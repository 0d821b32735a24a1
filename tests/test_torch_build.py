"""``kernels/build.py`` on the CPU: a library is named by a hash of
everything that goes into it, so an edited source or header never reuses a
stale build. Nothing is compiled: these tests need no nvcc."""
import os
import shutil

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary copy of ``csrc/`` that ``build`` reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", str(copy))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    return copy


def test_every_source_has_a_library_path_under_the_build_dir(csrc):
    paths = {src: build.library_path(src) for src in build.SOURCES}
    assert len(set(paths.values())) == len(build.SOURCES)
    for src, path in paths.items():
        assert os.path.basename(path).startswith(os.path.splitext(src)[0])
        assert path.endswith(".so")
        assert build.build_log(src) == ""       # nothing built yet


@pytest.mark.parametrize("edited", ["hopper.cuh", "flash_attention.cu"])
def test_editing_a_header_or_the_source_changes_the_path(csrc, edited):
    before = {src: build.library_path(src) for src in build.SOURCES}
    target = csrc / edited
    original = target.read_bytes()
    target.write_bytes(original + b"\n// edited\n")
    after = {src: build.library_path(src) for src in build.SOURCES}
    assert after["flash_attention.cu"] != before["flash_attention.cu"]
    if edited.endswith(".cuh"):   # every source may include a header
        assert all(after[s] != before[s] for s in build.SOURCES)
    else:
        assert all(after[s] == before[s] for s in build.SOURCES
                   if s != edited)
    target.write_bytes(original)
    assert {src: build.library_path(src) for src in build.SOURCES} == before


def test_a_new_header_changes_the_path_and_other_files_do_not(csrc):
    before = build.library_path("flash_attention.cu")
    (csrc / "notes.txt").write_text("not compiled\n")
    assert build.library_path("flash_attention.cu") == before
    (csrc / "extra.h").write_text("#pragma once\n")
    assert build.library_path("flash_attention.cu") != before


def test_the_compiler_report_is_read_beside_the_library(csrc):
    path = build.library_path("flash_attention.cu")
    os.makedirs(os.path.dirname(path))
    with open(path + ".log", "w") as f:
        f.write("ptxas info    : Used 168 registers\n")
    assert "168 registers" in build.build_log("flash_attention.cu")


def test_launch_counts_and_the_first_load_hold_under_threads(monkeypatch):
    """The async tier launches from its worker thread while the main thread
    launches too: no count is lost, and a library is built and loaded by
    one thread however many reach it first (16 threads, a short switch
    interval)."""
    import sys
    import threading
    built = []

    def fake_build(source):
        built.append(source)
        return "lib.so"

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "launches", {})
    go = threading.Barrier(16)

    def work():
        go.wait(timeout=30)
        build.load_library("spmm_bcsr.cu")
        for _ in range(2000):
            build.count_launch("spmm_bcsr")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert build.launches == {"spmm_bcsr": 16 * 2000}
    assert built == ["spmm_bcsr.cu"]
    build.reset_launches()
    assert build.launches == {"spmm_bcsr": 0}
