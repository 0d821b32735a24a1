"""The port's dataset cache: its own file name, atomic publication, and a
cache that cannot be read treated as a miss and rebuilt."""
import multiprocessing as mp
import os
import time

import numpy as np
import pytest

from repro.graph.datasets import get_dataset as jax_get_dataset
from repro_torch.graph import datasets


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(datasets, "_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(datasets, "_MEMO", {})
    return tmp_path


def _same(a, b):
    assert a.name == b.name
    for x, y in ((a.graph, b.graph), (a.norm_graph, b.norm_graph)):
        for f in ("indptr", "indices", "weights"):
            assert np.array_equal(getattr(x, f), getattr(y, f))
    assert np.array_equal(a.features, b.features)
    assert np.array_equal(a.labels, b.labels)
    assert all(np.array_equal(a.splits[k], b.splits[k]) for k in a.splits)


def test_cache_file_is_the_ports_own(cache_dir):
    ds = datasets.get_dataset("tiny")
    path = datasets.cache_path("tiny")
    assert os.path.basename(path) == "torch-tiny-v1.npz"
    assert os.listdir(cache_dir) == ["torch-tiny-v1.npz"]
    datasets._MEMO.clear()
    _same(datasets.get_dataset("tiny"), ds)       # read back from the file
    _same(ds, jax_get_dataset("tiny"))            # bitwise the reference's


@pytest.mark.parametrize("damage", ["truncate", "garbage", "empty",
                                    "missing_field"])
def test_unreadable_cache_is_rebuilt(cache_dir, damage):
    want = datasets.get_dataset("tiny")
    path = datasets.cache_path("tiny")
    if damage == "truncate":
        with open(path, "rb") as f:
            head = f.read()[: os.path.getsize(path) // 2]
        with open(path, "wb") as f:
            f.write(head)
    elif damage == "garbage":
        with open(path, "wb") as f:
            f.write(b"not an npz" * 100)
    elif damage == "empty":
        open(path, "wb").close()
    else:
        np.savez_compressed(path, indptr=np.zeros(3))
    datasets._MEMO.clear()
    _same(datasets.get_dataset("tiny"), want)
    datasets._MEMO.clear()
    _same(datasets._load("tiny", path), want)     # the rebuild was saved


def test_failed_write_leaves_nothing_under_the_final_name(cache_dir,
                                                          monkeypatch):
    def boom(f, **arrays):
        f.write(b"PK\x03\x04 half a zip")
        raise OSError("disk full")

    monkeypatch.setattr(datasets.np, "savez_compressed", boom)
    with pytest.raises(OSError, match="disk full"):
        datasets.get_dataset("tiny")
    assert os.listdir(cache_dir) == []


def _rewrite(cache_dir, stop_at):
    datasets._CACHE_DIR = cache_dir
    ds = datasets.get_dataset("tiny", cache=False)
    while time.monotonic() < stop_at:
        datasets._save(ds, datasets.cache_path("tiny"))


def test_readers_never_see_a_partial_file(cache_dir):
    """Three processes rewrite the cache over and over while this one
    reads it: every read finds a whole file."""
    want = datasets.get_dataset("tiny")
    path = datasets.cache_path("tiny")
    ctx = mp.get_context("spawn")
    stop_at = time.monotonic() + 10.0
    writers = [ctx.Process(target=_rewrite, args=(str(cache_dir), stop_at))
               for _ in range(3)]
    for w in writers:
        w.start()
    reads = 0
    try:
        while time.monotonic() < stop_at - 1.0:
            _same(datasets._load("tiny", path), want)
            reads += 1
    finally:
        for w in writers:
            w.join(timeout=30)
    assert not any(w.is_alive() for w in writers)
    assert all(w.exitcode == 0 for w in writers)
    assert reads > 0
    assert sorted(os.listdir(cache_dir)) == ["torch-tiny-v1.npz"]
