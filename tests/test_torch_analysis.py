"""The port's invariant analyzer (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

* Each checker gets the fixtures of ``tests/test_analysis.py`` moved to
  the port's paths (``src/repro/`` → ``src/repro_torch/``, ``benchmarks/``
  → ``benchmarks_torch/``, ``tools/`` → ``tools_torch/``) and reports what
  the reference's checker reports on the fixtures where they stand: the
  same rules, lines and messages, the paths and the module names in the
  messages mapped. ``jit-cache`` guards the port's compiled executables
  (kernel builds, ``torch.compile``, CUDA graphs) where the reference's
  guards ``jax.jit``: its fixtures are the reference's with ``jax.jit``
  written ``torch.compile``.
* A violation seeded into each scope the port adds (the kernel build
  cache, the dataset cache writer) is caught.
* The shipped baseline is empty; ``python -m repro_torch.analysis`` exits
  0 on this tree, and its ``--format json``, ``--only`` and path filters
  behave as the reference's do."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import atomic_write as ref_atomic
from repro.analysis import bench_gate as ref_bench
from repro.analysis import determinism as ref_det
from repro.analysis import fault_points as ref_faults
from repro.analysis import jit_cache as ref_jit
from repro.analysis import locks as ref_locks
from repro.analysis import model as ref_model
from repro_torch.analysis import atomic_write, bench_gate, determinism, \
    fault_points, jit_cache, locks
from repro_torch.analysis.cli import find_repo_root, main
from repro_torch.analysis.model import (BASELINE_RELPATH, Project,
                                        filter_allowed, load_baseline)

FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
ROOT = Path(__file__).resolve().parent.parent
_PATHS = (("src/repro/", "src/repro_torch/"),
          ("benchmarks/", "benchmarks_torch/"), ("tools/", "tools_torch/"))


def port_path(path):
    for ref, port in _PATHS:
        if path.startswith(ref):
            return port + path[len(ref):]
    return path


def port_message(msg):
    msg = re.sub(r"\brepro\.", "repro_torch.", msg)
    msg = msg.replace("src/ or benchmarks/",
                      "src/repro_torch/ or benchmarks_torch/")
    return re.sub(r"\bbenchmarks/", "benchmarks_torch/", msg)


def mapped(findings):
    return sorted((f.rule, port_path(f.path), f.line, port_message(f.message))
                  for f in findings)


def listed(findings):
    return sorted((f.rule, f.path, f.line, f.message) for f in findings)


def both_projects(relpath, source):
    return (ref_model.Project.from_sources({relpath: source}),
            Project.from_sources({port_path(relpath): source}))


def fixture(name):
    return (FIXTURES / name).read_text()


# the reference's fixtures, each at the virtual path its test gives it
SNIPPETS = [
    ("determinism", "src/repro/core/x.py", "determinism_bad.py"),
    ("determinism", "src/repro/core/x.py", "determinism_good.py"),
    ("determinism", "src/repro/serve/x.py", "determinism_bad.py"),
    ("locks", "src/repro/serve/x.py", "locks_bad.py"),
    ("locks", "src/repro/serve/x.py", "locks_good.py"),
    ("atomic", "src/repro/ooc/x.py", "atomic_bad.py"),
    ("atomic", "src/repro/ooc/x.py", "atomic_good.py"),
    ("atomic", "src/repro/serve/x.py", "atomic_bad.py"),
]
CHECKERS = {
    "determinism": (ref_det.DeterminismChecker,
                    determinism.DeterminismChecker),
    "locks": (ref_locks.LockDisciplineChecker, locks.LockDisciplineChecker),
    "atomic": (ref_atomic.AtomicWriteChecker, atomic_write.AtomicWriteChecker),
    "jit": (ref_jit.JitCacheChecker, jit_cache.JitCacheChecker),
    "faults": (ref_faults.FaultPointChecker, fault_points.FaultPointChecker),
    "bench": (ref_bench.BenchGateChecker, bench_gate.BenchGateChecker),
}


@pytest.mark.parametrize("kind,relpath,name", SNIPPETS,
                         ids=[f"{k}-{n}-{p.split('/')[2]}"
                              for k, p, n in SNIPPETS])
def test_checker_reports_what_the_reference_s_reports(kind, relpath, name):
    ref_cls, port_cls = CHECKERS[kind]
    ref_proj, port_proj = both_projects(relpath, fixture(name))
    want = ref_cls().run(ref_proj)
    got = port_cls().run(port_proj)
    assert listed(got) == mapped(want)
    # the allow comments suppress the same findings
    want_kept, want_allowed = ref_model.filter_allowed(want, ref_proj)
    got_kept, got_allowed = filter_allowed(got, port_proj)
    assert listed(got_kept) == mapped(want_kept)
    assert listed(got_allowed) == mapped(want_allowed)


def test_the_port_s_scopes_are_its_own():
    assert determinism.in_scope("src/repro_torch/core/plan.py")
    assert not determinism.in_scope("src/repro/core/plan.py")
    assert locks.in_scope("src/repro_torch/kernels/build.py")
    assert not locks.in_scope("src/repro/serve/engine.py")
    for path in ("src/repro_torch/kernels/build.py",
                 "src/repro_torch/graph/datasets.py",
                 "src/repro_torch/checkpoint/checkpointer.py"):
        assert atomic_write.in_scope(path)
    assert not atomic_write.in_scope("benchmarks/run.py")
    assert fault_points.FAULTS_MODULE == "src/repro_torch/faults.py"


@pytest.mark.parametrize("name", ["jit_bad.py", "jit_good.py"])
def test_jit_cache_fires_where_the_reference_s_fires(name):
    """The reference's jit fixtures with ``jax.jit`` written
    ``torch.compile``: the same findings at the same lines, each naming
    what it constructed."""
    src = fixture(name)
    ref_proj = ref_model.Project.from_sources({"src/repro/serve/x.py": src})
    port_src = src.replace("jax.jit", "torch.compile").replace(
        "import jax", "import torch")
    port_proj = Project.from_sources({"src/repro_torch/serve/x.py":
                                      port_src})
    want = ref_jit.JitCacheChecker().run(ref_proj)
    got = jit_cache.JitCacheChecker().run(port_proj)
    assert [(f.rule, f.line) for f in got] == [(f.rule, f.line)
                                               for f in want]
    assert all("`torch.compile`" in f.message for f in got)
    assert len(got) == (3 if name == "jit_bad.py" else 0)
    # the reference's own fixture means nothing to the port: no jax.jit
    assert jit_cache.JitCacheChecker().run(Project.from_sources(
        {"src/repro_torch/serve/x.py": src})) == []


_BUILDS = '''\
import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import load_library


def warm(sources):
    for src in sources:
        build.build_all((src,))               # a rebuild check per trip


class Server:
    def __init__(self):
        self.lib = build.load_library("x.cu")  # once: fine
        self.graph = torch.cuda.CUDAGraph()    # once: fine

    def run(self, batch):
        lib = load_library("x.cu")             # per request
        g = torch.cuda.CUDAGraph()             # per request
        with torch.cuda.graph(g):              # per request
            pass
        return lib, batch


@torch.compile
def step(x):
    return x
'''


def test_jit_cache_guards_the_port_s_compiled_executables():
    proj = Project.from_sources({"src/repro_torch/serve/x.py": _BUILDS})
    got = jit_cache.JitCacheChecker().run(proj)
    assert [f.line for f in got] == [9, 18, 19, 20]
    assert "inside a loop" in got[0].message
    assert all("per-request entry point `run()`" in f.message
               for f in got[1:])


def _source(rel):
    return (ROOT / rel).read_text(encoding="utf-8")


_SEEDED_BUILD = '''

def _cache_note(path, text):
    with open(path, "w") as f:                 # no tmp + os.replace
        f.write(text)


def _count_under_lock(name):
    with _lock:
        with open(name) as f:                  # file I/O under the lock
            return f.read(), time.time()       # and the raw clock


def _rebuild_all(sources):
    for src in sources:
        build(src)                             # compiled per trip
'''


def test_a_violation_seeded_into_the_kernel_build_cache_is_caught():
    rel = "src/repro_torch/kernels/build.py"
    clean = _source(rel)
    proj = Project.from_sources({rel: clean})
    for cls in (atomic_write.AtomicWriteChecker, locks.LockDisciplineChecker,
                jit_cache.JitCacheChecker):
        kept, _ = filter_allowed(cls().run(proj), proj)
        assert kept == []
    seeded = clean + "import time\n" + _SEEDED_BUILD
    proj = Project.from_sources({rel: seeded})
    marked = {text: i for i, line in enumerate(seeded.splitlines(), 1)
              for text in ("no tmp", "under the lock", "raw clock",
                           "per trip") if text in line}

    def lines(cls, rule=None):
        found, _ = filter_allowed(cls().run(proj), proj)
        return [f.line for f in found if rule is None or f.rule == rule]
    assert lines(atomic_write.AtomicWriteChecker) == [marked["no tmp"]]
    assert lines(locks.LockDisciplineChecker, "lock-blocking") == [
        marked["under the lock"]]
    assert lines(locks.LockDisciplineChecker, "clock-injectable") == [
        marked["raw clock"]]
    assert lines(jit_cache.JitCacheChecker) == [marked["per trip"]]


def test_a_plain_write_seeded_into_the_dataset_cache_writer_is_caught():
    rel = "src/repro_torch/graph/datasets.py"
    clean = _source(rel)
    assert atomic_write.AtomicWriteChecker().run(
        Project.from_sources({rel: clean})) == []
    seeded = clean + ('\n\ndef _save_in_place(ds, path):\n'
                      '    with open(path, "wb") as f:\n'
                      '        np.savez_compressed(f, x=ds.features)\n')
    found = atomic_write.AtomicWriteChecker().run(
        Project.from_sources({rel: seeded}))
    assert [f.line for f in found] == [len(clean.splitlines()) + 4]
    assert "repro_torch.ioutil" in found[0].message


def _mapped_tree(src, dst):
    """A fixture directory copied with the port's paths."""
    for dirpath, _dirs, files in os.walk(src):
        for fn in files:
            rel = os.path.relpath(os.path.join(dirpath, fn), src)
            out = dst / port_path(rel.replace(os.sep, "/"))
            out.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(os.path.join(dirpath, fn), out)
    return dst


@pytest.mark.parametrize("kind,name", [
    ("faults", "faultreg_bad"), ("faults", "faultreg_good"),
    ("bench", "benchgate_bad"), ("bench", "benchgate_good")])
def test_registry_and_gate_checkers_on_the_mapped_fixture_trees(
        tmp_path, kind, name):
    ref_cls, port_cls = CHECKERS[kind]
    want = ref_cls().run(ref_model.Project.load(str(FIXTURES / name)))
    got = port_cls().run(Project.load(str(_mapped_tree(FIXTURES / name,
                                                       tmp_path))))
    assert listed(got) == mapped(want)
    assert bool(got) == name.endswith("_bad")


def test_bench_gate_reports_nothing_until_the_port_has_a_gate():
    assert bench_gate.BenchGateChecker().run(Project.load(str(ROOT))) == []
    assert not (ROOT / bench_gate.GATE_MODULE).exists()


def test_shipped_baseline_is_empty():
    assert BASELINE_RELPATH.startswith("src/repro_torch/analysis/")
    assert load_baseline(str(ROOT / BASELINE_RELPATH)) == []
    assert Path(find_repo_root()) == ROOT


def test_repo_is_clean_end_to_end(capsys):
    rc = main(["--format", "json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert report["findings"] == []
    assert report["suppressed"]["baseline"] == []
    allowed = report["suppressed"]["allow_comments"]
    assert all(f["path"].startswith("src/repro_torch/") for f in allowed)
    lock_rules = {"lock-order", "lock-blocking", "condvar-wait",
                  "clock-injectable"}
    # the two by-design lock suppressions of the async tier (as the
    # reference's) and the kernel cache's first build; every other allow
    # is an annotated timing-only determinism read
    assert len([f for f in allowed if f["rule"] in lock_rules]) == 3
    assert {f["rule"] for f in allowed} == {"lock-blocking", "determinism"}


def test_module_entry_point_exits_0_on_the_repo():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("0 finding(s)")


def test_cli_nonzero_exit_and_json_report_on_drift(tmp_path, capsys):
    root = _mapped_tree(FIXTURES / "faultreg_bad", tmp_path)
    rc = main(["--root", str(root), "--format", "json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert len(report["findings"]) == 5
    assert {f["rule"] for f in report["findings"]} == {"fault-point"}
    rc = main(["--root", str(root)])
    out = capsys.readouterr().out.splitlines()
    assert rc == 1
    assert out[-1].startswith("5 finding(s) (0 allowed by lint comments, "
                              "0 baselined) over 2 modules")
    assert out[0].startswith("DESIGN.md:1: [fault-point]")


def test_cli_only_and_path_filters(tmp_path, capsys):
    root = _mapped_tree(FIXTURES / "faultreg_bad", tmp_path)
    # --only selects checkers; a path argument narrows reported findings
    assert main(["--root", str(root), "--only", "bench-gate"]) == 0
    assert main(["--root", str(root), "tools_torch"]) == 0
    assert main(["--root", str(root), "src/repro_torch"]) == 1
    capsys.readouterr()
    main(["--root", str(root), "--format", "json", "src/repro_torch"])
    paths = {f["path"] for f in json.loads(
        capsys.readouterr().out)["findings"]}
    assert paths == {"src/repro_torch/faults.py", "src/repro_torch/serve.py"}
