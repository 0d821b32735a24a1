"""The benchmark imports neither JAX nor the JAX package: by its sources,
by what a run leaves in ``sys.modules`` (whole top-level names: the port
``repro_torch`` is not the JAX package ``repro``), and it prints no result
without the program or without a card."""
import ast
import os
import shutil
import subprocess
import sys
import types

import pytest

from perfbench.harness.cell import PERFBENCH, ROOT
from perfbench.harness.runner import FORBIDDEN, forbidden_modules


def _sources():
    for d, _, files in os.walk(PERFBENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(path, n) for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    before = forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torchish", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert set(forbidden_modules()) == set(before) | {"repro", "jax"}


def _run(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "gcn-arxiv.train",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))


def test_no_result_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(ROOT)
    assert r.returncode == 2 and r.stdout == ""
