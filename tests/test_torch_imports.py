"""The port imports neither JAX nor the JAX package, directly or indirectly.

A fresh interpreter imports every ``repro_torch`` module and the port's
scripts at the repo root, then reports what ``sys.modules`` holds; an AST scan
catches the import statements themselves, including ones inside functions
that the import alone does not run."""
import ast
import json
import os
import subprocess
import sys

import pytest

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_PORT = os.path.join(_ROOT, "src", "repro_torch")
_SCRIPTS = [os.path.join(_ROOT, f) for f in ("chip_smoke.py",
                                             "plan_survey.py",
                                             "tools/flash_variants.py",
                                             "tools/spmm_variants.py")]

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
mods = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, prefix="repro_torch.")]
for m in mods:
    importlib.import_module(m)
for i, path in enumerate(sys.argv[1:]):
    spec = importlib.util.spec_from_file_location(f"script{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({"modules": mods, "loaded": sorted(
    m for m in sys.modules if m == "jax" or m.startswith("jax.")
    or m == "repro" or m.startswith("repro."))}))
"""


def _port_files():
    out = list(_SCRIPTS)
    for dirpath, _dirs, files in os.walk(_PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_fresh_import_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, *_SCRIPTS],
        capture_output=True, text=True, env=env, cwd=_ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for mod in ("repro_torch.serve.gnn_engine", "repro_torch.kernels.spmm.ops",
                "repro_torch.kernels.gather_rows.ops",
                "repro_torch.train.gnn_trainer", "repro_torch.data.loader",
                "repro_torch.optim.optimizers", "repro_torch.optim.schedules",
                "repro_torch.optim.accumulate", "repro_torch.faults",
                "repro_torch.graph.sampling",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.kernels.flash_attention.ref",
                "repro_torch.configs.registry", "repro_torch.configs.shapes",
                "repro_torch.configs.llama3_2_1b",
                "repro_torch.configs.deepseek_v3_671b",
                "repro_torch.models.lm.config", "repro_torch.models.lm.common",
                "repro_torch.models.lm.attention",
                "repro_torch.models.lm.blocks", "repro_torch.models.lm.model",
                "repro_torch.serve.engine", "repro_torch.convert"):
        assert mod in got["modules"]
    assert got["loaded"] == []


def _bad_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{os.path.relpath(path, _ROOT)}:{node.lineno} "
                           f"imports {n}")
    return bad


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_source_imports_no_jax_and_no_repro(path):
    assert _bad_imports(path) == []


def test_scan_flags_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch\nfrom repro.core import Plan\n"
                 "def f():\n    import jax.numpy as jnp\n")
    assert [b.split(" imports ")[1] for b in _bad_imports(str(p))] == \
        ["repro.core", "jax.numpy"]
