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
                                             "tools/fit_card_vs_cpu.py",
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
                "repro_torch.models.lm.moe", "repro_torch.models.lm.rglru",
                "repro_torch.models.lm.rwkv",
                "repro_torch.serve.engine", "repro_torch.convert",
                "repro_torch.core.update", "repro_torch.core.pipeline",
                "repro_torch.configs.gnn_gcn", "repro_torch.configs.gnn_sage",
                "repro_torch.configs.gnn_gat", "repro_torch.models.gnn.ops",
                "repro_torch.models.gnn.models", "repro_torch.ioutil",
                "repro_torch.ooc", "repro_torch.ooc.store",
                "repro_torch.ooc.stream", "repro_torch.ooc.shard",
                "repro_torch.serve.async_engine", "repro_torch.checkpoint",
                "repro_torch.checkpoint.checkpointer", "repro_torch.dist",
                "repro_torch.dist.data_parallel",
                "repro_torch.train.elastic", "repro_torch.core.influence",
                "repro_torch.launch", "repro_torch.launch.train",
                "repro_torch.optim.compression"):
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


def test_refresh_swap_and_the_other_kinds_are_ported():
    from repro_torch.core import GraphDelta, IBMBPipeline, PlanDelta
    from repro_torch.models.gnn.models import _LAYERS
    from repro_torch.serve import GNNInferenceEngine
    assert callable(IBMBPipeline.refresh) and callable(GNNInferenceEngine.swap)
    assert GraphDelta().summary()["edge_inserts"] == 0
    assert "dirty" in dir(PlanDelta)
    assert sorted(_LAYERS) == ["gat", "gcn", "sage"]


def test_async_tier_out_of_core_and_checkpoints_are_ported():
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import IBMBPipeline
    from repro_torch.ooc import PlanStore, ShardRouter, stream_plan
    from repro_torch.serve import AsyncGNNEngine, GNNInferenceEngine
    assert "out_of_core" in IBMBPipeline.plan.__code__.co_varnames
    assert callable(GNNInferenceEngine.ooc_stats)
    assert all(callable(f) for f in (
        Checkpointer.auto_resume, PlanStore.read_batch, ShardRouter.load,
        stream_plan, AsyncGNNEngine.swap))


# The reference's analyzer scopes its write and determinism rules to
# ``src/repro/`` paths, so it never reads the port. These tests present
# the port's writers to those rules under the paths of the modules they
# copy.
_WRITERS = {
    "src/repro_torch/ioutil.py": "src/repro/ioutil.py",
    "src/repro_torch/core/plan.py": "src/repro/core/plan.py",
    "src/repro_torch/checkpoint/checkpointer.py":
        "src/repro/checkpoint/checkpointer.py",
    "src/repro_torch/checkpoint/__init__.py":
        "src/repro/checkpoint/__init__.py",
    "src/repro_torch/ooc/__init__.py": "src/repro/ooc/__init__.py",
    "src/repro_torch/ooc/store.py": "src/repro/ooc/store.py",
    "src/repro_torch/ooc/stream.py": "src/repro/ooc/stream.py",
    "src/repro_torch/ooc/shard.py": "src/repro/ooc/shard.py",
}


def _port_project(extra=None):
    from repro.analysis.model import Project
    sources = {}
    for port, ref in _WRITERS.items():
        with open(os.path.join(_ROOT, port), encoding="utf-8") as f:
            sources[ref] = f.read()
    sources.update(extra or {})
    return Project.from_sources(sources)


def _findings(checker_cls, project):
    from repro.analysis.model import filter_allowed
    kept, _suppressed = filter_allowed(checker_cls().run(project), project)
    return [f"{f.path}:{f.line} {f.message}" for f in kept]


def test_port_writers_pass_the_reference_s_write_and_determinism_rules():
    from repro.analysis.atomic_write import AtomicWriteChecker
    from repro.analysis.determinism import DeterminismChecker
    from repro.analysis.determinism import in_scope
    project = _port_project()
    assert _findings(AtomicWriteChecker, project) == []
    assert _findings(DeterminismChecker, project) == []
    assert in_scope("src/repro/ooc/stream.py") and \
        in_scope("src/repro/ooc/shard.py")


def test_the_presented_rules_catch_a_plain_write_and_a_clock_read():
    from repro.analysis.atomic_write import AtomicWriteChecker
    from repro.analysis.determinism import DeterminismChecker
    bad = {"src/repro/checkpoint/extra.py":
           "def dump(p, s):\n    with open(p, 'w') as f:\n"
           "        f.write(s)\n",
           "src/repro/ooc/stream.py":
           "import time\ndef stamp():\n    return time.time()\n"}
    project = _port_project(bad)
    assert [f.split(" ")[0] for f in _findings(AtomicWriteChecker,
                                               project)] == \
        ["src/repro/checkpoint/extra.py:2"]
    assert [f.split(" ")[0] for f in _findings(DeterminismChecker,
                                               project)] == \
        ["src/repro/ooc/stream.py:3"]


def test_data_parallel_elastic_and_influence_are_ported():
    from repro_torch.core import Plan
    from repro_torch.core.influence import exact_influence
    from repro_torch.dist.data_parallel import (
        DataMesh, ShardedPlanExecutor, data_mesh, stack_batches)
    from repro_torch.models.gnn.policy import superstep_decision
    from repro_torch.train.elastic import ElasticCoordinator
    assert all(callable(f) for f in (
        Plan.supersteps, exact_influence, DataMesh, ShardedPlanExecutor,
        data_mesh, stack_batches, superstep_decision,
        ElasticCoordinator.epoch_queue))


def test_every_lm_layer_type_and_frontend_is_ported():
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models.lm import model, param_shapes
    from repro_torch.models.lm.attention import (
        mla_decode, mla_forward, sliding_window_attention)
    from repro_torch.models.lm.moe import moe_forward
    from repro_torch.models.lm.rglru import rglru_decode, rglru_forward
    from repro_torch.models.lm.rwkv import rwkv_channel_mix, rwkv_time_mix
    assert all(callable(f) for f in (
        mla_decode, mla_forward, sliding_window_attention, moe_forward,
        rglru_decode, rglru_forward, rwkv_channel_mix, rwkv_time_mix))
    assert "prefix_embeds" in model.lm_forward.__code__.co_varnames
    for arch in list_archs():
        assert param_shapes(get_config(arch))


# The reference's lock-discipline rule scopes ``src/repro/serve/``,
# ``src/repro/data/loader.py`` and ``src/repro/train/elastic.py``
# (src/repro/analysis/locks.py:39). These tests present the port's copies
# to it under those paths.
_LOCKED = {
    "src/repro_torch/data/loader.py": "src/repro/data/loader.py",
    "src/repro_torch/train/elastic.py": "src/repro/train/elastic.py",
    "src/repro_torch/serve/async_engine.py":
        "src/repro/serve/async_engine.py",
    "src/repro_torch/serve/common.py": "src/repro/serve/common.py",
    "src/repro_torch/serve/gnn_engine.py": "src/repro/serve/gnn_engine.py",
    "src/repro_torch/serve/engine.py": "src/repro/serve/engine.py",
}


def _locked_project(extra=None):
    from repro.analysis.model import Project
    sources = {}
    for port, ref in _LOCKED.items():
        with open(os.path.join(_ROOT, port), encoding="utf-8") as f:
            sources[ref] = f.read()
    sources.update(extra or {})
    return Project.from_sources(sources)


def test_port_copies_pass_the_reference_s_lock_discipline_rule():
    from repro.analysis.locks import LockDisciplineChecker, in_scope
    assert all(in_scope(ref) for ref in _LOCKED.values())
    assert _findings(LockDisciplineChecker, _locked_project()) == []


def test_the_presented_lock_rule_catches_nesting_and_blocking():
    from repro.analysis.locks import LockDisciplineChecker
    with open(os.path.join(_ROOT, "src/repro_torch/train/elastic.py"),
              encoding="utf-8") as f:
        elastic = f.read()
    # a lease read from disk under the queue's lock, and a snapshot that
    # nests the tenant lock inside the condition the dispatcher takes
    # after it
    bad = elastic.replace(
        "            return sum(len(v) for v in self.leases.values())",
        "            time.sleep(0.1)\n"
        "            return sum(len(v) for v in self.leases.values())")
    assert bad != elastic
    nest = ("import threading\n"
            "class T:\n"
            "    def __init__(self):\n"
            "        self._cond = threading.Condition()\n"
            "        self.lock = threading.Lock()\n"
            "    def a(self):\n"
            "        with self.lock:\n"
            "            with self._cond:\n"
            "                pass\n"
            "    def b(self):\n"
            "        with self._cond:\n"
            "            with self.lock:\n"
            "                pass\n")
    found = _findings(LockDisciplineChecker, _locked_project(
        {"src/repro/train/elastic.py": "import time\n" + bad,
         "src/repro/serve/extra.py": nest}))
    assert any(f.startswith("src/repro/train/elastic.py:") for f in found)
    assert any(f.startswith("src/repro/serve/extra.py:") for f in found)
