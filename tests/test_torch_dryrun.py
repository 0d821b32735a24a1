"""The port's dry run (``repro_torch.launch.dryrun``) and its per-chip
counter (``repro_torch.launch.hlo_analysis``) on SMOKE cells of a fake
(2, 2) mesh: per-chip dot flops equal a hand count of the cell, the
collectives are printed beside the reference's ``analyze_hlo`` of the
same cell (compiled on 4 emulated XLA CPU devices in a subprocess), and
``summarize`` renders the reference's table from the port's JSON.

The fake process group (world 4, this process rank 0) lives for this
module's tests only."""
import importlib
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.hlo_analysis import StepCounter

ARCH = "llama3.2-1b"
B, S = 4, 64
DP = TP = 2
REF_FIELDS = {"arch", "shape", "mesh", "chips", "params", "active_params",
              "lower_s", "compile_s", "memory", "cost_xla_once", "hlo",
              "model_flops_per_chip", "useful_ratio", "roofline"}


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    assert not dist.is_initialized()
    dryrun.fake_group(DP * TP)
    try:
        yield make_test_mesh((DP, TP))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def cells(mesh):
    cfg = get_smoke_config(ARCH)
    return {kind: dryrun.run_cell(ARCH, kind, "test", verbose=False,
                                  mesh=mesh, cfg=cfg,
                                  shape=ShapeSpec(kind, S, B, kind))
            for kind in ("prefill", "train", "decode")}


# --------------------------------------------------------------- the counter
def count_step(fn):
    counter = StepCounter()
    with counter:
        fn()
    return None, counter


def test_counter_counts_what_flop_counter_mode_counts_on_plain_tensors():
    gen = torch.Generator().manual_seed(0)
    w1 = torch.randn(64, 96, generator=gen, requires_grad=True)
    w2 = torch.randn(4, 96, 32, generator=gen, requires_grad=True)
    x = torch.randn(4, 16, 64, generator=gen)

    def step():
        h = torch.tanh(x @ w1)
        y = torch.bmm(h, w2) + 1.0
        y.sum().backward()
    with FlopCounterMode(display=False) as fc:
        step()
    _, counter = count_step(step)
    assert counter.dot_flops == fc.get_total_flops()
    assert counter.coll == {k: 0.0 for k in counter.coll}


def test_a_python_loop_counts_every_trip():
    # the reference's scan test: 10 chained matmuls, 10 · 2 · 128³
    x, w = torch.randn(128, 128), torch.randn(10, 128, 128)

    def f():
        c = x
        for i in range(10):
            c = c @ w[i]
        return c
    _, counter = count_step(f)
    assert counter.dot_flops == 10 * 2 * 128 ** 3


def test_bytes_and_elementwise_are_counted():
    x = torch.randn(256, 256)
    _, counter = count_step(lambda: torch.tanh(x @ x))
    assert counter.bytes >= 3 * 256 * 256 * 4      # two reads + a write
    assert counter.elementwise == 256 * 256
    assert counter.peak >= 2 * 256 * 256 * 4       # the product and tanh


def test_scope_sums_the_dots_inside_it():
    x = torch.randn(32, 32)

    def f():
        y = x @ x
        with hlo_analysis.scope("inner"):
            return y @ x
    _, counter = count_step(f)
    assert counter.scoped_dot_flops == {"inner": 2 * 32 ** 3}
    assert counter.dot_flops == 2 * 2 * 32 ** 3


# ----------------------------------------------------------------- LM cells
def _hand_prefill_dots(cfg, b, s, dp, tp):
    """Per-chip dot flops of the SMOKE prefill on (dp, tp): the layers
    run on the chip's (b/dp)·s tokens (the sequence gathered before the
    projections, as ``gqa_forward`` annotates x), every column-parallel
    weight gathered over "data" (FSDP) with its output columns over
    "model"; attention is the plain chunked path on the chip's H/tp heads
    (all S×S pairs); the head takes h[:, -1] of every sequence with
    d_model over "data" and the vocab over "model"."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, f, v = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size
    t = (b // dp) * s
    layer = (2 * t * d * (h * hd // tp)              # q
             + 2 * 2 * t * d * (kv * hd // tp)       # k, v
             + 2 * 2 * (b // dp) * (h // tp) * s * s * hd   # qk^T, pv
             + 2 * t * (h * hd // tp) * d            # wo
             + 3 * 2 * t * d * (f // tp))            # w_in, w_gate, w_out
    return cfg.num_layers * layer + 2 * b * (d // dp) * (v // tp)


def test_prefill_cell_dot_flops_equal_the_hand_count(cells):
    cfg = get_smoke_config(ARCH)
    cell = cells["prefill"]
    assert cell["hlo"]["dot_flops"] == _hand_prefill_dots(cfg, B, S, DP, TP)
    assert cell["chips"] == DP * TP
    assert set(cell) == REF_FIELDS
    # the step is sharded: torch's FlopCounterMode over the DTensor step
    # counts each op at its global shape, more than a chip does
    assert cell["cost_xla_once"]["flops"] > cell["hlo"]["dot_flops"]


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
def test_lm_cells_report_collectives_memory_and_roofline(cells, kind):
    cell = cells[kind]
    h, m, r = cell["hlo"], cell["memory"], cell["roofline"]
    assert h["collective_bytes"] > 0 and h["collectives"]["all-gather"] > 0
    assert h["all_to_all_as_all_gather"] is True
    assert 0 < m["argument_bytes"] < m["peak_bytes"]
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert m["hbm_fraction"] == m["peak_bytes"] / dryrun.HBM_BYTES
    assert r["compute_s"] == h["flops"] / dryrun.PEAK_FLOPS
    assert r["memory_s"] == h["bytes"] / dryrun.HBM_BW
    assert r["collective_s"] == h["collective_bytes"] / dryrun.ICI_BW
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")


def test_train_cell_runs_the_backward_and_reduces_gradients(cells):
    train, prefill = cells["train"]["hlo"], cells["prefill"]["hlo"]
    # forward, remat recompute and two backward products per layer GEMM
    assert train["dot_flops"] > 3 * prefill["dot_flops"]
    assert train["collectives"]["reduce-scatter"] > 0


def test_gnn_cell_counts_one_batch_a_chip_and_all_reduces(mesh):
    g = dryrun.GNN_SHAPE
    n, dims = g["max_nodes"], [g["feat_dim"]] + [g["hidden"]] * (
        g["layers"] - 1) + [g["num_classes"]]
    fwd = sum(2 * n * a * b for a, b in zip(dims, dims[1:]))
    # forward, the weights' gradients, the inputs' gradients past layer 1
    one = 2 * fwd + sum(2 * n * a * b for a, b in zip(dims[1:], dims[2:]))
    shmap = dryrun.run_gnn_cell("gnn-gcn", "test", verbose=False,
                                shmap=True, mesh=mesh)
    assert shmap["hlo"]["dot_flops"] == one
    n_params = sum(a * b + b for a, b in zip(dims, dims[1:])) + \
        2 * sum(dims[1:-1])                    # W, b and the LayerNorms
    assert shmap["hlo"]["collectives"]["all-reduce"] == 2 * 4 * (n_params + 1)
    base = dryrun.run_gnn_cell("gnn-gcn", "test", verbose=False, mesh=mesh)
    assert base["hlo"]["dot_flops"] == DP * TP * one
    assert base["hlo"]["collective_bytes"] == 0


def test_a_multi_pod_cell_shards_the_pod_axis():
    """The (2, 16, 16) production mesh in its own process (its fake
    group has world 512): decode_32k's batch of 128 over ("pod",
    "data")."""
    code = ("import json, sys\n"
            "from repro_torch.launch import dryrun\n"
            "c = dryrun.run_cell('llama3.2-1b', 'decode_32k', 'multi', "
            "verbose=False)\n"
            "print(json.dumps(c))\n")
    root = os.path.join(os.path.dirname(__file__), "..")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(root, "src")))
    assert res.returncode == 0, res.stderr[-3000:]
    cell = json.loads(res.stdout.strip().splitlines()[-1])
    assert cell["chips"] == 512 and cell["mesh"] == "multi"
    assert cell["hlo"]["collective_bytes"] > 0
    # the bf16 k/v cache of 16 layers, 128 × 32768 × 8 kv heads × 64:
    # over "data" alone a chip would hold a sixteenth of it, over pod ×
    # data it holds a thirty-second (and a few MB of parameters)
    cache = 2 * 16 * 128 * 32_768 * 8 * 64 * 2
    assert cache / 32 < cell["memory"]["argument_bytes"] < cache / 16


# --------------------------------------------- beside the reference's HLO
_REF = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_smoke_config
from repro.configs.shapes import ShapeSpec
from repro.dist.logical import logical_rules
from repro.dist.sharding import (param_spec, tree_shardings, with_shardings,
                                 logical_rules_for)
from repro.launch.dryrun import input_specs, make_prefill_step
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.lm import abstract_params
b, s = int(sys.argv[1]), int(sys.argv[2])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
cfg = get_smoke_config("llama3.2-1b")
pa = abstract_params(cfg)
pin = with_shardings(pa, tree_shardings(mesh, pa, param_spec))
batch = input_specs(cfg, ShapeSpec("prefill", s, b, "prefill"), mesh)
with mesh, logical_rules(logical_rules_for(cfg, mesh), mesh=mesh):
    c = jax.jit(make_prefill_step(cfg)).lower(pin, batch).compile()
h = analyze_hlo(c.as_text())
print(json.dumps({"flops": h["flops"], "coll": h["coll"]}))
"""


def test_collectives_beside_the_reference_s_analyze_hlo(cells):
    root = os.path.join(os.path.dirname(__file__), "..")
    res = subprocess.run([sys.executable, "-c", _REF, str(B), str(S)],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    port = cells["prefill"]["hlo"]
    print(f"\nSMOKE {ARCH} prefill B={B} S={S} on (2, 2), per chip:")
    print(f"  reference (XLA, optimized HLO): flops {ref['flops']:.6g}, "
          f"collective bytes {ref['coll']}")
    print(f"  port (eager DTensor step):      flops {port['flops']:.6g}, "
          f"collective bytes {port['collectives']} "
          f"(counts {port['collective_counts']})")
    assert sum(ref["coll"].values()) > 0
    assert port["collective_bytes"] > 0


def test_summarize_renders_the_reference_s_table(cells, tmp_path):
    for kind, cell in cells.items():
        with open(tmp_path / f"{ARCH}__{kind}__test.json", "w") as f:
            json.dump(dict(cell, mesh="single"), f)
    with open(tmp_path / "x__long__test.json", "w") as f:
        json.dump({"arch": "x", "shape": "long", "mesh": "single",
                   "skipped": "full-attention arch"}, f)
    with open(tmp_path / "y__bad__test.json", "w") as f:
        json.dump({"arch": "y", "shape": "bad", "mesh": "multi",
                   "error": "RuntimeError: no"}, f)
    port = importlib.import_module("repro_torch.launch.summarize")
    ref = importlib.import_module("repro.launch.summarize")
    got = port.load(str(tmp_path))
    want = ref.load(str(tmp_path))
    assert port.roofline_table(got) == ref.roofline_table(want)
    assert port.multi_pod_proof(got) == ref.multi_pod_proof(want)
    assert len(port.roofline_table(got).splitlines()) == 2 + 3 + 1
