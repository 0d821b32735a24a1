"""deepseek-v2-lite-16b's and rwkv6-3b's SMOKE prefill (B=8, S=64) on a
fake (2, 2) ("data", "model") process group, beside the reference's
``analyze_hlo`` of the same cell compiled on 4 emulated XLA CPU devices in
a subprocess (the reference's default einsum MoE dispatch): the per-chip
flops within 10% of the reference's, collectives on both sides (``-s``
prints them).

``python -m repro_torch.launch.dryrun --moe-dispatch shmap`` writes a
production deepseek-v2-lite-16b cell whose exchange the counter records
as all-to-all traffic (in its own process, as the reference's dry run
must run).

The fake process group (world 4, this process rank 0) lives for this
module's tests only."""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun

ROOT = os.path.join(os.path.dirname(__file__), "..")
B, S = 8, 64
DP = TP = 2
FLOPS_RTOL = 0.10

_REF = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "src")
import numpy as np, jax
from jax.sharding import Mesh
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
out = {}
for arch in sys.argv[3:]:
    cfg = get_smoke_config(arch)
    pa = abstract_params(cfg)
    pin = with_shardings(pa, tree_shardings(mesh, pa, param_spec))
    batch = input_specs(cfg, ShapeSpec("prefill", s, b, "prefill"), mesh)
    with mesh, logical_rules(logical_rules_for(cfg, mesh), mesh=mesh):
        c = jax.jit(make_prefill_step(cfg)).lower(pin, batch).compile()
    h = analyze_hlo(c.as_text())
    out[arch] = {"flops": h["flops"], "coll": h["coll"]}
print(json.dumps(out))
"""

ARCHS = ("deepseek-v2-lite-16b", "rwkv6-3b")


@pytest.fixture(scope="module")
def reference():
    res = subprocess.run([sys.executable, "-c", _REF, str(B), str(S),
                          *ARCHS], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_beside_the_reference_s_analyze_hlo(mesh, reference, arch):
    cell = dryrun.run_cell(arch, "prefill", "test", verbose=False,
                           mesh=mesh, cfg=get_smoke_config(arch),
                           shape=ShapeSpec("prefill", S, B, "prefill"))
    ref, port = reference[arch], cell["hlo"]
    print(f"\nSMOKE {arch} prefill B={B} S={S} on (2, 2), per chip:")
    print(f"  reference (XLA, optimized HLO): flops {ref['flops']:.6g}, "
          f"collective bytes {ref['coll']}")
    print(f"  port (eager DTensor step):      flops {port['flops']:.6g} "
          f"(dots {port['dot_flops']:.6g}), collective bytes "
          f"{port['collectives']} (counts {port['collective_counts']})")
    assert sum(ref["coll"].values()) > 0
    assert port["collective_bytes"] > 0
    assert abs(port["flops"] - ref["flops"]) <= FLOPS_RTOL * ref["flops"]


def test_cli_moe_dispatch_shmap_writes_a_cell_with_all_to_all(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "deepseek-v2-lite-16b", "--shape", "decode_32k", "--mesh",
         "single", "--moe-dispatch", "shmap", "--out", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(tmp_path / "deepseek-v2-lite-16b__decode_32k__single.json") \
            as f:
        cell = json.load(f)
    assert "error" not in cell, cell.get("traceback")
    assert cell["chips"] == 256
    assert cell["hlo"]["collectives"]["all-to-all"] > 0
