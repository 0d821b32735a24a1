"""The MoE and RWKV6 layers on DTensors over four ``gloo`` ranks (CPU), held
against their plain or single-controller counterparts:

* the einsum MoE dispatch on DTensors (``moe.routed_einsum``: the
  reference's one-hot formulation, global capacity and token order) within
  1e-4 of the plain sort path, with no drops and at capacity factor 0.5
  on ROADMAP Queue 3's input (64 tokens from numpy seed 5), forward and
  the gradients of x and of every parameter;
* the expert-parallel MoE on DTensors (``dispatch="shmap"``: ``_ep_member``
  inside ``local_map``, its exchanges functional all-to-alls over the
  "model" axis) within 1e-4 of the single-controller
  ``_moe_forward_shmap`` over a ``DataMesh`` of the same shape, which
  ``tests/test_torch_moe_ep.py`` holds against the reference's
  ``shard_map``, with no drops and at capacity factor 0.5 (256 tokens,
  64 a member); and its gradients against the plain path's where nothing
  drops;
* rwkv6-3b's SMOKE prefill, its parameters placed by ``param_spec`` and
  its tokens by ``batch_spec``, within 1e-4 of the unsharded prefill.

Meshes (2, 2) and (1, 4) ("data", "model"). Also ``chip_smoke.py``'s
moe-mesh phase at a small size on a world-1 (1, 1) mesh: on the CPU
(``gloo``) and, marked ``cuda``, on the card (``nccl``). Every process
group is made and destroyed inside a child process."""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
ATOL = 1e-4
MESHES = [(2, 2), (1, 4)]

_RANKS = r"""
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def run(rank, world, shapes, port, out):
    sys.path.insert(0, "src")
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import (batch_spec, distribute_tree, logical_rules,
        logical_rules_for, param_spec, placements)
    from repro_torch.dist.data_parallel import DataMesh
    from repro_torch.models.lm import head_logits, init_params, lm_forward
    from repro_torch.models.lm import moe
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    results = {}
    try:
        for shape in shapes:
            res = results[f"{shape[0]}x{shape[1]}"] = {}
            mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                              mesh_dim_names=("data", "model"))
            names = ("data", "model")
            # x (B, S, D): batch over "data", the sequence over "model", as
            # the residual stream is placed between layers
            x_pl = (Shard(0), Shard(1))

            def worst(got, want):
                return (((got - want).abs().max()) /
                        max(1.0, want.abs().max().item())).item()

            def grads(fn, ps, x):
                ps = {k: v.detach().requires_grad_() for k, v in ps.items()}
                x = x.detach().requires_grad_()
                out = fn(ps, x)
                w = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
                if hasattr(out, "device_mesh"):
                    w = distribute_tensor(w, out.device_mesh, out.placements)
                (out * w).sum().backward()
                return out, x.grad, {k: v.grad for k, v in ps.items()}

            def full(t):
                return t.full_tensor() if hasattr(t, "full_tensor") else t

            arch = "deepseek-v2-lite-16b"
            for cf in (11.0, 0.5):
                cfg = dataclasses.replace(get_smoke_config(arch),
                                          moe_capacity_factor=cf)
                params = init_params(
                    cfg, torch.Generator().manual_seed(0), "cpu")
                ffn = {k: v[0] for k, v in
                       params["stages"][1]["layer0"]["ffn"].items()}
                rng = np.random.default_rng(int(cf * 10))
                x = torch.from_numpy(rng.normal(size=(2, 32, cfg.d_model))
                                     .astype(np.float32))
                rules = logical_rules_for(cfg, mesh)
                fd = distribute_tree(mesh, ffn, param_spec)
                xd = distribute_tensor(x, mesh, x_pl)
                r = moe.route(cfg, ffn, x.reshape(-1, cfg.d_model))
                res[f"drops_{cf}"] = int((~r.keep).sum())
                # the einsum dispatch on DTensors against the plain sort path
                want, gx, gp = grads(lambda p, t: moe.moe_forward(cfg, p, t),
                                     ffn, x)
                with logical_rules(rules, mesh), implicit_replication():
                    got, gxd, gpd = grads(
                        lambda p, t: moe.moe_forward(cfg, p, t), fd, xd)
                res[f"einsum_{cf}"] = worst(full(got), want)
                res[f"einsum_grad_{cf}"] = max(
                    [worst(full(gxd), gx)] +
                    [worst(full(gpd[k]), gp[k]) for k in gp])
                # the funcol shmap path against the single-controller one, on
                # 256 tokens: 64 a member, so that capacity factor 0.5 drops
                # on every mesh (a member's capacity is at least 8)
                dm = DataMesh([["cpu"] * shape[1]] * shape[0], names)
                x = torch.from_numpy(rng.normal(size=(4, 64, cfg.d_model))
                                     .astype(np.float32))
                want, gx, gp = grads(lambda p, t: moe.moe_forward(cfg, p, t),
                                     ffn, x)
                sc_stats = {}
                sc = moe.moe_forward(cfg, ffn, x, dispatch="shmap", mesh=dm,
                                     stats=sc_stats)
                with logical_rules(rules, mesh), implicit_replication():
                    stats = {}
                    got, gxd, gpd = grads(
                        lambda p, t: moe.moe_forward(cfg, p, t,
                                                     dispatch="shmap",
                                                     stats=stats), fd,
                        distribute_tensor(x, mesh, x_pl))
                got = full(got)
                res[f"shmap_{cf}"] = worst(got, sc)
                res[f"shmap_bitwise_{cf}"] = bool(torch.equal(got, sc))
                # every member's drops (the single-controller run's records),
                # and this rank's record against its member's
                res[f"shmap_dropped_{cf}"] = sum(
                    m["dropped"] for m in sc_stats["members"])
                if rank == 0:
                    res[f"shmap_record_{cf}"] = (
                        stats["members"][0] == sc_stats["members"][0])
                if cf > 1:
                    # nothing drops: the exchange's gradients are the plain
                    # path's (the single-controller driver has none)
                    res["shmap_grad"] = max(
                        [worst(full(gxd), gx)] +
                        [worst(full(gpd[k]), gp[k]) for k in gp])
            # rwkv6-3b's SMOKE prefill, sharded against unsharded
            cfg = get_smoke_config("rwkv6-3b")
            params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            toks = torch.randint(0, cfg.vocab_size, (4, 32),
                                 generator=torch.Generator().manual_seed(1))
            with torch.no_grad():
                want = head_logits(cfg, params,
                                   lm_forward(cfg, params, toks)[:, -1])
                pd = distribute_tree(mesh, params, param_spec)
                td = distribute_tensor(toks, mesh, placements(
                    mesh, batch_spec(mesh, "tokens", toks.shape)))
                with logical_rules(logical_rules_for(cfg, mesh), mesh), \
                        implicit_replication():
                    got = head_logits(cfg, pd, lm_forward(cfg, pd, td)[:, -1])
                res["rwkv_prefill"] = worst(full(got), want)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()

if __name__ == "__main__":
    shapes = [tuple(s) for s in json.loads(sys.argv[1])]
    mp.spawn(run, args=(4, shapes, int(sys.argv[2]), sys.argv[3]),
             nprocs=4, join=True)
"""


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def all_ranks(tmp_path_factory):
    """Every figure on each mesh, by mesh: one group of four ranks makes
    both meshes."""
    d = tmp_path_factory.mktemp("moe_dtensor")
    out, script = d / "res.json", d / "ranks.py"
    script.write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(script),
                          json.dumps(MESHES), str(_free_port()), str(out)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(params=["2x2", "1x4"])
def ranks(request, all_ranks):
    print(f"{request.param}: {all_ranks[request.param]}")
    return all_ranks[request.param]


@pytest.mark.parametrize("cf", [11.0, 0.5])
def test_einsum_moe_on_dtensors_matches_the_plain_path(ranks, cf):
    assert (ranks[f"drops_{cf}"] > 0) == (cf < 1)
    assert ranks[f"einsum_{cf}"] <= ATOL
    assert ranks[f"einsum_grad_{cf}"] <= ATOL


@pytest.mark.parametrize("cf", [11.0, 0.5])
def test_funcol_shmap_matches_the_single_controller_path(ranks, cf):
    assert ranks[f"shmap_{cf}"] <= ATOL
    assert (ranks[f"shmap_dropped_{cf}"] > 0) == (cf < 1)
    assert ranks[f"shmap_record_{cf}"]


def test_funcol_shmap_gradients_match_the_plain_path(ranks):
    assert ranks["shmap_grad"] <= ATOL


def test_sharded_rwkv6_prefill_matches_unsharded(ranks):
    assert ranks["rwkv_prefill"] <= ATOL


_WORLD1 = r"""
import sys, types
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke
from repro_torch.configs import get_smoke_config
dev = torch.device(sys.argv[1])
torch.backends.cuda.matmul.allow_tf32 = False
ctx = types.SimpleNamespace(
    torch=torch, np=np, dev=dev, on_card=dev.type == "cuda",
    sync=torch.cuda.synchronize if dev.type == "cuda" else lambda: None,
    config=get_smoke_config, moe_b=2, moe_s=64)
with torch.no_grad():
    chip_smoke.moe_mesh_phase(ctx)
print("MOE MESH OK")
"""


def _world1(device):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _WORLD1, device], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    print(res.stdout)
    return res.stdout


def test_moe_mesh_phase_on_a_world_one_cpu_mesh():
    out = _world1("cpu")
    assert out.strip().endswith("MOE MESH OK")
    # the one-rank exchange moves the member's own buckets: bitwise
    assert "moe-mesh shmap on DTensors: max err 0 " in out


@pytest.mark.cuda
def test_moe_mesh_phase_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert _world1("cuda").strip().endswith("MOE MESH OK")
