"""The LM under a real device mesh: the SMOKE llama3.2-1b placed by
``param_spec``/``cache_spec``/``batch_spec`` and run under
``logical_rules``, held against the same model unsharded.

* world 4 on the CPU: four processes over ``gloo`` on (2, 2) and (1, 4)
  ("data", "model") meshes. On (1, 4) the 8 query heads split over
  "model" while the 2 kv heads stay whole (2 % 4 != 0), so each rank's
  query heads read their own kv heads (``kv_for_heads``). Prefill logits,
  4 decode steps and one train step's loss and gradients within 1e-4.
* world 1: the mesh-card phase of ``chip_smoke.py`` at a small size, on
  the CPU (``gloo``) and, marked ``cuda``, on the card (``nccl``), where
  the flash kernel runs under ``local_map``: bitwise the unsharded run.

Every process group is made and destroyed inside a child process."""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
ATOL = 1e-4

_RANKS = r"""
import json, os, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def run(rank, world, shape, port, out):
    sys.path.insert(0, "src")
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import (batch_spec, cache_spec, distribute_tree,
        logical_rules, logical_rules_for, param_spec, placements)
    from repro_torch.launch import train
    from repro_torch.models.lm import (decode_step, head_logits, init_cache,
        init_params, lm_forward)
    from repro_torch.optim.optimizers import tree_leaves
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=("data", "model"))
        cfg = get_smoke_config("llama3.2-1b")
        rules = logical_rules_for(cfg, mesh)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(0, cfg.vocab_size, (4, 32),
                             generator=torch.Generator().manual_seed(1))
        place = lambda t, n: distribute_tensor(
            t, mesh, placements(mesh, batch_spec(mesh, n, t.shape)),
            src_data_rank=None)
        pd = distribute_tree(mesh, params, param_spec)
        res = {}
        with torch.no_grad():
            want = head_logits(cfg, params, lm_forward(cfg, params, toks)[:, -1])
            with logical_rules(rules, mesh), implicit_replication():
                got = head_logits(cfg, pd, lm_forward(
                    cfg, pd, place(toks, "tokens"))[:, -1]).full_tensor()
            res["prefill"] = (got - want).abs().max().item()
            cache = init_cache(cfg, 4, 8, "cpu")
            cd = distribute_tree(mesh, init_cache(cfg, 4, 8, "cpu"),
                                 cache_spec)
            errs = []
            for i in range(4):
                t = toks[:, i:i + 1]
                lw, _ = decode_step(cfg, params, cache, t, i)
                with logical_rules(rules, mesh), implicit_replication():
                    lg, _ = decode_step(cfg, pd, cd, place(t, "tokens"), i)
                errs.append((lg.full_tensor() - lw).abs().max().item())
            res["decode"] = max(errs)
        batch = train.synthetic_batch(cfg, 4, 32, 0, "cpu")
        g1, l1 = train.grads_only(cfg, params, batch)
        with logical_rules(rules, mesh), implicit_replication():
            g2, l2 = train.grads_only(cfg, pd, {k: place(v, k)
                                                for k, v in batch.items()})
        res["loss"] = abs(l2.full_tensor().item() - l1.item())
        res["grads"] = max(
            (((b.full_tensor() - a).abs().max() /
              a.abs().max().clamp(min=1e-30)).item(), "/".join(map(str, p)))
            for p, a, b in zip(train.leaf_paths(g1), tree_leaves(g1),
                               tree_leaves(g2)))
        res["scale"] = want.abs().max().item()
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()

if __name__ == "__main__":
    shape = tuple(json.loads(sys.argv[1]))
    world = shape[0] * shape[1]
    mp.spawn(run, args=(world, shape, int(sys.argv[2]), sys.argv[3]),
             nprocs=world, join=True)
"""


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_sharded_llama_on_four_cpu_ranks_matches_unsharded(tmp_path, shape):
    out = tmp_path / "res.json"
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(script), json.dumps(shape),
                          str(_free_port()), str(out)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(out.read_text())
    print(f"{shape}: {got}")
    scale = max(1.0, got["scale"])
    assert got["prefill"] <= ATOL * scale
    assert got["decode"] <= ATOL * scale
    assert got["loss"] <= ATOL
    assert got["grads"][0] <= ATOL    # of each leaf's largest entry


_WORLD1 = r"""
import dataclasses, sys, types
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import build
dev = torch.device(sys.argv[1])
torch.backends.cuda.matmul.allow_tf32 = False
ctx = types.SimpleNamespace(
    torch=torch, np=np, dev=dev, build=build, on_card=dev.type == "cuda",
    sync=torch.cuda.synchronize if dev.type == "cuda" else lambda: None,
    prefill_s=256, train_b=2, train_s=64,
    # head dim 64: one the flash kernel takes
    mesh_cfg=dataclasses.replace(get_smoke_config("llama3.2-1b"),
                                 head_dim=64))
chip_smoke.mesh_card_phase(ctx)
print("BITWISE", all(ctx.mesh_bitwise.values()), ctx.mesh_launches)
"""


def _world1(device):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _WORLD1, device], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.strip().splitlines()[-1]


def test_world_one_mesh_is_bitwise_the_unsharded_run_on_the_cpu():
    assert _world1("cpu").startswith("BITWISE True")


@pytest.mark.cuda
def test_world_one_mesh_on_the_card_launches_flash_and_is_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    line = _world1("cuda")
    assert line.startswith("BITWISE True")
    # 2 layers: one launch each in the prefill, two each in the train step
    assert "'flash_attention': 6" in line
