"""Multi-pod dry run: one step of every (arch × shape × mesh) cell, counted
per chip for the roofline; the port of ``repro.launch.dryrun``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --mesh single --out results/dryrun

Cells and meshes, as in the reference:
  * mesh "single" = (data=16, model=16), 256 chips — roofline source.
  * mesh "multi"  = (pod=2, data=16, model=16), 512 chips — proves the pod
    axis shards.
  * --arch all --shape all runs every applicable cell (long_500k only for
    sub-quadratic archs).

How a cell runs. The reference lowers and compiles each step with XLA on
512 emulated CPU devices and reads the partitioned HLO. The port makes a
``fake`` process group of the mesh's world size in this one process
(``torch.testing._internal.distributed.fake_pg.FakeStore``: collectives
return at once and move nothing) and builds the ``DeviceMesh`` on it. The
parameters, optimizer state, cache and batch are DTensors placed by
``repro_torch.dist.sharding``'s specs whose local shards are fake tensors
(``FakeTensorMode``: shapes and dtypes, no memory is allocated). The step
then runs once, eagerly, under the cell's ``logical_rules``, as rank 0 of
the mesh, and ``repro_torch.launch.hlo_analysis.StepCounter`` counts the
ops on its local shards. Attention takes the plain chunked path: the
tensors are CPU tensors, and the reference's dry run lowers XLA's
``chunked_attention``, no Pallas kernel. Plain tensors a step creates
(positions, masks) take part as replicated (``implicit_replication``).

Hardware constants are the H100's: 989e12 bf16 FLOP/s and 3.35e12 B/s
(the NVIDIA H100 SXM5 80GB data sheet, dense, as ``chip_smoke.py``'s
bounds take them) and 900e9 B/s of NVLink per GPU (the same data sheet:
18 links, both directions together, so ``collective_s`` is a lower bound);
``memory.peak_bytes`` is read against 80 GB of device memory per GPU.

The JSON fields are the reference's. What fills them:
  * ``lower_s``: seconds to place the cell's fake state on the mesh;
    ``compile_s``: seconds of the counted step (nothing is compiled);
  * ``memory``: ``argument_bytes`` the local bytes of the step's inputs,
    ``output_bytes`` of its outputs, ``temp_bytes`` the peak of live local
    bytes the step created (op by op, ``StepCounter``), ``peak_bytes``
    their sum with the arguments, ``hbm_fraction`` that over 80 GB;
  * ``cost_xla_once``: no XLA; torch's own ``FlopCounterMode`` over the
    same step, which counts each DTensor op at its global shape (all
    chips together), so it reads about ``chips`` times the per-chip
    flops where the step is sharded (``bytes_accessed`` None);
  * ``hlo``: the per-chip counts (``StepCounter.cost``), with
    ``all_to_all_as_all_gather`` true on a CPU mesh (see hlo_analysis).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, shape_applies
from repro_torch.dist.logical import logical_rules
from repro_torch.dist.sharding import (
    batch_spec, cache_spec, distribute_tree, logical_rules_for, opt_spec,
    param_spec, placements)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.lm import (
    LMConfig, cache_shapes, decode_step, head_logits, lm_forward,
    param_shapes)
from repro_torch.models.lm.blocks import _cache_dtype
from repro_torch.models.lm.model import _map_leaves
from repro_torch.optim.optimizers import get_optimizer

# ---------------------------------------------------------- hardware constants
PEAK_FLOPS = 989e12        # bf16 dense per H100 SXM (NVIDIA data sheet)
HBM_BW = 3.35e12           # bytes/s of HBM3 per H100 SXM (data sheet)
ICI_BW = 900e9             # bytes/s of NVLink per H100 SXM (data sheet:
                           # 900 GB/s, both directions of 18 links)
HBM_BYTES = 80e9           # device memory per H100 SXM


def optimizer_for(arch: str) -> str:
    """Adafactor for ≥100B params (optimizer state must stay sub-HBM)."""
    return "adafactor" if arch in ("deepseek-v3-671b", "command-r-plus-104b") \
        else "adamw"


def fake_group(world: int) -> None:
    """Make the process group a ``fake`` one of ``world`` ranks (this
    process is rank 0), replacing a fake group of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a dry run needs its own process: a real "
                               "process group is in force")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _place(mesh, t: torch.Tensor, spec) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(mesh, spec),
                             src_data_rank=None)


# ------------------------------------------------------------------ input specs
def input_specs(cfg: LMConfig, shape: ShapeSpec, mesh) -> Dict[str, Any]:
    """Every model input of this cell, as DTensors placed by
    ``batch_spec``; call under the cell's ``FakeTensorMode`` (and the
    tensors hold no memory). A decode cell's ``pos`` is the cache's last
    slot, an int as the port's ``decode_step`` takes it."""
    b, s = shape.global_batch, shape.seq_len
    dev = mesh.device_type

    def mk(shp, dt, name):
        return _place(mesh, torch.empty(shp, dtype=dt, device=dev),
                      batch_spec(mesh, name, shp))
    if shape.kind in ("train", "prefill"):
        if cfg.num_codebooks > 1:
            toks = mk((b, s, cfg.num_codebooks), torch.int32, "tokens")
        else:
            toks = mk((b, s), torch.int32, "tokens")
        batch = {"tokens": toks,
                 "loss_mask": mk((b, s), torch.float32, "loss_mask")}
        if cfg.vision_prefix_len:
            batch["prefix_embeds"] = mk(
                (b, cfg.vision_prefix_len, cfg.d_model),
                getattr(torch, cfg.dtype), "prefix_embeds")
        return batch
    # decode: one new token against a seq_len cache
    if cfg.num_codebooks > 1:
        toks = mk((b, 1, cfg.num_codebooks), torch.int32, "tokens")
    else:
        toks = mk((b, 1), torch.int32, "tokens")
    return {"tokens": toks, "pos": s - 1}


# ------------------------------------------------------------------- step fns
# ``moe_dispatch``: the MoE layers' ``dispatch`` ("einsum" or "shmap"; the
# reference's REPRO_MOE_DISPATCH)
def make_train_step(cfg: LMConfig, opt, moe_dispatch: str = "einsum"):
    from repro_torch.launch.train import train_step as one_step

    def train_step(params, opt_state, batch, lr):
        return one_step(cfg, opt, params, opt_state, batch, lr,
                        moe_dispatch=moe_dispatch)
    return train_step


def make_prefill_step(cfg: LMConfig, moe_dispatch: str = "einsum"):
    def prefill(params, batch):
        with torch.no_grad():
            h = lm_forward(cfg, params, batch["tokens"],
                           prefix_embeds=batch.get("prefix_embeds"),
                           remat=False, moe_dispatch=moe_dispatch)
            return head_logits(cfg, params, h[:, -1])
    return prefill


def make_decode_step(cfg: LMConfig, moe_dispatch: str = "einsum"):
    def serve_step(params, cache, batch):
        with torch.no_grad():
            return decode_step(cfg, params, cache, batch["tokens"],
                               batch["pos"], moe_dispatch=moe_dispatch)
    return serve_step


def _fake_params(cfg: LMConfig, mesh) -> Any:
    dt = getattr(torch, cfg.dtype)
    return _map_leaves(param_shapes(cfg), lambda _n, s: torch.empty(
        s, dtype=dt, device=mesh.device_type))


def _count(step, args, fake_mode):
    """(outputs, StepCounter, FlopCounterMode total, seconds) of one
    counted run of ``step(*args)``."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.hlo_analysis import StepCounter
    counter = StepCounter(fake_mode)
    flops_global = FlopCounterMode(display=False)
    t0 = time.time()
    with implicit_replication(), counter, flops_global:
        out = step(*args)
    return out, counter, float(flops_global.get_total_flops()), \
        time.time() - t0


# ------------------------------------------------------------------ GNN cells
# The paper's own model, distributed the IBMB way: every chip processes its
# own precomputed padded batch (pure DP over the flattened mesh — batches are
# independent by construction), gradients all-reduced. Shapes follow the
# products-like synthetic config at production padding.
GNN_SHAPE = dict(max_nodes=8192, max_edges=131072, max_outputs=1024,
                 feat_dim=100, num_classes=47, hidden=256, layers=3)


def run_gnn_cell(arch: str, mesh_kind: str, verbose: bool = True,
                 shmap: bool = False, dtype: str = "float32",
                 mesh=None) -> Dict[str, Any]:
    """The GCN train step over one IBMB batch per chip. ``shmap`` (the
    reference's ``REPRO_GNN_SHMAP=1``, its ``shard_map``): each chip runs
    its own batch and the gradients and loss are all-reduced (mean) over
    every chip. Otherwise the reference's vmap baseline, which loses the
    batch sharding in XLA's partitioning and runs every batch on every
    chip: the port runs all of them, one after another, on each chip, with
    no collective. Parameters and optimizer state are replicated.
    ``dtype``: the reference's ``REPRO_GNN_DTYPE``. ``mesh``: a mesh to use
    instead of the production one (tests); the process group's world must
    be its size."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlo_analysis import local_bytes
    from repro_torch.models.gnn.models import (
        GNNConfig, gnn_apply, init_gnn, masked_xent, output_logits)
    from repro_torch.optim.optimizers import (
        apply_updates, tree_leaves, tree_map)
    kind = arch.split("-", 1)[1]
    g = GNN_SHAPE
    if mesh is None:
        fake_group(512 if mesh_kind == "multi" else 256)
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = mesh.size()
    if dist.get_world_size() != n_chips:
        raise ValueError(f"the GNN cell reduces over the whole group: its "
                         f"world {dist.get_world_size()} must be the mesh's "
                         f"{n_chips} chips")
    nb = n_chips                        # one IBMB batch per chip per step
    cfg = GNNConfig(kind=kind, in_dim=g["feat_dim"], hidden=g["hidden"],
                    out_dim=g["num_classes"], num_layers=g["layers"],
                    dtype=dtype)
    dev = mesh.device_type
    t0 = time.time()
    with FakeTensorMode() as fm:
        params = init_gnn(cfg, torch.Generator().manual_seed(0), dev)
        opt = get_optimizer("adamw")
        opt_state = opt.init(params)
        # this chip's batches: its own one (shmap), or all of them
        rows = 1 if shmap else nb

        def field(shape, dt):
            return torch.empty((rows,) + shape, dtype=dt, device=dev)
        batch = {
            "edge_src": field((g["max_edges"],), torch.int32),
            "edge_dst": field((g["max_edges"],), torch.int32),
            "edge_weight": field((g["max_edges"],), torch.float32),
            "node_mask": field((g["max_nodes"],), torch.float32),
            "output_idx": field((g["max_outputs"],), torch.int32),
            "output_mask": field((g["max_outputs"],), torch.float32),
            "features": field((g["max_nodes"], g["feat_dim"]),
                              torch.float32),
            "labels": field((g["max_outputs"],), torch.int32),
        }

        def loss_and_grads(p, b):
            """The mean loss over b's batches and its gradients."""
            q = tree_map(lambda t: t.detach().requires_grad_(), p)
            loss = sum(masked_xent(
                output_logits(gnn_apply(cfg, q, b1), b1), b1["labels"],
                b1["output_mask"]) for b1 in (
                    {k: v[i] for k, v in b.items()} for i in range(rows)))
            loss = loss / rows
            grads = iter(torch.autograd.grad(loss, tree_leaves(q)))
            return loss.detach(), tree_map(lambda _: next(grads), p)

        def train_step(p, s, b, lr):
            loss, grads = loss_and_grads(p, b)
            if shmap:
                grads = tree_map(lambda t: funcol.wait_tensor(
                    funcol.all_reduce(t, "avg", dist.group.WORLD)), grads)
                loss = funcol.wait_tensor(
                    funcol.all_reduce(loss, "avg", dist.group.WORLD))
            u, s = opt.update(grads, s, p, lr)
            return apply_updates(p, u), s, loss
        t_lower = time.time() - t0
        args = (params, opt_state, batch, 1e-3)
        arg_bytes = local_bytes(args[:3])
        out, counter, flops_global, t_step = _count(train_step, args, fm)
        out_bytes = local_bytes(out)
    return _finish(arch, "train_products", mesh_kind, n_chips, cfg, None,
                   counter, flops_global, arg_bytes, out_bytes, t_lower,
                   t_step, dev, model_flops_override=_gnn_model_flops(g, nb),
                   verbose=verbose)


def _gnn_model_flops(g, nb) -> float:
    """Useful FLOPs: 3 layers of (node matmul + edge aggregation), fwd+bwd."""
    dense = g["max_nodes"] * (g["feat_dim"] * g["hidden"] +
                              g["hidden"] * g["hidden"] +
                              g["hidden"] * g["num_classes"])
    agg = g["max_edges"] * (g["hidden"] * 2 + g["num_classes"])
    return float(nb * (2 * dense + 2 * agg) * 3)     # ×3 fwd+bwd


# ----------------------------------------------------------------------- cell
def run_cell(arch: str, shape_name: str, mesh_kind: str,
             verbose: bool = True, mesh=None, cfg: Optional[LMConfig] = None,
             shape: Optional[ShapeSpec] = None,
             gnn_shmap: bool = False, gnn_dtype: str = "float32",
             moe_dispatch: str = "einsum") -> Dict[str, Any]:
    """One cell. ``mesh``, ``cfg`` and ``shape`` replace the production
    mesh, the arch's config and the named shape (tests; the one-card
    anchor). ``moe_dispatch``: the MoE layers' dispatch, "einsum" or
    "shmap" (the reference's ``REPRO_MOE_DISPATCH``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if arch.startswith("gnn-"):
        return run_gnn_cell(arch, mesh_kind, verbose=verbose,
                            shmap=gnn_shmap, dtype=gnn_dtype, mesh=mesh)
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if not shape_applies(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "skipped": "full-attention arch, long_500k needs sub-quadratic"}
    if mesh is None:
        fake_group(512 if mesh_kind == "multi" else 256)
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = mesh.size()
    rules = logical_rules_for(cfg, mesh)
    from repro_torch.launch.hlo_analysis import local_bytes
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        params_g = _fake_params(cfg, mesh)
        params = distribute_tree(mesh, params_g, param_spec)
        batch = input_specs(cfg, shape, mesh)
        if shape.kind == "train":
            opt = get_optimizer(optimizer_for(arch))
            opt_state = distribute_tree(
                mesh, opt.init(params_g),
                lambda m, p, l: opt_spec(m, p, l, {}))
            del params_g
            step = make_train_step(cfg, opt, moe_dispatch)
            args = (params, opt_state, batch, 1e-3)
        elif shape.kind == "prefill":
            del params_g
            step = make_prefill_step(cfg, moe_dispatch)
            args = (params, batch)
        else:  # decode
            del params_g
            cache = distribute_tree(mesh, _map_leaves(
                cache_shapes(cfg, shape.global_batch, shape.seq_len),
                lambda name, s: torch.empty(s, dtype=_cache_dtype(cfg, name),
                                            device=mesh.device_type)),
                cache_spec)
            step = make_decode_step(cfg, moe_dispatch)
            args = (params, cache, batch)
        t_lower = time.time() - t0
    arg_bytes = local_bytes(args)
    with logical_rules(rules, mesh):
        out, counter, flops_global, t_step = _count(step, args, fm)
    out_bytes = local_bytes(out)
    return _finish(arch, shape_name, mesh_kind, n_chips, cfg, shape, counter,
                   flops_global, arg_bytes, out_bytes, t_lower, t_step,
                   mesh.device_type, verbose=verbose)


def _finish(arch, shape_name, mesh_kind, n_chips, cfg, shape, counter,
            flops_global, arg_bytes, out_bytes, t_lower, t_step, device_type,
            model_flops_override=None, verbose=False) -> Dict[str, Any]:
    hlo = counter.cost()
    flops = float(hlo["flops"])              # per chip per step
    bytes_hbm = float(hlo["bytes"])
    coll_total = float(hlo["collective_bytes"])

    # MODEL_FLOPS: 6·N_active·tokens (train), 2·N_active·tokens (fwd-only)
    if model_flops_override is not None:
        model_flops = model_flops_override
        n_active = params_n = None
    else:
        n_active = cfg.active_param_count()
        params_n = cfg.param_count()
        if shape.kind == "train":
            tokens = shape.global_batch * shape.seq_len
            model_flops = 6.0 * n_active * tokens
        elif shape.kind == "prefill":
            tokens = shape.global_batch * shape.seq_len
            model_flops = 2.0 * n_active * tokens
        else:
            model_flops = 2.0 * n_active * shape.global_batch  # 1 token/seq
    model_flops_chip = model_flops / n_chips
    peak = arg_bytes + counter.peak

    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": n_chips,
        "params": params_n, "active_params": n_active,
        "lower_s": round(t_lower, 1), "compile_s": round(t_step, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": counter.peak,
            "peak_bytes": peak,
            "hbm_fraction": peak / HBM_BYTES,
        },
        "cost_xla_once": {"flops": flops_global, "bytes_accessed": None},
        "hlo": {"flops": flops, "bytes": bytes_hbm,
                "collective_bytes": coll_total,
                "collectives": hlo["coll"],
                "collective_counts": hlo["collective_counts"],
                "dot_flops": hlo["dot_flops"],
                "elementwise_ops": hlo["elementwise_ops"],
                "scoped_dot_flops": hlo["scoped_dot_flops"],
                "all_to_all_as_all_gather": device_type == "cpu"},
        "model_flops_per_chip": model_flops_chip,
        "useful_ratio": model_flops_chip / flops if flops else None,
        "roofline": {
            "compute_s": flops / PEAK_FLOPS,
            "memory_s": bytes_hbm / HBM_BW,
            "collective_s": coll_total / ICI_BW,
        },
    }
    r = result["roofline"]
    dom = max(("compute_s", "memory_s", "collective_s"), key=lambda k: r[k])
    result["roofline"]["dominant"] = dom
    # roofline fraction: useful compute time / bound time
    bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
    result["roofline"]["model_compute_s"] = model_flops_chip / PEAK_FLOPS
    result["roofline"]["roofline_fraction"] = \
        (model_flops_chip / PEAK_FLOPS) / bound if bound else None
    if verbose:
        print(json.dumps(result, indent=2, default=str))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--gnn-shmap", action="store_true",
                    help="GNN cells: one batch per chip inside local_map, "
                         "gradients all-reduced (the reference's "
                         "REPRO_GNN_SHMAP=1)")
    ap.add_argument("--gnn-dtype", default="float32",
                    help="GNN cells' dtype (the reference's REPRO_GNN_DTYPE)")
    ap.add_argument("--moe-dispatch", default="einsum",
                    choices=["einsum", "shmap"],
                    help="MoE layers: the one-hot einsum dispatch, or the "
                         "expert-parallel exchange inside local_map (the "
                         "reference's REPRO_MOE_DISPATCH)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        arch_shapes = ["train_products"] if arch.startswith("gnn-") else shapes
        for shape in arch_shapes:
            for mesh_kind in meshes:
                tag = f"{arch}__{shape}__{mesh_kind}".replace("/", "_")
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip] {tag} (cached)")
                    continue
                print(f"[cell] {tag}", flush=True)
                try:
                    res = run_cell(arch, shape, mesh_kind, verbose=False,
                                   gnn_shmap=args.gnn_shmap,
                                   gnn_dtype=args.gnn_dtype,
                                   moe_dispatch=args.moe_dispatch)
                except Exception as e:  # record failures — they are bugs
                    import traceback
                    res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-3000:]}
                    print(res["error"])
                with open(path, "w") as f:
                    json.dump(res, f, indent=2, default=str)
                if "roofline" in res:
                    r = res["roofline"]
                    print(f"  compute {r['compute_s']:.3e}s  memory {r['memory_s']:.3e}s  "
                          f"collective {r['collective_s']:.3e}s  → {r['dominant']}",
                          flush=True)


if __name__ == "__main__":
    main()
