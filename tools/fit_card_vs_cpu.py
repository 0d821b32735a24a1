#!/usr/bin/env python3
"""Hold the GCN's data-parallel fit on the card against the same fit on
the CPU, under Adam and under plain SGD.

    python3 tools/fit_card_vs_cpu.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``
(about 90 s on an H100). The arxiv-like train and val Plans (bcsr), the
full-width GCN of ``configs/gnn_gcn.CONFIG`` at dropout 0 (each device's
generator draws its own dropout masks), a world-4 ``DataMesh`` of the card
four times against one of ``"cpu"`` four times, 1 and 2 epochs. For each
optimizer it prints the histories' differences and, per parameter leaf,
the largest difference and how many elements differ by more than
1e-4 + 1e-4·|value|; then the first super-step's averaged gradient on both
devices (plain SGD at lr 1, so the step is the gradient), with the
gradients nearest zero.

What it tells: whether a difference between the card's fit and the CPU's
comes from the gradients themselves or from the optimizer. Adam's first
steps divide each gradient element by its own magnitude, so an f32
summation-order difference in a gradient near zero can move that
parameter by up to the learning rate; SGD moves it by lr times the
gradient's own difference. ``chip_smoke.py`` holds the card to the CPU
under SGD for that reason.
"""
import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


def main() -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("tools/fit_card_vs_cpu.py: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import gnn_gcn
    from repro_torch.core import IBMBConfig, IBMBPipeline
    from repro_torch.dist.data_parallel import DataMesh, ShardedPlanExecutor
    from repro_torch.graph.datasets import get_dataset
    from repro_torch.kernels import build
    from repro_torch.models.gnn import BackendPolicy
    from repro_torch.optim import tree_leaves
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.train import GNNTrainer

    build.build_all()
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    ds = get_dataset("arxiv-like")
    pipe = IBMBPipeline(ds, IBMBConfig(variant="node", backend="bcsr"))
    train, val = pipe.plan("train"), pipe.plan("val", for_inference=True)
    cfg = dataclasses.replace(gnn_gcn.CONFIG, in_dim=ds.feat_dim,
                              out_dim=ds.num_classes, dropout=0.0)
    policy = BackendPolicy.fixed("bcsr")
    names = [f"{l}.{k}" for l, layer in enumerate(
        GNNTrainer(cfg, device=cpu).init_params()["layers"]) for k in layer]

    for opt, lr in (("adam", 1e-3), ("sgd", 0.1)):
        for epochs in (1, 2):
            res = {}
            for dev in (card, cpu):
                t0 = time.perf_counter()
                res[dev.type] = GNNTrainer(
                    cfg, optimizer=opt, lr=lr, backend=policy,
                    device=dev).fit(train, val, ds.num_classes,
                                    epochs=epochs,
                                    mesh=DataMesh([dev] * WORLD))
                print(f"{opt} lr {lr}, {epochs} epochs on {dev}: "
                      f"{time.perf_counter() - t0:.3f} s", flush=True)
            a, b = res["cuda"], res["cpu"]
            for ha, hb in zip(a.history, b.history):
                print(f"  epoch {ha['epoch']}: " + ", ".join(
                    f"{k} {ha[k]:.9f} vs {hb[k]:.9f}" for k in (
                        "train_loss", "val_loss", "val_acc")), flush=True)
            for name, x, y in zip(names, tree_leaves(a.params),
                                  tree_leaves(b.params)):
                d = (x.cpu() - y).abs()
                print(f"  {name} {tuple(x.shape)}: max diff "
                      f"{d.max().item():.3e}, beyond 1e-4 + 1e-4|y|: "
                      f"{int((d > 1e-4 + 1e-4 * y.abs()).sum())}",
                      flush=True)

    grads = {}
    for dev in (card, cpu):
        ex = ShardedPlanExecutor(DataMesh([dev] * WORLD), cfg,
                                 get_optimizer("sgd"), backend=policy)
        p = ex.place(GNNTrainer(cfg, device=cpu).init_params())
        idx, w = ex.supersteps(train.schedule)[0]
        batch, wd = ex.stage(train.cache, idx, w)
        p2, _, losses = ex.train_superstep(
            p, ex.replicate(p), get_optimizer("sgd").init(p), batch, wd,
            1.0, [None] * WORLD)
        grads[dev.type] = [(x - y).cpu() for x, y in zip(
            tree_leaves(p), tree_leaves(p2))]
        print(f"first super-step on {dev}: member losses "
              f"{[float(l) for l in losses]}", flush=True)
    for name, x, y in zip(names, grads["cuda"], grads["cpu"]):
        d = (x - y).abs()
        j = int(d.argmax())
        print(f"  gradient {name}: max diff {d.max().item():.3e} where the "
              f"CPU's is {y.flatten()[j].item():.3e}; smallest |g| "
              f"{y.abs().min().item():.3e}; elements with |g| < 1e-6: "
              f"{int((y.abs() < 1e-6).sum())}", flush=True)


if __name__ == "__main__":
    main()
