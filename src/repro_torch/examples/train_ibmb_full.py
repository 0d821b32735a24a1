"""End-to-end training driver: the paper's full recipe on a synthetic
dataset, on the card, with a checkpoint of the best parameters.

    python -m repro_torch.examples.train_ibmb_full \\
        --dataset arxiv-like --model gcn --variant node --epochs 60 \\
        --backend bcsr

Features exercised: PPR preprocessing, TSP batch scheduling, plateau LR
schedule, early stopping, checkpointing, IBMB mini-batched evaluation.
Under ``--backend bcsr`` the GCN aggregates through the block-CSR SpMM
kernel and SAGE through its pattern mode; GAT aggregates on the segment
path whatever the backend.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Sequence

from repro_torch.checkpoint import Checkpointer
from repro_torch.core import IBMBConfig, IBMBPipeline
from repro_torch.device import resolve_device
from repro_torch.examples._common import add_backend, add_device, plan_backend
from repro_torch.graph.datasets import get_dataset
from repro_torch.models.gnn import GNNConfig
from repro_torch.train import GNNTrainer


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="small",
                    choices=["tiny", "small", "arxiv-like", "products-like",
                             "reddit-like"])
    ap.add_argument("--model", default="gcn", choices=["gcn", "gat", "sage"])
    ap.add_argument("--variant", default="node",
                    choices=["node", "batch", "random"])
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--k", type=int, default=16,
                    help="auxiliary nodes per output (the paper's main knob)")
    ap.add_argument("--outputs-per-batch", type=int, default=1024)
    ap.add_argument("--schedule", default="tsp",
                    choices=["tsp", "weighted", "none"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--plan-dir", default=None,
                    help="save the train/val/test Plan artifacts here")
    add_device(ap)
    add_backend(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = get_dataset(args.dataset)
    print(f"{args.dataset}: {ds.num_nodes} nodes, {ds.graph.num_edges} edges, "
          f"{len(ds.splits['train'])} train")

    t0 = time.time()
    pipe = IBMBPipeline(ds, IBMBConfig(
        variant=args.variant, k_per_output=args.k,
        max_outputs_per_batch=args.outputs_per_batch,
        schedule=args.schedule, backend=plan_backend(args.backend)))
    tr_b = pipe.plan("train")
    va_b = pipe.plan("val", for_inference=True)
    te_b = pipe.plan("test", for_inference=True)
    prep = time.time() - t0
    if args.plan_dir:        # persist the artifacts: preprocess once, reuse
        os.makedirs(args.plan_dir, exist_ok=True)
        for name, p in [("train", tr_b), ("val", va_b), ("test", te_b)]:
            p.save(os.path.join(args.plan_dir, f"{name}_plan.npz"))
        print(f"saved plans to {args.plan_dir} "
              f"(fingerprints {tr_b.fingerprint}/{va_b.fingerprint}/"
              f"{te_b.fingerprint})")
    shp = tr_b.cache.fields["features"].shape
    n_edges = tr_b.cache.fields["edge_src"].shape[1]
    print(f"preprocess {prep:.1f}s → {len(tr_b)} train batches "
          f"(shape {shp[1]} nodes × {n_edges} edges, static)")

    cfg = GNNConfig(kind=args.model, in_dim=ds.feat_dim,
                    hidden=256 if args.dataset != "tiny" else 64,
                    out_dim=ds.num_classes, num_layers=3)
    trainer = GNNTrainer(cfg, optimizer="adam", lr=1e-3,
                         weight_decay=1e-4 if args.model == "gcn" else 0.0,
                         backend=args.backend, device=dev)
    res = trainer.fit(tr_b, va_b, ds.num_classes, epochs=args.epochs,
                      schedule_mode=args.schedule, verbose=True,
                      preprocess_time=prep)

    if args.ckpt_dir:
        ck = Checkpointer(args.ckpt_dir)
        ck.save(res.params, res.best_epoch, blocking=True)
        print(f"checkpointed best params to {args.ckpt_dir}")

    test = trainer.evaluate(res.params, te_b)
    print(f"\nfinal: val {res.best_val_acc:.4f}  test {test['acc']:.4f}  "
          f"{res.time_per_epoch*1e3:.0f} ms/epoch  preprocess {prep:.1f}s "
          f"({100*prep/max(res.total_time,1e-9):.1f}% of train time)")
    return dict(
        num_nodes=ds.num_nodes, num_edges=ds.graph.num_edges,
        num_train=len(ds.splits["train"]),
        fingerprints=(tr_b.fingerprint, va_b.fingerprint, te_b.fingerprint),
        train_batches=len(tr_b), val_batches=len(va_b),
        test_batches=len(te_b), max_nodes=int(shp[1]),
        max_edges=int(n_edges), hidden=cfg.hidden, preprocess_s=prep,
        best_val_acc=res.best_val_acc, best_epoch=res.best_epoch,
        test_acc=test["acc"], test_loss=test["loss"],
        ms_per_epoch=res.time_per_epoch * 1e3, epochs_run=len(res.history),
        history=res.history, num_layers=cfg.num_layers, cfg=cfg,
        backend=args.backend, params=res.params, test_plan=te_b)


if __name__ == "__main__":
    main()
