"""Quickstart: influence-based mini-batching end to end, on the card.

    python -m repro_torch.examples.quickstart [--backend bcsr]
    python -m repro_torch.examples.quickstart --device cpu

1. Build a synthetic homophilic graph (ogbn-arxiv stand-in, 400 nodes).
2. IBMB preprocessing → a frozen `Plan` artifact (DESIGN.md §8): PPR
   influence → output-node partitioning → auxiliary selection → padded,
   contiguously-cached batches + schedule + routing index + fingerprint.
3. `Plan.save` / `IBMBPipeline.load_plan`: preprocess once, reuse across
   models/seeds/processes — the paper's amortization, as an artifact.
4. Train a GCN with the paper's recipe (Adam + plateau LR + TSP batch order)
   straight from the plan; under ``--backend bcsr`` every aggregation,
   forward and backward, is the block-CSR SpMM kernel.
5. Serve per-node requests from the loaded plan with `GNNInferenceEngine`.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core import IBMBConfig, IBMBPipeline
from repro_torch.device import resolve_device
from repro_torch.examples._common import add_backend, add_device, plan_backend
from repro_torch.graph.datasets import get_dataset
from repro_torch.models.gnn import GNNConfig
from repro_torch.serve import GNNInferenceEngine
from repro_torch.train import GNNTrainer


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=40)
    add_device(ap)
    add_backend(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = get_dataset("tiny")
    print(f"graph: {ds.num_nodes} nodes, {ds.graph.num_edges} edges, "
          f"{ds.num_classes} classes, {len(ds.splits['train'])} train nodes")

    # -- IBMB preprocessing → frozen Plan artifacts -----------------------
    t0 = time.time()
    pipe = IBMBPipeline(ds, IBMBConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=64,
        pad_multiple=32, schedule="tsp", backend=plan_backend(args.backend)))
    train_plan = pipe.plan("train")
    val_plan = pipe.plan("val", for_inference=True)
    test_plan = pipe.plan("test", for_inference=True)
    prep = time.time() - t0
    print(f"preprocessing: {prep:.2f}s → {train_plan.num_batches} "
          f"train batches, plan {train_plan.nbytes()/1e6:.1f} MB "
          f"(contiguous cache + schedule + routing index)")

    # -- save / load: compute once, reuse everywhere ----------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "test_plan.npz")
        test_plan.save(path)
        test_plan = pipe.load_plan(path, "test", for_inference=True)
    print(f"plan round-trip: saved+loaded test_plan.npz "
          f"(fingerprint {test_plan.fingerprint})")

    # -- training (paper recipe), straight from the plan ------------------
    cfg = GNNConfig(kind="gcn", in_dim=ds.feat_dim, hidden=64,
                    out_dim=ds.num_classes, num_layers=3)
    trainer = GNNTrainer(cfg, optimizer="adam", lr=1e-3,
                         backend=args.backend, device=dev)
    res = trainer.fit(train_plan, val_plan, ds.num_classes,
                      epochs=args.epochs, schedule_mode="tsp", verbose=False)
    print(f"training: best val acc {res.best_val_acc:.3f} "
          f"(epoch {res.best_epoch}), {res.time_per_epoch*1e3:.0f} ms/epoch")

    # -- batch-eval IBMB inference ----------------------------------------
    t0 = time.time()
    test = trainer.evaluate(res.params, test_plan)
    print(f"inference: test acc {test['acc']:.3f} in {time.time()-t0:.2f}s "
          f"({test_plan.num_batches} batches)")

    # -- request-level serving from the loaded artifact -------------------
    engine = GNNInferenceEngine(test_plan, cfg, res.params,
                                backend=args.backend, device=dev)
    query = np.random.default_rng(0).choice(ds.splits["test"], size=16,
                                            replace=False)
    t0 = time.time()
    logits = engine.query(query)
    print(f"serving: {len(query)}-node query → logits {logits.shape} in "
          f"{(time.time()-t0)*1e3:.1f} ms "
          f"({engine.stats['batch_runs']} batch forwards)")
    return dict(
        num_nodes=ds.num_nodes, num_edges=ds.graph.num_edges,
        num_classes=ds.num_classes, num_train=len(ds.splits["train"]),
        preprocess_s=prep, train_batches=train_plan.num_batches,
        val_batches=val_plan.num_batches, train_plan_nbytes=train_plan.nbytes(),
        fingerprint=test_plan.fingerprint, best_val_acc=res.best_val_acc,
        best_epoch=res.best_epoch, ms_per_epoch=res.time_per_epoch * 1e3,
        epochs_run=len(res.history), test_acc=test["acc"],
        test_loss=test["loss"], test_batches=test_plan.num_batches,
        batch_runs=engine.stats["batch_runs"], num_layers=cfg.num_layers,
        backend=args.backend,
        served=dict(plan=test_plan, cfg=cfg, params=res.params,
                    backend=args.backend, query=query, logits=logits))


if __name__ == "__main__":
    main()
