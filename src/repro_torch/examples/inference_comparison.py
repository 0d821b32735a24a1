"""Paper Fig. 2 in miniature, on the card: one pretrained GCN, every
mini-batching method evaluated on the same weights — accuracy vs inference
wall time.

    python -m repro_torch.examples.inference_comparison [--backend bcsr]

The IBMB plans run ``--backend``; the five baselines' raw batch lists
carry no tiles, so they are evaluated on the segment path whatever it says.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

from repro_torch.core import IBMBConfig, IBMBPipeline
from repro_torch.device import resolve_device
from repro_torch.examples._common import add_backend, add_device, plan_backend
from repro_torch.graph.datasets import get_dataset
from repro_torch.graph.sampling import make_batcher
from repro_torch.models.gnn import GNNConfig
from repro_torch.train import GNNTrainer

BASELINES = [("cluster_gcn", {"num_batches": 8}),
             ("neighbor_sampling", {"num_batches": 8}),
             ("graphsaint_rw", {"num_steps": 8, "batch_roots": 400}),
             ("shadow_ppr", {"outputs_per_batch": 256}),
             ("full_batch", {})]


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=25)
    add_device(ap)
    add_backend(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = get_dataset("small")
    backend = plan_backend(args.backend)
    pipe = IBMBPipeline(ds, IBMBConfig(variant="node", k_per_output=8,
                                       max_outputs_per_batch=256,
                                       backend=backend))
    cfg = GNNConfig(kind="gcn", in_dim=ds.feat_dim, hidden=64,
                    out_dim=ds.num_classes, num_layers=3)
    trainer = GNNTrainer(cfg, lr=1e-3, backend=args.backend, device=dev)
    train_plan = pipe.plan("train")
    val_plan = pipe.plan("val", for_inference=True)
    res = trainer.fit(train_plan, val_plan, ds.num_classes,
                      epochs=args.epochs)
    print(f"pretrained GCN: val acc {res.best_val_acc:.3f}\n")
    print(f"{'method':22s} {'test acc':>9s} {'time (s)':>9s}")
    # the baselines' batches carry no tiles: the segment path, same weights
    segment = GNNTrainer(cfg, lr=1e-3, backend="segment", device=dev)
    methods = {}

    def bench(name, batches, tr):                # Plan or raw batch list
        t0 = time.time()
        m = tr.evaluate(res.params, batches)
        s = time.time() - t0
        print(f"{name:22s} {m['acc']:9.3f} {s:9.2f}")
        methods[name] = dict(acc=m["acc"], loss=m["loss"], time_s=s,
                             batches=len(batches))

    bench("ibmb_node", pipe.plan("test", for_inference=True), trainer)
    pipe_b = IBMBPipeline(ds, IBMBConfig(variant="batch", num_batches=8,
                                         max_outputs_per_batch=256,
                                         backend=backend))
    bench("ibmb_batch", pipe_b.plan("test", for_inference=True), trainer)
    for name, kw in BASELINES:
        bench(name, make_batcher(name, ds, split="test",
                                 **kw).epoch_batches(0), segment)
    return dict(best_val_acc=res.best_val_acc, methods=methods,
                train_batches=train_plan.num_batches,
                val_batches=val_plan.num_batches,
                epochs_run=len(res.history), num_layers=cfg.num_layers,
                cfg=cfg, backend=args.backend, params=res.params)


if __name__ == "__main__":
    main()
