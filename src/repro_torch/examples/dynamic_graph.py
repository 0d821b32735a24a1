"""Zero-downtime serving on a living graph (DESIGN.md §10), on the card.

    python -m repro_torch.examples.dynamic_graph [--dataset tiny] \\
        [--backend bcsr]

The dynamic-graphs loop end to end:

1. Preprocess ONCE → versioned ``Plan`` (v0), train a GCN, bring up a
   ``GNNInferenceEngine`` and serve requests.
2. The graph changes: a ``GraphDelta`` records feature drift + edge edits.
3. ``pipeline.refresh(plan, delta)`` emits plan v1 — only the batches the
   delta dirtied are rebuilt (incremental delta-PPR push decides); the
   ``PlanDelta`` audit says exactly what was rebuilt / patched / untouched.
4. ``engine.swap(v1, audit)`` hot-swaps between requests: untouched batches
   keep serving from the LRU, and the per-version stats prove traffic never
   stopped.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core import GraphDelta, IBMBConfig, IBMBPipeline, check_routing
from repro_torch.device import resolve_device
from repro_torch.examples._common import add_backend, add_device, plan_backend
from repro_torch.graph.datasets import get_dataset
from repro_torch.models.gnn import GNNConfig
from repro_torch.serve import GNNInferenceEngine
from repro_torch.train import GNNTrainer


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="tiny",
                    choices=["tiny", "small", "arxiv-like"])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=20)
    add_device(ap)
    add_backend(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = get_dataset(args.dataset)
    test = ds.splits["test"]

    # -- v0: plan once, train once, serve -------------------------------
    pipe = IBMBPipeline(ds, IBMBConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=16,
        pad_multiple=32, backend=plan_backend(args.backend)))
    plan = pipe.plan("test", for_inference=True)
    check_routing(plan)
    print(f"v0: {plan.num_batches} batches, fingerprint {plan.fingerprint}")

    cfg = GNNConfig(kind="gcn", in_dim=ds.feat_dim, hidden=64,
                    out_dim=ds.num_classes, num_layers=3)
    trainer = GNNTrainer(cfg, lr=1e-3, backend=args.backend, device=dev)
    train_plan = pipe.plan("train")
    val_plan = pipe.plan("val", for_inference=True)
    res = trainer.fit(train_plan, val_plan, ds.num_classes,
                      epochs=args.epochs)
    engine = GNNInferenceEngine(plan, cfg, res.params, backend=args.backend,
                                cache_batches=plan.num_batches, device=dev)
    rng = np.random.default_rng(0)
    first_q = rng.choice(test, size=min(8, len(test)), replace=False)
    first = engine.query(first_q)
    for _ in range(args.requests - 1):
        engine.query(rng.choice(test, size=min(8, len(test)), replace=False))
    runs_v0 = engine.stats["batch_runs"]
    hits_v0 = engine.stats["lru_hits"]
    print(f"v0: served {args.requests} requests with {runs_v0} batch "
          f"forwards ({hits_v0} LRU hits)")

    # -- the graph changes: payload drift on one batch's private nodes ---
    # (the steady-state dynamic case — features move, topology holds; an
    # edge edit would instead re-derive influence scores incrementally)
    others = set()
    for i in range(1, plan.num_batches):
        m = plan.node_ids[i]
        others |= set(m[m >= 0].tolist())
    m0 = plan.node_ids[0]
    upd = np.array(sorted(set(m0[m0 >= 0].tolist()) - others)[:8])
    delta = GraphDelta(
        feat_nodes=upd,
        feat_values=ds.features[upd]
        + rng.normal(0, 1, (len(upd), ds.feat_dim)).astype(np.float32))
    print(f"\ndelta: {delta.summary()}")

    t0 = time.time()
    child, audit = pipe.refresh(plan, delta)
    print(f"refresh → v{child.version} in {time.time()-t0:.2f}s: "
          f"{audit.summary()}")
    check_routing(child)
    assert child.parent == plan.fingerprint

    # -- zero-downtime hot swap ------------------------------------------
    swap = engine.swap(child, audit)
    print(f"swap: invalidated {swap['invalidated']} LRU entries, "
          f"kept {swap['kept']} serving")
    for _ in range(args.requests):
        engine.query(rng.choice(test, size=min(8, len(test)), replace=False))
    new_runs = engine.stats["batch_runs"] - runs_v0
    assert new_runs <= len(audit.dirty), \
        f"untouched batches re-ran after swap ({new_runs} runs)"
    print(f"v1: served {args.requests} more requests with only {new_runs} "
          f"new batch forwards (dirty set was {len(audit.dirty)})")
    versions = {}
    for v, s in sorted(engine.stats["versions"].items()):
        print(f"  version {v}: requests={s['requests']} "
              f"lru_hits={s['lru_hits']} batch_runs={s['batch_runs']} "
              f"hit_rate={s['hit_rate']:.2f}")
        versions[v] = {k: s[k] for k in ("requests", "lru_hits",
                                         "batch_runs")}
    print(f"swap_count={engine.stats['swap_count']} "
          f"evictions={engine.stats['evictions']}")
    print("\nOK: traffic never stopped across the plan swap")
    return dict(
        batches=plan.num_batches, fingerprint=plan.fingerprint,
        batch_runs_v0=runs_v0, lru_hits_v0=hits_v0,
        delta=delta.summary(), refresh=audit.summary(),
        child_version=child.version, child_fingerprint=child.fingerprint,
        invalidated=swap["invalidated"], kept=swap["kept"],
        new_runs=new_runs, dirty=len(audit.dirty), versions=versions,
        swap_count=engine.stats["swap_count"],
        evictions=engine.stats["evictions"],
        train_batches=train_plan.num_batches,
        val_batches=val_plan.num_batches, epochs_run=len(res.history),
        total_batch_runs=engine.stats["batch_runs"],
        num_layers=cfg.num_layers, best_val_acc=res.best_val_acc,
        backend=args.backend,
        served=dict(plan=plan, cfg=cfg, params=res.params,
                    backend=args.backend, query=first_q, logits=first))


if __name__ == "__main__":
    main()
