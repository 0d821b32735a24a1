"""Request-level GNN serving from a frozen Plan artifact (DESIGN.md §8).

    python -m repro_torch.examples.serve_gnn [--dataset tiny] [--backend bcsr]

The paper's serving story end to end, on the card:

1. Preprocess ONCE → `Plan` (batches + schedule + routing index), saved to
   disk.
2. Train a GCN from the same plan family (preprocessing is shared across
   models/seeds — the paper's amortization).
3. `Plan.load` in a "server": no re-preprocessing on the request path.
4. Stream per-node requests through `GNNInferenceEngine`: routing index →
   coalesced batch forwards → LRU for repeat traffic. Prints request-latency
   percentiles and the coalescing/caching counters.
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
from repro_torch.serve import GNNInferenceEngine, GNNRequest
from repro_torch.train import GNNTrainer


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="tiny",
                    choices=["tiny", "small", "arxiv-like"])
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--request-size", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=30)
    add_device(ap)
    add_backend(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = get_dataset(args.dataset)

    # -- offline: preprocess once, save the artifact ----------------------
    pipe = IBMBPipeline(ds, IBMBConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=64,
        pad_multiple=32, backend=plan_backend(args.backend)))
    t0 = time.time()
    test_plan = pipe.plan("test", for_inference=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "test_plan.npz")
        test_plan.save(path)
        print(f"offline: preprocessed + saved plan in {time.time()-t0:.2f}s "
              f"({test_plan.num_batches} batches, "
              f"{test_plan.nbytes()/1e6:.1f} MB, "
              f"fingerprint {test_plan.fingerprint})")

        cfg = GNNConfig(kind="gcn", in_dim=ds.feat_dim, hidden=64,
                        out_dim=ds.num_classes, num_layers=3)
        trainer = GNNTrainer(cfg, lr=1e-3, backend=args.backend, device=dev)
        train_plan = pipe.plan("train")
        val_plan = pipe.plan("val", for_inference=True)
        res = trainer.fit(train_plan, val_plan, ds.num_classes,
                          epochs=args.epochs)
        print(f"offline: trained GCN, val acc {res.best_val_acc:.3f}")

        # -- online: load the artifact, serve queries ---------------------
        t0 = time.time()
        plan = pipe.load_plan(path, "test", for_inference=True)
    engine = GNNInferenceEngine(plan, cfg, res.params, backend=args.backend,
                                cache_batches=4, device=dev)
    print(f"online: plan loaded + engine up in {time.time()-t0:.2f}s "
          f"(no re-preprocessing)")

    rng = np.random.default_rng(0)
    test = ds.splits["test"]
    size = min(args.request_size, len(test))
    first = engine.query(test[:size])          # warm up outside the timing
    lat_us = []
    for _ in range(args.requests):
        q = rng.choice(test, size=size, replace=False)
        t0 = time.perf_counter()
        engine.query(q)
        lat_us.append((time.perf_counter() - t0) * 1e6)
    p50, p95, p99 = (np.percentile(lat_us, p) for p in (50, 95, 99))
    print(f"\nserved {args.requests} sequential requests of {size} nodes:")
    print(f"  latency p50 {p50:.0f} us   p95 {p95:.0f} us   p99 {p99:.0f} us")
    s = engine.stats
    print(f"  {s['batch_runs']} batch forwards for {s['requests']} requests "
          f"({s['lru_hits']} LRU hits) — repeat traffic never re-runs a batch")
    seq = dict(batch_runs=s["batch_runs"], requests=s["requests"],
               lru_hits=s["lru_hits"])

    # concurrent burst: coalescing shares one forward per batch
    burst = [GNNRequest(node_ids=rng.choice(test, size=size, replace=False))
             for _ in range(32)]
    runs_before = engine.stats["batch_runs"]
    stats = engine.run(burst)
    lat = [r.latency_s * 1e6 for r in burst]
    burst_runs = engine.stats["batch_runs"] - runs_before
    print(f"\ncoalesced burst of {len(burst)} concurrent requests: "
          f"{burst_runs} new batch forwards, "
          f"completed in {stats['time_s']*1e3:.1f} ms "
          f"(p95 request latency {np.percentile(lat, 95):.0f} us)")
    return dict(
        test_batches=test_plan.num_batches,
        test_plan_nbytes=test_plan.nbytes(), fingerprint=test_plan.fingerprint,
        best_val_acc=res.best_val_acc, p50_us=p50, p95_us=p95, p99_us=p99,
        **seq, burst_runs=burst_runs, burst_ms=stats["time_s"] * 1e3,
        train_batches=train_plan.num_batches,
        val_batches=val_plan.num_batches, epochs_run=len(res.history),
        total_batch_runs=engine.stats["batch_runs"],
        num_layers=cfg.num_layers, backend=args.backend,
        served=dict(plan=plan, cfg=cfg, params=res.params,
                    backend=args.backend, query=test[:size], logits=first))


if __name__ == "__main__":
    main()
