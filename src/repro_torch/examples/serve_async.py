"""Serving under load: the async micro-batching tier (DESIGN.md §11), on
the card.

    python -m repro_torch.examples.serve_async [--dataset tiny] \\
        [--backend bcsr]

What §8's engine does for one coalesced `run` call, `AsyncGNNEngine` does
for a live concurrent stream:

1. Stand up TWO tenants (two (plan, params) models — here the same plan
   family with independently trained weights) behind one bounded queue and
   one dispatch worker.
2. Fire a Zipf-popular burst of per-node requests from several client
   threads. Requests coalesce into micro-batching windows: dispatch when a
   full batch's worth of routed rows accumulates or the window elapses.
3. Show admission control: a request with an infeasible deadline is
   rejected on arrival instead of timing out in the queue.
4. Hot-swap tenant "a" onto a refreshed plan (§10 version chain) MID-STREAM
   — nobody's queue drains, tenant "b" never notices.
5. Print the `ServeStats` surface: throughput, windows, occupancy,
   p50/p95/p99, and the per-tenant engine counters.
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core import GraphDelta, IBMBConfig, IBMBPipeline
from repro_torch.device import resolve_device
from repro_torch.examples._common import add_backend, add_device, plan_backend
from repro_torch.graph.datasets import get_dataset
from repro_torch.models.gnn import GNNConfig
from repro_torch.serve import AsyncGNNEngine, AsyncServeConfig, GNNInferenceEngine
from repro_torch.train import GNNTrainer


def zipf_queries(rng, nodes, n, size, exponent=1.1):
    ranks = np.arange(1, len(nodes) + 1, dtype=np.float64)
    p = ranks ** -exponent
    p /= p.sum()
    pop = rng.permutation(nodes)
    return [rng.choice(pop, size=size, replace=False, p=p) for _ in range(n)]


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="tiny",
                    choices=["tiny", "small", "arxiv-like"])
    ap.add_argument("--requests", type=int, default=120,
                    help="requests per client thread")
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--request-size", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=20)
    add_device(ap)
    add_backend(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = get_dataset(args.dataset)
    pipe = IBMBPipeline(ds, IBMBConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=32,
        pad_multiple=16, backend=plan_backend(args.backend)))
    plan = pipe.plan("test", for_inference=True)
    cfg = GNNConfig(kind="gcn", in_dim=ds.feat_dim, hidden=32,
                    out_dim=ds.num_classes, num_layers=2)
    trainer = GNNTrainer(cfg, lr=1e-3, backend=args.backend, device=dev)
    train_plan = pipe.plan("train")
    val_plan = pipe.plan("val", for_inference=True)
    tenants, fits = {}, {}
    for name, seed in [("a", 0), ("b", 1)]:
        res = trainer.fit(train_plan, val_plan, ds.num_classes,
                          epochs=args.epochs, rng=seed)
        tenants[name] = GNNInferenceEngine(plan, cfg, res.params,
                                           backend=args.backend,
                                           cache_batches=max(1, len(plan)),
                                           device=dev)
        fits[name] = res
        print(f"tenant {name!r}: trained (val acc {res.best_val_acc:.3f})")

    config = AsyncServeConfig(window_us=2000.0, max_queue=10_000)
    with AsyncGNNEngine(tenants, config) as tier:
        # admission control: an impossible deadline is refused at the door
        doomed = tier.submit("a", plan.routing.node_ids[:2], deadline_ms=0.01)
        print(f"\nadmission: deadline 0.01ms → "
              f"{'rejected on arrival' if doomed.rejected else 'accepted?!'}")

        nodes = plan.routing.node_ids
        size = min(args.request_size, len(nodes))
        first = tier.submit("a", nodes[:size]).result(timeout=120)  # warm up
        tier.submit("b", nodes[:size]).result(timeout=120)

        futs, lock = [], threading.Lock()

        def client(seed, tenant):
            rng = np.random.default_rng(seed)
            mine = [tier.submit(tenant, q) for q in zipf_queries(
                rng, nodes, args.requests, size)]
            with lock:
                futs.extend(mine)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client,
                                    args=(s, "ab"[s % 2]))
                   for s in range(args.clients)]
        for t in threads:
            t.start()
        # mid-stream: refresh + hot-swap tenant "a" while clients submit
        delta_nodes = np.random.default_rng(9).choice(
            nodes, size=4, replace=False).astype(np.int64)
        child, audit = pipe.refresh(plan, GraphDelta(
            feat_nodes=delta_nodes,
            feat_values=ds.features[delta_nodes] + 0.25))
        res = tier.swap("a", child, audit)
        for t in threads:
            t.join()
        for f in futs:
            f.result(timeout=120)
        wall = time.perf_counter() - t0

        snap = tier.snapshot()
        n = len(futs)
        print(f"\nswap('a') mid-stream: plan v{child.version}, "
              f"{res['invalidated']} LRU entries invalidated, "
              f"{res['kept']} kept — tenant 'b' untouched "
              f"(swaps: a={snap['tenants']['a']['swaps']}, "
              f"b={snap['tenants']['b']['swaps']})")
        print(f"\n{n} requests from {args.clients} clients in {wall:.2f}s "
              f"({n / wall:.0f} req/s)")
        print(f"  windows {snap['windows']} "
              f"(mean {snap['mean_window_requests']:.1f} requests/window, "
              f"last occupancy {snap['window_occupancy']:.2f})")
        print(f"  latency p50 {snap['p50_us']:.0f} us   "
              f"p95 {snap['p95_us']:.0f} us   p99 {snap['p99_us']:.0f} us")
        engines = {}
        for name in ("a", "b"):
            e = snap["tenants"][name]["engine"]
            print(f"  tenant {name!r}: {e['requests']} requests → "
                  f"{e['batch_runs']} batch forwards + {e['lru_hits']} LRU "
                  f"hits, versions served {sorted(e['versions'])}")
            engines[name] = dict(requests=e["requests"],
                                 batch_runs=e["batch_runs"],
                                 lru_hits=e["lru_hits"],
                                 versions=sorted(e["versions"]))
    return dict(
        batches=len(plan), fingerprint=plan.fingerprint,
        val_acc={k: r.best_val_acc for k, r in fits.items()},
        rejected=bool(doomed.rejected), child_version=child.version,
        invalidated=res["invalidated"], kept=res["kept"],
        swaps={k: snap["tenants"][k]["swaps"] for k in ("a", "b")},
        requests=n, req_per_s=n / wall, windows=snap["windows"],
        p50_us=snap["p50_us"], p95_us=snap["p95_us"],
        p99_us=snap["p99_us"], engines=engines,
        num_layers=cfg.num_layers, backend=args.backend,
        train_batches=train_plan.num_batches,
        val_batches=val_plan.num_batches,
        epochs_run={k: len(r.history) for k, r in fits.items()},
        served=dict(plan=plan, cfg=cfg, params=fits["a"].params,
                    backend=args.backend, query=nodes[:size],
                    logits=first))


if __name__ == "__main__":
    main()
