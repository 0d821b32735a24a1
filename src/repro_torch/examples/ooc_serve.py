"""Serving a plan bigger than the memory you give it (DESIGN.md §13), on
the card.

    python -m repro_torch.examples.ooc_serve [--dataset small] \\
        [--backend bcsr]

The out-of-core story end to end:

1. Stream-preprocess: `pipe.plan(..., out_of_core=True)` builds batches
   chunk by chunk straight into an on-disk `PlanStore` — peak host memory
   is one chunk, not the payload, and the fingerprint is bitwise-identical
   to the resident build.
2. Reopen the store O(metadata) and serve through `GNNInferenceEngine`
   with a bounded resident-batch LRU: only routed batches fault in from
   disk (checksum-verified per read), evicting under the budget.
3. Shard the same split into self-contained per-host stores with a
   fingerprint-chained manifest; `ShardRouter` fans queries out to owning
   shards and merges — still bitwise equal to the monolithic engine.

The GCN is untrained: ``init_gnn`` from a CPU generator seeded 0, so the
card and the CPU serve the same weights (``run(args, params=...)`` serves
others).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import IBMBConfig, IBMBPipeline
from repro_torch.device import resolve_device
from repro_torch.examples._common import add_backend, add_device, plan_backend
from repro_torch.graph.datasets import get_dataset
from repro_torch.models.gnn import GNNConfig, init_gnn
from repro_torch.ooc import OOCConfig, PlanStore, ShardRouter, build_shards
from repro_torch.serve import GNNInferenceEngine


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="small",
                    choices=["tiny", "small", "arxiv-like"])
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--request-size", type=int, default=16)
    ap.add_argument("--resident-batches", type=int, default=4)
    ap.add_argument("--shards", type=int, default=3)
    add_device(ap)
    add_backend(ap)
    return ap


def run(args: argparse.Namespace, params: Optional[Dict] = None) -> Dict:
    dev = resolve_device(args.device)
    ds = get_dataset(args.dataset)
    pipe = IBMBPipeline(ds, IBMBConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=64,
        pad_multiple=32, backend=plan_backend(args.backend)))
    with tempfile.TemporaryDirectory() as tmp:
        return _serve(args, dev, ds, pipe, tmp, params)


def _serve(args, dev, ds, pipe, tmp: str, params) -> Dict:
    store_dir = os.path.join(tmp, "test_store")

    # -- offline: stream the build, chunk by chunk, onto disk -------------
    ooc = OOCConfig(chunk_batches=2, resident_batches=args.resident_batches)
    t0 = time.time()
    pipe.plan("test", for_inference=True, out_of_core=True,
              store_dir=store_dir, ooc=ooc)
    store = PlanStore.open(store_dir)           # O(metadata) reopen
    print(f"offline: streamed {store.num_batches} batches "
          f"({store.payload_nbytes()/1e6:.1f} MB payload) to disk in "
          f"{time.time()-t0:.2f}s, never holding more than "
          f"{ooc.chunk_batches} batches in RAM "
          f"(fingerprint {store.fingerprint})")

    # the backend rides in the config, so the shard engines run it too
    mcfg = GNNConfig(kind="gcn", in_dim=ds.feat_dim, hidden=64,
                     out_dim=ds.num_classes, num_layers=3,
                     backend=args.backend)
    if params is None:
        params = init_gnn(mcfg, torch.Generator().manual_seed(0), device=dev)

    # -- online: lazy engine under a resident-batch budget ----------------
    plan = store.as_plan(resident_batches=args.resident_batches)
    engine = GNNInferenceEngine(plan, mcfg, params, device=dev)
    rng = np.random.default_rng(0)
    test = ds.splits["test"]
    size = min(args.request_size, len(test))
    ref = engine.query(test[:size])             # warm up outside the timing
    lat_us = []
    for _ in range(args.requests):
        q = rng.choice(test, size=size, replace=False)
        t0 = time.perf_counter()
        engine.query(q)
        lat_us.append((time.perf_counter() - t0) * 1e6)
    s = plan.cache.snapshot()
    p50 = np.percentile(lat_us, 50)
    print(f"\nserved {args.requests} requests "
          f"(p50 {p50:.0f} us): "
          f"{s['loads']} disk loads, {s['hits']} cache hits, "
          f"{s['evictions']} evictions — resident {s['resident']} "
          f"batches / {s['resident_bytes']/1e6:.1f} MB of "
          f"{store.payload_nbytes()/1e6:.1f} MB payload")

    # -- sharded: one self-contained store per host, routed queries -------
    root = os.path.join(tmp, "shards")
    num_shards = min(args.shards, store.num_batches)  # tiny split → 1 batch
    build_shards(pipe, "test", num_shards, root, for_inference=True, ooc=ooc)
    router = ShardRouter.load(root, mcfg, params,
                              resident_batches=args.resident_batches,
                              device=dev)
    q = test[:size]
    routed = router.query(q)
    shards_hit = router.shards_hit(q)
    same = bool(np.array_equal(routed, ref))
    print(f"\nsharded into {num_shards} stores: query of {size} nodes hit "
          f"{shards_hit} shard(s), logits bitwise equal to "
          f"the monolithic engine: {same}")
    return dict(
        batches=store.num_batches, payload_nbytes=store.payload_nbytes(),
        fingerprint=store.fingerprint, p50_us=p50,
        loads=s["loads"], hits=s["hits"], evictions=s["evictions"],
        resident=s["resident"], resident_bytes=s["resident_bytes"],
        num_shards=num_shards, shards_hit=shards_hit, bitwise_equal=same,
        batch_runs=engine.stats["batch_runs"], num_layers=mcfg.num_layers,
        backend=args.backend,
        query=q, logits=ref, routed=routed)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
