#!/usr/bin/env python3
"""What the plan-build autotuner decides on the synthetic datasets.

    python3 plan_survey.py [--out FILE]

Builds the test-split inference Plans of ``arxiv-like`` and ``reddit-like``
with the port (``src/repro_torch``, host-side numpy only, no card needed)
for the bcsr backend, at the default tile block and with a tile-size sweep,
and prints per batch the tile shape, the tile fill, the padded work of the
block-CSR SpMM against the edges it carries, and the autotuner's backend
decision. Memory: the arxiv-like B=128 plan holds about 1 GB of tiles.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

CASES = (("arxiv-like", {}),
         ("arxiv-like", {"tune_blocks": (16, 32, 64)}),
         ("reddit-like", {"tune_blocks": (16, 32, 64)}))


def survey(name, tune):
    from repro_torch.core import IBMBConfig, IBMBPipeline
    from repro_torch.graph.datasets import get_dataset

    t0 = time.perf_counter()
    plan = IBMBPipeline(get_dataset(name), IBMBConfig(
        variant="node", backend="bcsr", **tune)).plan(
            "test", for_inference=True)
    tv = plan.cache.fields["tile_vals"]
    _n, r, k, b, _ = tv.shape
    batches = []
    for s, backend in zip(plan.meta["batch_stats"], plan.batch_backends()):
        batches.append(dict(
            nodes=s["nodes"], edges=s["edges"],
            nonzero_tiles=s["nonzero_tiles"], tile_fill=s["tile_fill"],
            padded_entries_per_edge=r * k * b * b / max(s["edges"], 1),
            backend=backend))
    return dict(dataset=name, tune=tune, batches=len(plan),
                max_nodes=int(plan.cache.fields["features"].shape[1]),
                R=r, K=k, B=b, tile_vals_bytes=int(tv.nbytes),
                build_s=time.perf_counter() - t0, per_batch=batches)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the records as JSON lines")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    rows = []
    for name, tune in CASES:
        row = survey(name, tune)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)


if __name__ == "__main__":
    main()
