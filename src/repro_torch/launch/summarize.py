"""Summarize results/dryrun/*.json into the roofline tables; a copy of
``repro.launch.summarize`` (stdlib only).

    PYTHONPATH=src python -m repro_torch.launch.summarize [--dir results/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load(dir_: str) -> List[Dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    return f"{b/1e9:.1f}"


def roofline_table(cells: List[Dict], mesh: str = "single") -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "useful | roofline frac | HBM GB/chip | compile s |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for d in cells:
        if d.get("mesh") != mesh:
            continue
        tag = f"| {d['arch']} | {d['shape']} "
        if "skipped" in d:
            lines.append(tag + "| — | — | — | skipped (full-attn, needs sub-quadratic) | — | — | — | — |")
            continue
        if "error" in d:
            lines.append(tag + f"| — | — | — | ERROR {d['error'][:40]} | — | — | — | — |")
            continue
        r = d["roofline"]
        lines.append(
            tag + f"| {r['compute_s']:.2e} | {r['memory_s']:.2e} | "
            f"{r['collective_s']:.2e} | {r['dominant'].replace('_s','')} | "
            f"{(d.get('useful_ratio') or 0):.2f} | "
            f"{(r.get('roofline_fraction') or 0):.4f} | "
            f"{fmt_bytes(d['memory']['peak_bytes'])} | "
            f"{d.get('compile_s','-')} |")
    return "\n".join(lines)


def multi_pod_proof(cells: List[Dict]) -> str:
    ok = sum(1 for d in cells if d.get("mesh") == "multi" and "roofline" in d)
    skip = sum(1 for d in cells if d.get("mesh") == "multi" and "skipped" in d)
    err = [d for d in cells if d.get("mesh") == "multi" and "error" in d]
    lines = [f"multi-pod (2×16×16 = 512 chips): {ok} cells compiled, "
             f"{skip} skipped (sub-quadratic rule), {len(err)} errors."]
    for d in err:
        lines.append(f"  ERROR {d['arch']}×{d['shape']}: {d['error'][:120]}")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    cells = load(args.dir)
    print(roofline_table(cells, args.mesh))
    print()
    print(multi_pod_proof(cells))


if __name__ == "__main__":
    main()
