"""pinned_share.infer: share (%) of the bytes the engine staged over the
inference passes that it copied from page-locked host memory
(Σ ``pinned_bytes`` over Σ ``bytes`` of ``engine.stage``); moves
infer_nodes_per_s. None where the program's staging spans carry no
``pinned_bytes`` count.
"""
from perfbench.harness import spans


def pinned_share(snap, name):
    if not snap or snap["dropped"] > 0:
        return None
    rows = [r["attrs"] for r in snap["records"] if r["name"] == name]
    if not rows or any("pinned_bytes" not in a for a in rows):
        return None
    total = sum(a.get("bytes", 0) for a in rows)
    return 100.0 * sum(a["pinned_bytes"] for a in rows) / total \
        if total > 0 else None


def read(ctx):
    return pinned_share(spans.snapshot(), "engine.stage")
