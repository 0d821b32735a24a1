"""built_share.train: share (%) of the batch bytes the loader's worker
staged in the training window that it made on the card from each batch's
edges instead of copying them (Σ ``built_bytes`` over Σ ``bytes`` + Σ
``built_bytes`` of ``loader.stage``, whose ``bytes`` are what it copied);
moves train_nodes_per_s. None where the program's staging spans carry no
``built_bytes`` count.
"""
from perfbench.harness import spans


def built_share(snap, name):
    if not snap or snap["dropped"] > 0:
        return None
    rows = [r["attrs"] for r in snap["records"] if r["name"] == name]
    if not rows or any("built_bytes" not in a for a in rows):
        return None
    built = sum(a["built_bytes"] for a in rows)
    total = sum(a.get("bytes", 0) for a in rows) + built
    return 100.0 * built / total if total > 0 else None


def read(ctx):
    return built_share(spans.snapshot(), "loader.stage")
