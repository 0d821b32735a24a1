"""Plan-build autotuner: tile-shape search + per-batch backend decisions.

DESIGN.md §14. Preprocessing already measures every batch exactly (IBMB
batches are frozen), so the backend/tile choice can be made ONCE, at plan
build time, and stored in the Plan (format v3) instead of re-guessed at
serving time. Three decisions live here, all DETERMINISTIC analytic
functions of batch structure — never wall-clock measurements, so the same
plan always tunes to the same answer and the choice can be pinned by the
config fingerprint:

* **Tile block B** (per plan — every batch in a cache shares the
  (R, K, B, B) tile shape): sweep ``IBMBConfig.tune_blocks`` candidates and
  keep the one minimizing the padded MXU work the SpMM actually executes,
  ``Σ_batches nonzero_tiles(B) · B²``. Ties break to the LARGER block
  (fewer, denser tiles amortize fixed per-tile cost).
* **Backend** (per batch): bcsr beats the segment path when the padded
  tile flops it does are within ``auto_kappa`` of the exact per-edge work
  the COO gather does — ``nonzero_tiles · B² ≤ auto_kappa · num_edges``.
  Low-fill batches (scattered adjacency the reordering could not bunch)
  stay on the segment path; a plan can mix.
* **Feature-tile width block_f** (per batch): the widest
  ``tune_block_fs`` candidate whose fused-kernel working set — one K-row
  of value tiles + double-buffered x stripes + the output block — fits the
  ``tune_vmem_kb`` budget.

The streaming (out-of-core) builder makes the SAME decisions from the same
inputs (``repro.ooc.stream``), so resident and streamed plans stay
bitwise-identical — including the stored decision arrays.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.batches import PaddedBatch


def tile_shape_stats(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                     mn: int, block: int) -> Tuple[int, int]:
    """(nonzero_tiles, K) of the block-CSR that ``csr_to_bcsr`` would emit
    for this COO adjacency at tile size ``block`` — computed analytically
    (one ``np.unique``), no tiles materialized. Zero-weight (padded)
    entries are dropped exactly as the converter drops them."""
    nz = np.asarray(w) != 0
    rows = np.asarray(src, np.int64)[nz] // block
    cols = np.asarray(dst, np.int64)[nz] // block
    if len(rows) == 0:
        return 0, 1
    c_tiles = (mn + block - 1) // block
    keys = np.unique(rows * c_tiles + cols)
    k = int(np.bincount(keys // c_tiles).max())
    return int(len(keys)), max(k, 1)


def tile_block_candidates(cfg, mn: int) -> List[int]:
    """Effective candidate blocks: the configured default plus the sweep
    list, each gcd'd with the padded node count exactly as
    ``build_batches`` folds them, deduplicated, ascending."""
    cand = {math.gcd(int(cfg.bcsr_block), mn)}
    for c in getattr(cfg, "tune_blocks", ()) or ():
        cand.add(math.gcd(int(c), mn))
    return sorted(b for b in cand if b >= 1)


def pick_tile_block(costs: Dict[int, int]) -> int:
    """argmin over ``{block: Σ nonzero_tiles·B²}``; ties → larger block."""
    return min(costs, key=lambda b: (costs[b], -b))


def tune_block_f(k: int, block: int, candidates: Sequence[int],
                 vmem_kb: int) -> int:
    """Widest feature-tile width whose fused-kernel working set fits the
    VMEM budget: one (K, B, B) row of value tiles, ``nbuf`` (B, block_f)
    x stripes, and the (B, block_f) output accumulator, all float32."""
    if not candidates:
        return 0
    nbuf = 2 if k > 1 else 1
    budget = int(vmem_kb) * 1024
    vals = 4 * k * block * block
    fit = [c for c in sorted(int(c) for c in candidates)
           if vals + 4 * (nbuf + 1) * block * c <= budget]
    return fit[-1] if fit else int(min(int(c) for c in candidates))


def batch_tile_stats(batch: PaddedBatch) -> dict:
    """JSON-safe per-batch structure record: tile population (at the
    batch's built block shape) + the degree stats the backend decision is
    driven by. This is what plan meta stores as ``batch_stats``."""
    nodes = batch.num_real_nodes
    edges = batch.num_real_edges
    out = dict(nodes=nodes, edges=edges,
               avg_degree=float(edges) / max(nodes, 1))
    if batch.has_bcsr:
        s = batch.bcsr_stats()
        out.update(block=int(batch.tile_vals.shape[-1]),
                   nonzero_tiles=int(s["nonzero_tiles"]),
                   max_tiles_per_row=int(s["max_tiles_per_row"]),
                   tile_fill=float(s["tile_fill"]))
    return out


def decide_backend(stats: dict, auto_kappa: float) -> str:
    """bcsr iff the padded tile flops stay within ``auto_kappa`` of the
    segment path's exact per-edge work (equivalently: tile fill is at
    least 1/kappa of dense). Batches without tiles have no choice."""
    if "nonzero_tiles" not in stats:
        return "segment"
    block = stats["block"]
    padded = stats["nonzero_tiles"] * block * block
    return "bcsr" if padded <= auto_kappa * max(stats["edges"], 1) else "segment"


def decide_batches(batches: Sequence[PaddedBatch], cfg
                   ) -> Tuple[List[str], List[int], List[dict]]:
    """The per-batch half of the autotuner: ``(backends, block_fs, stats)``
    aligned with ``batches``. Pure function of the built batches + config,
    so the resident and streaming builders (which call it chunk by chunk)
    can never diverge. With ``autotune=False`` the decision degenerates to
    the configured backend for every batch (stats are still recorded)."""
    backends: List[str] = []
    block_fs: List[int] = []
    stats: List[dict] = []
    for b in batches:
        s = batch_tile_stats(b)
        if not b.has_bcsr:
            backend = cfg.backend if cfg.backend in ("segment", "dense") \
                else "segment"
        elif getattr(cfg, "autotune", True):
            backend = decide_backend(s, getattr(cfg, "auto_kappa", 16.0))
        else:
            backend = "bcsr"
        bf = 0
        if backend == "bcsr":
            bf = tune_block_f(b.tile_cols.shape[1], b.tile_vals.shape[-1],
                              getattr(cfg, "tune_block_fs", ()),
                              getattr(cfg, "tune_vmem_kb", 8192))
        s["backend"] = backend
        s["block_f"] = bf
        backends.append(backend)
        block_fs.append(bf)
        stats.append(s)
    return backends, block_fs, stats


class _CacheBatchView:
    """Adapter presenting one stacked-cache entry through the few
    ``PaddedBatch`` accessors :func:`decide_batches` touches — the refresh
    path (``core.update``) splices caches rather than keeping batch
    objects, but must make the SAME decisions."""

    def __init__(self, arrays: dict, meta: dict):
        self.tile_cols = arrays.get("tile_cols")
        self.tile_vals = arrays.get("tile_vals")
        self._arrays = arrays
        self._meta = meta

    @property
    def has_bcsr(self) -> bool:
        return self.tile_cols is not None and self.tile_vals is not None

    @property
    def num_real_nodes(self) -> int:
        n = self._meta.get("nodes", 0)
        return int(n) if n else int(np.count_nonzero(
            self._arrays["node_mask"]))

    @property
    def num_real_edges(self) -> int:
        e = self._meta.get("edges", 0)
        return int(e) if e else int(np.count_nonzero(
            self._arrays["edge_weight"]))

    def bcsr_stats(self) -> dict:
        from repro_torch.kernels.spmm.ops import BCSR
        n = self.tile_vals.shape[0] * self.tile_vals.shape[-1]
        return BCSR(self.tile_cols, self.tile_vals, n, n).density_stats()


def decide_cache(cache, cfg) -> Tuple[List[str], List[int], List[dict]]:
    """:func:`decide_batches` over an already-stacked ``BatchCache`` —
    used by the plan-refresh path, which splices parent/rebuilt payload
    instead of keeping ``PaddedBatch`` objects around."""
    views = [_CacheBatchView(cache[i], cache.meta[i])
             for i in range(len(cache))]
    return decide_batches(views, cfg)


def sweep_tile_blocks(batches: Sequence[PaddedBatch],
                      candidates: Sequence[int]
                      ) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Candidate sweep over BUILT batches (resident path): per candidate
    block, the total padded-flops cost and the global K the cache would
    pad to. Works off the padded COO arrays, so it never needs the tiles
    that were (or were not) built."""
    mn = int(batches[0].node_ids.shape[0])
    costs = {b: 0 for b in candidates}
    kmax = {b: 1 for b in candidates}
    for batch in batches:
        for b in candidates:
            t, k = tile_shape_stats(batch.edge_src, batch.edge_dst,
                                    batch.edge_weight, mn, b)
            costs[b] += t * b * b
            kmax[b] = max(kmax[b], k)
    return costs, kmax


def retile_batches(batches: Sequence[PaddedBatch], block: int,
                   pad_k: int) -> List[PaddedBatch]:
    """Re-emit every batch's block-CSR tiles at tile size ``block`` padded
    to ``pad_k`` slots — from the padded COO edge arrays, which carry the
    exact (reordered) batch adjacency with weight-0 padding the converter
    drops. Bitwise-identical to having built at ``block`` directly (the
    streaming builder does exactly that)."""
    import dataclasses

    from repro_torch.graph.csr import coo_to_csr
    from repro_torch.kernels.spmm.ops import csr_to_bcsr

    mn = int(batches[0].node_ids.shape[0])
    out = []
    for batch in batches:
        nz = batch.edge_weight != 0
        sub = coo_to_csr(batch.edge_src[nz], batch.edge_dst[nz], mn,
                         weights=batch.edge_weight[nz])
        bc = csr_to_bcsr(sub.indptr, sub.indices, sub.weights, mn, mn,
                         block=block, pad_k=pad_k)
        out.append(dataclasses.replace(batch, tile_cols=bc.tile_cols,
                                       tile_vals=bc.tile_vals))
    return out


def retune_tile_block(batches: Sequence[PaddedBatch], cfg
                      ) -> Tuple[List[PaddedBatch], int]:
    """The per-plan half of the autotuner (resident path): sweep the
    candidate tile blocks, keep the winner, and retile the batches when it
    differs from what ``build_batches`` already emitted. Returns
    ``(batches, winning_block)``."""
    if not batches or not batches[0].has_bcsr:
        return list(batches), 0
    mn = int(batches[0].node_ids.shape[0])
    cand = tile_block_candidates(cfg, mn)
    built = int(batches[0].tile_vals.shape[-1])
    if len(cand) == 1:
        return list(batches), built
    costs, kmax = sweep_tile_blocks(batches, cand)
    win = pick_tile_block(costs)
    if win == built:
        return list(batches), built
    return retile_batches(batches, win, kmax[win]), win
