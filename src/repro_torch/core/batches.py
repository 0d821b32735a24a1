"""Induced-subgraph mini-batches with static TPU-friendly shapes.

The paper's systems insight: batches are PRECOMPUTED and cached in consecutive
memory so training/inference does contiguous reads instead of random gathers.
On TPU this pays twice — XLA requires static shapes, and IBMB's fixed batches
let us pad ONCE at preprocessing time to a single (max_nodes, max_edges)
shape, so every step reuses one compiled executable and the host→device DMA
reads one contiguous buffer per batch.

When ``bcsr_block`` is set, preprocessing additionally emits a per-batch
padded block-CSR adjacency (DESIGN.md §7) — after a batch-local node
reordering that concentrates nonzeros into diagonal tiles — so the GNN
aggregation can run as dense MXU matmuls over nonzero tiles instead of
COO gathers + segment sums.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.graph.csr import CSRGraph, coo_to_csr, induced_subgraph


@dataclasses.dataclass
class PaddedBatch:
    """One IBMB mini-batch, padded to static shapes.

    node_ids:    (max_nodes,) int32, -1 padded — global ids of batch nodes
    node_mask:   (max_nodes,) bool
    edge_src:    (max_edges,) int32 — local indices (into node_ids)
    edge_dst:    (max_edges,) int32
    edge_weight: (max_edges,) float32 — global GCN normalization (paper App. B)
    edge_mask:   (max_edges,) bool
    output_idx:  (max_outputs,) int32 — local indices of output nodes, -1 pad
    output_mask: (max_outputs,) bool
    features:    (max_nodes, F) float32 — gathered once, cached contiguously
    labels:      (max_outputs,) int32 — labels of output nodes, 0 padded
    tile_cols:   (R, K) int32 block-CSR column-tile ids (DESIGN.md §7), or None
    tile_vals:   (R, K, B, B) float32 block-CSR tiles (R·B == max_nodes), or None
    """

    node_ids: np.ndarray
    node_mask: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_weight: np.ndarray
    edge_mask: np.ndarray
    output_idx: np.ndarray
    output_mask: np.ndarray
    features: Optional[np.ndarray]
    labels: np.ndarray
    tile_cols: Optional[np.ndarray] = None
    tile_vals: Optional[np.ndarray] = None

    @property
    def num_real_nodes(self) -> int:
        return int(self.node_mask.sum())

    @property
    def num_real_edges(self) -> int:
        return int(self.edge_mask.sum())

    @property
    def num_real_outputs(self) -> int:
        return int(self.output_mask.sum())

    @property
    def has_bcsr(self) -> bool:
        return self.tile_cols is not None and self.tile_vals is not None

    def bcsr_stats(self) -> dict:
        """Tile-population stats of the emitted block-CSR adjacency."""
        assert self.has_bcsr, "batch was built without bcsr_block"
        from repro_torch.kernels.spmm.ops import BCSR
        n = self.node_ids.shape[0]
        return BCSR(self.tile_cols, self.tile_vals, n, n).density_stats()

    def nbytes(self) -> int:
        total = 0
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                total += v.nbytes
        return total

    def device_arrays(self) -> Dict[str, np.ndarray]:
        """The arrays a train/serve step consumes (features must be cached)."""
        assert self.features is not None
        out = dict(
            edge_src=self.edge_src, edge_dst=self.edge_dst,
            edge_weight=self.edge_weight,
            node_mask=self.node_mask.astype(np.float32),
            output_idx=np.maximum(self.output_idx, 0),
            output_mask=self.output_mask.astype(np.float32),
            features=self.features, labels=self.labels,
        )
        if self.has_bcsr:
            out["tile_cols"] = self.tile_cols
            out["tile_vals"] = self.tile_vals
        return out


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def batch_node_order(num_nodes: int, src: np.ndarray, dst: np.ndarray,
                     mode: str = "bfs") -> np.ndarray:
    """Batch-local node reordering permutation (DESIGN.md §7).

    "bfs"    — reverse Cuthill-McKee: BFS from a peripheral low-degree node
               with degree-ordered tie-breaking. Minimizes bandwidth, i.e.
               concentrates nonzeros near the diagonal ⇒ fewer, fuller tiles.
    "degree" — descending degree (hubs share the leading tiles).
    "none"   — identity (nodes stay in sorted-global-id order).
    """
    if mode == "none" or num_nodes <= 1:
        return np.arange(num_nodes, dtype=np.int64)
    import scipy.sparse as sp
    a = sp.csr_matrix((np.ones(len(src), np.float32), (src, dst)),
                      shape=(num_nodes, num_nodes))
    a = (a + a.T).tocsr()
    if mode == "bfs":
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        return np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True),
                          dtype=np.int64)
    if mode == "degree":
        return np.argsort(-np.diff(a.indptr), kind="stable").astype(np.int64)
    raise ValueError(f"unknown reorder mode: {mode}")


def _check_symmetric(src: np.ndarray, dst: np.ndarray, w: np.ndarray) -> bool:
    """True iff the COO adjacency equals its transpose (weights included)."""
    fwd = np.lexsort((dst, src))
    bwd = np.lexsort((src, dst))
    return (np.array_equal(src[fwd], dst[bwd])
            and np.array_equal(dst[fwd], src[bwd])
            and np.allclose(w[fwd], w[bwd]))


def build_batches(
    norm_graph: CSRGraph,
    features: np.ndarray,
    labels: np.ndarray,
    output_batches: Sequence[np.ndarray],
    aux_batches: Sequence[np.ndarray],
    cache_features: bool = True,
    pad_multiple: int = 128,
    max_nodes: Optional[int] = None,
    max_edges: Optional[int] = None,
    max_outputs: Optional[int] = None,
    bcsr_block: Optional[int] = None,
    reorder: str = "bfs",
    bcsr_pad_k: Optional[int] = None,
) -> List[PaddedBatch]:
    """Materialize padded induced-subgraph batches.

    Shapes are padded to the max across batches (rounded to `pad_multiple`,
    which keeps the trailing dims MXU/VPU aligned) so all batches share ONE
    shape ⇒ one XLA executable.

    bcsr_block: when set, also emit the block-CSR adjacency of every batch
    (block size = gcd(bcsr_block, max_nodes) so tiles always divide the
    padded node count). Requires a symmetric batch adjacency — guaranteed by
    ``graph.csr.gcn_preprocess`` — because the bcsr training backend reuses
    the same tiles for the transpose in the backward pass (DESIGN.md §7).
    reorder: batch-local node ordering applied before tiling (see
    ``batch_node_order``); only active when bcsr_block is set.
    bcsr_pad_k: pad every batch's tile table to this K instead of the max
    over THIS call's batches — chunked out-of-core builds (DESIGN.md §13)
    pass the global K so batches built in different chunks share one shape.
    """
    assert len(output_batches) == len(aux_batches)
    raw = []
    for outs, aux in zip(output_batches, aux_batches):
        nodes = np.unique(np.concatenate([outs, aux])).astype(np.int64)
        src, dst, w = induced_subgraph(norm_graph, nodes)
        out_local = np.searchsorted(nodes, outs).astype(np.int32)
        if bcsr_block is not None and reorder != "none":
            perm = batch_node_order(len(nodes), src, dst, mode=reorder)
            inv = np.empty(len(nodes), np.int64)
            inv[perm] = np.arange(len(nodes))
            nodes = nodes[perm]
            src = inv[src].astype(np.int32)
            dst = inv[dst].astype(np.int32)
            out_local = inv[out_local].astype(np.int32)
        raw.append((nodes, src, dst, w, out_local, outs))

    mn = max_nodes or _round_up(max(len(r[0]) for r in raw), pad_multiple)
    me = max_edges or _round_up(max(max(len(r[1]) for r in raw), 1), pad_multiple)
    mo = max_outputs or _round_up(max(len(r[4]) for r in raw), pad_multiple)

    bcsr_list = []
    if bcsr_block is not None:
        from repro_torch.kernels.spmm.ops import csr_to_bcsr
        block = math.gcd(bcsr_block, mn)
        for nodes, src, dst, w, _ol, _o in raw:
            if len(src) and not _check_symmetric(src, dst, w):
                raise ValueError(
                    "bcsr backend needs a symmetric batch adjacency (the "
                    "backward pass reuses the forward tiles, DESIGN.md §7); "
                    "got an asymmetric induced subgraph — preprocess with "
                    "gcn_preprocess/make_undirected or use backend='segment'")
            sub = coo_to_csr(src, dst, mn, weights=w)
            bcsr_list.append(csr_to_bcsr(sub.indptr, sub.indices, sub.weights,
                                         mn, mn, block=block))
        kmax = max(bc.tile_cols.shape[1] for bc in bcsr_list)
        if bcsr_pad_k is not None:
            if kmax > bcsr_pad_k:
                raise ValueError(
                    f"batch needs K={kmax} column tiles but bcsr_pad_k="
                    f"{bcsr_pad_k} — the caps measured for this chunked "
                    f"build are stale")
            kmax = bcsr_pad_k
        bcsr_list = [bc.with_pad_k(kmax) for bc in bcsr_list]

    batches: List[PaddedBatch] = []
    for bi, (nodes, src, dst, w, out_local, outs) in enumerate(raw):
        nn, ne, no = len(nodes), len(src), len(out_local)
        if nn > mn or ne > me or no > mo:
            raise ValueError(f"batch exceeds caps: nodes {nn}>{mn} or edges {ne}>{me} or outputs {no}>{mo}")
        node_ids = np.full(mn, -1, np.int32); node_ids[:nn] = nodes
        node_mask = np.zeros(mn, bool); node_mask[:nn] = True
        # padded edges point at the last (guaranteed-padding or masked) slot
        # with weight 0 so segment-sums are unaffected.
        e_src = np.zeros(me, np.int32); e_dst = np.zeros(me, np.int32)
        e_w = np.zeros(me, np.float32); e_m = np.zeros(me, bool)
        e_src[:ne] = src; e_dst[:ne] = dst; e_w[:ne] = w; e_m[:ne] = True
        o_idx = np.full(mo, -1, np.int32); o_idx[:no] = out_local
        o_m = np.zeros(mo, bool); o_m[:no] = True
        lab = np.zeros(mo, np.int32); lab[:no] = labels[outs]
        feats = None
        if cache_features:
            feats = np.zeros((mn, features.shape[1]), np.float32)
            feats[:nn] = features[nodes]
        tc = tv = None
        if bcsr_list:
            tc, tv = bcsr_list[bi].tile_cols, bcsr_list[bi].tile_vals
        batches.append(PaddedBatch(node_ids, node_mask, e_src, e_dst, e_w, e_m,
                                   o_idx, o_m, feats, lab,
                                   tile_cols=tc, tile_vals=tv))
    return batches


class BatchCache:
    """Contiguous host-side cache of padded batches.

    All batches share one shape, so the cache is a dict of stacked arrays —
    one contiguous block per field. Reading batch i is a contiguous slice
    (the paper's "consecutive memory accesses"), ready for zero-copy DMA.
    """

    _META_KEY = "__meta_counts__"

    def __init__(self, batches: Sequence[PaddedBatch]):
        assert len(batches) > 0
        self.num_batches = len(batches)
        self.fields: Dict[str, np.ndarray] = {}
        sample = batches[0].device_arrays()
        for k, v in sample.items():
            self.fields[k] = np.ascontiguousarray(
                np.stack([b.device_arrays()[k] for b in batches]))
        self.meta = [dict(nodes=b.num_real_nodes, edges=b.num_real_edges,
                          outputs=b.num_real_outputs) for b in batches]

    def __len__(self) -> int:
        return self.num_batches

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {k: v[i] for k, v in self.fields.items()}

    def nbytes(self) -> int:
        return sum(v.nbytes for v in self.fields.values())

    def save(self, path: str) -> None:
        # .get: a cache loaded from a pre-meta-fix npz has empty meta dicts;
        # re-saving it writes zeros rather than crashing.
        meta = np.array([[m.get("nodes", 0), m.get("edges", 0),
                          m.get("outputs", 0)] for m in self.meta], np.int64)
        np.savez(path, **{self._META_KEY: meta}, **self.fields)

    @staticmethod
    def from_fields(fields: Dict[str, np.ndarray],
                    meta_counts: Optional[np.ndarray] = None) -> "BatchCache":
        """Rebuild a cache from already-stacked field arrays — the
        deserialization constructor shared by ``load`` and ``Plan.load``
        (DESIGN.md §8). ``meta_counts`` is the (num_batches, 3) array of
        real (nodes, edges, outputs) counts; None means a pre-meta-fix
        artifact (meta restored as empty dicts)."""
        obj = BatchCache.__new__(BatchCache)
        obj.fields = dict(fields)
        obj.num_batches = next(iter(obj.fields.values())).shape[0]
        if meta_counts is not None:
            obj.meta = [dict(nodes=int(n), edges=int(e), outputs=int(o))
                        for n, e, o in np.asarray(meta_counts)]
        else:
            obj.meta = [{} for _ in range(obj.num_batches)]
        return obj

    @staticmethod
    def load(path: str) -> "BatchCache":
        with np.load(path) as z:
            fields = {k: z[k] for k in z.files if k != BatchCache._META_KEY}
            meta = z[BatchCache._META_KEY] if BatchCache._META_KEY in z.files \
                else None
        return BatchCache.from_fields(fields, meta)
