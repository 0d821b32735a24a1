"""CSR/COO graph structures and the standard GNN preprocessing transforms.

All host-side preprocessing is numpy/scipy (this mirrors the paper, which does
preprocessing on CPU and caches the result). Device-side code consumes padded
COO edge lists / CSR blocks with static shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class CSRGraph:
    """A directed graph in CSR form with optional edge weights.

    indptr:  (N+1,) int64
    indices: (E,)   int32 — column indices (out-neighbors)
    weights: (E,)   float32 or None
    """

    indptr: np.ndarray
    indices: np.ndarray
    weights: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def to_scipy(self) -> sp.csr_matrix:
        n = self.num_nodes
        w = self.weights if self.weights is not None else np.ones(self.num_edges, np.float32)
        return sp.csr_matrix((w, self.indices, self.indptr), shape=(n, n))

    @staticmethod
    def from_scipy(m: sp.spmatrix) -> "CSRGraph":
        m = m.tocsr()
        m.sort_indices()
        return CSRGraph(
            indptr=m.indptr.astype(np.int64),
            indices=m.indices.astype(np.int32),
            weights=m.data.astype(np.float32),
        )

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]: self.indptr[u + 1]]

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        """Return (src, dst) int32 arrays."""
        src = np.repeat(np.arange(self.num_nodes, dtype=np.int32), self.degrees())
        return src, self.indices.copy()


def sorted_lookup(haystack: np.ndarray,
                  needles: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Positions of ``needles`` in the SORTED array ``haystack``.

    Returns ``(idx, hit)``: ``idx`` is clamped into range (meaningful only
    where ``hit``); ``hit`` marks needles actually present. The one home of
    the searchsorted + clamp + equality idiom (membership filters, routing
    patches, incremental-PPR row alignment) — the clamp guards the
    out-of-range searchsorted result and the equality test subsumes any
    ``pos < len`` check.
    """
    needles = np.asarray(needles)
    if len(haystack) == 0:
        return (np.zeros(needles.shape, np.int64),
                np.zeros(needles.shape, bool))
    idx = np.minimum(np.searchsorted(haystack, needles), len(haystack) - 1)
    return idx, haystack[idx] == needles


def coo_to_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int,
               weights: Optional[np.ndarray] = None) -> CSRGraph:
    w = weights if weights is not None else np.ones(len(src), np.float32)
    m = sp.csr_matrix((w, (src, dst)), shape=(num_nodes, num_nodes))
    m.sum_duplicates()
    m.sort_indices()
    return CSRGraph.from_scipy(m)


def make_undirected(g: CSRGraph) -> CSRGraph:
    """A := max(A, A^T) with unit weights (paper: 'make the graph undirected')."""
    m = g.to_scipy()
    m = m.maximum(m.T)
    m.data[:] = 1.0
    return CSRGraph.from_scipy(m)


def add_self_loops(g: CSRGraph) -> CSRGraph:
    m = g.to_scipy().tolil()
    m.setdiag(1.0)
    return CSRGraph.from_scipy(m.tocsr())


def sym_normalize(g: CSRGraph) -> CSRGraph:
    """D^{-1/2} A D^{-1/2} (GCN normalization). Degrees from row sums."""
    m = g.to_scipy()
    deg = np.asarray(m.sum(axis=1)).ravel()
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    m = sp.diags(dinv) @ m @ sp.diags(dinv)
    return CSRGraph.from_scipy(m.tocsr())


def row_normalize(g: CSRGraph) -> CSRGraph:
    """D^{-1} A (random-walk normalization, used by PPR)."""
    m = g.to_scipy()
    deg = np.asarray(m.sum(axis=1)).ravel()
    dinv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-12), 0.0)
    m = sp.diags(dinv) @ m
    return CSRGraph.from_scipy(m.tocsr())


def gcn_preprocess(g: CSRGraph) -> CSRGraph:
    """Paper App. B: undirected + self-loops + symmetric normalization.

    The normalization factors are GLOBAL and re-used inside every mini-batch
    (the paper found this as accurate and cheaper than per-batch renorm).
    """
    return sym_normalize(add_self_loops(make_undirected(g)))


def induced_subgraph(g: CSRGraph, nodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Subgraph induced by `nodes` (sorted unique int array).

    Returns (src_local, dst_local, weights) with indices into `nodes`.
    Vectorized: slice CSR rows, filter columns by membership via searchsorted.
    """
    nodes = np.asarray(nodes)
    starts = g.indptr[nodes]
    ends = g.indptr[nodes + 1]
    counts = (ends - starts).astype(np.int64)
    # gather all candidate edges of the selected rows
    total = int(counts.sum())
    if total == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32))
    # flat gather indices into g.indices
    offsets = np.repeat(starts, counts) + (
        np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(counts) - counts, counts))
    cols = g.indices[offsets]
    rows_local = np.repeat(np.arange(len(nodes), dtype=np.int32), counts)
    w = g.weights[offsets] if g.weights is not None else np.ones(total, np.float32)
    # membership of cols in nodes
    pos, keep = sorted_lookup(nodes, cols)
    return rows_local[keep], pos[keep].astype(np.int32), w[keep].astype(np.float32)
