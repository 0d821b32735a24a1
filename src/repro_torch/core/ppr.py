"""Personalized PageRank as the influence-score approximation (paper Sec. 3).

Two production paths, mirroring the paper's two IBMB instantiations:

* ``push_appr`` — node-wise approximate PPR (Andersen/Chung/Lang push).
  TPU/vector adaptation: instead of the sequential per-node push queue of the
  original (numba on CPU in the paper), we run *frontier-synchronous sweeps*:
  every residual entry above the ε·deg(v) threshold is pushed simultaneously;
  one sweep is one sparse matvec. This is the data-parallel formulation of
  push and keeps the classic guarantee (all residuals < ε·deg on
  convergence ⇒ per-entry error ≤ ε·deg). The paper itself uses the same
  relaxation ("push-flow algorithm with a fixed number of iterations").

* ``topic_sensitive_ppr`` — batch-wise PPR via power iteration with a batch
  teleport vector (the paper uses 50 power iterations). Dense (b, N) iterate;
  each step is a sparse matmul — this maps directly onto the TPU SpMM kernel.

``dense_ppr`` is the closed-form oracle used by tests.

Dynamic graphs (DESIGN.md §10): ``push_appr`` is *local* — a capped
frontier-synchronous push from root ``s`` only ever reads edges and degrees
inside the ``max_iters``-hop ball around ``s``. ``ppr_dirty_roots`` exploits
that to bound which roots a ``GraphDelta`` can affect (BFS from the edited
endpoints in the old AND new adjacency), and ``push_appr_incremental``
re-pushes ONLY those roots, splicing every other root's stored top-k row
through unchanged. For an untouched root the warm-started push would
perform zero pushes — its stored state already satisfies the residual
invariant on the new graph — so skipping it entirely is the exact form of
the warm start, and the refreshed result is bit-identical to a from-scratch
``push_appr`` on the new graph.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from repro_torch.graph.csr import CSRGraph, sorted_lookup


@dataclasses.dataclass
class TopKPPR:
    """Sparse per-root top-k PPR result.

    roots:   (R,) int32 root (output) node ids
    indices: (R, k) int32 neighbor ids (padded with -1)
    values:  (R, k) float32 PPR scores (padded with 0)
    """

    roots: np.ndarray
    indices: np.ndarray
    values: np.ndarray

    @property
    def k(self) -> int:
        return self.indices.shape[1]

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        m = self.indices[i] >= 0
        return self.indices[i][m], self.values[i][m]


def row_stochastic(g: CSRGraph) -> sp.csr_matrix:
    """P = D^{-1} A on the (assumed undirected) graph with unit weights.

    Built directly from the graph's CSR structure: row i's entries are all
    ``1/deg(i)``, so the data vector is ``np.repeat(dinv, deg)`` and the
    ``indices``/``indptr`` buffers are SHARED with ``g`` (``copy=False``) —
    no intermediate adjacency copy. That matters out of core (DESIGN.md
    §13): when ``g``'s arrays are ``np.memmap``-backed, the only resident
    allocation this makes is the O(E) float64 data vector; the old
    ``diag @ A`` formulation materialized two full adjacency copies.
    Values are bit-identical to the old path (same ``dinv`` doubles, same
    sorted CSR structure)."""
    deg = np.diff(g.indptr).astype(np.int64)
    dinv = np.where(deg > 0, 1.0 / np.maximum(deg.astype(np.float64), 1e-12),
                    0.0)
    data = np.repeat(dinv, deg)
    return sp.csr_matrix((data, g.indices, g.indptr),
                         shape=(g.num_nodes, g.num_nodes), copy=False)


_row_stochastic = row_stochastic      # internal alias (pre-§13 name)


def push_appr(
    g: CSRGraph,
    roots: np.ndarray,
    alpha: float = 0.25,
    eps: float = 2e-4,
    max_iters: int = 3,
    topk: Optional[int] = None,
    chunk: int = 4096,
) -> TopKPPR:
    """Frontier-synchronous push APPR for a set of root nodes.

    Sweep update (α-teleport PPR, residual form):
        active = r ⊙ 1[r > ε·deg]
        p += α · active
        r  = (r − active) + (1−α) · active @ P
    After convergence every residual satisfies r(v) ≤ ε·deg(v), giving the
    standard per-entry approximation bound. The paper caps iterations (3),
    we do the same by default.
    """
    roots = np.asarray(roots, dtype=np.int64)
    n = g.num_nodes
    deg = np.maximum(g.degrees().astype(np.float64), 1.0)
    P = _row_stochastic(g)
    k = topk if topk is not None else 32

    out_idx = np.full((len(roots), k), -1, dtype=np.int32)
    out_val = np.zeros((len(roots), k), dtype=np.float32)

    for c0 in range(0, len(roots), chunk):
        rts = roots[c0:c0 + chunk]
        m = len(rts)
        r = sp.csr_matrix(
            (np.ones(m, np.float64), (np.arange(m), rts)), shape=(m, n))
        p = sp.csr_matrix((m, n), dtype=np.float64)
        for _ in range(max_iters):
            if r.nnz == 0:
                break
            thresh = eps * deg[r.indices]
            mask = r.data > thresh
            if not mask.any():
                break
            active = r.copy()
            active.data = np.where(mask, r.data, 0.0)
            active.eliminate_zeros()
            p = p + alpha * active
            r = (r - active) + (1.0 - alpha) * (active @ P)
            r.eliminate_zeros()
        p = p.tocsr()
        p.sum_duplicates()
        # Vectorized per-row top-k (indptr-segmented): ONE lexsort orders all
        # nonzeros by (row asc, value desc); the within-row rank is then just
        # position − row start, and `rank < k` keeps each row's top-k. This
        # replaces the per-root Python loop that dominated preprocessing on
        # large root sets — preprocessing is the paper's amortized cost.
        lens = np.diff(p.indptr)
        if p.nnz:
            row_ids = np.repeat(np.arange(m), lens)
            order = np.lexsort((-p.data, row_ids))
            rows_s = row_ids[order]          # grouped by row, values desc
            rank = np.arange(p.nnz) - p.indptr[rows_s]
            keep = rank < k
            out_idx[c0 + rows_s[keep], rank[keep]] = p.indices[order][keep]
            out_val[c0 + rows_s[keep], rank[keep]] = p.data[order][keep]
        # isolated roots keep themselves with full mass
        empty = np.where(lens == 0)[0]
        out_idx[c0 + empty, 0] = rts[empty]
        out_val[c0 + empty, 0] = 1.0
    return TopKPPR(roots=roots.astype(np.int32), indices=out_idx, values=out_val)


def _hop_neighbors(g: CSRGraph, nodes: np.ndarray) -> np.ndarray:
    """Union of out-neighbors of `nodes` (vectorized CSR row gather)."""
    nodes = np.asarray(nodes, dtype=np.int64)
    starts = g.indptr[nodes]
    counts = (g.indptr[nodes + 1] - starts).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    offsets = np.repeat(starts, counts) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(np.cumsum(counts) - counts, counts))
    return np.unique(g.indices[offsets].astype(np.int64))


def ppr_dirty_roots(
    roots: np.ndarray,
    touched: np.ndarray,
    graphs: Sequence[CSRGraph],
    hops: int,
) -> np.ndarray:
    """Boolean mask over `roots`: which roots a structural edit can affect.

    A capped push from root ``s`` only ever reads adjacency rows and
    degrees of nodes within ``max_iters−1`` hops of ``s`` (the sweep-``t``
    residual is supported on the ``t``-hop ball, and the LAST sweep reads
    rows of its active set), so its result can only change if an edited
    endpoint lies within ``max_iters−1`` hops of ``s`` — pass
    ``hops = max_iters − 1``. We BFS ``hops`` levels from ``touched`` in
    every supplied adjacency (old AND new graph — either execution could
    have read the edit) and flag the reached roots (DESIGN.md §10).
    """
    roots = np.asarray(roots, dtype=np.int64)
    touched = np.unique(np.asarray(touched, dtype=np.int64))
    if len(touched) == 0 or len(roots) == 0:
        return np.zeros(len(roots), dtype=bool)
    n = max(g.num_nodes for g in graphs)
    reached = np.zeros(n, dtype=bool)
    in_range = touched[touched < n]
    reached[in_range] = True
    frontier = in_range
    for _ in range(hops):
        if len(frontier) == 0:
            break
        nxt = np.unique(np.concatenate(
            [_hop_neighbors(g, frontier[frontier < g.num_nodes])
             for g in graphs] or [np.zeros(0, np.int64)]))
        frontier = nxt[~reached[nxt]]
        reached[frontier] = True
    safe = np.minimum(roots, n - 1)
    return np.where(roots < n, reached[safe], False)


def push_appr_incremental(
    g: CSRGraph,
    roots: np.ndarray,
    prev: TopKPPR,
    dirty: np.ndarray,
    alpha: float = 0.25,
    eps: float = 2e-4,
    max_iters: int = 3,
    topk: Optional[int] = None,
    chunk: int = 4096,
) -> TopKPPR:
    """Refresh a stored ``TopKPPR`` after a graph delta (DESIGN.md §10).

    ``dirty`` is a boolean mask over ``roots`` (typically from
    ``ppr_dirty_roots``, plus any roots absent from ``prev``). Dirty roots
    are re-pushed on the new graph ``g`` with the exact same capped push as
    ``push_appr`` — per-root results are independent of chunk composition,
    so the spliced result is bit-identical to a full from-scratch
    ``push_appr(g, roots, ...)``. Clean roots reuse their stored row with
    zero work: their warm-started push would terminate immediately.
    """
    roots = np.asarray(roots, dtype=np.int64)
    dirty = np.asarray(dirty, dtype=bool).copy()
    k = topk if topk is not None else prev.k
    # align stored rows by root id; roots prev never solved are dirty
    prev_order = np.argsort(prev.roots, kind="stable")
    prev_sorted = prev.roots[prev_order].astype(np.int64)
    safe, known = sorted_lookup(prev_sorted, roots)
    dirty |= ~known
    if prev.k != k:          # stored top-k width no longer matches config
        dirty[:] = True

    out_idx = np.full((len(roots), k), -1, dtype=np.int32)
    out_val = np.zeros((len(roots), k), dtype=np.float32)
    clean = ~dirty
    if clean.any():
        src_rows = prev_order[safe[clean]]
        out_idx[clean] = prev.indices[src_rows]
        out_val[clean] = prev.values[src_rows]
    if dirty.any():
        fresh = push_appr(g, roots[dirty], alpha=alpha, eps=eps,
                          max_iters=max_iters, topk=k, chunk=chunk)
        out_idx[dirty] = fresh.indices
        out_val[dirty] = fresh.values
    return TopKPPR(roots=roots.astype(np.int32), indices=out_idx,
                   values=out_val)


def topic_sensitive_ppr(
    g: CSRGraph,
    batches: Sequence[np.ndarray],
    alpha: float = 0.25,
    num_iters: int = 50,
) -> np.ndarray:
    """Batch-wise (topic-sensitive) PPR: π_b = α t_b + (1−α) π_b P.

    t_b is uniform over the output nodes of batch b. Returns dense (b, N).
    """
    n = g.num_nodes
    P = _row_stochastic(g)
    Pt = P.T.tocsr()   # so that (π P) = (Pᵀ πᵀ)ᵀ
    b = len(batches)
    t = np.zeros((b, n), dtype=np.float64)
    for i, nodes in enumerate(batches):
        nodes = np.asarray(nodes)
        if len(nodes):
            t[i, nodes] = 1.0 / len(nodes)
    pi = t.copy()
    for _ in range(num_iters):
        pi = alpha * t + (1.0 - alpha) * (Pt @ pi.T).T
    return pi.astype(np.float32)


def dense_ppr(g: CSRGraph, alpha: float = 0.25) -> np.ndarray:
    """Closed form Π = α (I − (1−α) D^{-1}A)^{-1}. Oracle for tests (small N)."""
    n = g.num_nodes
    P = _row_stochastic(g).toarray()
    return alpha * np.linalg.inv(np.eye(n) - (1.0 - alpha) * P)


def heat_kernel(
    g: CSRGraph,
    batches: Sequence[np.ndarray],
    t: float = 3.0,
    num_terms: int = 30,
) -> np.ndarray:
    """Heat-kernel diffusion e^{-t} Σ_j t^j/j! P^j  (paper Table 5 alternative)."""
    n = g.num_nodes
    P = _row_stochastic(g)
    Pt = P.T.tocsr()
    b = len(batches)
    v = np.zeros((b, n), dtype=np.float64)
    for i, nodes in enumerate(batches):
        nodes = np.asarray(nodes)
        if len(nodes):
            v[i, nodes] = 1.0 / len(nodes)
    acc = v * np.exp(-t)
    term = v.copy()
    coef = np.exp(-t)
    for j in range(1, num_terms):
        term = (Pt @ term.T).T
        coef = coef * t / j
        acc = acc + coef * term
    return acc.astype(np.float32)
