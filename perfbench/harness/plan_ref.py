"""The reference's own IBMB batches: which nodes each batch holds, in which
order, and the order a training epoch visits the batches.

A frozen NumPy copy of the port's plan builder (``core/ppr.py`` push APPR,
``core/partition.py`` PPR-distance partition, ``core/aux_selection.py``
node-wise auxiliary nodes, ``core/batches.py`` reverse Cuthill-McKee
order, ``core/scheduling.py`` max-TSP order), so that the reference works
out again what the program's set-up derived, from the raw graph alone,
and a later change to the program cannot move it. Only the node-wise
variant that the benchmark's configurations use is kept.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class RefBatch:
    """One batch: its output nodes (sorted global ids) and all its nodes in
    the program's batch-local order (global ids)."""
    outputs: np.ndarray
    nodes: np.ndarray


def sorted_lookup(haystack: np.ndarray, needles: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    needles = np.asarray(needles)
    if len(haystack) == 0:
        return (np.zeros(needles.shape, np.int64),
                np.zeros(needles.shape, bool))
    idx = np.minimum(np.searchsorted(haystack, needles), len(haystack) - 1)
    return idx, haystack[idx] == needles


def push_appr(indptr, indices, roots, alpha, eps, max_iters, topk,
              chunk=4096):
    """Frontier-synchronous push APPR: (roots, top-k indices, values)."""
    roots = np.asarray(roots, dtype=np.int64)
    n = len(indptr) - 1
    degi = np.diff(indptr).astype(np.int64)
    deg = np.maximum(degi.astype(np.float64), 1.0)
    dinv = np.where(degi > 0,
                    1.0 / np.maximum(degi.astype(np.float64), 1e-12), 0.0)
    P = sp.csr_matrix((np.repeat(dinv, degi), indices, indptr),
                      shape=(n, n), copy=False)
    k = topk
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
        lens = np.diff(p.indptr)
        if p.nnz:
            row_ids = np.repeat(np.arange(m), lens)
            order = np.lexsort((-p.data, row_ids))
            rows_s = row_ids[order]
            rank = np.arange(p.nnz) - p.indptr[rows_s]
            keep = rank < k
            out_idx[c0 + rows_s[keep], rank[keep]] = p.indices[order][keep]
            out_val[c0 + rows_s[keep], rank[keep]] = p.data[order][keep]
        empty = np.where(lens == 0)[0]
        out_idx[c0 + empty, 0] = rts[empty]
        out_val[c0 + empty, 0] = 1.0
    return roots.astype(np.int32), out_idx, out_val


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)
        self.size = np.ones(n, dtype=np.int64)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union_capped(self, a: int, b: int, cap: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb or self.size[ra] + self.size[rb] > cap:
            return False
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]
        return True


def ppr_distance_partition(roots, idx, val, output_nodes, cap, seed):
    """Greedy merge of output nodes by descending PPR score under the size
    cap, then small leftovers merged after a seeded shuffle."""
    rng = np.random.default_rng(seed)
    output_nodes = np.asarray(output_nodes)
    n_out = len(output_nodes)
    srt = np.argsort(output_nodes, kind="stable")
    out_sorted = output_nodes[srt]

    def positions(ids):
        p, hit = sorted_lookup(out_sorted, ids)
        return np.where(hit, srt[p], -1)

    root_local = positions(np.asarray(roots, dtype=np.int64))
    v_local = positions(idx.astype(np.int64).ravel())
    u_local = np.repeat(root_local, idx.shape[1])
    keep = (v_local >= 0) & (v_local != u_local)
    us, vs, ws = u_local[keep], v_local[keep], val.ravel()[keep]
    uf = _UnionFind(n_out)
    if len(ws):
        order = np.argsort(-ws)
        for u, v in zip(us[order], vs[order]):
            uf.union_capped(int(u), int(v), cap)
    groups: dict = {}
    for i in range(n_out):
        groups.setdefault(int(uf.find(i)), []).append(i)
    batches = [np.array(g, dtype=np.int64) for g in groups.values()]
    rng.shuffle(batches)
    merged: List[np.ndarray] = []
    cur = None
    batches.sort(key=len)
    for b in batches:
        if cur is None:
            cur = b
        elif len(cur) + len(b) <= cap:
            cur = np.concatenate([cur, b])
        else:
            merged.append(cur)
            cur = b
    if cur is not None and len(cur):
        merged.append(cur)
    return [np.sort(output_nodes[b]).astype(np.int32) for b in merged]


def node_wise_aux(roots, idx, parts, k_per_output):
    """Each batch's nodes: its outputs and their top-k PPR neighbours."""
    pos = {int(r): i for i, r in enumerate(roots)}
    out = []
    for part in parts:
        sel = []
        for u in part:
            i = pos[int(u)]
            m = idx[i] >= 0
            sel.append(idx[i][m][:k_per_output])
        out.append(np.unique(np.concatenate(
            sel + [np.asarray(part, dtype=np.int32)])).astype(np.int32))
    return out


def induced_edges(n_indptr, n_indices, n_weights, nodes):
    """Edges of the normalised graph among ``nodes`` (sorted unique):
    (src, dst, weight) as positions into ``nodes``."""
    nodes = np.asarray(nodes)
    starts, ends = n_indptr[nodes], n_indptr[nodes + 1]
    counts = (ends - starts).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32))
    offsets = np.repeat(starts, counts) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(np.cumsum(counts) - counts, counts))
    cols = n_indices[offsets]
    rows = np.repeat(np.arange(len(nodes), dtype=np.int32), counts)
    w = n_weights[offsets]
    pos, keep = sorted_lookup(nodes, cols)
    return rows[keep], pos[keep].astype(np.int32), w[keep].astype(np.float32)


def rcm_order(n, src, dst):
    """Reverse Cuthill-McKee over the batch's symmetric pattern."""
    if n <= 1:
        return np.arange(n, dtype=np.int64)
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    a = sp.csr_matrix((np.ones(len(src), np.float32), (src, dst)),
                      shape=(n, n))
    a = (a + a.T).tocsr()
    return np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True),
                      dtype=np.int64)


def reference_batches(graph, ibmb: dict, split: str, for_inference: bool
                      ) -> List[RefBatch]:
    """The batches of ``split`` as the configuration's IBMB settings make
    them: node-wise APPR from every output node, PPR-distance partition,
    node-wise auxiliary nodes, each batch's nodes in RCM order."""
    if ibmb["variant"] != "node":
        raise ValueError(f"reference batches know the node-wise variant "
                         f"only, not {ibmb['variant']!r}")
    outputs = graph.splits[split]
    cap = ibmb["max_outputs_per_batch"] * (2 if for_inference else 1)
    roots, idx, val = push_appr(
        graph.indptr, graph.indices, outputs, ibmb["alpha"], ibmb["eps"],
        ibmb["push_iters"], max(ibmb["k_per_output"] * 2, 32))
    parts = ppr_distance_partition(roots, idx, val, outputs, cap,
                                   ibmb["seed"])
    aux = node_wise_aux(roots, idx, parts, ibmb["k_per_output"])
    out = []
    for part, a in zip(parts, aux):
        nodes = np.unique(np.concatenate([part, a])).astype(np.int64)
        out.append(RefBatch(part, nodes))
    return out


def local_order(graph, batch: RefBatch) -> np.ndarray:
    """The batch's nodes in the program's batch-local (RCM) order."""
    src, dst, _ = induced_edges(graph.n_indptr, graph.n_indices,
                                graph.n_weights, batch.nodes)
    return batch.nodes[rcm_order(len(batch.nodes), src, dst)]


def tsp_order(batch_labels: Sequence[np.ndarray], num_classes: int,
              seed: int, iters: int = 20_000, t0: float = 1.0,
              t1: float = 1e-3) -> np.ndarray:
    """One epoch's batch order: the max-distance closed tour over the
    batches' symmetrised label KL divergence, by simulated annealing."""
    n = len(batch_labels)
    if n <= 2:
        return np.arange(n)
    p = np.zeros((n, num_classes), dtype=np.float64)
    for i, lab in enumerate(batch_labels):
        cnt = np.bincount(np.asarray(lab), minlength=num_classes)
        p[i] = cnt.astype(np.float64) + 1e-6
        p[i] /= p[i].sum()
    logp = np.log(p)
    kl = (p * logp).sum(axis=1)[:, None] - p @ logp.T
    dist = kl + kl.T
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)

    def tour_len(o):
        return dist[o, np.roll(o, -1)].sum()

    cur = tour_len(order)
    best, best_len = order.copy(), cur
    for it in range(iters):
        temp = t0 * (t1 / t0) ** (it / max(iters - 1, 1))
        i, j = sorted(rng.integers(0, n, size=2))
        if i == j:
            continue
        cand = order.copy()
        if rng.random() < 0.5:
            cand[i:j + 1] = cand[i:j + 1][::-1]
        else:
            cand[i], cand[j] = cand[j], cand[i]
        new = tour_len(cand)
        if new > cur or rng.random() < np.exp((new - cur) / max(temp, 1e-9)):
            order, cur = cand, new
            if cur > best_len:
                best, best_len = order.copy(), cur
    return best
