"""Output-node partitioning (paper Sec. 3.2).

Three schemes:
* ``ppr_distance_partition`` — the paper's greedy merge over sorted PPR
  magnitudes with a union-find and a size cap (node-wise IBMB).
* ``graph_partition`` — METIS stand-in (batch-wise IBMB / Cluster-GCN).
  METIS is unavailable offline; we provide (a) a Fennel single-pass streaming
  partitioner with degree-penalized balance and (b) networkx Louvain
  communities packed to the target size. Both preserve the property the
  paper needs: nearby output nodes land in the same batch so their auxiliary
  sets overlap.
* ``random_partition`` — the paper's "fixed random" ablation.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.graph.csr import CSRGraph, sorted_lookup
from repro_torch.core.ppr import TopKPPR


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)
        self.size = np.ones(n, dtype=np.int64)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:   # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union_capped(self, a: int, b: int, cap: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if self.size[ra] + self.size[rb] > cap:
            return False
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]
        return True


def ppr_distance_partition(
    ppr: TopKPPR,
    output_nodes: np.ndarray,
    max_outputs_per_batch: int,
    seed: int = 0,
) -> List[np.ndarray]:
    """Greedy merge partitioning from node-wise PPR scores (paper Sec. 3.2).

    Every output node starts in its own batch; (u, v) pairs where both are
    output nodes are scanned in descending PPR magnitude and their batches
    merged while staying under the size cap. Small leftovers are merged
    randomly — from a Generator seeded HERE with ``seed`` (the config
    seed at the pipeline call sites), so the partition is a pure function
    of (ppr, outputs, cap, seed) like every other fingerprinted build
    step. Supports incremental streaming by construction (greedy).
    """
    rng = np.random.default_rng(seed)
    output_nodes = np.asarray(output_nodes)
    n_out = len(output_nodes)
    # map global node id -> position in output_nodes, via one sort (the
    # former per-entry dict lookup was a Python loop over every stored
    # (root, neighbor) pair and dominated partitioning time)
    out_sorted_order = np.argsort(output_nodes, kind="stable")
    out_sorted = output_nodes[out_sorted_order]

    def _positions(ids):
        """Position of each id in output_nodes, -1 when absent."""
        p, hit = sorted_lookup(out_sorted, ids)
        return np.where(hit, out_sorted_order[p], -1)

    root_local = _positions(np.asarray(ppr.roots, dtype=np.int64))
    if (root_local < 0).any():
        bad = np.asarray(ppr.roots)[root_local < 0]
        raise KeyError(f"PPR roots not in output_nodes: {bad[:8].tolist()}")
    # collect (score, u_local, v_local) for pairs of output nodes, in the
    # same root-major / within-row order the scan always used
    idx, val = ppr.indices, ppr.values
    flat = idx.astype(np.int64).ravel()
    v_local = _positions(flat)
    u_local = np.repeat(root_local, idx.shape[1])
    keep = (v_local >= 0) & (v_local != u_local)
    us = u_local[keep]
    vs = v_local[keep]
    ws = val.ravel()[keep]
    uf = _UnionFind(n_out)
    if len(ws):
        order = np.argsort(-ws)
        us = us[order]; vs = vs[order]
        for u, v in zip(us, vs):
            uf.union_capped(int(u), int(v), max_outputs_per_batch)

    # group by root
    roots = np.array([uf.find(i) for i in range(n_out)])
    groups: dict = {}
    for i, r in enumerate(roots):
        groups.setdefault(int(r), []).append(i)
    batches = [np.array(g, dtype=np.int64) for g in groups.values()]

    # randomly merge small leftovers under the cap
    rng.shuffle(batches)
    merged: List[np.ndarray] = []
    cur = None
    batches.sort(key=len)   # small first so leftovers coalesce
    for b in batches:
        if cur is None:
            cur = b
        elif len(cur) + len(b) <= max_outputs_per_batch:
            cur = np.concatenate([cur, b])
        else:
            merged.append(cur)
            cur = b
    if cur is not None and len(cur):
        merged.append(cur)
    return [np.sort(output_nodes[b]).astype(np.int32) for b in merged]


def _fennel(g: CSRGraph, num_parts: int, gamma: float = 1.5,
            seed: int = 0) -> np.ndarray:
    """Fennel streaming partitioner (Tsourakakis et al.): assign each node to
    argmax_p |N(v) ∩ p| − α·γ·size(p)^{γ−1}. Single pass in degree-descending
    order (a common Fennel heuristic)."""
    n = g.num_nodes
    e = max(g.num_edges, 1)
    alpha = np.sqrt(num_parts) * e / (n ** gamma)
    cap = int(1.1 * n / num_parts) + 1
    assign = np.full(n, -1, dtype=np.int64)
    sizes = np.zeros(num_parts, dtype=np.int64)
    order = np.argsort(-g.degrees())
    nbr_count = np.zeros(num_parts, dtype=np.float64)
    for v in order:
        nbr_count[:] = 0.0
        for u in g.neighbors(int(v)):
            a = assign[u]
            if a >= 0:
                nbr_count[a] += 1.0
        score = nbr_count - alpha * gamma * np.power(np.maximum(sizes, 1), gamma - 1)
        score[sizes >= cap] = -np.inf
        p = int(np.argmax(score))
        assign[v] = p
        sizes[p] += 1
    return assign


def _louvain(g: CSRGraph, seed: int = 0) -> np.ndarray:
    import networkx as nx
    src, dst = g.to_coo()
    G = nx.Graph()
    G.add_nodes_from(range(g.num_nodes))
    G.add_edges_from(zip(src.tolist(), dst.tolist()))
    comms = nx.community.louvain_communities(G, seed=seed)
    assign = np.zeros(g.num_nodes, dtype=np.int64)
    for i, c in enumerate(comms):
        assign[list(c)] = i
    return assign


def graph_partition(
    g: CSRGraph,
    output_nodes: np.ndarray,
    num_batches: int,
    method: str = "fennel",
    seed: int = 0,
) -> List[np.ndarray]:
    """Partition the WHOLE graph (METIS-style), then group output nodes by
    their partition (Cluster-GCN / batch-wise IBMB). Partitions that end up
    with no output nodes are dropped; overfull ones are split."""
    output_nodes = np.asarray(output_nodes)
    if method == "fennel":
        assign = _fennel(g, num_batches, seed=seed)
    elif method == "louvain":
        assign = _louvain(g, seed=seed)
    elif method == "random":
        rng = np.random.default_rng(seed)
        assign = rng.integers(0, num_batches, size=g.num_nodes)
    else:
        raise ValueError(f"unknown partition method: {method}")

    out_assign = assign[output_nodes]
    batches: List[np.ndarray] = []
    for p in np.unique(out_assign):
        nodes = output_nodes[out_assign == p]
        if len(nodes):
            batches.append(np.sort(nodes).astype(np.int32))
    # pack to approximately num_batches: split overly large, merge tiny
    target = max(1, int(np.ceil(len(output_nodes) / num_batches)))
    out: List[np.ndarray] = []
    for b in batches:
        if len(b) > 2 * target:
            for s in range(0, len(b), target):
                out.append(b[s:s + target])
        else:
            out.append(b)
    out.sort(key=len)
    merged: List[np.ndarray] = []
    cur: Optional[np.ndarray] = None
    for b in out:
        if cur is None:
            cur = b
        elif len(cur) + len(b) <= target:
            cur = np.sort(np.concatenate([cur, b]))
        else:
            merged.append(cur)
            cur = b
    if cur is not None and len(cur):
        merged.append(cur)
    return merged


def random_partition(
    output_nodes: np.ndarray,
    num_batches: int,
    seed: int = 0,
) -> List[np.ndarray]:
    """Fixed random batches (paper's ablation baseline)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.asarray(output_nodes))
    return [np.sort(c).astype(np.int32) for c in np.array_split(perm, num_batches) if len(c)]
