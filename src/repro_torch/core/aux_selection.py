"""Auxiliary-node selection (paper Sec. 3.1).

* node-wise: per output node take its top-k APPR neighbors; the batch's aux
  set is the union (optimizes the worst-case objective, Eq. 6).
* batch-wise: topic-sensitive PPR with the batch as teleport set; take the
  top-`budget` nodes (optimizes the average objective, Eq. 5).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.core.ppr import TopKPPR, topic_sensitive_ppr, heat_kernel


def node_wise_aux(
    ppr: TopKPPR,
    batches: Sequence[np.ndarray],
    k_per_output: int,
) -> List[np.ndarray]:
    """Union of each output node's top-k PPR neighbors (node-wise IBMB)."""
    root_pos = {int(r): i for i, r in enumerate(ppr.roots)}
    out: List[np.ndarray] = []
    for batch in batches:
        sel: List[np.ndarray] = []
        for u in batch:
            i = root_pos[int(u)]
            m = ppr.indices[i] >= 0
            cols = ppr.indices[i][m][:k_per_output]
            sel.append(cols)
        aux = np.unique(np.concatenate(sel + [np.asarray(batch, dtype=np.int32)]))
        out.append(aux.astype(np.int32))
    return out


def batch_wise_aux(
    g: CSRGraph,
    batches: Sequence[np.ndarray],
    budget: Optional[int] = None,
    alpha: float = 0.25,
    num_iters: int = 50,
    method: str = "ppr",
    heat_t: float = 3.0,
) -> List[np.ndarray]:
    """Top-`budget` nodes of the batch-teleport diffusion (batch-wise IBMB).

    budget=None uses the paper's default: as many auxiliary nodes as the
    batch has output nodes (|aux| = |partition|).
    """
    if method == "ppr":
        pi = topic_sensitive_ppr(g, batches, alpha=alpha, num_iters=num_iters)
    elif method == "heat":
        pi = heat_kernel(g, batches, t=heat_t)
    else:
        raise ValueError(f"unknown diffusion: {method}")
    out: List[np.ndarray] = []
    for i, batch in enumerate(batches):
        b = budget if budget is not None else len(batch)
        row = pi[i]
        k = min(b, (row > 0).sum())
        top = np.argpartition(-row, k - 1)[:k] if k > 0 else np.zeros(0, np.int64)
        aux = np.unique(np.concatenate([top.astype(np.int32),
                                        np.asarray(batch, dtype=np.int32)]))
        out.append(aux.astype(np.int32))
    return out
