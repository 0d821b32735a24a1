"""Influence scores (paper Sec. 3, Theorem 1) — exact computation for
validation of the PPR approximation.

I(v, u) = Σ_i Σ_j | ∂h_u,i^{(L)} / ∂X_v,j |

The port of ``repro.core.influence``. Used to confirm (on GCN models) that
PPR ranks auxiliary nodes consistently with the exact influence score —
the empirical justification for IBMB's practical instantiation. Kept out
of ``repro_torch.core``'s eager imports, as the reference does.

The Jacobian is ``torch.func.jacrev``, which vmaps one vector-Jacobian
product per output class. Every op of the GCN's full-graph forward
(``index_add_``, row indexing, matmul, ReLU) has a vmap batching rule, so
no per-class Python loop runs behind it.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.device import DeviceSpec, to_tensor


def exact_influence(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    features: np.ndarray,
    output_node: int,
    device: DeviceSpec = None,
) -> np.ndarray:
    """Exact I(v, u) for all v, for one output node u.

    apply_fn: X (N, F) -> H (N, C) full-graph forward, run where X lies.
    ``features`` go to ``device`` (``cuda`` unless the caller names
    another; no card raises). Returns (N,) influence of each node's
    features on node u's logits, on the host.
    """
    x = to_tensor(np.asarray(features, np.float32), device)

    def out_u(feats):
        return apply_fn(feats)[output_node]                   # (C,)

    jac = torch.func.jacrev(out_u)(x)                         # (C, N, F)
    return jac.abs().sum(dim=(0, 2)).cpu().numpy()           # Σ_i Σ_j |·|


def expected_influence_rw(adj_row_norm: np.ndarray, num_layers: int,
                          alpha: float = 0.0) -> np.ndarray:
    """Expected influence ∝ L-step random walk (with optional restart),
    Xu et al. [38] / paper Sec. 3. Dense, for tests: returns (N, N) where
    entry (u, v) is the influence of v on u."""
    n = adj_row_norm.shape[0]
    if alpha <= 0:
        return np.linalg.matrix_power(adj_row_norm, num_layers)
    acc = np.eye(n) * alpha
    walk = np.eye(n)
    for _ in range(num_layers):
        walk = (1 - alpha) * walk @ adj_row_norm
        acc = acc + alpha * walk
    return acc
