"""Batch scheduling (paper Sec. 4, Fig. 7).

Similar consecutive batches make the optimizer take compounding steps in a
suboptimal direction → accuracy spikes. The paper measures batch similarity
via symmetrized KL divergence of training-label distributions and proposes:
 (i) a fixed order maximizing consecutive distance (max-TSP, solved with
     simulated annealing — paper App. B uses python-tsp's SA), and
 (ii) sampling the next batch weighted by distance to the current one.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch import obs


def label_distributions(batch_labels: Sequence[np.ndarray], num_classes: int,
                        smooth: float = 1e-6) -> np.ndarray:
    """Normalized training-label distribution p_i = c_i / Σ_j c_j per batch."""
    out = np.zeros((len(batch_labels), num_classes), dtype=np.float64)
    for i, lab in enumerate(batch_labels):
        cnt = np.bincount(np.asarray(lab), minlength=num_classes).astype(np.float64)
        out[i] = cnt + smooth
        out[i] /= out[i].sum()
    return out


def pairwise_kl_distance(p: np.ndarray) -> np.ndarray:
    """Symmetrized KL: d_ab = KL(a‖b) + KL(b‖a). Returns (B, B)."""
    logp = np.log(p)
    # KL(a||b) = Σ p_a (log p_a − log p_b)
    ent = (p * logp).sum(axis=1)                       # Σ p_a log p_a
    cross = p @ logp.T                                 # Σ p_a log p_b
    kl = ent[:, None] - cross
    return kl + kl.T


def tsp_max_order(dist: np.ndarray, iters: int = 20_000, seed: int = 0,
                  t0: float = 1.0, t1: float = 1e-3) -> np.ndarray:
    """Max-distance closed tour via simulated annealing (2-opt + swap moves).

    Maximizing total consecutive distance ≡ solving max-TSP on the loop that
    visits every batch (paper: 'traveling salesman problem for finding the
    maximum distance loop').
    """
    n = dist.shape[0]
    if n <= 2:
        return np.arange(n)
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
        if rng.random() < 0.5:
            cand = order.copy()
            cand[i:j + 1] = cand[i:j + 1][::-1]     # 2-opt segment reversal
        else:
            cand = order.copy()
            cand[i], cand[j] = cand[j], cand[i]     # swap
        new = tour_len(cand)
        # MAXIMIZE: accept if longer, or with SA probability
        if new > cur or rng.random() < np.exp((new - cur) / max(temp, 1e-9)):
            order, cur = cand, new
            if cur > best_len:
                best, best_len = order.copy(), cur
    return best


def weighted_sampling_order(dist: np.ndarray, num_epochs: int = 1,
                            seed: int = 0) -> np.ndarray:
    """Sample the next batch ∝ distance to the current batch, without
    replacement within an epoch (every batch used exactly once per epoch,
    keeping training unbiased — paper Sec. 4)."""
    n = dist.shape[0]
    rng = np.random.default_rng(seed)
    orders = []
    cur = int(rng.integers(n))
    for _ in range(num_epochs):
        remaining = set(range(n))
        epoch = []
        for _ in range(n):
            rem = np.array(sorted(remaining))
            w = dist[cur, rem].astype(np.float64)
            w = np.maximum(w, 1e-12)
            cur = int(rng.choice(rem, p=w / w.sum()))
            remaining.discard(cur)
            epoch.append(cur)
        orders.append(np.array(epoch))
    return np.concatenate(orders) if num_epochs > 1 else orders[0]


def make_schedule(
    batch_labels: Sequence[np.ndarray],
    num_classes: int,
    mode: str = "tsp",
    num_epochs: int = 1,
    seed: int = 0,
) -> np.ndarray:
    """Return the batch visit order for `num_epochs` epochs, flattened."""
    n = len(batch_labels)
    with obs.span("schedule.order", batches=n):
        if mode == "none" or n <= 2:
            return np.tile(np.arange(n), num_epochs)
        p = label_distributions(batch_labels, num_classes)
        d = pairwise_kl_distance(p)
        if mode == "tsp":
            order = tsp_max_order(d, seed=seed)
            return np.tile(order, num_epochs)
        if mode == "weighted":
            return weighted_sampling_order(d, num_epochs=num_epochs,
                                           seed=seed)
        raise ValueError(f"unknown schedule mode: {mode}")
