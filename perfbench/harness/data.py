"""The benchmark's graph: a degree-corrected stochastic block model at a
configuration's published counts, made from the configuration's own seed.

A frozen copy of the port's DC-SBM generator (``graph/synthetic.py``) and
of its GCN normalisation (``graph/csr.py``), kept here so that a later
change to the program cannot move the data it is measured on. The graph
is fixed per configuration: its seed stands in for the published dataset.
It is cached as one ``.npz`` under ``perfbench/.cache/data`` (written once
per checkout, published with ``os.replace``) and handed to the program as
a ``GraphDataset`` and to the reference as arrays.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import zipfile
from typing import Dict

import numpy as np
import scipy.sparse as sp

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".cache", "data")


@dataclasses.dataclass
class Graph:
    """Raw undirected graph (unit weights), its GCN normalisation (self
    loops, symmetric), features, labels and splits, all host arrays."""
    indptr: np.ndarray
    indices: np.ndarray
    n_indptr: np.ndarray
    n_indices: np.ndarray
    n_weights: np.ndarray
    features: np.ndarray
    labels: np.ndarray
    splits: Dict[str, np.ndarray]

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1


def _csr(m: sp.spmatrix):
    m = m.tocsr()
    m.sort_indices()
    return (m.indptr.astype(np.int64), m.indices.astype(np.int32),
            m.data.astype(np.float32))


def _sample_edges(spec: dict, rng: np.random.Generator):
    """Degree-corrected SBM edges: sources by a lognormal degree
    propensity; the target in the source's block with probability
    ``homophily`` (degree-weighted), else anywhere (degree-weighted)."""
    n, k = spec["num_nodes"], spec["num_classes"]
    labels = rng.integers(0, k, size=n)
    theta = rng.lognormal(mean=0.0, sigma=1.0, size=n)
    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    starts = np.searchsorted(sorted_labels, np.arange(k))
    ends = np.searchsorted(sorted_labels, np.arange(k), side="right")
    block_nodes = [order[starts[b]:ends[b]] for b in range(k)]
    block_probs = []
    for b in range(k):
        p = theta[block_nodes[b]]
        s = p.sum()
        block_probs.append(p / s if s > 0 else None)
    num_edges = int(n * spec["avg_degree"] / 2)
    p_global = theta / theta.sum()
    src = rng.choice(n, size=num_edges, p=p_global)
    intra = rng.random(num_edges) < spec["homophily"]
    dst = np.empty(num_edges, dtype=np.int64)
    for b in range(k):
        mask = intra & (labels[src] == b)
        cnt = int(mask.sum())
        if cnt and len(block_nodes[b]):
            dst[mask] = rng.choice(block_nodes[b], size=cnt, p=block_probs[b])
        elif cnt:
            dst[mask] = rng.choice(n, size=cnt, p=p_global)
    mask = ~intra
    cnt = int(mask.sum())
    if cnt:
        dst[mask] = rng.choice(n, size=cnt, p=p_global)
    keep = src != dst
    return (src[keep].astype(np.int32), dst[keep].astype(np.int32),
            labels.astype(np.int32))


def make_graph(spec: dict) -> Graph:
    """The configuration's graph, deterministic in ``spec`` (its seed
    included)."""
    rng = np.random.default_rng(spec["seed"])
    n = spec["num_nodes"]
    src, dst, labels = _sample_edges(spec, rng)
    a = sp.csr_matrix((np.ones(len(src), np.float32), (src, dst)),
                      shape=(n, n))
    a.sum_duplicates()
    a = a.maximum(a.T).tocsr()
    a.data[:] = 1.0
    indptr, indices, _ = _csr(a)
    # GCN normalisation: self loops, then D^-1/2 (A + I) D^-1/2 with the
    # global degrees (the paper's App. B, reused inside every batch)
    m = sp.csr_matrix((np.ones(len(indices), np.float32), indices, indptr),
                      shape=(n, n)).tolil()
    m.setdiag(1.0)
    m = m.tocsr()
    deg = np.asarray(m.sum(axis=1)).ravel()
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    n_indptr, n_indices, n_weights = _csr(sp.diags(dinv) @ m @ sp.diags(dinv))
    centroids = rng.normal(size=(spec["num_classes"], spec["feat_dim"])
                           ).astype(np.float32)
    feats = centroids[labels] + spec["noise"] * rng.normal(
        size=(n, spec["feat_dim"])).astype(np.float32)
    perm = rng.permutation(n)
    n_tr = int(spec["train_frac"] * n)
    n_va = int(spec["val_frac"] * n)
    n_te = int(spec["test_frac"] * n)
    splits = {
        "train": np.sort(perm[:n_tr]).astype(np.int32),
        "val": np.sort(perm[n_tr:n_tr + n_va]).astype(np.int32),
        "test": np.sort(perm[n_tr + n_va:n_tr + n_va + n_te]).astype(np.int32),
    }
    return Graph(indptr, indices, n_indptr, n_indices, n_weights,
                 feats.astype(np.float32), labels, splits)


_FIELDS = ("indptr", "indices", "n_indptr", "n_indices", "n_weights",
           "features", "labels")
_SPLITS = ("train", "val", "test")


def cache_path(spec: dict) -> str:
    """The cache file of ``spec``: named by a digest of the spec, so a
    changed spec never reads another's graph."""
    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode())
    return os.path.join(CACHE_DIR, f"dcsbm-{key.hexdigest()[:16]}.npz")


def load_graph(spec: dict, cache: bool = True) -> Graph:
    """The graph of ``spec``, from the checkout's cache when it is there
    and readable, else made and (with ``cache``) published there."""
    path = cache_path(spec)
    if cache and os.path.exists(path):
        with contextlib.suppress(zipfile.BadZipFile, EOFError, ValueError,
                                 KeyError, OSError):
            with np.load(path, allow_pickle=False) as z:
                return Graph(*(z[f] for f in _FIELDS),
                             splits={s: z[s] for s in _SPLITS})
    g = make_graph(spec)
    if cache:
        os.makedirs(CACHE_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **{k: getattr(g, k) for k in _FIELDS},
                         **g.splits)
            os.replace(tmp, path)
        finally:
            with contextlib.suppress(OSError):
                os.remove(tmp)
    return g
