"""Dataset registry with on-disk caching.

Mirrors the paper's workflow: expensive preprocessing (graph build, PPR) is
done once, cached, and re-used across runs/models/seeds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import zipfile
from typing import Dict, Optional

import numpy as np

from repro_torch.graph.csr import CSRGraph, gcn_preprocess
from repro_torch.graph.synthetic import DATASET_SPECS, make_sbm_dataset

# REPRO_DATA_DIR, else ``.data_cache/`` at the root of the checkout
_CACHE_DIR = os.environ.get(
    "REPRO_DATA_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "..", "..", "..", ".data_cache"))


@dataclasses.dataclass
class GraphDataset:
    name: str
    graph: CSRGraph             # raw undirected graph (unit weights)
    norm_graph: CSRGraph        # GCN-normalized (self-loops, sym-norm)
    features: np.ndarray        # (N, F) float32
    labels: np.ndarray          # (N,) int32
    splits: Dict[str, np.ndarray]

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1

    @property
    def feat_dim(self) -> int:
        return self.features.shape[1]


_MEMO: Dict[str, GraphDataset] = {}

# a cache file that cannot be read (truncated, half-written by a process
# that died, or not an npz at all) is a miss: the dataset is rebuilt
_UNREADABLE = (zipfile.BadZipFile, EOFError, ValueError, KeyError, OSError)


def cache_path(name: str) -> str:
    """The port's own cache file for dataset ``name``; the reference's
    package caches the same datasets under another name, so neither
    package ever reads a file the other is writing."""
    return os.path.join(_CACHE_DIR, f"torch-{name}-v1.npz")


def _load(name: str, path: str) -> GraphDataset:
    with np.load(path, allow_pickle=False) as z:
        g = CSRGraph(z["indptr"], z["indices"], z["weights"])
        ng = CSRGraph(z["n_indptr"], z["n_indices"], z["n_weights"])
        return GraphDataset(name, g, ng, z["features"], z["labels"],
                            {"train": z["train"], "val": z["val"],
                             "test": z["test"]})


def _save(ds: GraphDataset, path: str) -> None:
    """Write under a name unique to this process, then publish with
    ``os.replace``: a reader sees the old file or the whole new one."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    g, ng = ds.graph, ds.norm_graph
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f, indptr=g.indptr, indices=g.indices,
                weights=g.weights if g.weights is not None
                else np.ones(g.num_edges, np.float32),
                n_indptr=ng.indptr, n_indices=ng.indices,
                n_weights=ng.weights, features=ds.features,
                labels=ds.labels, train=ds.splits["train"],
                val=ds.splits["val"], test=ds.splits["test"])
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def get_dataset(name: str, cache: bool = True) -> GraphDataset:
    if name in _MEMO:
        return _MEMO[name]
    spec = DATASET_SPECS[name]
    path = cache_path(name)
    ds = None
    if cache and os.path.exists(path):
        with contextlib.suppress(*_UNREADABLE):
            ds = _load(name, path)
    if ds is None:
        g, feats, labels, splits = make_sbm_dataset(spec)
        ds = GraphDataset(name, g, gcn_preprocess(g), feats, labels, splits)
        if cache:
            _save(ds, path)
    _MEMO[name] = ds
    return ds
