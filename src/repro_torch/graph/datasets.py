"""Dataset registry with on-disk caching.

Mirrors the paper's workflow: expensive preprocessing (graph build, PPR) is
done once, cached, and re-used across runs/models/seeds.
"""
from __future__ import annotations

import dataclasses
import os
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


def get_dataset(name: str, cache: bool = True) -> GraphDataset:
    if name in _MEMO:
        return _MEMO[name]
    spec = DATASET_SPECS[name]
    path = os.path.join(_CACHE_DIR, f"{name}-v1.npz")
    if cache and os.path.exists(path):
        z = np.load(path, allow_pickle=False)
        g = CSRGraph(z["indptr"], z["indices"], z["weights"])
        ng = CSRGraph(z["n_indptr"], z["n_indices"], z["n_weights"])
        ds = GraphDataset(name, g, ng, z["features"], z["labels"],
                          {"train": z["train"], "val": z["val"], "test": z["test"]})
    else:
        g, feats, labels, splits = make_sbm_dataset(spec)
        ng = gcn_preprocess(g)
        ds = GraphDataset(name, g, ng, feats, labels, splits)
        if cache:
            os.makedirs(_CACHE_DIR, exist_ok=True)
            np.savez_compressed(
                path,
                indptr=g.indptr, indices=g.indices,
                weights=g.weights if g.weights is not None else np.ones(g.num_edges, np.float32),
                n_indptr=ng.indptr, n_indices=ng.indices, n_weights=ng.weights,
                features=ds.features, labels=ds.labels,
                train=splits["train"], val=splits["val"], test=splits["test"])
    _MEMO[name] = ds
    return ds
