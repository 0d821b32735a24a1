"""Graph substrate: sparse structures and synthetic datasets."""
from repro_torch.graph.csr import CSRGraph, coo_to_csr, make_undirected, add_self_loops, sym_normalize
from repro_torch.graph.synthetic import make_sbm_dataset, DATASET_SPECS
from repro_torch.graph.datasets import get_dataset, GraphDataset

__all__ = [
    "CSRGraph", "coo_to_csr", "make_undirected", "add_self_loops", "sym_normalize",
    "make_sbm_dataset", "DATASET_SPECS", "get_dataset", "GraphDataset",
]
