"""GraphSAGE (Hamilton et al., NeurIPS 2017) with the mean aggregator, as
the IBMB paper's App. B runs it: each layer ``h @ w_self + mean(h) @ w_nbr
+ b``, the mean over the batch's edges (self loops included) as the
program's batches carry them. The program runs it as
``GNNConfig(kind="sage")``, whose aggregation is the block-CSR SpMM's
pattern mode over the degree. The interface is ``kinds/gcn.py``'s.
"""
import math

import torch

from perfbench.harness import reference

LEAVES = ("w_self", "w_nbr", "b")


def program_kwargs(model: dict) -> dict:
    return {"kind": "sage"}


def init_layer(model, d_in, d_out, last, gen):
    """Glorot-uniform ``w_self`` then ``w_nbr``, zero ``b``."""
    return {"w_self": reference.glorot(gen, (d_in, d_out)),
            "w_nbr": reference.glorot(gen, (d_in, d_out)),
            "b": torch.zeros(d_out)}


def serve_layer(model, d_in, d_out, last, uni, nrm):
    lim = math.sqrt(6.0 / (d_in + d_out))
    return {"w_self": uni((d_in, d_out), lim),
            "w_nbr": uni((d_in, d_out), lim), "b": nrm(d_out, 0.0, 0.1)}


def prepare(edges, device, dtype):
    """The dense pattern (1 per edge) and each row's degree, at least 1."""
    a = reference.dense_adjacency(
        edges, torch.ones(len(edges.weight)), device).to(dtype)
    return a, torch.clamp(a.sum(dim=1), min=1.0)[:, None]


def layer(model, p, h, g, last):
    a, deg = g
    return h @ p["w_self"] + ((a @ h) / deg) @ p["w_nbr"] + p["b"]


def spmm_calls(model, train):
    """One pattern call a layer, at its input's width (SAGE aggregates
    what comes in); a training step's backward takes the same widths
    again but for the first layer's, whose input (the features) wants no
    gradient."""
    calls = [(f, False) for f in reference.layer_dims(model)[:-1]]
    return calls + calls[1:] if train else calls


def forward_flops(model, real_nodes, nnz):
    """Two dense products over the real nodes, 2·n·F_in·F_out each, and
    2·nnz·F_in for the aggregation, a layer."""
    dims = reference.layer_dims(model)
    total = 0.0
    for f_in, f_out in zip(dims[:-1], dims[1:]):
        total += 2 * 2.0 * real_nodes * f_in * f_out
        total += 2.0 * nnz * f_in
    return total
