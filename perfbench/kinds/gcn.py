"""GCN (Kipf and Welling, ICLR 2017), as the IBMB paper's App. B runs it:
each layer ``A @ (h @ w) + b``, ``A`` the batch's normalised adjacency
with self loops. The program runs it as ``GNNConfig(kind="gcn")``, whose
aggregation is the weighted block-CSR SpMM.

A kind module holds everything the harness knows of one model kind, and
the harness finds it by the configuration's ``model.kind``:

* ``LEAVES``: a layer's leaves besides LayerNorm, in the order the
  program's ``init_gnn`` draws them;
* ``program_kwargs(model)``: the program's ``GNNConfig`` keywords beside
  the widths, depth, dropout, dtype and backend every kind shares;
* ``init_layer(model, d_in, d_out, last, gen)``: a layer's initial leaves
  as the program's trainer draws them from the CPU generator ``gen``;
* ``serve_layer(model, d_in, d_out, last, uni, nrm)``: a layer's serving
  weights in the program's layout, from the device draws ``uni(shape,
  lim)`` and ``nrm(n, mean, std)``;
* ``prepare(edges, device, dtype)``: what ``layer`` needs of a batch's
  ``reference.BatchEdges``, made once a batch;
* ``layer(model, p, h, g, last)``: one layer of the plain float32
  reference over ``g``, before LayerNorm;
* ``spmm_calls(model, train)``: (width, weighted) of each SpMM call of one
  batch, forward then backward; empty for a kind that does not aggregate
  by the SpMM;
* ``forward_flops(model, real_nodes, nnz)``: the model operations of one
  batch's forward.
"""
import math

import torch

from perfbench.harness import reference

LEAVES = ("w", "b")


def program_kwargs(model: dict) -> dict:
    return {"kind": "gcn"}


def init_layer(model, d_in, d_out, last, gen):
    """Glorot-uniform ``w``, zero ``b``."""
    return {"w": reference.glorot(gen, (d_in, d_out)),
            "b": torch.zeros(d_out)}


def serve_layer(model, d_in, d_out, last, uni, nrm):
    """Glorot-uniform ``w``, a small random ``b``."""
    lim = math.sqrt(6.0 / (d_in + d_out))
    return {"w": uni((d_in, d_out), lim), "b": nrm(d_out, 0.0, 0.1)}


def prepare(edges, device, dtype):
    """The dense adjacency with the normalised weights."""
    return reference.dense_adjacency(
        edges, torch.from_numpy(edges.weight), device).to(dtype)


def layer(model, p, h, a, last):
    return a @ (h @ p["w"]) + p["b"]


def spmm_calls(model, train):
    """One weighted call a layer, at its output's width (GCN transforms
    first and aggregates what the transform gives); a training step's
    backward takes the same widths again."""
    calls = [(f, True) for f in reference.layer_dims(model)[1:]]
    return calls + calls if train else calls


def forward_flops(model, real_nodes, nnz):
    """2·n·F_in·F_out for the dense product over the real nodes and
    2·nnz·F_out for the aggregation, a layer."""
    dims = reference.layer_dims(model)
    total = 0.0
    for f_in, f_out in zip(dims[:-1], dims[1:]):
        total += 2.0 * real_nodes * f_in * f_out
        total += 2.0 * nnz * f_out
    return total
