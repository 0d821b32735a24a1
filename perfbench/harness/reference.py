"""The plain reference of the benchmark's GNNs, as in the IBMB paper's App.
B (LayerNorm, ReLU, inverted dropout on every hidden layer; masked
cross-entropy; Adam), in float32 torch, with no kernel, cache or padding
of the program's.

What differs from one model kind to another (its leaves, its initial
weights, its layer over the batch's edges) lives in the kind's module,
``kinds/<kind>.py``, found by the configuration's ``model.kind``; this
module holds what every kind shares.

A batch is its nodes (global ids, in the order the program lays them out
when dropout masks have to line up) and the normalised graph's edges
among them (``BatchEdges``: self loops included). ``tf32=True`` computes
the same in TF32, the precision below the configuration's float32: the
control that the comparison has to fail.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench.harness.cell import kind_of
from perfbench.harness.plan_ref import induced_edges

LN_EPS = 1e-5


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls in full float32, or in TF32 with ``tf32``."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def derive_seed(*words: int) -> int:
    """A 64-bit seed that is a pure function of ``words``."""
    return int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(1, np.uint64)[0])


def layer_dims(model: dict) -> List[int]:
    return ([model["in_dim"]] + [model["hidden"]] * (model["num_layers"] - 1)
            + [model["out_dim"]])


def leaf_names(model: dict) -> List[str]:
    """Every parameter leaf as ``layers.<l>.<name>``."""
    per = tuple(kind_of(model).LEAVES)
    out = []
    for l in range(model["num_layers"]):
        names = per + (("ln_scale", "ln_bias")
                       if l < model["num_layers"] - 1 else ())
        out += [f"layers.{l}.{n}" for n in names]
    return out


def flatten(params: Dict) -> Dict[str, torch.Tensor]:
    return {f"layers.{l}.{k}": v for l, layer in enumerate(params["layers"])
            for k, v in layer.items()}


def glorot(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """Glorot-uniform from the CPU generator ``gen``, as the program draws
    it: the limit from the first and the last of ``shape``."""
    lim = float(np.sqrt(6.0 / (shape[0] + shape[-1])))
    return torch.empty(shape).uniform_(-lim, lim, generator=gen)


def trainer_init(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial parameters a trainer seeded with ``seed`` starts from:
    each layer's leaves as its kind draws them (``init_layer``), in layer
    order from one CPU generator seeded with ``derive_seed(seed, 0)``, and
    unit LayerNorm on the hidden layers."""
    gen = torch.Generator().manual_seed(derive_seed(seed, 0))
    kind, dims, L = kind_of(model), layer_dims(model), model["num_layers"]
    out = {}
    for l in range(L):
        layer = kind.init_layer(model, dims[l], dims[l + 1], l == L - 1, gen)
        if l < L - 1:
            layer["ln_scale"] = torch.ones(dims[l + 1])
            layer["ln_bias"] = torch.zeros(dims[l + 1])
        out.update((f"layers.{l}.{k}", v) for k, v in layer.items())
    return {k: v.to(device) for k, v in out.items()}


@dataclasses.dataclass(frozen=True)
class BatchEdges:
    """The normalised graph's edges among a batch's nodes, in batch-local
    ids (the nodes' given order), self loops included; ``n`` nodes."""
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    n: int


def batch_edges(graph, nodes: np.ndarray) -> BatchEdges:
    srt = np.argsort(nodes, kind="stable")
    src, dst, w = induced_edges(graph.n_indptr, graph.n_indices,
                                graph.n_weights, nodes[srt])
    return BatchEdges(srt[src], srt[dst], w, len(nodes))


def dense_adjacency(edges: BatchEdges, vals: torch.Tensor, device
                    ) -> torch.Tensor:
    """(n, n) float32 matrix with ``vals`` (one per edge) at the edges."""
    a = torch.zeros((edges.n, edges.n), dtype=torch.float32, device=device)
    a.index_put_((torch.from_numpy(edges.src).long().to(device),
                  torch.from_numpy(edges.dst).long().to(device)),
                 vals.to(device), accumulate=True)
    return a


def forward(model: dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
            g, masks: Optional[Sequence[torch.Tensor]] = None
            ) -> torch.Tensor:
    """Logits of every node of the batch. ``g``: what the kind's
    ``prepare`` made of the batch's edges. ``masks``: one keep-mask per
    hidden layer (inverted dropout at the configuration's rate)."""
    kind, L = kind_of(model), model["num_layers"]
    h = x
    for l in range(L):
        h = kind.layer(model, {n: p[f"layers.{l}.{n}"] for n in kind.LEAVES},
                       h, g, l == L - 1)
        if l < L - 1:
            mu = h.mean(dim=-1, keepdim=True)
            var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
            h = ((h - mu) * torch.rsqrt(var + LN_EPS)
                 * p[f"layers.{l}.ln_scale"] + p[f"layers.{l}.ln_bias"])
            h = torch.relu(h)
            if masks is not None:
                rate = model["dropout"]
                h = torch.where(masks[l], h / (1.0 - rate),
                                torch.zeros((), device=h.device))
    return h


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None].long())[:, 0].mean()


class Adam:
    """Adam (no weight decay) over a dict of leaves."""

    def __init__(self, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.step_count = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def step(self, p: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        self.step_count += 1
        bc1 = 1 - self.b1 ** self.step_count
        bc2 = 1 - self.b2 ** self.step_count
        out = {}
        for k in p:
            self.m[k] = self.b1 * self.m.get(k, 0.0) + (1 - self.b1) * g[k]
            self.v[k] = (self.b2 * self.v.get(k, 0.0)
                         + (1 - self.b2) * g[k] * g[k])
            out[k] = p[k] - self.lr * (self.m[k] / bc1) / (
                torch.sqrt(self.v[k] / bc2) + self.eps)
        return out


def train_steps(model: dict, graph, batches, init: Dict[str, torch.Tensor],
                step_masks, lr: float, device, tf32: bool = False,
                dtype=torch.float32):
    """Follow the program's first training steps: ``batches`` are
    (outputs, nodes in the program's local order) in step order,
    ``step_masks[i]`` the keep-masks of step i's hidden layers over those
    nodes. Returns each step's loss, the first step's gradient and the
    parameters after the last step. ``dtype=torch.float64`` gives the
    exact answer that both float32 sides round."""
    p = {k: v.detach().to(dtype, copy=True) for k, v in init.items()}
    opt = Adam(lr)
    losses, first_grad = [], None
    feats = torch.from_numpy(graph.features)
    labels = torch.from_numpy(graph.labels)
    with precision(tf32):
        for (outputs, nodes), masks in zip(batches, step_masks):
            g = kind_of(model).prepare(batch_edges(graph, nodes), device,
                                       dtype)
            x = feats[torch.from_numpy(nodes).long()].to(device, dtype)
            pos = torch.from_numpy(np.searchsorted(
                np.sort(nodes), outputs)).long()
            rows = torch.from_numpy(np.argsort(nodes, kind="stable"))[pos]
            y = labels[torch.from_numpy(outputs).long()].to(device)
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            logits = forward(model, leaves, x, g, masks)
            loss = xent(logits[rows.to(device)], y)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            grads = dict(zip(leaves, (t.detach() for t in grads)))
            if first_grad is None:
                first_grad = grads
            losses.append(float(loss.detach()))
            p = opt.step(p, grads)
            del g
    return losses, first_grad, p


@torch.no_grad()
def batch_logits(model: dict, graph, params: Dict[str, torch.Tensor],
                 nodes: np.ndarray, outputs: np.ndarray, device,
                 tf32: bool = False) -> np.ndarray:
    """Logits of ``outputs`` from the forward over the batch ``nodes``."""
    with precision(tf32):
        g = kind_of(model).prepare(batch_edges(graph, nodes), device,
                                   torch.float32)
        x = torch.from_numpy(graph.features)[
            torch.from_numpy(nodes).long()].to(device)
        h = forward(model, params, x, g)
        rows = np.searchsorted(nodes, outputs)
        return h[torch.from_numpy(rows).long().to(device)].cpu().numpy()
