"""Optimizers as plain functions on trees of tensors (no ``torch.optim``).

The port of ``repro.optim.optimizers``: the same five optimizers, the same
``init``/``update`` API and the same state layout (``{"step", "m", "v"}``
for Adam, ...), so a state carries across packages leaf by leaf, and the
same formulas in the same order of operations.

API: ``opt = adam(); state = opt.init(params);``
``updates, state = opt.update(grads, state, params, lr)``;
``params = apply_updates(params, updates)``. ``lr`` is a Python float, so
``ReduceLROnPlateau`` can change it between steps. A tree is a tensor, or
a dict, list or tuple of trees. Nothing is updated in place: every call
returns new tensors, as the reference's pure functions do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

OptState = Any
PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree``; the structure comes from
    ``tree``, and each of ``rest`` is walked alongside it only as deep as
    ``tree`` goes (``flatten_up_to``), so a leaf of ``tree`` may meet a
    whole subtree of another."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], OptState]
    update: Callable[[PyTree, OptState, PyTree, float],
                     Tuple[PyTree, OptState]]
    name: str = "opt"


def _step0(params) -> torch.Tensor:
    """The step counter, an int32 scalar on the parameters' device (so the
    bias corrections never leave the device)."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return torch.zeros((), dtype=torch.int32, device=dev)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def sgd(momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {"step": _step0(params)}
        return {"step": _step0(params),
                "mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, lr):
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), \
                {"step": state["step"] + 1}
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        upd = tree_map(lambda m: -lr * m, mu)
        return upd, {"step": state["step"] + 1, "mu": mu}

    return Optimizer(init, update, "sgd")


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam with optional L2 (coupled, as the paper's 'L2 regularization')."""

    def init(params):
        return {"step": _step0(params),
                "m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    def update(grads, state, params, lr):
        step = state["step"] + 1
        if weight_decay > 0.0:
            grads = tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                             grads, params)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        upd = tree_map(
            lambda m_, v_: -lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps),
            m, v)
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update, "adam")


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    base = adam(b1, b2, eps, 0.0)

    def update(grads, state, params, lr):
        upd, state = base.update(grads, state, params, lr)
        upd = tree_map(lambda u, p: u - lr * weight_decay * p.to(u.dtype),
                       upd, params)
        return upd, state

    return Optimizer(base.init, update, "adamw")


def adagrad(eps: float = 1e-10) -> Optimizer:
    def init(params):
        return {"step": _step0(params), "acc": tree_map(_zeros_f32, params)}

    def update(grads, state, params, lr):
        acc = tree_map(lambda a, g: a + torch.square(g.float()),
                       state["acc"], grads)
        upd = tree_map(lambda g, a: -lr * g.float() / (torch.sqrt(a) + eps),
                       grads, acc)
        return upd, {"step": state["step"] + 1, "acc": acc}

    return Optimizer(init, update, "adagrad")


def adafactor(decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Adafactor (factored second moment, no first moment) — the optimizer
    state for a (a, b) matrix is a + b floats instead of 2·a·b."""

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def per_leaf(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": _zeros_f32(p)}
        return {"step": _step0(params), "slots": tree_map(per_leaf, params)}

    def update(grads, state, params, lr):
        step = state["step"] + 1
        beta = 1.0 - step.float() ** (-decay)

        def per_leaf(g, slot):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if "vr" in slot:
                vr = beta * slot["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * slot["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :] /
                    torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                                min=eps))
                u = g32 / torch.clamp(denom, min=eps)
                new_slot = {"vr": vr, "vc": vc}
            else:
                v = beta * slot["v"] + (1 - beta) * g2
                u = g32 / torch.sqrt(v)
                new_slot = {"v": v}
            # update clipping (RMS)
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return -lr * u, new_slot

        outs = tree_map(per_leaf, grads, state["slots"])
        is_pair = lambda x: isinstance(x, tuple) and len(x) == 2 \
            and torch.is_tensor(x[0])
        upd = _unzip(outs, 0, is_pair)
        slots = _unzip(outs, 1, is_pair)
        return upd, {"step": step, "slots": slots}

    return Optimizer(init, update, "adafactor")


def _unzip(tree, i: int, is_pair):
    """Component ``i`` of every (update, slot) pair in ``tree``."""
    if is_pair(tree):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _unzip(v, i, is_pair) for k, v in tree.items()}
    return type(tree)(_unzip(v, i, is_pair) for v in tree)


def get_optimizer(name: str, weight_decay: float = 0.0) -> Optimizer:
    if name == "adam":
        return adam(weight_decay=weight_decay)
    if name == "adamw":
        return adamw(weight_decay=weight_decay or 0.01)
    if name == "adagrad":
        return adagrad()
    if name == "adafactor":
        return adafactor()
    if name == "sgd":
        return sgd(momentum=0.9)
    raise ValueError(f"unknown optimizer {name}")
