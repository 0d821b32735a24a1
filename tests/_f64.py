"""The port's ops in float64, and the rule that holds an f32 gradient with
a float64 witness (no JAX here: the card-only tests and ``chip_smoke.py``
import it too)."""
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

GRAD_TOL = 1e-4
WITNESS = 4.0
# the reference's further runs at nudged inputs, where a leaf is refused
N_NUDGED = 3


class port_f64(TorchDispatchMode):
    """Every op in f64: f32 operands are widened and f32 results
    (``.float()``, ``torch.zeros(..., dtype=torch.float32)``) are made
    f64, so the port's own f32 casts do not round."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        def up(x):
            if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
                return x.to(torch.float64)
            return x
        args = tree_map(up, args)
        kwargs = tree_map(up, dict(kwargs or {}))
        if kwargs.get("dtype") == torch.float32:
            kwargs["dtype"] = torch.float64
        return func(*args, **kwargs)


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def leaf_err(got, want) -> float:
    """max |got - want| over a leaf divided by the leaf's largest |want|."""
    a, b = _f64(got), _f64(want)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def witness_ok(port_vs_ref: float, ref_vs_f64: float, port_vs_f64: float,
               tol: float = GRAD_TOL) -> bool:
    """The rule for one leaf (or one figure): the port's f32 within ``tol``
    of the reference's f32 — or, where the reference's own f32 lies
    farther than ``tol / WITNESS`` from float64 (an ill-conditioned case),
    the port's f32 no farther from float64 than ``WITNESS`` times the
    reference's. A port op that lost precision, a stray bf16 say, lands
    orders of magnitude outside."""
    return port_vs_ref <= tol or (ref_vs_f64 > tol / WITNESS and
                                  port_vs_f64 <= WITNESS * ref_vs_f64)


def nudged(x, rng):
    """An f32 array or tensor with each entry scaled by 1 or 1 +- 2^-23 at
    random (moved by at most about one ulp): the same problem, rounded
    otherwise. Other dtypes are returned as they are."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.float32:
            return x
        u = rng.integers(-1, 2, tuple(x.shape)).astype(np.float32)
        return x * (1 + 2.0 ** -23 * torch.from_numpy(u).to(x.device))
    x = np.asarray(x)
    if x.dtype != np.float32:
        return x
    u = rng.integers(-1, 2, x.shape).astype(np.float32)
    return x * (1 + np.float32(2.0 ** -23) * u)


def witness_misses(port32, ref32, f64, names=None, tol: float = GRAD_TOL,
                   more=None):
    """The leaves of ``port32`` that ``witness_ok`` refuses, each with its
    figures (port_vs_ref, ref_f32_vs_f64, port_f32_vs_f64), measured
    against the reference's f32 ``ref32`` and the float64 ``f64``; and
    the largest of each figure over the leaves, with ``nudged_runs``, the
    number of pairs ``more`` gave.

    One sample of an ill-conditioned leaf's rounding error can fall far
    below its spread. So where a leaf is refused and ``more`` is given,
    ``more()`` yields further (ref32, f64) pairs of the reference on its
    inputs ``nudged`` by one ulp, and a leaf's ref_f32_vs_f64 becomes the
    largest over all the pairs; the port's stays the one sample at the
    inputs both were given."""
    names = list(names) if names is not None else list(range(len(port32)))
    figs = [[leaf_err(a, b), leaf_err(b, c), leaf_err(a, c)]
            for a, b, c in zip(port32, ref32, f64)]
    runs = 0
    if more is not None and not all(witness_ok(*f, tol=tol) for f in figs):
        for r32, r64 in more():
            runs += 1
            for f, b, c in zip(figs, r32, r64):
                f[1] = max(f[1], leaf_err(b, c))
    misses = [(name, tuple(f)) for name, f in zip(names, figs)
              if not witness_ok(*f, tol=tol)]
    worst = dict(zip(("port_vs_ref", "ref_f32_vs_f64", "port_f32_vs_f64"),
                     (max(f[i] for f in figs) for i in range(3))))
    return misses, dict(worst, nudged_runs=runs)
