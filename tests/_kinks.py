"""The kinks of the GNNs' activations, and the rule that excuses an element
of a card-vs-CPU gradient check only where a kink explains it (no JAX
here: ``chip_smoke.py``, ``tests/gat_kinks.py`` and the CPU tests import
it).

``torch.relu`` (the hidden layers of every GNN) and GAT's attention
``F.leaky_relu`` have a kink at 0: their derivative is 1 above it and 0 or
the slope at and below it. Where one pre-activation lies within a few ulps
of 0, the card and the CPU, which round the sums before it in other
orders, can put it on opposite sides. Its value hardly differs, but the
gradient that flows back through it is passed whole on one device and
scaled on the other: every gradient element it reaches may differ by about
its own size. ``kink_witness`` holds such an element to the CPU's step
recomputed with the card's side of each flipped pre-activation, and
refuses a flip that is no kink, an element the recomputation does not
explain, and more of a leaf excused than ``MAX_SHARE`` of it (at least
one element) for each flip.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

# a flip is a kink if both devices' values lie within this many ulps of
# the tensor's largest |value| of 0
KINK_ULPS = 8
# the share of a leaf's elements one flip may excuse (at least one
# element: a flip passes or blocks one unit's gradient, so a bias or norm
# leaf indexed by that unit differs in one element)
MAX_SHARE = 0.01
F32_EPS = float(np.finfo(np.float32).eps)


def _slope(func, args, kwargs) -> float:
    if func is torch.relu:
        return 0.0
    return float(args[1] if len(args) > 1 else kwargs.get("negative_slope",
                                                           0.01))


class kink_trace(TorchFunctionMode):
    """Records a copy of the input of every ``torch.relu`` and
    ``F.leaky_relu`` call, in call order (``inputs``). With ``sides``, one
    bool tensor per call in the same order, call i instead computes
    ``where(sides[i], x, slope * x)``: the op with its derivative's side
    taken from ``sides``, not from the sign of ``x``."""

    def __init__(self, sides=None):
        super().__init__()
        self.inputs = []
        self.sides = sides

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.relu or func is F.leaky_relu:
            x = args[0]
            i = len(self.inputs)
            self.inputs.append(x.detach().clone())
            if self.sides is not None:
                side = self.sides[i].to(x.device)
                return torch.where(side, x, x * _slope(func, args, kwargs))
        return func(*args, **kwargs)


def sides_of(inputs):
    """Each traced call's derivative side: ``x > 0``."""
    return [x > 0 for x in inputs]


def flips(card_inputs, cpu_inputs):
    """Per traced call, the flipped pre-activations: ``(call, index,
    x_card, x_cpu, ulps)`` for every position the two devices put on
    opposite sides of 0, ``ulps`` the larger |x| in units of the ulp of the
    call's largest |x| on the CPU."""
    out = []
    if len(card_inputs) != len(cpu_inputs):
        raise AssertionError(f"{len(card_inputs)} traced calls on the card, "
                             f"{len(cpu_inputs)} on the CPU")
    for i, (a, b) in enumerate(zip(card_inputs, cpu_inputs)):
        a, b = a.detach().cpu(), b.detach().cpu()
        ulp = F32_EPS * max(float(b.abs().max()), 1e-30)
        for idx in torch.nonzero((a > 0) != (b > 0)).tolist():
            xa, xb = float(a[tuple(idx)]), float(b[tuple(idx)])
            out.append((i, tuple(idx), xa, xb, max(abs(xa), abs(xb)) / ulp))
    return out


def kink_witness(card, cpu, forced, atol: float, rtol: float, names=None,
                 n_flips: int = 1):
    """The check of one step's gradient leaves ``card`` against ``cpu``
    (the CPU's step) with the kink rule: every element within ``atol`` and
    ``rtol``, except one that ``forced`` (the CPU's step with the card's
    side of each of the ``n_flips`` flipped pre-activations) holds within
    the same tolerance. ``forced`` is None where nothing flipped. Returns
    ``(excused, worst, problems)``: the number of excused elements, their
    largest |card - cpu|, and a list of what the rule refuses (an element
    ``forced`` does not explain, a leaf with more excused than
    ``n_flips`` times ``MAX_SHARE`` of it, at least one element a flip)."""
    names = list(names) if names is not None else list(range(len(card)))
    excused, worst, problems = 0, 0.0, []
    for k, (name, a, b) in enumerate(zip(names, card, cpu)):
        a, b = a.detach().cpu(), b.detach().cpu()
        bad = ~torch.isclose(a, b, atol=atol, rtol=rtol)
        n_bad = int(bad.sum())
        if not n_bad:
            continue
        if forced is None:
            problems.append(f"{name}: {n_bad} elements outside the "
                            f"tolerance and no pre-activation flipped")
            continue
        f = forced[k].detach().cpu()
        held = torch.isclose(a, f, atol=atol, rtol=rtol)
        unexplained = int((bad & ~held).sum())
        if unexplained:
            problems.append(f"{name}: {unexplained} of {n_bad} elements "
                            f"outside the tolerance are not explained by "
                            f"the flipped kinks (max |card - forced CPU| "
                            f"{float((a - f)[bad & ~held].abs().max()):.3e})")
        limit = n_flips * max(1, int(MAX_SHARE * a.numel()))
        if n_bad > limit:
            problems.append(f"{name}: {n_bad} of {a.numel()} elements "
                            f"excused, more than {limit} ({MAX_SHARE:.0%} "
                            f"of the leaf, at least 1, for each of "
                            f"{n_flips} flips)")
        excused += n_bad
        worst = max(worst, float((a - b)[bad].abs().max()))
    return excused, worst, problems


def flip_problems(flip_list):
    """What the rule refuses of ``flips``' output: a flipped pre-activation
    farther than ``KINK_ULPS`` ulps from 0, which no rounding explains."""
    return [f"call {c} at {idx}: card {a:.3e}, CPU {b:.3e}, {u:.1f} ulps "
            f"from 0 (more than {KINK_ULPS})"
            for c, idx, a, b, u in flip_list if u > KINK_ULPS]


def leaf_names(params):
    """``layers.<i>.<name>`` for each leaf of a GNN's parameters, in the
    order ``tree_leaves`` gives them."""
    return [f"layers.{i}.{k}" for i, layer in enumerate(params["layers"])
            for k in layer]
