"""The numbers that decide ``correct``: what the program's timed path
produced against what the reference works out again.

A leaf's gap of norms is the distance between the program's norm and the
reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger (some gradients are all but zero). A leaf whose
reference gradient is under a thousandth of the median leaf's moves under
Adam by round-off alone; it is left out of the parameters' change.

Training compares the numbers that are steady from seed to seed: the
first step's loss (a forward pass, continuous in every input); the first
gradient by the worst leaf of the last layer, the leaves that no ReLU
lies behind; and the change over the checked steps by the median moved
leaf. The worst leaf over every layer, and the later steps' losses, swing
a hundredfold from seed to seed with no fault anywhere: a pre-activation
within rounding of zero passes or blocks its gradient, and Adam's first
step moves an element whose gradient is all but zero by the full rate in
the direction that rounding gives it. They are worked out and logged,
not compared.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

ROUNDOFF_LEAF = 1e-3


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Each leaf's |‖prog‖ − ‖ref‖| / max(‖ref‖, median leaf's ‖ref‖)."""
    leaves = list(ref) if leaves is None else list(leaves)
    if set(prog) != set(ref):
        return {k: float("inf") for k in leaves}
    pn, rn = _norms(prog), _norms(ref)
    med = float(np.median([rn[k] for k in leaves]))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in leaves}


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leaves: Optional[Sequence[str]] = None) -> float:
    """Worst leaf's gap of norms (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, leaves).values())


def last_layer(leaves: Sequence[str]) -> List[str]:
    """The leaves ``layers.<l>.*`` of the largest ``l``."""
    top = max(int(k.split(".")[1]) for k in leaves)
    return [k for k in leaves if int(k.split(".")[1]) == top]


def moved_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding."""
    rn = _norms(ref_grad)
    med = float(np.median(list(rn.values())))
    return [k for k, v in rn.items() if v >= ROUNDOFF_LEAF * med]


def train_numbers(prog: Dict, ref: Dict, init_ref: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
    """``prog``: losses, p0, grad1, p_after of the program's first steps;
    ``ref``: losses, grad1, p_after of the reference on the same batches.
    Returns the compared numbers and, beside them, ``loss_gap`` (the worst
    step's), ``grad_gap`` and ``step_gap`` (the worst leaf's)."""
    out = {}
    n = len(ref["losses"])
    lp = prog["losses"]
    gaps = [abs(lp[i] - ref["losses"][i]) / abs(ref["losses"][i])
            for i in range(min(n, len(lp)))] + [float("inf")] * (n - len(lp))
    out["loss1_gap"], out["loss_gap"] = gaps[0], max(gaps)
    out["init_gap"] = max(float((prog["p0"][k].cpu() - init_ref[k].cpu())
                                .abs().max()) for k in init_ref) \
        if set(prog["p0"]) == set(init_ref) else float("inf")
    grad = leaf_gaps(prog["grad1"], ref["grad1"])
    out["grad_gap_last"] = max(grad[k] for k in last_layer(list(grad)))
    out["grad_gap"] = max(grad.values())
    keep = moved_leaves(ref["grad1"])
    d_prog = {k: prog["p_after"][k] - prog["p0"][k] for k in keep}
    d_ref = {k: ref["p_after"][k] - init_ref[k] for k in keep}
    step = leaf_gaps(d_prog, d_ref, keep)
    out["step_gap_median"] = float(np.median(list(step.values())))
    out["step_gap"] = max(step.values())
    return out


def logit_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """Largest |prog − ref| over the largest |ref| of the rows compared."""
    if prog.shape != ref.shape:
        return float("inf")
    scale = max(float(np.abs(ref).max()), 1e-30)
    d = np.abs(prog.astype(np.float64) - ref.astype(np.float64))
    return float(np.nan_to_num(d, nan=np.inf).max()) / scale


def plan_wrong(plan_nodes: np.ndarray, plan_outputs: List[np.ndarray],
               ref_batches, ordered: Dict[int, np.ndarray]) -> int:
    """Batches of the plan whose node set or output set differs from the
    reference's, or, for the batches in ``ordered``, whose batch-local
    order differs from the reference's."""
    if len(plan_nodes) != len(ref_batches):
        return max(len(plan_nodes), len(ref_batches))
    wrong = 0
    for b, rb in enumerate(ref_batches):
        ids = plan_nodes[b][plan_nodes[b] >= 0]
        ok = (np.array_equal(np.sort(ids), rb.nodes)
              and np.array_equal(np.sort(plan_outputs[b]), rb.outputs))
        if b in ordered:
            ok = ok and np.array_equal(ids, ordered[b])
        wrong += not ok
    return wrong


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a missing number fails)."""
    return all(k in numbers and np.isfinite(numbers[k])
               and numbers[k] <= limits[k] for k in limits)
