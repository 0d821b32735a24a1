"""Gradient accumulation (paper Fig. 8: accumulating over up to the whole
epoch barely changes IBMB convergence).

The port of ``repro.optim.accumulate`` on trees of tensors."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.optim.optimizers import tree_map


class GradAccumulator:
    """Host-side accumulator across steps.

    Usage:
        acc = GradAccumulator(every=k)
        g = acc.add(grads)          # returns averaged grads every k-th call, else None
    """

    def __init__(self, every: int = 1):
        self.every = max(1, every)
        self._buf: Optional[Any] = None
        self._count = 0

    def add(self, grads):
        if self.every == 1:
            return grads
        if self._buf is None:
            self._buf = grads
        else:
            self._buf = tree_map(torch.add, self._buf, grads)
        self._count += 1
        if self._count >= self.every:
            out = tree_map(lambda g: g / self._count, self._buf)
            self._buf, self._count = None, 0
            return out
        return None

    def flush(self):
        if self._buf is None:
            return None
        out = tree_map(lambda g: g / self._count, self._buf)
        self._buf, self._count = None, 0
        return out
