"""LR schedules. ReduceLROnPlateau is the paper's scheduler (App. B: factor
0.33, patience 30, min_lr 1e-4, cooldown 10, on validation loss).

The port's copy of ``repro.optim.schedules`` (pure Python)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ReduceLROnPlateau:
    lr: float = 1e-3
    factor: float = 0.33
    patience: int = 30
    min_lr: float = 1e-4
    cooldown: int = 10
    best: float = float("inf")
    bad_epochs: int = 0
    cooldown_left: int = 0

    def step(self, metric: float) -> float:
        """Call once per epoch with the validation loss; returns current lr."""
        if metric < self.best - 1e-12:
            self.best = metric
            self.bad_epochs = 0
        elif self.cooldown_left > 0:
            self.cooldown_left -= 1
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
                self.cooldown_left = self.cooldown
        return self.lr


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def fn(step: int) -> float:
        t = min(step / max(total_steps, 1), 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + np.cos(np.pi * t)))
    return fn


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.0):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)
    def fn(step: int) -> float:
        if step < warmup:
            return base_lr * (step + 1) / warmup
        return cos(step - warmup)
    return fn
