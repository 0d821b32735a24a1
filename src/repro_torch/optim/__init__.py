"""Optimizers, schedules and gradient accumulation on trees of tensors: the
port of ``repro.optim`` (gradient compression waits for the LM stack)."""
from repro_torch.optim.optimizers import (
    adam, adamw, adagrad, adafactor, sgd, Optimizer, OptState, apply_updates,
    get_optimizer, tree_map, tree_leaves,
)
from repro_torch.optim.schedules import (
    ReduceLROnPlateau, cosine_schedule, linear_warmup_cosine,
)
from repro_torch.optim.accumulate import GradAccumulator

__all__ = [
    "adam", "adamw", "adagrad", "adafactor", "sgd", "Optimizer", "OptState",
    "apply_updates", "get_optimizer", "tree_map", "tree_leaves",
    "ReduceLROnPlateau", "cosine_schedule", "linear_warmup_cosine",
    "GradAccumulator",
]
