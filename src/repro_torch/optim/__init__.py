"""Optimizers, schedules, gradient accumulation and gradient compression on
trees of tensors: the port of ``repro.optim``."""
from repro_torch.optim.optimizers import (
    adam, adamw, adagrad, adafactor, sgd, Optimizer, OptState, apply_updates,
    get_optimizer, tree_map, tree_leaves,
)
from repro_torch.optim.schedules import (
    ReduceLROnPlateau, cosine_schedule, linear_warmup_cosine,
)
from repro_torch.optim.accumulate import GradAccumulator
from repro_torch.optim.compression import (
    ErrorFeedback, TopKPayload, dequantize_int8, flatten_grads,
    quantize_int8, topk_compress, topk_decompress, unflatten_grads,
)

__all__ = [
    "adam", "adamw", "adagrad", "adafactor", "sgd", "Optimizer", "OptState",
    "apply_updates", "get_optimizer", "tree_map", "tree_leaves",
    "ReduceLROnPlateau", "cosine_schedule", "linear_warmup_cosine",
    "GradAccumulator", "ErrorFeedback", "TopKPayload", "dequantize_int8",
    "flatten_grads", "quantize_int8", "topk_compress", "topk_decompress",
    "unflatten_grads",
]
