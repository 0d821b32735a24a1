"""Plain PyTorch version of the row gather: the CPU path, and what the CUDA
kernel is held against on the card."""
from __future__ import annotations

import torch


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]]. table (N, F), idx (M,) int → (M, F). An
    index outside [-N, N) raises."""
    return table[idx.long()]
