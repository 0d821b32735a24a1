"""The yardstick's peaks and counts: one H100's published rates, the least
time of a sparse-times-dense product (SpMM) call, and the model operations
of a GNN step. Which SpMM calls a batch makes, and its model operations,
are its kind's (``kinds/<kind>.py``: ``spmm_calls``, ``forward_flops``).

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit: 67
TFLOP/s float32 outside the tensor cores (the port's GNN runs float32 with
TF32 off) and 3.35 TB/s of HBM3.

A call's least time is max(bytes / bandwidth, operations / peak) over what
the batch's adjacency needs, counted from the reference's own batches and
never from the program's storage format: a column id per nonzero entry
(and a float32 value where the product is weighted), a row offset per row,
the ``x`` rows of the distinct columns that hold a nonzero, the output rows
that hold one written once, and 2 operations per nonzero entry and feature.
Padding, all-zero blocks and the block size the program stores add
nothing, so a kernel that reads less of them shows as a gain.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from perfbench.harness.cell import kind_of

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


@dataclasses.dataclass(frozen=True)
class SpmmNeeds:
    """What one batch's adjacency needs of an SpMM: its nonzero entries,
    and the distinct rows and columns that hold one."""
    nnz: int
    rows: int
    cols: int


def spmm_needs(src: np.ndarray, dst: np.ndarray) -> SpmmNeeds:
    """``src``/``dst``: the nonzero entries' batch-local rows and
    columns."""
    return SpmmNeeds(len(src), len(np.unique(src)), len(np.unique(dst)))


def spmm_bytes(t: SpmmNeeds, f: int, weighted: bool) -> int:
    entry = 8 if weighted else 4
    return t.nnz * entry + (t.rows + 1) * 4 + (t.cols + t.rows) * f * 4


def spmm_flops(t: SpmmNeeds, f: int) -> float:
    return 2.0 * t.nnz * f


def spmm_bound_s(t: SpmmNeeds, f: int, weighted: bool) -> float:
    """Least time of one ``A @ x`` call with ``x`` of width ``f``."""
    return max(spmm_bytes(t, f, weighted) / PEAK_HBM_BYTES,
               spmm_flops(t, f) / PEAK_F32_FLOPS)


def spmm_calls(model: dict, train: bool) -> List[int]:
    """The width of every SpMM call of one batch, forward then, in a
    training step, backward."""
    return [f for f, _ in kind_of(model).spmm_calls(model, train)]


def batch_bound_s(t: SpmmNeeds, model: dict, train: bool) -> float:
    """Least time of one batch's SpMM calls, each weighted (a value per
    nonzero entry) or a pattern as its kind makes it."""
    return sum(spmm_bound_s(t, f, weighted)
               for f, weighted in kind_of(model).spmm_calls(model, train))


def model_flops(model: dict, real_nodes: int, nnz: int, train: bool) -> float:
    """Operations one batch needs of the model: its kind's forward over the
    real nodes and the nonzero entries; three times that for a training
    step's forward and backward."""
    return kind_of(model).forward_flops(model, real_nodes, nnz) * (
        3 if train else 1)
