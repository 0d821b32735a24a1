"""Public row-gather API: ``gather_rows(table, idx)``.

The port of ``repro.kernels.gather_rows.ops``. For CUDA tensors it launches
the hand-written CUDA kernel ``csrc/gather_rows.cu`` (the counterpart of
``gather_rows_pallas``); for CPU tensors it runs the plain ``table[idx]``.
It is the STANDALONE gather: the bcsr aggregation gathers its x stripes
inside the SpMM kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gather_rows.ref import gather_rows_ref

KERNEL = "gather_rows"
SOURCE = "gather_rows.cu"
IMPLS = ("cuda", "reference")
DTYPES = (torch.float32, torch.bfloat16)


def unit_bytes(row_bytes: int, *addresses: int) -> int:
    """The widest copy unit (16, 8, 4, 2 or 1 bytes) that divides the row's
    byte width and every address: what each lane of the kernel moves."""
    for unit in (16, 8, 4, 2):
        if row_bytes % unit == 0 and all(a % unit == 0 for a in addresses):
            return unit
    return 1


def _launch_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Validate, allocate and launch on the current stream; raises on what
    the kernel does not take and on a refused launch."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows wants table (N, F) and idx (M,); got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    if table.dtype not in DTYPES:
        raise TypeError(f"gather_rows kernel takes {DTYPES}, got "
                        f"{table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    dev = table.device
    for name, t in (("table", table), ("idx", idx)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; both operands must "
                             f"be on one CUDA device (table is on {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, f = table.shape
    m = idx.shape[0]
    out = torch.empty((m, f), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    row_bytes = f * table.element_size()
    lib = build.load_library(SOURCE)
    fn = lib.gather_rows_bytes
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + \
        [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, m,
                 row_bytes, unit_bytes(row_bytes, table.data_ptr(),
                                       out.data_ptr()), stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{err}")
    build.count_launch(KERNEL)
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                impl: Optional[str] = None,
                block_f: int = 512) -> torch.Tensor:
    """out[i, :] = table[idx[i], :]; table (N, F) f32 or bf16, idx (M,)
    int32 → (M, F).

    impl: None picks by device — the CUDA kernel for CUDA tensors, the
    plain ``table[idx]`` (``"reference"``) for CPU tensors; ``"cuda"``
    demands the kernel and raises on CPU tensors. On the card an index
    outside [0, N) reads nothing and yields a row of zeros; the plain
    version raises for it. ``block_f`` is the TPU kernel's feature-tile
    width, kept in the signature only: the CUDA kernel copies whole rows.
    """
    if impl is None:
        impl = "cuda" if table.device.type == "cuda" else "reference"
    if impl == "cuda":
        return _launch_cuda(table, idx)
    if impl == "reference":
        return gather_rows_ref(table, idx)
    raise ValueError(f"unknown impl {impl!r}; want one of {IMPLS} or None")
