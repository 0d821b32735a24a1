"""Public flash-attention API: ``flash_attention(q, k, v, causal, window,
impl)``.

The port of ``repro.kernels.flash_attention.ops``. For CUDA tensors it
launches the hand-written CUDA kernels of ``csrc/flash_attention.cu`` (the
counterpart of ``flash_attention_pallas``): bf16 inputs go to a kernel on
the tensor cores (``wgmma``, fed by TMA), f32 inputs to one that computes
in exact f32 on the CUDA cores. For CPU tensors it runs the plain
``attention_ref``. Forward only, as in the reference: there is no
backward, so the wrapper refuses inputs that would need one.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

KERNEL = "flash_attention"
#: the launch count of the kernels' head-dim-256 instantiations (the
#: bf16 one a block of one consumer warpgroup), recurrentgemma's local layers
KERNEL_D256 = "flash_attention_d256"
SOURCE = "flash_attention.cu"
IMPLS = ("cuda", "reference")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)


def _launch_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, window: int) -> torch.Tensor:
    """Validate, allocate and launch on the current stream; raises on what
    the kernel does not take and on a refused launch."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q (B, H, S, D) and k, v "
                         f"(B, KV, S, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    kv = k.shape[1]
    if k.shape[0] != b or k.shape[2:] != (s, d) or h % kv != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (need B, S, D equal and "
                         f"H % KV == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes one of "
                        f"{tuple(DTYPES)} for q, k and v; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(
                    n > 1 and st % 8 for n, st in zip(t.shape[:3],
                                                      t.stride()[:3])):
                raise ValueError(
                    f"{name}: the bf16 kernel reads through TMA, which "
                    f"needs a 16-byte-aligned start and batch, head and "
                    f"sequence strides that are multiples of 16 bytes (8 "
                    f"values); got strides {t.stride()} at offset "
                    f"{t.data_ptr() % 16} bytes past a 16-byte boundary")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward (nor has the "
                           "reference's kernel); call it under "
                           "torch.no_grad()")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; q, k and v must be "
                             f"on one CUDA device (q is on {dev})")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous, got "
                             f"strides {t.stride()}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid")
    # q's strides where q is dense (else contiguous): a (B, S, H, D) layout
    # passed as a transposed view comes back in that layout
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*(
        st for t in (q, k, v, out) for st in t.stride()[:3]))
    lib = build.load_library(SOURCE)
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 DTYPES[q.dtype], b, h, kv, s, d, strides, int(causal),
                 int(window), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    build.count_launch(KERNEL_D256 if d == 256 else KERNEL)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """softmax(q k^T · D^-0.5) v. q (B, H, S, D), k/v (B, KV, S, D) with
    H % KV == 0 (query head h reads kv head h // (H/KV)) → (B, H, S, D) in
    q's dtype. window > 0 ⇒ position i sees [i-window+1, i] (with causal).

    impl: None picks by device — the CUDA kernel for CUDA tensors, the
    plain ``attention_ref`` (``"reference"``) for CPU tensors; ``"cuda"``
    demands the kernel and raises on CPU tensors. The kernels take f32 and
    bf16, D in (64, 128, 256), any S, and any strides whose last axis is
    contiguous; bf16 also wants a 16-byte-aligned start and batch, head
    and sequence strides that are multiples of 8 values (TMA's rule).
    """
    if impl is None:
        impl = "cuda" if q.device.type == "cuda" else "reference"
    if impl == "cuda":
        return _launch_cuda(q, k, v, causal, window)
    if impl == "reference":
        return attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown impl {impl!r}; want one of {IMPLS} or None")
