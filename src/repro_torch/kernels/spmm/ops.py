"""Public SpMM API: host-side CSR→BCSR conversion + device-switched wrapper.

This is the aggregation-backend boundary (DESIGN.md §7): preprocessing emits
the padded block-CSR layout once per batch via ``csr_to_bcsr`` (vectorized
numpy, copied from ``repro.kernels.spmm.ops``), and the GNN forward calls
``spmm_bcsr`` / ``spmm_bcsr_sym`` every step.

``spmm_bcsr`` launches a hand-written CUDA kernel for CUDA tensors and runs
the plain streaming version for CPU tensors; ``impl="stream"``/
``"reference"`` name the plain versions explicitly. Two kernels compute the
same function:

* ``impl="cuda"`` (``csrc/spmm_bcsr.cu``), the counterpart of the
  reference's ``impl="fused"`` (``spmm_bcsr_fused_pallas``); the default
  for CUDA tensors and the one the GNN layers run.
* ``impl="cuda_unfused"`` (``csrc/spmm_bcsr_unfused.cu``), the counterpart
  of the reference's ``impl="pallas"`` (``spmm_bcsr_pallas``): K stays a
  grid axis, split into ``S`` ranges whose partial sums a second kernel
  adds in fixed order.

``pattern=True`` computes ``(A != 0) @ x`` instead, the neighbour sum of
GraphSAGE's mean aggregation: the ``"cuda"`` kernel's pattern mode
(``spmm_bcsr_pattern_f32``, counted as ``spmm_bcsr_pattern``) takes each
nonzero entry as 1 without building the binary tiles; the plain versions
multiply ``binary_tiles(tile_vals)``, as the reference does.

Both stream ``tile_vals`` once through shared memory and multiply only its
nonzero entries (``csrc/spmm_tile.cuh``), so a NaN or Inf in ``x`` reaches
only the rows whose nonzero entries read it, as in the reference's
``segment`` backend; the plain versions multiply every entry densely.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceSpec, resolve_device, to_tensor
from repro_torch.kernels import build
from repro_torch.kernels.spmm.ref import (
    binary_tiles, spmm_bcsr_ref, spmm_bcsr_stream)

KERNEL = "spmm_bcsr"
KERNEL_PATTERN = "spmm_bcsr_pattern"
SOURCE = "spmm_bcsr.cu"
KERNEL_UNFUSED = "spmm_bcsr_unfused"
SOURCE_UNFUSED = "spmm_bcsr_unfused.cu"
MAX_BLOCK = 128         # largest tile block B the kernels take
IMPLS = ("cuda", "cuda_unfused", "stream", "reference")
FEATURE_BLOCK = 256     # output features per thread block in both kernels
ROW_GROUP = 8           # rows of a row tile per thread block in both kernels


@dataclasses.dataclass
class BCSR:
    """Padded block-CSR: every row-tile holds exactly K tile slots (zero tiles
    pad). Block size B is MXU-native 128 by default."""
    tile_cols: np.ndarray   # (R, K) int32
    tile_vals: np.ndarray   # (R, K, B, B) float32
    num_rows: int
    num_cols: int

    @property
    def block(self) -> int:
        return self.tile_vals.shape[-1]

    def with_pad_k(self, pad_k: int) -> "BCSR":
        """Pad every row-tile to exactly `pad_k` slots (all-zero tiles at
        col-tile 0) — the ONE place K-padding lives, used both by the
        csr_to_bcsr pad_k arg and by build_batches when stacking batches
        into a shared-shape cache."""
        k = self.tile_cols.shape[1]
        if pad_k < k:
            raise ValueError(f"pad_k={pad_k} < required K={k}")
        if pad_k == k:
            return self
        return BCSR(
            np.pad(self.tile_cols, ((0, 0), (0, pad_k - k))),
            np.pad(self.tile_vals, ((0, 0), (0, pad_k - k), (0, 0), (0, 0))),
            self.num_rows, self.num_cols)

    def density_stats(self) -> dict:
        nz_tiles = int((np.abs(self.tile_vals).sum(axis=(2, 3)) > 0).sum())
        r, k, b, _ = self.tile_vals.shape
        return dict(row_tiles=r, max_tiles_per_row=k, nonzero_tiles=nz_tiles,
                    tile_fill=float(np.count_nonzero(self.tile_vals)) /
                              max(nz_tiles * b * b, 1))


def csr_to_bcsr(indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray,
                num_rows: int, num_cols: int, block: int = 128,
                pad_k: Optional[int] = None) -> BCSR:
    """Host-side conversion (preprocessing time — amortized like the paper's
    batch cache). Rows/cols are padded up to a multiple of `block`.

    Vectorized (DESIGN.md §7): entries are bucketed into (row_tile, col_tile)
    keys with one stable argsort; tile slots and in-tile offsets then come
    from ``np.unique`` + searchsorted arithmetic, so the cost is
    O(nnz log nnz) regardless of tile population. Explicit zero entries
    (e.g. masked/padded edges) are dropped — they carry no aggregation mass
    and would only deflate tile fill.

    pad_k: pad every row-tile to exactly `pad_k` slots (so batches built
    separately can be stacked into one contiguous cache array).
    """
    rpad = (num_rows + block - 1) // block * block
    cpad = (num_cols + block - 1) // block * block
    r_tiles, c_tiles = rpad // block, cpad // block

    counts = np.diff(np.asarray(indptr, dtype=np.int64))
    rows = np.repeat(np.arange(num_rows, dtype=np.int64), counts)
    cols = np.asarray(indices, dtype=np.int64)
    data = np.asarray(weights, dtype=np.float32)
    nz = data != 0
    rows, cols, data = rows[nz], cols[nz], data[nz]

    if len(rows) == 0:
        return BCSR(np.zeros((r_tiles, 1), np.int32),
                    np.zeros((r_tiles, 1, block, block), np.float32),
                    rpad, cpad).with_pad_k(max(pad_k or 1, 1))

    rt, ct = rows // block, cols // block
    key = rt * c_tiles + ct
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, entry_tile = np.unique(key_s, return_inverse=True)
    tile_r = uniq // c_tiles                      # (T,) row-tile of each tile
    tile_c = uniq % c_tiles                       # (T,) col-tile of each tile
    # slot of each tile within its row-tile (tiles sorted ⇒ contiguous rows)
    row_first = np.searchsorted(tile_r, np.arange(r_tiles))
    slot = np.arange(len(uniq)) - row_first[tile_r]
    k = int(slot.max()) + 1

    tile_cols = np.zeros((r_tiles, k), np.int32)
    tile_cols[tile_r, slot] = tile_c
    tile_vals = np.zeros((r_tiles, k, block, block), np.float32)
    # scatter-add (duplicate (i,j) within a tile accumulates, matching CSR
    # sum_duplicates semantics)
    np.add.at(tile_vals,
              (tile_r[entry_tile], slot[entry_tile],
               rows[order] % block, cols[order] % block),
              data[order])
    out = BCSR(tile_cols, tile_vals, rpad, cpad)
    return out if pad_k is None else out.with_pad_k(pad_k)


def build_tiles(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                edge_weight: torch.Tensor, tile_cols: torch.Tensor,
                block: int) -> torch.Tensor:
    """The float32 ``(R, K, B, B)`` tiles of a batch's COO edges on the
    slots of its ``tile_cols``, made where the tensors lie (on a card, from
    edges a few MB in size, instead of copying the dense tiles), with no
    wait on the device.

    For the ``tile_cols`` that ``csr_to_bcsr`` gave for the same edges (as
    a batch's CSR, rows ``edge_src``, columns ``edge_dst``) it gives that
    converter's ``tile_vals``, bit for bit: entries with weight 0 (padded
    edges, ``-0.0``) are dropped; a row tile's real slots are the leading
    run of strictly ascending columns, the rest are padding (column 0, all
    zeros, ``BCSR.with_pad_k``); each entry is added into zeros at
    ``(src // B, slot, src % B, dst % B)``. An entry outside the ``R * B``
    nodes or on a column tile with no real slot is dropped, so tiles that
    do not belong to these edges come out different, never out of bounds.
    """
    r, k = tile_cols.shape
    dev = tile_cols.device
    cols = tile_cols.long()
    asc = torch.ones((r, k), dtype=torch.long, device=dev)
    asc[:, 1:] = cols[:, 1:] > cols[:, :-1]
    real = asc.cumprod(dim=1).bool() & (cols >= 0) & (cols < r)
    # slot of each (row tile, column tile) pair, -1 where it has none;
    # each padded slot writes an entry of its own past the pairs, never read
    slot_of = torch.full((r * r + r * k,), -1, dtype=torch.long, device=dev)
    rows = torch.arange(r, device=dev).unsqueeze(1)
    slots = torch.arange(k, device=dev).expand(r, k)
    slot_of[torch.where(real, rows * r + cols, r * r + rows * k + slots)] = \
        slots

    n = r * block
    src, dst = edge_src.long(), edge_dst.long()
    keep = (edge_weight != 0) & (src >= 0) & (src < n) & (dst >= 0) \
        & (dst < n)
    src, dst = torch.where(keep, src, 0), torch.where(keep, dst, 0)
    slot = slot_of[(src // block) * r + dst // block]
    keep &= slot >= 0
    flat = (((src // block) * k + slot) * block + src % block) * block \
        + dst % block
    # each dropped entry lands in an element of its own past the tiles: the
    # scatter adds the entries of one element in turn, so a shared one
    # would take every padded edge of the batch one by one (2.7 ms a test
    # batch of the arxiv-size plan on an H100, against 0.1 ms)
    size = r * k * block * block
    past = size + torch.arange(len(flat), device=dev)
    out = torch.zeros(size + len(flat), dtype=torch.float32, device=dev)
    out.index_put_((torch.where(keep, flat, past),),
                   edge_weight.to(torch.float32), accumulate=True)
    return out[:size].view(r, k, block, block)


# The fields of a batch ``batch_tiles`` reads, ``tile_vals`` first: the
# tiles it makes from the other four.
TILE_SOURCES = ("tile_vals", "tile_cols", "edge_src", "edge_dst",
                "edge_weight")


def batch_tiles(staged: Mapping[str, torch.Tensor],
                host: Mapping[str, np.ndarray]) -> torch.Tensor:
    """``build_tiles`` of a batch's staged edge and ``tile_cols`` fields,
    at the block of its host ``tile_vals``: its ``tile_vals``, where they
    belong to its edges."""
    return build_tiles(staged["edge_src"], staged["edge_dst"],
                       staged["edge_weight"], staged["tile_cols"],
                       host["tile_vals"].shape[-1])


def _as_tensor(a, device: DeviceSpec) -> torch.Tensor:
    """Tensors stay where they are unless ``device`` names another place;
    host arrays go to ``device`` (``cuda`` when it is None)."""
    if torch.is_tensor(a):
        return a if device is None else a.to(resolve_device(device))
    return to_tensor(a, device)


def _check_operands(tile_cols: torch.Tensor, tile_vals: torch.Tensor,
                    x: torch.Tensor, name: str) -> None:
    """Raise on anything the kernels do not take."""
    if tile_vals.dim() != 4 or tile_cols.dim() != 2 or x.dim() != 2:
        raise ValueError(
            f"{name} wants tile_cols (R, K), tile_vals (R, K, B, B), "
            f"x (C·B, F); got {tuple(tile_cols.shape)}, "
            f"{tuple(tile_vals.shape)}, {tuple(x.shape)}")
    r, k, b, b2 = tile_vals.shape
    if b != b2 or tuple(tile_cols.shape) != (r, k):
        raise ValueError(f"tile shapes disagree: tile_cols "
                         f"{tuple(tile_cols.shape)}, tile_vals "
                         f"{tuple(tile_vals.shape)}")
    if not 1 <= b <= MAX_BLOCK:
        raise ValueError(f"tile block B={b} outside [1, {MAX_BLOCK}]")
    if x.shape[0] % b:
        raise ValueError(f"x has {x.shape[0]} rows, not a multiple of "
                         f"B={b}")
    if tile_cols.dtype != torch.int32:
        raise TypeError(f"tile_cols must be int32, got {tile_cols.dtype}")
    if tile_vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes float32 only, got "
                        f"tile_vals {tile_vals.dtype}, x {x.dtype}")
    dev = x.device
    for arg, t in (("tile_cols", tile_cols), ("tile_vals", tile_vals),
                   ("x", x)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{arg} is on {t.device}; all operands must "
                             f"be on one CUDA device (x is on {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _launch_cuda(tile_cols: torch.Tensor, tile_vals: torch.Tensor,
                 x: torch.Tensor, pattern: bool = False) -> torch.Tensor:
    """Validate the operands, allocate the output and launch the kernel
    (its pattern mode with ``pattern``) on the current stream. Raises on
    anything the kernel does not take and on a refused launch; never falls
    back to a plain version."""
    name = KERNEL_PATTERN if pattern else KERNEL
    _check_operands(tile_cols, tile_vals, x, name)
    r, k, b, _ = tile_vals.shape
    f = x.shape[1]
    dev = x.device
    out = torch.empty((r * b, f), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build.load_library(SOURCE)
    fn = lib.spmm_bcsr_pattern_f32 if pattern else lib.spmm_bcsr_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(tile_cols.data_ptr(), tile_vals.data_ptr(), x.data_ptr(),
                 out.data_ptr(), r, k, b, x.shape[0] // b, f, stream)
    _raise_on(err, name)
    build.count_launch(name)
    return out


def k_splits(r: int, k: int, b: int, f: int, sms: int) -> Tuple[int, int]:
    """``(S, slots per split)`` for the unfused kernel.

    The kernel is bound by the bytes of ``tile_vals`` (read once, whatever
    S is); S > 1 adds ``2·(S−1)·R·B·F·4`` bytes of partials (written, then
    read by the reduction) and buys SMs: ``R·ceil(B/8)·ceil(F/256)·S``
    blocks, each streaming its slabs through its own ring, keep
    ``min(1, blocks / sms)`` of the card's SMs pulling from memory. S
    minimises bytes over that share among the splits with no empty range
    (the fewest on a tie). Where the blocks already cover the SMs (the
    main path's 832-1264 blocks), S = 1 and the partial kernel writes the
    output with no workspace."""
    if k <= 0:
        return 1, 0
    base = r * -(-b // ROW_GROUP) * -(-f // FEATURE_BLOCK)
    vals_bytes, part_bytes = r * k * b * b * 4, r * b * f * 4

    def cost(per: int) -> float:
        s = -(-k // per)
        return (vals_bytes + 2 * (s - 1) * part_bytes) / \
            min(1.0, base * s / sms)

    # beyond ceil(sms / base) splits every SM is busy and bytes only grow
    pers = {-(-k // s) for s in range(1, min(k, -(-sms // base)) + 1)}
    per = min(sorted(pers, reverse=True), key=cost)
    return -(-k // per), per


def _launch_cuda_unfused(tile_cols: torch.Tensor, tile_vals: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """The unfused kernel: partial sums over ``S`` ranges of K into a
    workspace, then their sum in split order. Raises like ``_launch_cuda``."""
    _check_operands(tile_cols, tile_vals, x, KERNEL_UNFUSED)
    r, k, b, _ = tile_vals.shape
    f = x.shape[1]
    dev = x.device
    out = torch.empty((r * b, f), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s, per = k_splits(r, k, b, f, sms)
    ws = torch.empty((s, r * b, f), dtype=torch.float32, device=dev) \
        if s > 1 else None
    lib = build.load_library(SOURCE_UNFUSED)
    fn = lib.spmm_bcsr_unfused_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(tile_cols.data_ptr(), tile_vals.data_ptr(), x.data_ptr(),
                 ws.data_ptr() if ws is not None else None, out.data_ptr(),
                 r, k, b, x.shape[0] // b, f, s, per, stream)
    _raise_on(err, KERNEL_UNFUSED)
    build.count_launch(KERNEL_UNFUSED)
    return out


def spmm_bcsr(bcsr_cols, bcsr_vals, x, impl: Optional[str] = None,
              block_f: int = 0, device: DeviceSpec = None,
              pattern: bool = False) -> torch.Tensor:
    """out = A @ x over padded block-CSR tiles (``(A != 0) @ x`` with
    ``pattern``).

    bcsr_cols (R, K) int32, bcsr_vals (R, K, B, B), x (C·B, F) → (R·B, F).
    Tensors stay on their device; host arrays go to ``device`` (``cuda``
    unless the caller passes another, raising without a card).

    impl: None picks by device — the ``"cuda"`` kernel for CUDA tensors,
    the plain ``"stream"`` version for CPU tensors. ``"cuda"`` (the
    reference's ``"fused"``) and ``"cuda_unfused"`` (the reference's
    ``"pallas"``) demand their kernel and raise on CPU tensors;
    ``"stream"`` and ``"reference"`` run the plain versions on any device.
    ``block_f`` is the autotuner's feature-tile width, sized for a TPU's
    VMEM: a hint the CUDA kernels do not need (they pick their own tiling),
    accepted so callers keep one decision key. ``pattern`` runs on
    ``"cuda"`` (its pattern mode) and on the plain versions; the unfused
    kernel, off the GNN path, has no pattern mode and raises.
    """
    cols = _as_tensor(bcsr_cols, device)
    vals = _as_tensor(bcsr_vals, device)
    x = _as_tensor(x, device)
    if impl is None:
        impl = "cuda" if x.device.type == "cuda" else "stream"
    if impl == "cuda":
        return _launch_cuda(cols, vals, x, pattern)
    if impl == "cuda_unfused":
        if pattern:
            raise ValueError("impl='cuda_unfused' has no pattern mode; use "
                             "impl='cuda'")
        return _launch_cuda_unfused(cols, vals, x)
    if impl not in ("stream", "reference"):
        raise ValueError(f"unknown impl {impl!r}; want one of {IMPLS} or "
                         f"None")
    if pattern:
        vals = binary_tiles(vals, x.dtype)
    plain = spmm_bcsr_stream if impl == "stream" else spmm_bcsr_ref
    return plain(cols, vals, x)


class _SpmmBcsrSym(torch.autograd.Function):
    """``A @ x`` for a symmetric ``A``: the backward pass is the same op on
    the cotangent, ``Aᵀ g = A g``; the tiles are preprocessing constants and
    get no gradient (``repro.kernels.spmm.ops.spmm_bcsr_sym``). The pattern
    of a symmetric ``A`` is symmetric too, so ``pattern`` carries into the
    backward unchanged."""

    @staticmethod
    def forward(ctx, bcsr_cols, bcsr_vals, x, impl, block_f, pattern):
        ctx.save_for_backward(bcsr_cols, bcsr_vals)
        ctx.impl, ctx.block_f, ctx.pattern = impl, block_f, pattern
        return spmm_bcsr(bcsr_cols, bcsr_vals, x, impl=impl, block_f=block_f,
                         pattern=pattern)

    @staticmethod
    def backward(ctx, g):
        bcsr_cols, bcsr_vals = ctx.saved_tensors
        dx = spmm_bcsr(bcsr_cols, bcsr_vals, g.contiguous(), impl=ctx.impl,
                       block_f=ctx.block_f, pattern=ctx.pattern)
        return None, None, dx, None, None, None


def spmm_bcsr_sym(bcsr_cols: torch.Tensor, bcsr_vals: torch.Tensor,
                  x: torch.Tensor, impl: Optional[str] = None,
                  block_f: int = 0, pattern: bool = False) -> torch.Tensor:
    """``A @ x`` (``(A != 0) @ x`` with ``pattern``) for a SYMMETRIC
    block-CSR ``A``, differentiable in ``x``. The IBMB batch adjacency is
    symmetric by construction (DESIGN.md §7), which ``build_batches``
    checks before it emits tiles."""
    return _SpmmBcsrSym.apply(bcsr_cols, bcsr_vals, x, impl, block_f,
                              pattern)
