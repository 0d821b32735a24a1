"""Plain PyTorch versions of the block-CSR SpMM: the CPU path, and what the
CUDA kernel is held against on the card."""
from __future__ import annotations

import torch


def spmm_bcsr_ref(tile_cols: torch.Tensor, tile_vals: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """out = A @ x with A given as padded block-CSR: gather, then einsum.

    tile_cols: (R, K) int — column-tile index of each of the K tile slots of
               row-tile r (padded slots have all-zero tile_vals).
    tile_vals: (R, K, B, B) — dense tiles.
    x:         (C·B, F).
    Returns (R·B, F). Materializes the (R, K, B, F) gather.
    """
    r, _, b, _ = tile_vals.shape
    f = x.shape[1]
    gathered = x.reshape(-1, b, f)[tile_cols.long()]      # (R, K, B, F)
    out = torch.einsum("rkij,rkjf->rif", tile_vals, gathered)
    return out.reshape(r * b, f)


def spmm_bcsr_stream(tile_cols: torch.Tensor, tile_vals: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """out = A @ x, one tile slot at a time, accumulated in slot order like
    ``repro.kernels.spmm.fused.spmm_bcsr_stream``: peak memory O(R·B·F)
    instead of the reference's O(R·K·B·F)."""
    r, k, b, _ = tile_vals.shape
    f = x.shape[1]
    xt = x.reshape(-1, b, f)
    cols = tile_cols.long()
    acc = torch.zeros((r, b, f), dtype=x.dtype, device=x.device)
    for s in range(k):
        acc += torch.bmm(tile_vals[:, s], xt[cols[:, s]])
    return acc.reshape(r * b, f)


def binary_tiles(tile_vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The nonzero pattern of the tiles as ``dtype`` (1 where a value is not
    zero, NaN included): the reference's ``bin_tiles``
    (``repro.models.gnn.ops.mean_agg_backend``), which the plain versions
    multiply in pattern mode."""
    return (tile_vals != 0).to(dtype)
