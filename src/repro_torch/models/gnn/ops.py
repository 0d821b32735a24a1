"""Message passing on padded COO edge lists + aggregation-backend dispatch.

The port of ``repro.models.gnn.ops`` for the GCN. Batches are dicts of
tensors (``repro_torch.device.stage``); padded edges carry weight 0 and
point at node 0, so weighted sums are exact without branching.

Aggregation runs on one of three backends (DESIGN.md §7):

* "segment" — gather + ``index_add_`` (the reference's XLA scatter-add).
* "bcsr"    — the block-CSR SpMM over the tiles preprocessing emitted:
              the hand-written CUDA kernel for CUDA tensors, the plain
              streaming version for CPU tensors.
* "dense"   — the (N, N) batch adjacency by index-put, then a matmul.

Selection: ``repro_torch.models.gnn.policy.BackendPolicy``.
``REPRO_GNN_BACKEND`` is the same deprecated alias as in the reference.
"""
from __future__ import annotations

import os
import warnings

import torch

BACKENDS = ("segment", "bcsr", "dense")

_env_warned = False


def _env_backend() -> str:
    """Deprecated ``REPRO_GNN_BACKEND`` alias — warns ONCE per process and
    keeps the old force-this-backend semantics (it maps onto
    ``BackendPolicy.fixed``, so it also overrides auto dispatch)."""
    global _env_warned
    name = os.environ.get("REPRO_GNN_BACKEND", "")
    if name and not _env_warned:
        warnings.warn(
            "REPRO_GNN_BACKEND is deprecated: pass "
            "backend=BackendPolicy.fixed(...) (or a backend name) to the "
            "engine instead (DESIGN.md §14)",
            DeprecationWarning, stacklevel=3)
        _env_warned = True
    return name


def resolve_backend(backend: str, allow_auto: bool = False) -> str:
    """Config value, overridable by the deprecated REPRO_GNN_BACKEND alias.
    ``allow_auto=True`` passes ``"auto"`` through for callers that resolve
    it per batch (``validate_batch_for_backend``)."""
    b = _env_backend() or backend or "segment"
    if allow_auto and b == "auto":
        return b
    if b not in BACKENDS:
        raise ValueError(f"unknown aggregation backend {b!r}; want one of {BACKENDS}")
    return b


def _require_tiles(batch) -> None:
    if "tile_cols" not in batch or "tile_vals" not in batch:
        raise ValueError(
            "backend='bcsr' needs tile_cols/tile_vals in the batch — build "
            "batches with bcsr_block set (IBMBConfig(backend='bcsr') or "
            "build_batches(bcsr_block=128)), or use backend='segment'")


def validate_batch_for_backend(batch, backend: str, kind: str = "gcn") -> str:
    """Fail fast if `batch` lacks what `backend` needs; return the resolved
    backend name. ``backend="auto"`` resolves by tile presence: tiles ⇒
    bcsr, else segment (GAT always segment)."""
    b = resolve_backend(backend, allow_auto=True)
    if b == "auto":
        has_tiles = "tile_cols" in batch and "tile_vals" in batch
        b = "bcsr" if (has_tiles and kind != "gat") else "segment"
    if b == "bcsr" and kind != "gat":
        _require_tiles(batch)
    return b


def _spmm_tiles(tile_cols: torch.Tensor, tile_vals: torch.Tensor,
                x: torch.Tensor, block_f: int = 0) -> torch.Tensor:
    """A @ x through the symmetric-adjacency SpMM (DESIGN.md §7/§14).

    The impl follows the tensor's device: the CUDA kernel for a CUDA
    tensor, the plain streaming version for a CPU tensor. ``block_f`` is
    resolved exactly as the reference resolves it and stays in the
    decision key; the kernel treats it as a hint and picks its own tiling.
    """
    from repro_torch.kernels.spmm.ops import spmm_bcsr_sym
    r, _, b, _ = tile_vals.shape
    if r * b != x.shape[0]:
        raise ValueError(f"bcsr tiles cover {r * b} rows but h has "
                         f"{x.shape[0]}")
    f = x.shape[1]
    if block_f and f % block_f == 0:
        bf = int(block_f)
    else:
        bf = 128 if f % 128 == 0 else f
    return spmm_bcsr_sym(tile_cols, tile_vals, x.contiguous(), None, bf)


def weighted_agg(h: torch.Tensor, edge_src: torch.Tensor,
                 edge_dst: torch.Tensor,
                 edge_weight: torch.Tensor) -> torch.Tensor:
    """out[u] = Σ_{(u,v)∈E} w_uv · h[v]   (rows = edge_src, gathers edge_dst).

    h: (N, F); edges are local indices; padded edges have weight 0. On CUDA
    ``index_add_`` sums with atomics, so the order of the sum varies from
    run to run.
    """
    msgs = h[edge_dst.long()] * edge_weight[:, None].to(h.dtype)
    return torch.zeros_like(h).index_add_(0, edge_src.long(), msgs)


def _dense_adj(n: int, edge_src: torch.Tensor, edge_dst: torch.Tensor,
               values: torch.Tensor, dtype) -> torch.Tensor:
    a = torch.zeros((n, n), dtype=dtype, device=values.device)
    return a.index_put_((edge_src.long(), edge_dst.long()),
                        values.to(dtype), accumulate=True)


def weighted_agg_backend(h: torch.Tensor, batch, backend: str = "segment",
                         block_f: int = 0) -> torch.Tensor:
    """``out[u] = Σ w_uv h[v]`` on the selected backend (DESIGN.md §7)."""
    if backend == "bcsr":
        _require_tiles(batch)
        return _spmm_tiles(batch["tile_cols"], batch["tile_vals"], h,
                           block_f=block_f)
    if backend == "dense":
        a = _dense_adj(h.shape[0], batch["edge_src"], batch["edge_dst"],
                       batch["edge_weight"], h.dtype)
        return a @ h
    return weighted_agg(h, batch["edge_src"], batch["edge_dst"],
                        batch["edge_weight"])


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability ``1 - rate`` and
    scale the kept ones by ``1 / (1 - rate)``. ``generator`` lies on
    ``x``'s device and takes the place of the reference's JAX key; the two
    draw different bits from the same seed, so masks are compared by their
    statistics, never entry by entry."""
    if deterministic or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
