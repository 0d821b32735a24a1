"""Message passing on padded COO edge lists + aggregation-backend dispatch.

The port of ``repro.models.gnn.ops``. Batches are dicts of tensors
(``repro_torch.device.stage``); padded edges carry weight 0 and point at
node 0, so weighted sums are exact without branching.

Aggregation runs on one of three backends (DESIGN.md §7):

* "segment" — gather + ``index_add_`` (the reference's XLA scatter-add).
* "bcsr"    — the block-CSR SpMM over the tiles preprocessing emitted:
              the hand-written CUDA kernel for CUDA tensors, the plain
              streaming version for CPU tensors. GraphSAGE's mean runs
              the kernel's pattern mode, which counts each nonzero entry
              as 1, and divides by the degree the tiles give.
* "dense"   — the (N, N) batch adjacency by index-put, then a matmul.

GAT recomputes its edge weights by attention every step, so it has no
precomputable tiles and always runs the segment path (``segment_softmax``).

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
                x: torch.Tensor, block_f: int = 0,
                pattern: bool = False) -> torch.Tensor:
    """A @ x (``(A != 0) @ x`` with ``pattern``) through the
    symmetric-adjacency SpMM (DESIGN.md §7/§14).

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
    return spmm_bcsr_sym(tile_cols, tile_vals, x.contiguous(), None, bf,
                         pattern)


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


def mean_agg(h: torch.Tensor, edge_src: torch.Tensor,
             edge_dst: torch.Tensor, edge_mask: torch.Tensor) -> torch.Tensor:
    """Mean aggregation (GraphSAGE): masked mean over real edges. Rows are
    gathered with ``index_select`` (see ``segment_softmax``)."""
    w = edge_mask.to(h.dtype)
    src = edge_src.long()
    msgs = h.index_select(0, edge_dst.long()) * w[:, None]
    s = torch.zeros_like(h).index_add_(0, src, msgs)
    cnt = torch.zeros(h.shape[0], dtype=h.dtype,
                      device=h.device).index_add_(0, src, w)
    return s / torch.clamp(cnt, min=1.0)[:, None]


def bcsr_degree(tile_vals: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(R·B,) nonzero entries per row of the tiles, the real in-batch degree
    (a NaN value counts): the reference's ``bin_tiles.sum(axis=(1, 3))``.
    One reduction of the tiles, computed once per forward."""
    return torch.count_nonzero(tile_vals, dim=(1, 3)).reshape(-1).to(dtype)


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


def mean_agg_backend(h: torch.Tensor, batch, backend: str = "segment",
                     block_f: int = 0) -> torch.Tensor:
    """Masked neighbour mean on the selected backend (DESIGN.md §7).

    bcsr/dense recover the binary adjacency from nonzero weights: the batch
    graph is GCN-normalized, so every real edge has a strictly positive
    weight and ``w != 0`` equals the edge mask. Under bcsr the neighbour
    sum is the SpMM's pattern mode and the degree is ``bcsr_degree``, taken
    from ``batch["bcsr_degree"]`` when the forward put it there.
    """
    if backend == "bcsr":
        _require_tiles(batch)
        s = _spmm_tiles(batch["tile_cols"], batch["tile_vals"], h,
                        block_f=block_f, pattern=True)
        cnt = batch.get("bcsr_degree")
        if cnt is None:
            cnt = bcsr_degree(batch["tile_vals"], h.dtype)
        return s / torch.clamp(cnt, min=1.0)[:, None]
    if backend == "dense":
        a = _dense_adj(h.shape[0], batch["edge_src"], batch["edge_dst"],
                       batch["edge_weight"] != 0, h.dtype)
        return (a @ h) / torch.clamp(a.sum(dim=1), min=1.0)[:, None]
    return mean_agg(h, batch["edge_src"], batch["edge_dst"],
                    batch["edge_mask"])


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask: torch.Tensor) -> torch.Tensor:
    """Numerically-stable softmax over edges grouped by destination segment.

    logits: (E, H); mask: (E,) 1.0 for real edges. Masked edges take -1e9
    before the segment max (``scatter_reduce`` amax over the segment's own
    edges only) and weight 0 after the ``exp``.

    Per-edge rows are gathered with ``index_select``, whose backward is an
    ``index_add_``: the backward of ``x[ids]`` sorts the ids and sums each
    run of equal ids serially, and every padded edge points at node 0, so
    on an H100 that took 85% of a GAT train step's device time.
    """
    m = mask[:, None] > 0
    logits = torch.where(m, logits, torch.full_like(logits, -1e9))
    ids = segment_ids.long()
    idx = ids[:, None].expand_as(logits)
    seg_max = torch.zeros((num_segments, logits.shape[1]), dtype=logits.dtype,
                          device=logits.device).scatter_reduce(
        0, idx, logits, "amax", include_self=False)
    ex = torch.exp(logits - seg_max.index_select(0, ids)) * \
        mask[:, None].to(logits.dtype)
    denom = torch.zeros_like(seg_max).index_add_(0, ids, ex)
    return ex / torch.clamp(denom.index_select(0, ids), min=1e-16)


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
