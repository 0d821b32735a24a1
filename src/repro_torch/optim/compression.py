"""Gradient compression for slow links: the port of
``repro.optim.compression``.

* top-k sparsification with error feedback (Stich et al.): transmit the k
  largest-magnitude entries, accumulate the residual locally so nothing is
  lost in expectation.
* int8 linear quantization (round half to even) for dense payloads.

Both work on flat f32 vectors. ``flatten_grads`` lays the leaves out in the
order ``jax.tree_util`` flattens the reference's trees (dict keys sorted,
list items in order), so a port gradient tree and the reference's give the
same vector.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import torch


class TopKPayload(NamedTuple):
    indices: torch.Tensor   # (k,) int32
    values: torch.Tensor    # (k,) in the input's dtype
    size: int


def topk_compress(flat: torch.Tensor, k: int) -> TopKPayload:
    """The k entries of largest magnitude, in ``lax.top_k``'s order:
    magnitudes descending, equal magnitudes by ascending index (so which
    of several tied entries make the cut is fixed too). ``torch.topk``
    finds the k-th magnitude; the entries above it and the first of those
    equal to it, by index, fill the k slots."""
    k = min(k, flat.shape[0])
    mag = flat.abs()
    kth = torch.topk(mag, k, sorted=True).values[-1]
    above = torch.nonzero(mag > kth)[:, 0]
    tied = torch.nonzero(mag == kth)[:k - above.numel(), 0]
    idx = torch.sort(torch.cat([above, tied])).values
    order = torch.sort(mag[idx], descending=True, stable=True).indices
    idx = idx[order]
    return TopKPayload(idx.to(torch.int32), flat[idx], flat.shape[0])


def topk_decompress(payload: TopKPayload) -> torch.Tensor:
    out = torch.zeros((payload.size,), dtype=payload.values.dtype,
                      device=payload.values.device)
    out[payload.indices.long()] = payload.values
    return out


class ErrorFeedback:
    """e_{t+1} = (g + e_t) − decompress(compress(g + e_t)); the transmitted
    payload is compress(g + e_t)."""

    def __init__(self, k_frac: float = 0.01):
        self.k_frac = k_frac
        self._residual = None

    def compress(self, flat: torch.Tensor
                 ) -> Tuple[TopKPayload, torch.Tensor]:
        if self._residual is None:
            self._residual = torch.zeros_like(flat)
        corrected = flat + self._residual
        k = max(1, int(self.k_frac * flat.shape[0]))
        payload = topk_compress(corrected, k)
        sent = topk_decompress(payload)
        self._residual = corrected - sent
        return payload, sent


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization, rounding half to even.
    Returns (q, scale)."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _leaves_sorted(tree: Any, out: List[torch.Tensor]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves_sorted(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _leaves_sorted(t, out)
    else:
        out.append(tree)


def flatten_grads(grads: Any) -> Tuple[torch.Tensor, Any]:
    """One f32 vector of every leaf, in ``jax.tree_util``'s leaf order, and
    the spec ``unflatten_grads`` rebuilds the tree from."""
    leaves: List[torch.Tensor] = []
    _leaves_sorted(grads, leaves)
    flat = torch.cat([t.reshape(-1).float() for t in leaves])
    return flat, (_skeleton(grads), [tuple(t.shape) for t in leaves])


def _skeleton(tree: Any) -> Any:
    """``tree``'s dicts and lists with None for every leaf (the spec keeps
    no gradient alive)."""
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_skeleton(t) for t in tree)
    return None


def _rebuild(tree: Any, it) -> Any:
    """Fill the skeleton's leaves from ``it`` in sorted-key order, keeping
    the skeleton's own key order."""
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    return next(it)


def unflatten_grads(flat: torch.Tensor, spec: Any) -> Any:
    """The tree of ``spec`` with its leaves cut from ``flat`` (f32, in the
    order ``flatten_grads`` wrote them)."""
    template, shapes = spec
    out, off = [], 0
    for s in shapes:
        n = 1
        for d in s:
            n *= d
        out.append(flat[off:off + n].reshape(s))
        off += n
    return _rebuild(template, iter(out))
