"""Transformer layer assembly: (mixer, ffn) per LayerSpec, pre-norm residual.

The port of ``repro.models.lm.blocks`` for ``LayerSpec("gqa", "dense")``.
Provides three things per layer spec:
  * param SHAPE tree (pure dict of tuples — materialized by model.init)
  * full-sequence apply (prefill)
  * single-token decode apply, writing the cache in place
The ``local``, ``mla``, ``rglru`` and ``rwkv6`` mixers and the ``moe`` and
``rwkv_cmix`` FFNs raise ``NotImplementedError``: they come with later
slices (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.lm import attention as attn
from repro_torch.models.lm.common import activation, apply_norm
from repro_torch.models.lm.config import LayerSpec


def _require_ported(spec: LayerSpec) -> None:
    if spec.mixer != "gqa" or spec.ffn != "dense":
        raise NotImplementedError(
            f"layer {spec} is not ported yet: the port runs gqa mixers with "
            f"dense FFNs; the local/mla/rglru/rwkv6 mixers and moe/rwkv_cmix "
            f"FFNs come with later slices (ROADMAP Queue 1, item 12)")


# --------------------------------------------------------------- shape trees
def _norm_shape(cfg):
    if cfg.norm == "rmsnorm":
        return {"scale": (cfg.d_model,)}
    return {"scale": (cfg.d_model,), "bias": (cfg.d_model,)}


def ffn_params_shape(cfg):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.glu:
        return {"w_in": (d, f), "w_gate": (d, f), "w_out": (f, d)}
    return {"w_in": (d, f), "w_out": (f, d)}


def layer_param_shapes(cfg, spec: LayerSpec) -> Dict:
    _require_ported(spec)
    return {"norm1": _norm_shape(cfg), "mixer": attn.gqa_params_shape(cfg),
            "norm2": _norm_shape(cfg), "ffn": ffn_params_shape(cfg)}


# ------------------------------------------------------------------- applies
def ffn_forward(cfg, p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_in"]
    if cfg.glu:
        h = activation(cfg, x @ p["w_gate"]) * h
    else:
        h = activation(cfg, h)
    return h @ p["w_out"]


def layer_forward(cfg, spec: LayerSpec, p: Dict, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence layer. x: (B, S, D)."""
    _require_ported(spec)
    h = apply_norm(cfg, x, p["norm1"])
    x = x + attn.gqa_forward(cfg, p["mixer"], h, positions)
    h = apply_norm(cfg, x, p["norm2"])
    return x + ffn_forward(cfg, p["ffn"], h)


def layer_cache_shape(cfg, spec: LayerSpec, batch: int, s_max: int) -> Dict:
    _require_ported(spec)
    return attn.gqa_cache_shape(cfg, batch, s_max)


def _cache_dtype(cfg, name: str) -> torch.dtype:
    # recurrent states stay fp32 (stability); kv caches use model dtype
    return torch.float32 if name in ("wkv", "shift_t", "shift_c", "h",
                                     "conv") else getattr(torch, cfg.dtype)


def layer_decode(cfg, spec: LayerSpec, p: Dict, x: torch.Tensor,
                 cache: Dict, pos: int) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode. x: (B, 1, D); ``cache`` is written in place."""
    _require_ported(spec)
    h = apply_norm(cfg, x, p["norm1"])
    mix, cache_m = attn.gqa_decode(cfg, p["mixer"], h, cache, pos)
    x = x + mix
    h = apply_norm(cfg, x, p["norm2"])
    return x + ffn_forward(cfg, p["ffn"], h), cache_m
