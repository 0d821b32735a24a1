"""Transformer layer assembly: (mixer, ffn) per LayerSpec, pre-norm residual.

The port of ``repro.models.lm.blocks``, dispatching on ``(mixer, ffn)`` as
the reference does. Provides three things per layer spec:
  * param SHAPE tree (pure dict of tuples — materialized by model.init)
  * full-sequence apply (prefill)
  * single-token decode apply, writing the cache in place
The ``rwkv_cmix`` FFN keeps its parameters in the rwkv6 mixer's dict and
has an empty ``ffn`` dict, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import moe as moe_mod
from repro_torch.models.lm import rglru as rglru_mod
from repro_torch.models.lm import rwkv as rwkv_mod
from repro_torch.models.lm.common import activation, apply_norm
from repro_torch.models.lm.config import LayerSpec


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
    shapes: Dict = {"norm1": _norm_shape(cfg)}
    if spec.mixer in ("gqa", "local"):
        shapes["mixer"] = attn.gqa_params_shape(cfg)
    elif spec.mixer == "mla":
        shapes["mixer"] = attn.mla_params_shape(cfg)
    elif spec.mixer == "rglru":
        shapes["mixer"] = rglru_mod.rglru_params_shape(cfg)
    elif spec.mixer == "rwkv6":
        shapes["mixer"] = rwkv_mod.rwkv_params_shape(cfg)
    else:
        raise ValueError(spec.mixer)
    shapes["norm2"] = _norm_shape(cfg)
    if spec.ffn == "dense":
        shapes["ffn"] = ffn_params_shape(cfg)
    elif spec.ffn == "moe":
        shapes["ffn"] = moe_mod.moe_params_shape(cfg)
    elif spec.ffn == "rwkv_cmix":
        shapes["ffn"] = {}      # channel-mix params live in the rwkv mixer
    else:
        raise ValueError(spec.ffn)
    return shapes


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
    h = apply_norm(cfg, x, p["norm1"])
    if spec.mixer == "gqa":
        mix = attn.gqa_forward(cfg, p["mixer"], h, positions)
    elif spec.mixer == "local":
        mix = attn.gqa_forward(cfg, p["mixer"], h, positions,
                               window=cfg.window)
    elif spec.mixer == "mla":
        mix = attn.mla_forward(cfg, p["mixer"], h, positions)
    elif spec.mixer == "rglru":
        mix = rglru_mod.rglru_forward(cfg, p["mixer"], h)
    elif spec.mixer == "rwkv6":
        mix, _ = rwkv_mod.rwkv_time_mix(cfg, p["mixer"], h)
    else:
        raise ValueError(spec.mixer)
    x = x + mix
    h = apply_norm(cfg, x, p["norm2"])
    if spec.ffn == "dense":
        x = x + ffn_forward(cfg, p["ffn"], h)
    elif spec.ffn == "moe":
        x = x + moe_mod.moe_forward(cfg, p["ffn"], h)
    elif spec.ffn == "rwkv_cmix":
        out, _ = rwkv_mod.rwkv_channel_mix(cfg, p["mixer"], h)
        x = x + out
    else:
        raise ValueError(spec.ffn)
    return x


def layer_cache_shape(cfg, spec: LayerSpec, batch: int, s_max: int) -> Dict:
    if spec.mixer == "gqa":
        return attn.gqa_cache_shape(cfg, batch, s_max)
    if spec.mixer == "local":
        return attn.gqa_cache_shape(cfg, batch, s_max, window=cfg.window)
    if spec.mixer == "mla":
        return attn.mla_cache_shape(cfg, batch, s_max)
    if spec.mixer == "rglru":
        return rglru_mod.rglru_cache_shape(cfg, batch)
    if spec.mixer == "rwkv6":
        return rwkv_mod.rwkv_cache_shape(cfg, batch)
    raise ValueError(spec.mixer)


def _cache_dtype(cfg, name: str) -> torch.dtype:
    # recurrent states stay fp32 (stability); kv caches use model dtype
    return torch.float32 if name in ("wkv", "shift_t", "shift_c", "h",
                                     "conv") else getattr(torch, cfg.dtype)


def layer_decode(cfg, spec: LayerSpec, p: Dict, x: torch.Tensor,
                 cache: Dict, pos: int) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode. x: (B, 1, D); ``cache`` is written in place."""
    h = apply_norm(cfg, x, p["norm1"])
    if spec.mixer == "gqa":
        mix, _ = attn.gqa_decode(cfg, p["mixer"], h, cache, pos)
    elif spec.mixer == "local":
        mix, _ = attn.gqa_decode(cfg, p["mixer"], h, cache, pos,
                                 window=cfg.window)
    elif spec.mixer == "mla":
        mix, _ = attn.mla_decode(cfg, p["mixer"], h, cache, pos)
    elif spec.mixer == "rglru":
        mix, _ = rglru_mod.rglru_decode(cfg, p["mixer"], h, cache, pos)
    elif spec.mixer == "rwkv6":
        # single-step time mix via the chunked path with C = 1
        mix, st = rwkv_mod.rwkv_time_mix(cfg, p["mixer"], h, chunk=1,
                                         state=cache)
        cache["wkv"].copy_(st["wkv"])
        cache["shift_t"].copy_(st["shift_t"])
    else:
        raise ValueError(spec.mixer)
    x = x + mix
    h = apply_norm(cfg, x, p["norm2"])
    if spec.ffn == "dense":
        x = x + ffn_forward(cfg, p["ffn"], h)
    elif spec.ffn == "moe":
        x = x + moe_mod.moe_forward(cfg, p["ffn"], h)
    elif spec.ffn == "rwkv_cmix":
        out, shift_c = rwkv_mod.rwkv_channel_mix(cfg, p["mixer"], h,
                                                 state=cache["shift_c"])
        cache["shift_c"].copy_(shift_c)
        x = x + out
    else:
        raise ValueError(spec.ffn)
    return x, cache
