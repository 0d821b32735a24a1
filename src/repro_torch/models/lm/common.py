"""Shared LM building blocks: norms, rope, init helpers, activation.

The port of ``repro.models.lm.common``, with the reference's cast order: a
norm is computed in f32, cast to ``x.dtype`` and then multiplied by a scale
in the model's dtype; rope is computed in f32 and cast back.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    # dims counted from the front here and below: DTensor (torch 2.11)
    # keeps a negative dim unnormalized in some placements and refuses it
    var = x32.square().mean(dim=x.ndim - 1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=x.ndim - 1, keepdim=True)
    var = (x32 - mu).square().mean(dim=x.ndim - 1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def apply_norm(cfg, x: torch.Tensor, p: dict) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"], cfg.norm_eps)
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def f32_leaves(p: dict, names) -> dict:
    """The named leaves of a parameter dict upcast to f32 (the reference's
    recurrent blocks compute in f32 whatever the model's dtype)."""
    return {k: p[k].float() for k in names}


def activation(cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (S,) or (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (D/2,)
    angles = positions[..., None].float() * freqs            # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=x.ndim - 1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                    dim=x.ndim - 1)
    return out.to(x.dtype)


def sinusoidal_embed(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """(S,) → (S, D) classic transformer sinusoidal position embedding."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[:, None].float() * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def dense_init(generator: torch.Generator, shape, dtype: torch.dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, std) drawn in f32 on the generator's device, cast to
    ``dtype``. std is ``scale``, else ``shape[0] ** -0.5`` — the leading
    axis, which for stacked layer weights is the ``repeat`` axis, as in
    the reference."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else fan_in ** -0.5
    return (torch.randn(tuple(shape), generator=generator,
                        dtype=torch.float32, device=generator.device)
            * std).to(dtype)
