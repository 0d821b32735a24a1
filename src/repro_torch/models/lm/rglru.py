"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427); the port of
``repro.models.lm.rglru``.

Block: x → [W_main → conv1d(w=4, causal, depthwise) → RG-LRU] ⊙ gelu(W_gate)
→ W_out, all in f32. The RG-LRU diagonal recurrence

    r_t = σ(W_a x_t + b_a)            (recurrence gate)
    i_t = σ(W_i x_t + b_i)            (input gate)
    log a_t = −c · softplus(Λ) ⊙ r_t  (c = 8)
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

is elementwise. Where the reference runs ``jax.lax.associative_scan`` over
time, the port runs a Hillis–Steele scan: log₂ S doubling steps of tensor
ops (12 at S = 4096), each combining every position with the one 2^j
before it. Decode is one elementwise step on an O(B·width) state, written
in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.lm.common import f32_leaves

_C = 8.0
_GATES = ("wa", "ba", "wi", "bi", "lam")


def rglru_params_shape(cfg):
    d, w = cfg.d_model, cfg.rnn_width or cfg.d_model
    return {
        "w_main": (d, w), "w_gate": (d, w), "w_out": (w, d),
        "conv_w": (cfg.conv_width, w), "conv_b": (w,),
        "wa": (w, w), "ba": (w,), "wi": (w, w), "bi": (w,),
        "lam": (w,),
    }


def _gates(p: Dict, x: torch.Tensor):
    r = torch.sigmoid(x @ p["wa"] + p["ba"])
    i = torch.sigmoid(x @ p["wi"] + p["bi"])
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-9)) * (i * x)
    return a, gated


def _causal_conv(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x: (B, S, W)."""
    w = p["conv_w"].shape[0]
    xp = F.pad(x, (0, 0, w - 1, 0))
    out = sum(xp[:, i:i + x.shape[1]] * p["conv_w"][i] for i in range(w))
    return out + p["conv_b"]


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + b_t over axis 1 from h_{-1} = 0, by
    Hillis–Steele doubling: after the step of span j each position holds
    the composition of the (up to 2j) steps that end at it."""
    s = a.shape[1]
    span = 1
    while span < s:
        b = torch.cat([b[:, :span], a[:, span:] * b[:, :-span] + b[:, span:]],
                      dim=1)
        a = torch.cat([a[:, :span], a[:, span:] * a[:, :-span]], dim=1)
        span *= 2
    return b


def rglru_forward(cfg, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence. x: (B, S, D) → (B, S, D)."""
    xf = x.float()
    main = xf @ p["w_main"].float()
    main = _causal_conv(f32_leaves(p, ("conv_w", "conv_b")), main)
    a, b = _gates(f32_leaves(p, _GATES), main)
    h = linear_scan(a, b)
    gate = F.gelu(xf @ p["w_gate"].float(), approximate="tanh")
    out = (h * gate) @ p["w_out"].float()
    return out.to(x.dtype)


def rglru_decode(cfg, p: Dict, x: torch.Tensor, cache: Dict, pos: int
                 ) -> Tuple[torch.Tensor, Dict]:
    """One step. x: (B, 1, D). cache: h (B, W), conv (B, conv_width-1, W),
    written in place."""
    xf = x[:, 0].float()
    main = xf @ p["w_main"].float()
    # causal conv with rolling state
    hist = torch.cat([cache["conv"], main[:, None]], dim=1)   # (B, cw, W)
    conv = (hist * p["conv_w"].float()).sum(1) + p["conv_b"]
    a, b = _gates(f32_leaves(p, _GATES), conv)
    h = a * cache["h"] + b
    gate = F.gelu(xf @ p["w_gate"].float(), approximate="tanh")
    out = ((h * gate) @ p["w_out"].float()).to(x.dtype)
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    return out[:, None], cache


def rglru_cache_shape(cfg, batch: int):
    w = cfg.rnn_width or cfg.d_model
    return {"h": (batch, w), "conv": (batch, cfg.conv_width - 1, w)}
