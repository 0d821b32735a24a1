"""RWKV6 "Finch" (arXiv:2404.05892): attention-free time mix with
data-dependent per-channel decay + squared-ReLU channel mix; the port of
``repro.models.lm.rwkv``.

Recurrence per head (k-dim dk, v-dim dv, state S ∈ R^{dk×dv}):

    o_t = Sᵀ r_t + (r_t · (u ⊙ k_t)) v_t
    S   ← diag(w_t) S + k_t v_tᵀ

computed as chunked linear attention: within a chunk of length C the
contribution is a (C×C) masked "attention" with decay weights, and the
state is carried from chunk to chunk (here by a Python loop over the
chunks). Decay products are exp(L_i − L_j) with L = cumsum(log w) ≤ 0 and
i ≥ j, so every factor is ≤ 1. All in f32.

The reference picks its chunk and variants from the environment
(``REPRO_RWKV_CHUNK``, ``REPRO_RWKV_FACTORED``, ``REPRO_RWKV_MACRO``,
``REPRO_RWKV_REMAT``); the port reads none. ``rwkv_time_mix`` takes
``chunk`` and ``factored`` as keyword arguments with the reference's
defaults (64, off); its macro-chunks group the same sequential chunks and
do not change the result, and remat concerns the backward pass only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ref import pick_chunk
from repro_torch.models.lm.common import f32_leaves

_MIX = ("r", "k", "v", "w", "g")


def rwkv_params_shape(cfg):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    lo = cfg.rwkv_lora_dim
    return {
        # time-mix
        "mu": (len(_MIX), d), "mu_base": (d,),
        "lora_a": (d, len(_MIX) * lo), "lora_b": (len(_MIX), lo, d),
        "w_base": (d,), "wa_w": (d, lo), "wb_w": (lo, d),
        "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d), "wo": (d, d),
        "u": (h, hd),
        "ln_x_scale": (d,), "ln_x_bias": (d,),
        # channel-mix
        "cmix_mu_k": (d,), "cmix_mu_r": (d,),
        "ck": (d, cfg.d_ff), "cv": (cfg.d_ff, d), "cr": (d, d),
    }


def _token_shift(x: torch.Tensor,
                 last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1} (zero/state-filled at t=0). x: (B, S, D)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p: Dict, x: torch.Tensor, xx: torch.Tensor) -> Dict:
    """Data-dependent mixing for r/k/v/w/g (RWKV6 'ddlerp')."""
    lo = p["lora_b"].shape[1]
    base = x + xx * p["mu_base"]
    lora = torch.tanh(base @ p["lora_a"])                   # (B,S,5*lo)
    lora = lora.reshape(*lora.shape[:-1], len(_MIX), lo)
    delta = torch.einsum("bsml,mld->bsmd", lora, p["lora_b"])  # (B,S,5,D)
    mixed = x[..., None, :] + xx[..., None, :] * (p["mu"] + delta)
    return {m: mixed[..., i, :] for i, m in enumerate(_MIX)}


def _decay(p: Dict, xw: torch.Tensor) -> torch.Tensor:
    """log w_t ∈ [−5, 0): w = exp(−exp(w_base + lora_w(x))), the upper clip
    bounding the per-step log-decay at −5."""
    lw = p["w_base"] + torch.tanh(xw @ p["wa_w"]) @ p["wb_w"]
    return -torch.exp(torch.clamp(lw, -10.0, 1.609))


def _wkv_chunk(r, k, v, logw, u, state, factored: bool = False):
    """One chunk. r/k: (B,H,C,dk), v: (B,H,C,dv), logw: (B,H,C,dk),
    state: (B,H,dk,dv). Returns (out (B,H,C,dv), new_state).

    factored=True: A = (r·e^{L_prev}) @ (k·e^{−L})ᵀ, a plain C×C product
    instead of the (C,C,dk) pairwise-exp tensor; the same value, finite
    only while e^{−L} is (chunks ≤ 16 under the decay clip)."""
    c = r.shape[2]
    L = torch.cumsum(logw, dim=2)                           # (B,H,C,dk)
    L_prev = L - logw                                       # exclusive
    # state contribution: o_i += Sᵀ (e^{L_prev_i} ⊙ r_i)
    r_dec = r * torch.exp(L_prev)
    out_state = torch.einsum("bhcd,bhde->bhce", r_dec, state)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    if factored:
        A = torch.einsum("bhid,bhjd->bhij", r_dec, k * torch.exp(-L))
        A = torch.where(mask, A, 0.0)
    else:
        # intra-chunk: A_ij = Σ_c r_ic k_jc e^{L_prev_i,c − L_j,c} (j < i)
        expo = L_prev[:, :, :, None, :] - L[:, :, None, :, :]  # (B,H,i,j,dk)
        expo = torch.where(mask[:, :, None], expo, -1e30)
        A = torch.einsum("bhid,bhjd,bhijd->bhij", r, k, torch.exp(expo))
    # diagonal bonus term: (r_i · (u ⊙ k_i)) v_i
    diag = torch.einsum("bhcd,bhcd->bhc", r, k * u[None, :, None, :])
    out = out_state + torch.einsum("bhij,bhje->bhie", A, v) + \
        diag[..., None] * v
    # state update: S' = e^{L_C} ⊙ S + Σ_j (e^{L_C − L_j} ⊙ k_j) v_jᵀ
    Lc = L[:, :, -1]                                        # (B,H,dk)
    k_dec = k * torch.exp(Lc[:, :, None, :] - L)
    new_state = torch.exp(Lc)[..., None] * state + \
        torch.einsum("bhjd,bhje->bhde", k_dec, v)
    return out, new_state


def rwkv_time_mix(cfg, p: Dict, x: torch.Tensor, chunk: int = 64,
                  factored: bool = False, state: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence time mix. x: (B, S, D). Returns (out, final state
    {"wkv", "shift_t"}). ``factored`` applies only to chunks of at most 16,
    as in the reference (longer ones run the pairwise math)."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    xf = x.float()
    last = None if state is None else state["shift_t"]
    xx = _token_shift(xf, last) - xf
    mixed = _ddlerp(f32_leaves(p, ("mu", "mu_base", "lora_a", "lora_b")),
                    xf, xx)
    r = (mixed["r"] @ p["wr"].float()).reshape(b, s, h, hd)
    k = (mixed["k"] @ p["wk"].float()).reshape(b, s, h, hd)
    v = (mixed["v"] @ p["wv"].float()).reshape(b, s, h, hd)
    g = F.silu(mixed["g"] @ p["wg"].float())
    logw = _decay(f32_leaves(p, ("w_base", "wa_w", "wb_w")),
                  mixed["w"]).reshape(b, s, h, hd)

    c = pick_chunk(s, chunk)
    factored = factored and c <= 16
    rh, kh, vh, wh = (t.transpose(1, 2) for t in (r, k, v, logw))  # B,H,S,hd
    st = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device) \
        if state is None else state["wkv"]
    u = p["u"].float()
    outs = []
    for c0 in range(0, s, c):
        sl = slice(c0, c0 + c)
        o, st = _wkv_chunk(rh[:, :, sl], kh[:, :, sl], vh[:, :, sl],
                           wh[:, :, sl], u, st, factored=factored)
        outs.append(o)
    out = torch.cat(outs, dim=2).transpose(1, 2)             # (B,S,H,hd)
    # per-head group norm, then gate and project
    mu = out.mean(-1, keepdim=True)
    var = (out - mu).square().mean(-1, keepdim=True)
    out = ((out - mu) * torch.rsqrt(var + 64e-5)).reshape(b, s, d)
    out = out * p["ln_x_scale"].float() + p["ln_x_bias"].float()
    out = (out * g) @ p["wo"].float()
    return out.to(x.dtype), {"wkv": st, "shift_t": xf[:, -1]}


def rwkv_channel_mix(cfg, p: Dict, x: torch.Tensor,
                     state: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    xx = _token_shift(xf, state) - xf
    xk = xf + xx * p["cmix_mu_k"].float()
    xr = xf + xx * p["cmix_mu_r"].float()
    k = torch.square(torch.relu(xk @ p["ck"].float()))
    r = torch.sigmoid(xr @ p["cr"].float())
    out = r * (k @ p["cv"].float())
    return out.to(x.dtype), xf[:, -1]


def rwkv_cache_shape(cfg, batch: int):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    return {"wkv": (batch, h, hd, hd), "shift_t": (batch, d),
            "shift_c": (batch, d)}
