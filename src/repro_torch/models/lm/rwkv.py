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

from repro_torch.dist import annotate, gathered, grad_gathered, \
    grad_splittable, is_dtensor, on_grad, per_rank, splittable
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
    # the mesh's "model" axis shards 5·lo columns it may not split into 5
    lora = splittable(lora, -1, len(_MIX))
    lora = lora.reshape(*lora.shape[:-1], len(_MIX), lo)
    delta = torch.einsum("bsml,mld->bsmd", lora, p["lora_b"])  # (B,S,5,D)
    mixed = x[..., None, :] + xx[..., None, :] * (p["mu"] + delta)
    return {m: mixed[..., i, :] for i, m in enumerate(_MIX)}


def _decay(p: Dict, xw: torch.Tensor) -> torch.Tensor:
    """log w_t ∈ [−5, 0): w = exp(−exp(w_base + lora_w(x))), the upper clip
    bounding the per-step log-decay at −5."""
    lw = p["w_base"] + grad_gathered(torch.tanh(xw @ p["wa_w"]) @ p["wb_w"],
                                     1)
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


def _wkv(rh, kh, vh, wh, u, st, c: int, factored: bool):
    """The chunk loop over r/k/v/log w (B, H, S, hd) from state ``st``
    (B, H, hd, hd; zeros if None): (out (B, H, S, hd), final state)."""
    b, h, s, hd = rh.shape
    if st is None:
        st = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=rh.device)
    outs = []
    for c0 in range(0, s, c):
        sl = slice(c0, c0 + c)
        o, st = _wkv_chunk(rh[:, :, sl], kh[:, :, sl], vh[:, :, sl],
                           wh[:, :, sl], u, st, factored=factored)
        outs.append(o)
    return torch.cat(outs, dim=2), st


def _wkv_parallel(rh, kh, vh, wh, u, st, c: int, factored: bool):
    """``_wkv`` with every chunk's own terms computed at once over a
    (chunks, C) split of the sequence; only the state carry runs chunk by
    chunk, a product and a sum each. The same function as ``_wkv`` up to
    f32 rounding; a step that counts its ops (the dry run) takes a few ops
    a chunk instead of some hundred."""
    b, h, s, hd = rh.shape
    n = s // c
    r, k, v, logw = (t.reshape(b, h, n, c, hd) for t in (rh, kh, vh, wh))
    L = torch.cumsum(logw, dim=3)                           # (B,H,n,C,dk)
    L_prev = L - logw
    r_dec = r * torch.exp(L_prev)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    if factored:
        A = torch.einsum("bhnid,bhnjd->bhnij", r_dec, k * torch.exp(-L))
        A = torch.where(mask, A, 0.0)
    else:
        expo = L_prev[..., :, None, :] - L[..., None, :, :]  # (..,i,j,dk)
        expo = torch.where(mask[..., None], expo, -1e30)
        A = torch.einsum("bhnid,bhnjd,bhnijd->bhnij", r, k, torch.exp(expo))
    diag = torch.einsum("bhncd,bhncd->bhnc", r, k * u[None, :, None, None])
    intra = torch.einsum("bhnij,bhnje->bhnie", A, v) + diag[..., None] * v
    Lc = L[..., -1, :]                                      # (B,H,n,dk)
    k_dec = k * torch.exp(Lc[..., None, :] - L)
    kv = torch.einsum("bhnjd,bhnje->bhnde", k_dec, v)       # (B,H,n,dk,dv)
    decay = torch.exp(Lc)[..., None]
    if st is None:
        st = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=rh.device)
    before = []                 # the state entering each chunk
    for i in range(n):
        before.append(st)
        st = decay[:, :, i] * st + kv[:, :, i]
    out_state = torch.einsum("bhncd,bhnde->bhnce", r_dec,
                             torch.stack(before, dim=2))
    return (out_state + intra).reshape(b, h, s, hd), st


def _wkv_on_mesh(cfg, rh, kh, vh, wh, u, st, c: int, factored: bool):
    """``_wkv`` of DTensors, per rank (``per_rank``): the batch on the data
    axes and the heads on "model" where it divides them (else whole), each
    rank running the chunks (``_wkv_parallel``) of its own (batch, heads),
    which no step of the recurrence mixes."""
    def local(rl, kl, vl, wl, ul, *stl):
        # the transposed inputs' local gradients, made contiguous for the
        # reshapes DTensor applies to them on the way back
        rl, kl, vl, wl = (on_grad(t, torch.Tensor.contiguous)
                          for t in (rl, kl, vl, wl))
        return _wkv_parallel(rl, kl, vl, wl, ul, stl[0] if stl else None, c,
                             factored)
    heads = ("batch", "heads", None, None)
    args = (rh, kh, vh, wh, u) + (() if st is None else (st,))
    axes = (heads,) * 4 + (("heads", None),) + \
        (() if st is None else (heads,))
    return per_rank(cfg, local, args, axes, (heads, heads))


def rwkv_time_mix(cfg, p: Dict, x: torch.Tensor, chunk: int = 64,
                  factored: bool = False, state: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence time mix. x: (B, S, D). Returns (out, final state
    {"wkv", "shift_t"}). ``factored`` applies only to chunks of at most 16,
    as in the reference (longer ones run the pairwise math)."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    # not in the reference: the sequence gathered before the token shift
    # and the column-parallel matmuls, which flatten (B, S) (XLA reshards
    # by itself; DTensor cannot flatten a sequence-sharded x)
    x = annotate(x, "batch", None, "embed")
    xf = x.float()
    last = None if state is None else state["shift_t"]
    xx = _token_shift(xf, last) - xf
    mixed = _ddlerp(f32_leaves(p, ("mu", "mu_base", "lora_a", "lora_b")),
                    xf, xx)

    def heads(t):               # (B, S, D) → (B, S, H, hd)
        return splittable(t, -1, h).reshape(b, s, h, hd)
    r = heads(mixed["r"] @ p["wr"].float())
    k = heads(mixed["k"] @ p["wk"].float())
    v = heads(mixed["v"] @ p["wv"].float())
    g = F.silu(mixed["g"] @ p["wg"].float())
    logw = heads(_decay(f32_leaves(p, ("w_base", "wa_w", "wb_w")),
                        mixed["w"]))

    c = pick_chunk(s, chunk)
    factored = factored and c <= 16
    rh, kh, vh, wh = (t.transpose(1, 2) for t in (r, k, v, logw))  # B,H,S,hd
    st = None if state is None else state["wkv"]
    args = (rh, kh, vh, wh, p["u"].float(), st, c, factored)
    out, st = _wkv_on_mesh(cfg, *args) if is_dtensor(rh) else _wkv(*args)
    out = out.transpose(1, 2)                                # (B,S,H,hd)
    # per-head group norm, then gate and project
    mu = out.mean(-1, keepdim=True)
    var = (out - mu).square().mean(-1, keepdim=True)
    # the merged heads' gradient split again where the mesh does not
    # divide the heads (a DTensor)
    out = grad_splittable(
        ((out - mu) * torch.rsqrt(var + 64e-5)).reshape(b, s, d), 2, h)
    out = out * p["ln_x_scale"].float() + p["ln_x_bias"].float()
    out = grad_gathered(gathered(out * g, 1) @ p["wo"].float(), 1)
    return out.to(x.dtype), {"wkv": st, "shift_t": xf[:, -1]}


def rwkv_channel_mix(cfg, p: Dict, x: torch.Tensor,
                     state: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = annotate(x, "batch", None, "embed")     # as in rwkv_time_mix
    xf = x.float()
    xx = _token_shift(xf, state) - xf
    xk = xf + xx * p["cmix_mu_k"].float()
    xr = xf + xx * p["cmix_mu_r"].float()
    k = torch.square(torch.relu(xk @ p["ck"].float()))
    r = torch.sigmoid(xr @ p["cr"].float())
    out = grad_gathered(r * (k @ p["cv"].float()), 1)
    return out.to(x.dtype), xf[:, -1]


def rwkv_cache_shape(cfg, batch: int):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    return {"wkv": (batch, h, hd, hd), "shift_t": (batch, d),
            "shift_c": (batch, d)}
