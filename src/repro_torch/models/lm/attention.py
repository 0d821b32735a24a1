"""Attention mixers: GQA/MQA, sliding-window (local) and MLA (DeepSeek);
the port of ``repro.models.lm.attention``.

* Train/prefill attention: on a CUDA tensor ``gqa_forward`` launches the
  hand-written flash kernel (``kernels/csrc/flash_attention.cu``) once, with
  the window of a local layer; on the CPU it runs the plain online-softmax
  ``chunked_attention`` (global layers) or ``sliding_window_attention``
  (local layers), the reference's own algorithms. When autograd records
  on the card, the kernel runs inside ``FlashAttentionTrain``, whose
  backward differentiates the plain version on the saved inputs: the
  reference has no backward kernel either, and differentiates
  ``chunked_attention``.
* GQA uses the grouped formulation: query head h reads kv head h // G, and
  K/V are never expanded to H heads.
* A local layer's prefill applies no logit softcap and its decode does,
  as in the reference (``sliding_window_attention`` takes none): the two
  compute different functions when a config sets ``logit_softcap``
  (recurrentgemma-2b does). The port keeps the asymmetry (ROADMAP
  Queue 3).
* MLA stays plain tensor ops, as the reference computes it outside any
  Pallas kernel: its qk head dim (nope + rope, 192) differs from its v head
  dim (128), a shape the flash kernel does not take. Prefill is the
  reference's KV-chunked online softmax with K/V expanded from the
  compressed cache per chunk in f32; decode runs absorbed in the
  compressed space.
* Decode stays plain tensor ops, as the reference computes it outside any
  Pallas kernel. The cache is updated in place.
* Sharding: the reference's ``annotate`` calls stand at the same places
  (the identity outside a ``logical_rules`` context). Under a device mesh
  (DTensor inputs) attention runs inside ``local_map`` on each rank's
  local tensors, the flash kernel (which reads raw pointers) on the card
  and the plain version on the CPU: batch over the data axes, query heads
  and kv heads over "model" where it divides them. Where it
  divides the query heads but not the kv heads (llama3.2-1b's 8 kv heads
  on a model axis of 16), the kv heads stay whole and each rank's query
  heads read theirs, head h reading kv head h // (H / KV) of the global
  numbering. Where XLA would reshard a reshape or a gradient by itself,
  DTensor needs it asked for (``repro_torch.dist.splittable``,
  ``grad_splittable``, ``grad_gathered``, ``on_grad``): each is the
  identity on plain tensors.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.dist import (
    annotate, gathered, grad_gathered, grad_splittable, is_dtensor, on_grad,
    per_rank, splittable)
from repro_torch.kernels.flash_attention import chunked_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, pick_chunk
from repro_torch.models.lm.common import apply_rope, rms_norm


def _check_window_length(s: int, window: int) -> None:
    """The reference's rule for a local layer's sequence: S <= window, or a
    multiple of it (its neighbour-chunk pairing)."""
    if s > window and s % window != 0:
        raise ValueError(f"sliding-window attention takes S <= window or S "
                         f"a multiple of the window; got S={s}, window="
                         f"{window}")


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, window: int,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Causal sliding-window attention in O(S·2W): chunk size = W, each
    query chunk attends its (previous, own) chunks only. q (B, S, H, D),
    k/v (B, S, KV, D); no softcap, as in the reference."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    dv = v.shape[-1]
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    if s <= window:   # degenerate: plain causal
        return chunked_attention(q, k, v, causal=True, window=window,
                                 chunk_k=min(s, 1024), scale=scale)
    _check_window_length(s, window)
    w = window
    nc = s // w
    qg = q.reshape(b, nc, w, kv, g, d)
    kc = k.reshape(b, nc, w, kv, d)
    vc = v.reshape(b, nc, w, kv, dv)
    # previous chunk (zero-padded for the first)
    k_prev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    k2 = torch.cat([k_prev, kc], dim=2)                  # (B,nc,2W,KV,D)
    v2 = torch.cat([v_prev, vc], dim=2)
    s_ = torch.einsum("bnqkgd,bnckd->bnkgqc", qg.float(), k2.float()) * scale
    q_pos = torch.arange(w, device=q.device)[:, None]    # within-pair
    k_pos = torch.arange(2 * w, device=q.device)[None, :] - w
    mask = (k_pos <= q_pos) & (k_pos > q_pos - w)
    full_mask = mask.expand(nc, w, 2 * w).clone()
    full_mask[0] &= k_pos >= 0                           # no previous chunk
    s_ = torch.where(full_mask[None, :, None, None], s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bnkgqc,bnckd->bnqkgd", p, v2.float())
    return out.reshape(b, s, h, dv).to(q.dtype)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int, chunk_k: int = 1024,
                    softcap: float = 0.0) -> torch.Tensor:
    """A GQA or local layer's causal attention by the plain algorithms:
    ``sliding_window_attention`` (window > 0, no softcap) or
    ``chunked_attention``. q (B, S, H, D), k/v (B, S, KV, D)."""
    if window > 0:
        return sliding_window_attention(q, k, v, window)
    return chunked_attention(q, k, v, causal=True, chunk_k=chunk_k,
                             softcap=softcap)


class FlashAttentionTrain(torch.autograd.Function):
    """Causal attention for a train step on the card: the forward launches
    the flash kernel (f32 or bf16, with a local layer's window) and saves
    q, k and v; the backward recomputes ``plain_attention`` on them and
    returns its gradients, the reference's gradient. q (B, S, H, D), k/v
    (B, S, KV, D), read by the kernel as (B, heads, S, D) views."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, chunk_k: int):
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.chunk_k = window, chunk_k
        return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True, window=window,
                               impl="cuda").transpose(1, 2)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = plain_attention(q, k, v, ctx.window, ctx.chunk_k)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad_out)
        return dq, dk, dv, None, None


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           chunk_k: int) -> torch.Tensor:
    """One launch of the flash kernel on plain CUDA tensors q (B, S, H,
    hd), k/v (B, S, KV, hd): through ``FlashAttentionTrain`` when autograd
    records, else directly, (B, S, heads, hd) passed as (B, heads, S, hd)
    views (the kernel reads through strides and writes its output in q's
    layout)."""
    if torch.is_grad_enabled():
        return FlashAttentionTrain.apply(q, k, v, window, chunk_k)
    return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=True, window=window,
                           impl="cuda").transpose(1, 2)


def kv_for_heads(k: torch.Tensor, v: torch.Tensor, h0: int, hl: int,
                 g: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kv heads that query heads [h0, h0 + hl) read (head h reads kv
    head h // g), from k/v (B, S, KV, hd) holding every kv head: a slice
    when the local heads cover whole groups or lie in one, else one kv
    head per query head."""
    if hl % g == 0 and h0 % g == 0:
        a, n = h0 // g, hl // g
    elif g % hl == 0 and h0 // g == (h0 + hl - 1) // g:
        a, n = h0 // g, 1
    else:
        idx = torch.div(torch.arange(h0, h0 + hl, device=k.device), g,
                        rounding_mode="floor")
        return k.index_select(2, idx), v.index_select(2, idx)
    return k[:, :, a:a + n], v[:, :, a:a + n]


def _attend_on_mesh(cfg, q, k, v, attend: Callable):
    """``attend(q, k, v)`` of plain tensors, on DTensors q (B, S, H, hd) and
    k/v (B, S, KV, hd), per rank (``per_rank``): batch on the data axes and
    heads on "model" where it divides them (the reference's q/k/out
    annotations), each rank attending with its own heads; where the kv
    heads stay whole, each rank's query heads read theirs (and the kv
    gradient is each rank's heads' share, a partial sum)."""
    mesh = q.device_mesh
    h, kv = cfg.num_heads, cfg.num_kv_heads

    def local(ql, kl, vl):
        # a local gradient leaves local_map as a DTensor's shard, which
        # DTensor reshapes with view: attention's transposed layout would
        # be refused
        ql, kl, vl = (on_grad(t, torch.Tensor.contiguous)
                      for t in (ql, kl, vl))
        hl = ql.shape[2]
        if kl.shape[2] == kv and hl != h:
            # query heads sharded over "model", kv heads whole
            h0 = mesh.get_local_rank("model") * hl
            kl, vl = kv_for_heads(kl, vl, h0, hl, h // kv)
        return attend(ql, kl, vl)
    q_axes = ("batch", None, "heads", None)
    kv_axes = ("batch", None, "kv_heads", None)
    return per_rank(cfg, local, (q, k, v), (q_axes, kv_axes, kv_axes),
                    (q_axes,))


# ------------------------------------------------------------------- GQA mixer
def gqa_params_shape(cfg):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    shapes = {
        "wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
        "wo": (h * hd, d),
    }
    if cfg.qkv_bias:
        shapes.update({"bq": (h * hd,), "bk": (kv * hd,), "bv": (kv * hd,)})
    return shapes


def _project(cfg, p: Dict, x: torch.Tensor, positions: torch.Tensor):
    """q (B, S, H, hd), k and v (B, S, KV, hd), rope applied."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = splittable(q, -1, h).reshape(b, s, h, hd)
    k = splittable(k, -1, kv).reshape(b, s, kv, hd)
    v = splittable(v, -1, kv).reshape(b, s, kv, hd)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(cfg, p: Dict, x: torch.Tensor, positions: torch.Tensor,
                window: int = 0, chunk_k: int = 1024) -> torch.Tensor:
    """Full-sequence (train/prefill). x: (B, S, D_model). window > 0: a
    local layer, with no softcap (the reference's prefill applies none)."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    if window > 0:
        _check_window_length(s, window)
    # SP→TP transition: gather the sequence once for q/k/v
    x = annotate(x, "batch", None, "embed")
    q, k, v = _project(cfg, p, x, positions)
    q = annotate(q, "batch", "seq", "heads", None)
    k = annotate(k, "batch", "seq", "kv_heads", None)
    if x.device.type == "cuda":
        if window == 0 and cfg.logit_softcap > 0:
            raise NotImplementedError(
                "the flash kernel applies no logit softcap; no config sets "
                "one on a global attention layer")

        def attend(q, k, v):
            return _flash(q, k, v, window, chunk_k)
    else:
        def attend(q, k, v):
            return plain_attention(q, k, v, window, chunk_k,
                                   cfg.logit_softcap)
    out = _attend_on_mesh(cfg, q, k, v, attend) if is_dtensor(q) \
        else attend(q, k, v)
    out = annotate(out, "batch", "seq", "heads", None)
    out = grad_splittable(out.reshape(b, s, h * hd), 2, h)
    return grad_gathered(out @ p["wo"], 1)


def gqa_decode(cfg, p: Dict, x: torch.Tensor, cache: Dict, pos: int,
               window: int = 0) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode. x: (B, 1, D). cache: k/v (B, S_max, KV, hd)
    (ring buffer of size `window` for local layers), written in place.
    pos: absolute position of the new token."""
    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    # filled on the device: a tensor built from a host list would copy and
    # synchronise, once per layer and step
    positions = torch.full((1,), pos, device=x.device)
    q, k, v = _project(cfg, p, x, positions)
    ck, cv = cache["k"], cache["v"]
    s_max = ck.shape[1]
    slot = pos % s_max if window > 0 else min(pos, s_max - 1)
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    ck_a = annotate(ck, "batch", "cache_seq", "kv_heads", None)
    cv_a = annotate(cv, "batch", "cache_seq", "kv_heads", None)
    # positions of cache slots
    idx = torch.arange(s_max, device=x.device)
    if window > 0:
        # ring: slot i holds absolute position pos - ((slot - i) mod s_max)
        abs_pos = pos - torch.remainder(slot - idx, s_max)
        valid = (abs_pos >= 0) & (abs_pos >= pos - window + 1) & \
            (abs_pos <= pos)
    else:
        valid = idx <= pos

    def attend(q, k, v):
        return _decode_attend(cfg, valid, q, k, v)
    # on a mesh each rank attends with its own (batch, heads): the (B, KV)
    # batch of the products would merge two sharded dimensions
    out = _attend_on_mesh(cfg, q, ck_a, cv_a, attend) if is_dtensor(q) \
        else attend(q, ck_a, cv_a)
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    return out @ p["wo"], {"k": ck, "v": cv}


def _decode_attend(cfg, valid: torch.Tensor, q: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One query position against a cache: q (B, 1, H, hd), k/v (B,
    S_max, KV, hd) with H a multiple of KV, ``valid`` (S_max,) the slots
    it sees → (B, 1, H, hd) f32."""
    b, _, h, hd = q.shape
    kv = k.shape[2]
    qg = splittable(q, 2, kv).reshape(b, 1, kv, h // kv, hd).permute(
        0, 2, 3, 1, 4)
    s_ = torch.einsum("bkgqd,bskd->bkgqs", qg.float(), k.float()) * \
        (hd ** -0.5)
    if cfg.logit_softcap > 0:
        s_ = cfg.logit_softcap * torch.tanh(s_ / cfg.logit_softcap)
    s_ = torch.where(valid, s_, NEG_INF)
    pr = torch.softmax(s_, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", pr, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd)


def gqa_cache_shape(cfg, batch: int, s_max: int, window: int = 0):
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    size = min(window, s_max) if window > 0 else s_max
    return {"k": (batch, size, kv, hd), "v": (batch, size, kv, hd)}


# ------------------------------------------------------------------- MLA mixer
def mla_params_shape(cfg):
    d = cfg.d_model
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    shapes = {
        "wkv_a": (d, r_kv + dr),
        "kv_norm": (r_kv,),
        "wk_b": (r_kv, h * dn),
        "wv_b": (r_kv, h * dv),
        "wo": (h * dv, d),
    }
    if r_q:
        shapes.update({"wq_a": (d, r_q), "q_norm": (r_q,),
                       "wq_b": (r_q, h * (dn + dr))})
    else:
        shapes.update({"wq": (d, h * (dn + dr))})
    return shapes


def _mla_q(cfg, p: Dict, x: torch.Tensor, positions: torch.Tensor):
    """q_nope (B, S, H, dn) and q_rope (B, S, H, dr), rope applied."""
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        # the LoRA's gradient gathered over the sequence before its matmul
        # flattens (B, S) (a DTensor; XLA reshards by itself)
        q = rms_norm(grad_gathered(x @ p["wq_a"], 1), p["q_norm"],
                     cfg.norm_eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = splittable(q, -1, h).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_kv_a(cfg, p: Dict, x: torch.Tensor, positions: torch.Tensor):
    """The compressed cache entries: c_kv (B, S, r_kv) and k_rope (B, S, 1,
    dr), rope applied."""
    r_kv = cfg.kv_lora_rank
    kv_a = x @ p["wkv_a"]                               # (B,S,r+dr)
    c_kv = rms_norm(kv_a[..., :r_kv], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., None, r_kv:], positions, cfg.rope_theta)
    return c_kv, k_rope


def _mla_attend(chunk_k: int, qn, qr, c_kv, k_rope, wk_b, wv_b
                ) -> torch.Tensor:
    """MLA's causal attention over KV chunks, K/V expanded per chunk in f32:
    qn/qr (B, H, S, dn/dr) f32, c_kv (B, S, r_kv), k_rope (B, S, 1, dr),
    wk_b/wv_b (r_kv, H, dn/dv) f32 → (B, H, S, dv) f32."""
    b, h, s, dn = qn.shape
    dr, dv = qr.shape[-1], wv_b.shape[-1]
    dev = qn.device
    ck = pick_chunk(s, chunk_k)
    scale = (dn + dr) ** -0.5
    q_pos = torch.arange(s, device=dev)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, s, dv), dtype=torch.float32, device=dev)
    for c0 in range(0, s, ck):
        cc = c_kv[:, c0:c0 + ck].float()
        rc = k_rope[:, c0:c0 + ck, 0].float()
        k_nope = torch.einsum("bcr,rhd->bhcd", cc, wk_b)
        v_full = torch.einsum("bcr,rhd->bhcd", cc, wv_b)
        s_ = (torch.einsum("bhqd,bhcd->bhqc", qn, k_nope) +
              torch.einsum("bhqd,bcd->bhqc", qr, rc)) * scale
        k_pos = torch.arange(c0, c0 + ck, device=dev)
        s_ = torch.where(k_pos[None, :] <= q_pos[:, None], s_, NEG_INF)
        m_cur = torch.maximum(m, s_.amax(dim=-1))
        pr = torch.exp(s_ - m_cur[..., None])
        alpha = torch.exp(m - m_cur)
        l = l * alpha + pr.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqc,bhcd->bhqd", pr,
                                                    v_full)
        m = m_cur
    return acc / torch.clamp(l, min=1e-30)[..., None]          # (B,H,S,dv)


def mla_forward(cfg, p: Dict, x: torch.Tensor, positions: torch.Tensor,
                chunk_k: int = 1024) -> torch.Tensor:
    """Prefill MLA. K/V are expanded from the compressed cache per KV chunk
    (in f32), so the expanded (S, H, D) tensors never exist at full length.
    x: (B, S, D_model)."""
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank
    # SP→TP: one shared full-seq gather for q/kv projections
    x = annotate(x, "batch", None, "embed")
    c_kv, k_rope = _mla_kv_a(cfg, p, x, positions)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    q = annotate(torch.cat([q_nope, q_rope], dim=-1), "batch", "seq",
                 "heads", None).transpose(1, 2)            # (B,H,S,dn+dr)
    qn, qr = q[..., :dn].float(), q[..., dn:].float()
    wk_b = splittable(p["wk_b"], -1, h).reshape(r_kv, h, dn).float()
    wv_b = splittable(p["wv_b"], -1, h).reshape(r_kv, h, dv).float()
    args = (qn, qr, c_kv, k_rope, wk_b, wv_b)
    if is_dtensor(qn):
        # each rank attends with its own heads over the whole compressed
        # cache: the (B, H) batch of the products would merge two sharded
        # dimensions
        heads = ("batch", "heads", None, None)
        out = per_rank(cfg, functools.partial(_mla_attend, chunk_k), args,
                       (heads, heads, ("batch", None, None),
                        ("batch", None, None, None), (None, "heads", None),
                        (None, "heads", None)), (heads,))
    else:
        out = _mla_attend(chunk_k, *args)
    out = grad_splittable(out.transpose(1, 2).reshape(b, s, h * dv), 2,
                          h).to(x.dtype)
    out = annotate(out, "batch", "seq", None)
    # not in the reference: the sequence gathered again before wo, whose
    # matmul flattens (B, S) (XLA reshards by itself)
    return grad_gathered(gathered(out, 1) @ p["wo"], 1)


def mla_decode(cfg, p: Dict, x: torch.Tensor, cache: Dict, pos: int
               ) -> Tuple[torch.Tensor, Dict]:
    """Absorbed MLA decode: all work in the compressed space. x: (B, 1, D).
    cache: c_kv (B, S_max, r_kv), k_rope (B, S_max, dr), written in place.
    pos: absolute position of the new token."""
    b = x.shape[0]
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank
    positions = torch.full((1,), pos, device=x.device)
    c_new, kr_new = _mla_kv_a(cfg, p, x, positions)
    cc, cr = cache["c_kv"], cache["k_rope"]
    s_max = cc.shape[1]
    slot = min(pos, s_max - 1)
    cc[:, slot] = c_new[:, 0].to(cc.dtype)
    cr[:, slot] = kr_new[:, 0, 0].to(cr.dtype)

    q_nope, q_rope = _mla_q(cfg, p, x, positions)        # (B,1,H,dn/dr)
    wk_b = splittable(p["wk_b"], -1, h).reshape(r_kv, h, dn).float()
    wv_b = splittable(p["wv_b"], -1, h).reshape(r_kv, h, dv).float()
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wk_b)
    cc_a = annotate(cc, "batch", "cache_seq", None)
    cr_a = annotate(cr, "batch", "cache_seq", None)
    s_ = (torch.einsum("bqhr,bsr->bhqs", q_abs, cc_a.float()) +
          torch.einsum("bqhd,bsd->bhqs", q_rope.float(), cr_a.float())) * \
        ((dn + dr) ** -0.5)
    valid = torch.arange(s_max, device=x.device) <= pos
    s_ = torch.where(valid, s_, NEG_INF)
    pr = torch.softmax(s_, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", pr, cc_a.float())    # (B,1,H,r)
    out = torch.einsum("bqhr,rhd->bqhd", ctx, wv_b)           # (B,1,H,dv)
    out = out.reshape(b, 1, h * dv).to(x.dtype)
    return out @ p["wo"], {"c_kv": cc, "k_rope": cr}


def mla_cache_shape(cfg, batch: int, s_max: int):
    return {"c_kv": (batch, s_max, cfg.kv_lora_rank),
            "k_rope": (batch, s_max, cfg.qk_rope_head_dim)}
