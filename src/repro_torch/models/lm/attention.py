"""Attention mixers: GQA/MQA (the port of ``repro.models.lm.attention``).

* Train/prefill attention: on a CUDA tensor ``gqa_forward`` launches the
  hand-written flash kernel (``kernels/csrc/flash_attention.cu``) once; on
  the CPU it runs the plain online-softmax ``chunked_attention``, the same
  math without an S×S buffer.
* GQA uses the grouped formulation: query head h reads kv head h // G, and
  K/V are never expanded to H heads.
* Decode stays plain tensor ops, as the reference computes it outside any
  Pallas kernel. The cache is updated in place.
* The sliding-window (``local``) mixer and MLA come in a later slice
  (ROADMAP Queue 1, item 12); they raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.flash_attention import chunked_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models.lm.common import apply_rope

_LATER = ("is not ported yet: the local mixer and MLA come with a later "
          "slice of the LM stack (ROADMAP Queue 1, item 12)")


def sliding_window_attention(q, k, v, window, scale=None):
    raise NotImplementedError(f"sliding_window_attention {_LATER}")


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
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(cfg, p: Dict, x: torch.Tensor, positions: torch.Tensor,
                window: int = 0, chunk_k: int = 1024) -> torch.Tensor:
    """Full-sequence (train/prefill). x: (B, S, D_model)."""
    if window > 0:
        raise NotImplementedError(f"sliding-window attention {_LATER}")
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _project(cfg, p, x, positions)
    if x.device.type == "cuda":
        if cfg.logit_softcap > 0:
            raise NotImplementedError(
                "the flash kernel applies no logit softcap; no GQA config "
                "of this slice sets one")
        # (B, S, heads, hd) passed as (B, heads, S, hd) views: the kernel
        # reads through strides and writes its output in q's layout
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True,
                              impl="cuda").transpose(1, 2)
    else:
        out = chunked_attention(q, k, v, causal=True, chunk_k=chunk_k,
                                softcap=cfg.logit_softcap)
    return out.reshape(b, s, h * hd) @ p["wo"]


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
    # positions of cache slots
    idx = torch.arange(s_max, device=x.device)
    if window > 0:
        # ring: slot i holds absolute position pos - ((slot - i) mod s_max)
        abs_pos = pos - torch.remainder(slot - idx, s_max)
        valid = (abs_pos >= 0) & (abs_pos >= pos - window + 1) & \
            (abs_pos <= pos)
    else:
        valid = idx <= pos
    qg = q.reshape(b, 1, kv, h // kv, hd).permute(0, 2, 3, 1, 4)
    s_ = torch.einsum("bkgqd,bskd->bkgqs", qg.float(), ck.float()) * \
        (hd ** -0.5)
    if cfg.logit_softcap > 0:
        s_ = cfg.logit_softcap * torch.tanh(s_ / cfg.logit_softcap)
    s_ = torch.where(valid, s_, NEG_INF)
    pr = torch.softmax(s_, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", pr, cv.float())
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, h * hd).to(x.dtype)
    return out @ p["wo"], {"k": ck, "v": cv}


def gqa_cache_shape(cfg, batch: int, s_max: int, window: int = 0):
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    size = min(window, s_max) if window > 0 else s_max
    return {"k": (batch, size, kv, hd), "v": (batch, size, kv, hd)}
