"""Plain PyTorch versions of full-sequence attention: the CPU path, and what
the CUDA kernel ``csrc/flash_attention.cu`` is held against on the card.

``attention_ref`` materialises S×S (the port of
``repro.kernels.flash_attention.ref``); ``chunked_attention`` is the
online-softmax scan over KV chunks of ``repro.models.lm.attention``, the
same math as the kernel without an S×S buffer.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    mask = torch.ones((q_pos.numel(), k_pos.numel()), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, KV, S, D) with H % KV == 0 → (B, H, S, D).

    Query head h reads kv head h // (H / KV). Computed in f32, returned in
    q's dtype. window > 0 ⇒ sliding-window attention: position i sees
    [i-window+1, i].
    """
    b, h, s, d = q.shape
    g = h // k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = k.float().repeat_interleave(g, dim=1)
    v = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
    pos = torch.arange(s, device=q.device)
    logits = torch.where(_mask(pos, pos, causal, window), logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def pick_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is ≤ target (chunked scans need s % c == 0;
    odd lengths like S−1=4095 for MTP or prefix+text=4352 for VLMs occur)."""
    c = min(target, s)
    while s % c != 0:
        c -= 1
    return max(c, 1)


def chunked_attention(
    q: torch.Tensor,           # (B, S, H, D)
    k: torch.Tensor,           # (B, Sk, KV, D)
    v: torch.Tensor,           # (B, Sk, KV, Dv)
    causal: bool = True,
    window: int = 0,
    chunk_k: int = 1024,
    scale: Optional[float] = None,
    q_offset: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks. Returns (B, S, H, Dv)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    dv = v.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    ck = pick_chunk(sk, chunk_k)

    qg = q.reshape(b, sq, kv, g, d).permute(0, 2, 3, 1, 4).float()
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, kv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, sk, ck):
        kc = k[:, c0:c0 + ck].permute(0, 2, 1, 3).float()    # (B,KV,Ck,D)
        vc = v[:, c0:c0 + ck].permute(0, 2, 1, 3).float()
        s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kc) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(c0, c0 + ck, device=q.device)
        s = torch.where(_mask(q_pos, k_pos, causal, window), s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_cur[..., None])
        alpha = torch.exp(m - m_cur)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqc,bkcd->bkgqd",
                                                    p, vc)
        m = m_cur
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)
