"""Config-driven LM: embedding → stages → head; prefill and decode.

The port of ``repro.models.lm.model``. Parameters keep the reference's
stacked layout: each stage's layer weights carry a leading ``repeat`` axis,
so the trees match the reference's leaf for leaf. Where the reference runs
a stage as one ``lax.scan`` over that axis, the port runs a Python loop
over it. Multi-codebook models (MusicGen) take (B, S, K) tokens and VLM
backbones (InternVL) a ``prefix_embeds`` of patch embeddings before the
text. ``lm_loss`` is the next-token loss over a sequence-chunked cross
entropy (``chunked_xent``: the (B, S, V) logits never exist at once), plus
DeepSeek-V3's multi-token-prediction (``mtp``) term. With ``remat=True``
one repeat of a stage's layers (the reference's scan body) is
checkpointed when autograd records: its activations are recomputed in the
backward pass.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.kernels.flash_attention.ref import pick_chunk
from repro_torch.models.lm.blocks import (
    _cache_dtype, _norm_shape, layer_cache_shape, layer_decode,
    layer_forward, layer_param_shapes)
from repro_torch.models.lm.common import (
    apply_norm, dense_init, sinusoidal_embed)
from repro_torch.models.lm.config import LMConfig

# leaves the reference's init fills with zeros (besides ``norm``-named ones)
_ZEROS = ("bias", "ba", "bi", "conv_b", "ln_x_bias", "bq", "bk", "bv",
          "mu_base", "w_base", "cmix_mu_k", "cmix_mu_r")


# ----------------------------------------------------------------- param trees
def param_shapes(cfg: LMConfig) -> Dict:
    d, v = cfg.d_model, cfg.vocab_size
    tree: Dict = {}
    if cfg.num_codebooks > 1:
        tree["embed"] = {"table": (cfg.num_codebooks, v, d)}
    else:
        tree["embed"] = {"table": (v, d)}
    stages = []
    for st in cfg.stages:
        layers = {}
        for i, spec in enumerate(st.layers):
            shapes = layer_param_shapes(cfg, spec)
            layers[f"layer{i}"] = _map_leaves(
                shapes, lambda _name, s, r=st.repeat: (r,) + tuple(s))
        stages.append(layers)
    tree["stages"] = stages
    tree["final_norm"] = _norm_shape(cfg)
    if not cfg.tie_embeddings:
        if cfg.num_codebooks > 1:
            tree["head"] = {"w": (d, cfg.num_codebooks * v)}
        else:
            tree["head"] = {"w": (d, v)}
    if cfg.mtp_depth > 0:
        spec = cfg.stages[-1].layers[-1]
        tree["mtp"] = {
            "proj": (2 * d, d),
            "norm_h": _norm_shape(cfg), "norm_e": _norm_shape(cfg),
            "layer": layer_param_shapes(cfg, spec),
        }
    return tree


def _map_leaves(tree: Any, fn: Callable[[str, tuple], Any],
                name: str = "") -> Any:
    """``fn(leaf name, shape)`` over a tree of dicts and lists whose leaves
    are shape tuples. Dict keys are visited in sorted order (the order JAX
    flattens a dict in), so draws from one generator follow a fixed
    order."""
    if isinstance(tree, tuple):
        return fn(name, tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(tree[k], fn, k) for k in sorted(tree)}
    return [_map_leaves(t, fn, name) for t in tree]


def init_params(cfg: LMConfig, generator: torch.Generator,
                device: DeviceSpec = None) -> Dict:
    """Parameters by the reference's name-based rules: ``norm``-named
    leaves, ``scale`` and ``ln_x_scale`` are ones; biases and the
    RG-LRU/RWKV offsets zeros; ``lam`` is ``linspace(0.5, 2.0, s[0])``
    over its stacked shape's first axis, so of shape (repeat,), one decay
    rate per layer as the reference makes it (ROADMAP Queue 3); ``mu`` and
    ``u`` uniform × 0.5; every other leaf ``dense_init`` with its (stacked)
    shape. Drawn from ``generator`` on its own device (a CUDA generator
    draws a full-width model in seconds) and placed on ``device``
    (``cuda`` by default); a CPU generator gives the same weights on every
    device."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)

    def leaf(name: str, s: tuple) -> torch.Tensor:
        if "norm" in name or name in ("scale", "ln_x_scale"):
            return torch.ones(s, dtype=dt, device=dev)
        if name in _ZEROS:
            return torch.zeros(s, dtype=dt, device=dev)
        if name == "lam":
            return torch.from_numpy(np.linspace(0.5, 2.0, s[0])).to(
                dtype=dt, device=dev)
        if name in ("mu", "u"):
            return (torch.rand(s, generator=generator, dtype=torch.float32,
                               device=generator.device) * 0.5).to(dt).to(dev)
        return dense_init(generator, s, dt).to(dev)

    return _map_leaves(param_shapes(cfg), leaf)


def _at(tree: Any, r: int) -> Any:
    """Layer ``r`` of a stacked tree: a view of each leaf at index r."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    return tree[r]


# -------------------------------------------------------------------- embedding
def embed_tokens(cfg: LMConfig, params, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) int, or (B, S, K) for a K-codebook model (the sum of
    the per-codebook embeddings, MusicGen) → (B, S, D)."""
    table = params["embed"]["table"]
    if cfg.num_codebooks > 1:
        h = sum(table[k][tokens[..., k]] for k in range(cfg.num_codebooks))
    else:
        h = table[tokens]
    if cfg.pos_embed == "sinusoidal":
        if positions is None:
            positions = torch.arange(h.shape[1], device=h.device)
        h = h + sinusoidal_embed(positions, cfg.d_model).to(h.dtype)
    return h


def head_logits(cfg: LMConfig, params, h: torch.Tensor) -> torch.Tensor:
    """h (..., D) → logits (..., V) (or (..., K·V) for multi-codebook)."""
    if cfg.tie_embeddings:
        return h @ params["embed"]["table"].T
    return h @ params["head"]["w"]


# ------------------------------------------------------------------- forward
def _run_stages(cfg: LMConfig, params, h: torch.Tensor,
                positions: torch.Tensor, remat: bool = True) -> torch.Tensor:
    """Every stage's layers, one repeat at a time. ``remat``: checkpoint
    each repeat (the reference's ``jax.checkpoint`` of its scan body) when
    autograd records; under ``torch.no_grad()`` nothing is checkpointed."""
    remat = remat and torch.is_grad_enabled()
    for st, st_params in zip(cfg.stages, params["stages"]):
        for r in range(st.repeat):
            layer_p = _at(st_params, r)

            def body(x, layer_p=layer_p, st=st):
                for i, spec in enumerate(st.layers):
                    x = layer_forward(cfg, spec, layer_p[f"layer{i}"], x,
                                      positions)
                return x
            h = checkpoint(body, h, use_reentrant=False) if remat \
                else body(h)
    return h


def lm_forward(cfg: LMConfig, params, tokens: torch.Tensor,
               prefix_embeds: Optional[torch.Tensor] = None,
               remat: bool = True) -> torch.Tensor:
    """Returns final hidden states (B, P + S, D), P the rows of
    ``prefix_embeds`` (B, P, D) (a VLM's precomputed patch embeddings,
    put before the text). On a CUDA tensor each GQA or local attention
    layer launches the flash kernel once, and once more in the backward
    pass when ``remat`` recomputes its repeat."""
    h = embed_tokens(cfg, params, tokens)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)
    h = _run_stages(cfg, params, h, positions, remat=remat)
    return apply_norm(cfg, h, params["final_norm"])


def _xent_chunk(cfg: LMConfig, params, h_chunk: torch.Tensor,
                labels_chunk: torch.Tensor, mask_chunk: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked NLL, sum of the mask) over one (B, C) chunk; a
    K-codebook model's NLL is summed over its codebooks."""
    logits = head_logits(cfg, params, h_chunk).float()
    if cfg.num_codebooks > 1:
        b, s, _ = logits.shape
        logits = logits.reshape(b, s, cfg.num_codebooks, cfg.vocab_size)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels_chunk[..., None].long())[..., 0]
    if cfg.num_codebooks > 1:
        nll = nll.sum(-1)
    return (nll * mask_chunk).sum(), mask_chunk.sum()


def chunked_xent(cfg: LMConfig, params, h: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor, chunk: int = 512,
                 remat: bool = False) -> torch.Tensor:
    """Mean NLL with (B, C, V) logits at a time, C = ``pick_chunk(S,
    chunk)``; the chunk sums are added in order. ``remat``: recompute each
    chunk's logits in the backward pass instead of keeping its softmax
    (the reference's ``REPRO_XENT_REMAT=1``)."""
    s = h.shape[1]
    c = pick_chunk(s, chunk)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)

    def body(hh, ll, mm):
        return _xent_chunk(cfg, params, hh, ll, mm)
    remat = remat and torch.is_grad_enabled()
    for c0 in range(0, s, c):
        args = (h[:, c0:c0 + c], labels[:, c0:c0 + c], mask[:, c0:c0 + c])
        l, n = checkpoint(body, *args, use_reentrant=False) if remat \
            else body(*args)
        tot, cnt = tot + l, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(cfg: LMConfig, params, batch: Dict[str, torch.Tensor],
            remat: bool = True) -> torch.Tensor:
    """batch: tokens (B, S[, K]) int, loss_mask (B, S) float, optional
    prefix_embeds (B, P, D). Next-token LM loss (position t predicts token
    t + 1) over the text; with ``cfg.mtp_depth`` > 0 plus 0.3 x the MTP
    loss (DeepSeek-V3: h_t and the embedding of token t + 1 through one
    extra layer predict token t + 2, sharing ``final_norm`` and the
    head)."""
    tokens = batch["tokens"]
    prefix = batch.get("prefix_embeds")
    h = lm_forward(cfg, params, tokens, prefix_embeds=prefix, remat=remat)
    p_len = 0 if prefix is None else prefix.shape[1]
    h_in = h[:, p_len:][:, :-1]
    labels = tokens[:, 1:]
    mask = batch["loss_mask"][:, 1:].float()
    loss = chunked_xent(cfg, params, h_in, labels, mask)
    if cfg.mtp_depth > 0:
        mtp = params["mtp"]
        emb_next = embed_tokens(cfg, params, tokens[:, 1:])
        h_n = apply_norm(cfg, h_in, mtp["norm_h"])
        e_n = apply_norm(cfg, emb_next, mtp["norm_e"])
        h2 = torch.cat([h_n, e_n], dim=-1) @ mtp["proj"]
        spec = cfg.stages[-1].layers[-1]
        h2 = layer_forward(cfg, spec, mtp["layer"], h2,
                           torch.arange(h2.shape[1], device=h2.device))
        h2 = apply_norm(cfg, h2, params["final_norm"])
        loss = loss + 0.3 * chunked_xent(
            cfg, params, h2[:, :-1], tokens[:, 2:],
            batch["loss_mask"][:, 2:].float())
    return loss


# --------------------------------------------------------------------- decode
def cache_shapes(cfg: LMConfig, batch: int, s_max: int) -> Dict:
    stages = []
    for st in cfg.stages:
        layers = {}
        for i, spec in enumerate(st.layers):
            shapes = layer_cache_shape(cfg, spec, batch, s_max)
            layers[f"layer{i}"] = _map_leaves(
                shapes, lambda _name, s, r=st.repeat: (r,) + tuple(s))
        stages.append(layers)
    return {"stages": stages}


def init_cache(cfg: LMConfig, batch: int, s_max: int,
               device: DeviceSpec = None) -> Dict:
    dev = resolve_device(device)
    return _map_leaves(cache_shapes(cfg, batch, s_max), lambda name, s:
                       torch.zeros(s, dtype=_cache_dtype(cfg, name),
                                   device=dev))


def decode_step(cfg: LMConfig, params, cache, tokens: torch.Tensor,
                pos: int) -> Tuple[torch.Tensor, Any]:
    """One decode step. tokens (B, 1) int, or (B, 1, K) for a K-codebook
    model; pos: absolute position of this token. Returns (logits (B, 1, V)
    or (B, 1, K·V), cache); the cache is written in place and returned as
    the same object."""
    h = embed_tokens(cfg, params, tokens,
                     positions=torch.full((1,), pos, device=tokens.device))
    for st, st_params, st_cache in zip(cfg.stages, params["stages"],
                                       cache["stages"]):
        for r in range(st.repeat):
            for i, spec in enumerate(st.layers):
                h, _ = layer_decode(cfg, spec,
                                    _at(st_params[f"layer{i}"], r), h,
                                    _at(st_cache[f"layer{i}"], r), pos)
    h = apply_norm(cfg, h, params["final_norm"])
    return head_logits(cfg, params, h), cache
