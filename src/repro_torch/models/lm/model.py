"""Config-driven LM: embedding → stages → head; prefill and decode.

The port of ``repro.models.lm.model``. Parameters keep the reference's
stacked layout: each stage's layer weights carry a leading ``repeat`` axis,
so the trees match the reference's leaf for leaf. Where the reference runs
a stage as one ``lax.scan`` over that axis, the port runs a Python loop
over it. Multi-codebook models (MusicGen) take (B, S, K) tokens and VLM
backbones (InternVL) a ``prefix_embeds`` of patch embeddings before the
text. The parameter tree holds DeepSeek-V3's multi-token-prediction
(``mtp``) subtree; its forward comes with ``lm_loss`` and ``chunked_xent``
and LM training (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceSpec, resolve_device
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
                positions: torch.Tensor) -> torch.Tensor:
    for st, st_params in zip(cfg.stages, params["stages"]):
        for r in range(st.repeat):
            for i, spec in enumerate(st.layers):
                h = layer_forward(cfg, spec, _at(st_params[f"layer{i}"], r),
                                  h, positions)
    return h


def lm_forward(cfg: LMConfig, params, tokens: torch.Tensor,
               prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Returns final hidden states (B, P + S, D), P the rows of
    ``prefix_embeds`` (B, P, D) (a VLM's precomputed patch embeddings,
    put before the text). On a CUDA tensor each GQA or local attention
    layer launches the flash kernel once."""
    h = embed_tokens(cfg, params, tokens)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)
    h = _run_stages(cfg, params, h, positions)
    return apply_norm(cfg, h, params["final_norm"])


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
