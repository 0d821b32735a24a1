"""Unified LM-family architecture config.

One config type covers all 10 assigned architectures: dense GQA/MQA
transformers, MLA+MoE (DeepSeek), attention-free RWKV6, hybrid RG-LRU
(RecurrentGemma), multi-codebook audio decoders (MusicGen) and VLM backbones
(InternVL). A model is a sequence of STAGES; each stage is `repeat` copies of
a short layer pattern and is lowered as ONE lax.scan over stacked parameters
(keeps HLO size and compile time independent of depth).

The port's copy of ``repro.models.lm.config``. One named repair: the
reference's ``param_count``/``active_param_count`` count through JAX's
abstract params; here they are numpy over ``param_shapes``. The port runs
a stage as a Python loop over the stacked ``repeat`` axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str          # "gqa" | "local" | "mla" | "rglru" | "rwkv6"
    ffn: str            # "dense" | "moe" | "rwkv_cmix"


@dataclasses.dataclass(frozen=True)
class Stage:
    layers: Tuple[LayerSpec, ...]   # the pattern applied sequentially
    repeat: int                     # scanned `repeat` times


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    stages: Tuple[Stage, ...]
    head_dim: int = 0                 # 0 → d_model // num_heads
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    pos_embed: str = "rope"           # rope | sinusoidal | none
    window: int = 0                   # sliding-window size for "local" mixer
    logit_softcap: float = 0.0
    # MLA (DeepSeek)
    q_lora_rank: int = 0              # 0 → direct q projection
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # multi-token prediction (DeepSeek-V3)
    mtp_depth: int = 0
    # RWKV6
    rwkv_head_dim: int = 64
    rwkv_lora_dim: int = 64
    # RG-LRU (RecurrentGemma)
    rnn_width: int = 0                # 0 → d_model
    conv_width: int = 4
    # modality frontends (stubs per assignment)
    num_codebooks: int = 1            # MusicGen EnCodec codebooks
    vision_prefix_len: int = 0        # InternVL patch-embedding prefix
    # misc
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "silu"                 # silu | gelu
    glu: bool = True                  # gated FFN (SwiGLU/GeGLU)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    # ---------- derived ----------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_layers(self) -> int:
        return sum(len(s.layers) * s.repeat for s in self.stages)

    @property
    def is_subquadratic(self) -> bool:
        """True iff no layer does full-context attention (long_500k eligible)."""
        for s in self.stages:
            for l in s.layers:
                if l.mixer in ("gqa", "mla"):
                    return False
        return True

    @property
    def qk_head_dim(self) -> int:
        """Per-head q/k dim for MLA (nope + rope) or standard heads."""
        if self.qk_nope_head_dim:
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.resolved_head_dim

    def param_count(self) -> int:
        """Exact parameter count from the init shapes (host-side, cheap)."""
        from repro_torch.models.lm.model import param_shapes
        return sum(int(np.prod(s)) for _, s in _shape_leaves(
            param_shapes(self)))

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k routed only). As in
        the reference, it looks for "experts" in the key path, which no
        expert leaf (``we_in``, ``we_gate``, ``we_out``) has, so a MoE
        model reports its full count (ROADMAP Queue 3)."""
        from repro_torch.models.lm.model import param_shapes
        total = 0
        for path, shape in _shape_leaves(param_shapes(self)):
            size = int(np.prod(shape))
            if any("experts" in k for k in path) and self.moe_num_experts:
                size = size // self.moe_num_experts * self.moe_top_k
            total += size
        return total


def _shape_leaves(tree, path=()):
    """(key path, shape) of every leaf of a tree of dicts and lists whose
    leaves are shape tuples, in insertion order."""
    if isinstance(tree, tuple):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _shape_leaves(v, path + (str(k),))
    else:
        for i, v in enumerate(tree):
            yield from _shape_leaves(v, path + (str(i),))


def dense_stages(num_layers: int, mixer: str = "gqa") -> Tuple[Stage, ...]:
    return (Stage((LayerSpec(mixer, "dense"),), num_layers),)
