"""The LM stack of the port, training (``lm_loss``), prefill and decode for
every layer type of the reference: GQA and sliding-window attention, MLA,
MoE, RG-LRU and RWKV6, with multi-codebook tokens, a VLM prefix and
DeepSeek-V3's multi-token prediction."""
from repro_torch.models.lm.config import LMConfig, LayerSpec, Stage
from repro_torch.models.lm.model import (
    cache_shapes, decode_step, embed_tokens, head_logits, init_cache,
    init_params, lm_forward, lm_loss, param_shapes)

__all__ = [
    "LMConfig", "LayerSpec", "Stage", "cache_shapes", "decode_step",
    "embed_tokens", "head_logits", "init_cache", "init_params",
    "lm_forward", "lm_loss", "param_shapes",
]
