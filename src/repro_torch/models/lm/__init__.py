"""The LM stack of the port: dense GQA transformers (llama3.2-1b, qwen2,
...) for prefill and decode. See ``model`` for what is not ported yet."""
from repro_torch.models.lm.config import LMConfig, LayerSpec, Stage
from repro_torch.models.lm.model import (
    cache_shapes, decode_step, embed_tokens, head_logits, init_cache,
    init_params, lm_forward, param_shapes)

__all__ = [
    "LMConfig", "LayerSpec", "Stage", "cache_shapes", "decode_step",
    "embed_tokens", "head_logits", "init_cache", "init_params",
    "lm_forward", "param_shapes",
]
