from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, chunked_attention, pick_chunk)

__all__ = ["attention_ref", "chunked_attention", "flash_attention",
           "pick_chunk"]
