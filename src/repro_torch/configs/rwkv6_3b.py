"""rwkv6-3b "Finch" [ssm]: 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536 — data-dependent decay [arXiv:2404.05892].

State-based (O(1) decode state per layer) ⇒ runs long_500k."""
from repro_torch.models.lm.config import LMConfig, LayerSpec, Stage

CONFIG = LMConfig(
    name="rwkv6-3b",
    d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    stages=(Stage((LayerSpec("rwkv6", "rwkv_cmix"),), 32),),
    rwkv_head_dim=64, rwkv_lora_dim=64,
    pos_embed="none",
    norm="layernorm",
)

SMOKE = LMConfig(
    name="rwkv6-3b-smoke",
    d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512,
    stages=(Stage((LayerSpec("rwkv6", "rwkv_cmix"),), 2),),
    rwkv_head_dim=32, rwkv_lora_dim=16,
    pos_embed="none", norm="layernorm", dtype="float32",
)
