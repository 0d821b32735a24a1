"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + Qwen2-0.5B backbone [arXiv:2404.16821].

The InternViT frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (B, 256, d_model) that are prepended to the text
embeddings; loss_mask zeroes the vision positions."""
from repro_torch.models.lm.config import LMConfig, dense_stages

VISION_PREFIX = 256

CONFIG = LMConfig(
    name="internvl2-1b",
    d_model=896, num_heads=14, num_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151655,
    stages=dense_stages(24),
    qkv_bias=True, rope_theta=1_000_000.0,
    vision_prefix_len=VISION_PREFIX,
    tie_embeddings=True,
    norm="rmsnorm", act="silu", glu=True,
)

SMOKE = LMConfig(
    name="internvl2-1b-smoke",
    d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512,
    stages=dense_stages(2),
    qkv_bias=True, vision_prefix_len=16,
    tie_embeddings=True, dtype="float32",
)
