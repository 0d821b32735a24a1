"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — QKV bias [arXiv:2407.10671]."""
from repro_torch.models.lm.config import LMConfig, dense_stages

CONFIG = LMConfig(
    name="qwen2-1.5b",
    d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    stages=dense_stages(28),
    qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=True,
    norm="rmsnorm", act="silu", glu=True,
)

SMOKE = LMConfig(
    name="qwen2-1.5b-smoke",
    d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512,
    stages=dense_stages(2),
    qkv_bias=True, tie_embeddings=True, dtype="float32",
)
