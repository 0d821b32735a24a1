"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-1B]."""
from repro_torch.models.lm.config import LMConfig, dense_stages

CONFIG = LMConfig(
    name="llama3.2-1b",
    d_model=2048, num_heads=32, num_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=128256,
    stages=dense_stages(16),
    rope_theta=500_000.0,
    tie_embeddings=True,
    norm="rmsnorm", act="silu", glu=True,
)

SMOKE = LMConfig(
    name="llama3.2-1b-smoke",
    d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512,
    stages=dense_stages(2),
    rope_theta=500_000.0, tie_embeddings=True, dtype="float32",
)
