"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000 — GQA, no-bias [hf:CohereForAI/c4ai-command-r-plus]."""
from repro_torch.models.lm.config import LMConfig, dense_stages

CONFIG = LMConfig(
    name="command-r-plus-104b",
    d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000,
    stages=dense_stages(64),
    rope_theta=75_000_000.0,
    norm="layernorm", act="silu", glu=True,
)

SMOKE = LMConfig(
    name="command-r-plus-104b-smoke",
    d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512,
    stages=dense_stages(2),
    norm="layernorm", dtype="float32",
)
