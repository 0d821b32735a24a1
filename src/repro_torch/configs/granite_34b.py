"""granite-34b [dense]: 88L d_model=6144 48H (GQA kv=1 — MQA) d_ff=24576
vocab=49152 — code model [arXiv:2405.04324]. GPT-BigCode-style MQA with a
plain (non-gated) GELU MLP — a gated MLP would put the count at 47B, not
34B, so glu=False here."""
from repro_torch.models.lm.config import LMConfig, dense_stages

CONFIG = LMConfig(
    name="granite-34b",
    d_model=6144, num_heads=48, num_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    stages=dense_stages(88),
    rope_theta=10_000.0,
    norm="layernorm", act="gelu", glu=False, qkv_bias=True,
)

SMOKE = LMConfig(
    name="granite-34b-smoke",
    d_model=128, num_heads=8, num_kv_heads=1, head_dim=16,
    d_ff=256, vocab_size=512,
    stages=dense_stages(3),
    norm="layernorm", act="gelu", glu=False, qkv_bias=True,
    dtype="float32",
)
