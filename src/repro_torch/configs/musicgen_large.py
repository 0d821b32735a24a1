"""musicgen-large [audio]: 48L d_model=2048 32H (GQA kv=32 — MHA) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens, 4 codebooks, sinusoidal
positions [arXiv:2306.05284]. Frontend (EnCodec) is a STUB: input_specs()
provides the (B, S, 4) codebook token grid directly."""
from repro_torch.models.lm.config import LMConfig, dense_stages

CONFIG = LMConfig(
    name="musicgen-large",
    d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048,
    stages=dense_stages(48),
    pos_embed="sinusoidal",
    num_codebooks=4,
    norm="layernorm", act="gelu", glu=False,
)

SMOKE = LMConfig(
    name="musicgen-large-smoke",
    d_model=128, num_heads=8, num_kv_heads=8, head_dim=16,
    d_ff=256, vocab_size=128,
    stages=dense_stages(2),
    pos_embed="sinusoidal", num_codebooks=4,
    norm="layernorm", act="gelu", glu=False, dtype="float32",
)
