"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention (window 2048), pattern
(recurrent, recurrent, attention) [arXiv:2402.19427].

26 layers = 8 × (R, R, A) superblocks + 1 × (R, R) tail. Sub-quadratic
(local attention + diagonal recurrence) ⇒ runs long_500k."""
from repro_torch.models.lm.config import LMConfig, LayerSpec, Stage

_R = LayerSpec("rglru", "dense")
_A = LayerSpec("local", "dense")

CONFIG = LMConfig(
    name="recurrentgemma-2b",
    d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    stages=(Stage((_R, _R, _A), 8), Stage((_R, _R), 1)),
    window=2048, rnn_width=2560, conv_width=4,
    rope_theta=10_000.0, logit_softcap=30.0,
    tie_embeddings=True,
    norm="rmsnorm", act="gelu", glu=True,
)

SMOKE = LMConfig(
    name="recurrentgemma-2b-smoke",
    d_model=128, num_heads=4, num_kv_heads=1, head_dim=32,
    d_ff=256, vocab_size=512,
    stages=(Stage((_R, _R, _A), 1),),
    window=32, rnn_width=128, conv_width=4,
    tie_embeddings=True, act="gelu", dtype="float32",
)
