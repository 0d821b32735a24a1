"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408(moe)
vocab=102400 — MLA kv_lora=512, MoE 64 routed top-6 + 2 shared
[arXiv:2405.04434]. Layer 0 dense (d_ff 10944), layers 1-26 MoE."""
from repro_torch.models.lm.config import LMConfig, LayerSpec, Stage

CONFIG = LMConfig(
    name="deepseek-v2-lite-16b",
    d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    stages=(Stage((LayerSpec("mla", "dense"),), 1),
            Stage((LayerSpec("mla", "moe"),), 26)),
    q_lora_rank=0,                # v2-lite: no q compression
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128,
    moe_num_experts=64, moe_top_k=6, moe_num_shared=2, moe_d_ff=1408,
    rope_theta=10_000.0,
    norm="rmsnorm", act="silu", glu=True,
)

SMOKE = LMConfig(
    name="deepseek-v2-lite-16b-smoke",
    d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512,
    stages=(Stage((LayerSpec("mla", "dense"),), 1),
            Stage((LayerSpec("mla", "moe"),), 1)),
    kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
    v_head_dim=32,
    moe_num_experts=8, moe_top_k=2, moe_num_shared=1, moe_d_ff=64,
    dtype="float32",
)
