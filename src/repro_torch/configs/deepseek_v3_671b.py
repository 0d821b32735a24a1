"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048(moe)
vocab=129280 — MLA (q_lora 1536, kv_lora 512), MoE 256 routed top-8 +
1 shared, MTP [arXiv:2412.19437]. First 3 layers dense (d_ff 18432)."""
from repro_torch.models.lm.config import LMConfig, LayerSpec, Stage

CONFIG = LMConfig(
    name="deepseek-v3-671b",
    d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432, vocab_size=129280,
    stages=(Stage((LayerSpec("mla", "dense"),), 3),
            Stage((LayerSpec("mla", "moe"),), 58)),
    q_lora_rank=1536,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128,
    moe_num_experts=256, moe_top_k=8, moe_num_shared=1, moe_d_ff=2048,
    mtp_depth=1,
    rope_theta=10_000.0,
    norm="rmsnorm", act="silu", glu=True,
)

SMOKE = LMConfig(
    name="deepseek-v3-671b-smoke",
    d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512,
    stages=(Stage((LayerSpec("mla", "dense"),), 1),
            Stage((LayerSpec("mla", "moe"),), 1)),
    q_lora_rank=64,
    kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
    v_head_dim=32,
    moe_num_experts=8, moe_top_k=2, moe_num_shared=1, moe_d_ff=64,
    mtp_depth=1, dtype="float32",
)
