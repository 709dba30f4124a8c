"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.common.config import LMConfig

ARCH = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=True,
    n_experts=64,
    moe_top_k=6,
    moe_group_size=1024,
    norm="rmsnorm",
    mlp_act="swiglu",
    train_microbatches=4,
)
