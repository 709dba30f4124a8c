"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained. [hf:databricks/dbrx-base; unverified]"""
from repro_torch.common.config import LMConfig

ARCH = LMConfig(
    name="dbrx-132b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    moe=True,
    n_experts=16,
    moe_top_k=4,
    moe_group_size=256,   # §Perf iter 6: dispatch bytes/FLOPs scale with C
    norm="layernorm",
    mlp_act="swiglu",
    train_microbatches=8,
)
