"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, llama-arch, code. [arXiv:2405.04324; hf]"""
from repro_torch.common.config import LMConfig

ARCH = LMConfig(
    name="granite-34b",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    norm="layernorm",
    mlp_act="gelu",          # GPTBigCode-style arch uses gelu MLP
    train_microbatches=8,
)
