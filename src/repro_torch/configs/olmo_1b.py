"""olmo-1b [dense]: 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.
Non-parametric LayerNorm (OLMo's signature). [arXiv:2402.00838; hf]"""
from repro_torch.common.config import LMConfig

ARCH = LMConfig(
    name="olmo-1b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric_ln",
    mlp_act="swiglu",
    tie_embeddings=True,     # OLMo-1B ties input/output embeddings
)
