"""deit-b [vision]: img_res=224 patch=16 12L d_model=768 12H d_ff=3072,
distillation token. [arXiv:2012.12877; paper]"""
from repro_torch.common.config import ViTConfig

ARCH = ViTConfig(
    name="deit-b",
    img_res=224,
    patch=16,
    n_layers=12,
    d_model=768,
    n_heads=12,
    d_ff=3072,
    distill_token=True,
)
