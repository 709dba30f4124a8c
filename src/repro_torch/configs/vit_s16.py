"""vit-s16 [vision]: img_res=224 patch=16 12L d_model=384 6H d_ff=1536.
Base of the Focus cheap ingest-CNN search space. [arXiv:2010.11929; paper]"""
from repro_torch.common.config import ViTConfig

ARCH = ViTConfig(
    name="vit-s16",
    img_res=224,
    patch=16,
    n_layers=12,
    d_model=384,
    n_heads=6,
    d_ff=1536,
)
