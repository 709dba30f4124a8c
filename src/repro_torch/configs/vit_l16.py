"""vit-l16 [vision]: img_res=224 patch=16 24L d_model=1024 16H d_ff=4096.
Default Focus GT-CNN. [arXiv:2010.11929; paper]"""
from repro_torch.common.config import ViTConfig

ARCH = ViTConfig(
    name="vit-l16",
    img_res=224,
    patch=16,
    n_layers=24,
    d_model=1024,
    n_heads=16,
    d_ff=4096,
)
