"""dit-b2 [diffusion]: img_res=256 patch=2 12L d_model=768 12H.
[arXiv:2212.09748; paper]"""
from repro_torch.common.config import DiTConfig

ARCH = DiTConfig(
    name="dit-b2",
    img_res=256,
    patch=2,
    n_layers=12,
    d_model=768,
    n_heads=12,
)
