"""dit-s2 [diffusion]: img_res=256 patch=2 12L d_model=384 6H.
[arXiv:2212.09748; paper]"""
from repro_torch.common.config import DiTConfig

ARCH = DiTConfig(
    name="dit-s2",
    img_res=256,
    patch=2,
    n_layers=12,
    d_model=384,
    n_heads=6,
)
