"""efficientnet-b7 [vision]: native img_res=600, width_mult=2.0,
depth_mult=3.1. [arXiv:1905.11946; paper]"""
from repro_torch.common.config import EffNetConfig

ARCH = EffNetConfig(
    name="efficientnet-b7",
    img_res=600,
    width_mult=2.0,
    depth_mult=3.1,
)
