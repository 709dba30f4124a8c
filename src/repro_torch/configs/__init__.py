"""Architecture configs of the families the port runs, and the registry."""
from repro_torch.configs.registry import (ARCH_IDS, get_arch,  # noqa: F401
                                          get_shapes)
