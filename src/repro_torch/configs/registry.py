"""Registry mapping --arch ids to their config modules: the ids whose
families the port runs (the decoder LMs, dense and MoE). The JAX
package's vision and diffusion ids come with their slice (ROADMAP A13)."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "dbrx-132b",
    "moonshot-v1-16b-a3b",
    "olmo-1b",
    "granite-34b",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_") for a in ARCH_IDS}


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.ARCH

