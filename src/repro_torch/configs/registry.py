"""Registry mapping --arch ids to their config modules: the ids whose
families the port runs (the dense LMs). The JAX package's MoE, vision and
diffusion ids come with their slices (ROADMAP)."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "olmo-1b",
    "granite-34b",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_") for a in ARCH_IDS}


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.ARCH

