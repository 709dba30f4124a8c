"""Registry mapping --arch ids to their config modules: every id of the
JAX package's registry, in its order (the decoder LMs, dense and MoE, the
diffusion transformers and the vision models)."""
from __future__ import annotations

import importlib

from repro_torch.common.config import shapes_for

ARCH_IDS = [
    "dbrx-132b",
    "moonshot-v1-16b-a3b",
    "olmo-1b",
    "granite-34b",
    "dit-b2",
    "dit-s2",
    "vit-l16",
    "deit-b",
    "efficientnet-b7",
    "vit-s16",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_") for a in ARCH_IDS}


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.ARCH


def get_shapes(arch_id: str):
    return shapes_for(get_arch(arch_id))
