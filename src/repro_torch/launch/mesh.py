"""The ingest mesh: which devices sharded multi-stream ingest runs on.

The JAX package builds a 1-D ``("data",)`` ``jax.sharding.Mesh`` over its
devices (``repro.launch.mesh.make_ingest_mesh``). The port keeps the
name and the shape: an ``IngestMesh`` is a list of ``torch.device``s
along one ``"data"`` axis, and each of its devices owns a block of
stream slots (``distributed.sharding``). Nothing here touches a device
when the module is imported; ``make_ingest_mesh`` checks the device count
only when it is called.

The JAX package's ``make_production_mesh`` (fixed 256/512-chip TPU
shapes, for LM training) has no counterpart yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.common.device import resolve_device


@dataclass(frozen=True)
class IngestMesh:
    """A 1-D ``("data",)`` mesh: ``devices[i]`` owns the i-th block of
    stream slots. CPU meshes repeat ``torch.device("cpu")``: each entry is
    a block of its own, the counterpart of XLA's forced host devices."""
    devices: Tuple[torch.device, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data",)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_ingest_mesh(n_devices: int, device: str = "cuda") -> IngestMesh:
    """A 1-D ``("data",)`` mesh of ``n_devices`` blocks for sharded
    multi-stream ingest (DESIGN.md §13): the first ``n_devices`` CUDA
    devices, or with ``device="cpu"`` that many CPU blocks. Too few cards
    raise a ``ValueError`` that says what to do, up front, rather than a
    device error deep inside the first step."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    kind = torch.device(device).type
    if kind == "cpu":
        return IngestMesh(tuple(torch.device("cpu")
                                for _ in range(n_devices)))
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r}: expected 'cuda' "
                         f"or 'cpu'")
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices > avail:
        raise ValueError(
            f"make_ingest_mesh(n_devices={n_devices}) but only {avail} CUDA "
            f"device(s) are visible; pass n_devices <= {avail}, or "
            f"device='cpu' for a mesh of {n_devices} CPU blocks")
    return IngestMesh(tuple(resolve_device(f"cuda:{i}")
                            for i in range(n_devices)))
