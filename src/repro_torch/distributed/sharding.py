"""Ingest layout for sharded multi-stream ingest (DESIGN.md §13).

The counterpart of the ingest half of ``repro.distributed.sharding``
(``stream_spec``, ``ingest_batch_spec``, ``cluster_state_specs``,
``ingest_shardings``). The multi-stream pipeline stacks per-stream
tensors along a leading stream-slot axis: crops ``(S, B, R, R, 3)``,
centroids ``(S, M, D)``, counts ``(S, M)``, live counts ``n (S,)`` and
fold rows ``(S, B)``. Each device of the 1-D ``("data",)`` ingest mesh
owns a contiguous, device-major block of those slots for the whole run,
and every stacked tensor of a block lives on the block's device. There
is no ``NamedSharding``: a block is a slice of slots and its device,
computed once per pipeline, never per step.

The parameter-sharding half of the JAX module (``spec_for_param``,
``param_shardings``, ``batch_spec``, ``act_spec``, ``constrain``), which
lays LM training out over many devices, has no counterpart yet; nor have
the pieces of training that need it: ``compressed_psum`` (an int8 psum
over a named mesh axis) and ``choose_mesh``/``reshard`` (ROADMAP A14).
One card trains unsharded (``train/``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.core.clustering import ClusterState


@dataclass(frozen=True)
class SlotBlock:
    """Slots ``[lo, hi)`` of the stacked stream axis, on ``device``: the
    ``index``-th entry of the mesh's ``"data"`` axis."""
    index: int
    device: torch.device
    lo: int
    hi: int

    @property
    def width(self) -> int:
        return self.hi - self.lo

    @property
    def slots(self) -> range:
        return range(self.lo, self.hi)


def ingest_layout(mesh, n_slots: int) -> Tuple[SlotBlock, ...]:
    """The mesh's blocks for ``n_slots`` stream slots: ``mesh.size``
    contiguous blocks of ``n_slots // mesh.size`` slots each, block i on
    ``mesh.devices[i]``."""
    if n_slots < 1 or n_slots % mesh.size:
        raise ValueError(f"n_slots={n_slots} must be a non-zero multiple of "
                         f"the mesh size {mesh.size} (pad with None)")
    width = n_slots // mesh.size
    return tuple(SlotBlock(i, dev, i * width, (i + 1) * width)
                 for i, dev in enumerate(mesh.devices))


def stacked_state(block: SlotBlock, max_clusters: int,
                  feat_dim: int) -> ClusterState:
    """A block's zeroed cluster tables, stacked over its slots on its
    device: centroids (W, M, D) f32, counts (W, M) i32, n (W,) i32."""
    W, dev = block.width, block.device
    return ClusterState(
        centroids=torch.zeros((W, max_clusters, feat_dim),
                              dtype=torch.float32, device=dev),
        counts=torch.zeros((W, max_clusters), dtype=torch.int32,
                           device=dev),
        n=torch.zeros((W,), dtype=torch.int32, device=dev))
