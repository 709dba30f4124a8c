"""Mesh construction: the (pod, data, model) meshes of LM training and
serving, and the ingest mesh of sharded multi-stream ingest.

Functions, not module-level constants: importing this module touches no
device and no process group (the JAX package's contract,
``tests/test_launch.py``).

- ``make_mesh(shape, axes)`` is a ``torch.distributed`` ``DeviceMesh``
  over the process group's ranks: NCCL on the card, gloo with
  ``device="cpu"``. A mesh of one device starts its own one-rank group
  when none exists; a larger one needs the group started across
  ``prod(shape)`` processes (``init_process_group`` with an address, a
  world size and a rank).
- ``make_production_mesh`` is JAX's 256-device ``(16, 16)`` and
  512-device ``(2, 16, 16)`` mesh; ``make_abstract_mesh`` gives the same
  names and sizes without devices, which is all the sharding specs need
  (``distributed.sharding``), and ``make_fake_mesh`` a ``DeviceMesh`` of
  those sizes over a fake process group, on which the dry run traces
  steps on meta tensors (``launch.dryrun``).
- ``make_ingest_mesh`` is the 1-D ``("data",)`` ingest mesh. The JAX
  package builds a ``jax.sharding.Mesh`` over its devices; the port keeps
  the name and the shape: an ``IngestMesh`` is a list of
  ``torch.device``s along one ``"data"`` axis, each owning a block of
  stream slots.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from repro_torch.common.device import resolve_device
from repro_torch.distributed.sharding import AbstractMesh

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_abstract_mesh(shape: Sequence[int],
                       axes: Sequence[str]) -> AbstractMesh:
    """The mesh's axis names and sizes, no devices: what specs need."""
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process
    group's ranks in order (rank r at the row-major position r).

    ``device="cuda"`` without a card raises; there is no CPU fallback
    (pass ``device="cpu"`` for a gloo mesh). With no process group and a
    one-device shape, a one-rank group is started on a local store (NCCL
    on the card, gloo on the CPU); the caller ends it with
    ``torch.distributed.destroy_process_group()``. A shape whose size is
    not the world size raises a ``ValueError`` that says what to do."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} sizes for axes {axes}")
    dev = resolve_device(device)
    if dev.type not in _BACKEND:
        raise ValueError(f"unsupported device {device!r}: expected 'cuda' "
                         f"or 'cpu'")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"make_mesh({shape}) needs {n} processes, and no process "
                f"group exists: start one in each of {n} processes "
                f"(torch.distributed.init_process_group(backend, "
                f"init_method='tcp://localhost:<port>', world_size={n}, "
                f"rank=r)), then call make_mesh")
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(_BACKEND[dev.type], store=dist.HashStore(),
                                rank=0, world_size=1)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(
            f"make_mesh({shape}) holds {n} devices but the process group "
            f"has {world} ranks; pass a shape whose product is {world}, or "
            f"start the group with world_size={n}")
    if dev.type == "cuda":
        avail = torch.cuda.device_count()
        torch.cuda.set_device(dist.get_rank() % avail)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def production_shape(multi_pod: bool = False):
    """(shape, axes) of the production mesh: (data=16, model=16), or
    (pod=2, data=16, model=16) across two pods."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (data=16, model=16) = 256 devices. Multi-pod: (pod=2,
    data=16, model=16) = 512 devices, over CUDA cards. Raises with the
    visible card count where there are fewer (one card shows a one-rank
    mesh only); ``make_fake_mesh`` traces these shapes without cards."""
    shape, axes = production_shape(multi_pod)
    n = math.prod(shape)
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if avail < n:
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}) needs {n} "
            f"devices, but {avail} CUDA device(s) are visible; use "
            f"make_abstract_mesh({shape}, {axes}) for its specs, or "
            f"make_mesh with a shape of {max(avail, 1)} devices")
    return make_mesh(shape, axes)


_FAKE_MESHES = {}


def make_fake_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A CUDA-typed ``DeviceMesh`` of ``shape`` over a fake process group
    of ``prod(shape)`` ranks, this process being rank 0: for tracing a
    step on meta tensors at a mesh size no machine here holds (the dry
    run, ``launch.dryrun``). No card is needed and no collective moves
    data; DTensor plans the collectives NCCL would run, all-to-all
    included (a CPU-typed mesh would plan all-gathers in its place).

    Starts the group when none exists. A fake group of another size is
    destroyed and started anew (a group's world size is fixed), which
    ends every mesh made on it; a real group raises. The caller ends the
    group with ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} sizes for axes {axes}")
    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise ValueError(
                f"make_fake_mesh needs a fake process group, and a "
                f"{dist.get_backend()!r} group exists: end it first "
                f"(torch.distributed.destroy_process_group())")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        _FAKE_MESHES.clear()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    if (shape, axes) not in _FAKE_MESHES:
        _FAKE_MESHES[shape, axes] = init_device_mesh(
            "cuda", shape, mesh_dim_names=axes)
    return _FAKE_MESHES[shape, axes]


@dataclass(frozen=True)
class IngestMesh:
    """A 1-D ``("data",)`` mesh: ``devices[i]`` owns the i-th block of
    stream slots, their stacked cluster tables and (past block 0) a
    replica of the ingest forward; every kernel of the block launches on
    that device. CPU meshes repeat ``torch.device("cpu")``: each entry is
    a block of its own, the counterpart of XLA's forced host devices. An
    entry may repeat a card too (``(cuda:0, cuda:0)``: two blocks, two
    forwards, one card); ``make_ingest_mesh`` never builds one."""
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
    devices, one block each, driven by one process (the forward on
    ``cuda:0``, a replica on each other card), or with ``device="cpu"``
    that many CPU blocks. Too few cards raise a ``ValueError`` that says
    what to do, up front, rather than a device error deep inside the
    first step."""
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
