"""Elastic scaling, preemption handling and straggler detection for the
train loop: a port of ``repro.train.elastic``.

  * ``PreemptionHandler`` - SIGTERM sets ``triggered`` instead of ending
    the process; the loop checks it each step, checkpoints and returns.
    ``restore`` puts the earlier handlers back.
  * ``choose_mesh`` / ``reshard`` - rebuild a ``("pod", "data",
    "model")`` ``DeviceMesh`` from the ranks that remain, and move every
    leaf onto its ``param_shardings`` placement there: the rules are
    axis-name based, so a (2, 16, 16) job that loses a pod degrades to
    (1, 16, 16) without a change to model code.
  * ``StepTimer`` - EMA of step times; a step slower than
    ``straggler_factor`` times the EMA counts as a straggler.
"""
from __future__ import annotations

import contextlib
import signal
import time
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import (distribute, full_tensor,
                                              param_shardings)


class PreemptionHandler:
    """Registers ``signals`` (SIGTERM); sets ``triggered`` instead of
    dying. Outside the main thread no handler can be installed, and
    ``triggered`` stays False."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.triggered = False
        self._old = {}
        for s in signals:
            try:
                self._old[s] = signal.signal(s, self._handle)
            except ValueError:          # not the main thread
                pass

    def _handle(self, signum, frame):
        self.triggered = True

    def restore(self):
        for s, h in self._old.items():
            signal.signal(s, h)
        self._old = {}


def mesh_shape_for(n: int, model_parallelism: int = 1,
                   pods: int = 1) -> Tuple[int, int, int]:
    """(pods, dp, mp) of the largest mesh ``n`` devices hold: JAX's
    halving loop, model parallelism halved until ``mp * pods`` divides
    ``n``."""
    mp = model_parallelism
    while n % (mp * pods) and mp > 1:
        mp //= 2
    return pods, n // (mp * pods), mp


def choose_mesh(ranks: Optional[Sequence[int]] = None,
                model_parallelism: int = 1, pods: int = 1):
    """The largest ``("pod", "data", "model")`` ``DeviceMesh`` that the
    ``ranks`` (every rank of the process group by default) support, over
    the first ``pods * dp * mp`` of them in order (``mesh_shape_for``).

    Building a mesh is a collective over every rank of the group, so
    every rank calls this with the same arguments, also a rank left out
    of the mesh. Such a rank gets the mesh all the same, with no
    coordinate in it (``get_coordinate()`` is None); a DTensor it places
    there holds an empty local tensor. The mesh's devices are the
    group's: CUDA under NCCL, else the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise ValueError("choose_mesh needs a process group: start one "
                         "(launch.mesh.make_mesh starts a one-rank group)")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    p, dp, mp = mesh_shape_for(len(ranks), model_parallelism, pods)
    if dp < 1:
        raise ValueError(f"{len(ranks)} rank(s) cannot hold {pods} pods")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ids = torch.tensor(ranks[: p * dp * mp]).reshape(p, dp, mp)
    return DeviceMesh(device, ids, mesh_dim_names=("pod", "data", "model"))


def reshard(tree, new_mesh, scan_layers: bool = True):
    """Every leaf of ``tree`` (a parameter tree of tensors or DTensors)
    moved onto its ``param_shardings`` placement on ``new_mesh``: the
    full value is gathered (a collective on the old mesh) and placed
    again. The values do not change. Every rank of the process group
    calls it."""
    return distribute(full_tensor(tree),
                      param_shardings(tree, new_mesh, scan_layers),
                      new_mesh)


class StepTimer:
    """EMA step timing and straggler counting."""

    def __init__(self, alpha: float = 0.1, straggler_factor: float = 2.0):
        self.alpha = alpha
        self.factor = straggler_factor
        self.ema: Optional[float] = None
        self.last: float = 0.0
        self.n_steps = 0
        self.n_stragglers = 0

    @contextlib.contextmanager
    def measure(self):
        """Observe the host wall time of the ``with`` body."""
        t0 = time.perf_counter()
        yield
        self.observe(time.perf_counter() - t0)

    def observe(self, dt: float):
        self.last = dt
        self.n_steps += 1
        if self.ema is None:
            self.ema = dt
            return
        if dt > self.factor * self.ema:
            self.n_stragglers += 1
        self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
