"""AdamW + LR schedules + global-norm clipping over lists of tensors, in the
JAX package's order of operations (``repro.train.optimizer``).

``torch.optim.AdamW`` is not a drop-in: it decays every parameter as a
separate ``p * (1 - lr * wd)`` step, while the reference adds ``wd * p``
to the Adam direction of matrices only (ndim >= 2: conv and dense
weights, never a scale or a bias), and ``clip_grad_norm_`` divides by
``norm + 1e-6`` where the reference uses ``1e-9``. ``update`` writes the
reference's step out over tensors; unlike the reference, which returns
new arrays, it updates the parameters and the state in place.

On a mesh (DTensor parameters, gradients and moments) the global norm
is the whole model's, and a parameter whose gradient and moments share
its placement is updated on each rank's local block: the same
elementwise arithmetic on the same values, without DTensor's dispatch
per operation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

_f32 = np.float32


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"      # "cosine" | "linear" | "constant"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1


def lr_at(cfg: OptConfig, step: int) -> float:
    """The learning rate of (0-based) ``step``: linear warm-up, then the
    schedule's decay to ``min_lr_frac``. Evaluated in fp32, each constant
    rounded to fp32 first, in the reference's order."""
    s = _f32(step)
    warm = np.minimum(_f32(1.0),
                      (s + _f32(1)) / _f32(max(cfg.warmup_steps, 1)))
    frac = np.clip((s - _f32(cfg.warmup_steps))
                   / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   _f32(0.0), _f32(1.0))
    if cfg.schedule == "cosine":
        decay = _f32(cfg.min_lr_frac) + _f32((1 - cfg.min_lr_frac) * 0.5) \
            * (_f32(1) + np.cos(_f32(np.pi) * frac))
    elif cfg.schedule == "linear":
        decay = _f32(1.0) - _f32(1 - cfg.min_lr_frac) * frac
    else:
        decay = _f32(1.0)
    return float(_f32(_f32(cfg.lr) * warm) * decay)


def init(params: Sequence[torch.Tensor]) -> dict:
    """Zero first and second moments (fp32) and step 0."""
    return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "v": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "step": 0}


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def _local(p, *ts):
    """The local blocks of ``p`` and ``ts`` when they are DTensors of one
    placement (the update is elementwise there), else None."""
    if not hasattr(p, "to_local") or any(
            not hasattr(t, "to_local") or t.placements != p.placements
            or t.device_mesh != p.device_mesh for t in ts):
        return None
    return [p.to_local()] + [t.to_local() for t in ts]


def _like(t: torch.Tensor, p) -> torch.Tensor:
    """A local block ``t`` as a DTensor laid out as ``p``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


@torch.no_grad()
def update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           state: dict, cfg: OptConfig) -> dict:
    """One AdamW step in place over ``params`` and ``state``. Returns the
    step's metrics ``{"lr": float, "grad_norm": 0-d tensor}``; the norm
    stays on the parameters' device (no host sync)."""
    step = state["step"]
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    lr = lr_at(cfg, step)
    b1c = float(_f32(1) - _f32(cfg.b1) ** _f32(step + 1))
    b2c = float(_f32(1) - _f32(cfg.b2) ** _f32(step + 1))

    new_m: List[torch.Tensor] = []
    new_v: List[torch.Tensor] = []
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        local = _local(p, g, m, v)
        pt, gt, mt, vt = local or (p, g, m, v)
        sc = scale
        if local is not None and scale is not None:
            sc = scale.full_tensor()
        gt = gt.float() * sc if sc is not None else gt.float()
        mt = cfg.b1 * mt + (1 - cfg.b1) * gt
        vt = cfg.b2 * vt + (1 - cfg.b2) * gt * gt
        u = (mt / b1c) / (torch.sqrt(vt / b2c) + cfg.eps)
        if cfg.weight_decay > 0 and p.dim() >= 2:     # decay matrices only
            u = u + cfg.weight_decay * pt.float()
        pt.copy_(pt.float() - lr * u)
        new_m.append(_like(mt, p) if local is not None else mt)
        new_v.append(_like(vt, p) if local is not None else vt)
    state.update(m=new_m, v=new_v, step=step + 1)
    return {"lr": lr, "grad_norm": gnorm}
