"""The training loop the specialized cheap CNNs use (paper §4.3).

A port of the part of ``repro.train.train_loop.train`` that
``core.specialize`` runs: one micro-batch per step, no gradient
compression, no checkpoint and no preemption handling. Any other
``TrainConfig`` value raises ``NotImplementedError``; those parts come
with the backbone training slice.

``loss_fn(model, batch) -> (loss, metrics)`` is the model contract
(the reference's ``loss_fn(params, batch, rng)``: the cheap CNN draws no
random numbers, so there is no rng and no ``TrainConfig.seed``);
``batch`` is a dict of tensors on the model's device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
from torch import nn

from repro_torch.train import optimizer as opt


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 300
    log_every: int = 50
    ckpt_every: int = 0                 # 0 = no periodic checkpoint
    n_microbatches: int = 1             # grad accumulation
    compression: str = "none"           # none | bf16 | int8_ef


def _check_supported(cfg: TrainConfig):
    unsupported = {k: v for k, v in (("ckpt_every", cfg.ckpt_every),
                                     ("n_microbatches", cfg.n_microbatches),
                                     ("compression", cfg.compression))
                   if v != getattr(TrainConfig, k)}
    if unsupported:
        raise NotImplementedError(
            f"TrainConfig {unsupported}: the port's training loop runs one "
            f"micro-batch per step, without compression or checkpoints")


def train(loss_fn: Callable[[nn.Module, Dict[str, Any]],
                            Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
          model: nn.Module, data_iter: Iterator[Dict[str, Any]],
          opt_cfg: opt.OptConfig, train_cfg: TrainConfig,
          ) -> Tuple[nn.Module, List[dict]]:
    """Run ``train_cfg.steps`` AdamW steps on ``model``'s parameters in
    place; returns ``(model, history)``.

    ``history`` holds one entry at the first step and one every
    ``log_every`` steps: ``loss``, ``nll``, ``acc``, ``lr``,
    ``grad_norm``, ``step`` (1-based) and ``step_time_s``, the host time
    to issue the step (on the card the step runs asynchronously). Only
    logged steps read the loss and metrics back to the host.
    """
    _check_supported(train_cfg)
    params = list(model.parameters())
    state = opt.init(params)
    history: List[dict] = []
    for step in range(train_cfg.steps):
        batch = next(data_iter)
        t0 = time.perf_counter()
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params)
        om = opt.update(params, grads, state, opt_cfg)
        dt = time.perf_counter() - t0
        if (step + 1) % train_cfg.log_every == 0 or step == 0:
            m = {k: float(v) for k, v in {**metrics, "loss": loss.detach(),
                                          **om}.items()}
            m["step"] = step + 1
            m["step_time_s"] = dt
            history.append(m)
    return model, history
