"""The train loop: gradient accumulation over micro-batches,
gradient compression, checkpoint and restart, preemption handling. A
port of ``repro.train.train_loop``, which both the specialized cheap
CNNs (paper §4.3) and the decoder LM run.

``loss_fn(params, batch, rng) -> (loss, metrics)`` is the model contract,
the JAX package's: ``rng`` is a ``common.prng`` key (on the CPU), drawn
as the JAX package's loop draws it: ``key(TrainConfig.seed)``, split each
step into the next key and the step's, and the step's split once more
into one key per micro-batch (when there is more than one). DiT's loss
draws its timesteps and noise from it; the other models' losses take it
and draw nothing. A loss of two arguments (``loss_fn(params, batch)``) is
still called without one (``takes_rng``): a compatibility path for the
older tests' losses, to go when they are next touched. After a restore
the key restarts at
``key(seed)``, as the JAX package's does: a resumed run draws other
numbers than an uninterrupted one, in both packages. ``params`` is an
``nn.Module`` (the cheap CNN) or a tree of tensors (a model's parameter
dictionary); the loop updates its tensors in place and returns it.
``batch`` is a dict of tensors with a leading batch axis, on the
parameters' device.

The step runs in the JAX package's order: the batch split contiguously
into ``n_microbatches`` parts, each part's gradients added to an fp32
accumulator, the sum and the summed loss divided by the count, the last
part's metrics kept; then the compression, then ``optimizer.update`` (in
place). A module's parameters are its ``parameters()``; a tree's leaves
are flattened as ``train.checkpoint`` flattens them (dict keys sorted),
so a checkpoint's leaves are the JAX package's for the same tree.

On a mesh the parameters are DTensors (``distributed.sharding``): each
gradient is redistributed to its parameter's placement before the
compression and the update, so the update is local to each shard (and
``apply_ef``'s ``max |g|`` is the whole tensor's, JAX's global value);
``train(..., mesh=)`` lays each batch out with ``batch_spec`` and puts
a restored checkpoint's leaves on the parameters' placements.
"""
from __future__ import annotations

import contextlib
import inspect
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.common import prng
from repro_torch.distributed.sharding import (batch_spec, distribute,
                                              full_tensor, is_dtensor,
                                              replicate_like)
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager, flatten
from repro_torch.train.elastic import PreemptionHandler, StepTimer


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 300
    log_every: int = 50
    ckpt_every: int = 0                 # 0 = only on preemption/final
    n_microbatches: int = 1             # grad accumulation
    compression: str = "none"           # none | bf16 | int8_ef
    seed: int = 0


def param_leaves(params) -> List[torch.Tensor]:
    """The tensors the loop trains: a module's ``parameters()``, or a
    tree's leaves in the JAX package's order."""
    if isinstance(params, nn.Module):
        return list(params.parameters())
    return flatten(params)[0]


def state_tree(params, opt_state: dict, ef_state) -> tuple:
    """What the loop checkpoints: (params, optimizer state, error-feedback
    state), laid out as the JAX package's loop lays it out (the moments
    in parameter order, ``step`` an int32 scalar), so the checkpoint's
    leaves are the JAX package's."""
    p = list(params.parameters()) if isinstance(params, nn.Module) \
        else params
    return (p, {"m": opt_state["m"], "step": np.int32(opt_state["step"]),
                "v": opt_state["v"]}, ef_state)


@contextlib.contextmanager
def _requiring_grad(leaves: List[torch.Tensor]):
    """The leaves marked as requiring gradients inside the block, their
    own flags restored after it."""
    flags = [t.requires_grad for t in leaves]
    for t in leaves:
        t.requires_grad_(True)
    try:
        yield
    finally:
        for t, f in zip(leaves, flags):
            t.requires_grad_(f)


def _microbatch(batch: Dict[str, Any], i: int, n: int) -> Dict[str, Any]:
    """Part ``i`` of ``n`` of the batch's leading axis, contiguous."""
    def part(x):
        if isinstance(x, dict):
            return {k: part(v) for k, v in x.items()}
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]
    return part(batch)


def takes_rng(loss_fn: Callable) -> bool:
    """Whether ``loss_fn`` takes the contract's third argument, the rng.
    Every loss of the port's entry points takes it; the step builders'
    losses that draw nothing (``launch.steps``) and older tests' do not."""
    ps = inspect.signature(loss_fn).parameters.values()
    if any(p.kind == p.VAR_POSITIONAL for p in ps):
        return True
    return sum(p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
               for p in ps) >= 3


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Gradient ``g`` on parameter ``p``'s placement (a DTensor's backward
    leaves partial sums and other layouts); plain tensors as they are."""
    if is_dtensor(p):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _like(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A restored full value ``r`` laid out as the leaf ``t`` it is copied
    into (its placement when ``t`` is a DTensor)."""
    if not is_dtensor(t):
        return r
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(r.to(t.device), t.device_mesh,
                             t.placements, src_data_rank=None)


def _batch_specs(batch, mesh):
    """``batch_spec`` for every tensor of a batch (a dict of tensors)."""
    if isinstance(batch, dict):
        return {k: _batch_specs(v, mesh) for k, v in batch.items()}
    return batch_spec(mesh, batch.dim() - 1)


def make_train_step(loss_fn: Callable, opt_cfg: opt.OptConfig,
                    train_cfg: TrainConfig, mesh=None) -> Callable:
    """``step(params, opt_state, ef_state, batch, rng=None) -> (params,
    opt_state, ef_state, metrics)``. ``opt_state`` is ``optimizer.init``
    of ``param_leaves(params)``; ``ef_state`` is
    ``compression.init_ef_state`` of them under ``int8_ef``, else 0. The
    parameters and ``opt_state`` are updated in place. ``rng`` (a
    ``common.prng`` key) goes to a loss that takes one, split once per
    micro-batch when there is more than one. ``metrics`` holds
    ``loss_fn``'s metrics, ``loss``, ``lr`` and ``grad_norm``, as tensors
    on the device (``lr`` a float). ``mesh`` is JAX's argument: the step
    runs on whatever layout its DTensor parameters carry (each gradient
    is placed as its parameter before the update)."""
    n_mb = train_cfg.n_microbatches
    with_rng = takes_rng(loss_fn)

    def grads_of(params, leaves, batch, rng):
        if with_rng:
            if rng is None:
                raise ValueError("this loss_fn takes an rng: pass one")
            loss, metrics = loss_fn(params, batch, rng)
        else:
            loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, [_placed_like(g, p)
                                        for g, p in zip(grads, leaves)]

    def step(params, opt_state, ef_state, batch, rng=None):
        leaves = param_leaves(params)
        with _requiring_grad(leaves):
            if n_mb > 1:
                rngs = (prng.split(rng, n_mb) if rng is not None
                        else [None] * n_mb)
                grads = [torch.zeros_like(p, dtype=torch.float32)
                         for p in leaves]
                loss = replicate_like(torch.zeros(
                    (), dtype=torch.float32, device=leaves[0].device),
                    leaves[0])
                for i in range(n_mb):
                    l, metrics, g = grads_of(params, leaves,
                                             _microbatch(batch, i, n_mb),
                                             rngs[i])
                    for a, b in zip(grads, g):
                        a.add_(b)
                    loss = loss + l.float()
                    del g
                for g in grads:
                    g.div_(n_mb)
                loss = loss / n_mb
            else:
                loss, metrics, grads = grads_of(params, leaves, batch, rng)

        if train_cfg.compression == "bf16":
            grads = comp.cast_bf16(grads)
        elif train_cfg.compression == "int8_ef":
            grads, ef_state = comp.apply_ef(grads, ef_state)

        om = opt.update(leaves, grads, opt_state, opt_cfg)
        return params, opt_state, ef_state, dict(metrics, loss=loss, **om)

    return step


def train(loss_fn: Callable, params, data_iter: Iterator[Dict[str, Any]],
          opt_cfg: opt.OptConfig, train_cfg: TrainConfig,
          ckpt: Optional[CheckpointManager] = None, mesh=None,
          resume: bool = True, hooks=()) -> Tuple[Any, List[dict]]:
    """Run the loop to ``train_cfg.steps``; returns ``(params, history)``.

    ``history`` holds one entry at the first step run and one every
    ``log_every`` steps: ``loss_fn``'s metrics, ``loss``, ``lr``,
    ``grad_norm``, ``step`` (1-based) and ``step_time_s``, the host time
    to issue the step (``StepTimer``; on the card the step runs
    asynchronously). Only logged steps read values back to the host;
    each entry goes to every hook.

    Fault tolerance: with ``ckpt`` and ``resume``, the newest checkpoint's
    parameters (copied into ``params``), optimizer and error-feedback
    state are restored and its ``batches_consumed`` batches of
    ``data_iter`` replayed; the rng is not restored (it restarts at
    ``key(seed)``, as in the JAX package). A SIGTERM checkpoints at the next step's end
    (``preempted`` in its extras) and returns; ``ckpt_every`` saves
    periodically, and the last step is saved when ``train`` returns (the
    JAX package's loop saves it again when ``ckpt_every`` just did, and
    re-labels a restored state as ``steps`` when no step was left). The
    earlier SIGTERM handler is back in place when ``train`` returns.

    With a ``mesh`` (a ``DeviceMesh`` whose DTensors ``params`` are), each
    batch is laid out by ``batch_spec`` and every rank runs the loop.
    """
    step_fn = make_train_step(loss_fn, opt_cfg, train_cfg, mesh=mesh)
    leaves = param_leaves(params)
    int8_ef = train_cfg.compression == "int8_ef"
    start_step = 0
    if ckpt is not None and resume and ckpt.latest_step() is not None:
        start_step, (p, o, e), extra = ckpt.restore(
            device=leaves[0].device)
        with torch.no_grad():
            for t, r in zip(leaves, flatten(p)[0]):
                t.copy_(_like(r, t))
        opt_state = {"m": [_like(r, t) for r, t in zip(o["m"], leaves)],
                     "v": [_like(r, t) for r, t in zip(o["v"], leaves)],
                     "step": int(o["step"])}
        ef_state = ([_like(r, t) for r, t in zip(e, leaves)] if int8_ef
                    else 0)
        for _ in range(int(extra.get("batches_consumed", start_step))):
            next(data_iter)                      # replay iterator position
    else:
        opt_state = opt.init(leaves)
        ef_state = comp.init_ef_state(leaves) if int8_ef else 0

    rng = prng.key(train_cfg.seed)
    preempt = PreemptionHandler()
    timer = StepTimer()
    history: List[dict] = []
    saved = start_step                  # the step of the newest checkpoint
    try:
        for step in range(start_step, train_cfg.steps):
            batch = next(data_iter)
            if mesh is not None:
                batch = distribute(batch, _batch_specs(batch, mesh), mesh)
            rng, sub = prng.split(rng)
            with timer.measure():
                params, opt_state, ef_state, metrics = step_fn(
                    params, opt_state, ef_state, batch, sub)
            if (step + 1) % train_cfg.log_every == 0 or step == start_step:
                m = {k: float(v) for k, v in
                     full_tensor(metrics).items()}
                m["step"] = step + 1
                m["step_time_s"] = timer.last
                history.append(m)
                for h in hooks:
                    h(m)
            if ckpt is not None and (
                    preempt.triggered
                    or (train_cfg.ckpt_every
                        and (step + 1) % train_cfg.ckpt_every == 0)):
                ckpt.save(step + 1, state_tree(params, opt_state, ef_state),
                          extra={"batches_consumed": step + 1,
                                 "preempted": preempt.triggered})
                saved = step + 1
                if preempt.triggered:
                    ckpt.wait()
                    return params, history
        if ckpt is not None:
            if saved < train_cfg.steps:
                ckpt.save(train_cfg.steps,
                          state_tree(params, opt_state, ef_state),
                          extra={"batches_consumed": train_cfg.steps})
            ckpt.wait()
    finally:
        preempt.restore()
    return params, history
