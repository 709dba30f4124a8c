"""Gradient compression for the data-parallel reduce, over lists of
tensors: a port of the numerics of ``repro.train.compression``.

  * ``cast_bf16`` - the gradients as a bf16 all-reduce sees them (each
    rounded to bf16, to nearest even, and widened back to fp32);
  * ``apply_ef``  - per-tensor int8 quantization with error feedback: the
    residual of each step's quantization is carried in ``ef_state`` and
    added to the next step's gradient, so the bias cancels over steps.

  * ``compressed_psum`` - the quantized collective itself: an int8 sum
    over one named axis of a ``DeviceMesh``.

All run in the JAX package's order of fp32 operations (the scale is
``max(max |g|, 1e-12) / 127``, rounded half to even), so the same inputs
give the same bits. On DTensor gradients (a train step on a mesh) the
``max |g|`` of ``apply_ef`` is taken over the whole tensor, every shard:
the JAX package's global value.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def init_ef_state(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Zero fp32 residuals, one per parameter."""
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def _quant_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 levels, fp32 scale) of an fp32 tensor: symmetric, per
    tensor, levels in [-127, 127]."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def apply_ef(grads: Sequence[torch.Tensor], ef_state: Sequence[torch.Tensor]
             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Error-feedback int8 compression of a list of gradients. Returns
    (the dequantized gradients as seen after the wire, the new
    ``ef_state``)."""
    deq, new_e = [], []
    for g, e in zip(grads, ef_state):
        gf = g.float() + e
        q, scale = _quant_int8(gf)
        d = q.float() * scale
        deq.append(d)
        new_e.append(gf - d)
    return deq, new_e


@torch.no_grad()
def cast_bf16(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The bf16 wire format's round trip."""
    return [g.to(torch.bfloat16).float() for g in grads]


@torch.no_grad()
def compressed_psum(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """The int8-quantized sum of ``x`` over the ranks along ``axis_name``
    of the ``DeviceMesh`` ``mesh``: JAX's ``compressed_psum`` inside
    ``shard_map``, where ``x`` is this rank's local block (a plain
    tensor). In JAX's order: the local scale, its max over the axis (one
    shared scale), the levels requantized with it, their int32 sum (no
    overflow), times the scale. Every rank along the axis gets the same
    fp32 sum."""
    import torch.distributed as dist
    group = mesh.get_group(axis_name)
    xf = x.float()
    _, scale = _quant_int8(xf)
    scale = scale.reshape(1).clone()
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    scale = scale.reshape(())
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.float() * scale
