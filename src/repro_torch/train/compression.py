"""Gradient compression for the data-parallel reduce, over lists of
tensors: a port of the numerics of ``repro.train.compression``.

  * ``cast_bf16`` - the gradients as a bf16 all-reduce sees them (each
    rounded to bf16, to nearest even, and widened back to fp32);
  * ``apply_ef``  - per-tensor int8 quantization with error feedback: the
    residual of each step's quantization is carried in ``ef_state`` and
    added to the next step's gradient, so the bias cancels over steps.

Both run in the JAX package's order of fp32 operations (the scale is
``max(max |g|, 1e-12) / 127``, rounded half to even), so the same inputs
give the same bits. One card has no data-parallel axis to reduce over:
the collective itself, ``compressed_psum`` over a named mesh axis, waits
with the parameter sharding of ``distributed/sharding.py`` (ROADMAP A14).
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
