"""Plain PyTorch versions of the Hopper kernels: the tests' oracle, the CPU
path of every wrapper in ``hopper.ops``, and what ``chip_smoke.py`` holds
each kernel against on the card.

Each follows its TPU counterpart's contract (``repro.kernels.ref``) and
evaluates in the same order as its CUDA kernel, so the two rank near-ties
alike:

* ``centroid_assign_ref`` takes the argmin on the partial score
  ``|c|^2 - 2 f.c`` and adds ``|f|^2`` back afterwards, as both the CUDA
  kernel and the TPU kernel do;
* ``pixel_match_ref`` forms ``|a - b|`` in fp32 and sums it in fp64 before
  rounding the mean to fp32 once, as the CUDA kernel does (see
  ``csrc/pixel_diff.cu`` for why), in blocks bounded like the JAX
  package's blocked numpy matcher;
* ``dequant_topk_ref`` dequantizes as ``q * (sg * scale_row)``, each
  product one fp32 multiply in that order (the TPU kernel's and the eager
  v4 loader's op order), and ranks with a stable descending sort, so ties
  go to the lowest column as in the CUDA kernel's rank count.
"""
from __future__ import annotations

import torch

# pair-elements cap for one (rows, Nb, D) difference block
_BLOCK_ELEMS = 1 << 22


def threshold_sq(threshold) -> torch.Tensor:
    """``threshold**2`` squared in fp32, as the TPU kernel does: for
    example fp32(0.8)**2 is 0.64000005, while Python's 0.8*0.8 is
    0.6400000000000001, and the ``matched`` edge moves with it."""
    return torch.as_tensor(threshold, dtype=torch.float32).reshape(()) ** 2


def centroid_assign_ref(feats: torch.Tensor, centroids: torch.Tensor,
                        threshold=None):
    """feats (B, D), centroids (M, D) -> (min_d2 (B,) f32, argmin (B,) i32)
    or, with ``threshold``, also ``matched = min_d2 <= threshold**2``
    (B,) bool. Ties go to the lowest centroid index."""
    f = feats.float()
    c = centroids.float()
    part = (c * c).sum(1)[None, :] - 2.0 * (f @ c.T)          # (B, M)
    best, j = part.min(1)                   # first index of the minimum
    min_d2 = best + (f * f).sum(1)
    j = j.to(torch.int32)
    if threshold is None:
        return min_d2, j
    return min_d2, j, min_d2 <= threshold_sq(threshold).to(min_d2.device)


def pixel_match_ref(a: torch.Tensor, b: torch.Tensor, threshold):
    """a (Na, D), b (Nb, D) -> (match (Na,) i32, min_d (Na,) f32).

    ``match[i]`` is the lowest index j minimizing ``mean |a_i - b_j|`` when
    that minimum is STRICTLY below ``threshold``, else -1. An empty side
    gives all -1 and ``inf``."""
    Na, Nb = a.shape[0], b.shape[0]
    if Na == 0 or Nb == 0:
        return (torch.full((Na,), -1, dtype=torch.int32, device=a.device),
                torch.full((Na,), float("inf"), dtype=torch.float32,
                           device=a.device))
    af, bf = a.float(), b.float()
    D = af.shape[1]
    rows = max(1, _BLOCK_ELEMS // max(1, Nb * D))
    mins, args = [], []
    for i in range(0, Na, rows):
        diff = (af[i:i + rows, None, :] - bf[None, :, :]).abs()
        d = (diff.double().sum(-1) / D).float()                # (r, Nb)
        best, j = d.min(1)
        mins.append(best)
        args.append(j)
    min_d = torch.cat(mins)
    j = torch.cat(args).to(torch.int32)
    thr = torch.as_tensor(threshold, dtype=torch.float32).to(a.device)
    return torch.where(min_d < thr, j, torch.full_like(j, -1)), min_d


def dequant_topk_ref(q: torch.Tensor, scales: torch.Tensor, k: int,
                     global_scale=1.0):
    """q (M, C) int8/uint8, scales (M,) f32 -> (values (M, k) f32,
    indices (M, k) i32): the top-k of ``q * (global_scale * scales)[:,
    None]``, descending, ties to the LOWEST column. ``torch.topk`` does
    not keep that tie rule, so the rows are sorted with ``stable=True``."""
    sg = torch.as_tensor(global_scale, dtype=torch.float32,
                         device=q.device).reshape(())
    x = q.float() * (sg * scales.float())[:, None]
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()
