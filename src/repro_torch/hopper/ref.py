"""Plain PyTorch versions of the Hopper kernels: the tests' oracle, the CPU
path of every wrapper in ``hopper.ops``, and what ``chip_smoke.py`` holds
each kernel against on the card.

Each follows its TPU counterpart's contract (``repro.kernels.ref``). It
shares with its CUDA kernel what decides an exact result, not every sum's
order:

* ``centroid_assign_ref`` takes the argmin on the partial score
  ``|c|^2 - 2 f.c`` and adds ``|f|^2`` back afterwards, as both the CUDA
  kernel and the TPU kernel do; its ``f @ c.T`` sums in the matrix
  library's order and the kernel in one fmaf chain over D, so squared
  distances agree to a tolerance (the kernel scores equal centroids bit
  for bit alike, so planted ties stay ties); ``centroid_assign_stacked_ref``
  is its loop over stream slots;
* ``pixel_match_ref`` forms ``|a - b|`` in fp32 and sums it in fp64 before
  rounding the mean to fp32 once, as the CUDA kernel does (see
  ``csrc/pixel_diff.cu`` for why), in blocks bounded like the JAX
  package's blocked numpy matcher; the fp64 sum makes the fp32 mean
  independent of the order, so the two decide alike bit for bit;
  ``pixel_match_ranges_ref`` runs it once per run of rows sharing a range;
* ``dequant_topk_ref`` dequantizes as ``q * (sg * scale_row)``, each
  product one fp32 multiply in that order (the TPU kernel's and the eager
  v4 loader's op order), and ranks with a stable descending sort, so ties
  go to the lowest column as in the CUDA kernel's stable counting pass;
* ``topk_ref`` ranks the rows with the same stable descending sort;
* ``motion_gate_ref`` rounds each product and the sum of the EMA
  separately, as the CUDA kernel does, and sums each tile's ``|f - bg|``
  in fp64 before rounding its mean to fp32 once (see
  ``csrc/motion_gate.cu``); ``motion_gate_frames_ref`` is its loop over a
  window of frames;
* ``flash_attention_ref`` is dense softmax attention in fp32 (the JAX
  package's ``flash_attention_ref``); the kernel's online softmax sums in
  another order, so the two agree to a tolerance, not bitwise.
"""
from __future__ import annotations

import math

import numpy as np
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


def centroid_assign_stacked_ref(feats: torch.Tensor,
                                centroids: torch.Tensor, threshold=None):
    """feats (S, B, D), centroids (S, M, D) -> ``centroid_assign_ref`` of
    each slot, stacked: (min_d2 (S, B), argmin (S, B)[, matched (S, B)])."""
    S, B = feats.shape[:2]
    if S == 0:
        dev = feats.device
        out = (torch.zeros((0, B), dtype=torch.float32, device=dev),
               torch.zeros((0, B), dtype=torch.int32, device=dev),
               torch.zeros((0, B), dtype=torch.bool, device=dev))
        return out if threshold is not None else out[:2]
    per_slot = [centroid_assign_ref(f, c, threshold)
                for f, c in zip(feats, centroids)]
    return tuple(torch.stack(x) for x in zip(*per_slot))


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


def pixel_match_ranges_ref(a: torch.Tensor, b: torch.Tensor,
                           lo: torch.Tensor, hi: torch.Tensor, threshold):
    """a (Na, D), b (Nb, D), lo/hi (Na,) -> (match (Na,) i32, min_d (Na,)
    f32): row i matched against ``b[lo[i]:hi[i]]`` only (clamped to
    ``[0, Nb)``; ``hi <= lo`` is empty: -1 and ``inf``), ``match[i]`` the
    absolute index. Runs ``pixel_match_ref`` once per run of consecutive
    rows that share a range, so its sums are that function's."""
    Na, Nb = a.shape[0], b.shape[0]
    match = torch.full((Na,), -1, dtype=torch.int32, device=a.device)
    min_d = torch.full((Na,), float("inf"), dtype=torch.float32,
                       device=a.device)
    los = lo.cpu().numpy().astype(np.int64).clip(0, Nb)
    his = hi.cpu().numpy().astype(np.int64).clip(0, Nb)
    i = 0
    while i < Na:
        j = i + 1
        while j < Na and los[j] == los[i] and his[j] == his[i]:
            j += 1
        if his[i] > los[i]:
            m, d = pixel_match_ref(a[i:j], b[los[i]:his[i]], threshold)
            match[i:j] = torch.where(m >= 0, m + int(los[i]), m)
            min_d[i:j] = d
        i = j
    return match, min_d


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


def topk_ref(x: torch.Tensor, k: int):
    """x (B, C) f32 -> (values (B, k) f32, indices (B, k) i32): each row's
    k largest values, descending, ties to the LOWEST column; the values are
    the input bits. ``torch.topk`` does not keep that tie rule, so the rows
    are sorted with ``stable=True``."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def motion_gate_ref(frame: torch.Tensor, bg: torch.Tensor, alpha, threshold,
                    tile: int):
    """frame/bg (H, W, 3) f32 -> (new_bg (H, W, 3) f32, tiles (ty, tx) f32,
    hot (ty, tx) bool) with ty = H // tile, tx = W // tile.

    One ``BackgroundSubtractor`` step: the EMA background update
    ``(1 - alpha) * bg + alpha * frame`` over every pixel, the mean of
    ``|frame - bg|`` over each complete (tile, tile) tile and its 3
    channels (remainder rows and columns belong to no tile), and the
    strict ``tiles > threshold`` hot mask. ``alpha`` and ``threshold`` are
    taken as fp32."""
    a = torch.as_tensor(alpha, dtype=torch.float32,
                        device=frame.device).reshape(())
    f, b = frame.float(), bg.float()
    new_bg = (1 - a) * b + a * f
    H, W = f.shape[:2]
    ty, tx = H // tile, W // tile
    d = (f[:ty * tile, :tx * tile] - b[:ty * tile, :tx * tile]).abs()
    s = d.double().reshape(ty, tile, tx, tile * 3).sum((1, 3))
    tiles = (s / (3 * tile * tile)).float()
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=f.device)
    return new_bg, tiles, tiles > thr


def motion_gate_frames_ref(frames: torch.Tensor, bg: torch.Tensor, alpha,
                           threshold, tile: int):
    """frames (N, H, W, 3), bg (H, W, 3) f32 -> (new_bg (H, W, 3) f32,
    tiles (N, ty, tx) f32, hot (N, ty, tx) bool): ``motion_gate_ref`` over
    the frames in order, each against the background the previous one
    left; ``new_bg`` is the background after the last frame."""
    H, W = bg.shape[:2]
    b = bg.float()
    tiles, hot = [], []
    for f in frames:
        b, t, h = motion_gate_ref(f, b, alpha, threshold, tile)
        tiles.append(t)
        hot.append(h)
    if not tiles:
        empty = (0, H // tile, W // tile)
        return (b.clone(),
                torch.empty(empty, dtype=torch.float32, device=b.device),
                torch.empty(empty, dtype=torch.bool, device=b.device))
    return b, torch.stack(tiles), torch.stack(hot)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q, k, v (B, S, H, dh) -> (B, S, H, dh): plain softmax attention,
    computed in fp32 and cast back to q's dtype; ``causal`` masks the
    columns past each row."""
    S, dh = q.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -math.inf)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)
