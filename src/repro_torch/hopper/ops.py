"""Wrappers for the Hopper kernels in ``csrc/``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, and launches its kernel on the current CUDA
stream without synchronising. A CUDA tensor launches the kernel or raises;
only a CPU tensor takes the plain version in ``hopper.ref``. ``LAUNCHES``
counts kernel launches per wrapper, so a run can show that its path went
through the kernels.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.hopper import build, ref

LAUNCHES = {"centroid_assign": 0, "pixel_match": 0, "dequant_topk": 0}

# widest row the dequant_topk kernel ranks: its fp32 copy of one row lives
# in 48 KB of shared memory (kMaxC in csrc/dequant_topk.cu)
DEQUANT_MAX_C = 48 * 1024 // 4


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_pair(x: torch.Tensor, y: torch.Tensor, names: str):
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"{names} must be (N, D) and (M, D) with one D, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"{names} lie on {x.device} and {y.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_kernel_inputs(names: str, *ts: torch.Tensor):
    for t in ts:
        if t.dtype != torch.float32:
            raise ValueError(f"{names}: the kernel takes float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{names}: the kernel takes contiguous rows")
        if t.data_ptr() % 16:
            raise ValueError(f"{names}: the kernel reads 16-byte vectors; "
                             f"the data must be 16-byte aligned")
    if ts[0].shape[1] % 4:
        raise ValueError(f"{names}: the kernel reads 16-byte vectors, so D "
                         f"must be a multiple of 4, got {ts[0].shape[1]}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, name: str):
    if err:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


def centroid_assign(feats: torch.Tensor, centroids: torch.Tensor,
                    threshold=None):
    """(B, D), (M, D) -> (min squared-L2 (B,) f32, argmin (B,) i32) and,
    with ``threshold``, the fused ``matched (B,) bool`` mask
    (``min_d2 <= threshold**2``, the square taken in fp32). Ties go to the
    lowest centroid index."""
    _check_pair(feats, centroids, "feats/centroids")
    if feats.device.type == "cpu":
        return ref.centroid_assign_ref(feats, centroids, threshold)
    _check_kernel_inputs("centroid_assign", feats, centroids)
    B, D = feats.shape
    M = centroids.shape[0]
    if M == 0:
        raise ValueError("centroid_assign needs at least one centroid")
    dev = feats.device
    min_d2 = torch.empty((B,), dtype=torch.float32, device=dev)
    arg = torch.empty((B,), dtype=torch.int32, device=dev)
    matched = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        t2 = (np.float32(np.inf) if threshold is None
              else np.float32(threshold) ** 2)          # squared in fp32
        err = build.load().centroid_assign_launch(
            feats.data_ptr(), centroids.data_ptr(), min_d2.data_ptr(),
            arg.data_ptr(), matched.data_ptr(), B, M, D, float(t2),
            _stream(dev))
        _raise_on(err, "centroid_assign")
        LAUNCHES["centroid_assign"] += 1
    if threshold is None:
        return min_d2, arg
    return min_d2, arg, matched


def _n_split(device: torch.device, Na: int, Nb: int) -> int:
    """Ranges of b rows per crop: enough blocks for two per SM, but at
    least eight rows (one per warp) in each range."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-2 * sms // Na), -(-Nb // 8)))


def pixel_match(a: torch.Tensor, b: torch.Tensor, threshold):
    """(Na, D), (Nb, D) -> (match (Na,) i32, min_d (Na,) f32).

    ``match[i]`` is the lowest index j minimizing ``mean |a_i - b_j|`` when
    that minimum is STRICTLY below ``threshold`` (a mean exactly at the
    threshold does not match), else -1. ``Na == 0`` or ``Nb == 0`` gives
    all -1 and ``inf``: no references means nothing matches."""
    _check_pair(a, b, "a/b")
    Na, Nb = a.shape[0], b.shape[0]
    if a.device.type == "cpu" or Na == 0 or Nb == 0:
        return ref.pixel_match_ref(a, b, threshold)
    _check_kernel_inputs("pixel_match", a, b)
    D = a.shape[1]
    dev = a.device
    match = torch.empty((Na,), dtype=torch.int32, device=dev)
    min_d = torch.empty((Na,), dtype=torch.float32, device=dev)
    n_split = _n_split(dev, Na, Nb)
    part_v = part_i = None
    if n_split > 1:
        part_v = torch.empty((Na * n_split,), dtype=torch.float32, device=dev)
        part_i = torch.empty((Na * n_split,), dtype=torch.int32, device=dev)
    err = build.load().pixel_match_launch(
        a.data_ptr(), b.data_ptr(), match.data_ptr(), min_d.data_ptr(),
        part_v.data_ptr() if part_v is not None else None,
        part_i.data_ptr() if part_i is not None else None,
        Na, Nb, D, n_split, float(np.float32(threshold)), _stream(dev))
    _raise_on(err, "pixel_match")
    LAUNCHES["pixel_match"] += 1
    return match, min_d


def dequant_topk(q: torch.Tensor, scales: torch.Tensor, k: int, *,
                 global_scale=1.0):
    """q (M, C) int8/uint8, scales (M,) f32 ->
    (values (M, k) f32, indices (M, k) i32), descending.

    Fused dequant + top-k over quantized rows: ``values`` are the top-k of
    ``q * (global_scale * scales)[:, None]``, each product one fp32
    multiply in that order, with ties to the LOWEST column index — the
    archive's lazy rank path over v4 shards. ``scales`` are the stored
    per-row scales and must be positive. ``k > C`` (or ``k < 1``) raises;
    ``M == 0`` gives empty outputs without a launch. Float inputs raise:
    dequantizing an already-dequantized matrix is a bug."""
    if q.dim() != 2:
        raise ValueError(f"q must be (M, C), got {tuple(q.shape)}")
    M, C = q.shape
    if not 1 <= k <= C:
        raise ValueError(
            f"k must be in [1, C={C}], got {k}: the top-k of a (M, {C}) "
            f"quantized matrix has at most {C} entries per row")
    if q.dtype.is_floating_point or q.dtype.is_complex \
            or q.dtype == torch.bool:
        raise ValueError(f"dequant_topk expects integer quantized rows, "
                         f"got {q.dtype}")
    if tuple(scales.shape) != (M,):
        raise ValueError(f"scales must be ({M},) to match q's rows, got "
                         f"{tuple(scales.shape)}")
    if scales.device != q.device:
        raise ValueError(f"q/scales lie on {q.device} and {scales.device}")
    if q.device.type == "cpu":
        return ref.dequant_topk_ref(q, scales, k, global_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    dev = q.device
    vals = torch.empty((M, k), dtype=torch.float32, device=dev)
    idx = torch.empty((M, k), dtype=torch.int32, device=dev)
    if M == 0:
        return vals, idx
    if q.dtype not in (torch.uint8, torch.int8):
        raise ValueError(f"the dequant_topk kernel takes int8 or uint8, got "
                         f"{q.dtype}")
    if scales.dtype != torch.float32:
        raise ValueError(f"scales must be float32, got {scales.dtype}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequant_topk: the kernel takes contiguous rows")
    if C > DEQUANT_MAX_C:
        raise ValueError(f"dequant_topk: C={C} exceeds the kernel's "
                         f"{DEQUANT_MAX_C} columns (one fp32 row in 48 KB "
                         f"of shared memory)")
    sg = float(np.float32(global_scale))
    err = build.load().dequant_topk_launch(
        q.data_ptr(), int(q.dtype == torch.int8), scales.data_ptr(), sg,
        vals.data_ptr(), idx.data_ptr(), M, C, k, _stream(dev))
    _raise_on(err, "dequant_topk")
    LAUNCHES["dequant_topk"] += 1
    return vals, idx
