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
import functools

import numpy as np
import torch

from repro_torch.hopper import build, ref

LAUNCHES = {"centroid_assign": 0, "pixel_match": 0, "dequant_topk": 0,
            "topk": 0, "motion_gate": 0, "flash_attention": 0}

# feature rows per centroid_assign block (kBM in csrc/centroid_assign.cu)
CENTROID_ROWS = 64

# head widths the flash_attention kernel is built for (the JAX tests' set)
FLASH_HEAD_DIMS = (16, 32, 64, 128)

# widest row the dequant_topk kernel ranks: one key byte per column in
# shared memory (kMaxC in csrc/dequant_topk.cu)
DEQUANT_MAX_C = 12288
# widest row the topk kernel sorts: 12288 columns pad to 16384 64-bit keys,
# 128 KB of shared memory (kMaxC in csrc/topk.cu)
TOPK_MAX_C = 12288


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
    if ts[0].shape[-1] % 4:
        raise ValueError(f"{names}: the kernel reads 16-byte vectors, so D "
                         f"must be a multiple of 4, got {ts[0].shape[-1]}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, name: str):
    if err:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


def _assign_launch(feats: torch.Tensor, centroids: torch.Tensor, threshold,
                   name: str):
    """One ``centroid_assign`` launch over S slots: feats (S, B, D) against
    centroids (S, M, D) -> (S, B) outputs; no launch when S * B == 0."""
    _check_kernel_inputs(name, feats, centroids)
    S, B, D = feats.shape
    M = centroids.shape[1]
    if M == 0:
        raise ValueError(f"{name} needs at least one centroid")
    dev = feats.device
    min_d2 = torch.empty((S, B), dtype=torch.float32, device=dev)
    arg = torch.empty((S, B), dtype=torch.int32, device=dev)
    matched = torch.empty((S, B), dtype=torch.bool, device=dev)
    if S * B:
        if S > 65535:
            raise ValueError(f"{name}: S = {S} exceeds the kernel's 65535 "
                             f"blocks in z")
        t2 = (np.float32(np.inf) if threshold is None
              else np.float32(threshold) ** 2)          # squared in fp32
        # the in-launch merge's per-row keys and per-row-tile counters
        scratch = torch.empty((S * (8 * B + 4 * -(-B // CENTROID_ROWS)),),
                              dtype=torch.uint8, device=dev)
        err = build.load().centroid_assign_stacked_launch(
            feats.data_ptr(), centroids.data_ptr(), min_d2.data_ptr(),
            arg.data_ptr(), matched.data_ptr(), scratch.data_ptr(), S, B, M,
            D, float(t2), _stream(dev))
        _raise_on(err, name)
        LAUNCHES["centroid_assign"] += 1
    if threshold is None:
        return min_d2, arg
    return min_d2, arg, matched


def centroid_assign(feats: torch.Tensor, centroids: torch.Tensor,
                    threshold=None):
    """(B, D), (M, D) -> (min squared-L2 (B,) f32, argmin (B,) i32) and,
    with ``threshold``, the fused ``matched (B,) bool`` mask
    (``min_d2 <= threshold**2``, the square taken in fp32). Ties go to the
    lowest centroid index. One launch (after one memset of its merge
    keys) per call with B > 0."""
    _check_pair(feats, centroids, "feats/centroids")
    if feats.device.type == "cpu":
        return ref.centroid_assign_ref(feats, centroids, threshold)
    out = _assign_launch(feats[None], centroids[None], threshold,
                         "centroid_assign")
    return tuple(x[0] for x in out)


def centroid_assign_stacked(feats: torch.Tensor, centroids: torch.Tensor,
                            threshold=None):
    """(S, B, D), (S, M, D) -> (min_d2 (S, B) f32, argmin (S, B) i32[,
    matched (S, B) bool]): S independent ``centroid_assign`` problems, one
    per stream slot, feats[s] against centroids[s]. Every slot's outputs
    are bitwise those of ``centroid_assign(feats[s], centroids[s])``: the
    kernel runs each slot's body on the same tiles in the same order. One
    launch (after one memset) per call with S * B > 0, counted once under
    ``LAUNCHES["centroid_assign"]``."""
    if feats.dim() != 3 or centroids.dim() != 3 \
            or feats.shape[0] != centroids.shape[0] \
            or feats.shape[2] != centroids.shape[2]:
        raise ValueError(f"feats/centroids must be (S, B, D) and (S, M, D) "
                         f"with one S and D, got {tuple(feats.shape)} and "
                         f"{tuple(centroids.shape)}")
    if feats.device != centroids.device:
        raise ValueError(f"feats/centroids lie on {feats.device} and "
                         f"{centroids.device}")
    if feats.device.type == "cpu":
        return ref.centroid_assign_stacked_ref(feats, centroids, threshold)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    return _assign_launch(feats, centroids, threshold,
                          "centroid_assign_stacked")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _n_split(device: torch.device, Na: int, Nb: int) -> int:
    """Chunks of each row's range over ``blockIdx.y``: enough blocks for
    two per SM, but at least eight rows (one per warp) in a chunk of the
    widest possible range, ``Nb`` rows."""
    sms = _sm_count(device.index if device.index is not None
                    else torch.cuda.current_device())
    return max(1, min(-(-2 * sms // Na), -(-Nb // 8)))


def _pixel_match_launch(a, b, lo, hi, threshold):
    """One ``pixel_match`` launch; ``lo``/``hi`` None mean every row's
    range is all of ``b``."""
    Na, Nb = a.shape[0], b.shape[0]
    _check_kernel_inputs("pixel_match", a, b)
    D = a.shape[1]
    dev = a.device
    match = torch.empty((Na,), dtype=torch.int32, device=dev)
    min_d = torch.empty((Na,), dtype=torch.float32, device=dev)
    n_split = _n_split(dev, Na, Nb)
    # the in-launch merge's per-row keys and counters (12 bytes a row)
    scratch = (torch.empty((12 * Na,), dtype=torch.uint8, device=dev)
               if n_split > 1 else None)
    err = build.load().pixel_match_launch(
        a.data_ptr(), b.data_ptr(),
        lo.data_ptr() if lo is not None else None,
        hi.data_ptr() if hi is not None else None,
        match.data_ptr(), min_d.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        Na, Nb, D, n_split, float(np.float32(threshold)), _stream(dev))
    _raise_on(err, "pixel_match")
    LAUNCHES["pixel_match"] += 1
    return match, min_d


def pixel_match(a: torch.Tensor, b: torch.Tensor, threshold):
    """(Na, D), (Nb, D) -> (match (Na,) i32, min_d (Na,) f32).

    ``match[i]`` is the lowest index j minimizing ``mean |a_i - b_j|`` when
    that minimum is STRICTLY below ``threshold`` (a mean exactly at the
    threshold does not match), else -1. ``Na == 0`` or ``Nb == 0`` gives
    all -1 and ``inf`` without a launch: no references means nothing
    matches. The one-range case of ``pixel_match_ranges``: one launch."""
    _check_pair(a, b, "a/b")
    Na, Nb = a.shape[0], b.shape[0]
    if a.device.type == "cpu" or Na == 0 or Nb == 0:
        return ref.pixel_match_ref(a, b, threshold)
    return _pixel_match_launch(a, b, None, None, threshold)


def pixel_match_ranges(a: torch.Tensor, b: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, threshold):
    """(Na, D), (Nb, D), lo/hi (Na,) i32 -> (match (Na,) i32,
    min_d (Na,) f32).

    Row i searches only ``b[lo[i]:hi[i]]``: ``match[i]`` is the ABSOLUTE
    index of the lowest minimiser of ``mean |a_i - b_j|`` there when that
    minimum is strictly below ``threshold``, else -1; an empty range
    gives -1 and ``inf``. Ranges may overlap, and ``a`` may be a view into
    ``b``'s buffer. Ranges are clamped to ``[0, Nb)``, and ``hi <= lo`` is
    empty. One launch per call, counted under ``LAUNCHES["pixel_match"]``;
    the ranges stay on the device, unread."""
    _check_pair(a, b, "a/b")
    Na, Nb = a.shape[0], b.shape[0]
    for name, t in (("lo", lo), ("hi", hi)):
        if t.dtype != torch.int32 or tuple(t.shape) != (Na,):
            raise ValueError(f"{name} must be ({Na},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != a.device:
            raise ValueError(f"{name} lies on {t.device}, a on {a.device}")
    if a.device.type == "cpu":
        return ref.pixel_match_ranges_ref(a, b, lo, hi, threshold)
    if Na == 0 or Nb == 0:
        return ref.pixel_match_ref(a, b, threshold)     # nothing to launch
    if not (lo.is_contiguous() and hi.is_contiguous()):
        raise ValueError("pixel_match_ranges: lo and hi must be contiguous")
    return _pixel_match_launch(a, b, lo, hi, threshold)


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
                         f"{DEQUANT_MAX_C} columns (a row's key bytes in "
                         f"shared memory)")
    sg = float(np.float32(global_scale))
    err = build.load().dequant_topk_launch(
        q.data_ptr(), int(q.dtype == torch.int8), scales.data_ptr(), sg,
        vals.data_ptr(), idx.data_ptr(), M, C, k, _stream(dev))
    _raise_on(err, "dequant_topk")
    LAUNCHES["dequant_topk"] += 1
    return vals, idx


def topk(x: torch.Tensor, k: int):
    """x (B, C) f32 -> (values (B, k) f32, indices (B, k) i32), descending.

    Each row's k largest values with ties to the LOWEST column; the values
    are the input bits. ``k > C`` (or ``k < 1``) raises: there are only C
    columns to rank. ``B == 0`` gives empty outputs without a launch.
    Inputs must be 2-D float32 and hold no NaN."""
    if x.dim() != 2:
        raise ValueError(f"x must be (B, C), got {tuple(x.shape)}")
    B, C = x.shape
    if not 1 <= k <= C:
        raise ValueError(
            f"k must be in [1, C={C}], got {k}: the top-k of a (B, {C}) "
            f"matrix has at most {C} entries per row")
    if x.dtype != torch.float32:
        raise ValueError(f"topk takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return ref.topk_ref(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return vals, idx
    if not x.is_contiguous():
        raise ValueError("topk: the kernel takes contiguous rows")
    if C > TOPK_MAX_C:
        raise ValueError(f"topk: C={C} exceeds the kernel's {TOPK_MAX_C} "
                         f"columns (a row's keys in 128 KB of shared "
                         f"memory)")
    err = build.load().topk_launch(x.data_ptr(), vals.data_ptr(),
                                   idx.data_ptr(), B, C, k, _stream(dev))
    _raise_on(err, "topk")
    LAUNCHES["topk"] += 1
    return vals, idx


def motion_gate_frames(frames: torch.Tensor, bg: torch.Tensor, alpha,
                       threshold, *, tile: int = 8):
    """frames (N, H, W, 3) f32, bg (H, W, 3) f32 -> (new_bg (H, W, 3) f32,
    tiles (N, ty, tx) f32, hot (N, ty, tx) bool), ty = H // tile,
    tx = W // tile.

    N ``motion_gate`` steps in order, bit for bit, in one launch: frame
    n's tile means are taken against the background after frame n - 1
    (``bg`` for frame 0), and ``new_bg`` is the background after the last
    frame. ``N == 0`` gives a copy of ``bg`` and empty grids without a
    launch. ``alpha`` and ``threshold`` are taken as fp32 and passed by
    value: no host sync, no rebuild per value. One launch per call,
    counted under ``LAUNCHES["motion_gate"]``."""
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    if frames.dim() != 4 or frames.shape[3] != 3 or \
            frames.shape[1:] != bg.shape:
        raise ValueError(f"frames must be (N, H, W, 3) and bg (H, W, 3) of "
                         f"one H and W, got {tuple(frames.shape)} and "
                         f"{tuple(bg.shape)}")
    if frames.device != bg.device:
        raise ValueError(f"frames/bg lie on {frames.device} and "
                         f"{bg.device}")
    if frames.device.type == "cpu":
        return ref.motion_gate_frames_ref(frames, bg, alpha, threshold, tile)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    N, H, W = frames.shape[:3]
    ty, tx = H // tile, W // tile
    dev = frames.device
    tiles = torch.empty((N, ty, tx), dtype=torch.float32, device=dev)
    hot = torch.empty((N, ty, tx), dtype=torch.bool, device=dev)
    if N == 0:
        return bg.clone(), tiles, hot
    for t in (frames, bg):
        if t.dtype != torch.float32:
            raise ValueError(f"motion_gate: the kernel takes float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("motion_gate: the kernel takes contiguous "
                             "frames")
    if H == 0 or W == 0:
        raise ValueError(f"motion_gate: empty frame {tuple(bg.shape)}")
    if H * W * 3 >= 2 ** 31:
        raise ValueError(f"motion_gate: a frame of {H * W * 3} values "
                         f"exceeds the kernel's 32-bit offsets")
    new_bg = torch.empty_like(bg)
    err = build.load().motion_gate_launch(
        frames.data_ptr(), bg.data_ptr(), new_bg.data_ptr(),
        tiles.data_ptr(), hot.data_ptr(), N, H, W, tile,
        float(np.float32(alpha)), float(np.float32(threshold)), _stream(dev))
    _raise_on(err, "motion_gate")
    LAUNCHES["motion_gate"] += 1
    return new_bg, tiles, hot


def motion_gate(frame: torch.Tensor, bg: torch.Tensor, alpha, threshold, *,
                tile: int = 8):
    """frame/bg (H, W, 3) f32 -> (new_bg (H, W, 3) f32, tiles (ty, tx) f32,
    hot (ty, tx) bool) where ty = H // tile, tx = W // tile.

    One fused pass per frame: the EMA background update
    ``(1 - alpha) * bg + alpha * frame`` over EVERY pixel, remainder rows
    and columns included; the mean of ``|frame - bg|`` over each complete
    (tile, tile) tile and its 3 channels; and the strict
    ``tiles > threshold`` hot mask. A frame smaller than one tile still
    launches (the EMA only) and gives an empty tile grid. The N = 1 case
    of ``motion_gate_frames``: one launch."""
    if frame.dim() != 3 or frame.shape[2] != 3 or frame.shape != bg.shape:
        raise ValueError(f"frame and bg must both be (H, W, 3), got "
                         f"{tuple(frame.shape)} and {tuple(bg.shape)}")
    new_bg, tiles, hot = motion_gate_frames(frame[None], bg, alpha,
                                            threshold, tile=tile)
    return new_bg, tiles[0], hot[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v (B, S, H, dh) -> (B, S, H, dh): softmax attention with an
    online softmax over KV tiles, fp32 inside, q's dtype out; ``causal``
    masks the columns past each row. Any S >= 1; grouped KV heads are
    repeated to H by the caller, as the JAX package's attention does.

    The kernel reads the (B, S, H, dh) layout through its row stride
    ``H * dh`` instead of transposing to (B*H, S, dh) as the JAX package's
    wrapper does; the plain version keeps JAX's layout. The kernel takes
    contiguous float32 or bfloat16 tensors of one dtype with dh in
    ``FLASH_HEAD_DIMS``; bfloat16 ones must start on 16 bytes (it copies
    rows in 16-byte pieces)."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must all be (B, S, H, dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, "
                         f"{v.device}")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not \
            q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention: the kernel takes float32 or "
                         f"bfloat16 of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    B, S, H, dh = q.shape
    if dh not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} not in "
                         f"{FLASH_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: the kernel takes contiguous "
                         "(B, S, H, dh) tensors")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                          for t in (q, k, v)):
        raise ValueError("flash_attention: bfloat16 q, k, v must start on "
                         "16 bytes")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H = {B * H} exceeds the "
                         f"kernel's 65535 blocks in y")
    scale = float(np.float32(1.0 / dh ** 0.5))
    err = build.load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        dh, int(q.dtype == torch.bfloat16), int(causal), scale,
        _stream(q.device))
    _raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
