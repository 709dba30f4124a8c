"""Crop pixel differencing (paper §4.2 "Pixel Differencing of Objects").

``match_flat`` is the one matcher behind both the §4.2 frame-to-frame
tracker and the streaming redundancy gate, so the two agree bit for bit.
On ``device="cuda"`` it runs the ``pixel_match`` Hopper kernel; on
``device="cpu"`` the kernel's plain version. Background subtraction
(``BackgroundSubtractor`` and its ``motion_gate`` kernel) is not ported
yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.hopper import ops


def match_flat(a: np.ndarray, b: np.ndarray, threshold: float,
               device: DeviceLike = "cuda") -> np.ndarray:
    """Flattened-crop matcher: a (Na, D), b (Nb, D) -> (Na,) int64.

    ``out[i]`` is the lowest index j minimizing ``mean |a_i - b_j|`` when
    that minimum is STRICTLY below ``threshold`` (a diff exactly at the
    threshold does NOT match), else -1.
    """
    Na, Nb = len(a), len(b)
    if Na == 0 or Nb == 0:
        return np.full((Na,), -1, np.int64)
    dev = resolve_device(device)
    at = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    bt = torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(dev)
    m, _ = ops.pixel_match(at, bt, threshold)
    return m.cpu().numpy().astype(np.int64)


def pixel_difference(crops_a: np.ndarray, crops_b: np.ndarray,
                     threshold: float = 0.02,
                     device: DeviceLike = "cuda") -> np.ndarray:
    """Pairwise mean-abs-diff of current crops vs. the previous frame's
    crops; returns for each crop in ``crops_a`` the index of a
    near-identical crop in ``crops_b`` or -1.

    A crop matches only when its best mean-abs-diff is STRICTLY below
    ``threshold`` (``< threshold``, not ``<=``); ties between equally
    close references resolve to the lowest index.
    """
    return match_flat(
        np.asarray(crops_a, np.float32).reshape(len(crops_a), -1),
        np.asarray(crops_b, np.float32).reshape(len(crops_b), -1),
        threshold, device=device)
