"""Crop pixel differencing (paper §4.2 "Pixel Differencing of Objects") and
background subtraction (§6.1).

``match_flat`` (one range: all references) and ``match_ranges`` (a range
of references per crop) are the matchers behind the streaming redundancy
gate and the §4.2 frame-to-frame tracker. Both run the one ``pixel_match``
Hopper kernel on ``device="cuda"`` and its plain version on
``device="cpu"``, so the two agree bit for bit.

``BackgroundSubtractor`` excludes frames and regions with no moving
objects. The paper uses OpenCV MOG2; here an exponential-moving-average
background model plus connected components on a grid of hot tiles. The
background model stays on ``device`` between frames; each frame is
uploaded once, the ``motion_gate`` Hopper kernel (its plain version on
the CPU) updates the model and labels the hot tiles in one pass, and only
the (H/t, W/t) hot mask comes back to the host for the components.
``process`` does the same for a sequence of frames a window at a time:
one upload, one launch and one mask read per window.
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple

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
    # focuslint: disable=host-sync -- gate decision is consumed by host
    # control flow; match_flat returns numpy by contract
    return m.cpu().numpy().astype(np.int64)


def match_ranges(rows: np.ndarray, n_ref: int, lo: np.ndarray,
                 hi: np.ndarray, threshold: float,
                 device: DeviceLike = "cuda") -> np.ndarray:
    """Ranged matcher over one buffer: rows (N, D), crops ``rows[n_ref:]``
    -> (N - n_ref,) int64 indices into ``rows``.

    Crop i is matched against ``rows[lo[i]:hi[i]]`` only (an empty range
    matches nothing): ``out[i]`` is the lowest index there minimizing
    ``mean |crop_i - rows_j|`` when that minimum is STRICTLY below
    ``threshold``, else -1. ``rows`` is uploaded once, the crops are a
    view into it, and the match indices come back in one read: one kernel
    launch for the whole buffer."""
    dev = resolve_device(device)
    bt = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(dev)
    bounds = torch.from_numpy(np.stack([lo, hi]).astype(np.int32)).to(dev)
    m, _ = ops.pixel_match_ranges(bt[n_ref:], bt, bounds[0], bounds[1],
                                  threshold)
    # focuslint: disable=host-sync -- the tracker's matches, one read per
    # window; match_ranges returns numpy by contract
    return m.cpu().numpy().astype(np.int64)


class MotionBox(NamedTuple):
    y0: int
    x0: int
    y1: int
    x1: int


class BackgroundSubtractor:
    """EMA background model + hot-tile connected components.

    ``__call__(frame)`` runs one ``hopper.ops.motion_gate`` pass per frame
    after the first: the kernel on ``device="cuda"``, its plain version on
    ``device="cpu"``; both give the same boxes and the same background bit
    for bit. ``process(frames)`` gives what ``[self(f) for f in frames]``
    gives, with one ``motion_gate_frames`` launch per window of frames.
    """

    # frame bytes per window of ``process``: 341 frames of 128 x 128 x 3
    # fp32, 6 of 720p
    WINDOW_BYTES = 64 << 20

    def __init__(self, alpha: float = 0.05, threshold: float = 0.08,
                 tile: int = 8, min_tiles: int = 4,
                 device: DeviceLike = "cuda"):
        if tile < 1:
            raise ValueError(f"tile must be >= 1, got {tile}")
        self.alpha = alpha
        self.threshold = threshold
        self.tile = tile
        self.min_tiles = min_tiles
        self.device = resolve_device(device)
        self._bg = None                      # (H, W, 3) f32 on the device

    def __call__(self, frame: np.ndarray) -> List[MotionBox]:
        """frame (H, W, 3) float32 -> motion bounding boxes (possibly []).

        Edge cases are defined: the first frame seeds the background and
        yields []; frames smaller than one tile (ty == 0 or tx == 0)
        still update the background but yield []; a constant (all-static)
        stream yields [] on every frame; non-multiple-of-tile resolutions
        label complete tiles only (remainder rows/cols belong to no tile
        but still update the background model).
        """
        f = self._upload(frame)
        if self._bg is None:
            self._bg = f.clone()
            return []
        return self._boxes(self._step(f))

    def process(self, frames: Iterable[np.ndarray]) -> List[List[MotionBox]]:
        """frames: a sequence (or iterator) of (H, W, 3) float32 frames ->
        one box list per frame, equal to ``[self(f) for f in frames]``,
        the background included bit for bit.

        After the first frame of a fresh subtractor (which seeds the
        background, as in ``__call__``), the frames go in windows of
        ``WINDOW_BYTES``: each window is stacked into one host buffer,
        uploaded once, gated by one ``ops.motion_gate_frames`` launch, and
        its hot masks come back in one copy; the components then run per
        frame on the host. A frame of another shape than the background
        raises ``ValueError``, as in ``__call__``."""
        out: List[List[MotionBox]] = []
        window: List[np.ndarray] = []
        per = 1
        for frame in frames:
            if self._bg is None:
                out.append(self(frame))
                continue
            if not window:
                per = max(1, self.WINDOW_BYTES // max(1, frame.size * 4))
            window.append(frame)
            if len(window) == per:
                out.extend(self._window(window))
                window = []
        if window:
            out.extend(self._window(window))
        return out

    @property
    def background(self) -> np.ndarray:
        """The background model as a host (H, W, 3) float32 array."""
        return self._bg.cpu().numpy()

    def _upload(self, frames) -> torch.Tensor:
        """One frame or a window (a numpy array, or a host tensor) to the
        device in one copy."""
        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.ascontiguousarray(frames, np.float32))
        return frames.to(self.device)

    def _step(self, f: torch.Tensor) -> np.ndarray:
        """One EMA + tile-diff pass; replaces ``self._bg`` and returns the
        (ty, tx) hot mask on the host."""
        self._bg, _, hot = ops.motion_gate(f, self._bg, self.alpha,
                                           self.threshold, tile=self.tile)
        # focuslint: disable=host-sync -- per-frame gate: hot tiles feed
        # host connected-components
        return hot.cpu().numpy()

    def _steps(self, fw: torch.Tensor) -> np.ndarray:
        """A window (n, H, W, 3) in one pass; replaces ``self._bg`` and
        returns the (n, ty, tx) hot masks on the host in one copy."""
        self._bg, _, hot = ops.motion_gate_frames(
            fw, self._bg, self.alpha, self.threshold, tile=self.tile)
        # focuslint: disable=host-sync -- the window's hot tiles feed host
        # connected-components, one copy a window
        return hot.cpu().numpy()

    def _window(self, window: List[np.ndarray]) -> List[List[MotionBox]]:
        """One window: stacked into one host buffer (page-locked when the
        background lives on the card, so the upload is one direct copy;
        PyTorch's pinned-memory cache hands the same buffer to the next
        window), gated in one launch, its masks read back in one copy."""
        buf = torch.empty((len(window), *np.shape(window[0])),
                          dtype=torch.float32,
                          pin_memory=self.device.type == "cuda")
        np.stack(window, out=buf.numpy())
        hot = self._steps(self._upload(buf))
        return [self._boxes(h) for h in hot]

    def _boxes(self, hot: np.ndarray) -> List[MotionBox]:
        """The boxes of one (ty, tx) hot mask with at least ``min_tiles``
        tiles' area."""
        if hot.size == 0 or not hot.any():
            return []
        t = self.tile
        return [b for b in self._components(hot)
                if (b.y1 - b.y0) * (b.x1 - b.x0) >= self.min_tiles * t * t]

    def _components(self, hot: np.ndarray) -> List[MotionBox]:
        """Connected components on the tile grid (4-neighbor).

        Vectorized iterative min-label propagation: every hot tile starts
        labeled with its flat index, and each sweep takes the min over
        the 4-neighborhood (cold tiles pinned to a sentinel so they never
        bridge components). Converges in O(grid diameter) whole-grid numpy
        ops instead of a per-tile Python BFS. The surviving label of a
        component is its minimum flat index — its first tile in row-major
        order — so boxes come out in the same order the BFS produced.
        """
        t = self.tile
        ty, tx = hot.shape
        sentinel = ty * tx
        lab = np.where(hot, np.arange(ty * tx).reshape(ty, tx), sentinel)
        while True:
            nxt = lab.copy()
            nxt[1:] = np.minimum(nxt[1:], lab[:-1])
            nxt[:-1] = np.minimum(nxt[:-1], lab[1:])
            nxt[:, 1:] = np.minimum(nxt[:, 1:], lab[:, :-1])
            nxt[:, :-1] = np.minimum(nxt[:, :-1], lab[:, 1:])
            nxt[~hot] = sentinel
            if np.array_equal(nxt, lab):
                break
            lab = nxt
        boxes = []
        for root in np.unique(lab[hot]):
            ys, xs = np.nonzero(lab == root)
            boxes.append(MotionBox(ys.min() * t, xs.min() * t,
                                   (ys.max() + 1) * t, (xs.max() + 1) * t))
        # np.unique sorts by flat index == first-encounter order of the
        # row-major scan, matching the BFS reference's box order
        return boxes

    def _components_bfs(self, hot: np.ndarray) -> List[MotionBox]:
        """Reference 4-neighbor BFS (kept as the test oracle)."""
        t = self.tile
        ty, tx = hot.shape
        seen = np.zeros_like(hot, bool)
        boxes = []
        for i in range(ty):
            for j in range(tx):
                if not hot[i, j] or seen[i, j]:
                    continue
                stack = [(i, j)]
                seen[i, j] = True
                ys, xs = [i], [j]
                while stack:
                    a, b = stack.pop()
                    for da, db in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                        na, nb = a + da, b + db
                        if 0 <= na < ty and 0 <= nb < tx and hot[na, nb] \
                                and not seen[na, nb]:
                            seen[na, nb] = True
                            stack.append((na, nb))
                            ys.append(na)
                            xs.append(nb)
                boxes.append(MotionBox(min(ys) * t, min(xs) * t,
                                       (max(ys) + 1) * t, (max(xs) + 1) * t))
        return boxes


def extract_crops(frame: np.ndarray, boxes: List[MotionBox],
                  obj_res: int) -> np.ndarray:
    """Crop + nearest-resize each motion box to (obj_res, obj_res, 3)."""
    crops = []
    for b in boxes:
        patch = frame[b.y0:b.y1, b.x0:b.x1]
        h, w = patch.shape[:2]
        yi = (np.arange(obj_res) * h // obj_res).clip(0, h - 1)
        xi = (np.arange(obj_res) * w // obj_res).clip(0, w - 1)
        crops.append(patch[yi][:, xi])
    return (np.stack(crops) if crops
            else np.zeros((0, obj_res, obj_res, 3), np.float32))
