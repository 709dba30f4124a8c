"""Focus ingest-time pipeline (paper Fig. 4, left; §4.1-§4.3).

detected objects -> pixel-diff dedup -> cheap CNN (top-K probs + features)
                 -> incremental clustering -> top-K index

Pixel differencing and clustering run on ``device`` (the Hopper kernels
on ``"cuda"``); cluster bookkeeping (member lists, frame ids, eviction) is
host-side and batched through the SoA ``ClusterStore``.

The chunk-step itself (CNN batch -> clustering -> slot/cid bookkeeping ->
index fold -> eviction) lives in ``core.streaming.StreamingIngestor``;
``ingest()`` is the one-shot wrapper feeding a single chunk.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.common.device import DeviceLike
from repro_torch.core.index import ClassMap, TopKIndex


@dataclass(frozen=True)
class IngestConfig:
    K: int = 10
    threshold: float = 0.8          # clustering distance T (L2)
    max_clusters: int = 4096        # M
    batch_size: int = 512
    pixel_diff: bool = True
    pixel_diff_threshold: float = 0.02
    evict_frac: float = 0.25
    high_water: float = 0.95        # evict when n >= high_water * M
    clustering: str = "fused"       # "scan" | "batched" | "fused"
    # redundancy gate: match CNN-bound uniques against a ring of recent
    # uniques from earlier frames; hits skip the CNN and attach to their
    # ring root's cluster
    gate: bool = False
    gate_threshold: float = 0.02
    gate_capacity: int = 512        # ring size (recent CNN-bound uniques)
    # keep only frames with frame_id % frame_stride == 0 (absolute grid,
    # so the kept set is a function of the stream alone, never chunking)
    frame_stride: int = 1


@dataclass
class IngestStats:
    n_objects: int = 0
    n_cnn_invocations: int = 0
    n_pixel_dedup: int = 0          # §4.2 prev-frame tracker matches
    n_gate_skipped: int = 0         # redundancy-gate ring matches
    n_sampled_out: int = 0          # dropped by the frame stride
    cheap_flops: float = 0.0
    n_evictions: int = 0
    wall_s: float = 0.0


def pixel_tracks(crops: np.ndarray, frames: np.ndarray, threshold: float,
                 device: DeviceLike = "cuda") -> np.ndarray:
    """Root object id per object under §4.2 pixel differencing.

    Objects in frame t whose pixels nearly match an object in frame t-1
    join that object's track (and will share its cluster) without a CNN
    pass. Thin one-shot view over the streaming ``_PixelTracker`` — the
    same code path ingest uses.
    """
    from repro_torch.core.streaming import _PixelTracker
    n = len(crops)
    roots = np.arange(n)
    if n == 0:
        return roots
    order = np.argsort(frames, kind="stable")
    tracker = _PixelTracker(threshold, device)
    i = 0
    while i < n:
        f = int(frames[order[i]])
        j = i
        while j < n and frames[order[j]] == f:
            j += 1
        ids = order[i:j]
        roots[ids] = tracker.resolve(f, crops[ids], ids.astype(np.int64))
        i = j
    return roots


def ingest(crops: np.ndarray, frames: np.ndarray,
           cheap_apply: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]],
           cheap_flops_per_image: float, cfg: IngestConfig,
           class_map: Optional[ClassMap] = None,
           n_local_classes: Optional[int] = None,
           device: DeviceLike = "cuda") -> Tuple[TopKIndex, IngestStats]:
    """Build the top-K index for a stream of detected objects — the
    one-shot (single-chunk) wrapper over ``streaming.StreamingIngestor``.

    cheap_apply(crops (B,R,R,3)) -> (probs (B, C_local), feats (B, D)), as
    numpy. Objects are processed in (stable) frame order, and a chunked
    ``StreamingIngestor`` run over the same stream saves a byte-identical
    index.
    """
    from repro_torch.core.streaming import StreamingIngestor
    ing = StreamingIngestor(cheap_apply, cheap_flops_per_image, cfg,
                            class_map=class_map,
                            n_local_classes=n_local_classes, device=device)
    ing.feed(np.asarray(crops), np.asarray(frames, np.int64))
    return ing.finish()
