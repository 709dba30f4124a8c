"""Focus query-time pipeline (paper Fig. 4, right; §4.2, §5).

query(class X) -> top-K index lookup -> GT-CNN on cluster *centroids only*
               -> keep clusters whose centroid classifies as X
               -> return all member frames of kept clusters

Also provides the two baseline cost models the paper compares against
(Ingest-all / Query-all, both strengthened with motion detection) and the
frame-level precision/recall metrics relative to GT-CNN ground truth.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.index import OTHER, TopKIndex


@dataclass
class QueryResult:
    queried_class: int
    frames: np.ndarray                 # frame ids returned to the user
    matched_clusters: List[int]
    n_candidate_clusters: int
    n_gt_invocations: int
    gt_flops: float
    wall_s: float


def pad_to_bucket(crops: np.ndarray, bucket: int = 64) -> np.ndarray:
    """Zero-pad the leading axis up to the next multiple of ``bucket`` (the
    same shape-bucketing ``SpecializedModel.make_apply`` uses), so a jitted
    GT-CNN sees O(batch/bucket) distinct shapes instead of recompiling on
    every ragged final chunk."""
    pad = (-len(crops)) % bucket
    if pad:
        crops = np.concatenate(
            [crops, np.zeros((pad,) + crops.shape[1:], crops.dtype)])
    return crops


def query(index: TopKIndex, global_class: int,
          gt_apply: Callable[[np.ndarray], np.ndarray],
          gt_flops_per_image: float, Kx: Optional[int] = None,
          batch_size: int = 256, batch_pad: int = 64) -> QueryResult:
    """gt_apply(crops (B,R,R,3)) -> predicted *global* class ids (B,)."""
    t0 = time.perf_counter()
    cids = index.lookup(global_class, Kx)
    matched: List[int] = []
    n_gt = 0
    for start in range(0, len(cids), batch_size):
        chunk = np.asarray(cids[start:start + batch_size])
        padded = pad_to_bucket(index.rep_crops(chunk), batch_pad)
        labels = np.asarray(gt_apply(padded))[:len(chunk)]
        n_gt += len(chunk)                 # only real crops are accounted
        matched.extend(chunk[labels == global_class].tolist())
    frames = index.frames_of(matched)
    return QueryResult(
        queried_class=global_class, frames=frames, matched_clusters=matched,
        n_candidate_clusters=len(cids), n_gt_invocations=n_gt,
        gt_flops=n_gt * gt_flops_per_image,
        wall_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Ground truth + metrics (frame-level, GT-CNN as oracle — §6.1)
# ---------------------------------------------------------------------------

def gt_frames_by_class(gt_labels: np.ndarray,
                       frames: np.ndarray) -> Dict[int, np.ndarray]:
    """For each class, the sorted frame ids where GT-CNN saw that class —
    one lexsort over (label, frame) pairs, no per-object Python loop."""
    gt_labels = np.asarray(gt_labels, np.int64)
    frames = np.asarray(frames, np.int64)
    if len(gt_labels) == 0:
        return {}
    order = np.lexsort((frames, gt_labels))
    labs, fs = gt_labels[order], frames[order]
    keep = np.ones(len(labs), bool)         # drop duplicate (label, frame)
    keep[1:] = (labs[1:] != labs[:-1]) | (fs[1:] != fs[:-1])
    labs, fs = labs[keep], fs[keep]
    starts = np.nonzero(np.r_[True, labs[1:] != labs[:-1]])[0]
    bounds = np.r_[starts, len(labs)]
    return {int(labs[starts[i]]): fs[bounds[i]:bounds[i + 1]]
            for i in range(len(starts))}


def precision_recall(result_frames: np.ndarray,
                     gt_frames: np.ndarray) -> tuple:
    rs, gs = set(result_frames.tolist()), set(gt_frames.tolist())
    tp = len(rs & gs)
    precision = tp / len(rs) if rs else 1.0
    recall = tp / len(gs) if gs else 1.0
    return precision, recall


def dominant_classes(gt_labels: np.ndarray, top_frac: float = 0.95,
                     max_classes: int = 20) -> List[int]:
    """The most frequent classes covering ``top_frac`` of objects (§6.1
    evaluates all dominant classes of each stream)."""
    vals, counts = np.unique(gt_labels, return_counts=True)
    order = np.argsort(-counts)
    cum = np.cumsum(counts[order]) / counts.sum()
    cut = int(np.searchsorted(cum, top_frac)) + 1
    return [int(v) for v in vals[order[:min(cut, max_classes)]]]


# ---------------------------------------------------------------------------
# Baseline cost models (paper §6.1 Baselines)
# ---------------------------------------------------------------------------

@dataclass
class BaselineCosts:
    """Costs in FLOPs (device-independent) for the two baselines.

    Both are strengthened with motion detection: only frames with moving
    objects are processed (the n_objects stream is already post-detection).
    """
    n_objects: int
    gt_flops_per_image: float

    @property
    def ingest_all_flops(self) -> float:    # GT-CNN on everything at ingest
        return self.n_objects * self.gt_flops_per_image

    @property
    def query_all_flops(self) -> float:     # GT-CNN on everything at query
        return self.n_objects * self.gt_flops_per_image


def gpu_seconds(flops: float, peak_flops: float = 6.1e12,
                utilization: float = 0.35) -> float:
    """Convert model FLOPs to GPU-seconds on the paper's GTX Titan X
    (~6.1 TFLOP/s fp32, ~35% achieved utilization on CNN inference)."""
    return flops / (peak_flops * utilization)
