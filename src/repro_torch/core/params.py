"""Focus parameter selection (paper §4.4).

Sweeps (CheapCNN_i, K, T) per stream against GT-CNN ground truth on a
sample, keeps configurations meeting the precision/recall targets, draws the
Pareto boundary over (ingest cost, query latency), and picks:
    Balance     — min (ingest + query) total GPU cost   [default]
    Opt-Ingest  — cheapest ingest among viable configs
    Opt-Query   — fastest query among viable configs

Two-step search exactly as §4.4: (CheapCNN_i, Ls, K) are chosen against the
recall target first; T is then tightened until precision passes.

A numpy copy of ``repro.core.params``; only ``sweep`` touches the card,
through ``ingest(..., device=)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common.device import DeviceLike
from repro_torch.core.engine import QueryEngine
from repro_torch.core.query import (dominant_classes, gt_frames_by_class,
                                    precision_recall)
from repro_torch.core.ingest import IngestConfig, ingest


@dataclass(frozen=True)
class Candidate:
    model_id: str
    K: int
    T: float


@dataclass
class ConfigEval:
    candidate: Candidate
    precision: float
    recall: float
    ingest_flops: float
    query_flops: float           # avg over dominant classes (latency proxy)
    n_clusters: int
    viable: bool = False

    def cost_tuple(self) -> Tuple[float, float]:
        return (self.ingest_flops, self.query_flops)


def _simulate_queries(engine: QueryEngine, gt_by_class: Dict[int, np.ndarray],
                      classes: Sequence[int], Kx: int, gt_flops: float):
    """P/R + query cost for each dominant class, served through the batched
    engine in oracle mode (rep object's gt label IS what GT-CNN would
    output, by the paper's definition of ground truth). The engine's label
    cache persists across calls, so sweeping the K grid verifies each
    cluster once instead of once per K.

    ``query_flops`` stays the *cold* cost model — what one standalone query
    of this class would pay (candidates × GT FLOPs) — since it is the
    paper's query-latency proxy, independent of sweep-internal caching.
    """
    results, _ = engine.query_many(classes, Kx)
    ps, rs, costs = [], [], []
    for x, res in zip(classes, results):
        p, r = precision_recall(res.frames,
                                gt_by_class.get(int(x), np.array([])))
        ps.append(p)
        rs.append(r)
        costs.append(res.n_candidate_clusters * gt_flops)
    return float(np.mean(ps)), float(np.mean(rs)), float(np.mean(costs))


def sweep(crops: np.ndarray, frames: np.ndarray, gt_labels: np.ndarray,
          cheap_models: Dict[str, Tuple[Callable, float]],
          Ks: Sequence[int], Ts: Sequence[float], gt_flops: float,
          precision_target: float = 0.95, recall_target: float = 0.95,
          max_clusters: int = 4096, batch_size: int = 512,
          class_maps: Optional[Dict[str, object]] = None,
          device: DeviceLike = "cuda",
          ) -> List[ConfigEval]:
    """cheap_models: model_id -> (apply_fn, flops_per_image). Each (model,
    T) pair ingests once on ``device`` at the largest K; the K grid is
    read from that index."""
    evals: List[ConfigEval] = []
    dom = dominant_classes(gt_labels)
    gt_by_class = gt_frames_by_class(gt_labels, frames)
    Kmax = max(Ks)
    for mid, (apply_fn, flops) in cheap_models.items():
        cmap = (class_maps or {}).get(mid)
        for T in Ts:
            cfg = IngestConfig(K=Kmax, threshold=T,
                               max_clusters=max_clusters,
                               batch_size=batch_size)
            index, stats = ingest(crops, frames, apply_fn, flops, cfg,
                                  class_map=cmap, device=device)
            engine = QueryEngine(index, oracle_labels=gt_labels,
                                 gt_flops_per_image=gt_flops)
            for K in Ks:
                p, r, qcost = _simulate_queries(engine, gt_by_class,
                                                dom, K, gt_flops)
                evals.append(ConfigEval(
                    Candidate(mid, K, T), precision=p, recall=r,
                    ingest_flops=stats.cheap_flops, query_flops=qcost,
                    n_clusters=index.n_clusters,
                    viable=(p >= precision_target and r >= recall_target)))
    return evals


@dataclass(frozen=True)
class SamplerConfig:
    """Knobs for the per-stream adaptive frame sampler (DESIGN.md §10)."""
    min_stride: int = 1
    max_stride: int = 30
    # duplicate-rate hysteresis band: raise the stride above ``high``,
    # lower it below ``low``, hold inside the band
    dup_high: float = 0.80
    dup_low: float = 0.50
    recall_floor: float = 0.97      # the recall gate


class AdaptiveSampler:
    """AIMD frame-stride controller driven by observed redundancy.

    Each ``observe`` window reports how many objects the gate/tracker
    skipped vs. ingested. A high duplicate rate means the stream is
    redundant — the stride *additively* increases (+1), spending less on
    near-identical frames. A low rate means content is changing — the
    stride *multiplicatively* halves, the classic AIMD asymmetry: probe
    savings slowly, give them back fast.

    The recall gate overrides everything: when a probe measures recall
    against ungated ingest below ``recall_floor``, the stride collapses
    to ``min_stride`` immediately — throughput is never bought with
    recall. The caller wires the output to
    ``StreamingIngestor.set_frame_stride``.
    """

    def __init__(self, cfg: SamplerConfig = SamplerConfig()):
        if cfg.min_stride < 1 or cfg.max_stride < cfg.min_stride:
            raise ValueError(f"bad stride bounds: {cfg}")
        if not 0.0 <= cfg.dup_low <= cfg.dup_high <= 1.0:
            raise ValueError(f"bad duplicate-rate band: {cfg}")
        self.cfg = cfg
        self.stride = cfg.min_stride

    def observe(self, n_ingested: int, n_skipped: int,
                recall: Optional[float] = None,
                n_sampled_out: int = 0) -> int:
        """One control step; returns the stride for the next window.

        ``n_ingested`` — objects that reached the CNN this window;
        ``n_skipped`` — objects the tracker/gate deduplicated *among
        those that survived the stride filter*;
        ``n_sampled_out`` — objects the frame stride itself dropped.
        They are excluded from the duplicate rate: at stride S the stride
        removes >= (S-1)/S of the window regardless of content, so
        counting them as "skipped" is a positive feedback loop — the
        controller's own stride manufactures the redundancy signal that
        raises the stride, ratcheting to ``max_stride`` until the recall
        probe collapses it and the loop starts over (oscillation instead
        of convergence). Only gate/tracker skips measure content
        redundancy, and they naturally fall as the stride widens past the
        stream's temporal-correlation window — the negative feedback that
        makes AIMD settle.
        ``recall`` — optional probe of gated recall vs. ungated ingest.
        """
        c = self.cfg
        if recall is not None and recall < c.recall_floor:
            self.stride = c.min_stride
            return self.stride
        del n_sampled_out                  # accepted, never a control input
        total = n_ingested + n_skipped
        if total <= 0:
            return self.stride
        dup_rate = n_skipped / total
        if dup_rate > c.dup_high:
            self.stride = min(self.stride + 1, c.max_stride)
        elif dup_rate < c.dup_low:
            self.stride = max(self.stride // 2, c.min_stride)
        return self.stride


def pareto_boundary(evals: Sequence[ConfigEval]) -> List[ConfigEval]:
    """Non-dominated (ingest, query) points among viable configs."""
    viable = [e for e in evals if e.viable]
    out = []
    for e in viable:
        dominated = any(
            (o.ingest_flops <= e.ingest_flops
             and o.query_flops <= e.query_flops
             and (o.ingest_flops < e.ingest_flops
                  or o.query_flops < e.query_flops))
            for o in viable)
        if not dominated:
            out.append(e)
    return sorted(out, key=lambda e: e.ingest_flops)


def select(evals: Sequence[ConfigEval], policy: str = "balance",
           ) -> Optional[ConfigEval]:
    front = pareto_boundary(evals)
    if not front:
        return None
    if policy == "balance":     # min total GPU cycles (§4.4)
        return min(front, key=lambda e: e.ingest_flops + e.query_flops)
    if policy == "opt_ingest":
        return min(front, key=lambda e: (e.ingest_flops, e.query_flops))
    if policy == "opt_query":
        return min(front, key=lambda e: (e.query_flops, e.ingest_flops))
    raise ValueError(policy)
