"""Fused ingest megastep with double buffering (DESIGN.md §9).

The staged ingest hot path runs the cheap-CNN forward, copies probs and
feats to the host, and hands them to clustering, which uploads the feats
again. ``IngestPipeline`` keeps the batch on the device from the crops'
upload to the clustering state::

    crops ──► cheap-CNN forward ──► probs ──► topk kernel ──► (vals, idxs)
                     │
                     └► feats ──► centroid_assign kernel (phase 1)
                                        │
                                        └► matched fold, unmatched tail
                                           (ClusterState stays on device)

Only the small per-batch outputs come back to the host: the assignment
vector ``j``/``matched`` (slot → cid bookkeeping, the unmatched tail), the
top-K values/indices, and the ``probs``/``feats`` rows for the SoA index
fold. The megastep's launches are one dispatch and the sequential tail
over the *unmatched* rows is the only other, so a batch costs at most 2
dispatches.

Double buffering: ``submit`` queues batch N's megastep *before*
host-folding batch N-1's rows into the ``TopKIndex``, so the card runs
N's forward while the host does N-1's numpy bookkeeping. Every
device-to-host copy is queued without blocking into pinned host memory
right after the launches it reads, and an event recorded behind it tells
when it has landed: waiting for batch N-1's rows then waits only for the
work queued before them, never for batch N's (a plain ``.cpu()`` would
wait for everything on the stream). The host reads ``state.n`` only when
an upper bound (live clusters + cumulative unmatched rows) says eviction
*might* be due.

Numerics contract (pinned by ``tests/test_torch_pipeline.py``): a
pipeline-driven ``StreamingIngestor`` saves a byte-identical index (and
identical ``IngestStats`` counters) to the host-staged path over the same
stream, chunking, eviction and shard-rollover boundaries. The megastep
calls the *same* functions the staged path calls (the forward at the
same ``batch_bucket`` shape, ``hops.topk``, ``clustering._phase1``,
``_fold_matched`` and ``_scan_unmatched``), so per-row values agree bit
for bit. One order differs from the JAX package: the port's
``_fold_matched`` groups rows by cluster on the host so that its sum runs
in a fixed order, so the megastep fetches ``(j, matched)`` before the
matched fold rather than after it. It is still the one per-batch fetch.

Without a JIT there is nothing to donate and no trace cache: the JAX
package's buffer donation and ``jit_cache_entries`` have no counterpart
here. ``compile_hits``/``compile_misses`` (and their tail twins) still
count new (bucket, resolution) keys: the shapes the forward and the
kernels meet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import clustering as C
from repro_torch.hopper import ops as hops


def batch_bucket(n: int, batch_size: int) -> int:
    """Shape bucket for a batch of ``n`` crops.

    Full batches (``n >= batch_size`` — ``StreamingIngestor``
    ready batches are exactly ``batch_size``) map to themselves; ragged
    tail batches round up to the next power of two (min 8, capped at
    ``batch_size``), so the forward meets few distinct shapes — and the
    staged path, padded the same way, meets the same ones.
    """
    if n >= batch_size:
        return n
    return min(C._pad_bucket(n), batch_size)


def _pad_rows(arr: np.ndarray, bucket: int) -> np.ndarray:
    n = len(arr)
    if n == bucket:
        return arr
    return np.concatenate(
        [arr, np.zeros((bucket - n,) + arr.shape[1:], arr.dtype)])


def _to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Upload host rows. On the card they go through pinned memory without
    blocking, so the copy queues behind the stream's work instead of
    waiting for it."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _to_host(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Queue a copy of ``t`` to the host. On the card it lands in pinned
    memory without blocking (a copy into pageable memory would block), so
    it waits only for the work queued before it; on the CPU ``t`` is
    already there."""
    if t is None or t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _record(dev: torch.device):
    """An event behind everything queued so far (None on the CPU)."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def _widths(forward: Callable, crop_shape: tuple,
            dev: torch.device) -> Tuple[int, int]:
    """(classes, feature width) of ``forward``, from one call on 8 zero
    crops: a shape probe, which no stats count."""
    probs, feats = forward(torch.zeros((8,) + tuple(crop_shape),
                                       dtype=torch.float32, device=dev))
    return probs.shape[1], feats.shape[1]


def staged_cheap_apply(forward: Callable, cfg,
                       device: DeviceLike = "cuda") -> Callable:
    """Host-staged reference wrapper over a tensor-level ``forward``
    (``models.cnn.make_forward``): the forward on ``device`` with the SAME
    ``batch_bucket`` padding the pipeline uses, returning numpy ``(probs,
    feats)``. This is the baseline the fused megastep is byte-compared
    against (``make_apply`` pads to a multiple of 64 instead, so a ragged
    tail would run the CNN at another shape)."""
    dev = resolve_device(device)

    def apply(crops: np.ndarray):
        n = len(crops)
        if n == 0:
            n_classes, feat_dim = _widths(forward, crops.shape[1:], dev)
            return (np.zeros((0, n_classes), np.float32),
                    np.zeros((0, feat_dim), np.float32))
        x = _to_device(_pad_rows(np.asarray(crops),
                                 batch_bucket(n, cfg.batch_size)), dev)
        probs, feats = forward(x)
        return (probs[:n].float().cpu().numpy(),
                feats[:n].float().cpu().numpy())

    return apply


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@dataclass
class PipelineStats:
    n_batches: int = 0            # batches dispatched
    n_objects: int = 0            # real rows folded (pad rows excluded)
    n_dispatches: int = 0         # megasteps + unmatched tails
    n_tail_scans: int = 0         # batches that needed the unmatched tail
    n_eviction_syncs: int = 0     # host reads of state.n (bound crossed)
    compile_hits: int = 0         # megastep (bucket, res) key already seen
    compile_misses: int = 0       # fresh megastep (bucket, res) key
    tail_compile_hits: int = 0    # tail (P, bucket) key already seen
    tail_compile_misses: int = 0  # fresh tail (P, bucket) key

    @property
    def dispatches_per_batch(self) -> float:
        return self.n_dispatches / max(self.n_batches, 1)


@dataclass
class _InFlight:
    """One dispatched-but-not-yet-host-folded batch."""
    crops: np.ndarray             # real rows only
    objs: np.ndarray
    frames: np.ndarray
    n: int
    feats: torch.Tensor           # (n, D) on the device: fold and tail
    host: tuple                   # host copies: probs, feats, j, matched,
                                  # vals, idxs (the last two None w/o sink)
    ready: Optional[torch.cuda.Event]   # behind the newest host copy
    j: np.ndarray = field(default=None)         # (n,), after resolve
    matched: np.ndarray = field(default=None)   # (n,) bool
    unmatched_idx: np.ndarray = field(default=None)
    sub_ids: Optional[torch.Tensor] = None      # host copy of the tail ids


class IngestPipeline:
    """Owns the fused megastep + double buffering for ONE ingestor.

    ``forward(crops (B, R, R, 3) f32 tensor) -> (probs (B, C), feats (B,
    D))`` runs on ``device`` and is per-example pure (``make_forward`` of a
    cheap CNN is). Construct, then pass as ``StreamingIngestor(...,
    pipeline=...)`` on the same device — the ingestor binds itself and
    routes its batches through ``submit``/``flush_pending``.
    ``topk_sink(objs, vals, idxs)``, when given, receives each folded
    batch's per-object top-K classes from the ``topk`` kernel (without a
    sink the kernel does not run); the arrays may be views of pinned host
    buffers. The K defaults to ``cfg.K`` clamped to the model's class
    width — ``TopKIndex``'s ``min(K, C)`` semantics — while an *explicit*
    ``topk_k`` wider than the class width raises, as ``hops.topk`` does.
    """

    def __init__(self, forward: Callable, cfg=None,
                 topk_k: Optional[int] = None,
                 topk_sink: Optional[Callable] = None,
                 device: DeviceLike = "cuda"):
        self.forward = forward
        self.cfg = cfg
        if cfg is not None:
            self._check_clustering(cfg)
        self.topk_k = topk_k
        self.topk_sink = topk_sink
        self.device = resolve_device(device)
        self.stats = PipelineStats()
        self._ing = None
        self._pending: Optional[_InFlight] = None
        self._seen_keys = set()
        self._k: Optional[int] = None   # top-K width, set with the state
        self._n_hi = 0                  # upper bound on live clusters

    # -- wiring ----------------------------------------------------------------

    @staticmethod
    def _check_clustering(cfg):
        """The megastep hard-codes the fused clustering semantics
        (phase-1 assign + matched fold + unmatched tail); running it under
        a config that names another variant would silently break the
        byte-identity contract with the staged path."""
        if cfg.clustering != "fused":
            raise ValueError(
                f"IngestPipeline implements clustering='fused' only; got "
                f"cfg.clustering={cfg.clustering!r} — use the host-staged "
                f"cheap_apply path for other variants")

    def _bind(self, ingestor):
        if self._ing is not None and self._ing is not ingestor:
            raise ValueError("IngestPipeline is already bound to an "
                             "ingestor; build one pipeline per stream")
        self._check_clustering(ingestor.cfg)
        if self.cfg is not None and self.cfg != ingestor.cfg:
            raise ValueError(
                "IngestPipeline cfg differs from the ingestor's cfg; the "
                "megastep clusters/evicts with its own threshold and "
                "table size, so a mismatch would silently diverge from "
                "the staged path — construct with cfg=None to inherit, "
                "or pass the same IngestConfig to both")
        if self.device != ingestor.device:
            raise ValueError(
                f"IngestPipeline runs on {self.device} but its ingestor "
                f"on {ingestor.device}: the clustering state they share "
                f"lives on one device")
        self._ing = ingestor
        if self.cfg is None:
            self.cfg = ingestor.cfg

    def reset(self):
        """Shard rollover: clustering state was reset by the ingestor."""
        if self._pending is not None:
            raise RuntimeError("reset() with a pending batch; drain first")
        self._n_hi = 0

    # -- ingestor API ----------------------------------------------------------

    def submit(self, crops: np.ndarray, objs: np.ndarray,
               frames: np.ndarray):
        """Dispatch one batch's megastep, host-fold the previous batch
        while the device runs, then resolve this batch's assignments
        (matched fold, tail scan, eviction bookkeeping). Batches must be
        submitted in stream order — ``StreamingIngestor`` guarantees
        this."""
        n = len(objs)
        if n == 0:
            return
        ing = self._ing
        if ing is None:
            raise RuntimeError("pipeline is not bound to an ingestor; "
                               "pass it to StreamingIngestor(pipeline=...)")
        t0 = time.perf_counter()
        if ing._state is None:
            self._init_state(crops)
        rec = self._dispatch(crops, objs, frames)
        # double buffer: fold batch N-1 on the host while the device runs N
        prev, self._pending = self._pending, None
        ing.stats.wall_s += time.perf_counter() - t0
        if prev is not None:
            self._fold(prev)
        self._resolve(rec)

    def flush_pending(self):
        """Host-fold the outstanding batch (publication barrier: flush /
        finish / seal call this before the index is observed)."""
        if self._pending is not None:
            rec, self._pending = self._pending, None
            self._fold(rec)

    # -- internals -------------------------------------------------------------

    def _init_state(self, crops: np.ndarray):
        n_classes, feat_dim = _widths(self.forward, crops.shape[1:],
                                      self.device)
        if self.topk_k is not None and self.topk_k > n_classes:
            # an explicit topk_k beyond the class width is a config error
            # (same contract as hops.topk); the cfg.K default is clamped
            # instead, mirroring TopKIndex's min(K, C) semantics
            raise ValueError(f"topk_k={self.topk_k} exceeds the model's "
                             f"{n_classes} classes")
        k_top = self.topk_k if self.topk_k is not None else self.cfg.K
        self._k = min(k_top, n_classes)
        self._ing._state = C.init_state(self.cfg.max_clusters, feat_dim,
                                        device=self.device)
        self._n_hi = 0

    def _dispatch(self, crops, objs, frames) -> _InFlight:
        """Queue the megastep: upload, forward, [topk,] phase 1, and the
        host copies of everything the fold reads. Nothing here waits for
        the card."""
        n = len(objs)
        bucket = batch_bucket(n, self.cfg.batch_size)
        key = (bucket, crops.shape[1])
        if key in self._seen_keys:
            self.stats.compile_hits += 1
        else:
            self._seen_keys.add(key)
            self.stats.compile_misses += 1
        x = _to_device(_pad_rows(np.asarray(crops), bucket), self.device)
        probs, feats = self.forward(x)
        probs, feats = probs[:n].float(), feats[:n].float()
        vals = idxs = None
        if self.topk_sink is not None:
            vals, idxs = hops.topk(probs, self._k)
        j, matched = C._phase1(self._ing._state, feats, self.cfg.threshold)
        host = tuple(_to_host(t) for t in (probs, feats, j, matched,
                                           vals, idxs))
        self.stats.n_dispatches += 1
        self.stats.n_batches += 1
        return _InFlight(crops=crops, objs=objs, frames=frames, n=n,
                         feats=feats, host=host, ready=_record(self.device))

    def _resolve(self, rec: _InFlight):
        """Fetch the tiny assignment outputs, fold the matched rows, run
        the unmatched tail, and decide eviction — everything batch N+1's
        megastep depends on. Times itself into ``stats.wall_s``, pausing
        around ``_fold`` (it keeps its own clock) so eviction batches are
        not double-counted."""
        ing = self._ing
        t0 = time.perf_counter()
        # the one per-batch fetch: (j, matched), queued with the batch
        if rec.ready is not None:
            rec.ready.synchronize()
        _, _, j, matched, _, _ = rec.host
        rec.j, rec.matched = j.numpy(), matched.numpy()
        state = C._fold_matched(ing._state, rec.feats, rec.j, rec.matched)
        rec.unmatched_idx = np.nonzero(~rec.matched)[0]
        U = len(rec.unmatched_idx)
        if U:
            # identical tail construction to cluster_fused: gather indices
            # padded to a power-of-two bucket, invalid rows are no-ops
            P = C._pad_bucket(U)
            tail_key = ("tail", P, batch_bucket(rec.n, self.cfg.batch_size))
            if tail_key in self._seen_keys:
                self.stats.tail_compile_hits += 1
            else:
                self._seen_keys.add(tail_key)
                self.stats.tail_compile_misses += 1
            gather = np.zeros((P,), np.int64)
            gather[:U] = rec.unmatched_idx
            dev = self.device
            sub = rec.feats[torch.from_numpy(gather).to(dev)]
            valid = torch.from_numpy(np.arange(P) < U).to(dev)
            state, sub_ids = C._scan_unmatched(state, sub, valid,
                                               self.cfg.threshold)
            rec.sub_ids = _to_host(sub_ids)
            rec.ready = _record(dev)
            self.stats.n_dispatches += 1
            self.stats.n_tail_scans += 1
            self._n_hi += U
        ing._state = state
        # eviction uses the same trigger as the staged path (state.n at
        # high water), but only reads state.n when the bound says it could
        # fire: n_hi >= actual n always, so no staged eviction is missed
        hw = int(self.cfg.high_water * self.cfg.max_clusters)
        if self._n_hi >= hw:
            self.stats.n_eviction_syncs += 1
            n_live = int(ing._state.n)
            self._n_hi = n_live
            if n_live >= hw:
                # the remap must not run before this batch's slots are
                # translated: fold now (no overlap for this rare batch)
                ing.stats.wall_s += time.perf_counter() - t0
                self._fold(rec)
                t0 = time.perf_counter()
                ing._evict_live()
                self._n_hi = int(ing._state.n)
                ing.stats.wall_s += time.perf_counter() - t0
                return
        self._pending = rec
        ing.stats.wall_s += time.perf_counter() - t0

    def _fold(self, rec: _InFlight):
        """Host side of the fold: scatter tail ids, slot → cid, SoA index
        update — mirrors the staged ``fold_batch`` exactly."""
        ing = self._ing
        t0 = time.perf_counter()
        if rec.ready is not None:
            rec.ready.synchronize()
        probs, feats, _, _, vals, idxs = rec.host
        slots = rec.j.astype(np.int32)
        if len(rec.unmatched_idx):
            slots[rec.unmatched_idx] = \
                rec.sub_ids.numpy()[:len(rec.unmatched_idx)]
        ing.stats.n_cnn_invocations += rec.n
        ing.stats.cheap_flops += rec.n * ing.cheap_flops_per_image
        ing._fold_rows(rec.crops, rec.objs, rec.frames, probs.numpy(),
                       feats.numpy(), slots)
        self.stats.n_objects += rec.n
        if self.topk_sink is not None:
            self.topk_sink(rec.objs, vals.numpy(), idxs.numpy())
        ing.stats.wall_s += time.perf_counter() - t0
