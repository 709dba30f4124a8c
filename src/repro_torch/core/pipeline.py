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

``ShardedIngestPipeline`` (DESIGN.md §13) runs the same megastep for many
streams at once: the cluster tables stacked over stream slots on the
ingest mesh's blocks, one ``topk`` and one stacked ``centroid_assign``
launch and one stacked unmatched tail per step, however many streams it
carries; every stream's bytes are those of its solo ``IngestPipeline``.

Without a JIT there is nothing to donate and no trace cache: the JAX
package's buffer donation and ``jit_cache_entries`` have no counterpart
here. ``compile_hits``/``compile_misses`` (and their tail twins) still
count new (bucket, resolution) keys: the shapes the forward and the
kernels meet.
"""
from __future__ import annotations

import functools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
# the megastep's bookkeeping, shared by the solo and the sharded pipeline
# ---------------------------------------------------------------------------

def _count_key(stats: "PipelineStats", seen: set, key: tuple):
    """Count ``key`` as a compile hit or miss: a megastep ``(bucket,
    resolution)`` key, or a tail ``("tail", P, bucket)`` key."""
    kind = "tail_compile_" if key[0] == "tail" else "compile_"
    kind += "hits" if key in seen else "misses"
    seen.add(key)
    setattr(stats, kind, getattr(stats, kind) + 1)


def _tail_gather(um: np.ndarray, P: int, base: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The unmatched rows ``um`` as ``base + um`` gather indices padded to
    the bucket ``P``, and the mask of the real ones: padded rows gather
    row ``base`` and are no-ops in the scan (as in ``cluster_fused``)."""
    gather = np.full((P,), base, np.int64)
    gather[:len(um)] += um
    return gather, np.arange(P) < len(um)


def _high_water(cfg) -> int:
    return int(cfg.high_water * cfg.max_clusters)


def _evict_due(n_hi: int, hw: int, read_n: Callable[[], int]
               ) -> Tuple[int, bool]:
    """The bound-gated eviction trigger: ``n_hi`` (live clusters plus the
    unmatched rows since the last read) is never below the live count, so
    the live count is read (``read_n``, a host sync) only when ``n_hi``
    reaches the high-water mark ``hw``, and no staged eviction point is
    missed. Returns the new bound and whether eviction is due."""
    if n_hi < hw:
        return n_hi, False
    n_live = read_n()
    return n_live, n_live >= hw


def _topk_width(forward: Callable, crops: np.ndarray, dev: torch.device,
                topk_k: Optional[int], K: int) -> Tuple[int, int]:
    """(top-K width, feature width) for ``forward``. The K defaults to
    ``K`` clamped to the class width (``TopKIndex``'s ``min(K, C)``); an
    explicit ``topk_k`` beyond it is a config error, as in ``hops.topk``."""
    n_classes, feat_dim = _widths(forward, crops.shape[1:], dev)
    if topk_k is not None and topk_k > n_classes:
        raise ValueError(f"topk_k={topk_k} exceeds the model's "
                         f"{n_classes} classes")
    return min(topk_k if topk_k is not None else K, n_classes), feat_dim


def _host_fold(ing, stats: "PipelineStats", crops, objs, frames,
               probs: np.ndarray, feats: np.ndarray, slots: np.ndarray,
               sink: Optional[Callable], vals, idxs):
    """Host side of one stream's fold: the ingestor's stats, the SoA index
    update (mirrors the staged ``fold_batch`` exactly) and the sink."""
    n = len(objs)
    ing.stats.n_cnn_invocations += n
    ing.stats.cheap_flops += n * ing.cheap_flops_per_image
    ing._fold_rows(crops, objs, frames, probs, feats, slots)
    stats.n_objects += n
    if sink is not None:
        sink(objs, vals, idxs)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@dataclass
class PipelineStats:
    n_batches: int = 0            # batches dispatched (per stream)
    n_steps: int = 0              # stacked steps (ShardedIngestPipeline)
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
        self._k, feat_dim = _topk_width(self.forward, crops, self.device,
                                        self.topk_k, self.cfg.K)
        self._ing._state = C.init_state(self.cfg.max_clusters, feat_dim,
                                        device=self.device)
        self._n_hi = 0

    def _dispatch(self, crops, objs, frames) -> _InFlight:
        """Queue the megastep: upload, forward, [topk,] phase 1, and the
        host copies of everything the fold reads. Nothing here waits for
        the card."""
        n = len(objs)
        bucket = batch_bucket(n, self.cfg.batch_size)
        _count_key(self.stats, self._seen_keys, (bucket, crops.shape[1]))
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
            _count_key(self.stats, self._seen_keys,
                       ("tail", P, batch_bucket(rec.n, self.cfg.batch_size)))
            gather, valid = _tail_gather(rec.unmatched_idx, P)
            dev = self.device
            sub = rec.feats[torch.from_numpy(gather).to(dev)]
            valid = torch.from_numpy(valid).to(dev)
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
        # fire
        self._n_hi, evict = _evict_due(self._n_hi, _high_water(self.cfg),
                                       self._read_n)
        if evict:
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

    def _read_n(self) -> int:
        self.stats.n_eviction_syncs += 1
        return int(self._ing._state.n)

    def _fold(self, rec: _InFlight):
        """Host side of the fold: scatter tail ids, slot → cid, then
        ``_host_fold``."""
        ing = self._ing
        t0 = time.perf_counter()
        if rec.ready is not None:
            rec.ready.synchronize()
        probs, feats, _, _, vals, idxs = rec.host
        slots = rec.j.astype(np.int32)
        if len(rec.unmatched_idx):
            slots[rec.unmatched_idx] = \
                rec.sub_ids.numpy()[:len(rec.unmatched_idx)]
        _host_fold(ing, self.stats, rec.crops, rec.objs, rec.frames,
                   probs.numpy(), feats.numpy(), slots, self.topk_sink,
                   *(None if t is None else t.numpy() for t in (vals, idxs)))
        ing.stats.wall_s += time.perf_counter() - t0


# ---------------------------------------------------------------------------
# sharded multi-stream ingest (DESIGN.md §13)
# ---------------------------------------------------------------------------

class _ShardSlot:
    """Per-stream handle onto a shared ``ShardedIngestPipeline``.

    Implements the ``StreamingIngestor`` pipeline protocol (``_bind`` /
    ``submit`` / ``flush_pending`` / ``reset``), so an ingestor constructed
    with ``pipeline=shared.handle(name)`` — including catalog'd ones that
    seal shards mid-run — works unchanged. ``submit`` enqueues the batch
    in stream order; the shared pipeline folds queued head batches from
    all streams in stacked steps."""

    def __init__(self, shared: "ShardedIngestPipeline", name: str,
                 slot: int, block):
        self.shared = shared
        self.name = name
        self.slot = slot
        self.block = block               # the mesh block that holds it
        self.queue: deque = deque()      # (crops, objs, frames), FIFO
        self._ing = None
        self._n_hi = 0                   # upper bound on live clusters

    @property
    def device(self) -> torch.device:
        return self.block.device

    def _bind(self, ingestor):
        self.shared._bind_slot(self, ingestor)

    def submit(self, crops: np.ndarray, objs: np.ndarray,
               frames: np.ndarray):
        if len(objs) == 0:
            return
        self.queue.append((np.asarray(crops), np.asarray(objs, np.int64),
                           np.asarray(frames, np.int64)))
        if self.shared.auto_pump:
            self.shared.pump()

    def flush_pending(self):
        """Publication barrier: drain every queued batch (all streams —
        fold timing is invisible to the byte-identity contract)."""
        self.shared.pump()

    def reset(self):
        """Shard rollover for this stream: its ingestor reset its host
        state; zero the stream's rows of the stacked tables."""
        if self.queue:
            raise RuntimeError(
                f"reset() on stream {self.name!r} with queued batches; "
                f"seal must drain first")
        self.shared._reset_slot(self)


@dataclass
class _BlockStep:
    """One device block's share of a stacked step."""
    block: object                 # distributed.sharding.SlotBlock
    slots: List[int]              # its active slots, in slot order
    feats: torch.Tensor           # (A, bucket, D) on the block's device
    host: tuple                   # host copies: probs, feats, j, matched,
                                  # vals, idxs (the last two None w/o sink)
    ready: Optional[torch.cuda.Event]   # behind the newest host copy
    sub_ids: Optional[torch.Tensor] = None   # host copy of tail ids (W, P)


class ShardedIngestPipeline:
    """N-stream fused ingest over a 1-D ``("data",)`` ingest mesh
    (``launch.mesh.make_ingest_mesh``).

    ``slots`` is the device-major stream layout (see
    ``core.streaming.StreamPlacement``): its length is a multiple of the
    mesh size, and ``None`` entries are idle padding slots. Each mesh
    device holds a block of slots and their stacked cluster tables
    (``distributed.sharding``). All streams share ONE ``IngestConfig``
    (the stacked tables have one (M, D) shape) and one tensor-level
    ``forward``, as ``IngestPipeline`` takes it.

    A stacked step takes the head batch of every stream whose head shares
    the leading stream's (bucket, resolution) key, and per device block:
    runs the forward on each active slot's crops at the solo shape (one
    stacked forward would change the batch size, and with it cuDNN's and
    cuBLAS's bits), ranks the stacked probability rows in ONE ``topk``
    launch (with a sink), and scores the stacked features against the
    stacked tables in ONE ``centroid_assign_stacked`` launch. Then the
    one fetch of the whole stack's ``(j, matched)``, each slot's matched
    fold, and ONE stacked unmatched tail for every slot with unmatched
    rows (``clustering._StackedScan``: slots without them ride along as
    no-ops). So a step costs one megastep dispatch and at most one tail,
    however many streams it carries. Folding stays on the host per
    stream, in slot order, through ``StreamingIngestor._fold_rows``.
    Every stream's index is byte-identical to its solo ``IngestPipeline``
    run. The step does not double-buffer across steps.

    ``topk_sink(stream_name, objs, vals, idxs)`` — note the extra leading
    stream name against the single-stream ``IngestPipeline``'s sink.
    Ingest over more than one card is not built: the forward and the
    tables live on one card (CPU meshes may have any number of blocks).
    """

    def __init__(self, forward: Callable, mesh,
                 slots: Sequence[Optional[str]], cfg=None,
                 topk_k: Optional[int] = None,
                 topk_sink: Optional[Callable] = None,
                 auto_pump: bool = True):
        from repro_torch.distributed import sharding as shd
        if mesh is None:
            raise ValueError("ShardedIngestPipeline needs a mesh; use "
                             "launch.mesh.make_ingest_mesh(n_devices)")
        slots = list(slots)
        if not slots or len(slots) % mesh.size:
            raise ValueError(
                f"len(slots)={len(slots)} must be a non-zero multiple of "
                f"the mesh size {mesh.size} (pad with None)")
        if len({d for d in mesh.devices if d.type == "cuda"}) > 1:
            raise NotImplementedError(
                "ingest over more than one card is not built: the forward "
                "and the stacked tables live on one card; use "
                "make_ingest_mesh(1)")
        self.forward = forward
        self.mesh = mesh
        self.width = len(slots) // mesh.size
        self.cfg = cfg
        if cfg is not None:
            IngestPipeline._check_clustering(cfg)
        self.topk_k = topk_k
        self.topk_sink = topk_sink
        self.auto_pump = auto_pump
        self.stats = PipelineStats()
        # the layout is computed once here, never per step
        self.blocks = shd.ingest_layout(mesh, len(slots))
        self._slots: List[Optional[_ShardSlot]] = [
            (_ShardSlot(self, nm, i, self.blocks[i // self.width])
             if nm is not None else None)
            for i, nm in enumerate(slots)]
        self.handles: Dict[str, _ShardSlot] = {}
        for h in self._slots:
            if h is None:
                continue
            if h.name in self.handles:
                raise ValueError(f"duplicate stream name {h.name!r}")
            self.handles[h.name] = h
        # stacked tables per block (lazy: feature width from the first batch)
        self._states: Optional[List[C.ClusterState]] = None
        self._k: Optional[int] = None
        self._seen_keys = set()

    def handle(self, name: str) -> _ShardSlot:
        """The pipeline handle to pass as ``StreamingIngestor(pipeline=)``
        for stream ``name``."""
        return self.handles[name]

    # -- wiring ----------------------------------------------------------------

    def _bind_slot(self, h: _ShardSlot, ingestor):
        if h._ing is not None and h._ing is not ingestor:
            raise ValueError(
                f"slot {h.name!r} is already bound to an ingestor")
        IngestPipeline._check_clustering(ingestor.cfg)
        if self.cfg is not None and self.cfg != ingestor.cfg:
            raise ValueError(
                "all streams sharing a ShardedIngestPipeline must use one "
                "IngestConfig (the stacked cluster tables share one shape "
                "and threshold); construct the pipeline with cfg=None to "
                "inherit the first ingestor's, or pass the same cfg to "
                "every stream")
        if ingestor.device != h.device:
            raise ValueError(
                f"stream {h.name!r} lives on mesh block {h.block.index} "
                f"({h.device}) but its ingestor runs on {ingestor.device}")
        if self.cfg is None:
            self.cfg = ingestor.cfg
        h._ing = ingestor

    # -- pumping ---------------------------------------------------------------

    def pump(self) -> int:
        """Fold every queued batch; returns total objects folded."""
        total = 0
        while True:
            k = self.pump_one()
            if not k:
                return total
            total += k

    # -- the stacked step ------------------------------------------------------

    def pump_one(self) -> int:
        """ONE stacked step over the head batch of every stream whose head
        shares the leading stream's (bucket, resolution) key, then fold
        those streams' rows on the host. Returns objects folded (0 = no
        queued batches)."""
        active = [h for h in self._slots if h is not None and h.queue]
        if not active:
            return 0
        t0 = time.perf_counter()
        cfg = self.cfg
        lead_crops = active[0].queue[0][0]
        bucket = batch_bucket(len(active[0].queue[0][1]), cfg.batch_size)
        shape = lead_crops.shape[1:]
        group = [h for h in active
                 if batch_bucket(len(h.queue[0][1]),
                                 cfg.batch_size) == bucket
                 and h.queue[0][0].shape[1:] == shape]
        if self._states is None:
            self._init_stacked(lead_crops)
        _count_key(self.stats, self._seen_keys, (bucket, shape[0]))
        parts = {h.slot: (h, *h.queue.popleft()) for h in group}
        steps = [self._dispatch(b, [s for s in b.slots if s in parts],
                                parts, bucket)
                 for b in self.blocks if any(s in parts for s in b.slots)]
        self.stats.n_dispatches += 1
        self.stats.n_steps += 1
        self.stats.n_batches += len(parts)

        # the one (j, matched) fetch of the whole stack, queued with the
        # megastep; then each slot's matched fold on its device
        step_of: Dict[int, Tuple[_BlockStep, int]] = {}
        tails: Dict[int, np.ndarray] = {}
        for st in steps:
            if st.ready is not None:
                st.ready.synchronize()
            state = self._states[st.block.index]
            j_all, m_all = st.host[2].numpy(), st.host[3].numpy()
            for a, slot in enumerate(st.slots):
                step_of[slot] = (st, a)
                n = len(parts[slot][2])
                w = slot - st.block.lo
                C._fold_matched_(state.centroids[w], state.counts[w],
                                 st.feats[a, :n], j_all[a, :n],
                                 m_all[a, :n])
                um = np.nonzero(~m_all[a, :n])[0]
                if len(um):
                    tails[slot] = um

        # one stacked tail covering every slot with unmatched rows
        if tails:
            P = C._pad_bucket(max(len(um) for um in tails.values()))
            _count_key(self.stats, self._seen_keys, ("tail", P, bucket))
            for st in steps:
                if any(s in tails for s in st.slots):
                    self._tail(st, tails, P, bucket)
            self.stats.n_dispatches += 1
            self.stats.n_tail_scans += 1

        # host fold per stream in slot order; evictions collect and run
        # once after the loop (per-slot independent)
        n_host = []

        def read_n(slot: int) -> int:
            if not n_host:
                # the (S,) live counts, once per crossing step
                self.stats.n_eviction_syncs += 1
                n_host.append(np.concatenate([s.n.cpu().numpy()
                                              for s in self._states]))
            return int(n_host[0][slot])

        hw = _high_water(cfg)
        evictors: List[_ShardSlot] = []
        total = 0
        for slot in sorted(parts):
            h, crops, objs, frames = parts[slot]
            st, a = step_of[slot]
            if st.ready is not None:
                st.ready.synchronize()
            probs, feats, j, _, vals, idxs = st.host
            n = len(objs)
            ids = j.numpy()[a, :n].astype(np.int32)
            um = tails.get(slot)
            if um is not None:
                ids[um] = st.sub_ids.numpy()[slot - st.block.lo, :len(um)]
                h._n_hi += len(um)
            sink = (None if self.topk_sink is None
                    else functools.partial(self.topk_sink, h.name))
            _host_fold(h._ing, self.stats, crops, objs, frames,
                       probs.numpy()[a, :n], feats.numpy()[a, :n], ids, sink,
                       *(None if t is None else t.numpy()[a, :n]
                         for t in (vals, idxs)))
            total += n
            # the same bound-gated eviction trigger as IngestPipeline
            h._n_hi, evict = _evict_due(h._n_hi, hw,
                                        functools.partial(read_n, slot))
            if evict:
                evictors.append(h)
        if evictors:
            self._evict_slots(evictors)
        dt = time.perf_counter() - t0
        for h, _, objs, _ in parts.values():
            h._ing.stats.wall_s += dt * (len(objs) / max(total, 1))
        return total

    # -- internals -------------------------------------------------------------

    def _init_stacked(self, crops: np.ndarray):
        from repro_torch.distributed import sharding as shd
        cfg = self.cfg
        if cfg is None:
            raise RuntimeError("pipeline has no cfg; bind an ingestor "
                               "(StreamingIngestor(pipeline=handle)) first")
        self._k, feat_dim = _topk_width(self.forward, crops,
                                        self.blocks[0].device, self.topk_k,
                                        cfg.K)
        self._states = [shd.stacked_state(b, cfg.max_clusters, feat_dim)
                        for b in self.blocks]

    def _dispatch(self, block, slots: List[int], parts: dict,
                  bucket: int) -> _BlockStep:
        """Queue one block's megastep: upload and forward each active slot
        at the solo shape, [topk,] phase 1 over the stack, and the host
        copies of everything the fold reads. Nothing here waits for the
        card."""
        dev = block.device
        probs, feats = [], []
        for slot in slots:
            x = _to_device(_pad_rows(parts[slot][1], bucket), dev)
            p, f = self.forward(x)
            probs.append(p.float())
            feats.append(f.float())
        probs, feats = torch.stack(probs), torch.stack(feats)
        vals = idxs = None
        if self.topk_sink is not None:
            A, B, n_classes = probs.shape
            vals, idxs = hops.topk(probs.reshape(A * B, n_classes), self._k)
            vals, idxs = vals.reshape(A, B, -1), idxs.reshape(A, B, -1)
        state = self._states[block.index]
        cen, n = state.centroids, state.n
        if len(slots) < block.width:
            rows = torch.from_numpy(np.asarray(slots) - block.lo).to(dev)
            cen, n = cen.index_select(0, rows), n.index_select(0, rows)
        j, matched = C._phase1_stacked(cen, n, feats, self.cfg.threshold)
        host = tuple(_to_host(t) for t in (probs, feats, j, matched,
                                           vals, idxs))
        return _BlockStep(block, slots, feats, host, _record(dev))

    def _tail(self, st: _BlockStep, tails: Dict[int, np.ndarray], P: int,
              bucket: int):
        """The block's share of the stacked tail: its slots' unmatched rows
        gathered into (W, P, D), padded rows invalid, scanned in place on
        the block's tables."""
        block = st.block
        dev = block.device
        rows = np.zeros((block.width, P), np.int64)     # into (A * bucket)
        valid = np.zeros((block.width, P), bool)
        for a, slot in enumerate(st.slots):
            um = tails.get(slot)
            if um is not None:
                w = slot - block.lo
                rows[w], valid[w] = _tail_gather(um, P, a * bucket)
        flat = st.feats.reshape(-1, st.feats.shape[2])
        sub = flat[torch.from_numpy(rows).to(dev)]
        ids = C._scan_unmatched_stacked(
            self._states[block.index], sub, torch.from_numpy(valid).to(dev),
            self.cfg.threshold)
        st.sub_ids = _to_host(ids)
        st.ready = _record(dev)

    def _evict_slots(self, handles: Sequence[_ShardSlot]):
        """Rare path, the staged ``_evict_live``'s semantics: each evicting
        stream's rows go through its ingestor (the slot -> cid bookkeeping
        lives there) and come back into its slot of the stacked tables in
        place; no other slot is read or written."""
        for h in handles:
            state = self._states[h.block.index]
            w = h.slot - h.block.lo
            ing = h._ing
            ing._state = C.ClusterState(state.centroids[w], state.counts[w],
                                        state.n[w])
            ing._evict_live()
            new, ing._state = ing._state, None   # the stack holds the state
            state.centroids[w].copy_(new.centroids)
            state.counts[w].copy_(new.counts)
            state.n[w].copy_(new.n)
            h._n_hi = int(new.n)

    def _reset_slot(self, h: _ShardSlot):
        h._n_hi = 0
        if self._states is None:
            return
        state = self._states[h.block.index]
        w = h.slot - h.block.lo
        state.centroids[w].zero_()
        state.counts[w].zero_()
        state.n[w].zero_()
