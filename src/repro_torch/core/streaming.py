"""Streaming ingest with query-while-ingest (paper §5, Fig. 4).

Focus's deployment shape is a fleet of cameras ingested *continuously*
while "after the fact" queries arrive mid-stream. ``StreamingIngestor``
accepts chunked ``(crops, frames)`` feeds for one stream and maintains
clustering state + the top-K index incrementally across calls — carrying
``slot_cid``, pixel-track roots, and eviction remaps over chunk
boundaries.

Determinism contract: chunk boundaries are invisible. Unique objects are
buffered and cut into CNN batches of exactly ``cfg.batch_size``, so the
batch partition — and with it the clustering fold order, slot -> cid
assignment, and eviction points — is a function of the concatenated
stream only. Pixel-diff duplicates go to the index's separate attach log,
canonicalized at read/save time, so *when* the ingestor flushed them is
equally invisible. One-shot ``ingest()`` is the single-chunk special
case, and a chunked run saves byte-identically to it.

With a ``core.archive.ShardCatalog`` the ingestor rolls its live index
over into sealed time shards, each byte-identical to a one-shot
``ingest()`` of its window.

Freshness model for query-while-ingest: ``feed`` folds every complete
batch immediately; ``flush`` attaches the pixel-diff duplicates whose
root's batch has folded and publishes an ``IngestDelta`` naming the
new/moved clusters, which is exactly what a ``QueryEngine`` needs to
``prefetch`` so warm queries between chunks stay off the GT-CNN path.

Pixel differencing and clustering run on the ingestor's ``device``. With
a ``core.pipeline.IngestPipeline`` the CNN and clustering of every batch
run as the fused, double-buffered megastep instead of host-staged
``cheap_apply`` calls; the saved bytes are the same.

Many cameras: ``MultiStreamRunner`` round-robins N ingestors, either
through one ``cheap_apply`` (staged) or through one
``core.pipeline.ShardedIngestPipeline`` whose stacked steps carry a batch
of every stream (``make_sharded_runner``); ``StreamPlacement`` maps the
streams onto the ingest mesh's blocks. Every stream saves the bytes of
its solo run.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import clustering as C
from repro_torch.core.index import ClassMap, TopKIndex
from repro_torch.core.ingest import IngestConfig, IngestStats
from repro_torch.data.bgsub import match_flat, match_ranges


@dataclass
class IngestDelta:
    """What one ``flush()`` made newly visible to queries."""
    n_objects_published: int         # uniques folded + duplicates attached
    new_cids: List[int]              # clusters created since the last flush
    touched_cids: List[int]          # live-shard clusters whose centroid
                                     # moved (sorted, includes the new ones)
    n_evictions: int
    n_pending_unique: int            # buffered, awaiting a full CNN batch
    n_pending_dups: int              # awaiting their root's batch
    sealed_shards: List[int] = field(default_factory=list)
    touched_sealed: List[Tuple[int, int]] = field(default_factory=list)
    # (shard_id, cid) for clusters touched since the last flush whose
    # shard has since been sealed — what an ArchiveQueryEngine prefetches


def frame_groups(frames: np.ndarray, lo: int, hi: int):
    """``(f, i, j)`` for each run of equal frames in ``frames[lo:hi]``
    (frame-sorted)."""
    i = lo
    while i < hi:
        f = int(frames[i])
        j = i + int(np.searchsorted(frames[i:hi], f, side="right"))
        yield f, i, j
        i = j


class _PixelTracker:
    """Streaming §4.2 pixel differencing.

    Mirrors ``ingest.pixel_tracks`` exactly, but over an unbounded stream:
    a frame group may arrive split across chunks (the *open* frame keeps
    accepting members until a later frame appears), while the previous
    frame's completed group — crops and resolved root ids — is retained
    for matching. Requires frames to arrive in non-decreasing order.

    A match depends only on crops, never on roots, so ``prepare`` matches
    a whole frame-sorted window in one ``pixel_match`` launch: the window's
    crops and the retained crops it may reference are uploaded once, each
    crop's range is the rows of frame f-1 among them (empty when there is
    none), and the match indices come back in one read. ``resolve`` then
    turns the window's matches into roots one frame group at a time, in
    order, so a root rewritten by ``amend_last`` is what the next frame's
    matches chain to.
    """

    # new crops matched per launch: 8192 crops of 32 x 32 x 3 fp32 are
    # ~100 MB on the card (the retained reference crops, at most two frame
    # groups, come on top)
    WINDOW_ROWS = 8192

    def __init__(self, threshold: float, device: DeviceLike = "cuda"):
        self.threshold = threshold
        self.device = device
        self._open_frame: Optional[int] = None
        self._open_crops: List[np.ndarray] = []
        self._open_roots: List[np.ndarray] = []
        self._prev_frame: Optional[int] = None
        self._prev_crops: Optional[np.ndarray] = None
        self._prev_roots: Optional[np.ndarray] = None
        # the prepared window: its crops and frames, each crop's match (an
        # index into [references, window]), the roots of those rows as far
        # as resolved, the window's first row there, and the next row due
        self._win_crops: Optional[np.ndarray] = None
        self._win_frames: Optional[np.ndarray] = None
        self._match: Optional[np.ndarray] = None
        self._roots: Optional[np.ndarray] = None
        self._base = 0
        self._cursor = 0

    def prepare(self, frames: np.ndarray, crops: np.ndarray):
        """Match a frame-sorted window against each crop's previous frame,
        in one launch when any crop has one. The window continues the
        stream; ``resolve`` must then take all of its rows, in order."""
        if self._match is not None and self._cursor < len(self._match):
            raise RuntimeError("prepare() before the last window was "
                               "resolved")
        frames = np.asarray(frames, np.int64)
        n = len(frames)
        f0 = int(frames[0]) if n else None
        if n and self._open_frame is not None and f0 < self._open_frame:
            raise ValueError(
                f"frames must be non-decreasing across feeds: got frame {f0} "
                f"after frame {self._open_frame}")
        # the retained groups the window can reference: the open frame when
        # the window continues it or follows it, and the previous frame
        # when the window continues the open one
        refs = []
        if n and self._open_crops and f0 - 1 <= self._open_frame:
            if f0 == self._open_frame and self._prev_frame == f0 - 1:
                refs.append((self._prev_frame, self._prev_crops,
                             self._prev_roots))
            refs.append((self._open_frame, np.concatenate(self._open_crops),
                         np.concatenate(self._open_roots)))
        ref_frames = np.concatenate(
            [np.full(len(c), fr, np.int64) for fr, c, _ in refs]
            + [frames])
        lo = np.searchsorted(ref_frames, frames - 1, side="left")
        hi = np.searchsorted(ref_frames, frames - 1, side="right")
        n_ref = len(ref_frames) - n
        self._match = np.full(n, -1, np.int64)
        if (hi > lo).any():
            rows = [c.reshape(len(c), -1) for _, c, _ in refs]
            rows.append(np.asarray(crops).reshape(n, -1))
            rows = rows[0] if len(rows) == 1 else np.concatenate(rows)
            self._match = match_ranges(rows, n_ref, lo, hi, self.threshold,
                                       device=self.device)
        self._roots = np.concatenate([r for _, _, r in refs]
                                     + [np.zeros(n, np.int64)])
        self._win_crops, self._win_frames = crops, frames
        self._base, self._cursor = n_ref, 0

    def resolve(self, f: int, obj_ids: np.ndarray) -> np.ndarray:
        """Root object ids for the next ``len(obj_ids)`` prepared rows, one
        (possibly partial) frame-``f`` group."""
        k = len(obj_ids)
        c0, c1 = self._cursor, self._cursor + k
        if self._match is None or c1 > len(self._match) \
                or (self._win_frames[c0:c1] != f).any():
            raise ValueError(f"resolve(frame {f}, {k} objects) does not "
                             f"follow the prepared window")
        if self._open_frame is None or f > self._open_frame:
            if self._open_crops:
                self._prev_frame = self._open_frame
                self._prev_crops = np.concatenate(self._open_crops)
                self._prev_roots = np.concatenate(self._open_roots)
            self._open_frame = f
            self._open_crops, self._open_roots = [], []
        roots = np.array(obj_ids, np.int64)
        m = self._match[c0:c1]
        hit = m >= 0
        roots[hit] = self._roots[m[hit]]
        self._roots[self._base + c0:self._base + c1] = roots
        self._open_crops.append(self._win_crops[c0:c1])
        self._open_roots.append(roots)
        self._cursor = c1
        return roots

    def amend_last(self, roots: np.ndarray):
        """Replace the roots of the most recent ``resolve`` segment.

        The redundancy gate rewrites roots *after* the tracker resolved a
        group; the tracker must see the rewrite, or a next-frame tracker
        match would chain to the crop's own (never-CNN'd, never-folded)
        id and its duplicate record could never attach.
        """
        roots = np.asarray(roots, np.int64)
        self._open_roots[-1] = roots
        self._roots[self._base + self._cursor - len(roots):
                    self._base + self._cursor] = roots


class _RedundancyGate:
    """Cross-frame redundancy gate in front of the CNN.

    The §4.2 tracker only matches consecutive frames; on a static camera
    the same object re-surfaces for minutes. This gate keeps a bounded
    FIFO ring of the most recent *CNN-bound* unique crops (flattened)
    with their root ids; a new crop matching a ring entry (mean abs diff
    STRICTLY below ``threshold``, via ``bgsub.match_flat`` — the
    ``pixel_match`` kernel on the card) skips the CNN and attaches to the
    ring root's cluster through the duplicate/attach log.

    Chunk invariance: matching only sees entries from strictly earlier
    frames — a frame's own uniques are queued and admitted to the ring
    when the frame *closes* (a later frame arrives), mirroring the
    tracker's open/prev machinery, so a frame group split across chunks
    gates identically to an unsplit feed.
    """

    def __init__(self, threshold: float, capacity: int,
                 device: DeviceLike = "cuda"):
        if capacity < 1:
            raise ValueError(f"gate_capacity must be >= 1, got {capacity}")
        self.threshold = threshold
        self.capacity = capacity
        self.device = device
        self._ring_crops: List[np.ndarray] = []    # per-frame (k, D) groups
        self._ring_roots: List[np.ndarray] = []
        self._n = 0
        self._open_frame: Optional[int] = None
        self._open_crops: List[np.ndarray] = []
        self._open_roots: List[np.ndarray] = []

    def match(self, f: int, crops2d: np.ndarray) -> np.ndarray:
        """Ring root id per crop (or -1) for one frame-``f`` segment.
        Also advances the open-frame bookkeeping, so call it once per
        resolved segment even when ``crops2d`` is empty."""
        if self._open_frame is None or f > self._open_frame:
            if self._open_crops:
                self._push(np.concatenate(self._open_crops),
                           np.concatenate(self._open_roots))
                self._open_crops, self._open_roots = [], []
            self._open_frame = f
        out = np.full((len(crops2d),), -1, np.int64)
        if self._n == 0 or len(crops2d) == 0:
            return out
        m = match_flat(crops2d, np.concatenate(self._ring_crops),
                       self.threshold, device=self.device)
        hit = m >= 0
        if hit.any():
            roots = np.concatenate(self._ring_roots)
            out[hit] = roots[m[hit]]
        return out

    def admit(self, crops2d: np.ndarray, roots: np.ndarray):
        """Queue frame-``f`` CNN-bound uniques (f = the frame of the last
        ``match`` call); they join the ring when the frame closes."""
        if len(crops2d):
            self._open_crops.append(crops2d)
            self._open_roots.append(np.asarray(roots, np.int64))

    def _push(self, crops: np.ndarray, roots: np.ndarray):
        self._ring_crops.append(crops)
        self._ring_roots.append(roots)
        self._n += len(roots)
        # trim whole frame groups while the remainder still covers the
        # capacity: ring size stays in [capacity, capacity + group)
        while len(self._ring_roots) > 1 \
                and self._n - len(self._ring_roots[0]) >= self.capacity:
            self._n -= len(self._ring_roots[0])
            self._ring_crops.pop(0)
            self._ring_roots.pop(0)

    def live_roots(self) -> set:
        """Root ids a future gate match may still return (ring + open) —
        their ``_root_cid`` entries must survive pruning."""
        keep: set = set()
        for seg in self._ring_roots:
            keep.update(seg.tolist())
        for seg in self._open_roots:
            keep.update(seg.tolist())
        return keep


class _ChunkBuffer:
    """Unique-object buffer as a list of chunks: appends are O(1) and
    ``take`` concatenates only the rows taken. ``take`` on an empty buffer
    returns correctly-shaped empties."""

    def __init__(self):
        self._crops: List[np.ndarray] = []
        self._objs: List[np.ndarray] = []
        self._frames: List[np.ndarray] = []
        self._n = 0
        self._crop_shape: Optional[tuple] = None
        self._dtype = np.float32

    def __len__(self) -> int:
        return self._n

    def append(self, crops: np.ndarray, objs: np.ndarray,
               frames: np.ndarray):
        if self._crop_shape is None and crops.ndim > 1:
            self._crop_shape = crops.shape[1:]
            self._dtype = crops.dtype
        if len(objs) == 0:
            return
        self._crops.append(crops)
        self._objs.append(np.asarray(objs, np.int64))
        self._frames.append(np.asarray(frames, np.int64))
        self._n += len(objs)

    def _empty(self):
        shape = (0,) + (self._crop_shape if self._crop_shape is not None
                        else (0, 0, 3))
        return (np.zeros(shape, self._dtype), np.zeros((0,), np.int64),
                np.zeros((0,), np.int64))

    def take(self, k: int):
        """Pop the first ``k`` rows (all rows if ``k`` exceeds the
        buffer)."""
        if k <= 0 or self._n == 0:
            return self._empty()
        k = min(k, self._n)
        crops, objs, frames, got = [], [], [], 0
        while got < k:
            c, o, f = self._crops[0], self._objs[0], self._frames[0]
            need = k - got
            if len(o) <= need:
                self._crops.pop(0)
                self._objs.pop(0)
                self._frames.pop(0)
            else:
                self._crops[0] = c[need:]
                self._objs[0] = o[need:]
                self._frames[0] = f[need:]
                c, o, f = c[:need], o[:need], f[:need]
            crops.append(c)
            objs.append(o)
            frames.append(f)
            got += len(o)
        self._n -= k
        if len(objs) == 1:
            return crops[0], objs[0], frames[0]
        return (np.concatenate(crops), np.concatenate(objs),
                np.concatenate(frames))


class StreamingIngestor:
    """Incremental Focus ingest for one stream, fed in chunks.

    ``cheap_apply(crops (B,R,R,3)) -> (probs (B, C_local), feats (B, D))``
    returns numpy arrays. ``feed`` / ``flush`` / ``finish`` are the
    lifecycle; ``ingest()`` in ``core.ingest`` is the single-chunk
    wrapper. Pixel differencing and clustering run on ``device``.

    With a ``catalog`` (``core.archive.ShardCatalog``) the ingestor rolls
    the live index over into time shards: after ``shard_objects`` fed
    objects and/or at absolute ``shard_frames``-wide frame-window
    boundaries, the live index is *sealed* — drained, saved through the
    catalog, and replaced by a fresh one with all clustering/tracker state
    reset. Object ids restart per shard, so every sealed shard is
    byte-identical to a one-shot ``ingest()`` of its window (the rollover
    invariant; ``ShardMeta.obj_base`` maps ids back to global positions).
    ``finish()`` seals the tail shard. Sealing drains the tail batch
    through the CNN, so a catalog needs ``cheap_apply`` or ``pipeline``.

    ``pipeline`` (a ``core.pipeline.IngestPipeline`` on the same
    ``device``, or a ``ShardedIngestPipeline`` slot handle) replaces
    ``cheap_apply``: pass one or the other. The ingestor binds the
    pipeline last, so a constructor that raises leaves it unbound. With
    neither, the ingestor is runner-driven: a staged
    ``MultiStreamRunner`` takes its ready batches and folds them.
    """

    def __init__(self, cheap_apply: Optional[Callable],
                 cheap_flops_per_image: float = 0.0,
                 cfg: Optional[IngestConfig] = None,
                 class_map: Optional[ClassMap] = None,
                 n_local_classes: Optional[int] = None,
                 catalog=None, shard_objects: Optional[int] = None,
                 shard_frames: Optional[int] = None,
                 shard_format: Optional[int] = None,
                 device: DeviceLike = "cuda", pipeline=None):
        if pipeline is not None and cheap_apply is not None:
            raise ValueError(
                "pass either cheap_apply (host-staged) or pipeline "
                "(fused megastep), not both")
        if catalog is not None and cheap_apply is None and pipeline is None:
            raise ValueError("shard rollover needs cheap_apply or a "
                             "pipeline: sealing drains the tail batch "
                             "through the CNN")
        if catalog is None and (shard_objects is not None
                                or shard_frames is not None):
            raise ValueError("shard_objects/shard_frames need a catalog")
        if shard_objects is not None and shard_objects < 1:
            raise ValueError(f"shard_objects must be >= 1: {shard_objects}")
        if shard_frames is not None and shard_frames < 1:
            raise ValueError(f"shard_frames must be >= 1: {shard_frames}")
        if shard_format is not None and catalog is None:
            raise ValueError("shard_format needs a catalog")
        self.cheap_apply = cheap_apply
        self.pipeline = pipeline
        self.cheap_flops_per_image = cheap_flops_per_image
        self.cfg = cfg if cfg is not None else IngestConfig()
        self.class_map = class_map
        self.n_local_classes = n_local_classes
        self.catalog = catalog
        self.shard_objects = shard_objects
        self.shard_frames = shard_frames
        # None -> the catalog's default (v4 quantized columnar); pin 3 to
        # seal fp32 npz shards
        self.shard_format = shard_format
        self.device = resolve_device(device)
        self.stats = IngestStats()
        try:
            self._cluster_fn = C.CLUSTER_FNS[self.cfg.clustering]
        except KeyError:
            raise ValueError(
                f"unknown clustering variant {self.cfg.clustering!r}; "
                f"expected one of {sorted(C.CLUSTER_FNS)}") from None
        if self.cfg.frame_stride < 1:
            raise ValueError(
                f"frame_stride must be >= 1: {self.cfg.frame_stride}")
        self._frame_stride = self.cfg.frame_stride
        # the index exists up front whenever the class width is known, so a
        # QueryEngine can bind to it before the first chunk arrives
        self._index: Optional[TopKIndex] = None
        if n_local_classes is not None or class_map is not None:
            nl = (n_local_classes if n_local_classes is not None
                  else class_map.n_local)
            self._index = TopKIndex(self.cfg.K, nl, class_map)
        self._state = None                      # lazy: dims from first batch
        self._slot_cid = np.full(self.cfg.max_clusters, -1, np.int64)
        self._next_cid = 0
        self._tracker = _PixelTracker(self.cfg.pixel_diff_threshold,
                                      self.device)
        self._gate = (_RedundancyGate(self.cfg.gate_threshold,
                                      self.cfg.gate_capacity, self.device)
                      if self.cfg.gate else None)
        # unique-object buffer, awaiting a full CNN batch
        self._buf = _ChunkBuffer()
        # pixel-diff duplicates awaiting their root's batch
        self._dup_objs: List[np.ndarray] = []
        self._dup_frames: List[np.ndarray] = []
        self._dup_roots: List[np.ndarray] = []
        self._root_cid: Dict[int, int] = {}     # folded unique obj -> cid
        self._obj_next = 0       # next default object id (kept objects;
                                 # shard-local under rollover)
        self._max_frame: Optional[int] = None
        self._finished = False
        # live-shard accounting (identity values when no catalog is set)
        self._shard_n_fed = 0                   # objects fed to live shard
        self._shard_obj_base = 0                # global pos of its 1st obj
        self._shard_frame_lo: Optional[int] = None
        self._shard_frame_hi: Optional[int] = None
        self._shard_window_end: Optional[int] = None
        # delta accounting between flushes
        self._delta_new: List[int] = []
        self._delta_touched: set = set()
        self._delta_evictions = 0
        self._delta_published = 0
        self._delta_sealed: List[int] = []
        self._delta_touched_sealed: List[Tuple[int, int]] = []
        if catalog is not None and len(catalog.shards):
            # resuming on a non-empty catalog: new shards continue the
            # global object-id line and the non-decreasing frame contract
            # from where the existing archive ends (every fed object is
            # sealed as a member, so obj_base + n_objects is the count of
            # all objects fed to the prior run)
            last = catalog.shards[-1]
            self._shard_obj_base = last.obj_base + last.n_objects
            self._max_frame = last.frame_hi
        if pipeline is not None:
            # bind last: a constructor rejected above must not consume
            # the pipeline (binding is permanent per stream)
            pipeline._bind(self)

    # -- queryable state -------------------------------------------------------

    @property
    def index(self) -> Optional[TopKIndex]:
        """The live index (None until the class width is known)."""
        return self._index

    @property
    def _runner_driven(self) -> bool:
        """Neither ``cheap_apply`` nor a pipeline: a staged
        ``MultiStreamRunner`` folds this ingestor's batches."""
        return self.cheap_apply is None and self.pipeline is None

    @property
    def n_ready_batches(self) -> int:
        return len(self._buf) // self.cfg.batch_size

    @property
    def n_pending_unique(self) -> int:
        return len(self._buf)

    @property
    def n_pending_dups(self) -> int:
        return int(sum(len(a) for a in self._dup_objs))

    @property
    def shard_obj_base(self) -> int:
        """Global arrival position of the live shard's first object (0
        when rollover is off) — maps shard-local object ids back to the
        concatenated stream."""
        return self._shard_obj_base

    @property
    def frame_stride(self) -> int:
        return self._frame_stride

    def set_frame_stride(self, stride: int):
        """Retarget the sampling stride (the adaptive controller's hook,
        ``core.params.AdaptiveSampler``). Takes effect from the next
        ``feed``. A stride changed mid-run gives up the chunked ==
        one-shot byte identity (a one-shot run cannot replay a stride
        schedule), so only live deployments drive it."""
        if stride < 1:
            raise ValueError(f"frame_stride must be >= 1: {stride}")
        self._frame_stride = int(stride)

    # -- feeding ---------------------------------------------------------------

    def feed(self, crops: np.ndarray, frames: np.ndarray,
             obj_ids: Optional[np.ndarray] = None):
        """Ingest one chunk. Frames must be non-decreasing across feeds
        (chunks may split a frame's objects; the open frame keeps
        accepting members). ``obj_ids`` defaults to arrival positions in
        the concatenated stream (counting kept objects only) — shard-local
        under rollover, i.e. the shard's objects ranked by arrival,
        exactly the ids a one-shot ``ingest()`` of the shard's window
        assigns. A rejected chunk mutates nothing: validation runs before
        any stats or object-id state is touched.
        """
        if self._finished:
            raise RuntimeError("feed() after finish()")
        crops = np.asarray(crops)
        frames = np.asarray(frames, np.int64)
        n = len(crops)
        arr_pos = None
        if obj_ids is not None:
            obj_ids = np.asarray(obj_ids, np.int64)
        if n:
            order = np.argsort(frames, kind="stable")
            crops, frames = crops[order], frames[order]
            if obj_ids is not None:
                obj_ids = obj_ids[order]
            else:
                arr_pos = order          # chunk-arrival position per slot
            # the contract holds with or without pixel differencing: an
            # out-of-order chunk would silently move the CNN batch
            # partition away from the one-shot run's
            if self._max_frame is not None and frames[0] < self._max_frame:
                raise ValueError(
                    f"frames must be non-decreasing across feeds: got "
                    f"frame {int(frames[0])} after frame {self._max_frame}")
        if n == 0:
            return
        self._max_frame = int(frames[-1])
        if self._frame_stride > 1:
            # absolute sampling grid: frame f is kept iff f % stride == 0,
            # a function of the stream alone — dropped objects behave as
            # if never detected (no ids, no stats beyond n_sampled_out)
            keep = frames % self._frame_stride == 0
            self.stats.n_sampled_out += n - int(keep.sum())
            crops, frames = crops[keep], frames[keep]
            if obj_ids is not None:
                obj_ids = obj_ids[keep]
            else:
                arr_pos = arr_pos[keep]
            n = len(crops)
        self.stats.n_objects += n
        if n == 0:
            return
        start = 0
        while start < n:
            if self.catalog is not None \
                    and self._frame_boundary(int(frames[start])):
                self._seal_shard()
            end = self._shard_cut(frames, start, n)
            if obj_ids is None:
                # rank the segment's objects by chunk-arrival position:
                # ids follow arrival order even when the chunk was
                # internally unsorted, matching what a one-shot ingest of
                # the shard's window (objects in arrival order) assigns
                ranks = np.argsort(np.argsort(arr_pos[start:end],
                                              kind="stable"),
                                   kind="stable")
                seg_ids = self._obj_next + ranks.astype(np.int64)
            else:
                seg_ids = obj_ids[start:end]
            self._obj_next += end - start
            self._shard_n_fed += end - start
            if self._shard_frame_lo is None:
                self._shard_frame_lo = int(frames[start])
            self._shard_frame_hi = int(frames[end - 1])
            self._ingest_chunk(crops[start:end], frames[start:end], seg_ids)
            start = end
            if self.catalog is not None and self.shard_objects is not None \
                    and self._shard_n_fed >= self.shard_objects:
                self._seal_shard()

    def _frame_boundary(self, f: int) -> bool:
        """True when the next object falls past the live shard's absolute
        frame window (windows are ``[i*W, (i+1)*W)``, pinned by the
        shard's first frame — so the shard partition is a function of the
        stream alone, never of the chunking)."""
        return (self.shard_frames is not None
                and self._shard_window_end is not None
                and self._shard_n_fed > 0
                and f >= self._shard_window_end)

    def _shard_cut(self, frames: np.ndarray, start: int, n: int) -> int:
        """End of the maximal [start, end) run that stays inside the live
        shard's objects-per-shard and frame-window budgets."""
        end = n
        if self.catalog is None:
            return end
        if self.shard_objects is not None:
            end = min(end, start + self.shard_objects - self._shard_n_fed)
        if self.shard_frames is not None:
            if self._shard_window_end is None:
                W = self.shard_frames
                self._shard_window_end = (int(frames[start]) // W + 1) * W
            end = min(end, start + int(np.searchsorted(
                frames[start:n], self._shard_window_end, side="left")))
        return end

    def _ingest_chunk(self, crops: np.ndarray, frames: np.ndarray,
                      obj_ids: np.ndarray):
        """Pixel-diff + buffer one frame-sorted, single-shard segment,
        folding every completed CNN batch."""
        t0 = time.perf_counter()
        n = len(crops)
        if self.cfg.pixel_diff or self._gate is not None:
            # windows of the tracker's size: one pixel_match launch each;
            # a frame group cut by a window's edge resolves like one cut
            # by a chunk's
            step = _PixelTracker.WINDOW_ROWS
            for w0 in range(0, n, step):
                w1 = min(n, w0 + step)
                if self.cfg.pixel_diff:
                    self._tracker.prepare(frames[w0:w1], crops[w0:w1])
                for f, i, j in frame_groups(frames, w0, w1):
                    self._resolve_segment(f, crops[i:j], frames[i:j],
                                          obj_ids[i:j])
        else:
            self._buf.append(crops, obj_ids, frames)
        self.stats.wall_s += time.perf_counter() - t0
        if not self._runner_driven:
            self._drain_ready()

    def _resolve_segment(self, f: int, crops: np.ndarray,
                         frames: np.ndarray, ids: np.ndarray):
        """Roots for one frame-``f`` segment (tracker, then gate); buffer
        its uniques and log its duplicates."""
        if self.cfg.pixel_diff:
            roots = self._tracker.resolve(f, ids)
            self.stats.n_pixel_dedup += int((roots != ids).sum())
        else:
            roots = ids.copy()
        if self._gate is not None:
            roots = self._gate_segment(f, crops, ids, roots)
        uniq = roots == ids
        self._buf.append(crops[uniq], ids[uniq], frames[uniq])
        if not uniq.all():
            dup = ~uniq
            self._dup_objs.append(ids[dup])
            self._dup_frames.append(frames[dup])
            self._dup_roots.append(roots[dup])

    def _gate_segment(self, f: int, crops: np.ndarray, ids: np.ndarray,
                      roots: np.ndarray) -> np.ndarray:
        """Run one frame-``f`` segment's tracker-unique crops through the
        redundancy gate; returns the (possibly rewritten) roots. Gate
        hits become duplicates rooted at a ring entry (a CNN-bound
        object), misses are admitted as future ring entries."""
        uniq = roots == ids
        flat = crops[uniq].reshape(int(uniq.sum()),
                                   int(np.prod(crops.shape[1:])))
        groots = self._gate.match(f, flat)
        hit = groots >= 0
        if hit.any():
            roots = roots.copy()
            roots[np.nonzero(uniq)[0][hit]] = groots[hit]
            self.stats.n_gate_skipped += int(hit.sum())
            if self.cfg.pixel_diff:
                # the tracker must see the rewritten roots, else a
                # next-frame tracker match chains to a never-folded id
                self._tracker.amend_last(roots)
        self._gate.admit(flat[~hit], ids[uniq][~hit])
        return roots

    def take_ready_batch(self):
        """Pop one full CNN batch of buffered uniques."""
        return self._buf.take(self.cfg.batch_size)

    def take_tail(self):
        """Pop the remaining partial batch; empty arrays when nothing is
        buffered."""
        return self._buf.take(len(self._buf))

    def _drain_ready(self):
        while self.n_ready_batches:
            self._fold_crops(*self.take_ready_batch())

    def _fold_crops(self, crops, objs, frames):
        """Fold one CNN batch (a ready batch or the ragged tail) through
        whichever path drives this ingestor. The pipeline double-buffers:
        each submit dispatches the megastep, then host-folds the previous
        batch."""
        if self.pipeline is not None:
            self.pipeline.submit(crops, objs, frames)
            return
        t0 = time.perf_counter()
        probs, feats = self.cheap_apply(crops)
        self.stats.wall_s += time.perf_counter() - t0
        self.fold_batch(crops, objs, frames, probs, feats)

    # -- the chunk-step --------------------------------------------------------

    def fold_batch(self, crops: np.ndarray, obj_ids: np.ndarray,
                   frames: np.ndarray, probs: np.ndarray,
                   feats: np.ndarray):
        """Fold one CNN batch of unique objects into clustering state and
        the index, with ``slot_cid`` / eviction remaps carried across
        calls."""
        t0 = time.perf_counter()
        probs = np.asarray(probs)
        feats = np.asarray(feats, np.float32)
        self.stats.n_cnn_invocations += len(obj_ids)
        self.stats.cheap_flops += len(obj_ids) * self.cheap_flops_per_image

        if self._state is None:
            self._state = C.init_state(self.cfg.max_clusters, feats.shape[1],
                                       device=self.device)
        state, slots = self._cluster_fn(self._state, feats,
                                        self.cfg.threshold)
        self._state = state
        self._fold_rows(crops, obj_ids, frames, probs, feats,
                        slots.cpu().numpy())
        # eviction keeps the live table at M (paper: evict smallest)
        if int(self._state.n) >= int(self.cfg.high_water
                                     * self.cfg.max_clusters):
            self._evict_live()
        self.stats.wall_s += time.perf_counter() - t0

    def _fold_rows(self, crops: np.ndarray, obj_ids: np.ndarray,
                   frames: np.ndarray, probs: np.ndarray,
                   feats: np.ndarray, slots: np.ndarray):
        """Host bookkeeping for one clustered batch: slot -> cid mapping,
        SoA index fold, delta accounting."""
        if self.n_local_classes is None:
            self.n_local_classes = probs.shape[1]
        if self._index is None:
            self._index = TopKIndex(self.cfg.K, self.n_local_classes,
                                    self.class_map)
        # slot -> cid, assigning fresh cids in first-appearance order
        unmapped = self._slot_cid[slots] < 0
        if unmapped.any():
            new_slots, first_pos = np.unique(slots[unmapped],
                                             return_index=True)
            order = np.argsort(first_pos, kind="stable")
            fresh = self._next_cid + np.arange(len(new_slots))
            self._slot_cid[new_slots[order]] = fresh
            self._next_cid += len(new_slots)
            self._delta_new.extend(fresh.tolist())
        cids = self._slot_cid[slots]
        self._root_cid.update(zip(obj_ids.tolist(), cids.tolist()))

        touched = self._index.add_batch(cids, feats, probs, obj_ids, frames,
                                        crops=crops)
        self._delta_touched.update(
            self._index.store.row_cids[touched].tolist())
        self._delta_published += len(obj_ids)

    def _evict_live(self):
        """Evict the smallest clusters from the live table and remap
        ``slot_cid``. Host-side by design: eviction compacts the table
        with an argsort and rewrites the slot -> cid map, both entangled
        with index bookkeeping the device never sees."""
        state, evicted, remap = C.evict_smallest(self._state,
                                                 self.cfg.evict_frac)
        self.stats.n_evictions += len(evicted)
        self._delta_evictions += len(evicted)
        new_slot_cid = np.full_like(self._slot_cid, -1)
        live = remap >= 0
        new_slot_cid[remap[live]] = self._slot_cid[live]
        self._slot_cid = new_slot_cid
        self._state = state

    def _empty_index(self) -> TopKIndex:
        nl = (self.n_local_classes if self.n_local_classes is not None
              else (self.class_map.n_local
                    if self.class_map is not None else 0))
        return TopKIndex(self.cfg.K, nl, self.class_map)

    # -- shard rollover --------------------------------------------------------

    def _seal_shard(self):
        """Seal the live index as one archive shard: drain the tail batch,
        attach the remaining duplicates, save through the catalog, and
        reset all per-shard state (clustering table, slot->cid map, pixel
        tracker, redundancy gate, object ids). The next shard then ingests
        exactly like a fresh run, which is what makes every sealed shard
        byte-identical to a one-shot ``ingest()`` of its window."""
        self._drain_ready()
        if len(self._buf):
            self._fold_crops(*self.take_tail())
        if self.pipeline is not None:
            self.pipeline.flush_pending()
        if self._index is None:
            self._index = self._empty_index()
        self._attach_eligible()
        self._dup_objs, self._dup_frames, self._dup_roots = [], [], []
        seal_kw = ({} if self.shard_format is None
                   else {"format": self.shard_format})
        meta = self.catalog.seal(
            self._index,
            frame_lo=(self._shard_frame_lo
                      if self._shard_frame_lo is not None else 0),
            frame_hi=(self._shard_frame_hi
                      if self._shard_frame_hi is not None else 0),
            obj_base=self._shard_obj_base, **seal_kw)
        # clusters touched since the last flush now live in the sealed
        # shard; report them shard-tagged so a query-side cache can warm
        # them under their final identity
        self._delta_sealed.append(meta.shard_id)
        self._delta_touched_sealed.extend(
            (meta.shard_id, c) for c in sorted(self._delta_touched))
        self._delta_touched = set()
        self._delta_new = []
        self._state = None
        self._slot_cid = np.full(self.cfg.max_clusters, -1, np.int64)
        self._next_cid = 0
        self._tracker = _PixelTracker(self.cfg.pixel_diff_threshold,
                                      self.device)
        self._gate = (_RedundancyGate(self.cfg.gate_threshold,
                                      self.cfg.gate_capacity, self.device)
                      if self.cfg.gate else None)
        self._root_cid = {}
        self._index = (self._empty_index()
                       if self.n_local_classes is not None
                       or self.class_map is not None else None)
        self._shard_obj_base += self._shard_n_fed
        self._shard_n_fed = 0
        self._obj_next = 0
        self._shard_frame_lo = None
        self._shard_frame_hi = None
        self._shard_window_end = None
        if self.pipeline is not None:
            self.pipeline.reset()
        return meta

    # -- publication -----------------------------------------------------------

    def _attach_eligible(self):
        """Attach pending duplicates whose root's batch has folded."""
        if not self._dup_objs:
            return
        objs = np.concatenate(self._dup_objs)
        frames = np.concatenate(self._dup_frames)
        roots = np.concatenate(self._dup_roots)
        cids = np.array([self._root_cid.get(r, -1) for r in roots.tolist()],
                        np.int64)
        ready = cids >= 0
        if ready.any():
            self._index.attach(cids[ready], objs[ready], frames[ready])
            self._delta_published += int(ready.sum())
        hold = ~ready
        if hold.any():
            self._dup_objs = [objs[hold]]
            self._dup_frames = [frames[hold]]
            self._dup_roots = [roots[hold]]
        else:
            self._dup_objs, self._dup_frames, self._dup_roots = [], [], []

    def _prune_root_cids(self):
        """Drop root -> cid entries no future duplicate can reference: new
        dups only ever point at roots in the tracker's open/previous frame
        groups, and held dups carry their root explicitly. Keeps the map
        O(active window) over a continuously ingested stream instead of
        O(total unique objects)."""
        keep = set()
        for seg in self._tracker._open_roots:
            keep.update(seg.tolist())
        if self._tracker._prev_roots is not None:
            keep.update(self._tracker._prev_roots.tolist())
        for seg in self._dup_roots:
            keep.update(seg.tolist())
        if self._gate is not None:
            # gate roots can be far older than the tracker window; any
            # ring entry may still be matched (and need its cid) later
            keep |= self._gate.live_roots()
        self._root_cid = {r: c for r, c in self._root_cid.items()
                          if r in keep}

    def flush(self) -> IngestDelta:
        """Publish what has been ingested so far: attach eligible
        duplicates and report the clusters a query-side cache needs to
        refresh. Does NOT fold the partial unique batch — the batch
        partition must stay a function of the stream alone (that is what
        makes chunked and one-shot ingests identical)."""
        if self.pipeline is not None:
            self.pipeline.flush_pending()     # publication barrier
        t0 = time.perf_counter()
        self._attach_eligible()
        self._prune_root_cids()
        delta = IngestDelta(
            n_objects_published=self._delta_published,
            new_cids=list(self._delta_new),
            touched_cids=sorted(self._delta_touched),
            n_evictions=self._delta_evictions,
            n_pending_unique=self.n_pending_unique,
            n_pending_dups=self.n_pending_dups,
            sealed_shards=list(self._delta_sealed),
            touched_sealed=list(self._delta_touched_sealed))
        self._delta_new = []
        self._delta_touched = set()
        self._delta_evictions = 0
        self._delta_published = 0
        self._delta_sealed = []
        self._delta_touched_sealed = []
        self.stats.wall_s += time.perf_counter() - t0
        return delta

    def finish(self) -> Tuple[TopKIndex, IngestStats]:
        """Drain the final partial batch, attach the remaining duplicates,
        and return ``(index, stats)`` — after this the ingestor is closed.
        Under rollover the tail is sealed as the final shard and the
        returned index is the (empty) successor; the archive lives in the
        catalog."""
        if self._finished:
            return self._index, self.stats
        if self.catalog is not None:
            if self._shard_n_fed:
                self._seal_shard()
            if self._index is None:
                self._index = self._empty_index()
            self._finished = True
            return self._index, self.stats
        if not self._runner_driven:
            self._drain_ready()
        if len(self._buf):
            if self._runner_driven:
                raise RuntimeError(
                    "pending unique objects but no cheap_apply; a "
                    "runner-driven ingestor must be finished through "
                    "MultiStreamRunner.finish()")
            self._fold_crops(*self.take_tail())
        if self.pipeline is not None:
            self.pipeline.flush_pending()
        if self._index is None:          # empty stream: class width from the
            self._index = self._empty_index()   # class map, never dropped
        self._attach_eligible()
        # anything still pending has an unknown root (defensive): drop it
        self._dup_objs, self._dup_frames, self._dup_roots = [], [], []
        self._finished = True
        return self._index, self.stats


class StreamPlacement:
    """Deterministic stream -> mesh block placement for sharded ingest
    (DESIGN.md §13).

    A pure function of ``(names, n_devices)``, round-robin in the given
    name order: stream ``i`` lives on block ``i % n_devices``. The
    device-major ``slots`` list (each block's streams padded with
    ``None`` to a common width) is exactly the slot layout a
    ``ShardedIngestPipeline`` stacks along its leading stream axis, so the
    placement — and with it every stream's block and stacked row — is
    the same in every run and independent of feed() chunking.
    """

    def __init__(self, names, n_devices: int):
        names = list(names)
        if not names:
            raise ValueError("need at least one stream name")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stream names in {names!r}")
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        self.names = names
        self.n_devices = n_devices
        self.width = -(-len(names) // n_devices)        # ceil
        blocks: List[List[Optional[str]]] = [[] for _ in range(n_devices)]
        for i, nm in enumerate(names):
            blocks[i % n_devices].append(nm)
        for b in blocks:
            b.extend([None] * (self.width - len(b)))
        self.slots: List[Optional[str]] = [nm for b in blocks for nm in b]
        self._slot_of = {nm: s for s, nm in enumerate(self.slots)
                         if nm is not None}

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def slot_of(self, name: str) -> int:
        return self._slot_of[name]

    def device_of(self, name: str) -> int:
        return self._slot_of[name] // self.width

    def assignment(self) -> Dict[str, int]:
        """{stream name: block index} — the reproducibility contract."""
        return {nm: self.device_of(nm) for nm in self.names}


class MultiStreamRunner:
    """Round-robins N per-stream ingestors through one cheap CNN (a
    replica of it on each mesh block's device in sharded mode).

    Two modes:

    * **Staged** (``cheap_apply`` given; the ingestors have neither
      ``cheap_apply`` nor a pipeline): every ``step`` takes one ready
      batch (exactly ``cfg.batch_size`` unique crops) from each stream, in
      a rotating order, and folds it. Each stream's batch goes through
      ``cheap_apply`` at its own solo shape: the JAX package stacks the
      batches into one padded forward, but on the card a stacked forward
      gives other bits than the solo one (cuDNN and cuBLAS pick their
      algorithms by batch size), and the solo bits are the contract.
    * **Sharded** (``pipeline`` = a ``ShardedIngestPipeline``): each
      ingestor was constructed with ``pipeline=shared.handle(name)``;
      feeds enqueue per-stream batches and every ``step()`` runs ONE
      stacked step over the head batch of each stream, on every block's
      device at once (see ``make_sharded_runner``). The runner turns off
      the pipeline's auto-pump so batches stack *across* streams.

    Either way, per-stream fold order is preserved, so each stream's
    index is byte-identical to a self-driven run of its own.
    """

    def __init__(self, ingestors: Mapping[str, StreamingIngestor],
                 cheap_apply: Optional[Callable] = None, pipeline=None,
                 placement: Optional[StreamPlacement] = None):
        if not ingestors:
            raise ValueError("need at least one ingestor")
        if (cheap_apply is None) == (pipeline is None):
            raise ValueError(
                "pass exactly one of cheap_apply (staged) or pipeline "
                "(ShardedIngestPipeline)")
        if pipeline is not None:
            for name, ing in ingestors.items():
                h = ing.pipeline
                if h is None or getattr(h, "shared", None) is not pipeline:
                    raise ValueError(
                        f"ingestor {name!r} is not bound to this sharded "
                        f"pipeline; construct it with "
                        f"pipeline=shared.handle({name!r})")
            pipeline.auto_pump = False   # the runner owns step timing
        else:
            for name, ing in ingestors.items():
                if not ing._runner_driven:
                    raise ValueError(
                        f"ingestor {name!r} owns a cheap_apply/pipeline; "
                        f"runner-driven ingestors must be constructed "
                        f"with neither")
        self.ingestors: Dict[str, StreamingIngestor] = dict(ingestors)
        self.cheap_apply = cheap_apply
        self.pipeline = pipeline
        self.placement = placement
        self._rotation = list(self.ingestors)

    def feed(self, feeds: Mapping[str, Tuple[np.ndarray, np.ndarray]]):
        """Feed per-stream chunks, then fold every ready batch."""
        for name, (crops, frames) in feeds.items():
            self.ingestors[name].feed(crops, frames)
        self.drain()

    def step(self) -> int:
        """Up to one ready batch per stream. Staged mode rotates which
        stream goes first; sharded mode folds the head batch of every
        queued stream in one stacked step. Returns objects folded (0 =
        nothing ready)."""
        if self.pipeline is not None:
            for ing in self.ingestors.values():
                ing._drain_ready()       # enqueue ready batches
            return self.pipeline.pump_one()
        parts = []
        for name in self._rotation:
            ing = self.ingestors[name]
            if ing.n_ready_batches:
                parts.append((ing, *ing.take_ready_batch()))
        self._rotation = self._rotation[1:] + self._rotation[:1]
        self._fold_parts(parts)
        return int(sum(len(p[2]) for p in parts))

    def drain(self):
        while self.step():
            pass

    def _fold_parts(self, parts):
        for ing, crops, objs, frames in parts:
            t0 = time.perf_counter()
            probs, feats = self.cheap_apply(crops)
            ing.stats.wall_s += time.perf_counter() - t0
            ing.fold_batch(crops, objs, frames, probs, feats)

    def flush(self) -> Dict[str, IngestDelta]:
        self.drain()
        return {name: ing.flush() for name, ing in self.ingestors.items()}

    def finish(self) -> Dict[str, Tuple[TopKIndex, IngestStats]]:
        """Fold the ragged per-stream tails, then finalize every
        ingestor."""
        self.drain()
        if self.pipeline is None:
            self._fold_parts([(ing, *ing.take_tail())
                              for ing in self.ingestors.values()
                              if ing.n_pending_unique])
        # with a pipeline each finish() submits its own tail and flushes
        # the shared pipeline; catalog'd streams seal themselves
        return {name: ing.finish() for name, ing in self.ingestors.items()}


def make_sharded_runner(forward: Callable, mesh, stream_names,
                        cfg: Optional[IngestConfig] = None,
                        topk_k: Optional[int] = None,
                        topk_sink: Optional[Callable] = None,
                        ingestor_kwargs: Optional[Mapping[str, dict]] = None,
                        **common_kwargs) -> MultiStreamRunner:
    """The whole sharded multi-stream stack: a ``StreamPlacement`` over
    ``mesh.size`` blocks, one shared ``ShardedIngestPipeline`` running the
    tensor-level ``forward`` on block 0 and a replica of it on every other
    block's device, one ``StreamingIngestor`` per stream bound to its slot
    handle on its block's device (its pixel tracker and redundancy gate
    launch ``pixel_match`` on that card), and a ``MultiStreamRunner``
    driving it. One process drives every card of the mesh: ``mesh =
    launch.mesh.make_ingest_mesh(n)`` over the first n cards, with
    ``forward`` a module on ``mesh.devices[0]`` (``models.cnn.
    make_forward``); a forward that is no module serves only a mesh on one
    device.

    ``ingestor_kwargs`` maps stream name -> extra ``StreamingIngestor``
    kwargs (e.g. a per-stream ``catalog``); ``common_kwargs`` go to every
    ingestor. Per-stream cfg overrides are rejected by the pipeline — the
    stacked cluster tables share one shape and threshold.
    """
    from repro_torch.core.pipeline import ShardedIngestPipeline
    placement = StreamPlacement(stream_names, mesh.size)
    shared = ShardedIngestPipeline(forward, mesh, placement.slots, cfg=cfg,
                                   topk_k=topk_k, topk_sink=topk_sink)
    ingestors = {}
    for nm in placement.names:
        kw = dict(common_kwargs)
        kw.update((ingestor_kwargs or {}).get(nm, {}))
        kw.setdefault("cfg", cfg)
        kw.setdefault("device", mesh.devices[placement.device_of(nm)])
        ingestors[nm] = StreamingIngestor(None, pipeline=shared.handle(nm),
                                          **kw)
    return MultiStreamRunner(ingestors, pipeline=shared, placement=placement)
