"""The Focus top-K ingest index (paper §3, §4.1).

Structure (exactly the paper's):
    object class -> <cluster ID>
    cluster ID   -> [centroid object, <objects> in cluster, <frame IDs>]

Clusters carry a running mean of the cheap CNN's class probabilities; the
cluster's top-K class set is the top-K of that mean, which supports the
"dynamically adjusting K at query-time" enhancement (§5): lookup with any
Kx <= K uses rank information stored at ingest.

When the ingest CNN is *specialized* (§4.3), the index stores local class ids
(0..Ls-1 plus OTHER) and a ClassMap translates query-time global classes;
querying a class outside the specialized set routes to the OTHER clusters.

Storage is an array-backed SoA ``ClusterStore`` (DESIGN.md §4): centroids
(M, D), mean_probs (M, C), counts (M,), rep_crops (M, R, R, 3), plus an
append-only member/frame log compiled lazily into CSR form. Ingest-side
bookkeeping is batched (``add_batch``/``attach``) — no per-object Python
loop — and query-side ``_build``/``lookup`` are one vectorized
``argpartition`` over the (M, C) mean-probs matrix. The per-object
``Cluster`` dataclass remains as a compatibility view (``index.clusters``)
and as the unit of ``add_cluster``.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

OTHER = -1   # sentinel for the OTHER class in *global* space

INDEX_FORMAT = 4            # default save format (v4: quantized columnar)

# Format-level dequant multipliers for the v4 quantized columns. The stored
# per-row scale is the row's max magnitude; the effective dequant scale is
# ``GLOBAL * row_scale`` computed in float32, in that order — the JAX
# package's lazy archive path (``dequant_topk``) uses the same op order, so
# an index saved by either package loads to bitwise identical float32
# values.
PROB_GLOBAL_SCALE = np.float32(1.0 / 255.0)     # uint8 mean-probs
CENT_GLOBAL_SCALE = np.float32(1.0 / 127.0)     # int8 centroids


def _resolve_kx(Kx: Optional[int], K: int) -> int:
    """Validate a query-time Kx against the ingest-time K (shared by the
    eager ``TopKIndex.lookup`` and the archive's lazy shard lookup)."""
    if Kx is None:
        return K
    if Kx < 0:
        raise ValueError(f"Kx must be >= 0, got {Kx}")
    if Kx > K:
        raise ValueError(
            f"Kx={Kx} exceeds the ingest-time K={K}; ranks beyond "
            f"the top-K were not stored at ingest (re-ingest with a "
            f"larger K to query deeper)")
    return Kx


def _shrink_ints(a: np.ndarray) -> np.ndarray:
    """Narrowest of int16/int32/int64 holding ``a`` — chosen purely from
    the value range, so equal arrays always serialize identically (the
    byte-identity invariants depend on it)."""
    a = np.asarray(a, np.int64)
    if a.size == 0:
        return a.astype(np.int16)
    lo, hi = int(a.min()), int(a.max())
    for dt in (np.int16, np.int32):
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return a.astype(dt)
    return a


def _quant_rows_uint8(x: Optional[np.ndarray], n_rows: int):
    """Non-negative rows (M, C) -> (q uint8, row_scales f32 (M,)) with
    dequant ``q * (PROB_GLOBAL_SCALE * row_scales)``. All-zero rows get a
    sentinel scale of 1 so dequant stays exact (0)."""
    if x is None:
        return (np.zeros((n_rows, 0), np.uint8),
                np.ones((n_rows,), np.float32))
    x = np.asarray(x, np.float32)
    if x.size == 0:
        return x.astype(np.uint8), np.ones((x.shape[0],), np.float32)
    rowmax = x.max(axis=1)
    row_scales = np.where(rowmax > 0, rowmax, 1.0).astype(np.float32)
    scale = (PROB_GLOBAL_SCALE * row_scales).astype(np.float32)
    q = np.clip(np.round(x / scale[:, None]), 0, 255).astype(np.uint8)
    return q, row_scales


def _quant_rows_int8(x: Optional[np.ndarray], n_rows: int):
    """Signed rows (M, D) -> (q int8 in [-127, 127], row_scales f32 (M,))
    with dequant ``q * (CENT_GLOBAL_SCALE * row_scales)``."""
    if x is None:
        return (np.zeros((n_rows, 0), np.int8),
                np.ones((n_rows,), np.float32))
    x = np.asarray(x, np.float32)
    if x.size == 0:
        return x.astype(np.int8), np.ones((x.shape[0],), np.float32)
    rowmax = np.abs(x).max(axis=1)
    row_scales = np.where(rowmax > 0, rowmax, 1.0).astype(np.float32)
    scale = (CENT_GLOBAL_SCALE * row_scales).astype(np.float32)
    q = np.clip(np.round(x / scale[:, None]), -127, 127).astype(np.int8)
    return q, row_scales


def _quant_global_uint8(x: np.ndarray):
    """Bounded array -> (q uint8, qparams f32 (2,) = [scale, lo]) with
    dequant ``q * scale + lo`` — one affine grid per shard for rep-crops,
    which are bounded post-normalization."""
    x = np.asarray(x, np.float32)
    if x.size == 0:
        return x.astype(np.uint8), np.array([1.0, 0.0], np.float32)
    lo = np.float32(x.min())
    scale = np.float32((np.float32(x.max()) - lo) / np.float32(255.0))
    if scale <= 0:
        scale = np.float32(1.0)
    q = np.clip(np.round((x - lo) / scale), 0, 255).astype(np.uint8)
    return q, np.array([scale, lo], np.float32)


def dequant_crops(q: np.ndarray, qparams: np.ndarray) -> np.ndarray:
    """Invert ``_quant_global_uint8`` — shared by the eager loader and the
    archive's lazy per-row crop gather so both dequantize bitwise alike."""
    return (q.astype(np.float32) * np.float32(qparams[0])
            + np.float32(qparams[1]))


def saved_files(prefix: str) -> List[str]:
    """Suffixes (deterministic order) of the files ``TopKIndex.save``
    wrote at ``prefix``. THE enumeration unit for byte-identity
    comparisons and on-disk size accounting — formats <= 3 are
    ``.json`` + ``.npz``; v4 is ``.json`` plus one ``.npy`` per column."""
    with open(prefix + ".json") as f:
        meta = json.load(f)
    if meta.get("format", 1) >= 4:
        return [".json"] + [f".{c}.npy" for c in meta["columns"]]
    return [".json", ".npz"]


def saved_file_bytes(prefix: str) -> tuple:
    """((suffix, bytes), ...) of a saved index — the comparison unit used
    by every equivalence harness (rollover, chunked/one-shot, mesh)."""
    out = []
    for suf in saved_files(prefix):
        with open(prefix + suf, "rb") as f:
            out.append((suf, f.read()))
    return tuple(out)


def saved_nbytes(prefix: str) -> int:
    """Total on-disk bytes of a saved index."""
    return sum(os.path.getsize(prefix + suf) for suf in saved_files(prefix))


@dataclass
class ClassMap:
    """Global class id <-> local specialized id. Local Ls is OTHER."""
    global_ids: np.ndarray        # (Ls,) global ids of specialized classes

    @property
    def n_local(self) -> int:     # Ls + 1 (OTHER)
        return len(self.global_ids) + 1

    @property
    def other_local(self) -> int:
        return len(self.global_ids)

    def to_local(self, global_id: int) -> int:
        hits = np.nonzero(self.global_ids == global_id)[0]
        return int(hits[0]) if len(hits) else self.other_local

    def to_global(self, local_id: int) -> int:
        if local_id == self.other_local:
            return OTHER
        return int(self.global_ids[local_id])


@dataclass
class Cluster:
    """Per-cluster record. Still the unit of ``add_cluster`` and the
    materialization type of the ``index.clusters`` view; bulk ingest goes
    through ``ClusterStore.add_batch`` instead of per-object ``add``."""
    cluster_id: int
    centroid: np.ndarray                 # feature vector (D,)
    rep_crop: np.ndarray                 # centroid object's crop (for GT-CNN)
    mean_probs: np.ndarray               # (C_local,) running mean class probs
    count: int = 0
    members: List[int] = field(default_factory=list)   # object ids
    frames: List[int] = field(default_factory=list)    # frame ids

    def add(self, obj_id: int, frame_id: int, feat: np.ndarray,
            probs: np.ndarray, crop: Optional[np.ndarray] = None):
        self.count += 1
        a = 1.0 / self.count
        self.centroid = (1 - a) * self.centroid + a * feat
        self.mean_probs = (1 - a) * self.mean_probs + a * probs
        self.members.append(obj_id)
        self.frames.append(frame_id)
        if crop is not None and self.count == 1:
            self.rep_crop = crop

    def topk(self, k: int) -> np.ndarray:
        k = min(k, len(self.mean_probs))
        part = np.argpartition(-self.mean_probs, k - 1)[:k]
        return part[np.argsort(-self.mean_probs[part])]


def _grow(arr: Optional[np.ndarray], need: int, row_shape, dtype):
    """Amortized doubling of the leading axis; returns array with >= need
    rows (contents of live rows preserved)."""
    cap = 0 if arr is None else arr.shape[0]
    if cap >= need:
        return arr
    new_cap = max(64, cap * 2)
    while new_cap < need:
        new_cap *= 2
    out = np.zeros((new_cap, *row_shape), dtype)
    if arr is not None:
        out[:cap] = arr
    return out


class ClusterStore:
    """SoA cluster storage: all per-cluster scalars/vectors live in flat
    arrays indexed by row, with a dict only for the cid -> row map. The
    member/frame log is append-only (one entry per object) and compiled to
    CSR on demand for member listing; ``frames_of`` works straight off the
    flat log."""

    def __init__(self):
        self.n_rows = 0
        self.centroids: Optional[np.ndarray] = None     # (cap, D) f32
        self.mean_probs: Optional[np.ndarray] = None    # (cap, C) f32
        self.counts = np.zeros((0,), np.int64)          # (cap,) all members
        # CNN-folded members only: the running-mean weight. Attached
        # pixel-diff duplicates (never CNN'd) count toward ``counts`` but
        # must not change how later folds are weighted — otherwise the
        # centroid would depend on *when* the streaming ingestor attached
        # them, breaking chunked/one-shot equivalence.
        self.fold_counts = np.zeros((0,), np.int64)     # (cap,)
        self.rep_crops: Optional[np.ndarray] = None     # (cap, *crop_shape)
        self.first_objs = np.zeros((0,), np.int64)      # first member id
        self.row_cids = np.zeros((0,), np.int64)        # row -> cid
        self.versions = np.zeros((0,), np.int64)        # centroid generation
        self._cid_to_row: Dict[int, int] = {}
        # member/frame log for CNN-folded objects (append order is canonical:
        # it follows the batch partition, which is chunking-invariant)
        self.m_n = 0
        self._m_rows = np.zeros((0,), np.int64)
        self._m_objs = np.zeros((0,), np.int64)
        self._m_frames = np.zeros((0,), np.int64)
        # separate log for attached pixel-diff duplicates: their *timing*
        # depends on when the streaming ingestor flushed, so they are kept
        # apart and canonicalized by (obj, frame) order whenever read or
        # saved — a chunked ingest and a one-shot ingest produce the same
        # bytes regardless of when duplicates were attached
        self.a_n = 0
        self._a_rows = np.zeros((0,), np.int64)
        self._a_objs = np.zeros((0,), np.int64)
        self._a_frames = np.zeros((0,), np.int64)
        self._csr = None                       # (order, indptr, objs, frames)
        self._sorter = None                             # argsort of row_cids

    # -- rows ------------------------------------------------------------------

    def row_of(self, cid: int) -> int:
        return self._cid_to_row[cid]

    def rows_of(self, cids) -> np.ndarray:
        """Vectorized cid -> row map; raises KeyError on unknown cids (the
        dict-era contract)."""
        cids = np.asarray(cids, np.int64)
        if len(cids) == 0:
            return np.zeros((0,), np.int64)
        if self.n_rows == 0:
            raise KeyError(f"unknown cluster ids: {cids.tolist()[:5]}")
        rc = self.row_cids[:self.n_rows]
        if self._sorter is None:
            self._sorter = np.argsort(rc, kind="stable")
        pos = np.searchsorted(rc, cids, sorter=self._sorter)
        rows = self._sorter[np.minimum(pos, self.n_rows - 1)]
        bad = rc[rows] != cids
        if bad.any():
            raise KeyError(f"unknown cluster ids: "
                           f"{np.unique(cids[bad]).tolist()[:5]}")
        return rows

    def _new_rows(self, cids: np.ndarray, feat_dim: int, n_classes: int,
                  crop_shape) -> np.ndarray:
        """Allocate rows for cids (must be unseen); returns row ids.
        ``crop_shape=None`` defers rep_crop storage until a crop-bearing
        add supplies the shape (rows allocated before that read as
        zero crops)."""
        k = len(cids)
        need = self.n_rows + k
        self.centroids = _grow(self.centroids, need, (feat_dim,), np.float32)
        self.mean_probs = _grow(self.mean_probs, need, (n_classes,),
                                np.float32)
        self.counts = _grow(self.counts, need, (), np.int64)
        self.fold_counts = _grow(self.fold_counts, need, (), np.int64)
        if crop_shape is not None or self.rep_crops is not None:
            if crop_shape is None:
                crop_shape = self.rep_crops.shape[1:]
            self.rep_crops = _grow(self.rep_crops, need, crop_shape,
                                   np.float32)
        self.first_objs = _grow(self.first_objs, need, (), np.int64)
        self.row_cids = _grow(self.row_cids, need, (), np.int64)
        self.versions = _grow(self.versions, need, (), np.int64)
        rows = np.arange(self.n_rows, need, dtype=np.int64)
        self.row_cids[rows] = cids
        for c, r in zip(cids.tolist(), rows.tolist()):
            self._cid_to_row[c] = r
        self.n_rows = need
        self._sorter = None
        self._csr = None          # indptr must cover the new rows
        return rows

    def _append_log(self, rows: np.ndarray, obj_ids: np.ndarray,
                    frame_ids: np.ndarray):
        k = len(rows)
        need = self.m_n + k
        self._m_rows = _grow(self._m_rows, need, (), np.int64)
        self._m_objs = _grow(self._m_objs, need, (), np.int64)
        self._m_frames = _grow(self._m_frames, need, (), np.int64)
        self._m_rows[self.m_n:need] = rows
        self._m_objs[self.m_n:need] = obj_ids
        self._m_frames[self.m_n:need] = frame_ids
        self.m_n = need
        self._csr = None

    def _append_attach_log(self, rows: np.ndarray, obj_ids: np.ndarray,
                           frame_ids: np.ndarray):
        k = len(rows)
        need = self.a_n + k
        self._a_rows = _grow(self._a_rows, need, (), np.int64)
        self._a_objs = _grow(self._a_objs, need, (), np.int64)
        self._a_frames = _grow(self._a_frames, need, (), np.int64)
        self._a_rows[self.a_n:need] = rows
        self._a_objs[self.a_n:need] = obj_ids
        self._a_frames[self.a_n:need] = frame_ids
        self.a_n = need
        self._csr = None

    def _attach_canonical(self):
        """Attach-log entries in canonical (obj, frame) order — independent
        of when the streaming ingestor attached them."""
        rows = self._a_rows[:self.a_n]
        objs = self._a_objs[:self.a_n]
        frames = self._a_frames[:self.a_n]
        if self.a_n == 0:
            return rows, objs, frames
        order = np.lexsort((frames, objs))
        return rows[order], objs[order], frames[order]

    # -- batched ingest --------------------------------------------------------

    def add_batch(self, cids: np.ndarray, feats: np.ndarray,
                  probs: np.ndarray, obj_ids: np.ndarray,
                  frame_ids: np.ndarray, crops: Optional[np.ndarray] = None,
                  ) -> np.ndarray:
        """Fold a batch of objects into their clusters — vectorized.

        cids (B,) may repeat; unseen cids get fresh rows whose rep_crop is
        the first occurrence's crop. Running means are updated with one
        segment-sum per array: for a row with prior count c receiving k new
        values, new_mean = (c·mean + Σx) / (c + k) — exactly k sequential
        running-mean folds.

        Returns the sorted row ids whose centroid/mean_probs changed; their
        ``versions`` entries are bumped so label caches keyed on
        (cid, version) invalidate precisely.
        """
        cids = np.asarray(cids, np.int64)
        if len(cids) == 0:
            return np.zeros((0,), np.int64)
        obj_ids = np.asarray(obj_ids, np.int64)
        frame_ids = np.asarray(frame_ids, np.int64)
        feats = np.asarray(feats, np.float32)
        probs = np.asarray(probs, np.float32)

        # allocate rows for first-seen cids, in first-occurrence order
        uniq, first_pos = np.unique(cids, return_index=True)
        fresh_mask = np.array([c not in self._cid_to_row
                               for c in uniq.tolist()])
        if fresh_mask.any():
            order = np.argsort(first_pos[fresh_mask], kind="stable")
            fresh_cids = uniq[fresh_mask][order]
            fresh_first = first_pos[fresh_mask][order]
            if crops is not None:
                crop_shape = crops.shape[1:]
            elif self.rep_crops is not None:
                crop_shape = self.rep_crops.shape[1:]   # keep existing shape
            else:
                crop_shape = None                       # defer until known
            rows = self._new_rows(fresh_cids, feats.shape[1], probs.shape[1],
                                  crop_shape)
            if crops is not None:
                self.rep_crops[rows] = crops[fresh_first]
            self.first_objs[rows] = obj_ids[fresh_first]

        b_rows = self.rows_of(cids)
        # segment-sum over the *touched* rows only: O(B + k·(D+C)) per
        # batch, independent of total store size (evicted clusters stay in
        # the index, so n_rows grows without bound over a long stream)
        touched, inv = np.unique(b_rows, return_inverse=True)
        k = len(touched)
        add_cnt = np.bincount(inv, minlength=k).astype(np.int64)
        feat_sum = np.zeros((k, feats.shape[1]), np.float64)
        np.add.at(feat_sum, inv, feats.astype(np.float64))
        prob_sum = np.zeros((k, probs.shape[1]), np.float64)
        np.add.at(prob_sum, inv, probs.astype(np.float64))

        old_cnt = self.fold_counts[touched]
        new_cnt = old_cnt + add_cnt
        denom = new_cnt.astype(np.float64)[:, None]
        self.centroids[touched] = (
            (self.centroids[touched] * old_cnt[:, None] + feat_sum)
            / denom).astype(np.float32)
        self.mean_probs[touched] = (
            (self.mean_probs[touched] * old_cnt[:, None] + prob_sum)
            / denom).astype(np.float32)
        self.fold_counts[touched] = new_cnt
        self.counts[touched] += add_cnt
        self.versions[touched] += 1
        self._append_log(b_rows, obj_ids, frame_ids)
        return touched

    def attach(self, cids: np.ndarray, obj_ids: np.ndarray,
               frame_ids: np.ndarray):
        """Attach members without moving centroids/probs (pixel-diff
        duplicates share their root's cluster, §4.2)."""
        cids = np.asarray(cids, np.int64)
        if len(cids) == 0:
            return
        rows = self.rows_of(cids)
        uniq, cnt = np.unique(rows, return_counts=True)
        # focuslint: disable=cache-version -- intentional exemption:
        # attach only bumps counts; GT labels key on (cid, version) over
        # centroids/mean_probs, which attach leaves untouched
        self.counts[uniq] += cnt
        self._append_attach_log(rows, np.asarray(obj_ids, np.int64),
                                np.asarray(frame_ids, np.int64))

    # -- reads -----------------------------------------------------------------

    def _build_csr(self):
        """CSR over the combined log: fold entries (append order) followed
        by attach entries in canonical order, so per-row member lists are
        identical however the stream was chunked."""
        if self._csr is None:
            a_rows, a_objs, a_frames = self._attach_canonical()
            rows = np.concatenate([self._m_rows[:self.m_n], a_rows])
            objs = np.concatenate([self._m_objs[:self.m_n], a_objs])
            frames = np.concatenate([self._m_frames[:self.m_n], a_frames])
            order = np.argsort(rows, kind="stable")
            counts = np.bincount(rows, minlength=self.n_rows)
            indptr = np.zeros(self.n_rows + 1, np.int64)
            np.cumsum(counts, out=indptr[1:])
            self._csr = (order, indptr, objs, frames)
        return self._csr

    def drop_log_of(self, row: int):
        """Remove a row's member/frame log entries (cluster replacement —
        rare, O(log size))."""
        keep = self._m_rows[:self.m_n] != row
        kept = int(keep.sum())
        self._m_rows[:kept] = self._m_rows[:self.m_n][keep]
        self._m_objs[:kept] = self._m_objs[:self.m_n][keep]
        self._m_frames[:kept] = self._m_frames[:self.m_n][keep]
        self.m_n = kept
        a_keep = self._a_rows[:self.a_n] != row
        a_kept = int(a_keep.sum())
        self._a_rows[:a_kept] = self._a_rows[:self.a_n][a_keep]
        self._a_objs[:a_kept] = self._a_objs[:self.a_n][a_keep]
        self._a_frames[:a_kept] = self._a_frames[:self.a_n][a_keep]
        self.a_n = a_kept
        self._csr = None

    def members_of(self, row: int):
        order, indptr, objs, frames = self._build_csr()
        sel = order[indptr[row]:indptr[row + 1]]
        return objs[sel], frames[sel]

    def frames_of_rows(self, rows: np.ndarray) -> np.ndarray:
        """Union of frame ids over the given rows — O(selected members) via
        the cached CSR, not a scan of the whole log."""
        order, indptr, _, frames = self._build_csr()
        if len(rows) == 0:
            return np.array([], np.int64)
        sel = np.concatenate([order[indptr[r]:indptr[r + 1]] for r in rows])
        return np.unique(frames[sel]).astype(np.int64)

    def frames_of_each(self, rows: np.ndarray) -> List[np.ndarray]:
        """Per-row sorted unique frame ids (one array per row) — lets a
        caller detach from the store before it knows which rows it will
        keep (archive fan-out under an LRU-bounded loader)."""
        order, indptr, _, frames = self._build_csr()
        return [np.unique(frames[order[indptr[r]:indptr[r + 1]]]
                          ).astype(np.int64) for r in rows]


class _ViewCluster(Cluster):
    """Materialized snapshot handed out by ``index.clusters``; writes do not
    reach the store, so the mutating entry point fails loudly."""

    def add(self, *a, **kw):
        raise TypeError(
            "index.clusters[...] is a read-only snapshot; ingest through "
            "TopKIndex.add_batch/attach/add_cluster instead")


class _ClustersView(Mapping):
    """Read-only dict-like view materializing ``Cluster`` records from the
    SoA store on access (compat for ``index.clusters[cid].members[0]``-style
    callers; hot paths should use the vectorized TopKIndex methods)."""

    def __init__(self, store: ClusterStore):
        self._store = store

    def __getitem__(self, cid: int) -> Cluster:
        s = self._store
        row = s._cid_to_row[cid]
        members, frames = s.members_of(row)
        return _ViewCluster(
            cluster_id=int(cid),
            centroid=s.centroids[row],
            rep_crop=(s.rep_crops[row] if s.rep_crops is not None
                      else np.zeros((0,), np.float32)),
            mean_probs=s.mean_probs[row],
            count=int(s.counts[row]),
            members=members.tolist(),
            frames=frames.tolist(),
        )

    def __len__(self) -> int:
        return self._store.n_rows

    def __iter__(self) -> Iterator[int]:
        return iter(self._store.row_cids[:self._store.n_rows].tolist())


class TopKIndex:
    """class -> clusters inverted index, built at ingest time."""

    def __init__(self, K: int, n_local_classes: int,
                 class_map: Optional[ClassMap] = None):
        self.K = K
        self.n_local_classes = n_local_classes
        self.class_map = class_map
        self.store = ClusterStore()
        self._ranks: Optional[np.ndarray] = None   # (M, C) int32; K = miss

    @property
    def clusters(self) -> _ClustersView:
        return _ClustersView(self.store)

    # -- ingest-side -----------------------------------------------------------

    def add_cluster(self, cluster: Cluster):
        s = self.store
        if cluster.cluster_id in s._cid_to_row:
            # dict-era semantics: re-adding a cid replaces the cluster
            row = s._cid_to_row[cluster.cluster_id]
            s.drop_log_of(row)
        else:
            row = s._new_rows(np.array([cluster.cluster_id], np.int64),
                              len(cluster.centroid),
                              len(cluster.mean_probs),
                              cluster.rep_crop.shape)[0]
        s.centroids[row] = cluster.centroid
        s.mean_probs[row] = cluster.mean_probs
        s.rep_crops[row] = cluster.rep_crop
        s.counts[row] = cluster.count
        s.fold_counts[row] = cluster.count
        s.versions[row] += 1
        if cluster.members:
            s.first_objs[row] = cluster.members[0]
            s._append_log(np.full(len(cluster.members), row, np.int64),
                          np.asarray(cluster.members, np.int64),
                          np.asarray(cluster.frames, np.int64))
        self._refresh_ranks(np.array([row], np.int64))

    def add_batch(self, cids, feats, probs, obj_ids, frame_ids, crops=None):
        touched = self.store.add_batch(cids, feats, probs, obj_ids,
                                       frame_ids, crops)
        self._refresh_ranks(touched)
        return touched

    def attach(self, cids, obj_ids, frame_ids):
        self.store.attach(cids, obj_ids, frame_ids)

    # -- query-side ------------------------------------------------------------

    def _rank_rows(self, P: np.ndarray) -> np.ndarray:
        """Rank matrix (m, C) for probability rows P: rank of class c in the
        row's top-K mean probs, or K when c is outside the top-K — one
        vectorized sort over the rows instead of a per-cluster Python loop.

        Ties break to the LOWEST class index (stable argsort on the negated
        rows) — the tie order of the JAX package's ``topk`` and
        ``dequant_topk`` kernels, so rank answers agree across packages
        even where quantization collapses nearby probabilities into exact
        ties."""
        m, C = P.shape
        K = min(self.K, C)
        top = np.argsort(-P, axis=1, kind="stable")[:, :K]     # (m, K)
        ranks = np.full((m, C), K, np.int32)
        np.put_along_axis(ranks, top,
                          np.broadcast_to(np.arange(K, dtype=np.int32),
                                          (m, K)), 1)
        return ranks

    def _build(self):
        s = self.store
        M = s.n_rows
        if M == 0:
            self._ranks = np.zeros((0, 0), np.int32)
            return
        self._ranks = self._rank_rows(s.mean_probs[:M])

    def _refresh_ranks(self, rows: np.ndarray):
        """Incrementally maintain the rank matrix for the touched rows only,
        so interleaved ingest/query streaming pays O(touched · C) per batch
        instead of a full O(M · C) rebuild on the next lookup."""
        if self._ranks is None:
            return                       # built lazily on the next lookup
        s = self.store
        M = s.n_rows
        C = s.mean_probs.shape[1] if s.mean_probs is not None else 0
        if self._ranks.shape != (M, C):
            if self._ranks.shape[1] != C:
                self._ranks = None       # class width changed: full rebuild
                return
            grown = np.full((M, C), min(self.K, C), np.int32)
            grown[:self._ranks.shape[0]] = self._ranks
            self._ranks = grown
        rows = np.asarray(rows, np.int64)
        if len(rows):
            self._ranks[rows] = self._rank_rows(s.mean_probs[rows])

    def lookup(self, global_class: int, Kx: Optional[int] = None) -> List[int]:
        """Cluster ids whose top-Kx (local) classes include the queried
        class. ``Kx=None`` means the ingest-time K; ``Kx=0`` selects no
        clusters; negative Kx is an error, and so is ``Kx > K`` — rank
        information beyond the ingest-time top-K was never stored, so
        silently clamping would drop clusters whose class sits at rank
        K..Kx-1 with no signal to the caller."""
        if self._ranks is None:
            self._build()
        Kx = _resolve_kx(Kx, self.K)
        local = (self.class_map.to_local(global_class)
                 if self.class_map is not None else global_class)
        if self._ranks.size == 0 or not 0 <= local < self._ranks.shape[1]:
            return []
        rows = np.nonzero(self._ranks[:, local] < Kx)[0]
        return self.store.row_cids[rows].tolist()

    def frames_of(self, cids: Sequence[int]) -> np.ndarray:
        if len(cids) == 0:
            return np.array([], np.int64)
        return self.store.frames_of_rows(self.store.rows_of(cids))

    def rep_crops(self, cids: Sequence[int]) -> np.ndarray:
        if self.store.rep_crops is None:
            raise ValueError("no representative crops were stored "
                             "(add_batch was called without crops)")
        return self.store.rep_crops[self.store.rows_of(cids)]

    def first_members(self, cids: Sequence[int]) -> np.ndarray:
        """First (centroid-representative) object id per cluster —
        vectorized fast path for ``clusters[cid].members[0]``."""
        return self.store.first_objs[self.store.rows_of(cids)]

    # -- stats / persistence ---------------------------------------------------

    @property
    def n_clusters(self) -> int:
        return self.store.n_rows

    @property
    def n_objects(self) -> int:
        return int(self.store.counts[:self.store.n_rows].sum())

    def summary(self) -> dict:
        if self._ranks is None:
            self._build()
        if self._ranks.size:
            K = min(self.K, self._ranks.shape[1])
            n_indexed = int((self._ranks < K).any(axis=0).sum())
        else:
            n_indexed = 0
        return {
            "K": self.K,
            "n_clusters": self.n_clusters,
            "n_objects": self.n_objects,
            "n_classes_indexed": n_indexed,
            "specialized": self.class_map is not None,
        }

    def save(self, path: str, *, format: int = INDEX_FORMAT):
        """Persist index metadata + arrays (MongoDB stand-in, §5).

        Format v4 (default) is quantized columnar: one mmap-able ``.npy``
        per field — centroids int8 + per-row scales, mean-probs uint8 +
        per-row scales, rep-crops uint8 on one per-shard affine grid, and
        log/int columns narrowed to the smallest int dtype holding their
        range. Every quantization parameter is a pure function of the
        array values, so equal indexes still save byte-identically (the
        rollover / chunked-one-shot / mesh invariants carry over to v4
        unchanged). Format v3 (``format=3``) keeps the fp32 single-npz
        columnar layout for baselines and migration tests; the attach log
        is written in canonical (obj, frame) order in both. ``load`` reads
        all four layouts (v1 dict-era, v2 single-log, v3, v4).
        """
        if format not in (3, 4):
            raise ValueError(f"unsupported save format {format}")
        s = self.store
        M = s.n_rows
        log_rows = s._m_rows[:s.m_n]
        att_rows, att_objs, att_frames = s._attach_canonical()
        meta = {
            "format": format,
            "K": self.K,
            "n_local_classes": self.n_local_classes,
            "class_map": (self.class_map.global_ids.tolist()
                          if self.class_map else None),
        }
        if format == 3:
            arrays = {
                "row_cids": s.row_cids[:M],
                "centroids": (s.centroids[:M] if s.centroids is not None
                              else np.zeros((M, 0), np.float32)),
                "mean_probs": (s.mean_probs[:M] if s.mean_probs is not None
                               else np.zeros((M, 0), np.float32)),
                "rep_crops": (s.rep_crops[:M] if s.rep_crops is not None
                              else np.zeros((M, 0), np.float32)),
                "counts": s.counts[:M],
                "first_objs": s.first_objs[:M],
                "versions": s.versions[:M],
                "log_cids": s.row_cids[log_rows],
                "log_objs": s._m_objs[:s.m_n],
                "log_frames": s._m_frames[:s.m_n],
                "att_cids": s.row_cids[att_rows],
                "att_objs": att_objs,
                "att_frames": att_frames,
            }
            np.savez_compressed(path + ".npz", **arrays)
            with open(path + ".json", "w") as f:
                json.dump(meta, f)
            return

        cents_q, cent_scales = _quant_rows_int8(
            s.centroids[:M] if s.centroids is not None else None, M)
        probs_q, prob_scales = _quant_rows_uint8(
            s.mean_probs[:M] if s.mean_probs is not None else None, M)
        crops = (s.rep_crops[:M] if s.rep_crops is not None
                 else np.zeros((M, 0), np.float32))
        crops_q, crop_qparams = _quant_global_uint8(crops)
        columns = {
            "row_cids": _shrink_ints(s.row_cids[:M]),
            "counts": _shrink_ints(s.counts[:M]),
            "first_objs": _shrink_ints(s.first_objs[:M]),
            "versions": _shrink_ints(s.versions[:M]),
            "log_cids": _shrink_ints(s.row_cids[log_rows]),
            "log_objs": _shrink_ints(s._m_objs[:s.m_n]),
            "log_frames": _shrink_ints(s._m_frames[:s.m_n]),
            "att_cids": _shrink_ints(s.row_cids[att_rows]),
            "att_objs": _shrink_ints(att_objs),
            "att_frames": _shrink_ints(att_frames),
            "centroids_q": cents_q,
            "centroid_scales": cent_scales,
            "mean_probs_q": probs_q,
            "prob_scales": prob_scales,
            "rep_crops_q": crops_q,
            "crop_qparams": crop_qparams,
        }
        meta["columns"] = list(columns)
        meta["n_rows"] = int(M)
        meta["crop_shape"] = list(crops.shape[1:])
        # column files first, manifest last: a crash mid-save leaves at
        # worst orphan .npy files that no manifest references
        for name, arr in columns.items():
            np.save(path + f".{name}.npy", arr)
        with open(path + ".json", "w") as f:
            json.dump(meta, f)

    def save_bytes(self, *, format: int = INDEX_FORMAT) -> tuple:
        """((suffix, bytes), ...) of this index as ``save`` writes it —
        THE byte-identity comparison unit pinned by the streaming /
        pipeline / mesh equivalence harnesses and the ingest bench gate.
        One implementation (via ``saved_file_bytes``), so a save-format
        change cannot silently diverge what the harnesses compare."""
        import tempfile
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "idx")
            self.save(path, format=format)
            return saved_file_bytes(path)

    def _load_columnar(self, arrays: Mapping):
        s = self.store
        cids = np.asarray(arrays["row_cids"], np.int64)
        if len(cids) == 0:
            return
        cents = np.asarray(arrays["centroids"], np.float32)
        probs = np.asarray(arrays["mean_probs"], np.float32)
        crops = np.asarray(arrays["rep_crops"], np.float32)
        crop_shape = crops.shape[1:] if crops.shape[1:] != (0,) else None
        rows = s._new_rows(cids, cents.shape[1], probs.shape[1], crop_shape)
        s.centroids[rows] = cents
        s.mean_probs[rows] = probs
        if crop_shape is not None:
            s.rep_crops[rows] = crops
        s.counts[rows] = np.asarray(arrays["counts"], np.int64)
        s.fold_counts[rows] = s.counts[rows]     # attach share removed below
        s.first_objs[rows] = np.asarray(arrays["first_objs"], np.int64)
        s.versions[rows] = np.asarray(arrays["versions"], np.int64)
        log_cids = np.asarray(arrays["log_cids"], np.int64)
        if len(log_cids):
            s._append_log(s.rows_of(log_cids),
                          np.asarray(arrays["log_objs"], np.int64),
                          np.asarray(arrays["log_frames"], np.int64))
        if "att_cids" in arrays:        # v3: separate attach log
            att_cids = np.asarray(arrays["att_cids"], np.int64)
            if len(att_cids):
                att_rows = s.rows_of(att_cids)
                s._append_attach_log(
                    att_rows,
                    np.asarray(arrays["att_objs"], np.int64),
                    np.asarray(arrays["att_frames"], np.int64))
                s.fold_counts[:s.n_rows] -= np.bincount(
                    att_rows, minlength=s.n_rows).astype(np.int64)

    @classmethod
    def load(cls, path: str) -> "TopKIndex":
        with open(path + ".json") as f:
            meta = json.load(f)
        cmap = (ClassMap(np.array(meta["class_map"]))
                if meta["class_map"] is not None else None)
        idx = cls(meta["K"], meta["n_local_classes"], cmap)
        fmt = meta.get("format", 1)
        if fmt >= 4:
            cols = {name: np.load(path + f".{name}.npy")
                    for name in meta["columns"]}
            idx._load_columnar(_dequant_v4(meta, cols))
            return idx
        arrays = np.load(path + ".npz")
        if fmt >= 2:
            idx._load_columnar(arrays)
        else:                      # dict-era layout: per-cid npz keys
            for cid_s, info in meta["clusters"].items():
                cid = int(cid_s)
                idx.add_cluster(Cluster(
                    cid, arrays[f"centroid_{cid}"], arrays[f"crop_{cid}"],
                    arrays[f"probs_{cid}"], count=info["count"],
                    members=info["members"], frames=info["frames"]))
        return idx

    @property
    def nbytes(self) -> int:
        """Heap bytes of the store's arrays (allocated capacity) plus the
        rank matrix — the resident-size unit the archive's bytes-bounded
        ``ShardLoader`` accounts eagerly loaded shards with."""
        s = self.store
        total = 0
        for a in (s.centroids, s.mean_probs, s.rep_crops):
            if a is not None:
                total += a.nbytes
        for a in (s.counts, s.fold_counts, s.first_objs, s.row_cids,
                  s.versions, s._m_rows, s._m_objs, s._m_frames,
                  s._a_rows, s._a_objs, s._a_frames):
            total += a.nbytes
        if s._csr is not None:
            total += sum(int(x.nbytes) for x in s._csr)
        if s._sorter is not None:
            total += s._sorter.nbytes
        if self._ranks is not None:
            total += self._ranks.nbytes
        return total


def _dequant_v4(meta: Mapping, cols: Mapping) -> Dict[str, np.ndarray]:
    """Reconstruct the v3-shaped column mapping from v4 quantized columns
    (the shared dequant math — bitwise identical to the lazy archive
    path's in-kernel / per-row dequantization)."""
    M = int(meta["n_rows"])
    cents = (cols["centroids_q"].astype(np.float32)
             * (CENT_GLOBAL_SCALE
                * cols["centroid_scales"].astype(np.float32))[:, None])
    probs = (cols["mean_probs_q"].astype(np.float32)
             * (PROB_GLOBAL_SCALE
                * cols["prob_scales"].astype(np.float32))[:, None])
    crop_shape = tuple(meta["crop_shape"])
    crops = dequant_crops(cols["rep_crops_q"],
                          cols["crop_qparams"]).reshape((M, *crop_shape))
    out = {"centroids": cents, "mean_probs": probs, "rep_crops": crops}
    for name in ("row_cids", "counts", "first_objs", "versions",
                 "log_cids", "log_objs", "log_frames",
                 "att_cids", "att_objs", "att_frames"):
        out[name] = np.asarray(cols[name], np.int64)
    return out
