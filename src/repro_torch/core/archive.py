"""Time-sharded archive of top-K indexes with cross-shard query fan-out.

Focus's headline scenario is "after the fact" queries over *many days* of
recorded video (paper §1, §5), but a single in-memory ``TopKIndex`` grows
without bound over a long stream and a query must hold the whole archive's
centroids and rep-crops resident. Following the partitioned-repository
shape of zero-streaming cameras / ExSample, the archive here is a sequence
of **time shards**: ``StreamingIngestor`` seals its live index at an
objects-per-shard or frame-window boundary (through ``TopKIndex.save`` —
v4 quantized columnar by default), resets clustering state, and keeps
feeding. Each
sealed shard is byte-identical to a one-shot ``ingest()`` of its window —
the rollover invariant.

* ``ShardCatalog`` — the JSON manifest (shard id, frame window, object /
  cluster counts, object-id base, on-disk bytes, paths) plus
  ``seal``/``load_shard``; the manifest is written atomically (temp file +
  ``os.replace``), so a crash mid-seal leaves at worst orphan shard files
  that no manifest references.
* ``LazyShardIndex`` — the query-side view of a v4 quantized shard:
  per-column ``.npy`` files opened ``mmap_mode="r"``, ranks computed on
  ``device`` by the fused ``dequant_topk`` kernel (``hopper.ops``)
  straight off the uint8 mean-prob rows, rep-crops dequantized per
  gathered row only when a cluster actually reaches the GT pass.
* ``ShardLoader`` — LRU-bounded loader whose capacity is **bytes
  resident** (materialized heap per shard), with a deprecated shard-count
  mode for old callers; loads/hits/evictions are counted.
* ``ArchiveQueryEngine`` — extends ``QueryEngine``'s batching one level up:
  ``query_many`` fans ``lookup`` out across all shards, unions the
  **uncached** rep crops across all shards *and* all queries into one
  bucket-padded GT-CNN pass, and merges frame results per query. The
  GT-label cache is keyed ``(shard, cid, version)`` (stored row-aligned
  per shard, so the probe is one vectorized compare) and survives shard
  eviction *and* live-shard rollover: the live shard's id becomes the
  sealed shard's id and ``versions`` round-trip through ``save``, so a
  warm engine re-verifies nothing after a rollover. Query cost therefore
  scales with uncached candidates, not archive size.
"""
from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from dataclasses import asdict, dataclass
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.engine import (classify_crops, grow_row_cache,
                                     normalize_kx, probe_row_cache)
from repro_torch.core.index import (INDEX_FORMAT, PROB_GLOBAL_SCALE,
                                    ClassMap, TopKIndex, _resolve_kx,
                                    dequant_crops, saved_nbytes)
from repro_torch.hopper import ops as hops

CATALOG_NAME = "catalog.json"


@dataclass
class ShardMeta:
    """One sealed shard in the catalog manifest."""
    shard_id: int
    frame_lo: int                # first frame fed into the shard
    frame_hi: int                # last frame fed into the shard
    n_objects: int               # members in the shard index (folds+attaches)
    n_clusters: int
    obj_base: int                # global arrival position of the shard's
                                 # first object (ids inside are shard-local)
    path: str                    # basename under the catalog root
    n_bytes: int = 0             # on-disk bytes of the shard's index files
                                 # (0 in pre-v4 manifests)


class ShardCatalog:
    """JSON manifest of sealed shards under one archive directory.

    ``<root>/catalog.json`` lists the shards in time order; each shard's
    index lives at ``<root>/<path>.*`` (v4 quantized per-column ``.npy``
    by default; any ``TopKIndex`` format loads).
    """

    FORMAT = 1

    def __init__(self, root: str):
        self.root = root
        self.shards: List[ShardMeta] = []

    @classmethod
    def open(cls, root: str) -> "ShardCatalog":
        """Load the manifest at ``root`` (an empty catalog if absent)."""
        cat = cls(root)
        manifest = os.path.join(root, CATALOG_NAME)
        if os.path.exists(manifest):
            with open(manifest) as f:
                data = json.load(f)
            cat.shards = [ShardMeta(**m) for m in data["shards"]]
        return cat

    def save(self):
        """Atomically rewrite the manifest: the new contents go to a temp
        file that ``os.replace`` swaps in, so a crash mid-write can never
        leave a truncated/corrupt ``catalog.json`` — readers see either
        the old manifest or the new one."""
        os.makedirs(self.root, exist_ok=True)
        final = os.path.join(self.root, CATALOG_NAME)
        tmp = final + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"format": self.FORMAT,
                       "shards": [asdict(m) for m in self.shards]}, f,
                      indent=1)
        os.replace(tmp, final)

    def next_shard_id(self) -> int:
        return self.shards[-1].shard_id + 1 if self.shards else 0

    def path_of(self, shard_id: int) -> str:
        for m in self.shards:
            if m.shard_id == shard_id:
                return os.path.join(self.root, m.path)
        raise KeyError(f"unknown shard id {shard_id}")

    def seal(self, index: TopKIndex, frame_lo: int, frame_hi: int,
             obj_base: int, *, format: int = INDEX_FORMAT) -> ShardMeta:
        """Persist ``index`` as the next shard and append it to the
        manifest. The caller (``StreamingIngestor._seal_shard``) guarantees
        the index is final — sealed shards are immutable. Shard files are
        written before the manifest references them; if the manifest write
        fails, the in-memory shard list is rolled back so a retry reseals
        under the same id (overwriting the orphan files)."""
        sid = self.next_shard_id()
        name = f"shard_{sid:05d}"
        os.makedirs(self.root, exist_ok=True)
        prefix = os.path.join(self.root, name)
        index.save(prefix, format=format)
        meta = ShardMeta(shard_id=sid, frame_lo=int(frame_lo),
                         frame_hi=int(frame_hi),
                         n_objects=index.n_objects,
                         n_clusters=index.n_clusters,
                         obj_base=int(obj_base), path=name,
                         n_bytes=saved_nbytes(prefix))
        self.shards.append(meta)
        try:
            self.save()
        except BaseException:
            self.shards.pop()
            raise
        return meta

    def load_shard(self, shard_id: int) -> TopKIndex:
        """Eagerly load a shard as a full ``TopKIndex`` (any format)."""
        return TopKIndex.load(self.path_of(shard_id))

    def __len__(self) -> int:
        return len(self.shards)

    def __iter__(self) -> Iterator[ShardMeta]:
        return iter(self.shards)


class _LazyCropColumn:
    """Fancy-index view over the mmap'd uint8 rep-crop column: dequantizes
    only the gathered rows (the GT pass touches a handful of uncached
    clusters; the crop file — the bulk of a shard — is never read whole)."""

    def __init__(self, store: "_LazyStore"):
        self._store = store
        self._qparams: Optional[np.ndarray] = None

    def __getitem__(self, rows) -> np.ndarray:
        if self._qparams is None:
            self._qparams = np.asarray(self._store._col("crop_qparams"),
                                       np.float32)
        q = self._store._col("rep_crops_q")
        return dequant_crops(np.asarray(q[rows]), self._qparams)


class _LazyStore:
    """Read-side ``ClusterStore`` facade over a v4 shard's mmap'd columns.

    Exposes exactly the surface ``ArchiveQueryEngine`` reads — ``n_rows``,
    ``versions``/``first_objs`` (mmap), ``rows_of``, ``frames_of_each``,
    ``rep_crops[rows]``, ``_cid_to_row`` — materializing only small
    derived caches (cid sorter, member/frame CSR) on first use."""

    def __init__(self, prefix: str, meta: dict):
        self._prefix = prefix
        self.n_rows = int(meta["n_rows"])
        self._cols: Dict[str, np.ndarray] = {}
        self._rc64: Optional[np.ndarray] = None
        self._sorter: Optional[np.ndarray] = None
        self._csr = None
        self._cid_map: Optional[Dict[int, int]] = None
        self.rep_crops = _LazyCropColumn(self)

    def _col(self, name: str) -> np.ndarray:
        a = self._cols.get(name)
        if a is None:
            a = np.load(self._prefix + f".{name}.npy", mmap_mode="r")
            self._cols[name] = a
        return a

    @property
    def versions(self) -> np.ndarray:
        return self._col("versions")

    @property
    def first_objs(self) -> np.ndarray:
        return self._col("first_objs")

    @property
    def row_cids(self) -> np.ndarray:
        return self._col("row_cids")

    @property
    def counts(self) -> np.ndarray:
        return self._col("counts")

    def _row_cids64(self) -> np.ndarray:
        if self._rc64 is None:
            self._rc64 = np.asarray(self._col("row_cids"), np.int64)
        return self._rc64

    @property
    def _cid_to_row(self) -> Dict[int, int]:
        if self._cid_map is None:
            self._cid_map = {int(c): r for r, c in
                             enumerate(self._row_cids64().tolist())}
        return self._cid_map

    def rows_of(self, cids) -> np.ndarray:
        """Vectorized cid -> row map; raises KeyError on unknown cids
        (the ``ClusterStore.rows_of`` contract)."""
        cids = np.asarray(cids, np.int64)
        if len(cids) == 0:
            return np.zeros((0,), np.int64)
        if self.n_rows == 0:
            raise KeyError(f"unknown cluster ids: {cids.tolist()[:5]}")
        rc = self._row_cids64()
        if self._sorter is None:
            self._sorter = np.argsort(rc, kind="stable")
        pos = np.searchsorted(rc, cids, sorter=self._sorter)
        rows = self._sorter[np.minimum(pos, self.n_rows - 1)]
        bad = rc[rows] != cids
        if bad.any():
            raise KeyError(f"unknown cluster ids: "
                           f"{np.unique(cids[bad]).tolist()[:5]}")
        return rows

    def _build_csr(self):
        """CSR over the saved member/frame logs — fold entries (file
        order) then attach entries (already canonical (obj, frame) order
        on disk), matching ``ClusterStore._build_csr`` exactly."""
        if self._csr is None:
            log_cids = np.asarray(self._col("log_cids"), np.int64)
            att_cids = np.asarray(self._col("att_cids"), np.int64)
            rows = np.concatenate([self.rows_of(log_cids),
                                   self.rows_of(att_cids)])
            objs = np.concatenate([
                np.asarray(self._col("log_objs"), np.int64),
                np.asarray(self._col("att_objs"), np.int64)])
            frames = np.concatenate([
                np.asarray(self._col("log_frames"), np.int64),
                np.asarray(self._col("att_frames"), np.int64)])
            order = np.argsort(rows, kind="stable")
            counts = np.bincount(rows, minlength=self.n_rows)
            indptr = np.zeros(self.n_rows + 1, np.int64)
            np.cumsum(counts, out=indptr[1:])
            self._csr = (order, indptr, objs, frames)
        return self._csr

    def frames_of_rows(self, rows: np.ndarray) -> np.ndarray:
        order, indptr, _, frames = self._build_csr()
        if len(rows) == 0:
            return np.array([], np.int64)
        sel = np.concatenate([order[indptr[r]:indptr[r + 1]] for r in rows])
        return np.unique(frames[sel]).astype(np.int64)

    def frames_of_each(self, rows: np.ndarray) -> List[np.ndarray]:
        order, indptr, _, frames = self._build_csr()
        return [np.unique(frames[order[indptr[r]:indptr[r + 1]]]
                          ).astype(np.int64) for r in rows]

    def cache_nbytes(self) -> int:
        """Heap bytes of materialized caches. Mapped column pages are NOT
        counted: they belong to the OS page cache and are reclaimed under
        memory pressure without the loader's help."""
        import sys
        total = 0
        for a in (self._rc64, self._sorter):
            if a is not None:
                total += a.nbytes
        if self._csr is not None:
            total += sum(int(x.nbytes) for x in self._csr)
        if self._cid_map is not None:
            total += sys.getsizeof(self._cid_map)
        return total


class LazyShardIndex:
    """Query-side view of a v4 quantized shard.

    Duck-types the slice of ``TopKIndex`` that ``ArchiveQueryEngine``
    touches. ``lookup`` ranks the uint8 mean-prob rows on ``device`` with
    the fused ``dequant_topk`` kernel — the per-row scale is applied
    in-kernel, so no fp32 probability matrix is ever materialized — and
    caches the (M, K) top-k ids on the host for the shard's residency.
    Because the kernel, the eager loader, and ``TopKIndex._rank_rows``
    share one dequant op order and one tie rule (lowest class id), lazy
    answers are byte-identical to eagerly loading the same shard."""

    def __init__(self, prefix: str, meta: dict, device: DeviceLike = "cuda"):
        self._prefix = prefix
        self.meta = meta
        self.device = resolve_device(device)
        self.K = int(meta["K"])
        self.n_local_classes = int(meta["n_local_classes"])
        self.class_map = (ClassMap(np.array(meta["class_map"]))
                          if meta["class_map"] is not None else None)
        self.store = _LazyStore(prefix, meta)
        self._topk_ids: Optional[np.ndarray] = None

    @property
    def n_clusters(self) -> int:
        return self.store.n_rows

    @property
    def n_objects(self) -> int:
        return int(np.asarray(self.store.counts, np.int64).sum())

    def _rank_ids(self) -> np.ndarray:
        if self._topk_ids is None:
            q = self.store._col("mean_probs_q")
            M, C = q.shape
            if M == 0 or C == 0:
                self._topk_ids = np.zeros((M, 0), np.int32)
            else:
                # the mapped columns are read-only: copy them into owned
                # host memory before handing them to torch
                q_t = torch.from_numpy(np.array(q)).to(self.device)
                s_t = torch.from_numpy(np.array(
                    self.store._col("prob_scales"), np.float32)).to(
                        self.device)
                _, ids = hops.dequant_topk(q_t, s_t, min(self.K, C),
                                           global_scale=PROB_GLOBAL_SCALE)
                # focuslint: disable=host-sync -- designed once-per-shard
                # boundary: the one host fetch per residency; rank ids are
                # cached for the shard's resident lifetime
                self._topk_ids = ids.cpu().numpy()
        return self._topk_ids

    def lookup(self, global_class: int,
               Kx: Optional[int] = None) -> List[int]:
        """Cluster ids whose top-Kx (local) classes include the queried
        class — same contract and validation as ``TopKIndex.lookup``."""
        Kx = _resolve_kx(Kx, self.K)
        local = (self.class_map.to_local(global_class)
                 if self.class_map is not None else global_class)
        ids = self._rank_ids()
        n_classes = (self.store._col("mean_probs_q").shape[1]
                     if self.store.n_rows else 0)
        if ids.size == 0 or not 0 <= local < n_classes:
            return []
        kx = min(Kx, ids.shape[1])
        rows = np.nonzero((ids[:, :kx] == local).any(axis=1))[0]
        # focuslint: disable=host-sync -- a numpy array's .tolist(): host
        # rows, no device fetch
        return self.store._row_cids64()[rows].tolist()

    def frames_of(self, cids: Sequence[int]) -> np.ndarray:
        if len(cids) == 0:
            return np.array([], np.int64)
        return self.store.frames_of_rows(self.store.rows_of(cids))

    def rep_crops(self, cids: Sequence[int]) -> np.ndarray:
        return self.store.rep_crops[self.store.rows_of(cids)]

    @property
    def nbytes(self) -> int:
        """Materialized heap bytes (rank-id cache + store caches) — the
        resident-size unit for the bytes-bounded ``ShardLoader``."""
        total = self.store.cache_nbytes()
        if self._topk_ids is not None:
            total += self._topk_ids.nbytes
        return total


DEFAULT_CAPACITY_BYTES = 256 << 20      # 256 MiB of materialized shard state


class ShardLoader:
    """LRU-bounded shard index loader whose capacity is **bytes resident**.

    ``capacity_bytes`` bounds the summed heap footprint of resident shard
    indexes (``TopKIndex.nbytes`` for eagerly loaded formats <= 3;
    ``LazyShardIndex.nbytes`` — materialized caches only, mmap pages are
    the OS's — for v4). The bound is re-checked on every ``get`` because a
    lazy shard's footprint grows as its rank/CSR caches build; the most
    recently used shard is never evicted, even when it alone exceeds the
    budget. Reloads are counted (``n_loads`` / ``n_hits`` /
    ``n_evictions``) and ``resident_bytes`` reports current residency.

    ``capacity_shards`` (or the deprecated positional-era alias
    ``capacity=``) instead bounds the resident *count* — the pre-v4
    behaviour, kept so existing callers and benchmarks don't break. New
    code should pass ``capacity_bytes``; the count mode will go away once
    callers migrate. Exactly one bound applies: passing both is an error,
    passing neither defaults to ``DEFAULT_CAPACITY_BYTES``. Lazy v4 shards
    rank on ``device``.
    """

    def __init__(self, catalog: ShardCatalog,
                 capacity_bytes: Optional[int] = None, *,
                 capacity_shards: Optional[int] = None,
                 capacity: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        if capacity is not None:
            if capacity_shards is not None:
                raise ValueError(
                    "pass capacity_shards or the deprecated capacity "
                    "alias, not both")
            capacity_shards = capacity
        if capacity_bytes is not None and capacity_shards is not None:
            raise ValueError(
                "capacity_bytes and capacity_shards are mutually "
                "exclusive bounds")
        if capacity_bytes is None and capacity_shards is None:
            capacity_bytes = DEFAULT_CAPACITY_BYTES
        if capacity_shards is not None and capacity_shards < 1:
            raise ValueError(
                f"capacity must be >= 1 shard, got {capacity_shards}")
        if capacity_bytes is not None and capacity_bytes < 1:
            raise ValueError(
                f"capacity_bytes must be >= 1, got {capacity_bytes}")
        self.catalog = catalog
        self.capacity_bytes = capacity_bytes
        self.capacity_shards = capacity_shards
        self.device = resolve_device(device)
        self._lru: "OrderedDict[int, TopKIndex]" = OrderedDict()
        self.n_loads = 0
        self.n_hits = 0
        self.n_evictions = 0

    @property
    def resident_bytes(self) -> int:
        """Summed heap bytes of resident shard indexes right now."""
        return sum(int(ix.nbytes) for ix in self._lru.values())

    def _over_budget(self) -> bool:
        if self.capacity_shards is not None:
            return len(self._lru) > self.capacity_shards
        return self.resident_bytes > self.capacity_bytes

    def _load(self, shard_id: int):
        prefix = self.catalog.path_of(shard_id)
        with open(prefix + ".json") as f:
            meta = json.load(f)
        if meta.get("format", 1) >= 4:
            return LazyShardIndex(prefix, meta, device=self.device)
        return TopKIndex.load(prefix)

    def get(self, shard_id: int) -> TopKIndex:
        idx = self._lru.get(shard_id)
        if idx is not None:
            self._lru.move_to_end(shard_id)
            self.n_hits += 1
        else:
            idx = self._load(shard_id)
            self.n_loads += 1
            self._lru[shard_id] = idx
        while len(self._lru) > 1 and self._over_budget():
            self._lru.popitem(last=False)
            self.n_evictions += 1
        return idx

    def __len__(self) -> int:
        return len(self._lru)


@dataclass
class ArchiveQueryResult:
    """Per-query result of an archive fan-out (mirrors ``QueryResult``;
    matched clusters are ``(shard_id, cid)`` pairs)."""
    queried_class: int
    frames: np.ndarray                       # union over shards, sorted
    matched: List[Tuple[int, int]]
    n_candidate_clusters: int                # summed over shards
    n_gt_invocations: int                    # fresh verdicts charged here
    gt_flops: float
    wall_s: float


@dataclass
class ArchiveBatchStats:
    """Accounting for one ``ArchiveQueryEngine.query_many`` call. Field
    names mirror ``BatchQueryStats`` so callers can report either."""
    n_queries: int
    n_shards: int
    n_candidates: int            # sum over (query, shard) pairs
    n_unique_candidates: int     # after per-shard cross-query union
    n_cache_hits: int
    n_gt_invocations: int        # real crops classified in this call
    n_gt_batches: int            # gt_apply launches (the "one pass" gate)
    gt_flops: float
    wall_s: float
    n_shard_loads: int           # shards read from disk during this call
    n_shard_evictions: int


@dataclass
class ArchiveStats:
    """Cumulative counters over the archive engine's lifetime, including
    the loader's residency (mirrored after every query/prefetch so one
    snapshot serves benchmark reports and the serve summary table)."""
    n_queries: int = 0
    n_candidates: int = 0
    n_cache_hits: int = 0
    n_gt_invocations: int = 0
    gt_flops: float = 0.0
    n_shard_loads: int = 0       # cold shard reads over the lifetime
    n_shard_hits: int = 0        # LRU hits over the lifetime
    n_shard_evictions: int = 0
    resident_bytes: int = 0      # loader heap residency at last snapshot

    @property
    def shard_hit_rate(self) -> float:
        total = self.n_shard_loads + self.n_shard_hits
        return self.n_shard_hits / total if total else 0.0


class ArchiveQueryEngine:
    """Serves class queries against a time-sharded archive, classifying
    each (shard, centroid) with the GT-CNN at most once per version.

    ``ingestor`` (optional) is a live ``StreamingIngestor`` whose
    un-sealed index is queried as the newest shard; its eventual shard id
    is ``catalog.next_shard_id()``, so label-cache entries survive the
    rollover unchanged. Exactly one of ``gt_apply`` / ``oracle_labels``
    must be given (oracle labels are indexed by ``obj_base`` + the
    cluster's shard-local first member). Sealed v4 shards are ranked on
    ``device``.
    """

    def __init__(self, catalog: ShardCatalog,
                 gt_apply: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 gt_flops_per_image: float = 0.0,
                 batch_size: int = 256, batch_pad: int = 64,
                 oracle_labels: Optional[np.ndarray] = None,
                 capacity: Optional[int] = None,
                 capacity_bytes: Optional[int] = None, ingestor=None,
                 device: DeviceLike = "cuda"):
        if (gt_apply is None) == (oracle_labels is None):
            raise ValueError(
                "exactly one of gt_apply / oracle_labels must be provided")
        self.catalog = catalog
        # capacity= keeps the pre-v4 shard-count bound for existing
        # callers; capacity_bytes= is the bytes-resident bound (neither
        # given -> the loader's byte default)
        self.loader = ShardLoader(catalog, capacity_bytes=capacity_bytes,
                                  capacity_shards=capacity, device=device)
        self.gt_apply = gt_apply
        self.gt_flops_per_image = gt_flops_per_image
        self.batch_size = batch_size
        self.batch_pad = batch_pad
        self.oracle_labels = (np.asarray(oracle_labels, np.int64)
                              if oracle_labels is not None else None)
        self.ingestor = ingestor
        # per-shard row-aligned GT-label cache: shard id -> (versions,
        # labels). Row order is deterministic under save/load, so entries
        # survive LRU eviction and live-shard sealing; a mismatch between
        # the cached version and the store's is a stale entry.
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.stats = ArchiveStats()

    # -- shard plumbing --------------------------------------------------------

    def _iter_shards(self):
        """(shard_id, index, obj_base) over sealed shards in time order,
        then the live shard (if any and non-empty)."""
        for m in self.catalog.shards:
            yield m.shard_id, self.loader.get(m.shard_id), m.obj_base
        if self.ingestor is not None:
            live = self.ingestor.index
            if live is not None and live.n_clusters:
                yield (self.catalog.next_shard_id(), live,
                       self.ingestor.shard_obj_base)

    def _sync_loader_stats(self):
        """Mirror the loader's residency counters into ``stats`` so one
        snapshot reports everything."""
        self.stats.n_shard_loads = self.loader.n_loads
        self.stats.n_shard_hits = self.loader.n_hits
        self.stats.n_shard_evictions = self.loader.n_evictions
        self.stats.resident_bytes = self.loader.resident_bytes

    def _shard_cache(self, shard_id: int, n_rows: int):
        vers, labels = self._cache.get(shard_id,
                                       (np.full(0, -1, np.int64),
                                        np.zeros(0, np.int64)))
        vers, labels = grow_row_cache(vers, labels, n_rows)
        self._cache[shard_id] = (vers, labels)
        return vers, labels

    def cached_label(self, shard_id: int, cid: int) -> Optional[int]:
        """The cached verdict for ``(shard, cid)`` if still valid. A
        read-only probe: validates against the live index or an already
        resident shard, and returns None (rather than pulling a cold
        shard through the LRU, evicting a hot one) when the shard is not
        loaded."""
        ent = self._cache.get(int(shard_id))
        if ent is None:
            return None
        if self.ingestor is not None \
                and shard_id == self.catalog.next_shard_id():
            idx = self.ingestor.index
        else:
            idx = self.loader._lru.get(shard_id)     # resident shards only
        if idx is None:
            return None
        row = idx.store._cid_to_row.get(int(cid))
        if row is None or row >= len(ent[0]):
            return None
        if int(ent[0][row]) != int(idx.store.versions[row]):
            return None
        return int(ent[1][row])

    # -- classification --------------------------------------------------------

    def _classify_crops(self, crops: np.ndarray) -> Tuple[np.ndarray, int]:
        """One bucket-padded GT pass over ``crops``; returns (labels,
        gt_apply launches)."""
        return classify_crops(self.gt_apply, crops, self.batch_size,
                              self.batch_pad)

    def _verify_shard(self, shard_id: int, index: TopKIndex,
                      obj_base: int, cids: np.ndarray) -> int:
        """Ensure verdicts for ``cids`` of one shard are cached (prefetch
        path — runs its own GT pass). Returns fresh classifications."""
        cids = np.unique(np.asarray(cids, np.int64))
        if len(cids) == 0:
            return 0
        s = index.store
        rows = s.rows_of(cids)
        versions = s.versions[rows]
        vers, labels = self._shard_cache(shard_id, s.n_rows)
        _, _, miss = probe_row_cache(vers, labels, rows, versions)
        if len(miss) == 0:
            return 0
        mrows = rows[miss]
        if self.oracle_labels is not None:
            fresh = self.oracle_labels[s.first_objs[mrows] + obj_base]
        else:
            fresh, _ = self._classify_crops(s.rep_crops[mrows])
        vers[mrows] = versions[miss]
        labels[mrows] = fresh
        self.stats.n_gt_invocations += len(miss)
        self.stats.gt_flops += len(miss) * self.gt_flops_per_image
        return len(miss)

    def prefetch(self, delta_or_cids) -> int:
        """Warm the label cache ahead of the next query round.

        Accepts either a streaming ``IngestDelta`` — live ``touched_cids``
        plus ``touched_sealed`` ``(shard, cid)`` pairs from rollovers since
        the last flush — or a plain cid iterable for the live shard.
        Returns the number of fresh classifications."""
        touched_live = getattr(delta_or_cids, "touched_cids", None)
        touched_sealed = getattr(delta_or_cids, "touched_sealed", ())
        if touched_live is None:
            touched_live = list(delta_or_cids)
        n = 0
        by_shard: Dict[int, List[int]] = {}
        for sid, cid in touched_sealed:
            by_shard.setdefault(int(sid), []).append(int(cid))
        for m in self.catalog.shards:
            if m.shard_id in by_shard:
                n += self._verify_shard(
                    m.shard_id, self.loader.get(m.shard_id), m.obj_base,
                    np.asarray(by_shard[m.shard_id], np.int64))
        if len(touched_live) and self.ingestor is not None \
                and self.ingestor.index is not None:
            n += self._verify_shard(
                self.catalog.next_shard_id(), self.ingestor.index,
                self.ingestor.shard_obj_base,
                np.asarray(list(touched_live), np.int64))
        self._sync_loader_stats()
        return n

    # -- queries ---------------------------------------------------------------

    def query_many(self, classes: Sequence[int],
                   Kx: Union[None, int, Sequence[Optional[int]]] = None,
                   ) -> Tuple[List[ArchiveQueryResult], ArchiveBatchStats]:
        """Serve a query batch across every shard with one GT-CNN pass.

        Per shard: fan out ``lookup`` per query, union candidates across
        the batch, probe the ``(shard, cid, version)`` cache with one
        vectorized compare. The misses of *all shards and all queries* are
        then classified in a single bucket-padded GT pass and scattered
        back; per-query frame sets are the union over shards. Answers are
        identical to running a per-shard ``QueryEngine`` and unioning.
        """
        t0 = time.perf_counter()
        loads0, ev0 = self.loader.n_loads, self.loader.n_evictions
        classes = [int(c) for c in classes]
        Kxs = normalize_kx(Kx, len(classes))

        # fan-out + cache probe, collecting misses across shards. Each
        # entry detaches from its shard index (candidate frames gathered
        # eagerly, miss crops copied), so at most one shard is resident
        # beyond the loader's LRU capacity at any point in the call.
        entries = []          # (sid, cand, union, labels, frames_each)
        miss_crops: List[np.ndarray] = []
        # (entry idx, miss positions, their rows, their versions)
        miss_refs: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
        miss_keys: List[Tuple[int, int]] = []       # (sid, cid) fresh here
        n_cand = n_unique = n_hits = n_gt = n_batches = 0
        for sid, idx, obj_base in self._iter_shards():
            cand = [np.asarray(idx.lookup(c, k), np.int64)
                    for c, k in zip(classes, Kxs)]
            n_cand += int(sum(len(c) for c in cand))
            union = (np.unique(np.concatenate(cand)) if cand
                     else np.zeros((0,), np.int64))
            if len(union) == 0:
                entries.append((sid, cand, union, np.zeros(0, np.int64),
                                []))
                continue
            s = idx.store
            rows = s.rows_of(union)
            versions = s.versions[rows]
            vers, cached = self._shard_cache(sid, s.n_rows)
            hit, labels, miss = probe_row_cache(vers, cached, rows,
                                                versions)
            n_unique += len(union)
            n_hits += int(hit.sum())
            if len(miss):
                mrows = rows[miss]
                miss_keys.extend((sid, int(c)) for c in union[miss])
                if self.oracle_labels is not None:
                    fresh = self.oracle_labels[s.first_objs[mrows]
                                               + obj_base]
                    labels[miss] = fresh
                    vers[mrows] = versions[miss]
                    cached[mrows] = fresh
                    n_gt += len(miss)
                    hit = np.ones(len(union), bool)   # all labels known
                else:
                    # defer: one GT pass over all shards' misses below
                    miss_crops.append(s.rep_crops[mrows])
                    miss_refs.append((len(entries), miss, mrows,
                                      versions[miss]))
            # gather frames only where they can be returned: rows whose
            # (known) label matches a queried class, plus every miss —
            # the bulk of a warm round's candidates match none of the
            # queried classes and are skipped entirely
            need = ~hit | np.isin(labels, np.asarray(classes, np.int64))
            frames_each: List[Optional[np.ndarray]] = [None] * len(union)
            for p, fr in zip(np.nonzero(need)[0].tolist(),
                             idx.store.frames_of_each(rows[need])):
                frames_each[p] = fr
            entries.append((sid, cand, union, labels, frames_each))

        if miss_crops:
            fresh_all, n_batches = self._classify_crops(
                np.concatenate(miss_crops))
            n_gt += len(fresh_all)
            off = 0
            for entry_i, miss, mrows, mvers in miss_refs:
                sid, _, _, labels, _ = entries[entry_i]
                fresh = fresh_all[off:off + len(miss)]
                off += len(miss)
                labels[miss] = fresh
                vers, cached = self._shard_cache(sid, 0)
                vers[mrows] = mvers
                cached[mrows] = fresh

        # per-query scatter + frame merge across shards
        results = []
        uncharged = set(miss_keys)
        for qi, cls in enumerate(classes):
            matched_all: List[Tuple[int, int]] = []
            frames_parts: List[np.ndarray] = []
            n_cand_q = 0
            fresh_q = 0
            for sid, cand, union, labels, frames_each in entries:
                cq = cand[qi]
                n_cand_q += len(cq)
                if len(cq) == 0:
                    continue
                pos = np.searchsorted(union, cq)
                mask = labels[pos] == cls
                for c in cq.tolist():
                    if (sid, c) in uncharged:
                        uncharged.discard((sid, c))
                        fresh_q += 1
                if mask.any():
                    matched_all.extend((sid, int(c))
                                       for c in cq[mask].tolist())
                    frames_parts.extend(frames_each[p]
                                        for p in pos[mask].tolist())
            frames = (np.unique(np.concatenate(frames_parts))
                      if frames_parts else np.array([], np.int64))
            results.append(ArchiveQueryResult(
                queried_class=cls, frames=frames, matched=matched_all,
                n_candidate_clusters=n_cand_q, n_gt_invocations=fresh_q,
                gt_flops=fresh_q * self.gt_flops_per_image, wall_s=0.0))

        wall = time.perf_counter() - t0
        per_q = wall / max(len(classes), 1)
        for res in results:
            res.wall_s = per_q
        batch = ArchiveBatchStats(
            n_queries=len(classes), n_shards=len(entries),
            n_candidates=n_cand, n_unique_candidates=n_unique,
            n_cache_hits=n_hits, n_gt_invocations=n_gt,
            n_gt_batches=n_batches,
            gt_flops=n_gt * self.gt_flops_per_image, wall_s=wall,
            n_shard_loads=self.loader.n_loads - loads0,
            n_shard_evictions=self.loader.n_evictions - ev0)
        self.stats.n_queries += batch.n_queries
        self.stats.n_candidates += batch.n_candidates
        self.stats.n_cache_hits += n_hits
        self.stats.n_gt_invocations += n_gt
        self.stats.gt_flops += batch.gt_flops
        self._sync_loader_stats()
        return results, batch

    def query(self, global_class: int,
              Kx: Optional[int] = None) -> ArchiveQueryResult:
        results, batch = self.query_many([global_class], Kx)
        res = results[0]
        res.wall_s = batch.wall_s
        return res
