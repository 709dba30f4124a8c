"""Batched multi-query engine over one Focus top-K index (paper §4.2, §5).

The per-class ``query()`` loop re-invokes the expensive GT-CNN on the same
cluster centroids for every query — exactly the redundant work Focus exists
to avoid (a centroid's class does not depend on which query asked).
``QueryEngine`` serves many concurrent queries against one index with:

* a persistent **GT-label cache** keyed by ``(cluster id, centroid
  version)``: a centroid is classified by the GT-CNN at most once across
  all queries and all classes. ``ClusterStore.versions`` is bumped whenever
  ingest moves a centroid (``add_batch`` fold, ``add_cluster`` replace), so
  stale entries invalidate precisely — per moved cluster, not cache-wide.
  ``attach`` does not move centroids and therefore invalidates nothing.
* ``query_many(classes, Kx)``: union the candidate clusters of the whole
  query batch, dedupe against the cache, run **one** padded/bucketed
  GT-CNN pass over only the uncached rep crops, and scatter verdicts back
  to each query. Result frame sets are identical to sequential ``query()``
  per class.
* an **oracle mode** (``oracle_labels``) where a cluster's GT verdict is
  its first (centroid-representative) member's ground-truth label — the
  stand-in §4.4 parameter selection uses, so sweeps stop paying redundant
  simulated GT passes across the K grid.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.index import TopKIndex
from repro_torch.core.query import QueryResult, pad_to_bucket


def grow_row_cache(vers: np.ndarray, labels: np.ndarray, n_rows: int,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Grow a row-aligned (versions, labels) label cache to cover
    ``n_rows`` store rows (amortized doubling; version -1 = no entry —
    live rows always have version >= 1, so the sentinel is safe). Shared
    by ``QueryEngine`` and the per-shard caches in ``core.archive``."""
    if len(vers) < n_rows:
        grown_v = np.full(max(n_rows, 2 * len(vers)), -1, np.int64)
        grown_v[:len(vers)] = vers
        grown_l = np.zeros(len(grown_v), np.int64)
        grown_l[:len(labels)] = labels
        vers, labels = grown_v, grown_l
    return vers, labels


def _reject_bool_kx(x):
    # bool is a subclass of int, so True/False would silently pass the
    # scalar check below and query with Kx=1/0 — almost certainly a
    # mis-passed flag; demand an explicit integer
    if isinstance(x, (bool, np.bool_)):
        raise TypeError(
            f"Kx must be an int or None, got bool {x!r} (True/False would "
            f"silently query with Kx=1/0)")


def normalize_kx(Kx, n_queries: int) -> List[Optional[int]]:
    """One Kx per query: broadcast a scalar/None, validate a sequence."""
    _reject_bool_kx(Kx)
    if Kx is None or isinstance(Kx, (int, np.integer)):
        return [Kx] * n_queries
    if len(Kx) != n_queries:
        raise ValueError("per-query Kx length mismatch")
    out = list(Kx)
    for k in out:
        _reject_bool_kx(k)
    return out


def probe_row_cache(vers: np.ndarray, cached: np.ndarray, rows: np.ndarray,
                    versions: np.ndarray,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized probe of a row-aligned label cache: one version-match
    against the store's ``versions`` for the given rows. Returns
    ``(hit mask, labels (stale at miss positions), miss positions)``.
    Shared by ``QueryEngine.verify`` and both archive cache paths."""
    hit = vers[rows] == versions
    labels = cached[rows].copy()
    return hit, labels, np.nonzero(~hit)[0]


def classify_crops(gt_apply: Callable[[np.ndarray], np.ndarray],
                   crops: np.ndarray, batch_size: int, batch_pad: int,
                   ) -> Tuple[np.ndarray, int]:
    """One bucket-padded GT-CNN pass over ``crops``, chunked only by
    ``batch_size``; returns (labels, gt_apply launches)."""
    out = np.empty(len(crops), np.int64)
    n_batches = 0
    for start in range(0, len(crops), batch_size):
        chunk = crops[start:start + batch_size]
        padded = pad_to_bucket(chunk, batch_pad)
        out[start:start + len(chunk)] = \
            np.asarray(gt_apply(padded))[:len(chunk)]
        n_batches += 1
    return out, n_batches


@dataclass
class EngineStats:
    """Cumulative counters over the engine's lifetime."""
    n_queries: int = 0
    n_candidates: int = 0        # sum of per-query candidate clusters
    n_cache_hits: int = 0        # candidate verdicts served from the cache
    n_gt_invocations: int = 0    # real crops classified by the GT-CNN
    gt_flops: float = 0.0


@dataclass
class BatchQueryStats:
    """Accounting for one ``query_many`` call."""
    n_queries: int
    n_candidates: int            # sum over queries (with cross-query dups)
    n_unique_candidates: int     # after the cross-query union
    n_cache_hits: int
    n_gt_invocations: int        # real crops classified in this call
    gt_flops: float
    wall_s: float


class QueryEngine:
    """Serves class queries against ``index``, classifying each cluster
    centroid with the expensive GT-CNN at most once.

    Exactly one of ``gt_apply`` (crops (B,R,R,3) -> global class ids (B,))
    and ``oracle_labels`` (per-object ground-truth labels, indexed by the
    cluster's first member) must be given.
    """

    def __init__(self, index: TopKIndex,
                 gt_apply: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 gt_flops_per_image: float = 0.0,
                 batch_size: int = 256, batch_pad: int = 64,
                 oracle_labels: Optional[np.ndarray] = None):
        if (gt_apply is None) == (oracle_labels is None):
            raise ValueError(
                "exactly one of gt_apply / oracle_labels must be provided")
        self.index = index
        self.gt_apply = gt_apply
        self.gt_flops_per_image = gt_flops_per_image
        self.batch_size = batch_size
        self.batch_pad = batch_pad
        self.oracle_labels = (np.asarray(oracle_labels, np.int64)
                              if oracle_labels is not None else None)
        # row-aligned GT-label cache: the entry for a cluster lives at its
        # store row (rows are append-only, so alignment is stable), keyed
        # semantically by (cid, centroid version). version -1 = no entry;
        # live rows always have version >= 1, so the sentinel is safe.
        self._cache_vers = np.full(0, -1, np.int64)
        self._cache_labels = np.zeros(0, np.int64)
        self.stats = EngineStats()

    # -- cache -----------------------------------------------------------------

    def __len__(self) -> int:
        return int((self._cache_vers >= 0).sum())

    def _cache_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Grow the row-aligned cache to cover every store row."""
        self._cache_vers, self._cache_labels = grow_row_cache(
            self._cache_vers, self._cache_labels, self.index.store.n_rows)
        return self._cache_vers, self._cache_labels

    def cached_label(self, cid: int) -> Optional[int]:
        """The cached GT verdict for ``cid`` if still valid, else None
        (also for cids the index has never seen)."""
        row = self.index.store._cid_to_row.get(int(cid))
        if row is None or row >= len(self._cache_vers):
            return None
        if int(self._cache_vers[row]) != int(self.index.store.versions[row]):
            return None
        return int(self._cache_labels[row])

    def _classify_misses(self, rows: np.ndarray) -> np.ndarray:
        """GT-CNN labels for the store rows of uncached candidates."""
        s = self.index.store
        if self.oracle_labels is not None:
            return self.oracle_labels[s.first_objs[rows]]
        if s.rep_crops is None:
            raise ValueError("no representative crops were stored "
                             "(add_batch was called without crops)")
        labels, _ = classify_crops(self.gt_apply, s.rep_crops[rows],
                                   self.batch_size, self.batch_pad)
        return labels

    def verify(self, cids: np.ndarray) -> Tuple[np.ndarray, int, List[int]]:
        """GT verdicts for ``cids`` (aligned), via the cache.

        Returns ``(labels, n_cache_hits, miss_cids)`` where ``miss_cids``
        are the cids freshly classified in this call (len == GT
        invocations); they are classified in one bucketed pass and cached
        under the centroid's current version.
        """
        cids = np.asarray(cids, np.int64)
        if len(cids) == 0:
            return np.zeros((0,), np.int64), 0, []
        s = self.index.store
        rows = s.rows_of(cids)
        versions = s.versions[rows]
        vers, cached = self._cache_arrays()
        # vectorized version-match: one compare against store.versions
        # instead of a per-candidate Python probe (candidate unions are
        # multiplied by shard fan-out in archive queries)
        _, labels, miss = probe_row_cache(vers, cached, rows, versions)
        n_hits = len(cids) - len(miss)
        if len(miss):
            mrows = rows[miss]
            fresh = self._classify_misses(mrows)
            labels[miss] = fresh
            vers[mrows] = versions[miss]
            cached[mrows] = fresh
        return labels, n_hits, [int(c) for c in cids[miss]]

    def prefetch(self, cids) -> int:
        """Warm the GT-label cache for ``cids`` — typically a streaming
        flush's ``IngestDelta.touched_cids`` — ahead of the next query
        round, moving GT-CNN cost for new/moved centroids off the query
        path (query-while-ingest freshness). Returns the number of fresh
        classifications; already-valid entries cost nothing."""
        cids = np.unique(np.asarray(list(cids), np.int64))
        _, _, miss = self.verify(cids)
        self.stats.n_gt_invocations += len(miss)
        self.stats.gt_flops += len(miss) * self.gt_flops_per_image
        return len(miss)

    # -- queries ---------------------------------------------------------------

    def query_many(self, classes: Sequence[int],
                   Kx: Union[None, int, Sequence[Optional[int]]] = None,
                   ) -> Tuple[List[QueryResult], BatchQueryStats]:
        """Serve a batch of class queries with one shared GT-CNN pass.

        ``Kx`` is either one value for the whole batch or a per-query
        sequence. Per-query ``n_gt_invocations`` charges each freshly
        classified centroid to the first query whose candidate set contains
        it (so the per-query numbers sum to the batch total); ``wall_s`` is
        the batch wall time amortized evenly over the queries — the batch
        stats carry the true totals.
        """
        t0 = time.perf_counter()
        classes = [int(c) for c in classes]
        Kxs = normalize_kx(Kx, len(classes))
        cand = [np.asarray(self.index.lookup(c, k), np.int64)
                for c, k in zip(classes, Kxs)]
        union = (np.unique(np.concatenate(cand)) if cand
                 else np.zeros((0,), np.int64))
        labels, n_hits, miss_cids = self.verify(union)
        n_gt = len(miss_cids)
        label_of = dict(zip(union.tolist(), labels.tolist()))

        results = []
        uncharged = set(miss_cids)
        for cls, cids in zip(classes, cand):
            matched = [int(c) for c in cids.tolist() if label_of[c] == cls]
            fresh = [c for c in cids.tolist() if c in uncharged]
            uncharged.difference_update(fresh)
            results.append(QueryResult(
                queried_class=cls, frames=self.index.frames_of(matched),
                matched_clusters=matched, n_candidate_clusters=len(cids),
                n_gt_invocations=len(fresh),
                gt_flops=len(fresh) * self.gt_flops_per_image,
                wall_s=0.0))
        wall = time.perf_counter() - t0          # includes frame scatter
        per_q_wall = wall / max(len(classes), 1)
        for res in results:
            res.wall_s = per_q_wall
        batch = BatchQueryStats(
            n_queries=len(classes),
            n_candidates=int(sum(len(c) for c in cand)),
            n_unique_candidates=len(union), n_cache_hits=n_hits,
            n_gt_invocations=n_gt,
            gt_flops=n_gt * self.gt_flops_per_image, wall_s=wall)
        self.stats.n_queries += batch.n_queries
        self.stats.n_candidates += batch.n_candidates
        self.stats.n_cache_hits += n_hits
        self.stats.n_gt_invocations += n_gt
        self.stats.gt_flops += batch.gt_flops
        return results, batch

    def query(self, global_class: int,
              Kx: Optional[int] = None) -> QueryResult:
        """Single-query convenience over the shared cache."""
        results, batch = self.query_many([global_class], Kx)
        res = results[0]
        res.wall_s = batch.wall_s
        return res
