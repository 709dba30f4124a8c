"""Multi-tenant query service: request queue, admission control,
continuous batching, and ingest/query backpressure (DESIGN.md §12).

``QueryService`` turns the batched engines (``QueryEngine``,
``ArchiveQueryEngine``) into a serving layer. Tenants ``submit()`` class
queries; each ``step()`` runs one
**continuous-batch cycle** that merges every admitted in-flight request —
across all tenants — into ONE ``query_many`` call, deduping identical
``(class, Kx)`` pairs, so the engine pays one candidate union and at most
one GT-CNN pass per cycle no matter how many callers are waiting.
Results are byte-identical to serving each request alone: ``query_many``
computes per-query answers independently (its equivalence property),
so riding a merged call can change only cost, never frames.

**Admission control** bounds the queue (``max_queue_depth``,
``max_inflight_per_tenant``): a submit over either bound is rejected
immediately (the caller sees ``None``) instead of growing an unbounded
backlog — under an ingest-priority policy this is where query load sheds.

**Backpressure**: the service may also own the stream's ingest work via
``offer_ingest`` (chunks destined for an attached ``StreamingIngestor``);
each ``step()`` arbitrates the device between ingest and queries per
``ServiceConfig.policy``:

* ``"query"`` (default) — pending queries always run first; ingest chunks
  wait in a bounded backlog and run only on idle cycles. When the backlog
  bound overflows, the OLDEST chunk is shed (freshest frames win), counted
  in ``n_ingest_shed_*`` — ingest is sacrificed, query SLOs are not.
* ``"ingest"`` — up to ``ingest_chunks_per_cycle`` backlog chunks ingest
  *before* the cycle's query batch; query latency absorbs the contention
  and admission control sheds the query overflow instead.

After each ingested chunk the flush's ``IngestDelta`` is prefetched into
the engine's GT-label cache (``prefetch=True``), keeping the GT cost of
new/moved centroids off the query path exactly as in query-while-ingest.

Everything is deterministic and single-threaded: a "cycle" is one
``step()`` call, so entry points (``launch/serve.py``), benchmarks, and tests
can replay exact schedules. Wall-clock enters only through the injectable
``clock`` (latency accounting), never through control flow.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np

from repro_torch.core.archive import ArchiveQueryEngine
from repro_torch.core.engine import normalize_kx
from repro_torch.serve.slo import LatencyTracker, TenantStats


@dataclass
class QueryRequest:
    """One admitted tenant request: a batch of class queries."""
    req_id: int
    tenant: str
    classes: Tuple[int, ...]
    Kx: Tuple[Optional[int], ...]        # normalized: one entry per class
    deadline_s: Optional[float]          # SLO deadline relative to submit
    t_submit: float


@dataclass
class QueryResponse:
    """A completed request: per-class results aligned to
    ``request.classes`` (``QueryResult`` or ``ArchiveQueryResult``)."""
    request: QueryRequest
    results: List[object]
    latency_s: float
    deadline_missed: bool
    cycle: int                           # service cycle that completed it


@dataclass(frozen=True)
class ServiceConfig:
    """Knobs for one ``QueryService`` (validated at construction)."""
    max_queue_depth: int = 256           # admission bound on queued requests
    max_inflight_per_tenant: Optional[int] = None
    max_batch_requests: int = 32         # requests merged per cycle
    policy: str = "query"                # "query" | "ingest" priority
    ingest_chunks_per_cycle: int = 1
    max_ingest_backlog: Optional[int] = None   # chunks; overflow sheds oldest
    prefetch: bool = True                # warm the GT cache after each chunk
    default_deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.policy not in ("query", "ingest"):
            raise ValueError(f"unknown policy {self.policy!r}; "
                             f"expected 'query' or 'ingest'")
        if self.max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1: "
                             f"{self.max_queue_depth}")
        if self.max_batch_requests < 1:
            raise ValueError(f"max_batch_requests must be >= 1: "
                             f"{self.max_batch_requests}")
        if self.ingest_chunks_per_cycle < 1:
            raise ValueError(f"ingest_chunks_per_cycle must be >= 1: "
                             f"{self.ingest_chunks_per_cycle}")
        if self.max_ingest_backlog is not None and self.max_ingest_backlog < 1:
            raise ValueError(f"max_ingest_backlog must be >= 1 or None: "
                             f"{self.max_ingest_backlog}")
        if self.max_inflight_per_tenant is not None \
                and self.max_inflight_per_tenant < 1:
            raise ValueError(f"max_inflight_per_tenant must be >= 1 or "
                             f"None: {self.max_inflight_per_tenant}")


@dataclass
class ServiceStats:
    """Cumulative counters over the service's lifetime."""
    n_cycles: int = 0
    n_query_cycles: int = 0          # cycles that ran a merged query_many
    n_completed: int = 0             # requests completed
    n_rejected: int = 0              # requests shed by admission control
    n_class_queries: int = 0         # class queries inside completed requests
    n_merged_calls: int = 0          # engine.query_many invocations
    n_merged_queries: int = 0        # unique (class, Kx) pairs sent down
    n_shared_queries: int = 0        # duplicate pairs served by sharing
    n_ingest_chunks: int = 0
    n_ingest_objects: int = 0
    n_ingest_deferred: int = 0       # chunk-cycles spent behind queries
    n_ingest_shed_chunks: int = 0
    n_ingest_shed_objects: int = 0
    n_prefetch_gt: int = 0           # GT calls moved off the query path


class QueryService:
    """Serves many tenants' class queries against one engine
    (``QueryEngine`` or ``ArchiveQueryEngine``), one merged
    ``query_many`` per cycle, with admission control and ingest/query
    backpressure.

    ``ingestor`` (optional) is the ``StreamingIngestor`` behind
    ``offer_ingest``; when the engine is an ``ArchiveQueryEngine`` it
    should be the same ingestor the engine queries as its live shard.
    ``clock`` is injectable so tests can pin latency/deadline accounting.
    """

    def __init__(self, engine, cfg: Optional[ServiceConfig] = None,
                 ingestor=None,
                 clock: Callable[[], float] = time.perf_counter):
        self.engine = engine
        self.cfg = cfg if cfg is not None else ServiceConfig()
        self.ingestor = ingestor
        self.clock = clock
        self.slo = LatencyTracker()
        self.stats = ServiceStats()
        self.last_batch = None           # engine batch stats of the last cycle
        self._queue: Deque[QueryRequest] = deque()
        self._backlog: Deque[Tuple[np.ndarray, np.ndarray]] = deque()
        self._inflight: Dict[str, int] = {}
        self._next_id = 0

    # -- state -----------------------------------------------------------------

    @property
    def pending_queries(self) -> int:
        return len(self._queue)

    @property
    def pending_ingest(self) -> int:
        return len(self._backlog)

    def tenant_stats(self, tenant: str) -> TenantStats:
        return self.slo.tenant(tenant)

    # -- admission -------------------------------------------------------------

    def submit(self, tenant: str, classes: Sequence[int],
               Kx: Union[None, int, Sequence[Optional[int]]] = None,
               deadline_s: Optional[float] = None) -> Optional[int]:
        """Submit one request (a batch of class queries for ``tenant``).

        Returns the request id, or None when admission control sheds the
        request (queue full / tenant over its in-flight cap). ``Kx`` is
        validated here — a malformed request is the submitter's error and
        must never poison a merged batch cycle.
        """
        classes = tuple(int(c) for c in classes)
        kxs = tuple(normalize_kx(Kx, len(classes)))
        ts = self.slo.on_submit(tenant)
        if len(self._queue) >= self.cfg.max_queue_depth or (
                self.cfg.max_inflight_per_tenant is not None
                and self._inflight.get(tenant, 0)
                >= self.cfg.max_inflight_per_tenant):
            ts.n_rejected += 1
            self.stats.n_rejected += 1
            return None
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        req = QueryRequest(req_id=self._next_id, tenant=tenant,
                           classes=classes, Kx=kxs, deadline_s=deadline_s,
                           t_submit=self.clock())
        self._next_id += 1
        self._queue.append(req)
        self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
        return req.req_id

    def offer_ingest(self, crops: np.ndarray, frames: np.ndarray) -> bool:
        """Queue one ingest chunk for the attached ingestor.

        The chunk always enters the backlog; when ``max_ingest_backlog``
        overflows, the OLDEST chunk is shed so the freshest frames
        survive (chunks arrive in stream order, so dropping a prefix
        keeps the non-decreasing-frame contract). Returns False when this
        offer caused a shed — the caller's backpressure signal.
        """
        if self.ingestor is None:
            raise ValueError("offer_ingest needs an attached ingestor")
        self._backlog.append((np.asarray(crops),
                              np.asarray(frames, np.int64)))
        shed = False
        if self.cfg.max_ingest_backlog is not None:
            while len(self._backlog) > self.cfg.max_ingest_backlog:
                old_crops, _ = self._backlog.popleft()
                self.stats.n_ingest_shed_chunks += 1
                self.stats.n_ingest_shed_objects += len(old_crops)
                shed = True
        return not shed

    # -- the batch cycle -------------------------------------------------------

    def step(self) -> List[QueryResponse]:
        """One service cycle: arbitrate ingest vs queries per the policy,
        then complete up to ``max_batch_requests`` queued requests in one
        merged ``query_many``. Returns the cycle's completed responses."""
        self.stats.n_cycles += 1
        if self.cfg.policy == "ingest" or not self._queue:
            self._run_ingest(self.cfg.ingest_chunks_per_cycle)
        else:
            # query priority under contention: the backlog waits
            self.stats.n_ingest_deferred += len(self._backlog)
        return self._run_batch()

    def run_until_idle(self, max_cycles: int = 100_000,
                       ) -> List[QueryResponse]:
        """Step until no queries or ingest chunks are pending."""
        out: List[QueryResponse] = []
        for _ in range(max_cycles):
            if not self._queue and not self._backlog:
                return out
            out.extend(self.step())
        raise RuntimeError(
            f"service did not go idle within {max_cycles} cycles "
            f"({len(self._queue)} queries / {len(self._backlog)} chunks "
            f"pending)")

    def drain_ingest(self) -> int:
        """Ingest every backlog chunk now, bypassing the policy (entry-point
        shutdown / round barrier). Returns chunks ingested."""
        n = len(self._backlog)
        while self._backlog:
            self._run_ingest(len(self._backlog))
        return n

    def _run_ingest(self, budget: int):
        for _ in range(budget):
            if not self._backlog:
                return
            crops, frames = self._backlog.popleft()
            self.ingestor.feed(crops, frames)
            delta = self.ingestor.flush()
            self.stats.n_ingest_chunks += 1
            self.stats.n_ingest_objects += len(crops)
            if self.cfg.prefetch:
                if isinstance(self.engine, ArchiveQueryEngine):
                    self.stats.n_prefetch_gt += self.engine.prefetch(delta)
                else:
                    self.stats.n_prefetch_gt += self.engine.prefetch(
                        delta.touched_cids)

    def _run_batch(self) -> List[QueryResponse]:
        if not self._queue:
            return []
        n = min(len(self._queue), self.cfg.max_batch_requests)
        reqs = [self._queue.popleft() for _ in range(n)]
        # continuous batch: the unique (class, Kx) pairs across every
        # admitted request, in first-appearance order; duplicates share
        # one engine query (identical answers — per-query results depend
        # only on (class, Kx) and engine state, never on batch-mates)
        pair_pos: Dict[Tuple[int, Optional[int]], int] = {}
        classes: List[int] = []
        kxs: List[Optional[int]] = []
        for req in reqs:
            for c, k in zip(req.classes, req.Kx):
                key = (c, None if k is None else int(k))
                if key not in pair_pos:
                    pair_pos[key] = len(classes)
                    classes.append(c)
                    kxs.append(k)
                else:
                    self.stats.n_shared_queries += 1
        results, batch = self.engine.query_many(classes, kxs)
        self.last_batch = batch
        self.stats.n_merged_calls += 1
        self.stats.n_merged_queries += len(classes)
        self.stats.n_query_cycles += 1
        t_done = self.clock()
        responses: List[QueryResponse] = []
        for req in reqs:
            res = [results[pair_pos[(c, None if k is None else int(k))]]
                   for c, k in zip(req.classes, req.Kx)]
            latency = t_done - req.t_submit
            missed = (req.deadline_s is not None
                      and latency > req.deadline_s)
            self.slo.on_complete(req.tenant, latency, missed)
            self._inflight[req.tenant] -= 1
            self.stats.n_completed += 1
            self.stats.n_class_queries += len(req.classes)
            responses.append(QueryResponse(
                request=req, results=res, latency_s=latency,
                deadline_missed=missed, cycle=self.stats.n_cycles))
        return responses
