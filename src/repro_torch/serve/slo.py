"""Per-tenant latency-SLO accounting for the query service (DESIGN.md §12).

Each tenant accumulates the latency (submit -> completion) of every
completed request plus counters for admission rejections and deadline
misses. p50/p99 are percentiles over the completed-request latencies —
a rejected request never enters the distribution (it was shed, not
served), which keeps the latency numbers honest under overload: shedding
must show up in ``n_rejected``, not as an artificially good tail.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class TenantStats:
    """SLO counters and the latency distribution for one tenant."""
    tenant: str
    n_submitted: int = 0
    n_rejected: int = 0              # shed by admission control
    n_completed: int = 0
    n_deadline_missed: int = 0
    latencies_s: List[float] = field(default_factory=list)

    def percentile_s(self, q: float) -> float:
        """Latency percentile over completed requests (NaN if none)."""
        if not self.latencies_s:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies_s), q))

    @property
    def p50_s(self) -> float:
        return self.percentile_s(50.0)

    @property
    def p99_s(self) -> float:
        return self.percentile_s(99.0)


class LatencyTracker:
    """tenant name -> ``TenantStats``, plus service-wide aggregates."""

    def __init__(self):
        self._tenants: Dict[str, TenantStats] = {}

    def tenant(self, name: str) -> TenantStats:
        ts = self._tenants.get(name)
        if ts is None:
            ts = self._tenants[name] = TenantStats(tenant=name)
        return ts

    def __iter__(self):
        return iter(sorted(self._tenants.values(), key=lambda t: t.tenant))

    def __len__(self) -> int:
        return len(self._tenants)

    def on_submit(self, name: str) -> TenantStats:
        ts = self.tenant(name)
        ts.n_submitted += 1
        return ts

    def on_reject(self, name: str):
        self.tenant(name).n_rejected += 1

    def on_complete(self, name: str, latency_s: float, missed: bool):
        ts = self.tenant(name)
        ts.n_completed += 1
        ts.latencies_s.append(float(latency_s))
        if missed:
            ts.n_deadline_missed += 1

    def all_latencies_s(self) -> np.ndarray:
        """Every completed-request latency across tenants (for service
        p50/p99)."""
        out: List[float] = []
        for ts in self._tenants.values():
            out.extend(ts.latencies_s)
        return np.asarray(out, np.float64)

    def percentile_s(self, q: float) -> float:
        lat = self.all_latencies_s()
        if len(lat) == 0:
            return float("nan")
        return float(np.percentile(lat, q))

    def summary(self) -> Dict[str, dict]:
        """JSON-friendly per-tenant summary (benchmark / entry-point output)."""
        return {
            ts.tenant: {
                "submitted": ts.n_submitted,
                "rejected": ts.n_rejected,
                "completed": ts.n_completed,
                "deadline_missed": ts.n_deadline_missed,
                "p50_ms": round(ts.p50_s * 1e3, 3) if ts.latencies_s else None,
                "p99_ms": round(ts.p99_s * 1e3, 3) if ts.latencies_s else None,
            }
            for ts in self
        }
