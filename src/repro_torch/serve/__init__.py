"""Multi-tenant query serving layer: request queue + admission control, a
continuous batcher merging all in-flight queries into one ``query_many``
per cycle, and per-tenant latency-SLO accounting."""
from repro_torch.serve.service import (QueryRequest, QueryResponse,
                                       QueryService, ServiceConfig,
                                       ServiceStats)
from repro_torch.serve.slo import LatencyTracker, TenantStats

__all__ = [
    "LatencyTracker",
    "QueryRequest",
    "QueryResponse",
    "QueryService",
    "ServiceConfig",
    "ServiceStats",
    "TenantStats",
]
