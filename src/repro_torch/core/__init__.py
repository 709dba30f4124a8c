"""Focus core: clustering, the top-K index, ingest and query."""
from repro_torch.core.index import (  # noqa: F401
    ClassMap,
    Cluster,
    ClusterStore,
    TopKIndex,
    OTHER,
)
from repro_torch.core.engine import (  # noqa: F401
    BatchQueryStats,
    EngineStats,
    QueryEngine,
)
from repro_torch.core.archive import (  # noqa: F401
    ArchiveBatchStats,
    ArchiveQueryEngine,
    ArchiveQueryResult,
    ShardCatalog,
    ShardLoader,
    ShardMeta,
)
from repro_torch.core.ingest import IngestConfig, IngestStats, ingest  # noqa: F401
from repro_torch.core.pipeline import (  # noqa: F401
    IngestPipeline,
    PipelineStats,
    ShardedIngestPipeline,
    batch_bucket,
    staged_cheap_apply,
)
from repro_torch.core.streaming import (  # noqa: F401
    IngestDelta,
    MultiStreamRunner,
    StreamPlacement,
    StreamingIngestor,
    make_sharded_runner,
)
from repro_torch.core.query import (  # noqa: F401
    BaselineCosts,
    QueryResult,
    dominant_classes,
    gt_frames_by_class,
    gpu_seconds,
    precision_recall,
    query,
)
