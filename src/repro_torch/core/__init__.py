"""DynaServe's primary contribution: Adaptive Request Partitioning and
Scheduling (APS) — micro-requests, the two-level scheduler, chunked KV
transfer, and the online serving session that drives them on either
backend (simulator or real JAX engines)."""
from repro_torch.core.request import (  # noqa: F401
    BATCH, INTERACTIVE, MicroRequest, Request, RequestState, SLO_CLASSES,
    SLOClass, STANDARD, split_request,
)
from repro_torch.core.session import (  # noqa: F401
    Backend, ServeHandle, ServeSession, SessionConfig, SessionMetrics,
    SessionStallError,
)
from repro_torch.core.costmodel import HardwareSpec, A100, TPU_V5E, BatchCostModel  # noqa: F401
from repro_torch.core.local_scheduler import LocalScheduler, ProfileTable  # noqa: F401
from repro_torch.core.predictor import ExecutionPredictor, QueuedWork  # noqa: F401
from repro_torch.core.global_scheduler import GlobalScheduler  # noqa: F401
from repro_torch.core.kv_transfer import ChunkTransferPlan, plan_chunked_transfer  # noqa: F401
from repro_torch.core.elastic import (  # noqa: F401
    DrainInstance, ElasticConfig, InstanceStat, MigrateWork, PoolController,
    ScaleUp, SetRoleBias,
)
