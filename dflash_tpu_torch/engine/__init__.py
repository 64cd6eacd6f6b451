from dflash_tpu_torch.engine.batching import (
    BucketedEngine,
    BucketSpec,
    ContinuousBatchingEngine,
    EngineConfig,
    Request,
)
from dflash_tpu_torch.engine.disagg import DisaggResult, PrefillWorker

__all__ = [
    "BucketedEngine",
    "BucketSpec",
    "ContinuousBatchingEngine",
    "DisaggResult",
    "EngineConfig",
    "PrefillWorker",
    "Request",
]
