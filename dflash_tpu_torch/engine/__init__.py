from dflash_tpu_torch.engine.batching import (
    BucketedEngine,
    BucketSpec,
    ContinuousBatchingEngine,
    EngineConfig,
    Request,
)

__all__ = [
    "BucketedEngine",
    "BucketSpec",
    "ContinuousBatchingEngine",
    "EngineConfig",
    "Request",
]
