"""Deployable DA runtime of the port: artifacts and the serving engine.

    save_design / load_design   da4ml-design artifacts, interchangeable
                                with the JAX package's (crash-safe
                                ordered commit, corruption detection)
    design_from_arrays          an artifact's integer data -> a design
                                on a device
    ServeEngine                 microbatched multi-model serving engine
                                on the CUDA card, with deadlines,
                                circuit breaking and shard supervision
"""

from .artifact import (
    FORMAT_NAME,
    FORMAT_VERSION,
    ArtifactCorruptError,
    design_from_arrays,
    load_design,
    save_design,
)
from .engine import (
    CircuitOpenError,
    DeadlineExceededError,
    EngineClosedError,
    ModelUnhealthyError,
    QueueFullError,
    ServeEngine,
    ShardCrashedError,
)
from .metrics import LatencyRecorder, StageAccumulator, percentile
from .resilience import CircuitBreaker

__all__ = [
    "FORMAT_NAME",
    "FORMAT_VERSION",
    "ArtifactCorruptError",
    "CircuitBreaker",
    "CircuitOpenError",
    "DeadlineExceededError",
    "EngineClosedError",
    "LatencyRecorder",
    "ModelUnhealthyError",
    "QueueFullError",
    "ServeEngine",
    "ShardCrashedError",
    "StageAccumulator",
    "design_from_arrays",
    "load_design",
    "percentile",
    "save_design",
]
