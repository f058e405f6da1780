"""Model serving: dynamic batching, bucketed inference, load shedding and
replica failover, on CUDA devices.

The port of ``mxnet_tpu/serving`` for single-device replicas with fixed
batch buckets (see :mod:`.server` for what is not yet ported).
"""

from .batcher import DynamicBatcher
from .errors import (DeadlineExceeded, NoHealthyReplicas, ReplicaTimeout,
                     ServerClosed, ServerOverloaded, ServingError,
                     WorkerCrashed)
from .metrics import LatencyHistogram
from .replica import Replica, ReplicaPool
from .server import ModelServer, ServingConfig

__all__ = [
    "DynamicBatcher", "LatencyHistogram", "ModelServer", "Replica",
    "ReplicaPool", "ServingConfig",
    "ServingError", "ServerOverloaded", "DeadlineExceeded", "ServerClosed",
    "NoHealthyReplicas", "ReplicaTimeout", "WorkerCrashed",
]
