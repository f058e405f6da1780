"""Typed serving errors.

All subclass :class:`~mxnet_tpu_torch.base.MXNetError` so existing callers that
catch the framework's base error keep working; the HTTP frontend maps each
to a distinct status code (503/504) so clients can tell "back off" from
"give up".
"""

from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServingError", "ServerOverloaded", "DeadlineExceeded",
           "ServerClosed", "NoHealthyReplicas", "ReplicaTimeout",
           "WorkerCrashed"]


class ServingError(MXNetError):
    """Base class of every serving-subsystem error."""


class ServerOverloaded(ServingError):
    """The admission queue is full — the request was shed (reject-fast,
    never queued). Clients should back off and retry; the HTTP frontend
    returns 503 with a Retry-After hint. Counted in ``serving.shed``."""


class DeadlineExceeded(ServingError):
    """The request's deadline expired while it waited in the queue; it was
    dropped without running inference (the work would be wasted — the
    client has already given up). HTTP 504."""


class ServerClosed(ServingError):
    """The server is draining or closed and accepts no new requests.
    In-flight and already-queued requests still complete (graceful
    drain)."""


class NoHealthyReplicas(ServingError):
    """Every replica's circuit breaker is open (or ejected) and none is
    yet probe-eligible — the request fails fast and typed instead of
    queueing toward a deadline that cannot be met. Clients should back
    off; the HTTP frontend returns 503 with ``Retry-After``. Counted in
    ``serving.no_capacity``."""


class ReplicaTimeout(ServingError):
    """A batch exceeded the per-replica execution watchdog
    (``MXNET_SERVING_REPLICA_TIMEOUT_MS``). The replica is marked suspect
    (breaker OPEN) and the batch fails over; this error surfaces only
    when every failover attempt also failed. The one ``ServingError``
    the pool retries — a timeout is an infrastructure fault, not an
    admission verdict."""


class WorkerCrashed(ServingError):
    """The batcher worker hit an unhandled error outside the per-batch
    guard; pending requests are failed with this (instead of stranding
    their futures forever) and the worker restarts. Counted in
    ``serving.worker_crash``; HTTP 500."""
