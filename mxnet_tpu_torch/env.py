"""Runtime environment-variable catalogue of the PyTorch port.

The port honours the same ``MXNET_*`` names as ``mxnet_tpu/env.py``. Every
variable the port reads is declared here once, with type, default and
documentation; modules read through :func:`get`. Variables of subsystems
that are not yet ported are declared only where setting them must raise
(the serving mesh, sequence buckets and the checkpoint watcher).
"""

from __future__ import annotations

import os
from collections import namedtuple

_Var = namedtuple("_Var", ["name", "parse", "default", "doc"])

_CATALOGUE = {}


def _declare(name, parse, default, doc):
    _CATALOGUE[name] = _Var(name, parse, default, doc)


def _parse_bool(v):
    return str(v).lower() not in ("0", "false", "")


_declare("MXNET_TELEMETRY", _parse_bool, False,
         "Enable host-side span recording (telemetry.span emits Chrome "
         "trace events). Counters/gauges/histograms are always on at "
         "near-zero cost; this flag only gates trace-event capture.")
_declare("MXNET_SERVING_BUCKETS", str, "1,4,16,64",
         "Comma-separated batch-size buckets for serving.ModelServer: the "
         "COMPLETE set of inference shapes. warmup() runs one forward per "
         "bucket and the dynamic batcher coalesces requests up to the "
         "largest bucket, padding partial groups to the smallest covering "
         "one.")
_declare("MXNET_SERVING_MAX_DELAY_MS", float, 2.0,
         "Max milliseconds a queued request waits for batch-mates before "
         "a partial bucket dispatches (the batching deadline — the "
         "serving throughput/latency dial). 0 disables the coalescing "
         "wait; requests still batch with whatever queued during the "
         "previous inference.")
_declare("MXNET_SERVING_QUEUE_DEPTH", int, 256,
         "Admission bound for serving.ModelServer: when this many "
         "requests are already queued, submit() sheds immediately with "
         "ServerOverloaded (serving.shed counter) instead of queueing "
         "unboundedly — p99 stays finite under overload.")
_declare("MXNET_SERVING_DEADLINE_MS", float, 0.0,
         "Default per-request serving deadline: a request whose deadline "
         "passes while still queued is dropped with DeadlineExceeded "
         "(serving.deadline_expired) rather than served after the client "
         "gave up. 0 (default) = no deadline; per-request deadline_ms "
         "overrides.")
_declare("MXNET_SERVING_REPLICAS", int, 0,
         "Model replicas in serving.ModelServer, one per CUDA device: "
         "every replica holds its own device-resident weights and the "
         "dynamic batcher routes each assembled batch to the least-loaded "
         "HEALTHY replica. 0 (default) = auto: every visible CUDA device "
         "for a gpu context, 1 on CPU. Clamped to the devices present.")
_declare("MXNET_SERVING_REPLICA_TIMEOUT_MS", float, 0.0,
         "Per-batch execution watchdog for serving replicas: a device "
         "call exceeding this marks the replica suspect (circuit OPEN, "
         "serving.replica.timeout) and the batch fails over to another "
         "healthy replica. 0 (default) = no watchdog.")
_declare("MXNET_SERVING_MAX_RETRIES", int, 2,
         "Failover re-dispatches of a failed serving batch (after its "
         "first attempt) before the error reaches clients.")
_declare("MXNET_SERVING_HEDGE_MS", float, 0.0,
         "Tail-latency hedging: a serving batch still unanswered after "
         "this many milliseconds is duplicated to a second healthy "
         "replica; the first result wins. 0 (default) = off.")
_declare("MXNET_SERVING_CB_ERRORS", int, 3,
         "Consecutive errors (or slow calls) that trip a serving "
         "replica's circuit breaker OPEN (serving.replica.open).")
_declare("MXNET_SERVING_CB_PROBE_MS", float, 100.0,
         "Initial half-open backoff of a serving replica's circuit "
         "breaker; doubles per failed probe (capped at 10 s).")
_declare("MXNET_SERVING_CB_SLOW_MS", float, 0.0,
         "Slow-call threshold for the serving circuit breaker: successful "
         "replica calls slower than this count toward "
         "MXNET_SERVING_CB_ERRORS. 0 (default) = only real errors count.")
_declare("MXNET_SERVING_MESH", str, "auto",
         "Per-replica device-group layout. Only 'auto' (one-device "
         "replicas) is ported; any other value raises MXNetError.")
_declare("MXNET_SERVING_SEQ_BUCKETS", str, "",
         "Sequence-length buckets. Not yet ported: a non-empty value "
         "raises MXNetError.")
_declare("MXNET_SERVING_WATCH", float, 0.0,
         "Checkpoint-watch poll period for hot reload. Not yet ported: a "
         "non-zero value raises MXNetError.")


def get(name):
    """Typed value of a declared variable (env override else default)."""
    var = _CATALOGUE[name]
    raw = os.environ.get(name)
    if raw is None:
        return var.default
    try:
        return var.parse(raw)
    except (TypeError, ValueError):
        return var.default
