"""Runtime environment-variable catalogue of the PyTorch port.

The port declares every ``MXNET_*`` name of ``mxnet_tpu/env.py``, once,
with type, default and documentation; modules read through :func:`get`.
Each variable is one of three kinds:

* honoured: the port reads it and does what the reference does;
* accepted and ignored: a layout-only or performance-only knob whose
  setting cannot change a result; the note next to it says why;
* not yet ported: its subsystem is missing, so setting it (to a value
  other than its default) raises :class:`MXNetError` naming the
  ``ROADMAP.md`` item, at the entry point it would act on (``fit`` for
  training, ``ModelServer`` for serving; :func:`check_unported`) — never
  silently ignored.

The serving mesh, sequence buckets and checkpoint watcher are honoured
variables whose non-default values raise where they are read.
"""

from __future__ import annotations

import os
from collections import namedtuple

from .base import MXNetError

# status: "honoured", "ignored" or the ROADMAP.md queue 1 item that ports
# the subsystem; scopes: the entry points that check an unported variable
_Var = namedtuple("_Var", ["name", "parse", "default", "doc", "status",
                           "scopes"])

_CATALOGUE = {}
_FIT, _SERVING = ("fit",), ("serving",)
_BOTH = _FIT + _SERVING


def _declare(name, parse, default, doc, status="honoured", scopes=()):
    _CATALOGUE[name] = _Var(name, parse, default, doc, status, scopes)


def _ignored(name, parse, default, doc):
    """A layout- or performance-only variable, accepted and ignored."""
    _declare(name, parse, default, doc, "ignored")


def _unported(name, parse, default, item, scopes, doc):
    """A variable whose subsystem is not yet ported (``item``)."""
    _declare(name, parse, default, f"{doc} Not yet ported (ROADMAP.md queue "
             f"1 item {item}): setting it raises MXNetError.", item, scopes)


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

_declare("MXNET_EXEC_BULK_EXEC_TRAIN", _parse_bool, True,
         "When false, Module.update skips the fused training step "
         "(Executor.fused_train_update, one multi-tensor kernel launch over "
         "every parameter) and applies the optimizer parameter by "
         "parameter (reference MXNET_EXEC_BULK_EXEC_TRAIN).")
_declare("MXNET_NONFINITE_GUARD", str, "",
         "Non-finite-gradient sentinel for training updates: 'skip' adds "
         "every gradient into a device probe inside the fused step and, "
         "when it is NaN/Inf, keeps the old parameters, optimizer state "
         "and BatchNorm statistics (no per-batch host sync); 'rollback' "
         "raises at the epoch end after MXNET_NONFINITE_TOLERANCE "
         "consecutive skips (restoring a checkpoint is not yet ported); "
         "'raise' fails the fit loop on the first skipped batch (a "
         "per-batch host check). Empty (default) = off. Skips are counted "
         "in fit.nonfinite_skip.")
_declare("MXNET_NONFINITE_TOLERANCE", int, 3,
         "Consecutive non-finite-gradient skips tolerated before "
         "MXNET_NONFINITE_GUARD=rollback escalates.")
_declare("MXNET_DEVICE_PREFETCH", _parse_bool, True,
         "When true (default), Module.fit and score (on a full, fresh "
         "pass) wrap the data iterator in io.DevicePrefetchIter: a thread "
         "makes batch N+1 in page-locked memory and copies it to the card "
         "on a side stream while batch N computes. Set to 0 to feed "
         "batches synchronously from the epoch loop.")
_declare("MXNET_PREFETCH_DEPTH", int, 0,
         "Staging-queue depth (batches) of the DevicePrefetchIter that "
         "fit and score wrap around their iterators. 0 (default) = auto: "
         "2, grown to K x depth + 1 once fit's training windows engage "
         "(MXNET_TRAIN_WINDOW, MXNET_DISPATCH_DEPTH), so the staged "
         "batches cover every window in flight. An explicit value is "
         "honoured as it is.")
_declare("MXNET_TRAIN_WINDOW", str, "",
         "Steps per training window of Module.fit: an integer K hands "
         "chunks of K batches to Module.train_window (K eager steps on the "
         "hand-written kernels, the hyperparameters frozen at the window's "
         "first step); 'auto' probes a few single-step batches and picks K "
         "from the measured dispatch-vs-residual span ratio "
         "(aot.choose_train_window). Windows move lr-schedule, metric and "
         "batch-callback updates to window granularity. Empty (default) "
         "keeps the per-batch loop.")
_declare("MXNET_DISPATCH_DEPTH", str, "",
         "Training windows Module.fit keeps in flight: the host enqueues "
         "window N+1 while window N runs on the card and fences "
         "(WindowBoundary.wait, a CUDA event) only when the count would "
         "exceed this depth. An integer >= 1 fixes it; empty/'auto' "
         "(default) lets the window scheduler co-tune it with K "
         "(aot.choose_dispatch_depth, >= 2 whenever windows engage). "
         "Published on the fit.dispatch_depth gauge; "
         "MXNET_NONFINITE_GUARD=rollback caps it at 1. Each window in "
         "flight holds K staged batches of device memory.")


# --- accepted and ignored: layout- and performance-only -------------------
_ignored("MXNET_ENGINE_TYPE", str, "ThreadedEnginePerDevice",
         "Execution engine; 'NaiveEngine' runs the reference synchronously "
         "for debugging. Ignored: the port runs eagerly in stream order "
         "either way, with the same results.")
_ignored("MXNET_CPU_WORKER_NTHREADS", int, 4,
         "Host threads of the decode plane. Ignored (performance only; "
         "the decode plane is ROADMAP.md queue 1 item 6).")
_ignored("MXNET_KVSTORE_BIGARRAY_BOUND", int, 1000000,
         "Server sharding threshold of the reference kvstore. Ignored, as "
         "the JAX package ignores it.")
_ignored("MXNET_BACKWARD_DO_MIRROR", _parse_bool, False,
         "Rematerialise activations in the backward to save memory. "
         "Ignored (memory and speed only, never the result).")
_ignored("MXNET_PACK_SMALL_PARAMS", _parse_bool, True,
         "Pack small parameters into one buffer at the training step's "
         "boundary. Ignored (performance only).")
_ignored("MXNET_WINDOW_AUTO_LAYOUT", _parse_bool, True,
         "Let the compiler choose buffer layouts of training windows. "
         "Ignored (layout only).")
_ignored("MXNET_AOT_CACHE", _parse_bool, False,
         "Persist compiled programs on disk. Ignored (performance only): "
         "eager PyTorch compiles no program.")
_ignored("MXNET_AOT_CACHE_DIR", str, "~/.cache/mxnet_tpu/aot",
         "Directory of the program cache. Ignored with MXNET_AOT_CACHE.")
_ignored("MXNET_IO_POOL", _parse_bool, True,
         "Decode RecordIO batches on a worker pool (byte-identical to the "
         "serial path). Ignored (performance only).")
_ignored("MXNET_IO_QUEUE_DEPTH", int, 0,
         "Bound on decoded batches held by the decode pool. Ignored "
         "(memory only).")
_ignored("MXNET_XLA_TPU_OPTIONS", str, "",
         "XLA compiler options for TPU programs. Ignored: the port "
         "compiles no XLA program.")
_ignored("MXNET_XLA_FLAGS", str, "",
         "XLA compiler options for every program. Ignored: the port "
         "compiles no XLA program.")
_ignored("MXNET_CONV_LAYOUT", str, "auto",
         "Device layout of the convolution stack (NCHW or NHWC). Ignored "
         "(layout only; the logical layout is NCHW either way).")

# --- not yet ported: setting them raises ----------------------------------
_unported("MXNET_PROFILER_AUTOSTART", _parse_bool, False, 15, _BOTH,
          "Start the profiler at import.")
_unported("MXNET_PROFILER_MODE", str, "symbolic", 15, _BOTH,
          "Profiler mode ('symbolic' or 'all').")
_unported("MXNET_COORDINATOR", str, "", 7, _BOTH,
          "host:port of process 0 of a multi-host job.")
_unported("MXNET_NUM_PROCS", int, 1, 7, _BOTH,
          "Processes in a multi-host job.")
_unported("MXNET_PROC_ID", int, 0, 7, _BOTH,
          "This process's rank in a multi-host job.")
_unported("MXNET_MESH", str, "", 7, _BOTH,
          "Default device mesh every module binds against.")
_unported("MXNET_MESH_BACKEND", str, "", 7, _BOTH,
          "Backend whose devices back MXNET_MESH.")
_unported("MXNET_PP_MICROBATCHES", int, 0, 14, _FIT,
          "Pipeline-parallel microbatches.")
for _name, _parse, _default, _doc in (
        ("MXNET_PS_PORT", int, 0, "Port of the dist_async server."),
        ("MXNET_PS_EXIT_TIMEOUT", float, 3600.0,
         "Seconds the dist_async server waits for workers at exit."),
        ("MXNET_PS_KEY", str, "", "Key authenticating dist_async frames."),
        ("MXNET_PS_MAX_FRAME", int, 1 << 31,
         "Largest dist_async frame payload."),
        ("MXNET_KV_TIMEOUT", float, 0.0,
         "Seconds a dist kvstore barrier may block."),
        ("MXNET_KV_TRANSPORT", str, "mesh",
         "Collective transport of the dist kvstore."),
        ("MXNET_KV_HEARTBEAT_MS", float, 1000.0,
         "Elastic transport heartbeat interval."),
        ("MXNET_KV_PEER_TIMEOUT", float, 10.0,
         "Elastic transport heartbeat silence before a worker is dead."),
        ("MXNET_KV_RECONNECT", float, 60.0,
         "Elastic transport reconnect window."),
        ("MXNET_KV_MAX_STALENESS", int, 0,
         "Elastic transport bounded staleness."),
        ("MXNET_KV_BACKUP_WORKERS", int, 0,
         "Elastic transport backup workers."),
        ("MXNET_KV_COMPRESS", str, "",
         "Elastic transport gradient compression.")):
    _unported(_name, _parse, _default, 7, _FIT, _doc)
for _name, _parse, _default, _doc in (
        ("MXNET_CHECKPOINT_DIR", str, "",
         "fit checkpoints here and resumes from the newest valid commit."),
        ("MXNET_CHECKPOINT_PERIOD", int, 1, "Epochs between checkpoints."),
        ("MXNET_CHECKPOINT_KEEP", int, 3, "Checkpoints kept."),
        ("MXNET_CHECKPOINT_BATCH_PERIOD", int, 0,
         "Batches between mid-epoch checkpoints."),
        ("MXNET_CKPT_ASYNC", _parse_bool, False,
         "Write checkpoints on a writer thread."),
        ("MXNET_CKPT_CONSENSUS", _parse_bool, True,
         "Resume from the commit rank 0 verified.")):
    _unported(_name, _parse, _default, "4b", _FIT, _doc)
_unported("MXNET_IO_RETRY", int, 0, "3b", _FIT,
          "fit retries transient data-source failures this many times.")
_unported("MXNET_IO_RETRY_BACKOFF", float, 0.05, "3b", _FIT,
          "Initial backoff of the retrying iterator.")
_unported("MXNET_IO_WORKER_TIMEOUT_MS", float, 60000.0, 6, _FIT,
          "Hung-decode watchdog of the decode pool.")
_unported("MXNET_SERVING_MAX_BODY_BYTES", int, 64 << 20, 5, _SERVING,
          "HTTP request-body cap of the serving front end.")
_unported("MXNET_SERVING_SEQ_AXIS", int, 0, "9.4", _SERVING,
          "Sample axis that MXNET_SERVING_SEQ_BUCKETS buckets on.")
_unported("MXNET_SERVING_CANARY_PCT", float, 0.0, 5, _SERVING,
          "Share of traffic routed to a canary weight set.")
_unported("MXNET_SERVING_SHADOW", int, 0, 5, _SERVING,
          "Duplicate every request to a shadow server.")
_unported("MXNET_SANITIZER", int, 0, 16, _BOTH,
          "Arm the runtime concurrency sanitizer.")
_unported("MXNET_SANITIZER_HOLD_MS", float, 0.0, 16, _BOTH,
          "Held-too-long threshold of the sanitizer.")
# fault injection (faultinject.py)
for _name, _parse, _default, _scopes in (
        ("MXNET_FI_KV_KILL_RANK", int, -1, _FIT),
        ("MXNET_FI_KV_KILL_AT_BATCH", int, -1, _FIT),
        ("MXNET_FI_KV_DELAY_MS", float, 0.0, _FIT),
        ("MXNET_FI_KV_DELAY_RANK", int, -1, _FIT),
        ("MXNET_FI_KV_DROP_EVERY", int, 0, _FIT),
        ("MXNET_FI_KV_CORRUPT_EVERY", int, 0, _FIT),
        ("MXNET_FI_CRASH_AT_BATCH", int, -1, _FIT),
        ("MXNET_FI_NAN_BATCHES", str, "", _FIT),
        ("MXNET_FI_ITER_RAISE_BATCHES", str, "", _FIT),
        ("MXNET_FI_CORRUPT_CKPT", str, "", _FIT),
        ("MXNET_FI_CKPT_KILL_PHASE", str, "", _FIT),
        ("MXNET_NUM_RESTARTS", int, 0, _FIT),
        ("MXNET_FI_ATTEMPT", int, 0, _FIT),
        ("MXNET_FI_RANK", int, -1, _FIT),
        ("MXNET_FI_EXIT_CODE", int, 17, _FIT),
        ("MXNET_FI_IO_CRASH_BATCHES", str, "", _FIT),
        ("MXNET_FI_IO_HANG_BATCHES", str, "", _FIT),
        ("MXNET_FI_IO_HANG_MS", float, 500.0, _FIT),
        ("MXNET_FI_SERVE_RAISE_REPLICA", str, "", _SERVING),
        ("MXNET_FI_SERVE_LATENCY_MS", float, 0.0, _SERVING),
        ("MXNET_FI_SERVE_LATENCY_REPLICA", int, -1, _SERVING),
        ("MXNET_FI_SERVE_FAIL_EVERY", int, 0, _SERVING),
        ("MXNET_FI_SERVE_RELOAD_CORRUPT", str, "", _SERVING)):
    _unported(_name, _parse, _default, 15, _scopes,
              "Fault injection (the reference's faultinject.py).")


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


def check_unported(scope):
    """Raise :class:`MXNetError` when a variable whose subsystem is not
    yet ported, and that acts on entry point ``scope`` (``"fit"`` or
    ``"serving"``), is set to a value other than its default."""
    for var in _CATALOGUE.values():
        if (scope in var.scopes and var.name in os.environ
                and get(var.name) != var.default):
            raise MXNetError(
                f"{var.name}={os.environ[var.name]!r}: its subsystem is not "
                f"yet ported to mxnet_tpu_torch (ROADMAP.md queue 1 item "
                f"{var.status}); unset it")
