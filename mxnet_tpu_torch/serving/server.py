"""ModelServer: replicated, bucketed inference with admission control and
health-gated failover, on CUDA devices.

Counterpart of ``mxnet_tpu/serving/server.py``. A :class:`ModelServer`
owns N :class:`Replica`\\ s — one per CUDA device, clamped to
``torch.cuda.device_count()`` — each holding one
:class:`~mxnet_tpu_torch.predictor.Predictor` per configured bucket batch
size (or per (batch, seq) bucket pair, when a ``sym_gen`` gives one
symbol per sequence-length bucket) over its own device-resident copy of
the weights, plus a
:class:`~mxnet_tpu_torch.serving.batcher.DynamicBatcher` that coalesces
concurrent requests into those fixed shapes and a
:class:`~mxnet_tpu_torch.serving.replica.ReplicaPool` that routes every
assembled batch to the least-loaded healthy replica. :meth:`warmup` runs
one forward per (replica, bucket) before traffic is admitted, so CUDA
module loading, cuDNN's algorithm choice and the kernel build never land
behind a request.

With sequence buckets (``ServingConfig(seq_buckets=...)`` and a
``sym_gen``), each request's sequence axis is zero-padded up to the
smallest covering bucket, only requests of one bucket share a batch, and
each answer comes back padded to its bucket, as the reference serves them.

Not yet ported, and refused with :class:`MXNetError` rather than ignored:
device-group replicas (``mesh``), hot reload (:meth:`ModelServer.reload`,
``watch_dir``), the ``int8`` variant, checkpoint-directory parameters and
the HTTP frontend (``max_body_bytes``).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from .. import env as _env
from .. import telemetry as _tm
from ..base import MXNetError
from .batcher import DynamicBatcher
from .errors import ServerClosed
from .metrics import LatencyHistogram
from .replica import Replica, ReplicaPool

__all__ = ["ServingConfig", "ModelServer"]


def _not_ported(what):
    return MXNetError(f"{what} is not yet ported to mxnet_tpu_torch")


def _parse_buckets(raw):
    try:
        buckets = sorted({int(b) for b in str(raw).split(",") if b.strip()})
    except ValueError as e:
        raise MXNetError(f"bad bucket list {raw!r}: {e}") from e
    if not buckets or buckets[0] < 1:
        raise MXNetError(f"bad bucket list {raw!r}")
    return tuple(buckets)


class ServingConfig:
    """Serving policy. Every knob defaults from its ``MXNET_SERVING_*``
    env var so deployments tune without code changes.

    Parameters
    ----------
    buckets : sequence of int or str
        Batch-size buckets (the complete set of served shapes).
    max_delay_ms : float
        Max milliseconds a request waits for batch-mates before a partial
        bucket dispatches. 0 disables coalescing beyond what queues
        naturally during inference.
    queue_depth : int
        Admission bound; a full queue sheds (``ServerOverloaded``). The
        effective bound scales with the healthy-replica fraction.
    deadline_ms : float
        Default per-request deadline (0 = none). A request whose deadline
        passes while queued is dropped with ``DeadlineExceeded``.
    fold_bn : bool
        Fold inference BatchNorms into their producers once, server-wide.
    replicas : int
        Model replicas, one per CUDA device. 0 (default) = auto: every
        visible CUDA device for a gpu context, 1 on CPU. Clamped to the
        devices actually present.
    replica_timeout_ms, max_retries, hedge_ms, cb_errors, cb_probe_ms,
    cb_slow_ms
        Replica-pool health policy (watchdog, failover re-dispatches,
        hedging, circuit breaker); see ``serving/replica.py``.
    seq_buckets : sequence of int or str
        Sequence-length buckets (empty: fixed-shape serving); with them the
        server needs a ``sym_gen``.
    seq_axis : int
        The per-sample axis that ``seq_buckets`` bucket on (0: the first).
    mesh, watch_dir, watch_period, max_body_bytes
        Not yet ported: a value other than the default raises
        :class:`MXNetError`.
    """

    __slots__ = ("buckets", "max_delay", "queue_depth", "deadline",
                 "fold_bn", "replicas", "replica_timeout", "max_retries",
                 "hedge", "cb_errors", "cb_probe", "cb_slow", "seq_buckets",
                 "seq_axis")

    def __init__(self, buckets=None, max_delay_ms=None, queue_depth=None,
                 deadline_ms=None, watch_dir=None, watch_period=None,
                 fold_bn=True, replicas=None, replica_timeout_ms=None,
                 max_retries=None, hedge_ms=None, cb_errors=None,
                 cb_probe_ms=None, cb_slow_ms=None, max_body_bytes=None,
                 mesh=None, seq_buckets=None, seq_axis=None):
        _env.check_unported("serving")
        if mesh is None:
            mesh = _env.get("MXNET_SERVING_MESH")
        if str(mesh or "auto").strip().lower() not in ("", "auto"):
            raise _not_ported(f"serving mesh {mesh!r}")
        if watch_period is None:
            watch_period = _env.get("MXNET_SERVING_WATCH")
        if watch_dir or float(watch_period) > 0:
            raise _not_ported("checkpoint watching (hot reload)")
        if max_body_bytes is not None:
            raise _not_ported("the HTTP frontend (max_body_bytes)")

        if buckets is None:
            buckets = _env.get("MXNET_SERVING_BUCKETS")
        if isinstance(buckets, str):
            buckets = _parse_buckets(buckets)
        else:
            buckets = _parse_buckets(",".join(map(str, buckets)))
        self.buckets = buckets

        def _ms(value, env_name, floor=0.0):
            if value is None:
                value = _env.get(env_name)
            return max(floor, float(value)) / 1e3

        self.max_delay = _ms(max_delay_ms, "MXNET_SERVING_MAX_DELAY_MS")
        if queue_depth is None:
            queue_depth = _env.get("MXNET_SERVING_QUEUE_DEPTH")
        self.queue_depth = max(1, int(queue_depth))
        self.deadline = _ms(deadline_ms, "MXNET_SERVING_DEADLINE_MS")
        self.fold_bn = bool(fold_bn)
        if replicas is None:
            replicas = _env.get("MXNET_SERVING_REPLICAS")
        self.replicas = max(0, int(replicas))
        self.replica_timeout = _ms(replica_timeout_ms,
                                   "MXNET_SERVING_REPLICA_TIMEOUT_MS")
        if max_retries is None:
            max_retries = _env.get("MXNET_SERVING_MAX_RETRIES")
        self.max_retries = max(0, int(max_retries))
        self.hedge = _ms(hedge_ms, "MXNET_SERVING_HEDGE_MS")
        if cb_errors is None:
            cb_errors = _env.get("MXNET_SERVING_CB_ERRORS")
        self.cb_errors = max(1, int(cb_errors))
        self.cb_probe = _ms(cb_probe_ms, "MXNET_SERVING_CB_PROBE_MS",
                            floor=1.0)
        self.cb_slow = _ms(cb_slow_ms, "MXNET_SERVING_CB_SLOW_MS")
        if seq_buckets is None:
            seq_buckets = _env.get("MXNET_SERVING_SEQ_BUCKETS")
        if isinstance(seq_buckets, str):
            self.seq_buckets = (_parse_buckets(seq_buckets)
                                if seq_buckets.strip() else ())
        elif seq_buckets:
            self.seq_buckets = _parse_buckets(
                ",".join(map(str, seq_buckets)))
        else:
            self.seq_buckets = ()
        if seq_axis is None:
            seq_axis = _env.get("MXNET_SERVING_SEQ_AXIS")
        self.seq_axis = max(0, int(seq_axis))


def _load_params(source):
    """``(arg_params, aux_params)`` from a params dict (plain or
    ``arg:``/``aux:``-prefixed), a ``.params`` file or a param blob."""
    from ..ndarray import load as nd_load, load_buffer

    if isinstance(source, (str, os.PathLike)):
        source = os.fspath(source)
        if os.path.isdir(source):
            raise _not_ported("serving from a checkpoint directory")
        params = nd_load(source)
    elif isinstance(source, bytes):
        params = load_buffer(source)
    else:
        params = source
    arg_params, aux_params = {}, {}
    for k, v in params.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


class ModelServer:
    """Batched, bucketed, replicated, overload-protected inference server.

    Parameters
    ----------
    symbol : Symbol, json str, or symbol file path
        The model graph (resolved exactly like ``Predictor``); None with a
        ``sym_gen``.
    params : dict / ``.params`` path / param blob
        Initial weights.
    input_shapes : dict name -> per-SAMPLE shape
        e.g. ``{"data": (3, 224, 224)}`` — no batch dimension; the bucket
        predictors prepend their batch sizes (and, with seq buckets, set
        the seq axis to their bucket's length).
    config : ServingConfig or None
        None reads the ``MXNET_SERVING_*`` defaults.
    ctx, dev_type, dev_id
        Where replica 0 lives; the default is the card, ``gpu(0)``.
        Without CUDA a gpu context raises :class:`MXNetError`.
    input_types : dict name -> dtype, optional
        Input dtypes (forwarded to each bucket ``Predictor``).
    sym_gen : callable, optional
        ``sym_gen(seq_len)`` -> symbol (or BucketingModule's ``(symbol,
        data_names, label_names)``), called once per seq bucket; required
        with seq buckets, refused without them. BatchNorm folding is then
        skipped.
    variant
        Not yet ported: anything but ``None`` or ``"f32"`` raises
        :class:`MXNetError`.

    Lifecycle: ``warmup()`` (one forward per replica × bucket) →
    ``start()`` (accept traffic; implies warmup) → ``submit``/``predict``
    → ``close()`` (drain + stop).
    """

    def __init__(self, symbol, params, input_shapes, config=None, ctx=None,
                 dev_type="gpu", dev_id=0, input_types=None, logger=None,
                 sym_gen=None, variant=None):
        from ..context import Context
        from ..symbol import Symbol, fromjson, load as sym_load

        if variant not in (None, "f32"):
            raise _not_ported(f"serving variant {variant!r}")
        self.config = config or ServingConfig()
        self.logger = logger or logging.getLogger("mxnet_tpu_torch.serving")
        self.variant = "f32"
        self._sym_gen = sym_gen
        if sym_gen is not None:
            # BucketingModule-style sequence serving: the symbol varies
            # per seq-len bucket; fold_bn is skipped (folding per-bucket
            # graphs against one shared weight set is out of scope)
            if not self.config.seq_buckets:
                raise MXNetError(
                    "sym_gen given but no seq buckets configured "
                    "(MXNET_SERVING_SEQ_BUCKETS / ServingConfig"
                    "(seq_buckets=...))")
            sym = None
        elif self.config.seq_buckets:
            raise MXNetError(
                "seq buckets configured but no sym_gen given: "
                "variable-length serving needs the per-seq-len symbol "
                "factory (BucketingModule's sym_gen contract)")
        elif isinstance(symbol, Symbol):
            sym = symbol
        elif isinstance(symbol, str) and symbol.lstrip().startswith("{"):
            sym = fromjson(symbol)
        else:
            sym = sym_load(symbol)
        arg_params, aux_params = _load_params(params)
        if sym is None:
            self._symbol = None
        else:
            self._symbol, arg_params, aux_params = self._fold(
                sym, arg_params, aux_params)
        self._sample_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self._input_names = tuple(self._sample_shapes)
        self._input_types = dict(input_types or {})
        self._ctx = ctx or Context(dev_type, dev_id)
        self._ctx.torch_device()  # no card for a gpu context: raise now
        # one symbol per seq bucket, generated once (every replica and
        # batch bucket shares the same per-seq graph)
        self._seq_syms = {s: self._gen_symbol(s)
                          for s in self.config.seq_buckets}

        replicas = []
        for rid, rctx in enumerate(self._replica_contexts()):
            # move weights to EACH replica's device once: that replica's
            # bucket predictors then all bind the same device-resident
            # tensors (as_in_context is a no-op in-context)
            r_args = self._to_ctx(arg_params, rctx)
            r_aux = self._to_ctx(aux_params, rctx)
            preds = {key: self._make_predictor(bsym, shapes, rctx, r_args,
                                               r_aux)
                     for key, bsym, shapes in self._bucket_items()}
            replicas.append(Replica(rid, rctx, preds))
        self._pool = ReplicaPool(
            replicas,
            timeout=self.config.replica_timeout,
            max_retries=self.config.max_retries,
            hedge=self.config.hedge,
            cb_errors=self.config.cb_errors,
            cb_probe=self.config.cb_probe,
            cb_slow=self.config.cb_slow,
            logger=self.logger)
        self._predictors = replicas[0].predictors
        p1 = self._predictors[next(iter(self._predictors))]
        self._input_dtypes = p1.input_dtypes()
        self.latency = LatencyHistogram()
        self._batcher = DynamicBatcher(
            self._infer, self.config.buckets,
            max_delay=self.config.max_delay,
            queue_depth=self.config.queue_depth,
            latency_observer=self.latency.observe_us,
            capacity_fn=self._pool.capacity_fraction,
            dispatch_concurrency=len(replicas),
        )
        self._warm = False
        self._closed = False
        self.version = 0

    # -- construction helpers ------------------------------------------
    def _gen_symbol(self, seq_len):
        sym = self._sym_gen(seq_len)
        if isinstance(sym, tuple):  # (symbol, data_names, label_names)
            sym = sym[0]
        return sym

    def _seq_shape(self, sample_shape, seq_len):
        shape = list(sample_shape)
        shape[self.config.seq_axis] = seq_len
        return tuple(shape)

    def _bucket_items(self):
        """Yield ``(predictor key, symbol, batched input shapes)`` per
        served shape: plain batch buckets, or ``(batch, seq)`` composite
        keys when seq bucketing is on — every program one replica hosts
        (and warmup runs)."""
        for b in self.config.buckets:
            if self.config.seq_buckets:
                for s in self.config.seq_buckets:
                    shapes = {n: (b,) + self._seq_shape(shape, s)
                              for n, shape in self._sample_shapes.items()}
                    yield (b, s), self._seq_syms[s], shapes
            else:
                shapes = {n: (b,) + shape
                          for n, shape in self._sample_shapes.items()}
                yield b, self._symbol, shapes

    def _make_predictor(self, sym, shapes, rctx, r_args, r_aux):
        from ..predictor import Predictor

        return Predictor(
            sym, self._combined(r_args, r_aux), shapes, ctx=rctx,
            fold_bn=False, input_types=self._input_types or None)

    def _replica_contexts(self):
        """One Context per replica. ``config.replicas == 0`` is auto: every
        visible CUDA device for a gpu context, 1 on CPU. A request beyond
        the devices present clamps with a warning."""
        import torch

        from ..context import Context

        dev_type = self._ctx.device_type
        on_gpu = dev_type == "gpu"
        avail = torch.cuda.device_count() if on_gpu else 1
        want = self.config.replicas
        if want == 0:
            want = avail
        if want > avail:
            self.logger.warning(
                "serving: %d replicas requested but only %d %s device(s) "
                "present; clamping", want, avail, dev_type)
            want = avail
        if want <= 1:
            return [self._ctx]
        ids = [self._ctx.device_id] + [
            i for i in range(avail) if i != self._ctx.device_id]
        return [Context(dev_type, i) for i in ids[:want]]

    def _fold(self, sym, arg_params, aux_params):
        """Fold inference BatchNorms ONCE at the server level; every
        bucket predictor then shares the folded symbol and weights."""
        if not self.config.fold_bn:
            return sym, arg_params, aux_params
        from ..contrib import fold_batchnorm

        try:
            folded_sym, folded_args = fold_batchnorm(
                sym, arg_params, aux_params)
        except MXNetError:
            # malformed/partial param sets: serve unfolded
            return sym, arg_params, aux_params
        return folded_sym, folded_args, aux_params

    @staticmethod
    def _to_ctx(params, ctx):
        from ..ndarray import NDArray

        return {k: v.as_in_context(ctx) if isinstance(v, NDArray) else v
                for k, v in params.items()}

    @staticmethod
    def _combined(arg_params, aux_params):
        d = {f"arg:{k}": v for k, v in arg_params.items()}
        d.update({f"aux:{k}": v for k, v in aux_params.items()})
        return d

    def predictor(self, bucket, replica=0):
        """A replica's underlying Predictor for one bucket, a batch size or
        a ``(batch, seq)`` pair (benchmarks and tests; do not drive it
        while traffic is flowing)."""
        return self._pool.replicas[replica].predictors[bucket]

    @property
    def replicas(self):
        """The replica pool's replicas (read-mostly introspection)."""
        return self._pool.replicas

    # -- lifecycle -----------------------------------------------------
    def warmup(self):
        """Run one forward per (replica, bucket) before traffic, a bucket
        being a ``(batch, seq)`` pair under seq bucketing. Returns
        {replica: {bucket: warmed kinds}}."""
        done = {rep.rid: {} for rep in self._pool.replicas}
        with _tm.span("serving.warmup"):
            for rep in self._pool.replicas:
                for b, pred in rep.predictors.items():
                    done[rep.rid][b] = pred.compile(("forward",))
        self._warm = True
        _tm.counter("serving.warmup_buckets").inc(
            sum(len(v) for v in done.values()))
        self.logger.info(
            "serving: warmed %d replica(s) x buckets %s",
            len(self._pool.replicas), list(self.config.buckets))
        return done

    def start(self):
        """Begin accepting traffic (warmup first if not already warm)."""
        if self._closed:
            raise ServerClosed("server already closed")
        if not self._warm:
            self.warmup()
        self._batcher.start()
        return self

    def close(self, drain=True, timeout=30.0):
        """Stop accepting requests; ``drain=True`` completes everything
        already queued before returning (graceful shutdown)."""
        if self._closed:
            return
        self._closed = True
        self._batcher.stop(drain=drain, timeout=timeout)
        self._pool.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    def reload(self, source=None):
        """Hot reload is not yet ported."""
        raise _not_ported("ModelServer.reload (hot reload)")

    # -- request path --------------------------------------------------
    def _coerce(self, inputs):
        """Validate one request's inputs against the per-sample contract
        and coerce to the BOUND dtypes. Returns ``(coerced, group)`` —
        with seq bucketing on, the variable seq axis is zero-padded up to
        its seq-len bucket and ``group`` is that bucket (the batcher's
        second bucketing axis); otherwise ``group`` is None."""
        if not isinstance(inputs, dict):
            if len(self._input_names) != 1:
                raise MXNetError(
                    f"model has inputs {self._input_names}; pass a dict")
            inputs = {self._input_names[0]: inputs}
        seq_buckets = self.config.seq_buckets
        axis = self.config.seq_axis
        group = seq_len = None
        out = {}
        for name, shape in self._sample_shapes.items():
            if name not in inputs:
                raise MXNetError(f"missing input {name!r}")
            arr = np.asarray(inputs[name])
            if seq_buckets:
                if arr.ndim != len(shape):
                    raise MXNetError(
                        f"input {name!r}: rank {len(shape)} expected, "
                        f"got {arr.ndim}")
                if seq_len is None:
                    # the FIRST input fixes the request's seq length;
                    # every other input must agree (one shared bucket)
                    seq_len = int(arr.shape[axis])
                    if not 1 <= seq_len <= seq_buckets[-1]:
                        raise MXNetError(
                            f"input {name!r}: seq length {seq_len} not "
                            f"served (seq buckets {list(seq_buckets)})")
                    group = next(s for s in seq_buckets if s >= seq_len)
                expect = self._seq_shape(shape, seq_len)
                if tuple(arr.shape) != expect:
                    raise MXNetError(
                        f"input {name!r}: per-sample shape {expect} "
                        f"expected, got {tuple(arr.shape)}")
                if seq_len < group:
                    pad = [(0, 0)] * arr.ndim
                    pad[axis] = (0, group - seq_len)
                    arr = np.pad(arr, pad)
            elif tuple(arr.shape) != shape:
                raise MXNetError(
                    f"input {name!r}: per-sample shape {shape} expected, "
                    f"got {tuple(arr.shape)}")
            out[name] = np.ascontiguousarray(
                arr, dtype=self._input_dtypes[name])
        unknown = set(inputs) - set(self._sample_shapes)
        if unknown:
            raise MXNetError(f"unknown inputs {sorted(unknown)}")
        return out, group

    def submit(self, inputs, deadline_ms=None):
        """Admit one request; returns a ``Future`` resolving to the list
        of output arrays (one per model output, per-sample shape; with
        seq bucketing the seq axis comes back padded to its bucket).
        Sheds with ``ServerOverloaded`` when the (capacity-scaled) queue
        is full, ``NoHealthyReplicas`` when the whole pool is down."""
        if self._closed:
            raise ServerClosed("server closed")
        coerced, group = self._coerce(inputs)
        if deadline_ms is None and self.config.deadline > 0:
            deadline_ms = self.config.deadline * 1e3
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms else None)
        return self._batcher.submit(coerced, deadline=deadline,
                                    group=group)

    def predict(self, inputs, timeout=None, deadline_ms=None):
        """Synchronous :meth:`submit` — blocks for the outputs."""
        return self.submit(inputs, deadline_ms=deadline_ms).result(timeout)

    def _infer(self, bucket, stacked, n_valid):
        """Batcher runner: route the batch through the replica pool."""
        return self._pool.run_batch(
            bucket, stacked, n_valid,
            deadline=self._batcher.batch_deadline())

    # -- introspection -------------------------------------------------
    def stats(self):
        """Health/readiness payload. ``status``: ``ok`` (all replicas
        healthy) / ``degraded`` (some) / ``unavailable`` (none) /
        ``warming`` / ``draining``."""
        reps = self._pool.stats()
        healthy = sum(1 for r in reps if r["state"] == "closed")
        if self._closed:
            status = "draining"
        elif not self._batcher.running:
            status = "warming"
        elif healthy == 0:
            status = "unavailable"
        elif healthy < len(reps):
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            "degraded": 0 < healthy < len(reps),
            "healthy_replicas": healthy,
            "replicas": reps,
            "buckets": list(self.config.buckets),
            "queue_depth": len(self._batcher._queue),
            "queue_limit": self.config.queue_depth,
            "max_delay_ms": self.config.max_delay * 1e3,
            "version": self.version,
            "latency": self.latency.snapshot(),
            "inputs": {n: list(s) for n, s in self._sample_shapes.items()},
            "variant": self.variant,
        }
