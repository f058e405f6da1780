"""Dynamic request batching: coalesce concurrent requests into bucketed
padded batches.

Clipper/TF-Serving-style adaptive batching in front of pre-compiled
executables: requests queue; a single worker thread coalesces whatever has
arrived — waiting at most ``max_delay`` after the oldest queued request —
pads the group up to the smallest configured bucket batch size, runs ONE
inference, and scatters the output rows back to per-request futures. The
bucket set is closed, so a warmed server never sees a new program shape on
the request path.

Admission is bounded: when ``queue_depth`` requests are already waiting,
``submit`` rejects fast with :class:`ServerOverloaded` instead of letting
the queue (and every queued request's latency) grow without bound —
shedding at admission is the only load response that keeps p99 finite.
With a ``capacity_fn`` (the replica pool's healthy fraction), the bound
additionally scales with healthy capacity: a half-dead pool sheds at half
the depth rather than letting the queue deadline-expire, and zero healthy
capacity fails fast with :class:`NoHealthyReplicas`.

The batcher is model-agnostic: ``runner(bucket, stacked, n_valid)``
receives each input stacked batch-major and zero-padded to ``bucket`` rows
and returns the output arrays batch-major (or ``(outputs, note_dict)`` —
the note's entries are stamped onto every future of the batch, which is
how the replica pool reports the weight version and replica that actually
served it); only rows ``< n_valid`` are scattered. ``ModelServer``
supplies a runner that drives the replica pool.

With ``dispatch_concurrency > 1`` (a multi-replica pool) the worker does
NOT execute batches inline: it hands each assembled batch to a bounded
dispatch pool and immediately coalesces the next one, so independent
replicas run batches concurrently — replicated serving throughput scales
with the pool instead of serializing behind one worker.

The worker is supervised: an unhandled exception outside the per-batch
guard fails all pending futures with :class:`WorkerCrashed` (typed — a
stranded future would block its client forever), increments
``serving.worker_crash``, and restarts the loop.

Telemetry: ``serving.request`` / ``serving.shed`` / ``serving.no_capacity``
/ ``serving.deadline_expired`` / ``serving.batches`` /
``serving.worker_crash`` counters, the ``serving.batch_size`` /
``serving.pad_waste`` / ``serving.queue_wait`` histograms (queue_wait in
µs), the ``serving.infer`` span and the ``serving.queue_depth`` gauge.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor

import numpy as np

from .. import telemetry as _tm
from .errors import (DeadlineExceeded, NoHealthyReplicas, ServerClosed,
                     ServerOverloaded, WorkerCrashed)

__all__ = ["DynamicBatcher"]

_LOG = logging.getLogger("mxnet_tpu_torch.serving")


class _Request:
    __slots__ = ("inputs", "future", "t_enqueue", "deadline", "group")

    def __init__(self, inputs, deadline, group=None):
        self.inputs = inputs
        self.future = Future()
        self.t_enqueue = time.monotonic()
        self.deadline = deadline  # absolute monotonic seconds, or None
        # second bucketing axis (seq-len bucket): only requests sharing a
        # group coalesce into one batch; None = ungrouped (plain int
        # bucket keys, the historical contract)
        self.group = group


def _fail(future, exc):
    """set_exception tolerating client-side cancel() and cross-thread
    races: an unguarded set on a CANCELLED (or, with supervised restart
    racing a dispatch thread, already-resolved) future raises
    InvalidStateError and would kill the batcher worker — bricking the
    server."""
    try:
        if future.set_running_or_notify_cancel():
            future.set_exception(exc)
    except InvalidStateError:
        pass  # the other resolver won; the client has an answer


def _resolve(future, result):
    """set_result with the same cancel/race tolerance as :func:`_fail`."""
    try:
        if future.set_running_or_notify_cancel():
            future.set_result(result)
    except InvalidStateError:
        pass


class DynamicBatcher:
    """Coalesces submitted requests into padded bucket-sized batches.

    Parameters
    ----------
    runner : callable
        ``runner(bucket, stacked, n_valid) -> sequence of np.ndarray``
        or ``-> (sequence, note_dict)``. ``stacked`` maps input name ->
        ``(bucket, *sample_shape)`` array (rows ``>= n_valid`` are zero
        padding); outputs are batch-major. A returned note dict is set as
        attributes on every future of the batch. The batch's deadline
        (min over its requests, or None) is visible to the runner as
        ``batcher.batch_deadline()`` from the executing thread.
    buckets : sequence of int
        Allowed batch sizes, e.g. ``(1, 4, 16, 64)``. A group of ``n``
        requests runs at the smallest bucket ``>= n``; the largest bucket
        caps how many requests one batch takes.
    max_delay : float
        Seconds the worker waits for more requests after the oldest queued
        one before dispatching a partial bucket (the batching deadline).
    queue_depth : int
        Admission bound: ``submit`` sheds when this many requests wait.
    latency_observer : callable or None
        Called with the request's total latency in µs when its future
        resolves successfully (feeds the server's p50/p99 histogram).
    capacity_fn : callable or None
        Returns the healthy capacity fraction in [0, 1]. Admission scales
        ``queue_depth`` by it (graceful degradation) and fails fast with
        :class:`NoHealthyReplicas` at 0.
    dispatch_concurrency : int
        Batches allowed in flight at once (= replica count). 1 keeps the
        historical inline execution under ``run_lock``.
    """

    def __init__(self, runner, buckets, max_delay=0.002, queue_depth=256,
                 latency_observer=None, capacity_fn=None,
                 dispatch_concurrency=1):
        buckets = sorted(set(int(b) for b in buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"invalid bucket set {buckets!r}")
        self._runner = runner
        self.buckets = tuple(buckets)
        self.max_delay = float(max_delay)
        self.queue_depth = int(queue_depth)
        self._latency_observer = latency_observer
        self._capacity_fn = capacity_fn
        self._dispatch_n = max(1, int(dispatch_concurrency))
        self._dispatch_pool = None
        self._dispatch_sem = threading.Semaphore(self._dispatch_n)
        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._stopping = False
        self._worker = None
        self._current = None  # batch in the worker's hands (supervision)
        self._tl = threading.local()
        # serializes inference against weight swaps in SINGLE-replica
        # (inline) mode: ModelServer.reload historically acquired this so
        # a swap lands BETWEEN batches. With a replica pool, per-replica
        # locks carry that contract instead (batches on other replicas
        # must keep flowing during a one-replica swap)
        self.run_lock = threading.Lock()
        # optional legacy hook: called under run_lock right after an
        # inline runner returns; its dict is set as attributes on every
        # future of the batch. Runners that return (outs, note) — the
        # replica pool — supersede it
        self.annotate = None

    # -- lifecycle -----------------------------------------------------
    def start(self):
        if self._worker is not None:
            return
        if self._dispatch_n > 1 and self._dispatch_pool is None:
            self._dispatch_pool = ThreadPoolExecutor(
                max_workers=self._dispatch_n,
                thread_name_prefix="serving-dispatch")
        self._worker = threading.Thread(
            target=self._run_supervised, name="serving-batcher", daemon=True)
        self._worker.start()

    @property
    def running(self):
        return self._worker is not None and not self._stopping

    def stop(self, drain=True, timeout=30.0):
        """Stop accepting work. ``drain=True`` serves everything already
        queued first; ``drain=False`` fails queued requests with
        :class:`ServerClosed`. Joins the worker and waits for in-flight
        dispatched batches to resolve their futures."""
        with self._cond:
            self._stopping = True
            if not drain:
                while self._queue:
                    req = self._queue.popleft()
                    _fail(req.future, ServerClosed(
                        "server closed before this request ran"))
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)
            self._worker = None
        if self._dispatch_pool is not None:
            # bounded drain: every in-flight dispatched batch holds one
            # semaphore permit, so acquiring all permits == all batches
            # resolved. Bounded by the caller's timeout — a wedged
            # replica (no watchdog armed) must not hang close() forever
            deadline = time.monotonic() + max(0.0, timeout)
            got = 0
            for _ in range(self._dispatch_n):
                remaining = deadline - time.monotonic()
                if remaining > 0 and self._dispatch_sem.acquire(
                        timeout=remaining):
                    got += 1
                else:
                    break
            for _ in range(got):
                self._dispatch_sem.release()
            if got < self._dispatch_n:
                _LOG.warning(
                    "serving: %d batch(es) still in flight after the "
                    "%.0f s drain timeout; abandoning them",
                    self._dispatch_n - got, timeout)
            self._dispatch_pool.shutdown(wait=got == self._dispatch_n)
            self._dispatch_pool = None

    # -- admission -----------------------------------------------------
    def submit(self, inputs, deadline=None, group=None):
        """Enqueue one request; returns its ``concurrent.futures.Future``.

        ``inputs``: dict name -> per-sample numpy array (already validated
        and dtype-coerced by the caller). ``deadline``: absolute
        ``time.monotonic()`` seconds after which the request is dropped
        unserved, or None. ``group``: second bucketing axis (the seq-len
        bucket) — only same-group requests coalesce, and the runner is
        keyed ``(bucket, group)`` instead of the plain int bucket. Raises
        :class:`ServerClosed` / :class:`NoHealthyReplicas` /
        :class:`ServerOverloaded` without queueing.
        """
        req = _Request(inputs, deadline, group)
        depth_limit = self.queue_depth
        if self._capacity_fn is not None:
            frac = self._capacity_fn()
            if frac <= 0.0:
                _tm.counter("serving.no_capacity").inc()
                raise NoHealthyReplicas(
                    "no healthy replica available; request rejected at "
                    "admission — retry after the next health probe")
            # shed proportionally as capacity drops: a half-healthy pool
            # at full queue depth would only convert the lost capacity
            # into deadline expiries further down the queue
            depth_limit = max(1, int(self.queue_depth * frac))
        with self._cond:
            if self._stopping or self._worker is None:
                raise ServerClosed("server is not accepting requests")
            if len(self._queue) >= depth_limit:
                _tm.counter("serving.shed").inc()
                raise ServerOverloaded(
                    f"admission queue full ({depth_limit} waiting, "
                    f"{self.queue_depth} configured); request shed")
            self._queue.append(req)
            depth = len(self._queue)
            self._cond.notify()
        _tm.counter("serving.request").inc()
        _tm.gauge("serving.queue_depth").set(depth)
        return req.future

    def batch_deadline(self):
        """The executing batch's deadline (min over its requests' absolute
        monotonic deadlines, or None) — valid from the thread running the
        runner; the replica pool reads it to bound failover re-dispatch
        within the batch's remaining budget."""
        return getattr(self._tl, "deadline", None)

    # -- worker --------------------------------------------------------
    def _take(self):
        """Block for the next group of requests (None = stopped + drained).

        Coalescing rule: once the queue is non-empty, wait until either
        the largest bucket fills or ``max_delay`` has elapsed since the
        OLDEST queued request — so no request's batching wait exceeds
        max_delay. While draining, dispatch immediately."""
        with self._cond:
            while not self._queue and not self._stopping:
                self._cond.wait()
            if not self._queue:
                return None
            max_b = self.buckets[-1]
            if not self._stopping:
                while len(self._queue) < max_b and not self._stopping:
                    # the coalescing wait must never outlive a queued
                    # request's deadline: a lone request whose deadline is
                    # shorter than max_delay dispatches (slightly early)
                    # instead of expiring on an idle server. Recomputed
                    # each wake — new arrivals can carry earlier deadlines
                    dispatch_at = self._queue[0].t_enqueue + self.max_delay
                    for r in self._queue:
                        if r.deadline is not None:
                            dispatch_at = min(dispatch_at,
                                              r.deadline - 1e-3)
                    remaining = dispatch_at - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            # only the head request's group coalesces (same compiled
            # seq-len shape); other groups stay queued, order preserved,
            # for the next iteration
            head_group = self._queue[0].group
            reqs, skipped = [], collections.deque()
            while self._queue and len(reqs) < max_b:
                r = self._queue.popleft()
                if r.group == head_group:
                    reqs.append(r)
                else:
                    skipped.append(r)
            self._queue.extendleft(reversed(skipped))
            _tm.gauge("serving.queue_depth").set(len(self._queue))
        return reqs

    def _run_supervised(self):
        """Satellite contract: the lone worker thread must survive ANY
        unhandled exception — fail what it held (typed), count it, and
        restart the loop. A dead worker strands every queued future and
        every future ever submitted after it, forever."""
        while True:
            try:
                self._run()
                return  # clean stop
            except BaseException as e:  # noqa: BLE001 — supervision
                _tm.counter("serving.worker_crash").inc()
                _LOG.exception(
                    "serving: batcher worker crashed; failing pending "
                    "requests and restarting")
                crashed = WorkerCrashed(
                    f"batcher worker crashed: {type(e).__name__}: {e}")
                reqs, self._current = self._current, None
                for r in reqs or []:
                    if not r.future.done():
                        _fail(r.future, crashed)
                with self._cond:
                    while self._queue:
                        _fail(self._queue.popleft().future, crashed)
                    if self._stopping:
                        return

    def _run(self):
        while True:
            reqs = self._take()
            if reqs is None:
                return
            self._current = reqs
            now = time.monotonic()
            live = []
            for r in reqs:
                _tm.histogram("serving.queue_wait").observe(
                    (now - r.t_enqueue) * 1e6)
                if r.deadline is not None and now > r.deadline:
                    _tm.counter("serving.deadline_expired").inc()
                    _fail(r.future, DeadlineExceeded(
                        "deadline expired after "
                        f"{(now - r.t_enqueue) * 1e3:.1f} ms in queue"))
                else:
                    live.append(r)
            if live:
                self._run_batch(live)
            self._current = None

    def _pick_bucket(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]  # _take caps n at the largest bucket

    def _run_batch(self, reqs):
        n = len(reqs)
        bsize = self._pick_bucket(n)
        if reqs[0].group is not None:
            # composite program key: (batch bucket, seq-len bucket) — the
            # runner's predictor tables are keyed the same way. Ungrouped
            # requests keep the plain int key (historical contract relied
            # on by tests that patch bare runners).
            bucket = (bsize, reqs[0].group)
        else:
            bucket = bsize
        try:
            stacked = {}
            for name, sample in reqs[0].inputs.items():
                rows = [r.inputs[name] for r in reqs]
                batch = np.stack(rows)
                if n < bsize:
                    pad = np.zeros((bsize - n,) + sample.shape,
                                   dtype=sample.dtype)
                    batch = np.concatenate([batch, pad])
                stacked[name] = batch
        except BaseException as e:  # noqa: BLE001 — fanned out per request
            for r in reqs:
                _fail(r.future, e)
            return
        deadlines = [r.deadline for r in reqs if r.deadline is not None]
        deadline = min(deadlines) if deadlines else None
        if self._dispatch_pool is not None:
            # replicated mode: hand the batch to the dispatch pool and
            # immediately coalesce the next one — batches run on
            # independent replicas concurrently. The semaphore bounds
            # batches in flight at the replica count so a slow pool
            # backpressures into the admission queue (where shedding and
            # deadlines own the response) instead of an unbounded pile of
            # dispatched-but-unserved batches
            self._dispatch_sem.acquire()
            try:
                fut = self._dispatch_pool.submit(
                    self._dispatch_task, reqs, bucket, stacked, n, deadline)
            except BaseException as e:  # pool shut down under us
                self._dispatch_sem.release()
                for r in reqs:
                    _fail(r.future, e)
                return
            fut.add_done_callback(
                lambda _f: self._dispatch_sem.release())
        else:
            self._execute_and_scatter(reqs, bucket, stacked, n, deadline)

    def _dispatch_task(self, reqs, bucket, stacked, n, deadline):
        """Async-dispatch wrapper: the dispatch thread is its own
        supervisor — any escape here must resolve the batch's futures,
        never strand them."""
        try:
            self._execute_and_scatter(reqs, bucket, stacked, n, deadline)
        except BaseException as e:  # noqa: BLE001 — last-resort fan-out
            _tm.counter("serving.worker_crash").inc()
            _LOG.exception("serving: batch dispatch crashed")
            crashed = WorkerCrashed(
                f"batch dispatch crashed: {type(e).__name__}: {e}")
            for r in reqs:
                if not r.future.done():
                    _fail(r.future, crashed)

    def _execute_and_scatter(self, reqs, bucket, stacked, n, deadline):
        self._tl.deadline = deadline
        try:
            if self._dispatch_pool is None:
                with self.run_lock:
                    with _tm.span("serving.infer", bucket=bucket, valid=n):
                        res = self._runner(bucket, stacked, n)
                    note = self._note_for(res)
            else:
                with _tm.span("serving.infer", bucket=bucket, valid=n):
                    res = self._runner(bucket, stacked, n)
                note = self._note_for(res)
        except BaseException as e:  # noqa: BLE001 — fanned out per request
            for r in reqs:
                _fail(r.future, e)
            return
        finally:
            self._tl.deadline = None
        outs = res[0] if self._is_noted(res) else res
        bsize = bucket[0] if isinstance(bucket, tuple) else bucket
        _tm.counter("serving.batches").inc()
        _tm.histogram("serving.batch_size").observe(n)
        _tm.histogram("serving.pad_waste").observe(bsize - n)
        done = time.monotonic()
        for i, r in enumerate(reqs):
            lat_us = (done - r.t_enqueue) * 1e6
            _tm.histogram("serving.latency").observe(lat_us)
            if self._latency_observer is not None:
                self._latency_observer(lat_us)
            # which program shape served this request: responses are
            # bitwise-deterministic PER BUCKET (XLA codegen is
            # shape-specialized), so reproducibility audits need the
            # bucket next to the result
            r.future.bucket = bucket
            if note:
                for k, v in note.items():
                    setattr(r.future, k, v)
            # copy the rows out: a view would pin the whole padded
            # bucket-sized output batch for as long as the client keeps
            # the response
            _resolve(r.future, [np.array(o[i]) for o in outs])

    @staticmethod
    def _is_noted(res):
        return (isinstance(res, tuple) and len(res) == 2
                and isinstance(res[1], dict))

    def _note_for(self, res):
        if self._is_noted(res):
            return res[1]
        return self.annotate() if self.annotate else None
