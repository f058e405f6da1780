"""Replicated serving: N model replicas with health-gated failover.

A copy of ``mxnet_tpu/serving/replica.py`` for one-device replicas. One
:class:`Replica` per CUDA device holds its own per-bucket predictors over
device-resident weights;
the :class:`ReplicaPool` routes each assembled batch to the least-loaded
*healthy* replica. Health is a per-replica circuit breaker in the classic
three states:

- **CLOSED** (healthy): serving traffic. Consecutive errors — or, with
  ``MXNET_SERVING_CB_SLOW_MS``, consecutive slow calls — reaching
  ``MXNET_SERVING_CB_ERRORS`` trip it OPEN.
- **OPEN**: no traffic. After an exponentially-growing backoff
  (``MXNET_SERVING_CB_PROBE_MS`` doubling per failed probe, capped) the
  breaker becomes probe-eligible: exactly ONE live request is routed
  through as a half-open probe. Probe success closes the breaker; probe
  failure re-opens with doubled backoff.
- **EJECTED**: administratively out; time-based probing must NOT
  re-admit it. Only :meth:`ReplicaPool.heal` does.

A batch that fails on one replica is transparently **re-dispatched** to
another healthy replica (bounded by ``MXNET_SERVING_MAX_RETRIES`` and the
batch's deadline budget; serving-typed admission errors are never
retried — only execution faults, which are idempotent pure forwards).
``MXNET_SERVING_REPLICA_TIMEOUT_MS`` arms a per-batch watchdog: a hung
device call marks the replica suspect (breaker OPEN, counted in
``serving.replica.timeout``) and the batch fails over instead of freezing
the dispatch worker. ``MXNET_SERVING_HEDGE_MS`` arms tail-latency
hedging: a batch still unanswered after the hedge delay is duplicated to
a second healthy replica, first result wins, the loser is
cancelled/discarded.

Every transition is observable: ``serving.replica.healthy`` (gauge),
``serving.replica.{open,failover,hedge,timeout,probe,recovered,ejected}``
(counters).
"""

from __future__ import annotations

import concurrent.futures as _cf
import logging
import threading
import time

from .. import telemetry as _tm
from .errors import NoHealthyReplicas, ReplicaTimeout, ServingError

__all__ = ["Replica", "ReplicaPool"]

_LOG = logging.getLogger("mxnet_tpu_torch.serving")

# breaker states
CLOSED, OPEN, EJECTED = "closed", "open", "ejected"

# half-open backoff never grows past this (seconds): a dead replica is
# probed at least this often so recovery is never more than one cap away
_PROBE_BACKOFF_CAP = 10.0


class Replica:
    """One model replica: per-bucket predictors bound to one device, a
    lock serializing its forwards, and a single-thread executor so a hung
    device call can be timed out (and later probes queue behind it — a
    wedged replica stays observably wedged instead of stacking threads
    onto a dead device)."""

    __slots__ = ("rid", "ctx", "predictors", "lock", "version", "state",
                 "consec", "backoff", "open_at", "probing", "in_flight",
                 "batches", "failures", "last_error", "_exec", "_seq")

    def __init__(self, rid, ctx, predictors):
        self.rid = int(rid)
        self.ctx = ctx
        self.predictors = dict(predictors)
        # serializes this replica's forwards; the version it reads under
        # the lock is the weight version the batch actually used
        self.lock = threading.RLock()
        self.version = 0
        self.state = CLOSED
        self.consec = 0          # consecutive errors/slow calls
        self.backoff = 0.0       # current half-open backoff (seconds)
        self.open_at = 0.0       # monotonic time the breaker opened
        self.probing = False     # a half-open probe is in flight
        self.in_flight = 0
        self.batches = 0         # batches served (per-replica throughput)
        self.failures = 0
        self.last_error = None
        self._seq = 0            # last-routed tiebreak for least-loaded
        self._exec = _cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"serving-replica-{rid}")

    def submit(self, bucket, stacked, n_valid):
        return self._exec.submit(self._call, bucket, stacked, n_valid)

    def _call(self, bucket, stacked, n_valid):
        with self.lock:
            outs = self.predictors[bucket].run(**stacked)
            return outs, self.version

    def device(self):
        try:
            return str(self.ctx.torch_device())
        except Exception:  # noqa: BLE001 — stats must never raise
            return repr(self.ctx)

    def close_pool(self):
        # wait=False: a wedged device thread must not hang shutdown
        self._exec.shutdown(wait=False)


class ReplicaPool:
    """Routes batches across replicas with health gating, failover
    re-dispatch, watchdog timeouts and optional hedging.

    Parameters
    ----------
    replicas : sequence of Replica
    timeout : float
        Per-attempt watchdog seconds (0 = no watchdog).
    max_retries : int
        Failover re-dispatches after the first failed attempt.
    hedge : float
        Seconds before duplicating a slow batch to a second replica
        (0 = no hedging).
    cb_errors : int
        Consecutive errors (or slow calls) that trip a breaker OPEN.
    cb_probe : float
        Initial half-open backoff seconds (doubles per failed probe).
    cb_slow : float
        Successful calls slower than this (seconds) count toward the
        breaker like errors (0 = only real errors count).
    """

    def __init__(self, replicas, timeout=0.0, max_retries=2, hedge=0.0,
                 cb_errors=3, cb_probe=0.1, cb_slow=0.0, logger=None):
        self.replicas = list(replicas)
        self.timeout = max(0.0, float(timeout))
        self.max_retries = max(0, int(max_retries))
        self.hedge = max(0.0, float(hedge))
        self.cb_errors = max(1, int(cb_errors))
        self.cb_probe = max(1e-3, float(cb_probe))
        self.cb_slow = max(0.0, float(cb_slow))
        self.logger = logger or _LOG
        self._lock = threading.Lock()
        self._route_seq = 0
        self._update_healthy_gauge()

    # -- health accounting (all under self._lock) ----------------------
    def _update_healthy_gauge(self):
        _tm.gauge("serving.replica.healthy").set(
            sum(1 for r in self.replicas if r.state == CLOSED))

    def healthy_count(self):
        with self._lock:
            return sum(1 for r in self.replicas if r.state == CLOSED)

    def _allowed(self, rep, now, probes=True):
        if rep.state == CLOSED:
            return True
        if rep.state == OPEN and probes and not rep.probing:
            return now >= rep.open_at + rep.backoff
        return False

    def capacity_fraction(self):
        """Healthy share of the pool (probe-eligible OPEN replicas count:
        they are the only way traffic can heal an all-down pool). The
        batcher scales its admission bound by this, shedding
        proportionally as capacity drops; 0.0 means admission should
        fast-fail with :class:`NoHealthyReplicas`."""
        now = time.monotonic()
        with self._lock:
            if not self.replicas:
                return 0.0
            n = sum(1 for r in self.replicas if self._allowed(r, now))
            return n / len(self.replicas)

    def _pick(self, exclude, for_hedge=False):
        """Least-loaded healthy replica not in ``exclude``; claims and
        returns a half-open probe when one is due (never for hedges —
        a hedge exists to cut latency, a probe to take a risk)."""
        now = time.monotonic()
        with self._lock:
            if not for_hedge:
                for rep in self.replicas:
                    if rep.rid in exclude or rep.state != OPEN:
                        continue
                    if rep.probing or now < rep.open_at + rep.backoff:
                        continue
                    rep.probing = True
                    _tm.counter("serving.replica.probe").inc()
                    return rep, True
            ranked = sorted(
                (r for r in self.replicas
                 if r.state == CLOSED and r.rid not in exclude),
                key=lambda r: (r.in_flight, r._seq))
            if not ranked:
                return None, False
            rep = ranked[0]
            self._route_seq += 1
            rep._seq = self._route_seq
            return rep, False

    def _open(self, rep, reason):
        # caller holds self._lock
        if rep.state == OPEN:
            rep.backoff = min(rep.backoff * 2, _PROBE_BACKOFF_CAP)
        else:
            rep.state = OPEN
            rep.backoff = self.cb_probe
            _tm.counter("serving.replica.open").inc()
        rep.open_at = time.monotonic()
        rep.probing = False
        rep.consec = 0
        self._update_healthy_gauge()
        self.logger.warning(
            "serving: replica %d OPEN (%s); next probe in %.0f ms",
            rep.rid, reason, rep.backoff * 1e3)

    def _on_success(self, rep, probe, duration):
        with self._lock:
            rep.batches += 1
            if probe or rep.state == OPEN:
                rep.state = CLOSED
                rep.probing = False
                rep.consec = 0
                rep.backoff = 0.0
                _tm.counter("serving.replica.recovered").inc()
                self._update_healthy_gauge()
                self.logger.info(
                    "serving: replica %d recovered (probe served)", rep.rid)
            elif self.cb_slow > 0 and duration > self.cb_slow:
                rep.consec += 1
                if rep.consec >= self.cb_errors:
                    self._open(rep, f"{rep.consec} consecutive slow calls "
                                    f"(> {self.cb_slow * 1e3:.0f} ms)")
            else:
                rep.consec = 0

    def _on_failure(self, rep, probe, exc):
        with self._lock:
            rep.failures += 1
            rep.last_error = repr(exc)
            if probe or rep.state == OPEN:
                self._open(rep, f"probe failed: {exc!r}")
            else:
                rep.consec += 1
                if rep.consec >= self.cb_errors:
                    self._open(rep, f"{rep.consec} consecutive errors; "
                                    f"last: {exc!r}")

    def _on_timeout(self, rep, probe):
        # a hung device call is immediately suspect — no error budget:
        # the wedged thread still holds the replica's executor, so more
        # traffic would only stack up behind it
        _tm.counter("serving.replica.timeout").inc()
        with self._lock:
            rep.failures += 1
            rep.last_error = f"watchdog timeout ({self.timeout * 1e3:.0f} ms)"
            self._open(rep, rep.last_error)

    def eject(self, rep, reason):
        """Administratively remove a replica: not probe-eligible; only
        :meth:`heal` re-admits it."""
        with self._lock:
            rep.state = EJECTED
            rep.probing = False
            rep.consec = 0
            rep.last_error = reason
            _tm.counter("serving.replica.ejected").inc()
            self._update_healthy_gauge()
        self.logger.error("serving: replica %d EJECTED (%s)", rep.rid, reason)

    def heal(self, rep):
        """Re-admit a replica. An error-opened breaker is also closed; if
        the fault persists the breaker simply re-opens after
        ``cb_errors`` strikes."""
        with self._lock:
            if rep.state != CLOSED:
                rep.state = CLOSED
                rep.probing = False
                rep.consec = 0
                rep.backoff = 0.0
                _tm.counter("serving.replica.recovered").inc()
                self._update_healthy_gauge()

    # -- dispatch ------------------------------------------------------
    def run_batch(self, bucket, stacked, n_valid, deadline=None):
        """One batch through the pool: least-loaded healthy routing,
        watchdog, hedging, failover. Returns ``(outputs, note)`` where
        ``note`` carries the weight ``version`` the serving replica
        computed against and its ``replica`` id. Raises
        :class:`NoHealthyReplicas` when no replica may be tried, the
        last execution error when retries/deadline are exhausted."""
        tried = set()
        attempts = 0
        last_exc = None
        while True:
            rep, probe = self._pick(tried)
            if rep is None:
                if last_exc is not None:
                    raise last_exc
                raise NoHealthyReplicas(
                    "no healthy replica available "
                    f"({len(self.replicas)} configured); retry later")
            try:
                outs, ver = self._execute(rep, probe, bucket, stacked,
                                          n_valid, tried)
                return outs, {"version": ver, "replica": rep.rid}
            except ServingError as e:
                if not isinstance(e, ReplicaTimeout):
                    raise  # admission-typed: never retried
                last_exc = e
            except BaseException as e:  # noqa: BLE001 — failover fodder
                last_exc = e
            tried.add(rep.rid)
            attempts += 1
            if attempts > self.max_retries:
                raise last_exc
            if deadline is not None and time.monotonic() >= deadline:
                raise last_exc
            _tm.counter("serving.replica.failover").inc()
            self.logger.warning(
                "serving: batch failed on replica %d (%r); re-dispatching "
                "(attempt %d/%d)", rep.rid, last_exc, attempts + 1,
                self.max_retries + 1)

    def _submit(self, rep, bucket, stacked, n_valid):
        with self._lock:
            rep.in_flight += 1
        try:
            fut = rep.submit(bucket, stacked, n_valid)
        except BaseException:
            with self._lock:
                rep.in_flight -= 1
            raise

        def _done(_f, _rep=rep):
            with self._lock:
                _rep.in_flight -= 1

        fut.add_done_callback(_done)
        return fut

    def _execute(self, primary, probe, bucket, stacked, n_valid, tried):
        """One routed attempt (plus its hedge). Success on either the
        primary or the hedge is success; the loser is cancelled if still
        queued, discarded otherwise."""
        start = time.monotonic()
        # the watchdog alone bounds a RUNNING attempt; the request
        # deadline governs queueing (batcher) and whether a failed batch
        # may be re-dispatched (run_batch) — abandoning an almost-done
        # forward at the deadline would waste the work a client may
        # still collect
        timeout_at = start + self.timeout if self.timeout > 0 else None
        # probes accept latency; hedging one would double-claim risk
        hedge_at = (start + self.hedge
                    if self.hedge > 0 and not probe else None)
        try:
            futs = {self._submit(primary, bucket, stacked, n_valid):
                    (primary, probe)}
        except BaseException:
            if probe:  # release the claimed probe token — a leak would
                with self._lock:  # leave the replica un-probeable forever
                    primary.probing = False
            raise
        hedged = False
        last_exc = None
        while futs:
            marks = [t for t in (timeout_at,
                                 None if hedged else hedge_at)
                     if t is not None]
            budget = (max(0.0, min(marks) - time.monotonic())
                      if marks else None)
            done, _ = _cf.wait(set(futs), timeout=budget,
                               return_when=_cf.FIRST_COMPLETED)
            if done:
                for f in done:
                    rep, was_probe = futs.pop(f)
                    exc = f.exception()
                    if exc is None:
                        outs, ver = f.result()
                        self._on_success(rep, was_probe,
                                         time.monotonic() - start)
                        for loser in futs:
                            loser.cancel()  # still queued → never runs
                        if hedged and rep is not primary:
                            _tm.counter("serving.replica.hedge_win").inc()
                        return outs, ver
                    last_exc = exc
                    self._on_failure(rep, was_probe, exc)
                if not futs:
                    raise last_exc
                continue
            now = time.monotonic()
            if (not hedged and hedge_at is not None and now >= hedge_at
                    and (timeout_at is None or now < timeout_at)):
                hedged = True
                exclude = tried | {r.rid for r, _ in futs.values()}
                second, _ = self._pick(exclude, for_hedge=True)
                if second is None:
                    hedge_at = None
                    continue
                _tm.counter("serving.replica.hedge").inc()
                futs[self._submit(second, bucket, stacked, n_valid)] = \
                    (second, False)
                continue
            if timeout_at is not None and now >= timeout_at:
                for rep, was_probe in futs.values():
                    self._on_timeout(rep, was_probe)
                raise ReplicaTimeout(
                    f"batch (bucket {bucket}) timed out after "
                    f"{(now - start) * 1e3:.0f} ms on replica(s) "
                    f"{sorted(r.rid for r, _ in futs.values())}")

    # -- introspection / lifecycle -------------------------------------
    def stats(self):
        with self._lock:
            return [{
                "id": r.rid,
                "device": r.device(),
                "state": r.state,
                "in_flight": r.in_flight,
                "batches": r.batches,
                "failures": r.failures,
                "version": r.version,
                "last_error": r.last_error,
            } for r in self.replicas]

    def close(self):
        for rep in self.replicas:
            rep.close_pool()
