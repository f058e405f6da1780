"""The training-window scheduler of ``Module.fit``.

Counterpart of the third piece of ``mxnet_tpu/aot.py`` (the adaptive
train-window scheduler, :class:`TrainWindowScheduler`):
``MXNET_TRAIN_WINDOW`` sets how many steps ``fit`` hands to one
``Module.train_window`` call, a fixed K or ``auto``, which probes a few
single-step batches and picks K from the measured ``fit.*`` phase spans
(:func:`choose_train_window`). The same profile co-tunes how many windows
``fit`` keeps in flight (``MXNET_DISPATCH_DEPTH``,
:func:`choose_dispatch_depth`). The decisions are published on the
``fit.train_window_k`` and ``fit.dispatch_depth`` gauges.

The functions and the scheduler are copies of the reference's, so the
same telemetry gives the same K and depth in both packages. In the port a
window runs its K steps eagerly on the hand-written kernels
(``Executor.fused_train_update``), so K amortises the host's per-step
work around the launches, not a per-program round trip.

The other two pieces of the reference module, ahead-of-time dispatch of
compiled programs (``AOTProgram``) and their persistent cache
(``load``/``store``), are ``ROADMAP.md`` queue 1 item 11.
"""

from __future__ import annotations

import math

from . import env as _env
from . import telemetry as _tm


def train_window_setting():
    """Parsed ``MXNET_TRAIN_WINDOW``: None (off), an int K > 1, or 'auto'."""
    raw = str(_env.get("MXNET_TRAIN_WINDOW")).strip().lower()
    if raw in ("", "0", "1", "off", "none", "false"):
        return None
    if raw == "auto":
        return "auto"
    try:
        k = int(raw)
    except ValueError:
        return None
    return k if k > 1 else None


def dispatch_depth_setting():
    """Parsed ``MXNET_DISPATCH_DEPTH``: 'auto' or an int >= 1."""
    raw = str(_env.get("MXNET_DISPATCH_DEPTH")).strip().lower()
    if raw in ("", "auto"):
        return "auto"
    try:
        d = int(raw)
    except ValueError:
        return "auto"
    return max(1, d)


def choose_dispatch_depth(dispatch_us, residual_us, max_depth=4):
    """Windows to keep in flight, from a measured per-step host profile.

    Depth 2 (double buffering) is the baseline: while window N runs on the
    device, the host assembles and enqueues N+1. A deeper queue helps only
    when the host's per-step work is mostly dispatch (``dispatch_us`` >
    the residual); one more window of slack then absorbs its bursts.
    Depth never exceeds ``max_depth``: every window in flight holds K
    staged batches of device memory.
    """
    host = max(dispatch_us, 0.0) + max(residual_us, 0.0)
    if host <= 0:
        return 2
    share = max(dispatch_us, 0.0) / host
    return max(2, min(int(max_depth), 2 + int(share > 0.5)))


def choose_train_window(dispatch_us, residual_us, max_k=32,
                        overhead_budget=0.1):
    """Window depth K from a measured per-step host profile.

    ``dispatch_us``: average host time per step in the ``fit.dispatch``
    span. ``residual_us``: average host time per step everywhere else in
    the loop (data wait, metric, callbacks). K is the smallest depth that
    brings ``dispatch / K`` under ``overhead_budget`` of the residual, so
    dispatch-bound profiles get deep windows and the others K = 1.
    """
    if dispatch_us <= 0:
        return 1
    if residual_us <= 0:
        return max_k
    k = math.ceil(dispatch_us / (overhead_budget * residual_us))
    return max(1, min(int(k), int(max_k)))


class TrainWindowScheduler:
    """Drives ``Module.fit``'s steps per window (``MXNET_TRAIN_WINDOW``).

    A fixed integer: every dispatch takes that K. ``auto``: the first
    ``SKIP_BATCHES`` steps are ignored (they carry the first launches and
    cuDNN's choices), the next ``PROBE_BATCHES`` run single-step while the
    ``fit.*`` phase histograms accumulate, then :func:`choose_train_window`
    fixes K for the rest of training. A telemetry ``reset()`` during the
    probe restarts it.

    The scheduler also owns the dispatch depth (``MXNET_DISPATCH_DEPTH``):
    auto co-tunes (K, depth) from the same profile, depth >= 2 whenever
    windows engage, and K then relaxes because the overlap hides part of
    the per-window work. :meth:`cap_depth` forces depth 1 for policies
    whose boundaries must fence; the ``fit.dispatch_depth`` gauge reports
    the depth in force either way.
    """

    SKIP_BATCHES = 2
    PROBE_BATCHES = 8
    _PHASES = ("fit.dispatch", "fit.data_wait", "fit.metric", "fit.callback")

    def __init__(self, setting, max_k=32, depth_setting=None):
        self.max_k = max_k
        self.auto = setting == "auto"
        self.k = 1 if self.auto else int(setting)
        self._decided = not self.auto
        self._batches = 0
        self._skipped = not self.auto
        self._base = {}
        self._depth_setting = (dispatch_depth_setting()
                               if depth_setting is None else depth_setting)
        self._depth_cap_reason = None
        self.depth = self._resolve_depth(None, None)
        _tm.gauge("fit.train_window_k").set(self.k)
        _tm.gauge("fit.dispatch_depth").set(self.depth)

    @staticmethod
    def from_env(module, monitor=None):
        """A scheduler for this fit run, or None when windows do not apply
        (the variable unset, a module without ``train_window``, or a
        monitor installed: monitored steps stay per batch)."""
        setting = train_window_setting()
        if setting is None or monitor is not None:
            return None
        if not callable(getattr(module, "train_window", None)):
            return None
        return TrainWindowScheduler(setting)

    def _resolve_depth(self, dispatch_us, residual_us):
        """The depth for the current K: a policy cap wins, then K <= 1
        forces 1 (no windows, no pipeline), then a fixed setting, then
        auto: 2 before the probe, :func:`choose_dispatch_depth` after."""
        if self._depth_cap_reason is not None:
            return 1
        if self.k <= 1:
            return 1
        if self._depth_setting != "auto":
            return int(self._depth_setting)
        if dispatch_us is None:
            return 2
        return choose_dispatch_depth(dispatch_us, residual_us)

    def cap_depth(self, reason):
        """Cap the depth at 1 (every window boundary fences) and record
        why; the ``fit.dispatch_depth`` gauge reports the capped value."""
        self._depth_cap_reason = str(reason)
        self.depth = 1
        _tm.gauge("fit.dispatch_depth").set(1)
        return self

    @property
    def depth_cap_reason(self):
        """Why the depth is capped at 1, or None."""
        return self._depth_cap_reason

    def _rebase(self):
        for name in self._PHASES:
            h = _tm.histogram(name)
            self._base[name] = (h.count, h.sum)
        self._batches = 0

    def observe(self, n):
        """Record that ``n`` batches were dispatched since the last call."""
        self._batches += n

    def next_k(self):
        """The window depth of the next dispatch (decided when the probe
        completes)."""
        if self._decided:
            # a telemetry reset zeroes the gauges: re-assert the decision
            _tm.gauge("fit.train_window_k").set(self.k)
            _tm.gauge("fit.dispatch_depth").set(self.depth)
            return self.k
        if not self._skipped:
            if self._batches >= self.SKIP_BATCHES:
                self._skipped = True
                self._rebase()
            return 1
        if self._batches < self.PROBE_BATCHES:
            return 1
        deltas = {}
        reset_seen = False
        for name, (c0, s0) in self._base.items():
            h = _tm.histogram(name)
            dc_, ds_ = h.count - c0, h.sum - s0
            # a negative delta means telemetry was reset during the probe
            if dc_ < 0 or ds_ < 0:
                reset_seen = True
            deltas[name] = (dc_, ds_)
        dc, ds = deltas["fit.dispatch"]
        if reset_seen or dc <= 0:
            self._rebase()
            return 1
        residual = sum(s for n, (_c, s) in deltas.items()
                       if n != "fit.dispatch")
        dispatch_us, residual_us = ds / dc, residual / dc
        self.k = choose_train_window(dispatch_us, residual_us, self.max_k)
        self.depth = self._resolve_depth(dispatch_us, residual_us)
        if self.k > 1 and self.depth > 1:
            # with >= 2 windows in flight the overlap already hides part of
            # the per-window work: the budget relaxes by the depth factor
            self.k = max(2, choose_train_window(
                dispatch_us, residual_us, self.max_k,
                overhead_budget=0.1 * self.depth))
        self._decided = True
        _tm.gauge("fit.train_window_k").set(self.k)
        _tm.gauge("fit.dispatch_depth").set(self.depth)
        return self.k
