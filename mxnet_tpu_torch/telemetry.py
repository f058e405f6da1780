"""Process-wide telemetry: counters, gauges, histograms, host spans.

A copy of ``mxnet_tpu/telemetry.py``, the host half of observability:

- **Instruments** (:func:`counter`, :func:`gauge`, :func:`histogram`) form
  a process-wide registry. They are ALWAYS on: an increment is one lock +
  one add, cheap enough for per-batch hot paths. :func:`snapshot` renders
  the registry as a nested dict, :func:`dump` writes it as JSON plus a
  Prometheus-style text exposition, :func:`reset` zeroes values in place
  (handles cached by hot paths stay valid).

- **Spans** (:func:`span`) time a region. The duration always feeds the
  histogram of the same name (microseconds), and — only when span
  recording is enabled via ``MXNET_TELEMETRY`` (:func:`enable_spans`) — a
  Chrome trace *complete* event is recorded; :func:`dump_trace` writes
  them as trace-event JSON.

The port's instrumented paths are ``serving.*`` (request admission/shed,
batch composition, queue-wait/infer/latency) and ``ndarray.asnumpy``
(every device-to-host copy). Merging with a device trace and the
per-kernel table wait for the port's profiler.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = [
    "counter", "gauge", "histogram", "span", "snapshot", "dump", "reset",
    "prometheus", "spans_enabled", "enable_spans", "events", "dump_trace",
    "phase_totals",
]


class Counter:
    """Monotonic counter (resettable via :func:`reset`)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self.value += n

    def _zero(self):
        with self._lock:
            self.value = 0

    def _render(self):
        return self.value


class Gauge:
    """Last-set value plus the high-water mark since the last reset."""

    __slots__ = ("name", "value", "max", "_lock")

    def __init__(self, name):
        self.name = name
        self.value = 0
        self.max = 0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self.value = v
            if v > self.max:
                self.max = v

    def _zero(self):
        with self._lock:
            self.value = 0
            self.max = 0

    def _render(self):
        return {"value": self.value, "max": self.max}


class Histogram:
    """Streaming count/sum/min/max (values are whatever unit the caller
    observes; span durations are microseconds)."""

    __slots__ = ("name", "count", "sum", "min", "max", "_lock")

    def __init__(self, name):
        self.name = name
        self.count = 0
        self.sum = 0
        self.min = None
        self.max = None
        self._lock = threading.Lock()

    def observe(self, v):
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    def _zero(self):
        with self._lock:
            self.count = 0
            self.sum = 0
            self.min = None
            self.max = None

    def _render(self):
        out = {"count": self.count, "sum": self.sum}
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
            out["avg"] = self.sum / self.count
        return out


_lock = threading.Lock()
_instruments = {}  # name -> instrument (kind enforced on first use)


def _get(name, cls):
    inst = _instruments.get(name)
    if inst is None:
        with _lock:
            inst = _instruments.get(name)
            if inst is None:
                inst = cls(name)
                _instruments[name] = inst
    if not isinstance(inst, cls):
        raise TypeError(
            f"telemetry name {name!r} is a {type(inst).__name__}, "
            f"not a {cls.__name__}"
        )
    return inst


def counter(name):
    """The process-wide counter called ``name`` (created on first use)."""
    return _get(name, Counter)


def gauge(name):
    """The process-wide gauge called ``name`` (created on first use)."""
    return _get(name, Gauge)


def histogram(name):
    """The process-wide histogram called ``name`` (created on first use)."""
    return _get(name, Histogram)


# --- span recording --------------------------------------------------------

def _env_spans():
    from . import env as _env

    return bool(_env.get("MXNET_TELEMETRY"))


_spans_on = _env_spans()
_events = []
_events_lock = threading.Lock()
_MAX_EVENTS = 500_000  # memory backstop; overflow counted, not grown


def spans_enabled():
    """True when span() calls record Chrome trace events."""
    return _spans_on


def enable_spans(on=True):
    """Turn span recording on/off at runtime (MXNET_TELEMETRY sets the
    import-time default)."""
    global _spans_on
    _spans_on = bool(on)


class _Span:
    """Times a region: histogram always, trace event when spans are on."""

    __slots__ = ("name", "args", "_t0", "_ts")

    def __init__(self, name, args):
        self.name = name
        self.args = args

    def __enter__(self):
        # wall-clock start is always captured: spans may be enabled while
        # this one is open (enable_spans from a callback) and __exit__
        # must not find _ts unset
        self._ts = time.time_ns() // 1000
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur_us = (time.perf_counter_ns() - self._t0) // 1000
        histogram(self.name).observe(dur_us)
        if _spans_on:
            ev = {
                "name": self.name, "ph": "X", "cat": "host",
                "ts": self._ts, "dur": max(dur_us, 1),
                "pid": os.getpid(), "tid": threading.get_ident(),
            }
            if self.args:
                ev["args"] = dict(self.args)
            with _events_lock:
                if len(_events) < _MAX_EVENTS:
                    _events.append(ev)
                else:
                    counter("telemetry.dropped_events").inc()
        return False


def span(name, **args):
    """Context manager timing a region.

    The duration (microseconds) always feeds ``histogram(name)``; when
    span recording is enabled a Chrome trace-event is captured as well.
    """
    return _Span(name, args)


def events():
    """A copy of the recorded host trace events."""
    with _events_lock:
        return list(_events)


def dump_trace(path):
    """Write the recorded host spans as Chrome trace-event JSON."""
    with open(path, "w") as f:
        json.dump({"traceEvents": events(), "displayTimeUnit": "ms"}, f)
    return path


# --- export ----------------------------------------------------------------

def snapshot():
    """The registry as a nested dict (names split on '.')."""
    with _lock:
        items = sorted(_instruments.items())
    # build a tree of instrument objects first, render at the end: while
    # building, dicts are always tree nodes and instruments always leaves,
    # so a name nested under another instrument's name ("a.b" vs "a.b.c")
    # demotes the occupying leaf to key "" instead of merging into its
    # rendered dict
    root = {}
    for name, inst in items:
        node = root
        parts = name.split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = node[p] = {} if nxt is None else {"": nxt}
            node = nxt
        leaf = parts[-1]
        if isinstance(node.get(leaf), dict):
            node[leaf][""] = inst
        else:
            node[leaf] = inst

    def render(node):
        return {
            k: render(v) if isinstance(v, dict) else v._render()
            for k, v in node.items()
        }

    return render(root)


def phase_totals(prefix=""):
    """{name: summed duration} for every histogram under ``prefix`` —
    Speedometer's phase-breakdown feed."""
    with _lock:
        items = list(_instruments.items())
    return {
        n: h.sum for n, h in items
        if isinstance(h, Histogram) and n.startswith(prefix)
    }


def prometheus():
    """Prometheus text exposition of the registry (counters/gauges map
    directly; histograms expose _count/_sum/_min/_max)."""
    with _lock:
        items = sorted(_instruments.items())
    lines = []

    def metric_name(name, suffix=""):
        return "mxnet_" + name.replace(".", "_").replace("-", "_") + suffix

    for name, inst in items:
        if isinstance(inst, Counter):
            lines.append(f"# TYPE {metric_name(name)} counter")
            lines.append(f"{metric_name(name)} {inst.value}")
        elif isinstance(inst, Gauge):
            lines.append(f"# TYPE {metric_name(name)} gauge")
            lines.append(f"{metric_name(name)} {inst.value}")
            lines.append(f"{metric_name(name, '_max')} {inst.max}")
        else:
            lines.append(f"# TYPE {metric_name(name)} summary")
            lines.append(f"{metric_name(name, '_count')} {inst.count}")
            lines.append(f"{metric_name(name, '_sum')} {inst.sum}")
            if inst.count:
                lines.append(f"{metric_name(name, '_min')} {inst.min}")
                lines.append(f"{metric_name(name, '_max')} {inst.max}")
    return "\n".join(lines) + "\n"


def dump(path):
    """Write the snapshot as JSON to ``path`` and the Prometheus text
    exposition next to it (``<path stem>.prom``). Returns both paths."""
    with open(path, "w") as f:
        json.dump(snapshot(), f, indent=2, sort_keys=True)
    prom_path = os.path.splitext(path)[0] + ".prom"
    with open(prom_path, "w") as f:
        f.write(prometheus())
    return path, prom_path


def reset():
    """Zero every instrument in place (cached handles stay valid) and
    drop recorded span events. Does not change span enablement."""
    with _lock:
        insts = list(_instruments.values())
    for inst in insts:
        inst._zero()
    with _events_lock:
        _events.clear()
