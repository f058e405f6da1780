"""Serving-side latency histogram with percentiles.

:mod:`mxnet_tpu_torch.telemetry` histograms keep count/sum/min/max — enough for
throughput accounting but not for the p50/p99 a serving SLO is written
against. This is the standard fixed-boundary (Prometheus-style) answer:
log-spaced buckets, O(1) lock-one-add observe (hot-path safe at request
rates), percentiles by linear interpolation inside the covering bucket.
Accuracy is bounded by the bucket ratio (~19% with the default ×1.5
spacing) — the right trade for a always-on histogram that must never
allocate per request.
"""

from __future__ import annotations

import bisect
import threading

__all__ = ["LatencyHistogram"]


class LatencyHistogram:
    """Log-spaced latency histogram (microseconds).

    Buckets cover ``[lo_us, hi_us)`` with ×``ratio`` spacing plus one
    overflow bucket; values below ``lo_us`` land in the first bucket.
    """

    __slots__ = ("_bounds", "_counts", "_count", "_sum", "_lock")

    def __init__(self, lo_us=50.0, hi_us=120_000_000.0, ratio=1.5):
        bounds = []
        b = float(lo_us)
        while b < hi_us:
            bounds.append(b)
            b *= ratio
        self._bounds = tuple(bounds)  # upper edge of each finite bucket
        self._counts = [0] * (len(bounds) + 1)  # +1 = overflow
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe_us(self, v):
        v = float(v)
        i = bisect.bisect_right(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v

    @property
    def count(self):
        return self._count

    def mean_us(self):
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def percentile(self, p):
        """Approximate ``p``-th percentile in microseconds (0 < p <= 100).

        Linear interpolation inside the covering bucket; 0.0 when empty.
        """
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if not total:
            return 0.0
        rank = max(1.0, p / 100.0 * total)
        seen = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            if seen + c >= rank:
                # bucket i spans (lower, upper); interpolate by rank offset
                upper = self._bounds[i] if i < len(self._bounds) \
                    else self._bounds[-1] * 2
                lower = self._bounds[i - 1] if i > 0 else 0.0
                frac = (rank - seen) / c
                return lower + (upper - lower) * frac
            seen += c
        return self._bounds[-1] * 2  # unreachable (total > 0)

    def snapshot(self):
        """{count, mean_us, p50_us, p90_us, p99_us} — the healthz payload."""
        return {
            "count": self._count,
            "mean_us": round(self.mean_us(), 1),
            "p50_us": round(self.percentile(50), 1),
            "p90_us": round(self.percentile(90), 1),
            "p99_us": round(self.percentile(99), 1),
        }

    def reset(self):
        with self._lock:
            for i in range(len(self._counts)):
                self._counts[i] = 0
            self._count = 0
            self._sum = 0.0
