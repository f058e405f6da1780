"""Training callbacks.

A copy of ``mxnet_tpu/callback.py`` (reference API ``python/mxnet/callback.py``):
batch callbacks receive a
``BatchEndParam``-shaped object (``epoch``/``nbatch``/``eval_metric``),
epoch callbacks receive ``(epoch, symbol, arg_params, aux_params)``; all
driven from ``BaseModule.fit``'s hooks.

Re-designed around two small primitives instead of per-callback state
machines: ``_Every`` (a periodic trigger) and ``_Meter`` (a rolling
throughput window), which the public callbacks compose.
"""

from __future__ import annotations

import logging
import math
import sys
import time


class _Every:
    """Fires on every N-th tick; ticks are explicit (epoch or batch ids)."""

    __slots__ = ("period",)

    def __init__(self, period):
        self.period = int(max(1, period))

    def fires(self, tick):
        return (tick + 1) % self.period == 0


class _Meter:
    """Rolling samples/sec over the batches since the last read."""

    __slots__ = ("batch_size", "_mark_time", "_mark_batch")

    def __init__(self, batch_size):
        self.batch_size = batch_size
        self._mark_time = None
        self._mark_batch = 0

    def rate(self, nbatch):
        """Throughput since the previous call; None on first/reset/zero-
        batch windows (an epoch rollover that lands on the same nbatch must
        arm, not report 0.0)."""
        now = time.time()
        batches = nbatch - self._mark_batch
        if self._mark_time is None or batches <= 0:
            self._mark_time, self._mark_batch = now, nbatch
            return None
        elapsed = max(now - self._mark_time, 1e-9)
        self._mark_time, self._mark_batch = now, nbatch
        return batches * self.batch_size / elapsed


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch callback saving a Module checkpoint every ``period`` epochs,
    through the atomic writer (``Module.save_checkpoint``: write to a
    temporary file, fsync, rename)."""
    every = _Every(period)

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if every.fires(iter_no):
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch callback saving symbol+params every ``period`` epochs,
    through the atomic writer (``model.save_checkpoint``)."""
    from .model import save_checkpoint

    every = _Every(period)

    def _callback(iter_no, sym, arg, aux):
        if every.fires(iter_no):
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch callback logging the training metric every ``period`` batches."""
    def _callback(param):
        if param.nbatch % period != 0 or param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            param.eval_metric.reset()

    return _callback


class Speedometer:
    """Log samples/sec (and the metric) every ``frequent`` batches.

    ``phases=True`` additionally logs the telemetry phase breakdown of the
    window — time spent in fit.data_wait / fit.dispatch / fit.metric /
    fit.callback since the last report — so a throughput dip is
    immediately attributable to data vs dispatch vs sync.
    """

    def __init__(self, batch_size, frequent=50, phases=False):
        self.frequent = int(frequent)
        self._meter = _Meter(batch_size)
        self._phases = bool(phases)
        self._phase_mark = None

    def _phase_line(self):
        """Render the per-phase time delta since the last report."""
        from . import telemetry as _tm

        totals = _tm.phase_totals("fit.")
        mark, self._phase_mark = self._phase_mark, totals
        if mark is None:
            return None
        parts = [
            f"{name.split('.', 1)[1]}={(totals[name] - mark.get(name, 0)) / 1e3:.1f}ms"
            for name in sorted(totals)
            if totals[name] - mark.get(name, 0) > 0
        ]
        return " ".join(parts) or None

    def __call__(self, param):
        if param.nbatch % self.frequent != 0:
            # keep the window anchored at the last report
            if param.nbatch < self._meter._mark_batch:
                self._meter.rate(param.nbatch)  # epoch rollover resets
            return
        speed = self._meter.rate(param.nbatch)
        if speed is None:
            if self._phases:
                self._phase_line()  # arm the phase window with the meter
            return  # first tick only arms the meter
        if self._phases:
            line = self._phase_line()
            if line:
                logging.info("Epoch[%d] Batch [%d]\tPhases: %s",
                             param.epoch, param.nbatch, line)
        metric = param.eval_metric
        if metric is not None:
            pairs = metric.get_name_value()
            metric.reset()
            for name, value in pairs:
                logging.info(
                    "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t"
                    "Train-%s=%f", param.epoch, param.nbatch, speed, name,
                    value,
                )
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, speed)


class ProgressBar:
    """ASCII progress bar per epoch."""

    def __init__(self, total, length=80):
        self.bar_len = int(length)
        self.total = total

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        filled = int(round(self.bar_len * frac))
        bar = "=" * filled + "-" * (self.bar_len - filled)
        sys.stdout.write(f"[{bar}] {math.ceil(frac * 100)}%\r")
