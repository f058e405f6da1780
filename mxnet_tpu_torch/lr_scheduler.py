"""Learning-rate schedulers.

A copy of ``mxnet_tpu/lr_scheduler.py`` (reference
``python/mxnet/lr_scheduler.py``): schedulers are callables of
``num_update`` (the Optimizer tracks per-index update counts and drives
the schedule). Re-designed stateless-at-heart: each scheduler derives the
decay count directly from ``num_update`` (a pure function of the step), so
schedulers survive checkpoint/resume without replaying the update history;
a change-log is emitted only when the derived lr actually moves.
"""

from __future__ import annotations

import bisect
import logging


class LRScheduler:
    """Base: maps ``num_update`` → learning rate. ``base_lr`` is stamped by
    the Optimizer at construction (reference contract)."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr
        self._last_logged = None

    def __call__(self, num_update):
        raise NotImplementedError("__call__ must be overridden")

    def _maybe_log(self, num_update, lr):
        if lr != self._last_logged:
            self._last_logged = lr
            logging.info("Update[%d]: learning rate is now %0.5e",
                         num_update, lr)
        return lr


class FactorScheduler(LRScheduler):
    """lr = base_lr · factor^(decays so far), one decay per ``step``
    updates, floored at ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = int(step)
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def __call__(self, num_update):
        # derived, not accumulated: number of whole steps strictly passed
        decays = max(num_update - 1, 0) // self.step
        lr = self.base_lr * (self.factor ** decays)
        if lr < self.stop_factor_lr:
            lr = self.stop_factor_lr
        return self._maybe_log(num_update, lr)


class MultiFactorScheduler(LRScheduler):
    """lr decays by ``factor`` as ``num_update`` passes each milestone in
    the increasing list ``step``."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty increasing list")
        if any(s < 1 for s in step) or any(
            b <= a for a, b in zip(step, step[1:])
        ):
            raise ValueError("Schedule step must be an increasing list of "
                             "integers >= 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = list(step)
        self.factor = factor

    def __call__(self, num_update):
        # milestones strictly below num_update have fired
        fired = bisect.bisect_left(self.step, num_update)
        lr = self.base_lr * (self.factor ** fired)
        return self._maybe_log(num_update, lr)
