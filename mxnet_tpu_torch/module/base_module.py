"""BaseModule — the training-loop interface.

Counterpart of ``mxnet_tpu/module/base_module.py`` (reference
``python/mxnet/module/base_module.py``, ``fit`` at :375-533): bind ->
init_params -> init_optimizer -> per batch forward_backward / update /
update_metric -> epoch metric log, callbacks, optional evaluation, plus
``score``, ``predict`` and ``iter_predict``. The epoch loop never reads a
device value per batch: the metric accumulates on the device and the epoch
end reads it, and the non-finite guard's counters are read there too.

Not yet ported, and raising where a caller asks for them: training windows
(``MXNET_TRAIN_WINDOW``), checkpoint directories with auto-resume
(``fit(checkpoint=...)``), monitors, device prefetch and the I/O retry
wrapper.
"""

from __future__ import annotations

import logging
import time

import torch

from .. import env as _env
from .. import metric as metric_mod
from .. import telemetry as _tm
from ..base import MXNetError
from ..initializer import Uniform
from ..ndarray import NDArray


def _as_list(obj):
    return obj if isinstance(obj, list) else [obj]


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        candidates = [arg for arg in args if not arg.endswith(
            ("_weight", "_bias", "_gamma", "_beta"))]
        msg = (f"You created Module with Module(..., {typename}_names={names}) "
               f"but input with name '{name}' is not found in "
               f"symbol.list_arguments(). Did you mean one of:\n\t"
               + "\n\t".join(candidates))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class _NonfiniteGuard:
    """Escalation policy for ``MXNET_NONFINITE_GUARD`` (the detection and
    the skip run on the device inside the fused update; this class reads
    the counters at sync points). ``skip`` counts skips
    (``fit.nonfinite_skip``); ``raise`` fails on the first skipped batch (a
    per-batch host read); ``rollback`` raises once
    ``MXNET_NONFINITE_TOLERANCE`` consecutive skips stand at an epoch end,
    because restoring a checkpoint is not yet ported."""

    def __init__(self, module, mode, tolerance):
        self.module = module
        self.mode = mode
        self.tolerance = max(1, int(tolerance))
        self._reported = module.nonfinite_stats()[0]

    @staticmethod
    def from_env(module):
        mode = str(_env.get("MXNET_NONFINITE_GUARD") or "").lower()
        if mode not in ("skip", "rollback", "raise"):
            return None
        if not hasattr(module, "nonfinite_stats"):
            logging.warning(
                "MXNET_NONFINITE_GUARD set but %s exposes no guard counters; "
                "each update is still guarded on the device, but escalation "
                "is off", type(module).__name__)
            return None
        return _NonfiniteGuard(module, mode,
                               _env.get("MXNET_NONFINITE_TOLERANCE"))

    def _flush(self):
        total, consec = self.module.nonfinite_stats()
        if total > self._reported:
            _tm.counter("fit.nonfinite_skip").inc(total - self._reported)
            self._reported = total
        return total, consec

    def after_batch(self):
        if self.mode != "raise":
            return
        total, consec = self._flush()
        if consec:
            raise MXNetError(
                f"non-finite gradients: update skipped ({total} total); "
                "MXNET_NONFINITE_GUARD=raise fails fast — use 'skip' to "
                "train through it")

    def on_epoch(self, logger):
        total, consec = self._flush()
        if consec == 0:
            return
        logger.warning(
            "fit: %d consecutive non-finite-gradient skips at epoch end "
            "(%d total this run)", consec, total)
        if self.mode == "rollback" and consec >= self.tolerance:
            raise MXNetError(
                f"{consec} consecutive non-finite-gradient skips and no "
                "checkpoint to roll back to (checkpoint rollback is not yet "
                "ported to mxnet_tpu_torch)")


def _train_window_unset():
    window = str(_env.get("MXNET_TRAIN_WINDOW") or "").strip()
    if window not in ("", "1"):
        raise MXNetError(f"MXNET_TRAIN_WINDOW={window}: training windows "
                         "are not yet ported to mxnet_tpu_torch (ROADMAP.md "
                         "queue 1 item 2)")


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # --- high-level -------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        if not (self.binded and self.params_initialized):
            raise MXNetError("score: bind and init_params first")
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        from ..model import BatchEndParam

        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        if not (self.binded and self.params_initialized):
            raise MXNetError("iter_predict: bind and init_params first")
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        output_list = [[o.copy() for o in outputs] for outputs, _n, _b in
                       self.iter_predict(eval_data, num_batch, reset)]
        if not output_list or not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        if any(len(out) != num_outputs for out in output_list):
            raise MXNetError("Cannot merge batches, as num of outputs is not "
                             "the same in mini-batches")
        merged = [NDArray(torch.cat([out[i]._data for out in output_list]))
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, checkpoint=None):
        """Train the module (reference base_module.py:375-533)."""
        if num_epoch is None:
            raise MXNetError("please specify number of epochs")
        if checkpoint is not None:
            raise MXNetError("fit(checkpoint=...) is not yet ported to "
                             "mxnet_tpu_torch; use epoch_end_callback="
                             "callback.do_checkpoint(prefix)")
        if monitor is not None:
            raise MXNetError("monitors are not yet ported to mxnet_tpu_torch")
        _train_window_unset()
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        guard = _NonfiniteGuard.from_env(self)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        from ..model import BatchEndParam

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            batches = iter(train_data)
            with _tm.span("fit.data_wait"):
                pending = next(batches, None)
            while pending is not None:
                data_batch = pending
                with _tm.span("fit.dispatch"):
                    self.forward_backward(data_batch)
                    self.update()
                # fetch and prepare the next batch while this step runs on
                # the card (a BucketingModule binds its bucket here)
                with _tm.span("fit.data_wait"):
                    pending = next(batches, None)
                    if pending is not None:
                        self.prepare(pending)
                with _tm.span("fit.metric"):
                    self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    with _tm.span("fit.callback"):
                        for callback in _as_list(batch_end_callback):
                            callback(params)
                nbatch += 1
                if guard is not None:
                    guard.after_batch()
            _tm.counter("fit.batches").inc(nbatch)
            _tm.counter("fit.epochs").inc()
            with _tm.span("fit.metric"):
                epoch_values = eval_metric.get_name_value()
            for name, val in epoch_values:
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            with _tm.span("fit.param_sync"):
                arg_params_, aux_params_ = self.get_params()
            if guard is not None:
                guard.on_epoch(self.logger)
            if epoch_end_callback is not None:
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    def prepare(self, data_batch):
        """Get ready for ``data_batch`` before its step (reference
        ``prepare``); batches already live on their context here."""

    # --- symbol/params interface ------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
        save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
        from ..ndarray import save

        save(fname, save_dict)

    def load_params(self, fname):
        from ..model import _split_param_dict
        from ..ndarray import load

        arg_params, aux_params = _split_param_dict(load(fname), fname)
        self.set_params(arg_params, aux_params)
