"""BucketingModule — variable-length training with a module per bucket.

Counterpart of ``mxnet_tpu/module/bucketing_module.py`` (reference
``python/mxnet/module/bucketing_module.py``): ``sym_gen(bucket_key)``
produces a ``(symbol, data_names, label_names)`` triple per bucket;
``switch_bucket`` binds a child :class:`Module` for a new key with the
default bucket's module as ``shared_module``, so every bucket's executor
holds the same parameter, gradient and state arrays, and borrows its
optimizer, so every bucket updates the same Adam (or momentum) states. The
JAX package compiles one XLA program per bucket; here each bucket is an
eager executor with its own graph plan and its own update-kernel table,
built once, over the shared storage.

Training windows (``train_window``) and ahead-of-time warmup
(``compile``) are not yet ported and raise :class:`MXNetError`.
"""

from __future__ import annotations

import logging
import warnings

from .. import telemetry as _tm
from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule, _check_input_names
from .module import Module

_WINDOWS = ("not yet ported to mxnet_tpu_torch (ROADMAP.md queue 1 item 2: "
            "training windows and the step's warmup)")


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs a default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = list(fixed_param_names or [])
        self._state_names = list(state_names or [])
        self._validate_sym_gen()
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False

    def _validate_sym_gen(self):
        """Check the sym_gen contract on the default bucket up front."""
        symbol, data_names, label_names = \
            self._sym_gen(self._default_bucket_key)
        for names, kind, required in (
                (list(data_names or []), "data", True),
                (list(label_names or []), "label", False),
                (self._state_names, "state", True),
                (self._fixed_param_names, "fixed_param", True)):
            _check_input_names(symbol, names, kind, required)

    def _module_for(self, bucket_key):
        """A fresh (unbound) Module for one bucket key."""
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(
            symbol, data_names, label_names, logger=self.logger,
            context=self._context, work_load_list=self._work_load_list,
            fixed_param_names=self._fixed_param_names,
            state_names=self._state_names,
        )

    def _require(self, *, bound=False, params=False, optimizer=False):
        if bound and not self.binded:
            raise MXNetError("BucketingModule is not bound; call bind()")
        if params and not self.params_initialized:
            raise MXNetError("parameters are not initialized; call "
                             "init_params()")
        if optimizer and not self.optimizer_initialized:
            raise MXNetError("optimizer is not initialized; call "
                             "init_optimizer()")

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        self._require(bound=True)
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        self._require(bound=True)
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        self._require(bound=True)
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        self._require(bound=True)
        return self._curr_module.symbol

    # ------------------------------------------------------------------
    def get_params(self):
        self._require(bound=True, params=True)
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=False,
                             force_init=force_init)
            return
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and "
                          "force_init=False. set_params call ignored.",
                          stacklevel=2)
            return
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init)
        self._params_dirty = True
        self.params_initialized = True

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        self._require(bound=True)
        self._curr_module.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init)
        self._params_dirty = False
        self.params_initialized = True

    def get_states(self, merge_multi_context=True):
        self._require(bound=True, params=True)
        return self._curr_module.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        self._require(bound=True, params=True)
        self._curr_module.set_states(states, value)

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if shared_module is not None:
            raise MXNetError("shared_module for BucketingModule is not "
                             "supported")
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        module = self._module_for(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, shared_module=None, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` current, binding its module on first use
        (sharing the default bucket's arrays and optimizer).
        ``bucketing.switch`` counts changes of the current bucket,
        ``bucketing.compile_on_switch`` the switches that bound a new
        bucket (the reference's names)."""
        self._require(bound=True)
        if bucket_key != self._curr_bucket_key:
            _tm.counter("bucketing.switch").inc()
        if bucket_key not in self._buckets:
            _tm.counter("bucketing.compile_on_switch").inc()
            default = self._buckets[self._default_bucket_key]
            module = self._module_for(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False, shared_module=default)
            if self.optimizer_initialized:
                module.borrow_optimizer(default)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._require(bound=True, params=True)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def prepare(self, data_batch):
        """Bind the batch's bucket ahead of its step without making it
        current."""
        self._require(bound=True, params=True)
        active = self._curr_bucket_key
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.prepare(data_batch)
        self.switch_bucket(active, None, None)

    def train_window(self, data_batch, n_steps=1, batches=None,
                     publish_grads=True):
        raise MXNetError(f"BucketingModule.train_window: {_WINDOWS}")

    def compile(self, buckets=None, parallel=True):
        raise MXNetError(f"BucketingModule.compile: {_WINDOWS}")

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._require(bound=True, params=True)
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._require(bound=True, params=True)
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._require(bound=True, params=True, optimizer=True)
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        self._require(bound=True, params=True)
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require(bound=True, params=True)
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._require(bound=True, params=True)
        self._curr_module.update_metric(eval_metric, labels)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Save the default bucket's symbol, the parameters and (optionally)
        the optimizer states, as the reference does."""
        self._require(bound=True)
        default = self._buckets[self._default_bucket_key]
        default._params_dirty = default._params_dirty or self._params_dirty
        default.save_checkpoint(prefix, epoch, save_optimizer_states)
        self._params_dirty = False
