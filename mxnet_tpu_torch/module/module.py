"""Module — the standard intermediate-level training module.

Counterpart of ``mxnet_tpu/module/module.py`` (reference
``python/mxnet/module/module.py``): ``bind`` creates the executor group,
``init_params`` runs the initializer (or copies given values),
``init_optimizer`` sets ``rescale_grad = 1/batch`` and builds the
optimizer, ``update`` applies it — in one fused multi-tensor launch when
the optimizer has ``torch_apply`` and a backward has just run, else
parameter by parameter through the ``Updater`` — and checkpoints save the
symbol, the parameters and the optimizer states.

The module runs on ``context`` (default: the current context, ``gpu(0)``;
the JAX package defaults to ``cpu()``). Several contexts, kvstores and
training windows (``train_window``) are not yet ported.
"""

from __future__ import annotations

import logging
import warnings

import torch

from .. import context as ctx_mod
from .. import env as _env
from .. import optimizer as opt
from ..base import MXNetError
from ..executor import nonfinite_guard_on
from ..initializer import InitDesc, Uniform
from ..model import (
    _create_kvstore,
    _update_params,
    atomic_path,
    load_checkpoint,
)
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        if context is None:
            context = ctx_mod.current_context()
        self._context = [context] if isinstance(context, ctx_mod.Context) \
            else list(context)
        self._work_load_list = list(work_load_list or [1] * len(self._context))
        groups = {}
        for kind, names, required in (
                ("data", data_names, True),
                ("label", label_names, False),
                ("state", state_names, True),
                ("fixed_param", fixed_param_names, True)):
            names = [] if names is None else list(names)
            _check_input_names(symbol, names, kind, required)
            groups[kind] = names
        self._data_names = groups["data"]
        self._label_names = groups["label"]
        self._state_names = groups["state"]
        self._fixed_param_names = groups["fixed_param"]
        fed = set(self._data_names) | set(self._label_names) | \
            set(self._state_names)
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in fed]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = self._aux_params = None
        self._params_dirty = False
        self._optimizer = self._kvstore = self._updater = None
        self._update_on_kvstore = False
        self._preload_opt_states = None
        self._grad_req = self._exec_group = None
        self._data_shapes = self._label_shapes = None
        self._guard_host = None  # [total, consecutive] of imperative skips

    def _require(self, *, bound=False, params=False, optimizer=False):
        if bound and not self.binded:
            raise MXNetError("Module is not bound; call bind() first")
        if params and not self.params_initialized:
            raise MXNetError("parameters are not initialized; call "
                             "init_params()")
        if optimizer and not self.optimizer_initialized:
            raise MXNetError("optimizer is not initialized; call "
                             "init_optimizer()")

    # ------------------------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Save symbol, params and (optionally) optimizer states under
        ``prefix``, each file written atomically."""
        with atomic_path(f"{prefix}-symbol.json") as tmp:
            self._symbol.save(tmp)
        param_name = f"{prefix}-{epoch:04d}.params"
        with atomic_path(param_name) as tmp:
            self.save_params(tmp)
        logging.info("Saved checkpoint to \"%s\"", param_name)
        if save_optimizer_states:
            with atomic_path(f"{prefix}-{epoch:04d}.states") as tmp:
                self.save_optimizer_states(tmp)

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        self._require(bound=True)
        return self._data_shapes

    @property
    def label_shapes(self):
        self._require(bound=True)
        return self._label_shapes

    @property
    def output_shapes(self):
        self._require(bound=True)
        shapes = {d.name: d.shape for d in self._data_shapes}
        shapes.update({d.name: d.shape for d in self._label_shapes or []})
        _args, outs, _aux = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, outs))

    # ------------------------------------------------------------------
    def get_params(self):
        self._require(bound=True, params=True)
        if self._params_dirty:
            self._exec_group.get_params(self._arg_params, self._aux_params)
            self._params_dirty = False
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and "
                          "force_init=False. init_params call ignored.",
                          stacklevel=2)
            return
        self._require(bound=True)

        def _impl(name, arr, cache):
            supplied = None if cache is None else cache.get(name)
            if supplied is not None:
                if supplied is not arr:
                    supplied.copyto(arr)
                return
            if cache is not None and not allow_missing:
                raise RuntimeError(f"{name} is not presented")
            if initializer is not None:
                initializer(name, arr)

        exe = self._exec_group._exec
        attrs = self._symbol.attr_dict()
        for name, arr in sorted(exe.arg_dict.items()):
            if name in self._param_names:
                _impl(InitDesc(name, attrs.get(name, None)), arr, arg_params)
        for name, arr in sorted(exe.aux_dict.items()):
            _impl(InitDesc(name, attrs.get(name, None)), arr, aux_params)
        self.params_initialized, self._params_dirty = True, False
        self._arg_params = {n: exe.arg_dict[n].copy()
                            for n in self._param_names if n in exe.arg_dict}
        self._aux_params = {n: a.copy() for n, a in exe.aux_dict.items()}

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
        self._exec_group.set_params(arg_params, aux_params, allow_extra=True)
        self._params_dirty = True
        self.params_initialized = True

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self.binded = False
            self._exec_group = self._data_shapes = self._label_shapes = None
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad and not for_training:
            raise ValueError("inputs_need_grad requires for_training=True")
        self.binded, self.for_training = True, for_training
        self.inputs_need_grad, self._grad_req = inputs_need_grad, grad_req
        shared_group = None
        if shared_module is not None:
            if not (isinstance(shared_module, Module) and shared_module.binded
                    and shared_module.params_initialized):
                raise MXNetError("shared_module must be a bound, initialized "
                                 "Module")
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list, data_shapes,
            label_shapes, self._param_names, for_training, inputs_need_grad,
            shared_group, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            state_names=self._state_names)
        self._data_shapes = self._exec_group.data_shapes
        self._label_shapes = self._exec_group.label_shapes
        if shared_module is not None and shared_module.params_initialized:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            # bind() after load(): push the loaded params into the executor
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def reshape(self, data_shapes, label_shapes=None):
        self._require(bound=True)
        self._exec_group.reshape(data_shapes, label_shapes)
        self._data_shapes = self._exec_group.data_shapes
        self._label_shapes = self._exec_group.label_shapes

    # ------------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._require(bound=True, params=True)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        self._kvstore, self._update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        rescale_grad = 1.0 / self._exec_group.batch_size
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._exec_group.param_names))
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError("optimizer must be a name or an Optimizer")
        elif optimizer.rescale_grad != rescale_grad:
            warnings.warn(
                f"Optimizer created manually outside Module but rescale_grad "
                f"is not normalized to 1.0/batch_size "
                f"({optimizer.rescale_grad} vs. {rescale_grad}). Is this "
                "intended?", stacklevel=2)
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        shared_module._require(optimizer=True)
        for attr in ("_optimizer", "_kvstore", "_update_on_kvstore",
                     "_updater"):
            setattr(self, attr, getattr(shared_module, attr))
        self.optimizer_initialized = True

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._require(bound=True, params=True)
        curr = tuple(i.shape for i in self._data_shapes)
        new = tuple(i.shape for i in data_batch.data)
        if curr != new:
            new_dshape = getattr(data_batch, "provide_data", None) or [
                (i.name, shape) for i, shape in zip(self._data_shapes, new)]
            new_lshape = getattr(data_batch, "provide_label", None)
            if not new_lshape and data_batch.label:
                new_lshape = [(i.name, j.shape) for i, j in
                              zip(self._label_shapes, data_batch.label)]
            self.reshape(new_dshape, new_lshape or None)
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._require(bound=True, params=True)
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply the optimizer to the gradients of the last backward."""
        self._require(bound=True, params=True, optimizer=True)
        self._params_dirty = True
        if self._fusable_update():
            self._exec_group.update_fused(self._optimizer, self._updater)
            return
        if self._nonfinite_skip_imperative():
            return
        _update_params(self._exec_group.param_arrays,
                       self._exec_group.grad_arrays, updater=self._updater,
                       num_device=1)

    def train_window(self, data_batch, n_steps=1, batches=None,
                     publish_grads=True):
        raise MXNetError("Module.train_window: training windows are not yet "
                         "ported to mxnet_tpu_torch (ROADMAP.md queue 1 "
                         "item 2)")

    def _fusable_update(self):
        """True when this step can take the fused update: a
        ``torch_apply`` optimizer and gradients of a backward that no
        update has consumed (else the imperative path keeps the semantics
        of gradients edited by hand)."""
        return (bool(_env.get("MXNET_EXEC_BULK_EXEC_TRAIN"))
                and getattr(self._optimizer, "torch_apply", None) is not None
                and self._exec_group.has_pending_backward())

    def _nonfinite_skip_imperative(self):
        """The guard on the imperative update path: one host read of an
        all-finite reduction per step. True when the update must be
        skipped."""
        if not nonfinite_guard_on():
            return False
        finite = all(bool(torch.isfinite(g[0]._data).all())
                     for g in self._exec_group.grad_arrays
                     if g[0] is not None)
        total, consec = self._guard_host or (0, 0)
        self._guard_host = [total + (not finite),
                            0 if finite else consec + 1]
        return not finite

    def nonfinite_stats(self):
        """``(total_skips, consecutive_skips)`` of the non-finite guard over
        the fused (device) and imperative (host) update paths. Reads the
        device counters: call at sync points."""
        et, ec = self._exec_group._exec.nonfinite_guard_stats()
        ht, hc = self._guard_host or (0, 0)
        return (et + ht, max(ec, hc))

    def reset_nonfinite_consec(self):
        self._exec_group._exec.reset_nonfinite_guard(keep_total=True)
        if self._guard_host:
            self._guard_host[1] = 0

    def get_outputs(self, merge_multi_context=True):
        self._require(bound=True, params=True)
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require(bound=True, params=True)
        if not self.inputs_need_grad:
            raise MXNetError("bind was not called with inputs_need_grad=True")
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def get_states(self, merge_multi_context=True):
        """The state arrays (``state_names``, e.g. RNN begin states), in
        order."""
        self._require(bound=True, params=True)
        states = [self._exec_group._exec.arg_dict[n]
                  for n in self._state_names]
        return states if merge_multi_context else [[s] for s in states]

    def set_states(self, states=None, value=None):
        """Write the state arrays from ``states`` (one array, or one list
        of per-device arrays, per state) or fill them with ``value``."""
        self._require(bound=True, params=True)
        if (states is None) == (value is None):
            raise MXNetError("set_states takes either states or value")
        for i, name in enumerate(self._state_names):
            arr = self._exec_group._exec.arg_dict[name]
            if states is None:
                arr[:] = value
                continue
            src = states[i][0] if isinstance(states[i], (list, tuple)) \
                else states[i]
            src.copyto(arr)

    # ------------------------------------------------------------------
    def save_optimizer_states(self, fname):
        self._require(optimizer=True)
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        self._require(optimizer=True)
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
