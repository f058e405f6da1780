"""DataParallelExecutorGroup on one device.

Counterpart of ``mxnet_tpu/module/executor_group.py`` (reference
``python/mxnet/module/executor_group.py``): binds the module's executor,
feeds batches, gathers outputs and applies the fused update. The JAX
package binds one SPMD executor over a mesh of the contexts; the port
binds one executor on one device, and several contexts raise
(multi-GPU data parallelism is ``ROADMAP.md`` queue 1 item 7).
"""

from __future__ import annotations

import logging

from ..base import MXNetError, parse_shape
from ..executor import Executor
from ..io import DataDesc
from ..optimizer import _map_state


def _as_desc_list(shapes):
    out = []
    for s in shapes or []:
        if isinstance(s, DataDesc):
            out.append(s)
        else:
            out.append(DataDesc(s[0], s[1], *s[2:]))
    return out


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad, shared_group=None,
                 logger=logging, fixed_param_names=None, grad_req="write",
                 state_names=None):
        self.symbol = symbol
        self.contexts = list(contexts)
        if len(self.contexts) != 1:
            raise MXNetError(
                f"{len(self.contexts)} contexts: data parallelism over several "
                "devices is not yet ported to mxnet_tpu_torch (ROADMAP.md "
                "queue 1 item 7)")
        self.workload = workload
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.logger = logger
        self.fixed_param_names = set(fixed_param_names or [])
        self.state_names = set(state_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.shared_group = shared_group

        self.grad_req = {}
        for name in self.arg_names:
            if name in self.param_names:
                self.grad_req[name] = (
                    "null" if name in self.fixed_param_names or not for_training
                    else (grad_req if isinstance(grad_req, str)
                          else grad_req.get(name, "write")))
            elif name in self.state_names:
                self.grad_req[name] = "null"
            else:  # data/label inputs
                self.grad_req[name] = (
                    "write" if inputs_need_grad and for_training else "null")
        self.bind_exec(data_shapes, label_shapes, shared_group)

    @property
    def execs(self):
        return [self._exec]

    def bind_exec(self, data_shapes, label_shapes, shared_group=None,
                  reshape=False):
        self.data_shapes = _as_desc_list(data_shapes)
        self.label_shapes = _as_desc_list(label_shapes) if label_shapes else []
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [d.name for d in self.label_shapes]
        self.batch_size = self.data_shapes[0].shape[0]
        shape_kwargs = {d.name: d.shape for d in self.data_shapes}
        shape_kwargs.update({d.name: d.shape for d in self.label_shapes})
        # complete partial __shape__ hints (0 = batch) on the other input
        # arguments — RNN begin states — with the batch size, as the
        # reference's binder does
        attrs = self.symbol.attr_dict()
        axis = DataDesc.get_batch_axis(self.data_shapes[0].layout)
        bsz = self.data_shapes[0].shape[max(axis, 0)]
        for name in self.arg_names:
            hint = attrs.get(name, {}).get("__shape__")
            if name in shape_kwargs or name in self.param_names or not hint:
                continue
            shape = parse_shape(hint)
            if shape:
                shape_kwargs[name] = tuple(bsz if d == 0 else d
                                           for d in shape)
        type_kwargs = {d.name: d.dtype for d in self.data_shapes}
        type_kwargs.update({d.name: d.dtype for d in self.label_shapes})
        shared_exec = shared_group._exec if shared_group is not None else None
        if shared_exec is None and reshape and \
                getattr(self, "_exec", None) is not None:
            # a reshape of a live group keeps its trained parameters
            shared_exec = self._exec
        self._exec = Executor.simple_bind(
            self.symbol, self.contexts[0], grad_req=self.grad_req,
            type_dict=type_kwargs, shared_exec=shared_exec, **shape_kwargs)
        self.slices = [slice(0, self.batch_size)]

    def reshape(self, data_shapes, label_shapes):
        if (_as_desc_list(data_shapes) == self.data_shapes and
                _as_desc_list(label_shapes or []) == self.label_shapes):
            return
        self.bind_exec(data_shapes, label_shapes, self.shared_group,
                       reshape=True)

    # ------------------------------------------------------------------
    def set_params(self, arg_params, aux_params, allow_extra=False):
        self._exec.copy_params_from(arg_params, aux_params,
                                    allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        for name in self.param_names:
            if name in self._exec.arg_dict:
                if name in arg_params:
                    self._exec.arg_dict[name].copyto(arg_params[name])
                else:
                    arg_params[name] = self._exec.arg_dict[name].copy()
        for name in self.aux_names:
            if name in aux_params:
                self._exec.aux_dict[name].copyto(aux_params[name])
            else:
                aux_params[name] = self._exec.aux_dict[name].copy()

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        feed = dict(zip(self.data_names, data_batch.data))
        if self.label_shapes and data_batch.label is not None:
            feed.update(zip(self.label_names, data_batch.label))
        feed = {k: v for k, v in feed.items() if k in self._exec.arg_dict}
        self._exec.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run backward")
        self._exec.backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        outs = self._exec.outputs
        return outs if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        grads = [self._exec.grad_dict.get(n) for n in self.data_names]
        return grads if merge_multi_context else [[g] for g in grads]

    @property
    def grad_arrays(self):
        return [[self._exec.grad_dict.get(n)] for n in self.param_names
                if n in self._exec.arg_dict]

    @property
    def param_arrays(self):
        return [[self._exec.arg_dict[n]] for n in self.param_names
                if n in self._exec.arg_dict]

    @property
    def aux_arrays(self):
        return [[self._exec.aux_dict[n]] for n in self.aux_names]

    def update_metric(self, eval_metric, labels):
        # on-device accumulation: no per-batch host sync
        eval_metric.device_update(labels, self.get_outputs())

    # ------------------------------------------------------------------
    def has_pending_backward(self):
        return self._exec._grads_fresh

    def update_fused(self, optimizer, updater):
        """Apply the optimizer to every parameter with a gradient in one
        ``Executor.fused_train_update`` call (one multi-tensor kernel
        launch); the states stay in ``updater.states`` as the NDArrays the
        imperative path uses, next to their weights."""
        exe = self._exec
        host = getattr(self, "_fused_host", None)
        if host is not None and (
                host["ids"] != (id(exe), id(optimizer), id(updater))
                or any(updater.states.get(i) is not st
                       for i, st in zip(host["keys"], host["states"]))):
            host = None  # rebound, or set_states replaced the states
        if host is None:
            keys, names = [], []
            for i, n in enumerate(self.param_names):
                if n not in exe.arg_dict or exe.grad_req.get(n) == "null":
                    continue
                w = exe.arg_dict[n]
                st = updater.states.get(i)
                if st is None and i not in updater.states:
                    st = optimizer.create_state(i, w)
                st = _map_state(st, lambda a, w=w: a.as_in_context(w.context))
                updater.states[i] = st
                keys.append(i)
                names.append(n)
            host = {"ids": (id(exe), id(optimizer), id(updater)),
                    "keys": keys, "names": names,
                    "states": [updater.states[i] for i in keys]}
            self._fused_host = host
        keys = host["keys"]
        for i in keys:
            optimizer._update_count(i)
        lrs = [optimizer._get_lr(i) for i in keys]
        wds = [optimizer._get_wd(i) for i in keys]
        ts = [optimizer._index_update_count[i] for i in keys]
        try:
            exe.fused_train_update(host["names"], optimizer.torch_apply,
                                   host["states"], lrs, wds, ts)
        except Exception:
            # a retried or imperative update must see the same counts
            for i in keys:
                optimizer._index_update_count[i] -= 1
            optimizer.num_update = max(
                [optimizer.begin_num_update]
                + list(optimizer._index_update_count.values()))
            raise
