"""Optimizers (SGD and Adam).

Counterpart of ``mxnet_tpu/optimizer.py`` (reference
``python/mxnet/optimizer.py``): the ``Optimizer`` base with the
reference's lr/wd multiplier resolution (per-optimizer dicts > symbol
``__lr_mult__``/``__wd_mult__`` attributes > the bias/gamma/beta
heuristic), ``SGD``, ``Adam``, ``create``/``register``, ``Updater`` and
``get_updater``.

``update`` is the imperative per-parameter path (``nd.sgd_mom_update``,
``nd.adam_update`` with ``out=weight``). ``torch_apply`` is the
counterpart of ``jax_apply`` for the fused training step: where the JAX
package traces one update per parameter into the step's XLA program, the
port updates every parameter in one launch of a multi-tensor kernel
(:mod:`mxnet_tpu_torch.kernels.sgd_mom_multi`,
:mod:`mxnet_tpu_torch.kernels.adam_multi`). The other optimizers of the
JAX package (RMSProp, NAG, AdaGrad, ...) are not yet ported.
"""

from __future__ import annotations

import math
import pickle

import numpy as np

from .kernels.adam_multi import adam_multi
from .kernels.sgd_mom_multi import sgd_mom_multi
from .ndarray import (NDArray, adam_update, array, sgd_mom_update, sgd_update,
                      zeros)


class Optimizer:
    """Base optimizer (reference ``Optimizer``)."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        name = klass.__name__.lower()
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError(f"Cannot find optimizer {name} (mxnet_tpu_torch "
                         f"has {sorted(Optimizer.opt_registry)})")

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        if param_idx2name is not None and not isinstance(param_idx2name,
                                                         dict):
            raise TypeError(
                "param_idx2name should be a dict of param indexes to names."
            )
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.wd = wd
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        # num_update drives schedules; per-index counts drive bias correction
        self.num_update = self.begin_num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    # One update of every parameter for the fused training step, in place:
    # ``torch_apply(weights, grads, states, lrs, wds, ts, cache=, guard=)``
    # over lists of tensors. None: this optimizer only has the imperative
    # per-parameter path.
    torch_apply = None

    def _clip(self):
        return self.clip_gradient if self.clip_gradient is not None else -1.0

    def _sym_mults(self, attr_key):
        """Per-param multipliers declared as symbol attributes."""
        if self.sym is None:
            return {}
        attrs = self.sym.attr_dict()
        return {
            name: float(attrs[name][attr_key])
            for name in self.sym.list_arguments()
            if attr_key in attrs.get(name, ())
        }

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._sym_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # heuristic tier: biases and BN scale/shift take no weight decay
        self.wd_mult = {
            n: 0.0 for n in self.idx2name.values()
            if not n.endswith(("_weight", "_gamma"))
        }
        self.wd_mult.update(self._sym_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd


register = Optimizer.register


@register
class SGD(Optimizer):
    """SGD with momentum, on the ``sgd_mom_multi`` kernel."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                      rescale_grad=self.rescale_grad,
                      clip_gradient=self._clip())
        if state is not None:
            sgd_mom_update(weight, grad, state, out=weight,
                           momentum=self.momentum, **kwargs)
        else:
            sgd_update(weight, grad, out=weight, **kwargs)

    def torch_apply(self, weights, grads, states, lrs, wds, ts, cache=None,
                    guard=None):
        moms = None if self.momentum == 0.0 else [s._data for s in states]
        sgd_mom_multi(weights, grads, moms, lrs, wds, self.momentum,
                      self.rescale_grad, self._clip(), guard=guard,
                      cache=cache)
        return states


@register
class Adam(Optimizer):
    """Adam (reference ``Adam``), on the ``adam_multi`` kernel."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                zeros(weight.shape, ctx=weight.context, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        # the bias correction in double, as the reference's imperative path
        lr = self._get_lr(index) * math.sqrt(1.0 - self.beta2 ** t) \
            / (1.0 - self.beta1 ** t)
        mean, var = state
        adam_update(weight, grad, mean, var, out=weight, lr=lr,
                    wd=self._get_wd(index), beta1=self.beta1,
                    beta2=self.beta2, epsilon=self.epsilon,
                    rescale_grad=self.rescale_grad,
                    clip_gradient=self._clip())

    def lr_t(self, lr, t):
        """The bias-corrected rate of the fused step, in float32 as
        ``jax_apply`` computes it: ``lr * sqrt(1 - beta2^t) / (1 -
        beta1^t)``."""
        one, t = np.float32(1.0), np.float32(t)
        return float(np.float32(lr)
                     * np.sqrt(one - np.float32(self.beta2) ** t)
                     / (one - np.float32(self.beta1) ** t))

    def torch_apply(self, weights, grads, states, lrs, wds, ts, cache=None,
                    guard=None):
        adam_multi(weights, grads, [s[0]._data for s in states],
                   [s[1]._data for s in states],
                   [self.lr_t(lr, t) for lr, t in zip(lrs, ts)], wds,
                   self.beta1, self.beta2, self.epsilon, self.rescale_grad,
                   self._clip(), guard=guard, cache=cache)
        return states


create = Optimizer.create_optimizer


class Updater:
    """Applies an optimizer per key with lazily created state (reference
    ``Updater``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.states[index] = _map_state(
            self.states[index], lambda nd: nd.as_in_context(weight.context))
        self.optimizer.update(index, weight, grad, self.states[index])

    def set_states(self, states):
        """Load states written by :meth:`get_states` (either package's)
        onto the current context; the first update moves each next to its
        weight."""
        raw = pickle.loads(states)
        self.states = {k: _map_state(v, lambda a: array(a, dtype=a.dtype))
                       for k, v in raw.items()}

    def get_states(self):
        return pickle.dumps({k: _map_state(v, NDArray.asnumpy)
                             for k, v in self.states.items()})


def _map_state(st, f):
    """Map ``f`` over the leaves of an optimizer-state tree; a tuple whose
    leaves all map to themselves comes back as the same object."""
    if st is None:
        return None
    if isinstance(st, (list, tuple)):
        new = tuple(_map_state(x, f) for x in st)
        return st if all(a is b for a, b in zip(new, st)) else new
    if isinstance(st, (NDArray, np.ndarray)):
        return f(st)
    return st


def get_updater(optimizer):
    return Updater(optimizer)
