"""Optimizer update operators.

Counterpart of ``mxnet_tpu/ops/defs_optimizer.py``: ``sgd_update``,
``sgd_mom_update``, ``adam_update``, ``rmsprop_update`` and
``rmspropalex_update`` as registered ops, following the reference's
gradient preprocessing ``_prep_grad`` (rescale, clip, then ``wd * weight``
outside the clip for SGD and RMSProp; ``wd * weight`` before the clip for
Adam). Each op body runs a multi-tensor kernel (``sgd_mom_multi``,
``adam_multi``, ``rmsprop_multi``) over its one parameter, on copies, so
the op stays functional; ``mx.nd`` calls with ``out=weight`` write the
result back, and the ops write their new optimizer state into their state
inputs (``mutate``). The fused training step calls the kernel once over
every parameter instead (``torch_apply`` of
:mod:`mxnet_tpu_torch.optimizer`).
"""

from __future__ import annotations

from ..base import parse_float
from ..kernels.adam_multi import adam_multi
from ..kernels.rmsprop_multi import rmsprop_multi
from ..kernels.sgd_mom_multi import sgd_mom_multi
from .registry import Param, register


def _common_schema():
    return {
        "lr": Param(parse_float),
        "wd": Param(parse_float, 0.0),
        "rescale_grad": Param(parse_float, 1.0),
        "clip_gradient": Param(parse_float, -1.0),
    }


def _sgd_update(ins, params, mode):
    weight, grad = ins
    w = weight.clone()
    sgd_mom_multi([w], [grad], None, [params["lr"]], [params["wd"]], 0.0,
                  params["rescale_grad"], params["clip_gradient"])
    return w


register(
    "sgd_update",
    _sgd_update,
    arg_names=["weight", "grad"],
    param_schema=_common_schema(),
)


def _sgd_mom_update(ins, params, mode):
    weight, grad, mom = ins
    w, m = weight.clone(), mom.clone()
    sgd_mom_multi([w], [grad], [m], [params["lr"]], [params["wd"]],
                  params["momentum"], params["rescale_grad"],
                  params["clip_gradient"])
    return [w, m]


register(
    "sgd_mom_update",
    _sgd_mom_update,
    arg_names=["weight", "grad", "mom"],
    param_schema={**_common_schema(), "momentum": Param(parse_float, 0.0)},
    num_outputs=2,
    num_visible_outputs=1,
    mutate=[("mom", 1)],
)


def _adam_update(ins, params, mode):
    weight, grad, mean, var = ins
    w, m, v = weight.clone(), mean.clone(), var.clone()
    adam_multi([w], [grad], [m], [v], [params["lr"]], [params["wd"]],
               params["beta1"], params["beta2"], params["epsilon"],
               params["rescale_grad"], params["clip_gradient"])
    return [w, m, v]


register(
    "adam_update",
    _adam_update,
    arg_names=["weight", "grad", "mean", "var"],
    param_schema={
        **_common_schema(),
        "beta1": Param(parse_float, 0.9),
        "beta2": Param(parse_float, 0.999),
        "epsilon": Param(parse_float, 1e-8),
    },
    num_outputs=3,
    num_visible_outputs=1,
    mutate=[("mean", 1), ("var", 2)],
)


def _rmsprop_update(ins, params, mode):
    weight, grad, n = ins
    w, n = weight.clone(), n.clone()
    rmsprop_multi([w], [grad], [n], [params["lr"]], [params["wd"]],
                  params["gamma1"], params["epsilon"], params["rescale_grad"],
                  params["clip_gradient"], params["clip_weights"])
    return [w, n]


register(
    "rmsprop_update",
    _rmsprop_update,
    arg_names=["weight", "grad", "n"],
    param_schema={
        **_common_schema(),
        "gamma1": Param(parse_float, 0.95),
        "epsilon": Param(parse_float, 1e-8),
        "clip_weights": Param(parse_float, -1.0),
    },
    num_outputs=2,
    num_visible_outputs=1,
    mutate=[("n", 1)],
)


def _rmspropalex_update(ins, params, mode):
    weight, grad, n, g, delta = ins
    w, n, g, delta = weight.clone(), n.clone(), g.clone(), delta.clone()
    rmsprop_multi([w], [grad], [n], [params["lr"]], [params["wd"]],
                  params["gamma1"], params["epsilon"], params["rescale_grad"],
                  params["clip_gradient"], params["clip_weights"], gms=[g],
                  deltas=[delta], gamma2=params["gamma2"])
    return [w, n, g, delta]


register(
    "rmspropalex_update",
    _rmspropalex_update,
    arg_names=["weight", "grad", "n", "g", "delta"],
    param_schema={
        **_common_schema(),
        "gamma1": Param(parse_float, 0.95),
        "gamma2": Param(parse_float, 0.9),
        "epsilon": Param(parse_float, 1e-8),
        "clip_weights": Param(parse_float, -1.0),
    },
    num_outputs=4,
    num_visible_outputs=1,
    mutate=[("n", 1), ("g", 2), ("delta", 3)],
)
