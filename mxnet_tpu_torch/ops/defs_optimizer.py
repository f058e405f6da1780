"""Optimizer update operators (the SGD subset).

Counterpart of ``mxnet_tpu/ops/defs_optimizer.py:1-72``: ``sgd_update`` and
``sgd_mom_update`` as registered ops, following the reference's gradient
preprocessing ``_prep_grad`` (rescale, clip, then ``wd * weight`` outside
the clip). Each op body runs the multi-tensor kernel ``sgd_mom_multi`` over
its one parameter, on copies, so the op stays functional; ``mx.nd`` calls
with ``out=weight`` write the result back, and ``sgd_mom_update`` writes
the new momentum into its ``mom`` input (``mutate``). The fused training
step calls the kernel once over every parameter instead
(:meth:`mxnet_tpu_torch.optimizer.SGD.torch_apply`). ``adam_update``,
``rmsprop_update`` and ``rmspropalex_update`` are not yet ported.
"""

from __future__ import annotations

from ..base import parse_float
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
