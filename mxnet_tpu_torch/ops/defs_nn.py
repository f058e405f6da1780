"""Neural-network layer operators, forward at inference.

Counterpart of ``mxnet_tpu/ops/defs_nn.py`` for the ops of the ResNet
serving path: FullyConnected, Convolution, Activation, BatchNorm, Pooling
and SoftmaxOutput. Convolution and FullyConnected are cuDNN/cuBLAS calls
through torch, as the JAX package leaves them to XLA; float32 runs without
TF32 (``mxnet_tpu_torch/__init__.py`` clears both flags), matching the
reference's ``precision=HIGHEST``. The inference BatchNorm (with the ReLU
the executor fuses into it) and the SoftmaxOutput forward run the port's
hand-written kernels (:mod:`mxnet_tpu_torch.kernels`).

Training forward and every backward are not yet ported: a training-mode
BatchNorm raises :class:`MXNetError`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import (
    MXNetError,
    parse_bool,
    parse_float,
    parse_int,
    parse_shape,
    parse_str,
)
from ..kernels.bn_act import bn_act
from ..kernels.softmax_rows import softmax
from .registry import Param, register


def _castp(param, data):
    """Cast a parameter to the activation dtype (master weights stay f32)."""
    if param is not None and param.dtype != data.dtype:
        return param.to(data.dtype)
    return param


# --- FullyConnected --------------------------------------------------------
def _fc(ins, params, mode):
    if params["no_bias"]:
        data, weight = ins
        bias = None
    else:
        data, weight, bias = ins
    weight, bias = _castp(weight, data), _castp(bias, data)
    # flatten=False: FC applies to the LAST axis, leading dims kept
    x = data.reshape(data.shape[0], -1) if params["flatten"] else data
    return F.linear(x, weight, bias)


def _fc_fill(shapes, params):
    data = shapes[0]
    n = params["num_hidden"]
    if data is not None:
        in_dim = math.prod(data[1:]) if params["flatten"] else int(data[-1])
        if shapes[1] is None:
            shapes[1] = (n, in_dim)
    if not params["no_bias"] and shapes[2] is None:
        shapes[2] = (n,)
    return shapes


register(
    "FullyConnected",
    _fc,
    arg_names=lambda p: ["data", "weight"] + ([] if p["no_bias"] else ["bias"]),
    param_schema={
        "num_hidden": Param(parse_int),
        "no_bias": Param(parse_bool, False),
        "flatten": Param(parse_bool, True),
    },
    fill_in_shapes=_fc_fill,
)


# --- Convolution -----------------------------------------------------------
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv(ins, params, mode):
    """The plain convolution. The JAX op rewrites a 7x7/2 stem over <= 4
    channels by space-to-depth for the TPU's matrix unit; the result is the
    same convolution, so the port runs it as written."""
    if params["no_bias"]:
        data, weight = ins
        bias = None
    else:
        data, weight, bias = ins
    weight, bias = _castp(weight, data), _castp(bias, data)
    k = params["kernel"]
    nsp = len(k)
    if nsp not in _CONV:
        raise MXNetError(f"Convolution: {nsp}-D kernels are not supported")
    return _CONV[nsp](
        data, weight, bias,
        stride=params["stride"] or (1,) * nsp,
        padding=params["pad"] or (0,) * nsp,
        dilation=params["dilate"] or (1,) * nsp,
        groups=params["num_group"],
    )


def _conv_fill(shapes, params):
    data = shapes[0]
    k = params["kernel"]
    nf = params["num_filter"]
    ng = params["num_group"]
    if data is not None and shapes[1] is None:
        shapes[1] = (nf, data[1] // ng) + tuple(k)
    if not params["no_bias"] and shapes[2] is None:
        shapes[2] = (nf,)
    return shapes


register(
    "Convolution",
    _conv,
    arg_names=lambda p: ["data", "weight"] + ([] if p["no_bias"] else ["bias"]),
    param_schema={
        "kernel": Param(parse_shape),
        "stride": Param(parse_shape, None),
        "dilate": Param(parse_shape, None),
        "pad": Param(parse_shape, None),
        "num_filter": Param(parse_int),
        "num_group": Param(parse_int, 1),
        "no_bias": Param(parse_bool, False),
        "workspace": Param(parse_int, 1024),  # reference knob, unused
        "cudnn_tune": Param(parse_str, None),  # accepted for parity, unused
        "cudnn_off": Param(parse_bool, False),
        "layout": Param(parse_str, None),
    },
    fill_in_shapes=_conv_fill,
    aliases=("Convolution_v1",),
)


# --- Activation ------------------------------------------------------------
_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}


def _activation(ins, params, mode):
    return _ACTS[params["act_type"]](ins[0])


register(
    "Activation",
    _activation,
    arg_names=["data"],
    param_schema={"act_type": Param(parse_str)},
)


# --- BatchNorm -------------------------------------------------------------
def batch_norm(ins, params, mode, relu=False):
    """Inference BatchNorm over the moving statistics, with the following
    ReLU fused in when ``relu`` (the executor's BatchNorm -> Activation
    route). Returns the op protocol's ``(outputs, new_aux)``."""
    data, gamma, beta, moving_mean, moving_var = ins
    if mode.is_train and not params["use_global_stats"]:
        raise MXNetError(
            "BatchNorm: the training forward (batch statistics) is not yet "
            "ported to mxnet_tpu_torch")
    if params["axis"] != 1:
        raise MXNetError("BatchNorm: only axis=1 is ported")
    out = bn_act(data, moving_mean, moving_var, gamma, beta, params["eps"],
                 params["fix_gamma"], relu)
    return [out, moving_mean, moving_var], [moving_mean, moving_var]


def _bn_fill(shapes, params):
    data = shapes[0]
    if data is not None:
        c = (data[1],)
        for i in range(1, 5):
            if shapes[i] is None:
                shapes[i] = c
    return shapes


register(
    "BatchNorm",
    batch_norm,
    arg_names=["data", "gamma", "beta"],
    aux_names=["moving_mean", "moving_var"],
    param_schema={
        "eps": Param(parse_float, 1e-3),
        "momentum": Param(parse_float, 0.9),
        "fix_gamma": Param(parse_bool, True),
        "use_global_stats": Param(parse_bool, False),
        "output_mean_var": Param(parse_bool, False),
        "cudnn_off": Param(parse_bool, False),
        "axis": Param(parse_int, 1),
    },
    aliases=("BatchNorm_v1",),
    fill_in_shapes=_bn_fill,
    num_outputs=3,
    num_visible_outputs=lambda p: 3 if p["output_mean_var"] else 1,
)


# --- Pooling ---------------------------------------------------------------
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_SUM_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pooling(ins, params, mode):
    (x,) = ins
    nsp = x.dim() - 2
    if params["global_pool"]:
        k = tuple(x.shape[2:])
        stride = (1,) * nsp
        pad = (0,) * nsp
    else:
        k = params["kernel"]
        stride = params["stride"] or (1,) * nsp
        pad = params["pad"] or (0,) * nsp
    ptype = params["pool_type"]
    # explicit (lo, hi) padding per spatial axis, as the reference's
    # reduce_window takes it; "full" adds the ceil-mode remainder on hi
    pads = []
    for i in range(nsp):
        lo = hi = pad[i]
        if params["pooling_convention"] == "full" and not params["global_pool"]:
            size = x.shape[2 + i]
            full_out = -(-(size + 2 * pad[i] - k[i]) // stride[i]) + 1
            valid_out = (size + 2 * pad[i] - k[i]) // stride[i] + 1
            hi += (full_out - valid_out) * stride[i]
        pads.append((lo, hi))
    flat_pads = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad order
    if ptype == "max":
        if not x.is_floating_point():
            raise MXNetError("Pooling: max over integer data is not ported")
        xp = F.pad(x, flat_pads, value=-math.inf) if any(flat_pads) else x
        return _MAX_POOL[nsp](xp, k, stride)
    if ptype not in ("sum", "avg"):
        raise MXNetError(f"Pooling: unknown pool_type {ptype}")
    xf = x.to(torch.float32)
    if params["global_pool"]:
        summed = xf.sum(dim=tuple(range(2, x.dim())), keepdim=True)
    else:
        if nsp not in _SUM_POOL:
            raise MXNetError(f"Pooling: {nsp}-D sum/avg pooling is not ported")
        xp = F.pad(xf, flat_pads) if any(flat_pads) else xf
        summed = _SUM_POOL[nsp](xp, k, stride, divisor_override=1)
    if ptype == "sum":
        return summed.to(x.dtype)
    return (summed / float(math.prod(k))).to(x.dtype)


register(
    "Pooling",
    _pooling,
    arg_names=["data"],
    param_schema={
        "kernel": Param(parse_shape, ()),
        "pool_type": Param(parse_str, "max"),
        "global_pool": Param(parse_bool, False),
        "stride": Param(parse_shape, None),
        "pad": Param(parse_shape, None),
        "pooling_convention": Param(parse_str, "valid"),
        "cudnn_off": Param(parse_bool, False),
    },
    aliases=("Pooling_v1",),
)


# --- SoftmaxOutput ---------------------------------------------------------
def _softmax_output(ins, params, mode):
    """SoftmaxOutput forward: the class-axis softmax (the label only feeds
    the loss-layer backward, which is not yet ported)."""
    data, _label = ins
    if params["multi_output"]:
        return softmax(data, 1)
    if params["preserve_shape"]:
        return softmax(data, -1)
    return softmax(data.reshape(data.shape[0], -1), -1).reshape(data.shape)


def _softmax_output_fill(shapes, params):
    data = shapes[0]
    if data is not None and shapes[1] is None:
        if params["multi_output"]:
            shapes[1] = (data[0],) + tuple(data[2:])
        elif params["preserve_shape"]:
            shapes[1] = tuple(data[:-1])
        else:
            shapes[1] = (data[0],)
    return shapes


register(
    "SoftmaxOutput",
    _softmax_output,
    arg_names=["data", "label"],
    param_schema={
        "grad_scale": Param(parse_float, 1.0),
        "ignore_label": Param(parse_float, -1.0),
        "multi_output": Param(parse_bool, False),
        "use_ignore": Param(parse_bool, False),
        "preserve_shape": Param(parse_bool, False),
        "normalization": Param(parse_str, "null"),
        "out_grad": Param(parse_bool, False),
    },
    fill_in_shapes=_softmax_output_fill,
    aliases=("Softmax",),
    is_loss=True,
)
