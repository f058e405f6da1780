"""Neural-network layer operators.

Counterpart of ``mxnet_tpu/ops/defs_nn.py`` for the ops of the ResNet
path: FullyConnected, Convolution, Activation, BatchNorm, Pooling and
SoftmaxOutput, forward and backward; and of the SSD path's
L2Normalization (its channel mode on the ``l2norm_channel`` kernel) and
SoftmaxActivation, at inference. Convolution and FullyConnected are
cuDNN/cuBLAS calls through torch, as the JAX package leaves them to XLA;
float32 runs without TF32 (``mxnet_tpu_torch/__init__.py`` clears both
flags), matching the reference's ``precision=HIGHEST``. BatchNorm (with the ReLU the executor
fuses into it) and SoftmaxOutput run the port's hand-written kernels
(:mod:`mxnet_tpu_torch.kernels`): at inference ``bn_act`` and
``softmax_rows``; in training the same forward kernels behind a
``torch.autograd.Function`` — with ``bn_stats`` for the batch statistics —
whose backward is ``bn_act_bwd`` and ``softmax_output_bwd``. The other ops
are differentiated by autograd.
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
from ..kernels.bn_act_bwd import bn_act_bwd
from ..kernels.bn_stats import bn_stats
from ..kernels.softmax_output_bwd import softmax_output_bwd
from ..kernels.l2norm_channel import l2norm_channel
from ..kernels.multibox_decode import channel_softmax
from ..kernels.softmax_rows import softmax, softmax_rows
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
class _BatchNormAct(torch.autograd.Function):
    """Training BatchNorm (+ the fused ReLU) over given statistics: the
    forward is ``bn_act``, the backward ``bn_act_bwd``. ``kvar`` (the clamp
    derivative from ``bn_stats``) marks batch statistics; None means the
    moving statistics (``use_global_stats``), which do not depend on x."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mean, var, kvar, eps, fix_gamma, relu):
        y = bn_act(x, mean, var, gamma, beta, eps, fix_gamma, relu)
        ctx.save_for_backward(x, y if relu else None, mean, var, gamma, kvar)
        ctx.cfg = (eps, fix_gamma, relu)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, mean, var, gamma, kvar = ctx.saved_tensors
        eps, fix_gamma, relu = ctx.cfg
        dx, dgamma, dbeta = bn_act_bwd(dy.contiguous(), y, x, mean, var,
                                       gamma, kvar, eps, fix_gamma, relu)
        return dx, dgamma, dbeta, None, None, None, None, None, None


def batch_norm(ins, params, mode, relu=False):
    """BatchNorm, with the following ReLU fused in when ``relu`` (the
    executor's BatchNorm -> Activation route). At inference it normalizes
    over the moving statistics. In training it takes the anchored batch
    statistics (``bn_stats``, which updates the moving statistics in place
    — once per forward, as the reference does) unless
    ``use_global_stats``. Returns the op protocol's ``(outputs, new_aux)``."""
    data, gamma, beta, moving_mean, moving_var = ins
    if params["axis"] != 1:
        raise MXNetError("BatchNorm: only axis=1 is ported")
    eps, fix_gamma = params["eps"], params["fix_gamma"]
    if not mode.is_train:
        out = bn_act(data, moving_mean, moving_var, gamma, beta, eps,
                     fix_gamma, relu)
        return [out, moving_mean, moving_var], [moving_mean, moving_var]
    if params["output_mean_var"]:
        raise MXNetError("BatchNorm: output_mean_var=True in training is not "
                         "yet ported to mxnet_tpu_torch")
    if params["use_global_stats"]:
        mean, var, kvar = moving_mean, moving_var, None
    else:
        with torch.no_grad():
            mean, var, kvar = bn_stats(data.detach(), moving_mean,
                                       moving_var, params["momentum"])
    out = _BatchNormAct.apply(data, gamma, beta, mean, var, kvar, eps,
                              fix_gamma, relu)
    return [out, mean, var], [moving_mean, moving_var]


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


# --- L2Normalization, SoftmaxActivation ----------------------------------
def no_kernel_grad(x, what):
    """Raise where autograd would need the backward of a kernel that has
    none yet (a CUDA tensor recorded for training)."""
    if x.device.type == "cuda" and x.requires_grad and torch.is_grad_enabled():
        raise MXNetError(f"{what}: the backward of its CUDA kernel is not yet "
                         "ported (ROADMAP.md queue 1, SSD training)")


def _l2_normalization(ins, params, mode):
    """``x / sqrt(sum(x^2) + eps)`` over the mode's axes; ``channel`` runs
    the ``l2norm_channel`` kernel (scale 1)."""
    (x,) = ins
    eps, m = params["eps"], params["mode"]
    if m == "channel":
        no_kernel_grad(x, "L2Normalization(mode='channel')")
        return l2norm_channel(x, eps)
    if m == "instance":
        axes = tuple(range(1, x.dim()))
    elif m == "spatial":
        axes = tuple(range(2, x.dim()))
    else:
        raise MXNetError(f"L2Normalization: unknown mode {m}")
    sq = x * x
    total = torch.sum(sq, dim=axes, keepdim=True) if axes else sq
    return x / torch.sqrt(total + eps)


register(
    "L2Normalization",
    _l2_normalization,
    arg_names=["data"],
    param_schema={
        "eps": Param(parse_float, 1e-10),
        "mode": Param(parse_str, "instance"),
    },
)


def _softmax_activation(ins, params, mode):
    """``channel``: the softmax over axis 1 (one ``jax.nn.softmax`` in the
    reference); ``instance``: over each flattened sample, through
    ``softmax_rows``."""
    (x,) = ins
    if params["mode"] == "channel":
        return channel_softmax(x)
    no_kernel_grad(x, "SoftmaxActivation(mode='instance')")
    rows = x.reshape(x.shape[0], -1).contiguous()
    return softmax_rows(rows).reshape(x.shape)


register(
    "SoftmaxActivation",
    _softmax_activation,
    arg_names=["data"],
    param_schema={"mode": Param(parse_str, "instance")},
)


# --- SoftmaxOutput ---------------------------------------------------------
def _softmax_forward(data, params):
    if params["multi_output"]:
        return softmax(data, 1)
    if params["preserve_shape"]:
        return softmax(data, -1)
    return softmax(data.reshape(data.shape[0], -1), -1).reshape(data.shape)


class _SoftmaxOutputLoss(torch.autograd.Function):
    """SoftmaxOutput in training: forward ``softmax_rows``, backward the
    loss layer's ``softmax_output_bwd``, which ignores the head gradient."""

    @staticmethod
    def forward(ctx, data, label, params):
        p = _softmax_forward(data, params)
        ctx.save_for_backward(p, label)
        ctx.params = params
        return p

    @staticmethod
    def backward(ctx, _head_grad):
        p, label = ctx.saved_tensors
        q = ctx.params
        if not q["multi_output"] and not q["preserve_shape"] and p.dim() != 2:
            raise MXNetError(
                "SoftmaxOutput backward: data of rank > 2 needs multi_output "
                "or preserve_shape (the reference's one-hot fails there too)")
        grad = softmax_output_bwd(
            p, label, q["grad_scale"], q["ignore_label"], q["use_ignore"],
            q["normalization"], q["multi_output"])
        return grad, None, None


def _softmax_output(ins, params, mode):
    """SoftmaxOutput: the class-axis softmax; in training the loss-layer
    backward ``(p - onehot(label)) * grad_scale`` (reference
    ``softmax_output-inl.h``)."""
    data, label = ins
    if mode.is_train:
        return _SoftmaxOutputLoss.apply(data, label, params)
    return _softmax_forward(data, params)


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
