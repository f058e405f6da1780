"""``l2norm_channel`` and ``l2norm_channel_bwd``: L2 normalization over the
channel axis, with a fused scale, forward and backward.

Replaces ``mxnet_tpu/ops/defs_nn.py`` ``_l2_normalization`` in mode
``"channel"`` (``x / sqrt(sum_c x^2 + eps)``) together with the ``* 20.0``
that follows it on the SSD path (``mxnet_tpu/models/ssd.py:132-133``),
which XLA fuses into one pass and eager PyTorch would run as a square, a
sum, an add, a sqrt, a divide and a multiply. The executor routes an
``L2Normalization(mode="channel")`` whose only consumer is a
``_mul_scalar`` here with the scale fused (``executor._fused_l2norm``);
the op alone runs the same kernel with scale 1.

Bound on the H100: device-memory bandwidth. At SSD-300's conv4_3,
(8, 512, 37, 37) float32, the function reads 22.4 MB and writes 22.4 MB.
``csrc/l2norm_channel.cu`` gives each (n, h*w) position 16 threads, each
summing every 16th channel with stride H*W, so the threads of a warp read
neighbouring addresses; the partial sums are added in a fixed order, and
the square, the sum, the sqrt, the division and the scale are each rounded
once, in the reference's order.

In training :class:`L2NormChannelFn` runs the forward kernel and, as its
backward, ``csrc/l2norm_channel_bwd.cu``: the VJP ``dx = s * g / n - x *
(s * sum_c g * x) / n^3`` (``n = sqrt(sum_c x^2 + eps)``), in the same
layout, one pass that sums ``x^2`` and ``g * x`` per position and a second
over the same channels (in L2) that writes ``dx``. It recomputes the norm,
so the forward keeps its single output. At SSD-300's conv4_3 in training,
(32, 512, 37, 37), it reads 179 MB and writes 90 MB. Its order of
operations is not ``jax.vjp``'s: against :func:`l2norm_channel_bwd_plain`
(which is) it agrees to ``BWD_RTOL`` of each value plus ``BWD_ATOL`` of the
largest, since ``s * g / n`` and the projection term cancel where ``g``
lies along ``x``.
"""

from __future__ import annotations

import math

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# count kernel launches only (never the plain versions)
LAUNCHES = _tm.counter("kernel.l2norm_channel.launches")
BWD_LAUNCHES = _tm.counter("kernel.l2norm_channel_bwd.launches")
# the backward kernel against its plain version (float32): |got - want| <=
# BWD_RTOL * |want| + BWD_ATOL * max|want|
BWD_RTOL, BWD_ATOL = 1e-5, 1e-6


def l2norm_channel_plain(x, eps, scale=1.0):
    """The plain PyTorch version: ``(x / sqrt(sum_c x^2 + eps)) * scale``,
    the reference's formula op by op (the scale only when it is not 1)."""
    y = x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)
    return y * scale if scale != 1.0 else y


def l2norm_channel_bwd_plain(x, g, eps, scale=1.0):
    """The plain PyTorch version of the backward, in ``jax.vjp``'s order of
    operations for the reference's formula followed by ``* scale``."""
    gs = g * scale if scale != 1.0 else g
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)
    dnorm = torch.sum(-gs * x * (1.0 / (norm * norm)), dim=1, keepdim=True)
    return gs / norm + (dnorm * (0.5 / norm)) * (2.0 * x)


def _check_layout(name, x):
    if x.dtype != torch.float32 or x.dim() < 2 or not x.is_contiguous():
        raise MXNetError(
            f"{name}: kernel takes a contiguous float32 (N, C, ...) "
            f"tensor, got {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()}")
    n, c, hw = x.shape[0], x.shape[1], math.prod(x.shape[2:])
    if (n * hw + 31) // 32 >= 2 ** 31:
        raise MXNetError(f"{name}: {n * hw} positions exceed the kernel's "
                         "grid")
    return n, c, hw


def l2norm_channel(x, eps, scale=1.0):
    """``(x / sqrt(sum_c x^2 + eps)) * scale`` over axis 1 of ``x``.

    A CPU (or shape-only ``meta``) tensor takes the plain version. A CUDA
    tensor launches the kernel, which takes a contiguous float32 tensor of
    rank >= 2; anything else raises :class:`MXNetError`.
    """
    if x.device.type in ("cpu", "meta"):
        return l2norm_channel_plain(x, eps, scale)
    if x.device.type != "cuda":
        raise MXNetError(f"l2norm_channel: no kernel for device {x.device}")
    n, c, hw = _check_layout("l2norm_channel", x)
    y = torch.empty_like(x)
    lib = _lib.library()
    with torch.cuda.device(x.device):
        err = lib.mxt_l2norm_channel_f32(
            x.data_ptr(), y.data_ptr(), n, c, hw, float(eps), float(scale),
            _lib.stream_of(x))
    _lib.check(err, "l2norm_channel")
    LAUNCHES.inc()
    return y


def l2norm_channel_bwd(x, g, eps, scale=1.0):
    """The gradient of ``(x / sqrt(sum_c x^2 + eps)) * scale`` (axis 1)
    with respect to ``x``, given the output's gradient ``g``.

    A CPU (or ``meta``) tensor takes the plain version. A CUDA tensor
    launches the kernel, which takes contiguous float32 ``x`` and ``g`` of
    one shape (rank >= 2) on one device; anything else raises
    :class:`MXNetError`.
    """
    if x.device.type in ("cpu", "meta"):
        return l2norm_channel_bwd_plain(x, g, eps, scale)
    if x.device.type != "cuda":
        raise MXNetError(f"l2norm_channel_bwd: no kernel for device "
                         f"{x.device}")
    n, c, hw = _check_layout("l2norm_channel_bwd", x)
    _lib.check_f32("l2norm_channel_bwd: g", g, x.device, x.shape)
    dx = torch.empty_like(x)
    lib = _lib.library()
    with torch.cuda.device(x.device):
        err = lib.mxt_l2norm_channel_bwd_f32(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), n, c, hw, float(eps),
            float(scale), _lib.stream_of(x))
    _lib.check(err, "l2norm_channel_bwd")
    BWD_LAUNCHES.inc()
    return dx


class L2NormChannelFn(torch.autograd.Function):
    """The channel L2 normalization with a fused scale in training:
    forward :func:`l2norm_channel`, backward :func:`l2norm_channel_bwd`."""

    @staticmethod
    def forward(ctx, x, eps, scale):
        ctx.save_for_backward(x)
        ctx.eps, ctx.scale = eps, scale
        return l2norm_channel(x, eps, scale)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (l2norm_channel_bwd(x, g.contiguous(), ctx.eps, ctx.scale),
                None, None)
