"""``l2norm_channel``: L2 normalization over the channel axis, with a fused
scale.

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
"""

from __future__ import annotations

import math

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version)
LAUNCHES = _tm.counter("kernel.l2norm_channel.launches")


def l2norm_channel_plain(x, eps, scale=1.0):
    """The plain PyTorch version: ``(x / sqrt(sum_c x^2 + eps)) * scale``,
    the reference's formula op by op (the scale only when it is not 1)."""
    y = x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)
    return y * scale if scale != 1.0 else y


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
    if x.dtype != torch.float32 or x.dim() < 2 or not x.is_contiguous():
        raise MXNetError(
            f"l2norm_channel: kernel takes a contiguous float32 (N, C, ...) "
            f"tensor, got {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()}")
    n, c, hw = x.shape[0], x.shape[1], math.prod(x.shape[2:])
    if (n * hw + 31) // 32 >= 2 ** 31:
        raise MXNetError(f"l2norm_channel: {n * hw} positions exceed the "
                         "kernel's grid")
    y = torch.empty_like(x)
    lib = _lib.library()
    with torch.cuda.device(x.device):
        err = lib.mxt_l2norm_channel_f32(
            x.data_ptr(), y.data_ptr(), n, c, hw, float(eps), float(scale),
            _lib.stream_of(x))
    _lib.check(err, "l2norm_channel")
    LAUNCHES.inc()
    return y
