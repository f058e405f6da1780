"""``bn_act``: BatchNorm's normalize and affine with an optional fused
(leaky) ReLU.

Replaces the normalize and affine of ``mxnet_tpu/ops/defs_nn.py``
``_batch_norm`` (:394, over the moving or the batch statistics) together
with the ``Activation(relu)`` or ``LeakyReLU(act_type="leaky", slope=s)``
(``_leaky_relu``, :336-345) that follows it, which XLA fuses into one pass
and eager PyTorch would run as a chain of launches. The activation is
``where(t > 0, t, slope * t)``; the ReLU is slope 0 (and gives +0.0 for
negative ``t``), and ``slope=None`` means no activation.

On the ResNet-50 serving path (BatchNorm folded) 17 BatchNorms cannot fold,
because a residual add or the max-pool produces their input; each is
followed by a ReLU, so the executor routes the pair here with ``slope=0``.
DCGAN's discriminator routes its three BatchNorm -> LeakyReLU(0.2) pairs
here with ``slope=0.2``, which runs under its own kernel name.

Bound on the H100: device-memory bandwidth. Each element is read once and
written once (8 bytes) for five flops. The kernel
(``csrc/bn_act.cu``) gives each (n, c) plane to one warp, which computes
the channel's constants once and streams the plane with 16-byte vector
loads and stores, with scalar head and tail so planes whose H*W is not a
multiple of 4 (7*7 = 49) stay on the vector path for most elements. The
arithmetic keeps the reference's order ``((x - mean) * rsqrt(var + eps))
* gamma + beta`` without FMA contraction, so results agree at float32
rounding.
"""

from __future__ import annotations

import math

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version); the leaky ones
# (slope > 0) count in both
LAUNCHES = _tm.counter("kernel.bn_act.launches")
LEAKY_LAUNCHES = _tm.counter("kernel.bn_act_leaky.launches")


def bn_act_plain(x, mean, var, gamma, beta, eps, fix_gamma, slope=None):
    """The plain PyTorch version: the reference formula, op by op."""
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    inv = torch.rsqrt(var.to(torch.float32) + eps).to(x.dtype)
    y = (x - mean.to(x.dtype).reshape(bshape)) * inv.reshape(bshape) \
        * gamma.to(x.dtype).reshape(bshape) + beta.to(x.dtype).reshape(bshape)
    if slope is None:
        return y
    return torch.where(y > 0, y, slope * y) if slope else torch.relu(y)


def bn_act(x, mean, var, gamma, beta, eps, fix_gamma, slope=None):
    """``t = (x - mean) * rsqrt(var + eps) * gamma + beta`` over channel
    axis 1, then unless ``slope`` is None ``where(t > 0, t, slope * t)``
    (slope 0: the ReLU); gamma is 1 under ``fix_gamma``. ``slope`` must be
    None or >= 0.

    A CPU (or shape-only ``meta``) tensor takes the plain version. A CUDA
    tensor launches the kernel, which takes a contiguous float32 ``x`` of
    rank >= 2 and contiguous float32 ``(C,)`` statistics on the same
    device; anything else raises :class:`MXNetError`.
    """
    if slope is not None and not slope >= 0:
        raise MXNetError(f"bn_act: slope must be None or >= 0, got {slope}")
    if x.device.type in ("cpu", "meta"):
        return bn_act_plain(x, mean, var, gamma, beta, eps, fix_gamma, slope)
    if x.device.type != "cuda":
        raise MXNetError(f"bn_act: no kernel for device {x.device}")
    if x.dtype != torch.float32 or x.dim() < 2 or not x.is_contiguous():
        raise MXNetError(
            f"bn_act: kernel takes a contiguous float32 (N, C, ...) tensor, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    n, c = x.shape[0], x.shape[1]
    for name, t in (("mean", mean), ("var", var), ("gamma", gamma),
                    ("beta", beta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or not t.is_contiguous() or t.device != x.device):
            raise MXNetError(
                f"bn_act: {name} must be a contiguous float32 ({c},) tensor "
                f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    y = torch.empty_like(x)
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise MXNetError("bn_act: kernel needs 16-byte aligned x and y")
    hw = math.prod(x.shape[2:])
    if (n * c + 7) // 8 >= 2 ** 31:
        raise MXNetError(f"bn_act: {n * c} planes exceed the kernel's grid")
    lib = _lib.library()
    with torch.cuda.device(x.device):
        err = lib.mxt_bn_act_f32(
            x.data_ptr(), mean.data_ptr(), var.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), y.data_ptr(), n, c, hw, float(eps),
            int(bool(fix_gamma)), _lib.c_slope(slope),
            torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(err, "bn_act")
    LAUNCHES.inc()
    if slope:
        LEAKY_LAUNCHES.inc()
    return y
