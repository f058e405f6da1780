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
written once (8 bytes) for five flops. ``csrc/bn_act.cu`` makes one
launch a call, planned here by :func:`plan`: the grid covers the tensor's
elements flat, in 16-byte units where every plane starts on a 16-byte
boundary (regime ``vec``: H*W a multiple of 4, ``x`` and ``y`` aligned:
every DCGAN shape and every ResNet-50 shape but 7x7) and in 4-byte units
otherwise (regime ``scalar``: 7x7 planes, views at a float offset), so
every lane works however short a plane is; a unit's plane and channel
come from 32-bit multiply-high divisions by :func:`_lib.magic`'s numbers
(regime ``wide``, with 64-bit divisions, past 2**31 units). The arithmetic
keeps the reference's order ``((x - mean) * (1 / sqrt(var + eps))) * gamma
+ beta`` with each step rounded once (no FMA contraction), the same bits in
every regime. The wrapper takes the light launch path
(:func:`_lib.launch_packed`, one compound check of the five tensors).
"""

from __future__ import annotations

import struct
from collections import namedtuple

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version); the leaky ones
# (slope > 0) count in both
LAUNCHES = _tm.counter("kernel.bn_act.launches")
LEAKY_LAUNCHES = _tm.counter("kernel.bn_act_leaky.launches")
# the C entry's packed arguments (csrc/bn_act.cu Packed): x, mean, var,
# gamma, beta, y, eps, fix_gamma, slope (-1: no activation), then n, c, hw
# and the plan's regime, threads, grid and magic numbers, the stream
_PACK = struct.Struct("=6Qdqd10qQ").pack
REGIMES = ("vec", "scalar", "wide")
UNITS = 4  # units a thread has in flight (csrc kUnits)
THREADS = (256, 128, 64)  # block sizes, largest first (csrc kMaxThreads)
MIN_BLOCKS = 132  # a block for each of the H100's SMs, where the work allows
INT32_MAX = 2 ** 31 - 1  # the most units of the vec and scalar regimes
WIDE_GRID = 132 * 16  # regime wide: a grid-stride loop over this many blocks

Plan = namedtuple("Plan", "regime unit threads grid d_magic d_shift c_magic "
                          "c_shift")


def plan(n, c, hw, aligned=True):
    """The launch of a call on ``(n, c, hw)`` inputs whose ``x`` and ``y``
    start on a 16-byte boundary when ``aligned``: regime ``vec`` (float4
    units) where H*W is a multiple of 4, ``scalar`` (float units)
    otherwise, each while the units fit 32-bit indices, ``wide`` past
    that. The block size is the largest of ``THREADS`` that still gives
    ``MIN_BLOCKS`` blocks of ``UNITS`` units a thread (the least where none
    does), the grid what covers every unit once; ``d`` (H*W in units) and
    ``C`` come with their magic numbers."""
    total = n * c * hw
    if hw % 4 == 0 and aligned and total // 4 <= INT32_MAX:
        regime, unit = "vec", 4
    elif total <= INT32_MAX:
        regime, unit = "scalar", 1
    else:
        return Plan("wide", 1, THREADS[0],
                    min(WIDE_GRID, -(-total // THREADS[0])), 0, 0, 0, 0)
    units = total // unit
    threads = next((t for t in THREADS
                    if -(-units // (t * UNITS)) >= MIN_BLOCKS), THREADS[-1])
    return Plan(regime, unit, threads, -(-units // (threads * UNITS)),
                *_lib.magic(hw // unit), *_lib.magic(c))


_plans = {}  # (shape, x aligned) -> the packed struct's plan fields


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
    if not x.is_cuda:
        if x.device.type in ("cpu", "meta"):
            return bn_act_plain(x, mean, var, gamma, beta, eps, fix_gamma,
                                slope)
        raise MXNetError(f"bn_act: no kernel for device {x.device}")
    # one compound check of the five tensors; get_device() is -1 on the
    # CPU, so it also tells a CUDA tensor on x's device
    dev = x.get_device()
    f32 = torch.float32
    shape = x.shape
    if not (x.dtype is f32 and len(shape) >= 2 and x.is_contiguous()
            and mean.dtype is f32 and mean.get_device() == dev
            and mean.shape == (cs := (shape[1],)) and mean.is_contiguous()
            and var.dtype is f32 and var.get_device() == dev
            and var.shape == cs and var.is_contiguous()
            and gamma.dtype is f32 and gamma.get_device() == dev
            and gamma.shape == cs and gamma.is_contiguous()
            and beta.dtype is f32 and beta.get_device() == dev
            and beta.shape == cs and beta.is_contiguous()):
        if x.dim() < 2:
            raise MXNetError(
                f"bn_act: x must have rank >= 2, got {x.dim()}")
        cs = (shape[1],)
        raise _lib.refusal("bn_act", [
            ("x", x, shape), ("mean", mean, cs), ("var", var, cs),
            ("gamma", gamma, cs), ("beta", beta, cs)], x.device)
    xp = x.data_ptr()
    key = (shape, xp % 16 == 0)
    tail = _plans.get(key)
    if tail is None:
        if not x.numel():
            return torch.empty_like(x)
        n, c = shape[0], shape[1]
        tail = _plans[key] = _tail(plan(n, c, x.numel() // (n * c), key[1]),
                                   n, c, x.numel() // (n * c))
    return _launch(tail, x, xp, mean, var, gamma, beta, eps, fix_gamma,
                   slope)


def _tail(p, n, c, hw):
    """The packed struct's fields from ``n`` on, for plan ``p``."""
    return (n, c, hw, REGIMES.index(p.regime), p.threads, p.grid, p.d_magic,
            p.d_shift, p.c_magic, p.c_shift)


def _launch(tail, x, xp, mean, var, gamma, beta, eps, fix_gamma, slope):
    y = torch.empty_like(x)
    err = _lib.launch_packed(
        x, _lib.library().mxt_bn_act_f32, _PACK, xp, mean.data_ptr(),
        var.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), eps,
        1 if fix_gamma else 0, -1.0 if slope is None else slope, *tail)
    _lib.check(err, "bn_act")
    LAUNCHES.inc()
    if slope:
        LEAKY_LAUNCHES.inc()
    return y


def run_plan(p, x, mean, var, gamma, beta, eps, fix_gamma, slope):
    """Launch plan ``p`` on checked CUDA inputs with at least one element;
    returns ``y``."""
    n, c = x.shape[0], x.shape[1]
    return _launch(_tail(p, n, c, x.numel() // (n * c)), x, x.data_ptr(),
                   mean, var, gamma, beta, eps, fix_gamma, slope)
