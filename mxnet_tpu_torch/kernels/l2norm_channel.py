"""``l2norm_channel`` and ``l2norm_channel_bwd``: L2 normalization over the
channel axis, with a fused scale, forward and backward.

Replaces ``mxnet_tpu/ops/defs_nn.py`` ``_l2_normalization`` in mode
``"channel"`` (``x / sqrt(sum_c x^2 + eps)``) together with the ``* 20.0``
that follows it on the SSD path (``mxnet_tpu/models/ssd.py:132-133``),
which XLA fuses into one pass and eager PyTorch would run as a square, a
sum, an add, a sqrt, a divide and a multiply. The executor routes an
``L2Normalization(mode="channel")`` whose only consumer is a
``_mul_scalar`` here with the scale fused (``executor._run_l2norm``);
the op alone runs the same kernel with scale 1.

Bound on the H100: device-memory bandwidth. The forward reads ``x`` once
and writes ``y`` once: at SSD-300's conv4_3 in training, (32, 512, 37, 37)
float32, 89.7 MB each way (0.0536 ms at 3.35 TB/s); in serving at bucket 8,
22.4 MB. Both directions plan their regime here from the channel count
alone (:func:`plan`): up to ``ONCHIP_C`` = 512 channels (every path shape)
a block of positions x ``SLICES`` = 16 channel slices keeps each thread's
``k`` channels in registers from the load to the store, so each element is
read once; past that, a two-pass regime reads them again. The thread of
slice ``j`` sums channels ``j, j + 16, ...`` in order and the 16 partials
are added in slice order, in both regimes. ``csrc/l2norm_channel.cu``
rounds the square, the sum, the sqrt, the division and the scale once
each, in the reference's order; the forward's block is 64 positions wide
on large grids (SSD training), 32 on middle ones and 16 where wider blocks
would leave SMs idle (:func:`tile`: SSD serving at bucket 1). A zero
input is its own quotient where the norm is positive: the kernels skip the
division there, whose slow path a zero dividend takes; a norm of 0 (eps 0)
or NaN gives NaN, as the reference does.

In training :class:`L2NormChannelFn` runs the forward kernel and, as its
backward, ``csrc/l2norm_channel_bwd.cu``: the VJP ``dx = s * g / n - x *
(s * sum_c g * x) / n^3`` (``n = sqrt(sum_c x^2 + eps)``). It recomputes
the norm, so the forward keeps its single output. At SSD-300's conv4_3 in
training it reads 179 MB and writes 90 MB, one launch a call in the same
regimes (32 positions a block). Its order of operations is not
``jax.vjp``'s: against :func:`l2norm_channel_bwd_plain` (which is) it
agrees to :func:`bwd_limit`: ``BWD_RTOL`` of the two terms' magnitudes at
each position plus ``BWD_ATOL`` of the largest value, since ``s * g / n``
and the projection term cancel where ``g`` lies along ``x`` and each
float32 version then keeps only their rounding. Both wrappers take the
light launch path (:func:`_lib.launch_packed`, the plan cached per call
shape).
"""

from __future__ import annotations

import math
import struct
from collections import namedtuple

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# count kernel launches only (never the plain versions)
LAUNCHES = _tm.counter("kernel.l2norm_channel.launches")
BWD_LAUNCHES = _tm.counter("kernel.l2norm_channel_bwd.launches")
# the backward kernel against its plain version (float32): |got - want| <=
# BWD_RTOL * (the terms' magnitudes) + BWD_ATOL * max|want|: see bwd_limit
BWD_RTOL, BWD_ATOL = 1e-5, 1e-6
# the C entries' packed arguments (csrc/l2norm_channel.cu and
# csrc/l2norm_channel_bwd.cu Packed): the forward's x, y, n, c, hw, eps,
# scale, the plan's regime, k and positions a block, the stream; the
# backward's x, g, dx, n, c, hw, eps, scale, the plan's regime and k, the
# stream
_PACK = struct.Struct("=2Q3q2d3qQ").pack
_BWD_PACK = struct.Struct("=3Q3q2d2qQ").pack
# the on-chip regime: a block takes its positions x 16 slices of channels,
# a thread k (a compiled choice) of its position's channels in registers,
# at most 32; the backward's blocks hold POSITIONS positions, the
# forward's as tile() gives them (on the H100, shared-memory storage and
# other block shapes lost to these settings at SSD's shapes: PERF.md)
POSITIONS, SLICES = 32, 16
K_CHOICES = (1, 2, 4, 8, 16, 32)
ONCHIP_C = SLICES * K_CHOICES[-1]  # the largest C the on-chip regime takes
REGIMES = ("onchip", "two_pass")
# the forward's positions a block (compiled choices): WIDE_POSITIONS from
# WIDE_FROM positions on, NARROW_POSITIONS below NARROW_BELOW, POSITIONS
# between them. Each tile was the fastest on the H100 at one measured call
# (PERF.md): SSD serving at bucket 1 (1369 positions) 16, at bucket 8
# (10952) 32, training at batch 32 (43808) 64. The borders lie between those
# calls and were not timed themselves: buckets 2 (2738) and 4 (5476) fall on
# either side of NARROW_BELOW, bucket 16 (21904) below WIDE_FROM.
TILES = (16, 32, 64)
WIDE_POSITIONS, WIDE_FROM = 64, 32768
NARROW_POSITIONS, NARROW_BELOW = 16, 4096


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


def bwd_limit(x, g, eps, scale, want):
    """How far the kernel's ``dx`` may lie from the plain version's
    ``want``, position by position: ``BWD_RTOL`` of ``|s g| / n + |x| |s
    sum_c(g x)| / n^3``, the magnitudes of the two terms whose difference is
    ``dx``, plus ``BWD_ATOL`` of the largest ``|want|``. Where ``g`` lies
    nearly along ``x`` the terms cancel and ``|dx|`` is far below them; each
    float32 version then keeps only the terms' rounding (on an H100 at
    (2, 3) over 5000 seeds, ``chip_smoke.py --l2norm-bwd-sweep``, each read
    at most 1.1e-6 of the terms from a float64 computation), so a limit
    relative to ``|dx|`` would test cancellation, not the kernel."""
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)
    proj = torch.sum(g * x, dim=1, keepdim=True) * scale
    terms = (g * scale).abs() / norm + x.abs() * proj.abs() / norm ** 3
    return BWD_RTOL * terms + BWD_ATOL * want.abs().max()


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


Plan = namedtuple("Plan", "regime k")


def plan(c):
    """The regime for ``c`` channels, forward and backward: ``onchip``
    with ``k`` the least of ``K_CHOICES`` that covers C in ``SLICES``
    slices, up to ``ONCHIP_C``; ``two_pass`` past it."""
    if c <= ONCHIP_C:
        return Plan("onchip", next(k for k in K_CHOICES if SLICES * k >= c))
    return Plan("two_pass", 0)


bwd_plan = plan  # the backward plans as the forward does


def tile(positions):
    """The forward's positions a block (on chip) for ``positions`` = N *
    H*W: ``WIDE_POSITIONS`` from ``WIDE_FROM`` on, ``NARROW_POSITIONS``
    below ``NARROW_BELOW``, else ``POSITIONS``."""
    if positions >= WIDE_FROM:
        return WIDE_POSITIONS
    return NARROW_POSITIONS if positions < NARROW_BELOW else POSITIONS


_plans = {}  # (C, N * H*W) -> the packed struct's plan fields


def l2norm_channel(x, eps, scale=1.0):
    """``(x / sqrt(sum_c x^2 + eps)) * scale`` over axis 1 of ``x``.

    A CPU (or shape-only ``meta``) tensor takes the plain version. A CUDA
    tensor launches the kernel, which takes a contiguous float32 tensor of
    rank >= 2; anything else raises :class:`MXNetError`.
    """
    if not x.is_cuda:
        if x.device.type in ("cpu", "meta"):
            return l2norm_channel_plain(x, eps, scale)
        raise MXNetError(f"l2norm_channel: no kernel for device {x.device}")
    shape = x.shape
    if not (x.dtype is torch.float32 and len(shape) >= 2
            and x.is_contiguous()):
        _check_layout("l2norm_channel", x)
    if not x.numel():
        return torch.empty_like(x)
    n, c = shape[0], shape[1]
    positions = x.numel() // c
    key = (c, positions)
    fields = _plans.get(key)
    if fields is None:
        _check_layout("l2norm_channel", x)
        p = plan(c)
        fields = _plans[key] = (REGIMES.index(p.regime), p.k,
                                tile(positions) if p.regime == "onchip"
                                else POSITIONS)
    return _launch(x, n, c, positions // n, eps, scale, fields)


def _launch(x, n, c, hw, eps, scale, fields):
    y = torch.empty_like(x)
    err = _lib.launch_packed(
        x, _lib.library().mxt_l2norm_channel_f32, _PACK, x.data_ptr(),
        y.data_ptr(), n, c, hw, float(eps), float(scale), *fields)
    _lib.check(err, "l2norm_channel")
    LAUNCHES.inc()
    return y


def run_plan(p, pos, x, eps, scale=1.0):
    """Launch plan ``p`` with ``pos`` positions a block on a checked CUDA
    ``x`` with at least one element; returns ``y``."""
    n, c = x.shape[0], x.shape[1]
    return _launch(x, n, c, x.numel() // (n * c), eps, scale,
                   (REGIMES.index(p.regime), p.k, pos))


_bwd_plans = {}


def l2norm_channel_bwd(x, g, eps, scale=1.0):
    """The gradient of ``(x / sqrt(sum_c x^2 + eps)) * scale`` (axis 1)
    with respect to ``x``, given the output's gradient ``g``.

    A CPU (or ``meta``) tensor takes the plain version. A CUDA tensor
    launches the kernel, which takes contiguous float32 ``x`` and ``g`` of
    one shape (rank >= 2) on one device; anything else raises
    :class:`MXNetError`.
    """
    if not x.is_cuda:
        if x.device.type in ("cpu", "meta"):
            return l2norm_channel_bwd_plain(x, g, eps, scale)
        raise MXNetError(f"l2norm_channel_bwd: no kernel for device "
                         f"{x.device}")
    dev = x.get_device()
    f32 = torch.float32
    if not (x.dim() >= 2 and x.dtype is f32 and x.is_contiguous()
            and g.dtype is f32 and g.is_contiguous() and g.is_cuda
            and g.get_device() == dev and g.shape == x.shape):
        _check_layout("l2norm_channel_bwd", x)
        _lib.check_f32("l2norm_channel_bwd: g", g, x.device, x.shape)
    dx = torch.empty_like(x)
    if not x.numel():
        return dx
    n, c = x.shape[0], x.shape[1]
    p = _bwd_plans.get(c)
    if p is None:
        p = _bwd_plans[c] = plan(c)
    err = _lib.launch_packed(
        x, _lib.library().mxt_l2norm_channel_bwd_f32, _BWD_PACK,
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), n, c,
        x.numel() // (n * c), float(eps), float(scale),
        0 if p.regime == "onchip" else 1, p.k)
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
