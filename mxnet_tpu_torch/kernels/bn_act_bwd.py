"""``bn_act_bwd``: the BatchNorm backward with the (leaky) ReLU mask fused.

Replaces the VJP of ``mxnet_tpu/ops/defs_nn.py`` ``_batch_norm``
(:380-442) composed with the ``Activation(relu)`` or
``LeakyReLU(act_type="leaky", slope=s)`` after it, which ``jax.grad``
derives and XLA fuses. With ``dy' = where(y > 0, dy, slope * dy)``
(slope 0 is the ReLU's ``dy * (y > 0)``) or, with ``slope=None``, ``dy``,
``x^ = (x - mean) * invstd`` and ``n`` elements per channel:

* ``dbeta = sum(dy')``, ``dgamma = sum(dy' * x^)`` (0 under ``fix_gamma``);
* ``dx = gamma * invstd * (dy' - sum(dy')/n - kvar * x^ * sum(dy' x^)/n)``
  for batch statistics — the VJP of the anchored formula, because the
  anchor is ``stop_gradient``; ``kvar`` is the clamp's derivative from
  :func:`.bn_stats.bn_stats` (0 where the clamp holds the variance at 0);
* ``dx = gamma * invstd * dy'`` for ``use_global_stats`` (``kvar=None``),
  where mean and variance are the moving statistics.

The mask reads the sign from the output ``y``, which has ``t``'s sign for
a slope >= 0; at ``t == 0`` it gives ``slope * dy``, the gradient of the
reference's ``where``. A negative slope flips the sign and is refused. The
leaky route (slope > 0) runs under its own kernel names.

Bound on the H100: device-memory bandwidth, 16 bytes per element (dy, y
and x read once, dx written once). :func:`plan` picks the regime of
``csrc/bn_act_bwd.cu`` from the per-channel element count ``m = N*H*W``,
the card's shared memory per block and its largest cluster:

* ``block``: ``m`` is at most ``BLOCK_TARGET`` (16384) and fits one
  block (8 bytes an element: ``d'`` and ``x^`` kept in shared memory):
  one launch, one pass over device memory; a block takes several channels
  when ``m`` is small;
* ``cluster``: ``m`` fits ``k = ceil(m / BLOCK_TARGET)`` blocks, at most
  the card's cluster limit (16 on the H100) and each holding up to
  :func:`block_elems`: one launch of ``k``-block clusters that add their
  partial sums through distributed shared memory, one pass;
* ``two_phase``: larger channels: a reduction, then the dx pass, two
  launches that read the inputs twice (28 bytes an element).

At batch 32 every ResNet-50 BatchNorm plans one launch (``bn0``'s
401408-element channels a 16-block cluster), as do DCGAN's. The wrapper
takes the light launch path (:func:`_lib.launch`) and checks its inputs in
one compound test.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import NamedTuple

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version): one per call in
# the block and cluster regimes, two in the two-phase one; the leaky ones
# (slope > 0) count in both
LAUNCHES = _tm.counter("kernel.bn_act_bwd.launches")
LEAKY_LAUNCHES = _tm.counter("kernel.bn_act_bwd_leaky.launches")
_WARPS = 8  # warps per block of the two-phase kernels
# the one-pass entry's packed arguments (csrc/bn_act_bwd.cu OnePassArgs):
# ten pointers, n, c, hw, eps, fix_gamma, slope, the plan, the stream
_PACK_ONEPASS = struct.Struct("=10Q3qdqd5qQ").pack
ELEM_BYTES = 8  # shared memory a held element takes: d' and x^, float32
MAX_THREADS = 1024  # threads per block of the one-pass kernels, at most
PACK_THREADS = 256  # small channels share a block up to this many threads
# The planner's two settings, from ``chip_smoke.py --bn-bwd-plans`` on the
# H100 (PERF.md): a cluster of blocks of up to 16384 elements, groups of
# at most 512 threads at 16 elements each (1024 only past the target),
# ran ResNet-50's 12 shapes in the least device time. Larger blocks of
# 1024 threads hold one block an SM (48 registers a thread), and its loads
# and stores do not overlap another block's.
ELEMS_PER_THREAD = 16  # a one-pass group's size aims at this many each
BLOCK_TARGET = 16384  # elements a block takes before a cluster splits them
GROUP_CAP = 512  # threads per channel group while a block holds <= target


class Plan(NamedTuple):
    """How one call runs: ``regime`` ``"block"``, ``"cluster"`` or
    ``"two_phase"``; ``grid`` blocks of ``threads``; ``cluster`` blocks per
    channel (1 but in a cluster); ``channels_per_block`` channels of
    ``group`` threads each; ``chunk`` elements of a channel per block;
    ``launches`` per call."""

    regime: str
    grid: int
    cluster: int
    channels_per_block: int
    threads: int
    group: int
    chunk: int
    launches: int


def block_elems(smem_limit):
    """Elements of one channel that one block holds in ``smem_limit``
    bytes of shared memory: a multiple of 4, so that every block's part
    starts on a 16-byte boundary."""
    return smem_limit // ELEM_BYTES // 4 * 4


def block_limit(smem_limit):
    """The most elements a channel may have and take the block regime."""
    return min(BLOCK_TARGET, block_elems(smem_limit))


def _ceil(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def plan(n, c, hw, smem_limit, cluster_limit, target=BLOCK_TARGET,
         per_thread=ELEMS_PER_THREAD):
    """The regime, grid and cluster of a call on ``(n, c, hw)`` inputs, on
    a card whose one-pass blocks may take ``smem_limit`` bytes of dynamic
    shared memory and run clusters of up to ``cluster_limit`` blocks. A
    channel of ``m = n * hw`` elements takes one block up to ``target``
    elements (and what a block holds), a cluster of ``ceil(m / target)``
    blocks beyond (at most ``cluster_limit``, each holding up to
    :func:`block_elems`), and two phases past that; a group of threads per
    channel aims at ``per_thread`` elements each, at most ``GROUP_CAP``
    threads while a block holds no more than ``target``. A pure function;
    the C entry checks the plan it is given."""
    m = n * hw
    cap = block_elems(smem_limit)
    if not cap or m >= 2 ** 31 or _ceil(m, cap) > cluster_limit:
        splits = max(1, _ceil(n, _WARPS))
        return Plan("two_phase", c * splits, 1, 1, _WARPS * 32,
                    _WARPS * 32, 0, 2)
    k = min(cluster_limit, max(1, _ceil(m, min(target, cap))))
    chunk = max(4, _ceil(_ceil(m, k), 4) * 4)
    most = GROUP_CAP if chunk <= target else MAX_THREADS
    group = 32
    while group < most and group * per_thread < chunk:
        group *= 2
    cpb = 1
    if k == 1 and group < PACK_THREADS:
        cpb = max(1, min(PACK_THREADS // group, c, cap // chunk))
    return Plan("block" if k == 1 else "cluster", _ceil(c, cpb) * k, k, cpb,
                cpb * group, group, chunk, 1)


_caps = {}


def device_limits(index):
    """``(smem_limit, cluster_limit)`` of CUDA device ``index`` for
    :func:`plan`, as the C side finds them (once per device)."""
    got = _caps.get(index)
    if got is None:
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(index):
            err = _lib.library().mxt_bn_bwd_caps(out, None)
        _lib.check(err, "bn_act_bwd (device limits)")
        got = _caps[index] = (out[0], out[1])
    return got


def plan_for(x):
    """The :class:`Plan` of a call on CUDA tensor ``x`` (rank >= 2)."""
    hw = math.prod(x.shape[2:])
    return plan(x.shape[0], x.shape[1], hw, *device_limits(x.get_device()))


def bn_act_bwd_plain(dy, y, x, mean, var, gamma, kvar, eps, fix_gamma,
                     slope=None):
    """The plain PyTorch version of the formulas above."""
    axes = (0,) + tuple(range(2, x.dim()))
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    n = float(math.prod(x.shape[i] for i in axes))
    if slope is None:
        d = dy
    elif slope:
        d = torch.where(y > 0, dy, slope * dy)
    else:
        d = torch.where(y > 0, dy, 0.0)
    inv = torch.rsqrt(var.to(torch.float32) + eps)
    xhat = (x - mean.reshape(bshape)) * inv.reshape(bshape)
    sdy = d.sum(dim=axes)
    sdyx = (d * xhat).sum(dim=axes)
    scale = inv if fix_gamma else gamma * inv
    if kvar is None:
        dx = scale.reshape(bshape) * d
    else:
        dx = scale.reshape(bshape) * (d - (sdy / n).reshape(bshape) - xhat
                                      * (kvar * sdyx / n).reshape(bshape))
    dgamma = torch.zeros_like(sdyx) if fix_gamma else sdyx
    return dx, dgamma, sdy


def bn_act_bwd(dy, y, x, mean, var, gamma, kvar, eps, fix_gamma,
               slope=None):
    """``(dx, dgamma, dbeta)`` of ``y = [leaky_relu(slope)](bn(x))`` for
    the head gradient ``dy``; ``y`` is read only with a ``slope`` (pass None
    without). ``slope`` must be None or >= 0.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernels, which take contiguous float32 ``dy``/``y``/``x`` of one shape
    (rank >= 2) and contiguous float32 ``(C,)`` statistics on the same
    device; anything else raises :class:`MXNetError`.
    """
    if slope is not None and not slope >= 0:
        raise MXNetError(
            f"bn_act_bwd: slope must be None or >= 0, got {slope}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return bn_act_bwd_plain(dy, y, x, mean, var, gamma, kvar, eps,
                                    fix_gamma, slope)
        raise MXNetError(f"bn_act_bwd: no kernel for device {x.device}")
    if x.dim() < 2:
        raise MXNetError(f"bn_act_bwd: x must have rank >= 2, got {x.dim()}")
    shape = x.shape
    c = shape[1]
    dev = x.get_device()
    f32 = torch.float32
    ok = (x.dtype is f32 and dy.dtype is f32 and x.is_contiguous()
          and dy.is_contiguous() and dy.get_device() == dev
          and dy.shape == shape)
    if ok and slope is not None:
        ok = (y is not None and y.dtype is f32 and y.is_contiguous()
              and y.get_device() == dev and y.shape == shape)
    stats = (mean, var, gamma) if kvar is None else (mean, var, gamma, kvar)
    for t in stats:
        ok = ok and (t.dtype is f32 and t.is_contiguous()
                     and t.get_device() == dev and t.shape == (c,))
    if not ok:
        raise _lib.refusal("bn_act_bwd", [
            ("x", x, shape), ("dy", dy, shape),
            ("y", y if slope is not None else None, shape)] + [
            (name, t, (c,)) for name, t in zip(("mean", "var", "gamma",
                                                "kvar"), stats)], x.device)
    n = shape[0]
    hw = x.numel() // (n * c) if n * c else 0
    dx = torch.empty_like(x)
    sums = x.new_empty((2, c))
    dgamma, dbeta = sums.unbind(0)
    if not x.numel():
        sums.zero_()
        return dx, dgamma, dbeta
    return run_plan(plan(n, c, hw, *device_limits(dev)), dy, y, x, mean,
                    var, gamma, kvar, eps, fix_gamma, slope, dx, dgamma,
                    dbeta)


def run_plan(p, dy, y, x, mean, var, gamma, kvar, eps, fix_gamma, slope,
             dx, dgamma, dbeta):
    """Launch the kernels of :class:`Plan` ``p`` on checked CUDA inputs,
    writing ``dx``, ``dgamma`` and ``dbeta``; returns them."""
    n, c = x.shape[0], x.shape[1]
    hw = x.numel() // (n * c)
    yp = y.data_ptr() if slope is not None else 0
    c_slope = _lib.c_slope(slope)
    lib = _lib.library()
    kp = kvar.data_ptr() if kvar is not None else 0
    if p.launches == 1:
        err = _lib.launch_packed(
            x, lib.mxt_bn_bwd_onepass_f32, _PACK_ONEPASS, dy.data_ptr(), yp,
            x.data_ptr(), mean.data_ptr(), var.data_ptr(), gamma.data_ptr(),
            kp, dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), n, c, hw,
            float(eps), int(bool(fix_gamma)), c_slope, p.grid, p.cluster,
            p.channels_per_block, p.group, p.chunk)
        _lib.check(err, f"bn_act_bwd ({p.regime})")
        LAUNCHES.inc()
        if slope:
            LEAKY_LAUNCHES.inc()
        return dx, dgamma, dbeta
    splits = p.grid // c
    if p.grid >= 2 ** 31 or (n * c + _WARPS - 1) // _WARPS >= 2 ** 31:
        raise MXNetError(f"bn_act_bwd: {n}x{c} planes exceed the grid")
    totals = x.new_empty(2 * c)
    partial = x.new_empty(2 * c * splits)
    err = _lib.launch(
        x, lib.mxt_bn_bwd_reduce_f32, dy.data_ptr(), yp, x.data_ptr(),
        mean.data_ptr(), var.data_ptr(), totals.data_ptr(),
        dgamma.data_ptr(), dbeta.data_ptr(), partial.data_ptr(),
        _lib.tickets(x.device, c).data_ptr(), n, c, hw, splits, float(eps),
        int(bool(fix_gamma)), c_slope)
    _lib.check(err, "bn_act_bwd (reduce)")
    LAUNCHES.inc()
    if slope:
        LEAKY_LAUNCHES.inc()
    err = _lib.launch(
        x, lib.mxt_bn_bwd_dx_f32, dy.data_ptr(), yp, x.data_ptr(),
        mean.data_ptr(), var.data_ptr(), gamma.data_ptr(), kp,
        totals.data_ptr(), dx.data_ptr(), n, c, hw, float(eps),
        int(bool(fix_gamma)), c_slope, int(kvar is not None))
    _lib.check(err, "bn_act_bwd (dx)")
    LAUNCHES.inc()
    if slope:
        LEAKY_LAUNCHES.inc()
    return dx, dgamma, dbeta
