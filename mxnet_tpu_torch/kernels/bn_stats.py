"""``bn_stats``: the anchored one-pass BatchNorm training statistics.

Replaces the batch-statistics branch of ``mxnet_tpu/ops/defs_nn.py``
``_batch_norm`` (:399-435): per channel, the sums of ``xc = x - m0`` and
``xc * xc`` with the moving mean as anchor ``m0``, from them the batch mean
and the clamped variance, and the moving averages in the reference's
order ``moving * momentum + stat * (1 - momentum)``. XLA fuses the two sums
into one read of the activation; eager PyTorch would run a subtract, a
square, two reductions and the update arithmetic as separate launches.
``torch.batch_norm`` and cuDNN compute Welford statistics instead, whose
rounding differs from the anchored formula (``ROADMAP.md`` 2b item 1).

The moving statistics are updated in place. Besides the mean and the
variance the function returns ``kvar``, the derivative of the clamp
``max(raw, 0)`` as ``jax.vjp`` takes it (1 above 0, 0.5 at 0, 0 below):
the backward (:mod:`.bn_act_bwd`) multiplies it into the variance term.

Bound on the H100: device-memory bandwidth, one read of ``x`` (4 bytes per
element). ``csrc/bn_stats.cu`` runs one launch per call, planned by
:func:`plan` (``bn_act_bwd``'s one-pass planner, with no shared-memory
limit: the statistics keep only two sums on chip): small channels several
to a block, middle ones a block each, large ones a cluster of up to 16
blocks that add their partial sums through distributed shared memory in
rank order. A channel is walked flat, image by image, with 16-byte loads
where the planes allow them. Every sum runs in a fixed order, so two
calls on the same inputs give the same bits. The wrapper takes the light
launch path (:func:`_lib.launch_packed`, one compound check, one (3, C)
allocation for the three results).
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib
from . import bn_act_bwd as _bwd

# counts kernel launches only (never the plain version): one per call
LAUNCHES = _tm.counter("kernel.bn_stats.launches")
# the C entry's packed arguments (csrc/bn_stats.cu Packed): four pointers,
# n, c, hw, momentum and 1 - momentum, the plan's five fields, the stream
_PACK = struct.Struct("=4Q3q2d5qQ").pack
# no shared memory bounds a block: bn_act_bwd's planner with a block
# capacity of 2**31 elements, so that only m >= 2**31 leaves one launch
_NO_SMEM_LIMIT = 2 ** 31 * _bwd.ELEM_BYTES
# The planner's two settings, from ``chip_smoke.py --bn-stats-plans`` on
# the H100 (PERF.md): blocks of up to 65536 elements, groups of threads
# aimed at 32 elements each, ran ResNet-50's 50 inputs in the least device
# time; smaller blocks pay a cluster's partial sums and barriers for too
# little streaming each.
BLOCK_TARGET = 65536  # elements a block takes before a cluster splits them
ELEMS_PER_THREAD = 32  # a group's size aims at this many each


def plan(n, c, hw, cluster_limit, target=BLOCK_TARGET,
         per_thread=ELEMS_PER_THREAD):
    """The :class:`.bn_act_bwd.Plan` of a call on ``(n, c, hw)`` inputs on
    a card that runs clusters of up to ``cluster_limit`` blocks: a channel
    of ``m = n * hw`` elements takes a block up to ``target`` elements
    (several channels to a block when small) and a cluster of
    ``min(cluster_limit, ceil(m / target))`` blocks beyond, one launch at
    any ``m < 2**31`` (the ``two_phase`` regime past that, which this
    kernel does not have)."""
    return _bwd.plan(n, c, hw, _NO_SMEM_LIMIT, cluster_limit, target,
                     per_thread)


_caps = {}


def device_limits(index):
    """The largest cluster the statistics kernel runs on CUDA device
    ``index``, as the C side finds it (once per device)."""
    got = _caps.get(index)
    if got is None:
        out = (ctypes.c_int * 1)()
        with torch.cuda.device(index):
            err = _lib.library().mxt_bn_stats_caps(out, None)
        _lib.check(err, "bn_stats (device limits)")
        got = _caps[index] = out[0]
    return got


def plan_for(x):
    """The plan of a call on CUDA tensor ``x`` (rank >= 2)."""
    return plan(x.shape[0], x.shape[1], math.prod(x.shape[2:]),
                device_limits(x.get_device()))


_plans = {}


def _plan_of(shape, dev):
    """:func:`plan` for ``shape`` on device ``dev``, kept per shape: the
    wrapper's hot path looks it up by one dictionary access."""
    got = _plans.get((shape, dev))
    if got is None:
        got = plan(shape[0], shape[1], math.prod(shape[2:]),
                   device_limits(dev))
        if got.regime == "two_phase" or got.grid >= 2 ** 31:
            raise MXNetError(f"bn_stats: channels of "
                             f"{shape[0] * math.prod(shape[2:])} elements "
                             "exceed the kernel")
        _plans[(shape, dev)] = got
    return got


def _axes(x):
    return (0,) + tuple(range(2, x.dim()))


def bn_stats_plain(x, moving_mean, moving_var, momentum):
    """The plain PyTorch version: the reference formula, op by op."""
    axes = _axes(x)
    n = float(math.prod(x.shape[i] for i in axes))
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    m0 = moving_mean.to(torch.float32)
    xc = x.to(torch.float32) - m0.reshape(bshape)
    dmean = xc.sum(dim=axes) / n
    mean = m0 + dmean
    raw = (xc * xc).sum(dim=axes) / n - dmean * dmean
    var = torch.clamp_min(raw, 0.0)  # lets NaN through, as jnp.maximum
    kvar = torch.where(raw > 0, 1.0,
                       torch.where(raw == 0, 0.5, 0.0)).to(torch.float32)
    moving_mean.copy_(moving_mean * momentum + mean * (1 - momentum))
    moving_var.copy_(moving_var * momentum + var * (1 - momentum))
    return mean, var, kvar


def bn_stats(x, moving_mean, moving_var, momentum):
    """Batch ``(mean, var, kvar)`` of ``x`` over every axis but 1, anchored
    at ``moving_mean``; ``moving_mean``/``moving_var`` are updated in place.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel, which takes a contiguous float32 ``x`` of rank >= 2 and
    contiguous float32 ``(C,)`` moving statistics on the same device;
    anything else raises :class:`MXNetError`. On the card the three results
    are views of one (3, C) allocation.
    """
    if not x.is_cuda:
        if x.device.type == "cpu":
            return bn_stats_plain(x, moving_mean, moving_var, momentum)
        raise MXNetError(f"bn_stats: no kernel for device {x.device}")
    dev = x.get_device()
    f32 = torch.float32
    ok = x.dim() >= 2 and x.dtype is f32 and x.is_contiguous()
    c = x.shape[1] if ok else 0
    for t in (moving_mean, moving_var):
        ok = ok and (t.dtype is f32 and t.is_contiguous()
                     and t.get_device() == dev and t.shape == (c,))
    if not ok:
        if x.dim() < 2:
            raise MXNetError(
                f"bn_stats: x must have rank >= 2, got {x.dim()}")
        c = x.shape[1]
        raise _lib.refusal("bn_stats", [
            ("x", x, x.shape), ("moving_mean", moving_mean, (c,)),
            ("moving_var", moving_var, (c,))], x.device)
    if not x.numel():
        raise MXNetError(f"bn_stats: x {tuple(x.shape)} has no elements")
    out = x.new_empty((3, c))
    run_plan(_plan_of(x.shape, dev), x, moving_mean, moving_var, momentum,
             out)
    return out.unbind(0)


def run_plan(p, x, moving_mean, moving_var, momentum, out):
    """Launch plan ``p`` on checked CUDA inputs, writing ``(mean, var,
    kvar)`` into the rows of ``out`` (3, C)."""
    n, c = x.shape[0], x.shape[1]
    err = _lib.launch_packed(
        x, _lib.library().mxt_bn_stats_f32, _PACK, x.data_ptr(),
        moving_mean.data_ptr(), moving_var.data_ptr(), out.data_ptr(), n, c,
        x.numel() // (n * c), float(momentum), float(1 - momentum), p.grid,
        p.cluster, p.channels_per_block, p.group, p.chunk)
    _lib.check(err, "bn_stats")
    LAUNCHES.inc()
