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
element). ``csrc/bn_stats.cu`` gives each block's warps whole planes, reads
them with 16-byte loads, and the last block of each channel adds the
partial sums in a fixed order (no atomics on the sums, so the result does
not depend on scheduling).
"""

from __future__ import annotations

import math

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version)
LAUNCHES = _tm.counter("kernel.bn_stats.launches")
_WARPS = 8  # warps per block in csrc/bn_stats.cu


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
    anything else raises :class:`MXNetError`.
    """
    if x.device.type == "cpu":
        return bn_stats_plain(x, moving_mean, moving_var, momentum)
    if x.device.type != "cuda":
        raise MXNetError(f"bn_stats: no kernel for device {x.device}")
    if x.dim() < 2:
        raise MXNetError(f"bn_stats: x must have rank >= 2, got {x.dim()}")
    _lib.check_f32("bn_stats: x", x, x.device)
    n, c = x.shape[0], x.shape[1]
    for name, t in (("moving_mean", moving_mean), ("moving_var", moving_var)):
        _lib.check_f32(f"bn_stats: {name}", t, x.device, (c,))
    hw = math.prod(x.shape[2:])
    splits = max(1, -(-n // _WARPS))
    if c * splits >= 2 ** 31:
        raise MXNetError(f"bn_stats: {c} channels exceed the kernel's grid")
    mean, var, kvar = (torch.empty(c, device=x.device) for _ in range(3))
    partial = torch.empty(2 * c * splits, device=x.device)
    lib = _lib.library()
    with torch.cuda.device(x.device):
        err = lib.mxt_bn_stats_f32(
            x.data_ptr(), moving_mean.data_ptr(), moving_var.data_ptr(),
            mean.data_ptr(), var.data_ptr(), kvar.data_ptr(),
            partial.data_ptr(), _lib.tickets(x.device, c).data_ptr(),
            n, c, hw, splits, float(momentum), float(1 - momentum),
            _lib.stream_of(x))
    _lib.check(err, "bn_stats")
    LAUNCHES.inc()
    return mean, var, kvar
