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

Bound on the H100: device-memory bandwidth. ``csrc/bn_act_bwd.cu`` runs
two phases, two launches per call (100 per ResNet-50 step for its 50
BatchNorms): a per-channel reduction over ``dy``, ``y`` and ``x`` (12
bytes per element) that ends in its last block, then the ``dx`` pass (16
bytes per element), against a one-pass minimum of 16.
"""

from __future__ import annotations

import math

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version): two per call; the
# leaky ones (slope > 0) count in both
LAUNCHES = _tm.counter("kernel.bn_act_bwd.launches")
LEAKY_LAUNCHES = _tm.counter("kernel.bn_act_bwd_leaky.launches")
_WARPS = 8  # warps per block in csrc/bn_act_bwd.cu


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
    if x.device.type == "cpu":
        return bn_act_bwd_plain(dy, y, x, mean, var, gamma, kvar, eps,
                                fix_gamma, slope)
    if x.device.type != "cuda":
        raise MXNetError(f"bn_act_bwd: no kernel for device {x.device}")
    if x.dim() < 2:
        raise MXNetError(f"bn_act_bwd: x must have rank >= 2, got {x.dim()}")
    dev = x.device
    _lib.check_f32("bn_act_bwd: x", x, dev)
    _lib.check_f32("bn_act_bwd: dy", dy, dev, x.shape)
    if slope is not None:
        _lib.check_f32("bn_act_bwd: y", y, dev, x.shape)
    n, c = x.shape[0], x.shape[1]
    stats = [("mean", mean), ("var", var), ("gamma", gamma)]
    if kvar is not None:
        stats.append(("kvar", kvar))
    for name, t in stats:
        _lib.check_f32(f"bn_act_bwd: {name}", t, dev, (c,))
    hw = math.prod(x.shape[2:])
    splits = max(1, -(-n // _WARPS))
    if c * splits >= 2 ** 31 or (n * c + _WARPS - 1) // _WARPS >= 2 ** 31:
        raise MXNetError(f"bn_act_bwd: {n}x{c} planes exceed the grid")
    dx = torch.empty_like(x)
    dgamma, dbeta = torch.empty(c, device=dev), torch.empty(c, device=dev)
    sums = torch.empty(2 * c, device=dev)
    partial = torch.empty(2 * c * splits, device=dev)
    yp = y.data_ptr() if slope is not None else 0
    c_slope = _lib.c_slope(slope)
    lib = _lib.library()
    stream = _lib.stream_of(x)
    with torch.cuda.device(dev):
        err = lib.mxt_bn_bwd_reduce_f32(
            dy.data_ptr(), yp, x.data_ptr(), mean.data_ptr(), var.data_ptr(),
            sums.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
            partial.data_ptr(), _lib.tickets(dev, c).data_ptr(), n, c, hw,
            splits, float(eps), int(bool(fix_gamma)), c_slope, stream)
        _lib.check(err, "bn_act_bwd (reduce)")
        LAUNCHES.inc()
        if slope:
            LEAKY_LAUNCHES.inc()
        err = lib.mxt_bn_bwd_dx_f32(
            dy.data_ptr(), yp, x.data_ptr(), mean.data_ptr(), var.data_ptr(),
            gamma.data_ptr(), kvar.data_ptr() if kvar is not None else 0,
            sums.data_ptr(), dx.data_ptr(), n, c, hw, float(eps),
            int(bool(fix_gamma)), c_slope, int(kvar is not None), stream)
        _lib.check(err, "bn_act_bwd (dx)")
        LAUNCHES.inc()
        if slope:
            LEAKY_LAUNCHES.inc()
    return dx, dgamma, dbeta
