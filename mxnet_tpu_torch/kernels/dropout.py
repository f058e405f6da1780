"""``dropout``: a Bernoulli mask from counter-based random bits and the
masked input, in one pass.

Replaces the draw and the products of ``Dropout``
(``mxnet_tpu/ops/defs_nn.py:627-645``: ``mask = bernoulli(keep) / keep``,
``y = x * mask``) and of the ``RNN`` op's dropout between layers
(``mxnet_tpu/ops/defs_rnn.py:176-179``: ``x * bernoulli(keep) / keep``),
which XLA fuses into one pass with the TPU's own random bits.

The bits are Philox4x32-10 keyed by the 64-bit ``key`` (low word, high
word), with the counter ``(i // 4, stream, serial, step)`` for element
``i``, which takes word ``i % 4``: an executor passes its bind-time key,
its forward count and the node's serial (``OpMode.rng``), and ``stream``
tells apart the masks one node draws (the ``RNN`` op's layers). Element
``i`` is kept when ``(word >> 8) * 2**-24 < keep32``, ``keep32 =
float32(1 - p)``, an exact test. The mask is ``float32(kept) / keep32`` in
``x``'s dtype, and ``y = x * mask`` as ``Dropout`` rounds it; with
``divide`` ``y = (x * kept) / keep32`` as the ``RNN`` op rounds it, and no
mask is written. The bits cannot equal JAX's, so the tests hold the port
to the reference by feeding the reference the port's masks.

:func:`dropout_plain` computes the same Philox in PyTorch's int64
arithmetic (no product leaves 64 bits), so kernel and plain version agree
bit for bit. Bound on the H100: bytes, 12 an element in float32 (8 with
``divide``); at the LSTM LM's (20, 650) a launch's fixed costs. The
backward, ``g * mask``, is one ``torch.mul`` (:class:`DropoutFn`), the
product JAX's autodiff leaves outside any fused region; with ``divide`` the
backward draws the same bits again on the gradient
(:class:`DivideDropoutFn`: ``(g * kept) / keep32``, the rounding of the
reference's VJP ``(g / keep) * kept``), so nothing is stored.
"""

from __future__ import annotations

import struct

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# the C entry's packed arguments (csrc/dropout.cu DropoutArgs)
_PACK = struct.Struct("=3QqQ3qd2qQ").pack
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_ELEMENTS = 1 << 34  # the counter's first word numbers groups of four
# count kernel launches only (never the plain version)
LAUNCHES = _tm.counter("kernel.dropout.launches")

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m, c):
    """``(hi, lo)`` words of ``m * c`` for a 32-bit constant ``m`` and an
    int64 tensor ``c`` of 32-bit values, with no product past 2**49."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    t = c * m_lo
    u = c * m_hi
    hi = (u + (t >> 16)) >> 16
    lo = (((u & 0xFFFF) << 16) + t) & _M32
    return hi, lo


def philox4x32(counter, key):
    """Philox4x32-10 of the four int64 tensors ``counter`` (32-bit words)
    under the two-word ``key``: the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _M32
        k1 = (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def keep32(p):
    """``float32(1 - p)`` as a 0-d float32 tensor."""
    return torch.tensor(1.0 - float(p), dtype=torch.float32)


_KEEP32 = {}


def keep32_value(p):
    """``float32(1 - p)`` as a Python float (exact: a float32 value),
    computed once per ``p``: what the kernel's keep test and its roundings
    read."""
    k = _KEEP32.get(p)
    if k is None:
        k = _KEEP32[p] = float(keep32(p))
    return k


def kept_plain(n, p, key, step, serial, stream=0, device="cpu"):
    """The keep decisions (bool) of ``n`` elements, in flat order."""
    groups = (n + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=device)

    def word(v):
        return torch.full_like(g, int(v) & _M32)

    words = philox4x32((g, word(stream), word(serial), word(step)),
                       (int(key) & _M32, (int(key) >> 32) & _M32))
    bits = torch.stack(words, dim=1).reshape(-1)[:n]
    u = (bits >> 8).to(torch.float32) * 2.0 ** -24
    return u < keep32(p).to(device)


def dropout_plain(x, p, key, step, serial, stream=0, divide=False):
    """The plain PyTorch version: ``(y, mask)`` (``mask`` None with
    ``divide``), bit for bit the kernel's; a float64 ``x`` (the CPU
    yardsticks) keeps float64 with ``keep32``'s values."""
    kept = kept_plain(x.numel(), p, key, step, serial, stream,
                      x.device).reshape(x.shape).to(torch.float32)
    k = keep32(p).to(x.device)
    if divide:
        # 16-bit types compute in float32 and round once, as the kernel
        wide = x if x.dtype in (torch.float32, torch.float64) \
            else x.to(torch.float32)
        return ((wide * kept) / k).to(x.dtype), None
    mask = (kept / k).to(x.dtype)
    return x * mask, mask


def dropout(x, p, key, step, serial, stream=0, divide=False):
    """``(y, mask)`` of ``x`` under drop probability ``p`` with the bits of
    ``(key, step, serial, stream)``; ``mask`` is None with ``divide``.

    CPU (and shape-only ``meta``) tensors take the plain version. A CUDA
    tensor launches the kernel, which takes a contiguous float32, float16
    or bfloat16 tensor of at most 2**34 elements; anything else raises
    :class:`MXNetError`.
    """
    if not x.is_cuda:
        if x.device.type == "meta":
            return torch.empty_like(x), (None if divide
                                         else torch.empty_like(x))
        if x.device.type == "cpu":
            return dropout_plain(x, p, key, step, serial, stream, divide)
        raise MXNetError(f"dropout: no kernel for device {x.device}")
    code = _DTYPES.get(x.dtype)
    n = x.numel()
    if code is None or n > MAX_ELEMENTS or not x.is_contiguous():
        raise MXNetError(
            f"dropout: x must be a contiguous float32, float16 or bfloat16 "
            f"tensor of at most 2**34 elements, got {x.dtype} "
            f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    y = torch.empty_like(x)
    mask = None if divide else torch.empty_like(x)
    err = _lib.launch_packed(
        x, _lib.library().mxt_dropout, _PACK, x.data_ptr(), y.data_ptr(),
        0 if divide else mask.data_ptr(), n, int(key) & 0xFFFFFFFFFFFFFFFF,
        int(step) & _M32, int(serial) & _M32, int(stream) & _M32,
        keep32_value(p), code, 1 if divide else 0)
    _lib.check(err, "dropout")
    LAUNCHES.inc()
    return y, mask


class DropoutFn(torch.autograd.Function):
    """``Dropout`` in training: forward :func:`dropout`, ``(y, mask)`` with
    the mask saved; backward ``g * mask``."""

    @staticmethod
    def forward(ctx, x, p, key, step, serial, stream):
        y, mask = dropout(x, p, key, step, serial, stream)
        ctx.save_for_backward(mask)
        ctx.mark_non_differentiable(mask)
        return y, mask

    @staticmethod
    def backward(ctx, g, _gmask):
        (mask,) = ctx.saved_tensors
        return torch.mul(g, mask), None, None, None, None, None


class DivideDropoutFn(torch.autograd.Function):
    """The ``RNN`` op's dropout in training: forward :func:`dropout` with
    ``divide``; backward the same bits on the gradient, ``(g * kept) /
    keep32``, which equals the reference's ``(g / keep) * kept`` bit for
    bit. Stores no mask."""

    @staticmethod
    def forward(ctx, x, p, key, step, serial, stream):
        ctx.rng = (p, key, step, serial, stream)
        return dropout(x, p, key, step, serial, stream, divide=True)[0]

    @staticmethod
    def backward(ctx, g):
        return (dropout(g.contiguous(), *ctx.rng, divide=True)[0],
                None, None, None, None, None)
