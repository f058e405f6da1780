"""``softmax_rows``: the SoftmaxOutput forward.

Replaces ``forward`` inside ``mxnet_tpu/ops/defs_nn.py`` ``_softmax_output``
(``jax.nn.softmax`` over the class axis), which XLA fuses into one pass and
eager PyTorch would run as a max, a subtract, an exp, a sum and a divide.

Bound on the H100: launch latency. On the serving path the input is
``(bucket, 1000)`` float32, at most 32 x 1000 x 8 B = 256 KB moved, well
under a microsecond of device-memory time. The kernel
(``csrc/softmax_rows.cu``) gives one block to each row, loops over the
columns for any width and reduces the float32 max and sum with warp
shuffles and shared memory; the one launch per forward is all it can cost.

``multi_output`` and ``preserve_shape`` reach the same kernel:
:func:`softmax` moves the class axis last, makes the array contiguous and
moves the axis back.
"""

from __future__ import annotations

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version)
LAUNCHES = _tm.counter("kernel.softmax_rows.launches")


def softmax_rows_plain(x):
    """The plain PyTorch version over the last axis: ``exp(x - max) /
    sum(exp(x - max))``, as ``jax.nn.softmax`` computes it."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def softmax_rows(x):
    """Softmax of each row of a 2-D ``(rows, cols)`` tensor.

    A CPU (or shape-only ``meta``) tensor takes the plain version. A CUDA
    tensor launches the kernel, which takes a contiguous float32 2-D
    tensor; anything else raises :class:`MXNetError`.
    """
    if x.device.type in ("cpu", "meta"):
        return softmax_rows_plain(x)
    if x.device.type != "cuda":
        raise MXNetError(f"softmax_rows: no kernel for device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise MXNetError(
            f"softmax_rows: kernel takes a contiguous float32 (rows, cols) "
            f"tensor, got {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()}")
    rows, cols = x.shape
    if rows >= 2 ** 31:
        raise MXNetError(f"softmax_rows: {rows} rows exceed the kernel's grid")
    y = torch.empty_like(x)
    lib = _lib.library()
    with torch.cuda.device(x.device):
        err = lib.mxt_softmax_rows_f32(
            x.data_ptr(), y.data_ptr(), rows, cols,
            torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(err, "softmax_rows")
    LAUNCHES.inc()
    return y


def softmax(x, axis):
    """Softmax over ``axis`` of any-rank ``x`` through :func:`softmax_rows`."""
    moved = torch.movedim(x, axis, -1)
    flat = moved.contiguous().reshape(-1, moved.shape[-1])
    return torch.movedim(softmax_rows(flat).reshape(moved.shape), -1, axis)
