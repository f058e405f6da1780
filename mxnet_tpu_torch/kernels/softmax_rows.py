"""``softmax_rows``: the SoftmaxOutput forward.

Replaces ``forward`` inside ``mxnet_tpu/ops/defs_nn.py`` ``_softmax_output``
(``jax.nn.softmax`` over the class axis, :703), which XLA fuses into one
pass and eager PyTorch would run as a max, a subtract, an exp, a sum and a
divide.

Bound on the H100: device-memory bandwidth, 8 bytes per element (the input
read once, the output written once): 0.013 ms for SSD training's
(259072, 21), 0.0245 ms for the LSTM head's (1024, 10000); ResNet's
(32, 1000) moves 256 KB, so its launch is the cost. ``csrc/softmax_rows.cu``
picks a design by the column count C, each reading and writing every
element once: C <= 32 a tile of 256 rows per block, brought into shared
memory by one bulk asynchronous copy and written back by one bulk store,
one thread per row; C <= 4096 one warp per row with the row in registers
and 16-byte accesses; wider rows one block per row staged in shared
memory (rows beyond the card's shared memory loop over device memory).
The wrapper takes the light launch path (:func:`_lib.launch`): no device
switch when the tensor's device is current, the raw current stream.

``multi_output`` and ``preserve_shape`` reach the same kernel:
:func:`softmax` moves the class axis last, makes the array contiguous and
moves the axis back (no copy where the moved view is already contiguous,
as SSD's class-major head is).
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
    if not x.is_cuda:
        if x.device.type in ("cpu", "meta"):
            return softmax_rows_plain(x)
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
    err = _lib.launch(x, _lib.library().mxt_softmax_rows_f32, x.data_ptr(),
                      y.data_ptr(), rows, cols)
    _lib.check(err, "softmax_rows")
    LAUNCHES.inc()
    return y


def softmax(x, axis):
    """Softmax over ``axis`` of any-rank ``x`` through :func:`softmax_rows`."""
    moved = torch.movedim(x, axis, -1)
    flat = moved.contiguous().reshape(-1, moved.shape[-1])
    return torch.movedim(softmax_rows(flat).reshape(moved.shape), -1, axis)
