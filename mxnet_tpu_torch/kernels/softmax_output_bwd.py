"""``softmax_output_bwd``: the SoftmaxOutput loss-layer backward.

Replaces ``bwd`` inside ``mxnet_tpu/ops/defs_nn.py`` ``_softmax_output``
(:686-737), the ``custom_vjp`` that ignores the head gradient and writes
``(p - onehot(label)) * grad_scale``, with ``use_ignore`` masking and
``batch``/``valid`` normalisation, which XLA fuses into one pass and eager
PyTorch would run as a one-hot, a subtract, a mask and two scalings.

Bound on the H100: device-memory bandwidth, one read of ``p`` and the
labels and one write of the gradient (44.6 MB on SSD-300's training call,
82 MB at the LSTM head's (1024, 10000)); at ResNet's (32, 1000) the
launch. ``csrc/softmax_output_bwd.cu`` makes one launch a call under every
normalization, planned by :func:`plan`: regime ``rows`` (class axis last,
16-byte aligned, fewer than 2**31 elements: every path) walks the flat
buffer in 16-byte chunks and finds a chunk's row and class by a 32-bit
multiply-high division by :func:`_lib.magic`'s number, reading each row's label
once per chunk; regime ``general`` (``multi_output`` with ``inner`` > 1,
views off the alignment, larger tensors) takes one element at a time.
``normalization='valid'`` under ``use_ignore`` divides by the number of
valid labels of the whole batch, which must be known before any element
is scaled: that launch is cooperative, every block counts a slice of the
labels into its integer slot of a buffer kept for the launch's stream
(``SLOTS``, so launches that share it run in order), the grid
synchronises, and every block adds the slots in integers, so no value
goes through the host and no second kernel runs. The count is exact as an
integer; the plain version's float32 sum of ones is exact below 2**24
labels, and the two agree bit for bit there (past it the reference's own
float32 sum stops being exact too). Each step of ``(p - onehot) * valid /
divisor * grad_scale`` is rounded once, in that order, as in the plain
version on the CPU, whose divisions are correctly rounded (PyTorch's CUDA
division by a Python number multiplies by the float32 reciprocal, so on the
card the plain version under ``batch`` may lie one rounding away).
The wrapper takes the light launch path (:func:`_lib.launch_packed`); the
counter below counts launches, one a call.
"""

from __future__ import annotations

import math
import struct
import threading
from collections import namedtuple

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version): one per call
LAUNCHES = _tm.counter("kernel.softmax_output_bwd.launches")
_NORM = {"null": 0, "batch": 1, "valid": 2}
# the C entry's packed arguments (csrc/softmax_output_bwd.cu Packed): p,
# label, g, the slots, outer, classes, inner, grad_scale, ignore_label,
# use_ignore, the normalization, N, the plan's regime, magic and shift,
# the stream
_PACK = struct.Struct("=4Q3q2d6qQ").pack
SLOTS = 4096  # the count's per-block slots (csrc kSlots)
INT32_MAX = 2 ** 31 - 1  # the largest element count of the rows regime

Plan = namedtuple("Plan", "regime magic shift")


def plan(outer, classes, inner, aligned):
    """The regime of a call on ``(outer, classes, inner)`` probabilities
    whose memory (and the gradient's) starts at a 16-byte boundary when
    ``aligned``: ``rows`` with the magic number of ``classes`` where
    ``inner == 1`` and there are at most ``INT32_MAX`` elements, else
    ``general``."""
    if inner == 1 and aligned and 0 < outer * classes <= INT32_MAX:
        return Plan("rows", *_lib.magic(classes))
    return Plan("general", 0, 0)


def _view(p, multi_output):
    """``(outer, classes, inner)`` of the probabilities' layout."""
    if multi_output:
        return p.shape[0], p.shape[1], math.prod(p.shape[2:])
    return math.prod(p.shape[:-1]), p.shape[-1], 1


def softmax_output_bwd_plain(p, label, grad_scale, ignore_label, use_ignore,
                             normalization, multi_output):
    """The plain PyTorch version, in the reference's order of operations."""
    outer, classes, inner = _view(p, multi_output)
    p3 = p.reshape(outer, classes, inner)
    lab = label.reshape(outer, 1, inner).to(torch.float32)
    cls = torch.arange(classes, device=p.device).reshape(1, classes, 1)
    onehot = (lab.to(torch.int32) == cls).to(p.dtype)
    grad = p3 - onehot
    valid = torch.ones_like(lab)
    if use_ignore:
        valid = (lab != ignore_label).to(p.dtype)
        grad = grad * valid
    if normalization == "batch":
        grad = grad / p.shape[0]
    elif normalization == "valid":
        grad = grad / torch.clamp_min(valid.sum(), 1.0)
    return (grad * grad_scale).reshape(p.shape)


_lock = threading.Lock()
_slots = {}
_plans = {}


def _slots_of(dev):
    """The address of the count's slot buffer for the current stream of
    CUDA device ``dev``, allocated once per (device, stream). The kernel
    writes every slot it reads, so launches that share a buffer need only
    run in order, as launches on one stream do; launches on other streams
    have buffers of their own."""
    key = (dev, torch._C._cuda_getCurrentRawStream(dev))
    buf = _slots.get(key)
    if buf is None:
        with _lock:
            buf = _slots.get(key)
            if buf is None:
                with torch.cuda.device(dev):
                    buf = _slots[key] = torch.empty(
                        SLOTS, dtype=torch.int32, device="cuda")
    return buf.data_ptr()


def softmax_output_bwd(p, label, grad_scale=1.0, ignore_label=-1.0,
                       use_ignore=False, normalization="null",
                       multi_output=False):
    """Gradient of SoftmaxOutput's input from its output ``p`` and labels.

    ``p`` is the forward's output in the data's layout: ``(N, C, ...)``
    with the class axis 1 under ``multi_output``, else the class axis last
    (``(N, K)`` or, with ``preserve_shape``, ``(..., K)``); ``label`` has
    ``p``'s shape without the class axis. Under ``multi_output`` ``p`` may
    also be the class-major view of class-last memory (SSD's transposed
    class scores); the gradient then comes back in the same layout.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel, which takes contiguous float32 ``p`` and ``label`` (other label
    dtypes and layouts are cast) on one device; anything else raises
    :class:`MXNetError`.
    """
    mode = _NORM.get(normalization)
    if mode is None:
        raise MXNetError(f"SoftmaxOutput: unknown normalization "
                         f"{normalization!r}")
    if not p.is_cuda:
        if p.device.type == "cpu":
            return softmax_output_bwd_plain(p, label, grad_scale,
                                            ignore_label, use_ignore,
                                            normalization, multi_output)
        raise MXNetError(f"softmax_output_bwd: no kernel for device "
                         f"{p.device}")
    if multi_output and p.dim() > 2 and not p.is_contiguous():
        moved = p.movedim(1, -1)
        if moved.is_contiguous():
            # the class-major view of class-last memory (SSD's cls_prob):
            # the same function with the class axis last, no copy
            return softmax_output_bwd(
                moved, label, grad_scale, ignore_label, use_ignore,
                normalization, multi_output=False).movedim(-1, 1)
    if p.dtype is not torch.float32 or not p.is_contiguous():
        _lib.check_f32("softmax_output_bwd: p", p, p.device)
    outer, classes, inner = _view(p, multi_output)
    dev = p.get_device()
    if label.dtype is not torch.float32 or not label.is_contiguous():
        label = label.to(torch.float32).contiguous()
    if (not label.is_cuda or label.get_device() != dev
            or label.numel() != outer * inner):
        raise MXNetError(
            f"softmax_output_bwd: label {tuple(label.shape)} on "
            f"{label.device} does not match p {tuple(p.shape)} on {p.device}")
    g = torch.empty_like(p)
    if not g.numel():
        return g
    aligned = (p.data_ptr() | g.data_ptr()) % 16 == 0
    key = (outer, classes, inner, aligned)
    pl = _plans.get(key)
    if pl is None:
        pl = _plans[key] = plan(outer, classes, inner, aligned)
    err = _lib.launch_packed(
        p, _lib.library().mxt_softmax_output_bwd_f32, _PACK, p.data_ptr(),
        label.data_ptr(), g.data_ptr(),
        _slots_of(dev) if mode == 2 and use_ignore else 0, outer,
        classes, inner, float(grad_scale), float(ignore_label),
        1 if use_ignore else 0, mode, p.shape[0],
        0 if pl.regime == "rows" else 1, pl.magic, pl.shift)
    _lib.check(err, "softmax_output_bwd")
    LAUNCHES.inc()
    return g
