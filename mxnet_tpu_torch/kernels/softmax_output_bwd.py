"""``softmax_output_bwd``: the SoftmaxOutput loss-layer backward.

Replaces ``bwd`` inside ``mxnet_tpu/ops/defs_nn.py`` ``_softmax_output``
(:686-737), the ``custom_vjp`` that ignores the head gradient and writes
``(p - onehot(label)) * grad_scale``, with ``use_ignore`` masking and
``batch``/``valid`` normalisation, which XLA fuses into one pass and eager
PyTorch would run as a one-hot, a subtract, a mask and two scalings.

Bound on the H100: launch latency. On the training path ``p`` is
``(32, 1000)`` float32, 256 KB read and written. ``csrc/softmax_output_bwd.cu``
runs one thread per element over the ``(outer, classes, inner)`` view of
``p`` (``inner`` > 1 only for ``multi_output``). ``normalization='valid'``
divides by the number of valid labels in the whole batch, which must be
known before any element is scaled: the C entry first launches a one-block
kernel that counts them into a device scalar, so no value goes through
the host. The counter below counts calls, one per backward.
"""

from __future__ import annotations

import math

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version): one per call, two
# under normalization='valid' (the count of valid labels, then the rows)
LAUNCHES = _tm.counter("kernel.softmax_output_bwd.launches")
_NORM = {"null": 0, "batch": 1, "valid": 2}


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


def softmax_output_bwd(p, label, grad_scale=1.0, ignore_label=-1.0,
                       use_ignore=False, normalization="null",
                       multi_output=False):
    """Gradient of SoftmaxOutput's input from its output ``p`` and labels.

    ``p`` is the forward's output in the data's layout: ``(N, C, ...)``
    with the class axis 1 under ``multi_output``, else the class axis last
    (``(N, K)`` or, with ``preserve_shape``, ``(..., K)``); ``label`` has
    ``p``'s shape without the class axis.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel, which takes contiguous float32 ``p`` and ``label`` (other label
    dtypes are cast) on one device; anything else raises
    :class:`MXNetError`.
    """
    if normalization not in _NORM:
        raise MXNetError(f"SoftmaxOutput: unknown normalization "
                         f"{normalization!r}")
    if p.device.type == "cpu":
        return softmax_output_bwd_plain(p, label, grad_scale, ignore_label,
                                        use_ignore, normalization,
                                        multi_output)
    if p.device.type != "cuda":
        raise MXNetError(f"softmax_output_bwd: no kernel for device "
                         f"{p.device}")
    _lib.check_f32("softmax_output_bwd: p", p, p.device)
    outer, classes, inner = _view(p, multi_output)
    label = label.to(torch.float32).contiguous()
    if label.device != p.device or label.numel() != outer * inner:
        raise MXNetError(
            f"softmax_output_bwd: label {tuple(label.shape)} on "
            f"{label.device} does not match p {tuple(p.shape)} on {p.device}")
    g = torch.empty_like(p)
    count = torch.empty(1, device=p.device)
    lib = _lib.library()
    with torch.cuda.device(p.device):
        err = lib.mxt_softmax_output_bwd_f32(
            p.data_ptr(), label.data_ptr(), g.data_ptr(), count.data_ptr(),
            outer, classes, inner, float(grad_scale), float(ignore_label),
            int(bool(use_ignore)), _NORM[normalization], float(p.shape[0]),
            _lib.stream_of(p))
    _lib.check(err, "softmax_output_bwd")
    LAUNCHES.inc(2 if normalization == "valid" else 1)
    return g
