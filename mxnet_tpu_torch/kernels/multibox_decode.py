"""``multibox_decode``: the per-anchor part of SSD's detection head.

Replaces the body of ``mxnet_tpu/ops/defs_contrib.py``
``_multibox_detection`` up to the NMS (:256-279): the foreground max and
first-index argmax over the class probabilities, ``score > threshold`` and
``_decode_boxes`` (:134-146) with the variances and the clip; on the SSD
path together with the channel ``SoftmaxActivation`` that feeds it
(``mxnet_tpu/ops/defs_nn.py:671-676``). XLA fuses these into one pass; eager
PyTorch would run some twenty launches. The executor routes a
``SoftmaxActivation(mode="channel")`` whose only consumer is a
``MultiBoxDetection`` to this kernel with the softmax fused
(``executor._fused_detection``); ``MultiBoxDetection`` alone runs it on
probabilities. ``valid`` is not stored: the NMS kernel compares the score
with the threshold itself.

Bound on the H100: launch latency. At SSD-300, batch 8 (A = 8096 anchors,
21 classes) it moves about 8 MB, ~2.4 us at 3.35 TB/s.
``csrc/multibox_decode.cu`` runs one thread per (image, anchor), reads the
class scores through the strides of the (n, C+1, A) view it is given (on
the SSD path a ``transpose(0, 2, 1)`` of an (n, A, C+1) array, so nothing
is copied), and keeps the reference's order of operations without FMA
contraction, with ``expf`` as ``jax.nn.softmax`` and ``jnp.exp`` take it.
"""

from __future__ import annotations

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version)
LAUNCHES = _tm.counter("kernel.multibox_decode.launches")


def channel_softmax(x):
    """``jax.nn.softmax(x, axis=1)`` op by op: ``exp(x - max) / sum``.
    The plain version's first step and the body of
    ``SoftmaxActivation(mode="channel")``."""
    e = torch.exp(x - torch.amax(x, dim=1, keepdim=True))
    return e / torch.sum(e, dim=1, keepdim=True)


def decode_boxes(loc, anchors, variances, clip):
    """``_decode_boxes`` of the reference: center offsets ``loc`` (..., A,
    4) against corner-format ``anchors`` (A, 4), with the variances, in
    its order of operations; corners clipped to [0, 1] with ``clip``."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    cx = loc[..., 0] * variances[0] * aw + acx
    cy = loc[..., 1] * variances[1] * ah + acy
    w = torch.exp(loc[..., 2] * variances[2]) * aw / 2
    h = torch.exp(loc[..., 3] * variances[3]) * ah / 2
    out = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
    return torch.clamp(out, 0.0, 1.0) if clip else out


def multibox_decode_plain(cls, loc, anchors, variances, clip, softmax):
    """The plain PyTorch version: ``(boxes (n, A, 4), score (n, A),
    cls_id (n, A) int32)``."""
    n, _c1, a = cls.shape
    prob = channel_softmax(cls) if softmax else cls
    fg = prob[:, 1:]
    cls_id = torch.argmax(fg, dim=1)
    score = torch.amax(fg, dim=1)
    boxes = decode_boxes(loc.reshape(n, a, 4), anchors.reshape(a, 4),
                         variances, clip)
    return boxes, score, cls_id.to(torch.int32)


def multibox_decode(cls, loc, anchors, variances, clip, softmax):
    """Best foreground class, its score and the decoded box of every
    anchor.

    ``cls`` is ``(n, C+1, A)`` (logits with ``softmax``, else
    probabilities; class 0 is the background), ``loc`` ``(n, 4A)`` box
    offsets, ``anchors`` ``(1, A, 4)`` corner-format boxes. Returns
    ``(boxes (n, A, 4), score (n, A), cls_id (n, A) int32)``.

    A CPU (or shape-only ``meta``) tensor takes the plain version. A CUDA
    tensor launches the kernel, which takes float32 ``cls`` of any strides
    and contiguous, 16-byte aligned float32 ``loc`` and ``anchors`` on the
    same device; anything else raises :class:`MXNetError`.
    """
    if cls.device.type in ("cpu", "meta"):
        return multibox_decode_plain(cls, loc, anchors, variances, clip,
                                     softmax)
    if cls.device.type != "cuda":
        raise MXNetError(f"multibox_decode: no kernel for device "
                         f"{cls.device}")
    if cls.dtype != torch.float32 or cls.dim() != 3 or cls.shape[1] < 2:
        raise MXNetError(
            f"multibox_decode: class scores must be float32 (n, C+1, A) with "
            f"C >= 1, got {cls.dtype} {tuple(cls.shape)}")
    n, c1, a = cls.shape
    _lib.check_f32("multibox_decode: loc", loc, cls.device, (n, 4 * a))
    _lib.check_f32("multibox_decode: anchors", anchors, cls.device,
                   (1, a, 4))
    if loc.data_ptr() % 16 or anchors.data_ptr() % 16:
        raise MXNetError("multibox_decode: kernel needs 16-byte aligned loc "
                         "and anchors")
    if (n * a + 127) // 128 >= 2 ** 31:
        raise MXNetError(f"multibox_decode: {n * a} anchors exceed the "
                         "kernel's grid")
    boxes = torch.empty((n, a, 4), dtype=torch.float32, device=cls.device)
    score = torch.empty((n, a), dtype=torch.float32, device=cls.device)
    cls_id = torch.empty((n, a), dtype=torch.int32, device=cls.device)
    v = [float(x) for x in variances]
    lib = _lib.library()
    with torch.cuda.device(cls.device):
        err = lib.mxt_multibox_decode_f32(
            cls.data_ptr(), *cls.stride(), loc.data_ptr(), anchors.data_ptr(),
            boxes.data_ptr(), score.data_ptr(), cls_id.data_ptr(), n, c1, a,
            *v, int(bool(clip)), int(bool(softmax)), _lib.stream_of(cls))
    _lib.check(err, "multibox_decode")
    LAUNCHES.inc()
    return boxes, score, cls_id
