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
(``executor._run_detection``); ``MultiBoxDetection`` alone runs it on
probabilities. ``valid`` is not stored: the NMS kernel compares the score
with the threshold itself.

Bound on the H100: device-memory bandwidth. At SSD-300, batch 8 (A = 8096
anchors, 21 classes) it reads 6.6 MB and writes 1.55 MB, ~2.4 us at 3.35
TB/s; at batch 32 four times that. ``csrc/multibox_decode.cu`` takes the
class scores through the strides of the (n, C+1, A) view it is given
(nothing is copied) and chooses its body by them (:func:`body`): on both
SSD paths the view is a ``transpose(0, 2, 1)`` of an (n, A, C+1) array,
whose rows a block stages in shared memory with coalesced 16-byte loads
(``rows``); any other strides or alignment go through the strides
(``strided``: a class-major view's reads are coalesced there), and more
classes than a block's shared memory holds through the ``wide`` body. Each
exponential is computed once, and the reference's order of operations is
kept without FMA contraction, with ``expf`` as ``jax.nn.softmax`` and
``jnp.exp`` take it. :func:`plan` sizes the blocks (``ANCHORS`` a block).
The wrapper takes the light launch path (:func:`_lib.launch_packed`, the
layout checked in one compound test and its plan cached), and its three
outputs are views of one allocation: the boxes (16-byte aligned), the
scores, the class ids.
"""

from __future__ import annotations

import struct
from collections import namedtuple

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version)
LAUNCHES = _tm.counter("kernel.multibox_decode.launches")
# the C entry's packed arguments (csrc/multibox_decode.cu Packed): cls,
# loc, anchors, boxes, score, cls_id, the strides sn, sc, sa, n, C+1, A,
# the four variances, clip, softmax, the plan's body, threads (anchors a
# block), grid and dynamic shared-memory bytes, the stream
_PACK = struct.Struct("=6Q6q4d6qQ").pack
BODIES = ("rows", "strided", "wide")
# anchors a block (a thread each), chosen by a sweep of 32 to 256 on the
# H100 (PERF.md): 128 is the fastest or level at SSD serving buckets 1 and
# 8 and at training's batch 32, bucket 1's 64 blocks included (a block's
# time is its latency chain, so a grid that covers the SMs with 32-anchor
# blocks is no faster); a staged block holds T (C+1) floats of shared
# memory, at most SMEM_LIMIT bytes (past that, fewer anchors a block, down
# to 32, then the wide body)
ANCHORS = 128
SMEM_LIMIT = 48 * 1024


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


Plan = namedtuple("Plan", "body threads grid smem")


def body(n, c1, a, strides, aligned):
    """The kernel's body for class scores ``(n, c1, a)`` with ``strides``
    ``(sn, sc, sa)``, whose data starts on a 16-byte boundary when
    ``aligned``: ``rows`` where each anchor's scores are a contiguous row
    and the rows of all images follow each other (the SSD paths'
    transposed view), ``strided`` otherwise."""
    sn, sc, sa = strides
    if sc == 1 and sa == c1 and (n == 1 or sn == a * c1) and aligned:
        return "rows"
    return "strided"


def plan(n, c1, a, strides, aligned):
    """The launch for class scores ``(n, c1, a)`` of ``strides``: the body,
    the anchors a block (``ANCHORS``, halved while ``T (C+1)`` floats
    exceed ``SMEM_LIMIT``), the grid that covers every anchor once and the
    shared-memory bytes; ``wide`` with no shared memory where 32 anchors'
    scores do not fit."""
    total = n * a
    threads = ANCHORS
    while threads > 32 and threads * c1 * 4 > SMEM_LIMIT:
        threads //= 2
    if threads * c1 * 4 > SMEM_LIMIT:
        return Plan("wide", 128, -(-total // 128), 0)
    return Plan(body(n, c1, a, strides, aligned), threads,
                -(-total // threads), threads * c1 * 4)


# (dtype, shape, strides, device, aligned) of the scores -> (loc's shape,
# the anchors' shape, (n, A), the packed struct's fields after the
# pointers and variances: strides, n, C+1 and A; then the plan's)
_layouts = {}


def _layout(cls, key):
    if cls.dtype != torch.float32 or cls.dim() != 3 or cls.shape[1] < 2:
        raise MXNetError(
            f"multibox_decode: class scores must be float32 (n, C+1, A) with "
            f"C >= 1, got {cls.dtype} {tuple(cls.shape)}")
    n, c1, a = cls.shape
    p = plan(n, c1, a, cls.stride(), key[4])
    if p.grid >= 2 ** 31:
        raise MXNetError(f"multibox_decode: {n * a} anchors exceed the "
                         "kernel's grid")
    return ((n, 4 * a), (1, a, 4), (n, a), (*cls.stride(), n, c1, a),
            (BODIES.index(p.body), p.threads, p.grid, p.smem))


def multibox_decode(cls, loc, anchors, variances, clip, softmax):
    """Best foreground class, its score and the decoded box of every
    anchor.

    ``cls`` is ``(n, C+1, A)`` (logits with ``softmax``, else
    probabilities; class 0 is the background), ``loc`` ``(n, 4A)`` box
    offsets, ``anchors`` ``(1, A, 4)`` corner-format boxes. Returns
    ``(boxes (n, A, 4), score (n, A), cls_id (n, A) int32)``, views of one
    allocation.

    A CPU (or shape-only ``meta``) tensor takes the plain version. A CUDA
    tensor launches the kernel, which takes float32 ``cls`` of any strides
    and contiguous, 16-byte aligned float32 ``loc`` and ``anchors`` on the
    same device; anything else raises :class:`MXNetError`.
    """
    if not cls.is_cuda:
        if cls.device.type in ("cpu", "meta"):
            return multibox_decode_plain(cls, loc, anchors, variances, clip,
                                         softmax)
        raise MXNetError(f"multibox_decode: no kernel for device "
                         f"{cls.device}")
    dev = cls.get_device()
    cp = cls.data_ptr()
    key = (cls.dtype, cls.shape, cls.stride(), dev, cp % 16 == 0)
    lay = _layouts.get(key)
    if lay is None:
        lay = _layouts[key] = _layout(cls, key)
    f32 = torch.float32
    lp, ap = loc.data_ptr(), anchors.data_ptr()
    # one compound check of loc and anchors; get_device() is -1 on the CPU
    if not (loc.dtype is f32 and loc.get_device() == dev
            and loc.shape == lay[0] and loc.is_contiguous()
            and anchors.dtype is f32 and anchors.get_device() == dev
            and anchors.shape == lay[1] and anchors.is_contiguous()
            and not lp % 16 and not ap % 16):
        _lib.check_f32("multibox_decode: loc", loc, cls.device, lay[0])
        _lib.check_f32("multibox_decode: anchors", anchors, cls.device,
                       lay[1])
        raise MXNetError("multibox_decode: kernel needs 16-byte aligned loc "
                         "and anchors")
    return _launch(cls, cp, lp, ap, lay[2], lay[3], lay[4], variances, clip,
                   softmax)


def outputs(n, a, device):
    """``(boxes (n, a, 4), score (n, a), cls_id (n, a) int32)``: contiguous
    views of one float32 allocation, the boxes first (16-byte aligned),
    then the scores, then the class ids."""
    buf = torch.empty((6, n, a), dtype=torch.float32, device=device)
    return (buf.as_strided((n, a, 4), (4 * a, 4, 1)), buf[4],
            buf[5].view(torch.int32))


def _launch(cls, cp, lp, ap, na, sizes, fields, variances, clip, softmax):
    boxes, score, cls_id = outputs(*na, cls.device)
    if not boxes.numel():
        return boxes, score, cls_id
    v0, v1, v2, v3 = variances
    bp = boxes.data_ptr()
    m = score.numel()
    err = _lib.launch_packed(
        cls, _lib.library().mxt_multibox_decode_f32, _PACK, cp, lp, ap, bp,
        bp + 16 * m, bp + 20 * m, *sizes, float(v0), float(v1), float(v2),
        float(v3), 1 if clip else 0, 1 if softmax else 0, *fields)
    _lib.check(err, "multibox_decode")
    LAUNCHES.inc()
    return boxes, score, cls_id
