"""``nms``: greedy non-maximum suppression of SSD detections.

Replaces ``mxnet_tpu/ops/defs_contrib.py`` ``_nms_keep`` (:234-253) and
the assembly of ``_multibox_detection``'s output rows (:274-277). The
reference builds the (A, A) IoU matrix of the boxes in descending score
order and runs an A-step ``jax.lax.fori_loop`` over it: box i is kept when
it is valid (``score > threshold``) and no kept box before it overlaps it
by more than ``nms_threshold`` in the same class (any class with
``force_suppress``). At A = 8096 anchors per image, eager PyTorch cannot
run that as a handful of launches.

Bound on the H100: operations. At SSD-300, batch 8, the mask kernel does
n * A^2 / 2 ~ 262 M IoUs and writes 65.8 MB of suppression words; the scan
is a dependency chain of 127 64-box chunks per image.
``csrc/nms.cu`` has two kernels, so each call launches twice: the mask
kernel reads the boxes through ``order`` (no sorted copy) and writes a
64-bit word per (valid row box, later 64-box block); the scan kernel, one block
per image, stages the diagonal words and validity bits in shared memory
(so A <= 27712 anchors), resolves each chunk against its diagonal words,
ORs the kept rows' words into the removed vector, and writes the (n, A, 6)
rows ``(keep ? cls : -1, score, box)`` in anchor order. IoU is computed as
``_iou_matrix`` does, without FMA contraction, and compared strictly
against the float32 threshold, so the keep mask is the reference's bit for
bit on the same inputs.

``nms_topk`` and ``background_id`` are parsed by the reference and never
used: NMS runs over all A anchors, here as there.
"""

from __future__ import annotations

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version): two per call
LAUNCHES = _tm.counter("kernel.nms.launches")
_ROW_BLOCK = 1024  # rows of the IoU matrix the plain version holds at once


def iou_matrix(anchors, gt):
    """``_iou_matrix`` of the reference: (A, 4) x (G, 4) corner-format
    boxes -> IoU (A, G), in its order of operations."""
    ax1, ay1, ax2, ay2 = [anchors[:, i, None] for i in range(4)]
    gx1, gy1, gx2, gy2 = [gt[None, :, i] for i in range(4)]
    iw = torch.clamp(torch.minimum(ax2, gx2) - torch.maximum(ax1, gx1), min=0)
    ih = torch.clamp(torch.minimum(ay2, gy2) - torch.maximum(ay1, gy1), min=0)
    inter = iw * ih
    area_a = torch.clamp(ax2 - ax1, min=0) * torch.clamp(ay2 - ay1, min=0)
    area_g = torch.clamp(gx2 - gx1, min=0) * torch.clamp(gy2 - gy1, min=0)
    union = area_a + area_g - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def keep_sorted(boxes_o, valid_o, cls_o, nms_threshold, force):
    """The reference's ``fori_loop``: the keep mask of boxes already in
    descending score order. Box i is kept when valid and no kept box
    before it suppresses it; the IoU matrix is built ``_ROW_BLOCK`` rows at
    a time."""
    a = boxes_o.shape[0]
    keep = valid_o.clone()
    thr = torch.tensor(nms_threshold, dtype=boxes_o.dtype)
    for r0 in range(0, a, _ROW_BLOCK):
        r1 = min(a, r0 + _ROW_BLOCK)
        sup = iou_matrix(boxes_o[r0:r1], boxes_o[:r1]) > thr
        if not force:
            sup &= cls_o[r0:r1, None] == cls_o[None, :r1]
        for i in range(max(r0, 1), r1):
            keep[i] &= ~torch.any(sup[i - r0, :i] & keep[:i])
    return keep


def nms_keep_plain(boxes, scores, valid, nms_threshold, force, cls_ids):
    """``_nms_keep`` of the reference, for one image: the keep mask in
    anchor order (stable descending sort, as ``jnp.argsort(-scores)``)."""
    order = torch.argsort(-scores, stable=True)
    keep_o = keep_sorted(boxes[order], valid[order], cls_ids[order],
                         nms_threshold, force)
    keep = torch.empty_like(keep_o)
    keep[order] = keep_o
    return keep


def nms_plain(boxes, score, cls_id, order, threshold, nms_threshold, force):
    """The plain PyTorch version: the (n, A, 6) rows ``(keep ? cls : -1,
    score, box)`` in anchor order, image by image."""
    n, a = score.shape
    out = torch.empty((n, a, 6), dtype=boxes.dtype, device=boxes.device)
    thr = torch.tensor(threshold, dtype=score.dtype)
    for b in range(n):
        o = order[b]
        keep_o = keep_sorted(boxes[b][o], score[b][o] > thr, cls_id[b][o],
                             nms_threshold, force)
        keep = torch.empty_like(keep_o)
        keep[o] = keep_o
        out[b, :, 0] = torch.where(keep, cls_id[b].to(boxes.dtype),
                                   torch.full_like(score[b], -1.0))
        out[b, :, 1] = score[b]
        out[b, :, 2:] = boxes[b]
    return out


def nms(boxes, score, cls_id, order, threshold, nms_threshold, force):
    """Greedy NMS over every image's anchors: ``(n, A, 6)`` rows
    ``(keep ? cls : -1, score, box)`` in anchor order.

    ``boxes`` (n, A, 4) corner format, ``score`` (n, A), ``cls_id`` (n, A)
    int32, ``order`` (n, A) int64 — each image's anchors by descending
    score, stable (``torch.argsort(-score, dim=1, stable=True)``). A box is
    valid when ``score > threshold``; a kept box suppresses a later one of
    its class (any class with ``force``) when their IoU exceeds
    ``nms_threshold``.

    A CPU tensor takes the plain version and a ``meta`` tensor gives the
    output's shape. A CUDA tensor launches the two kernels, which take
    contiguous tensors of these dtypes on one device, ``boxes`` 16-byte
    aligned; anything else raises :class:`MXNetError`.
    """
    if boxes.device.type == "meta":
        return torch.empty((*score.shape, 6), dtype=boxes.dtype,
                           device="meta")
    if boxes.device.type == "cpu":
        return nms_plain(boxes, score, cls_id, order, threshold,
                         nms_threshold, force)
    if boxes.device.type != "cuda":
        raise MXNetError(f"nms: no kernel for device {boxes.device}")
    if score.dim() != 2:
        raise MXNetError(f"nms: score must be (n, A), got "
                         f"{tuple(score.shape)}")
    n, a = score.shape
    dev = boxes.device
    _lib.check_f32("nms: boxes", boxes, dev, (n, a, 4))
    _lib.check_f32("nms: score", score, dev, (n, a))
    for name, t, dtype in (("cls_id", cls_id, torch.int32),
                           ("order", order, torch.int64)):
        if (t.dtype != dtype or tuple(t.shape) != (n, a)
                or not t.is_contiguous() or t.device != dev):
            raise MXNetError(
                f"nms: {name} must be a contiguous {dtype} ({n}, {a}) tensor "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if boxes.data_ptr() % 16:
        raise MXNetError("nms: kernel needs 16-byte aligned boxes")
    words = (a + 63) // 64
    # grid (words, words, n); the scan holds 67 words per 64 boxes in
    # shared memory (227 KB a block: A <= 27712)
    if words > 65535 or n > 65535 or 536 * words > 232448:
        raise MXNetError(f"nms: {n} images of {a} anchors exceed the "
                         "kernels' grid or shared memory")
    mask = torch.empty((n, a, words), dtype=torch.int64, device=dev)
    out = torch.empty((n, a, 6), dtype=torch.float32, device=dev)
    lib = _lib.library()
    stream = _lib.stream_of(boxes)
    with torch.cuda.device(dev):
        err = lib.mxt_nms_mask_f32(
            boxes.data_ptr(), cls_id.data_ptr(), score.data_ptr(),
            order.data_ptr(), mask.data_ptr(), n, a, float(threshold),
            float(nms_threshold), int(bool(force)), stream)
        _lib.check(err, "nms (mask)")
        LAUNCHES.inc()
        err = lib.mxt_nms_scan_f32(
            mask.data_ptr(), boxes.data_ptr(), score.data_ptr(),
            cls_id.data_ptr(), order.data_ptr(), out.data_ptr(), n, a,
            float(threshold), stream)
    _lib.check(err, "nms (scan)")
    LAUNCHES.inc()
    return out
