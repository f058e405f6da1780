"""``nms``: greedy non-maximum suppression of SSD detections.

Replaces ``mxnet_tpu/ops/defs_contrib.py`` ``_nms_keep`` (:234-253) and
the assembly of ``_multibox_detection``'s output rows (:274-277). The
reference builds the (A, A) IoU matrix of the boxes in descending score
order and runs an A-step ``jax.lax.fori_loop`` over it: box i is kept when
it is valid (``score > threshold``) and no kept box before it overlaps it
by more than ``nms_threshold`` in the same class (any class with
``force_suppress``). At A = 8096 anchors per image, eager PyTorch cannot
run that as a handful of launches.

Bound on the H100: operations, the same-class IoUs the kept boxes need
(17.1 M at SSD-300 batch 8), but what holds greedy NMS back is its
dependency chain. Without ``force`` a box suppresses only boxes of its own
class, so greedy NMS splits exactly into (image, class) segments; with
``force``, or without the class count, the segment is the image.
``csrc/nms.cu`` gives each segment a block (``nms_segment_kernel``) that
gathers its members from ``order`` by a stable ballot compaction; a
segment of at most :attr:`Plan.lmax` boxes (256) runs its chain there, in
shared memory, testing later boxes against each 64-box chunk's kept boxes
only; block 0 of an image writes the rows of its invalid anchors. The
classes are uneven (the longest of SSD-300's 20 holds ~2480 of 8096 boxes
on its random-weight heads), and one chain's tests grow as L^2 on one SM,
so a longer segment goes to the scratch, where ``nms_mask_kernel``
computes its suppression words over the whole card and
``nms_chain_kernel`` resolves it chunk by chunk from them: launches that
:func:`plan` makes only where a long segment is possible. A valid class id
outside ``[0, classes)`` makes its image one segment. IoU is computed as
``_iou_matrix`` does, without FMA contraction, and compared strictly
against the float32 threshold, so the keep mask is the reference's bit
for bit on the same inputs.

``nms_topk`` and ``background_id`` are parsed by the reference and never
used: NMS runs over all A anchors, here as there.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib

# counts kernel launches only (never the plain version): plan().launches
# per call, one or three
LAUNCHES = _tm.counter("kernel.nms.launches")
_ROW_BLOCK = 1024  # rows of the IoU matrix the plain version holds at once
CHUNK = 64  # boxes per chain step (bits of a word)
# the C entry's packed arguments (csrc/nms.cu Packed): six pointers, n, a,
# classes, force, the two thresholds, the plan's seven fields, the stream
_PACK = struct.Struct("=6Q4q2d7qQ").pack
# L_max, the longest segment a block chains in shared memory: on the H100
# one chain of L boxes takes ~0.65 ms at L = 2480 and grows as L^2, while
# the mask route spreads the tests over the card; of the L_max settings
# ``chip_smoke.py --nms-plans`` timed on the SSD heads (256 to 1024), 256
# took the least device time at batches 8 and 32 (PERF.md)
ONCHIP = 256
THREADS = 512  # threads of a segment block and of a chain block
MASK_BLOCKS = 16 * 132  # the mask kernel's fixed grid: 16 blocks an SM
MAX_ENTRIES = 12287  # images x segments + 1 ints of the mask kernel <= 48 KB
MAX_WORDS = 3072  # ceil(A / 64): the chain block's two bitmaps <= 48 KB


def seg_bytes(cap):
    """Bytes a segment of ``cap`` boxes (a multiple of 64) takes in shared
    memory: a box (16), a diagonal word (8), a class and an anchor index
    (4 each), a removed flag (1) each, and a keep word per 64 boxes: 33.125
    a box."""
    return 33 * cap + cap // 8


def seg_limit(smem_limit):
    """The most boxes, a multiple of 64, whose segment fits ``smem_limit``
    bytes of shared memory."""
    cap = smem_limit * 8 // 265 // CHUNK * CHUNK
    while cap > 0 and seg_bytes(cap) > smem_limit:
        cap -= CHUNK
    return cap


def _ceil(a, b):
    return -(-a // b)


class Plan(NamedTuple):
    """How one call runs: ``segments`` blocks per image (the classes, or 1)
    of ``threads`` threads for the segment kernel, each chaining up to
    ``cap`` boxes in ``smem`` bytes of dynamic shared memory (``lmax``:
    the longest segment a block chains, ``ONCHIP`` where the card's shared
    memory holds it; ``cap`` is ``lmax`` or A rounded up to 64, the
    smaller); where a segment can be longer (A > ``cap``), the mask kernel
    on ``mask_blocks`` blocks and the chain kernel on as many blocks as
    the segment kernel, over ``scratch`` bytes; ``launches`` per call."""

    segments: int
    lmax: int
    cap: int
    threads: int
    smem: int
    mask_blocks: int
    scratch: int
    launches: int


@functools.lru_cache(maxsize=1024)
def plan(n, a, classes, force, smem_limit, onchip=ONCHIP):
    """The launches of a call on ``n`` images of ``a`` anchors: segments by
    class when ``classes`` (the class count) is given and ``force`` is off
    (whole images where ``n * classes`` segments would not fit the mask
    kernel's table), else one segment per image; ``smem_limit`` bytes of
    shared memory per segment block. A segment longer than L_max can exist
    only when ``a > lmax``: then the mask and chain kernels are launched,
    and the scratch holds every anchor's box, class and index (24 bytes),
    its suppression words (8 bytes per 64 anchors of the image) and a
    descriptor per segment (16 bytes). ``onchip`` is L_max where the shared
    memory allows it. A pure function; the C entry checks the plan it is
    given."""
    lmax = min(onchip, seg_limit(smem_limit))
    if lmax < CHUNK:
        raise MXNetError(f"nms: {smem_limit} bytes of shared memory hold no "
                         f"{CHUNK}-box segment")
    segments = classes if classes and not force else 1
    if n * segments + 1 > MAX_ENTRIES:
        segments = 1
    cap = min(lmax, _ceil(a, CHUNK) * CHUNK)
    longs = a > cap
    words = _ceil(a, CHUNK)
    if longs and (n + 1 > MAX_ENTRIES or words > MAX_WORDS):
        raise MXNetError(f"nms: {n} images of {a} anchors exceed the long "
                         "segments' tables")
    scratch = (n * a * 24 + n * words * a * 8 + n * segments * 16
               if longs else 0)
    launches = (3 if longs else 1) if n and a else 0
    return Plan(segments, lmax, cap, THREADS, seg_bytes(cap),
                MASK_BLOCKS if longs else 0, scratch, launches)


_caps = {}


def device_limits(index):
    """The dynamic shared memory (bytes) a segment block may take on CUDA
    device ``index``, as the C side finds it (once per device)."""
    got = _caps.get(index)
    if got is None:
        out = (ctypes.c_int * 1)()
        with torch.cuda.device(index):
            err = _lib.library().mxt_nms_caps(out, None)
        _lib.check(err, "nms (device limits)")
        got = _caps[index] = out[0]
    return got


def plan_for(score, classes=None, force=False):
    """The :class:`Plan` of a call on CUDA ``score`` (n, A)."""
    n, a = score.shape
    return plan(n, a, classes, bool(force),
                device_limits(score.get_device()))


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


def nms_plain(boxes, score, cls_id, order, threshold, nms_threshold, force,
              classes=None):
    """The plain PyTorch version: the (n, A, 6) rows ``(keep ? cls : -1,
    score, box)`` in anchor order, image by image. ``classes`` is accepted
    and ignored: the result does not depend on it."""
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


def nms(boxes, score, cls_id, order, threshold, nms_threshold, force,
        classes=None):
    """Greedy NMS over every image's anchors: ``(n, A, 6)`` rows
    ``(keep ? cls : -1, score, box)`` in anchor order.

    ``boxes`` (n, A, 4) corner format, ``score`` (n, A), ``cls_id`` (n, A)
    int32, ``order`` (n, A) int64 — each image's anchors by descending
    score, stable (``torch.argsort(-score, dim=1, stable=True)``). A box is
    valid when ``score > threshold``; a kept box suppresses a later one of
    its class (any class with ``force``) when their IoU exceeds
    ``nms_threshold``. ``classes``, the class count (ids in
    ``[0, classes)``), lets the kernel split each image by class; without
    it each image is one segment. It never changes the result.

    A CPU tensor takes the plain version and a ``meta`` tensor gives the
    output's shape. A CUDA tensor launches the kernels of :func:`plan`,
    which take contiguous tensors of these dtypes on one device, ``boxes``
    16-byte aligned; anything else raises :class:`MXNetError`.
    """
    if not boxes.is_cuda:
        if boxes.device.type == "meta":
            return torch.empty((*score.shape, 6), dtype=boxes.dtype,
                               device="meta")
        if boxes.device.type == "cpu":
            return nms_plain(boxes, score, cls_id, order, threshold,
                             nms_threshold, force)
        raise MXNetError(f"nms: no kernel for device {boxes.device}")
    if classes is not None and not (isinstance(classes, int)
                                    and classes > 0):
        raise MXNetError(f"nms: classes must be a positive int, got "
                         f"{classes!r}")
    dev = boxes.get_device()
    shape = score.shape
    f32 = torch.float32
    ok = (score.dim() == 2 and boxes.dtype is f32 and score.dtype is f32
          and cls_id.dtype is torch.int32 and order.dtype is torch.int64
          and boxes.is_contiguous() and score.is_contiguous()
          and cls_id.is_contiguous() and order.is_contiguous()
          and score.get_device() == dev and cls_id.get_device() == dev
          and order.get_device() == dev and boxes.shape == (*shape, 4)
          and cls_id.shape == shape and order.shape == shape
          and boxes.data_ptr() % 16 == 0)
    if not ok:
        raise MXNetError(
            f"nms: the kernel takes a 16-byte aligned float32 (n, A, 4) "
            f"boxes, float32 (n, A) score, int32 (n, A) cls_id and int64 "
            f"(n, A) order, contiguous, on one device; got boxes "
            f"{boxes.dtype} {tuple(boxes.shape)} on {boxes.device}, score "
            f"{score.dtype} {tuple(shape)} on {score.device}, cls_id "
            f"{cls_id.dtype} {tuple(cls_id.shape)} on {cls_id.device}, "
            f"order {order.dtype} {tuple(order.shape)} on {order.device}")
    n, a = shape
    if n > 65535 or a >= 2 ** 31:
        raise MXNetError(f"nms: {n} images of {a} anchors exceed the "
                         "kernels' grid")
    return run_plan(plan(n, a, classes, bool(force), device_limits(dev)),
                    boxes, score, cls_id, order, threshold, nms_threshold,
                    force, classes)


def run_plan(p, boxes, score, cls_id, order, threshold, nms_threshold, force,
             classes):
    """Launch the kernels of :class:`Plan` ``p`` on checked CUDA inputs;
    returns the (n, A, 6) rows."""
    n, a = score.shape
    out = boxes.new_empty((n, a, 6))
    if not p.launches:
        return out
    # the long segments' members, words and descriptors (stream-ordered:
    # freed after the launch, reused only by later work on this stream)
    scratch = boxes.new_empty(p.scratch, dtype=torch.uint8)
    err = _lib.launch_packed(
        boxes, _lib.library().mxt_nms_f32, _PACK, boxes.data_ptr(),
        score.data_ptr(), cls_id.data_ptr(), order.data_ptr(),
        out.data_ptr(), scratch.data_ptr() if p.scratch else 0, n, a,
        classes or 0, int(bool(force)), float(threshold),
        float(nms_threshold), p.segments, p.cap, p.threads, p.smem,
        p.mask_blocks, p.scratch, p.launches)
    _lib.check(err, "nms")
    LAUNCHES.inc(p.launches)
    return out
