"""``multibox_target``: SSD's training targets (matching, encoding, mining).

Replaces ``mxnet_tpu/ops/defs_contrib.py`` ``_multibox_target``
(:150-213, with ``_iou_matrix`` :103 and ``_encode_boxes`` :116): per image
an (A, G) IoU matrix, each anchor's best object and each object's forced
best anchor, the encoded offsets, and hard-negative mining by a stable sort
of the background logits, which XLA fuses into a few passes and eager
PyTorch would run as dozens of launches and a sort per step.

Bound on the H100: device-memory bytes. At SSD-300 training, batch 32,
A = 8096 anchors, G = 16 objects, the function reads ~8 MB of background
logits through the class-major view's stride and writes 9.3 MB of targets.
``csrc/multibox_target.cu`` gives each image a thread-block cluster of
``CLUSTER`` blocks (planned by :func:`plan`), each a contiguous span of the
anchors: every (anchor, valid object) IoU is computed once and folded into
its anchor's row maximum and its object's column maximum; each anchor's
mining key is set before the forced matches are known and counted by top
byte; after one cluster barrier every block reads the others' partials
through distributed shared memory (each object's best anchor, the first
on ties), finds the forced anchors and corrects the counts for them; the
mining rank is found without a sort (a radix select over the cluster's
summed histograms, each bin chosen by a warp-parallel prefix, a scan for
the ties); and the targets are written last, in 16-byte rows. The outputs
equal :func:`multibox_target_plain` bit for bit on the same inputs. The
wrapper takes the light launch path (:func:`_lib.launch_packed`).

Semantics the reference's code has, which both versions keep:

* a padded object row (class < 0) has IoU -1 everywhere, so its best
  anchor is anchor 0, and the forced matches are written row by row with
  the last write winning (``zeros(A).at[best_anchor].set(valid)`` on
  XLA:CPU): a padded row after a valid object whose best anchor is 0
  clears that object's forced match;
* the mining key is ``cls_pred[:, 0, :]`` as given (the training symbol
  feeds logits), candidates in ascending order, ties by anchor index,
  -0.0 equal to 0.0, every other anchor after them at +inf.
"""

from __future__ import annotations

import struct
from collections import namedtuple

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib
from .nms import iou_matrix

# counts kernel launches only (never the plain version)
LAUNCHES = _tm.counter("kernel.multibox_target.launches")
_ENC_EPS = 1e-8  # _encode_boxes' eps
# the C entry's packed arguments (csrc/multibox_target.cu Packed): anchors,
# label, the background logits, the three outputs, n, A, G, the label's row
# width, the logits' image and anchor strides, the overlap threshold,
# ignore_label, the mining ratio and threshold, the four variances,
# min_neg, mining, the plan's three fields, the stream
_PACK = struct.Struct("=6Q6q8d5qQ").pack
# blocks an image takes and threads a block takes (csrc kCluster,
# kThreads), chosen from a sweep of k in {2, 4, 8} x {256, 512, 1024}
# threads at SSD's call on the H100 (PERF.md)
CLUSTER, THREADS = 2, 1024
# the block's dynamic shared memory: 52 bytes an object, 16 an anchor of
# its span; the static rest (warp partials, four 256-bin histograms) below
# 9 KB of the H100's 227 KB
OBJECT_BYTES, ANCHOR_BYTES = 52, 16
SMEM_LIMIT = 232448 - 9216

Plan = namedtuple("Plan", "span apt smem")


def plan(a, g):
    """The launch for ``a`` anchors and ``g`` objects an image: each of the
    ``CLUSTER`` blocks a span of ``ceil(a / CLUSTER)`` anchors in
    ``THREADS`` threads, ``apt`` contiguous anchors a thread, and the
    block's dynamic shared memory in bytes."""
    span = -(-a // CLUSTER)
    return Plan(span, -(-span // THREADS),
                OBJECT_BYTES * g + ANCHOR_BYTES * span)


_plans = {}


def encode_boxes(matched, anchors, variances):
    """``_encode_boxes``: corner boxes ``matched`` (..., 4) against
    ``anchors`` (..., 4) -> center offsets (..., 4), in the reference's
    order of operations; every divisor is a tensor (no reciprocal
    shortcut)."""
    var = torch.tensor(variances, dtype=anchors.dtype, device=anchors.device)
    eps = torch.tensor(_ENC_EPS, dtype=anchors.dtype, device=anchors.device)
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = (anchors[..., 0] + anchors[..., 2]) * 0.5
    acy = (anchors[..., 1] + anchors[..., 3]) * 0.5
    gw = matched[..., 2] - matched[..., 0]
    gh = matched[..., 3] - matched[..., 1]
    gcx = (matched[..., 0] + matched[..., 2]) * 0.5
    gcy = (matched[..., 1] + matched[..., 3]) * 0.5
    awe, ahe = torch.maximum(aw, eps), torch.maximum(ah, eps)
    tx = torch.div(torch.div(gcx - acx, awe), var[0])
    ty = torch.div(torch.div(gcy - acy, ahe), var[1])
    tw = torch.div(torch.log(torch.maximum(torch.div(gw, awe), eps)), var[2])
    th = torch.div(torch.log(torch.maximum(torch.div(gh, ahe), eps)), var[3])
    return torch.stack([tx, ty, tw, th], dim=-1)


def multibox_target_plain(anchors, label, cls_pred, overlap_threshold,
                          ignore_label, negative_mining_ratio,
                          negative_mining_thresh, minimum_negative_samples,
                          variances):
    """The plain PyTorch version, batched over images: ``(loc_target
    (n, A*4), loc_mask (n, A*4), cls_target (n, A))``."""
    anc = anchors.reshape(-1, 4)
    a = anc.shape[0]
    n, g = label.shape[0], label.shape[1]
    dev, f32 = anc.device, anc.dtype
    valid = label[:, :, 0] >= 0  # (n, G)
    gt = label[:, :, 1:5]
    iou = torch.stack([iou_matrix(anc, gt[b]) for b in range(n)])  # (n,A,G)
    iou = torch.where(valid[:, None, :], iou,
                      torch.tensor(-1.0, dtype=f32, device=dev))
    best_gt = torch.argmax(iou, dim=2)  # (n, A), first maximum
    best_iou = torch.gather(iou, 2, best_gt[..., None])[..., 0]
    best_anchor = torch.argmax(iou, dim=1)  # (n, G), first maximum
    # the forced matches, object row by object row: the last write wins
    forced = torch.zeros((n, a), dtype=torch.bool, device=dev)
    for j in range(g):
        forced.scatter_(1, best_anchor[:, j:j + 1], valid[:, j:j + 1])
    matched = forced | (best_iou >= overlap_threshold)
    hit = (torch.arange(a, device=dev)[None, :, None]
           == best_anchor[:, None, :]) & valid[:, None, :]
    forced_gt = torch.argmax(torch.where(hit, iou + 2.0, iou), dim=2)
    idx = torch.where(forced, forced_gt, best_gt)
    boxes = torch.gather(gt, 1, idx[..., None].expand(n, a, 4))
    cls = torch.gather(label[:, :, 0], 1, idx)
    zero = torch.zeros((), dtype=f32, device=dev)
    loc_t = torch.where(matched[..., None],
                        encode_boxes(boxes, anc[None], variances), zero)
    loc_mask = matched[..., None].to(f32).expand(n, a, 4).reshape(n, a * 4)
    cls_t = torch.where(matched, cls + 1.0, zero)
    if negative_mining_ratio > 0:
        num_pos = matched.sum(1).to(f32)
        ratio = torch.tensor(negative_mining_ratio, dtype=f32, device=dev)
        max_neg = torch.clamp_min((ratio * num_pos).to(torch.int32),
                                  minimum_negative_samples)
        cand = ~matched & (best_iou < negative_mining_thresh)
        inf = torch.tensor(float("inf"), dtype=f32, device=dev)
        # + 0.0 turns -0.0 into 0.0: the two tie in the reference's sort
        key = torch.where(cand, cls_pred[:, 0, :], inf) + 0.0
        order = torch.argsort(key, dim=1, stable=True)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(a, device=dev).expand(n, a))
        keep = cand & (rank < max_neg[:, None])
        cls_t = torch.where(
            matched, cls_t,
            torch.where(keep, zero,
                        torch.tensor(ignore_label, dtype=f32, device=dev)))
    return loc_t.reshape(n, a * 4), loc_mask, cls_t


def multibox_target(anchors, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD's training targets: ``(loc_target (n, A*4), loc_mask (n, A*4),
    cls_target (n, A))`` from ``anchors`` (1, A, 4), ``label`` (n, G, 5+)
    rows ``[cls, x1, y1, x2, y2]`` (class < 0 pads) and ``cls_pred``
    (n, classes + 1, A), whose channel 0 is the mining key.

    A CPU tensor takes the plain version and a ``meta`` tensor gives the
    outputs' shapes. A CUDA tensor launches the kernel, which takes
    contiguous float32 ``anchors`` and ``label`` and a float32 ``cls_pred``
    of any strides, on one device; anything else raises
    :class:`MXNetError`.
    """
    args = (overlap_threshold, ignore_label, negative_mining_ratio,
            negative_mining_thresh, minimum_negative_samples, variances)
    if anchors.device.type == "meta":
        n, a = label.shape[0], anchors.numel() // 4
        return (torch.empty((n, a * 4), device="meta"),
                torch.empty((n, a * 4), device="meta"),
                torch.empty((n, a), device="meta"))
    if anchors.device.type == "cpu":
        return multibox_target_plain(anchors, label, cls_pred, *args)
    if anchors.device.type != "cuda":
        raise MXNetError(f"multibox_target: no kernel for device "
                         f"{anchors.device}")
    dev = anchors.device
    if label.dim() != 3 or label.shape[2] < 5 or cls_pred.dim() != 3:
        raise MXNetError(
            f"multibox_target: label must be (n, G, 5+) and cls_pred "
            f"(n, classes + 1, A), got {tuple(label.shape)} and "
            f"{tuple(cls_pred.shape)}")
    n, g, w = label.shape
    a = anchors.numel() // 4
    _lib.check_f32("multibox_target: anchors", anchors, dev,
                   (1, a, 4) if anchors.dim() == 3 else (a, 4))
    _lib.check_f32("multibox_target: label", label, dev)
    if (cls_pred.dtype != torch.float32 or cls_pred.device != dev
            or cls_pred.shape[0] != n or cls_pred.shape[2] != a):
        raise MXNetError(
            f"multibox_target: cls_pred must be float32 ({n}, classes + 1, "
            f"{a}) on {dev}, got {cls_pred.dtype} {tuple(cls_pred.shape)} "
            f"on {cls_pred.device}")
    key = (a, g)
    p = _plans.get(key)
    if p is None:
        p = plan(a, g)
        if g < 1 or p.smem > SMEM_LIMIT:
            raise MXNetError(f"multibox_target: {a} anchors and {g} objects "
                             "exceed the kernel's shared memory")
        _plans[key] = p
    return run_plan(p, anchors, label, cls_pred, *args)


def run_plan(p, anchors, label, cls_pred, overlap_threshold, ignore_label,
             negative_mining_ratio, negative_mining_thresh,
             minimum_negative_samples, variances):
    """Launch plan ``p`` on checked CUDA inputs."""
    n, g, w = label.shape
    a = anchors.numel() // 4
    if anchors.data_ptr() % 16:  # a view off the 16-byte rows
        anchors = anchors.clone()
    if n * CLUSTER > 2 ** 31 - 1:
        raise MXNetError(f"multibox_target: {n} images exceed the grid")
    loc_t = torch.empty((n, a * 4), dtype=torch.float32, device=label.device)
    loc_mask = torch.empty_like(loc_t)
    cls_t = torch.empty((n, a), dtype=torch.float32, device=label.device)
    if (loc_t.data_ptr() | loc_mask.data_ptr()) % 16:
        raise MXNetError("multibox_target: outputs off the 16-byte alignment")
    err = _lib.launch_packed(
        anchors, _lib.library().mxt_multibox_target_f32, _PACK,
        anchors.data_ptr(), label.data_ptr(), cls_pred.data_ptr(),
        loc_t.data_ptr(), loc_mask.data_ptr(), cls_t.data_ptr(), n, a, g, w,
        cls_pred.stride(0), cls_pred.stride(2), float(overlap_threshold),
        float(ignore_label), float(negative_mining_ratio),
        float(negative_mining_thresh), *(float(v) for v in variances),
        int(minimum_negative_samples), int(negative_mining_ratio > 0),
        p.span, p.apt, p.smem)
    _lib.check(err, "multibox_target")
    LAUNCHES.inc()
    return loc_t, loc_mask, cls_t
