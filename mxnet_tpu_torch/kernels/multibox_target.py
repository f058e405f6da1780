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
``csrc/multibox_target.cu`` runs one 1024-thread block per image: the
objects in shared memory, each object's best anchor by a block reduction,
each anchor matched and encoded by its own thread, and the mining rank
found without a sort (a radix select of the ``max_neg``-th key and a
block scan for the ties), so the outputs equal :func:`multibox_target_plain`
bit for bit on the same inputs.

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

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from . import _lib
from .nms import iou_matrix

# counts kernel launches only (never the plain version)
LAUNCHES = _tm.counter("kernel.multibox_target.launches")
_ENC_EPS = 1e-8  # _encode_boxes' eps
_THREADS_WARPS = 32  # warps of the kernel's block (its shared partials)


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
    # dynamic shared memory, beside ~1.4 KB of static (227 KB a block)
    smem = g * (8 + 2 * _THREADS_WARPS) * 4 + a * 5
    if g < 1 or smem > 232448 - 2048 or n > 2 ** 31 - 1:
        raise MXNetError(f"multibox_target: {a} anchors and {g} objects "
                         "exceed the kernel's shared memory")
    loc_t = torch.empty((n, a * 4), dtype=torch.float32, device=dev)
    loc_mask = torch.empty_like(loc_t)
    cls_t = torch.empty((n, a), dtype=torch.float32, device=dev)
    var = [float(v) for v in variances]
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.mxt_multibox_target_f32(
            anchors.data_ptr(), label.data_ptr(), cls_pred.data_ptr(),
            loc_t.data_ptr(), loc_mask.data_ptr(), cls_t.data_ptr(), n, a, g,
            w, cls_pred.stride(0), cls_pred.stride(2),
            float(overlap_threshold), float(ignore_label),
            float(negative_mining_ratio), float(negative_mining_thresh),
            *var, int(minimum_negative_samples),
            int(negative_mining_ratio > 0), _lib.stream_of(anchors))
    _lib.check(err, "multibox_target")
    LAUNCHES.inc()
    return loc_t, loc_mask, cls_t
