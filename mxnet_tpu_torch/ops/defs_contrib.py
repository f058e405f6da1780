"""Contrib / detection operators: the SSD triple.

Counterpart of ``mxnet_tpu/ops/defs_contrib.py`` for ``MultiBoxPrior``,
``MultiBoxDetection`` and ``MultiBoxTarget`` (registered with their
aliases and parameter schemas). ``MultiBoxPrior`` depends only on the
input's shape and its parameters: plain PyTorch, which the executor runs
once per bound shape and holds (the reference's XLA folds it into a
constant).
``MultiBoxDetection`` runs two hand-written kernels around a stable sort:
``multibox_decode`` (best foreground class, score and decoded box of every
anchor) and ``nms`` (the greedy suppression and the output rows); the
executor feeds it the logits of a channel ``SoftmaxActivation`` so the
softmax runs inside ``multibox_decode``. ``MultiBoxTarget``
(SSD training) runs the ``multibox_target`` kernel: matching, encoding and
hard-negative mining in one launch. ``ROIPooling``,
``Proposal`` and the other contrib ops are not yet ported.
"""

from __future__ import annotations

import ast
import math

import torch

from ..base import parse_bool, parse_float, parse_int
from ..kernels import multibox_decode as _decode
from ..kernels import multibox_target as _target
from ..kernels import nms as _nms
from .registry import Param, register


def _parse_floats(v):
    if v is None:
        return ()
    if isinstance(v, (tuple, list)):
        return tuple(float(x) for x in v)
    val = ast.literal_eval(str(v))
    if isinstance(val, (int, float)):
        return (float(val),)
    return tuple(float(x) for x in val)


# --- MultiBoxPrior ---------------------------------------------------------
def multibox_prior(in_h, in_w, sizes, ratios, steps, offsets, clip,
                   device="cpu"):
    """The ``(1, in_h * in_w * num_anchors, 4)`` float32 anchors of one
    feature map, in the reference's order: per position, ``(size_k,
    ratio_0)`` for every k, then ``(size_0, ratio_k)`` for k > 0."""
    steps = steps or (-1.0, -1.0)
    step_y = steps[0] if steps[0] > 0 else 1.0 / in_h
    step_x = steps[1] if steps[1] > 0 else 1.0 / in_w
    f32 = torch.float32
    cy = (torch.arange(in_h, dtype=f32, device=device) + offsets[0]) * step_y
    cx = (torch.arange(in_w, dtype=f32, device=device) + offsets[1]) * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    pairs = [(s, ratios[0]) for s in sizes] + [(sizes[0], r)
                                               for r in ratios[1:]]
    ws = torch.tensor([s * math.sqrt(r) / 2.0 for s, r in pairs], dtype=f32,
                      device=device)
    hs = torch.tensor([s / math.sqrt(r) / 2.0 for s, r in pairs], dtype=f32,
                      device=device)
    cxg, cyg = cxg[:, :, None], cyg[:, :, None]
    boxes = torch.stack([cxg - ws, cyg - hs, cxg + ws, cyg + hs], dim=-1)
    out = boxes.reshape(1, in_h * in_w * len(pairs), 4)
    return torch.clamp(out, 0.0, 1.0) if clip else out


def _multibox_prior(ins, params, mode):
    (data,) = ins
    return multibox_prior(data.shape[2], data.shape[3], params["sizes"],
                          params["ratios"], params["steps"], params["offsets"],
                          params["clip"], device=data.device)


register(
    "MultiBoxPrior",
    _multibox_prior,
    arg_names=["data"],
    param_schema={
        "sizes": Param(_parse_floats, (1.0,)),
        "ratios": Param(_parse_floats, (1.0,)),
        "clip": Param(parse_bool, False),
        "steps": Param(_parse_floats, None),
        "offsets": Param(_parse_floats, (0.5, 0.5)),
    },
    aliases=("_contrib_MultiBoxPrior", "multibox_prior"),
)


# --- MultiBoxTarget --------------------------------------------------------
def _multibox_target(ins, params, mode):
    """The ``multibox_target`` kernel. Every output is a selection (by
    ``where``, ``argmax`` or ``argsort`` in the reference), so none carries
    a gradient, and ``cls_pred`` is read detached."""
    anchors, label, cls_pred = ins
    return list(_target.multibox_target(
        anchors.detach(), label.detach(), cls_pred.detach(),
        params["overlap_threshold"], params["ignore_label"],
        params["negative_mining_ratio"], params["negative_mining_thresh"],
        params["minimum_negative_samples"], params["variances"]))


register(
    "MultiBoxTarget",
    _multibox_target,
    arg_names=["anchor", "label", "cls_pred"],
    param_schema={
        "overlap_threshold": Param(parse_float, 0.5),
        "ignore_label": Param(parse_float, -1.0),
        "negative_mining_ratio": Param(parse_float, -1.0),
        "negative_mining_thresh": Param(parse_float, 0.5),
        "minimum_negative_samples": Param(parse_int, 0),
        "variances": Param(_parse_floats, (0.1, 0.1, 0.2, 0.2)),
    },
    num_outputs=3,
    aliases=("_contrib_MultiBoxTarget", "multibox_target"),
)


# --- MultiBoxDetection -----------------------------------------------------
def detect(cls, loc_pred, anchors, params, softmax):
    """One detection step: ``multibox_decode`` (with the class softmax when
    ``softmax``, on logits), the stable descending sort of the scores, then
    ``nms`` over the ``cls.shape[1] - 1`` foreground classes (the decode's
    argmax gives ids in that range). Returns the (n, A, 6) rows ``(id,
    score, xmin, ymin, xmax, ymax)``, id -1 where the anchor is not kept."""
    boxes, score, cls_id = _decode.multibox_decode(
        cls, loc_pred.contiguous(), anchors.contiguous(),
        params["variances"], params["clip"], softmax)
    order = torch.argsort(-score, dim=1, stable=True)
    return _nms.nms(boxes, score, cls_id, order, params["threshold"],
                    params["nms_threshold"], params["force_suppress"],
                    classes=cls.shape[1] - 1)


def _multibox_detection(ins, params, mode):
    """Read detached: the training symbol's only consumer of the detections
    is ``MakeLoss(grad_scale=0)``, so the reference's gradient through them
    is exactly zero."""
    cls_prob, loc_pred, anchors = ins
    # cls_prob (n, num_cls+1, A); loc_pred (n, A*4); anchors (1, A, 4)
    return detect(cls_prob.detach(), loc_pred.detach(), anchors.detach(),
                  params, softmax=False)


register(
    "MultiBoxDetection",
    _multibox_detection,
    arg_names=["cls_prob", "loc_pred", "anchor"],
    param_schema={
        "clip": Param(parse_bool, True),
        "threshold": Param(parse_float, 0.01),
        "background_id": Param(parse_int, 0),  # parsed, unused (as there)
        "nms_threshold": Param(parse_float, 0.5),
        "force_suppress": Param(parse_bool, False),
        "variances": Param(_parse_floats, (0.1, 0.1, 0.2, 0.2)),
        "nms_topk": Param(parse_int, -1),  # parsed, unused (as there)
    },
    aliases=("_contrib_MultiBoxDetection", "multibox_detection"),
)
