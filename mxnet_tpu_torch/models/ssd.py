"""SSD-VGG16 single-shot detector, inference and training symbols (a copy
of ``mxnet_tpu/models/ssd.py``).

Reference: ``example/ssd/symbol/symbol_builder.py`` + ``legacy_vgg16_ssd_300``
— VGG-16-reduced backbone, multi-scale feature layers, per-scale loc/cls
convolution heads, MultiBoxPrior anchors, and MultiBoxDetection
(inference) or MultiBoxTarget with the SoftmaxOutput and smooth-L1 losses
(training).
"""

from __future__ import annotations

from .. import symbol as sym
from .recipe import low_precision_io


def _conv_act(data, name, num_filter, kernel=(3, 3), pad=(1, 1), stride=(1, 1)):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel, pad=pad,
                        stride=stride, name=name)
    return sym.Activation(c, act_type="relu", name=name + "_relu")


def _vgg16_reduced(data):
    """VGG16 through conv5 + fc6/fc7 as dilated convs (SSD backbone)."""
    layers = []
    body = data
    cfg = [(2, 64), (2, 128), (3, 256), (3, 512)]
    for i, (num, filters) in enumerate(cfg):
        for j in range(num):
            body = _conv_act(body, f"conv{i + 1}_{j + 1}", filters)
        if i == 3:
            layers.append(body)  # conv4_3
        body = sym.Pooling(body, pool_type="max", kernel=(2, 2), stride=(2, 2),
                           name=f"pool{i + 1}")
    for j in range(3):
        body = _conv_act(body, f"conv5_{j + 1}", 512)
    body = sym.Pooling(body, pool_type="max", kernel=(3, 3), stride=(1, 1),
                       pad=(1, 1), name="pool5")
    body = sym.Convolution(body, num_filter=1024, kernel=(3, 3), pad=(6, 6),
                           dilate=(6, 6), name="fc6")
    body = sym.Activation(body, act_type="relu", name="relu6")
    body = sym.Convolution(body, num_filter=1024, kernel=(1, 1), name="fc7")
    body = sym.Activation(body, act_type="relu", name="relu7")
    layers.append(body)  # fc7
    return layers


def _extra_layers(body, fsize):
    """Extra feature scales; only the stages the input size supports are
    built (SSD-300's full spec needs ~300px — smaller inputs drop tail
    scales instead of inferring 0-sized feature maps; the reference ships
    per-size symbol variants, ssd_300/ssd_512, for the same reason)."""
    layers = []
    specs = [(256, 512, 2), (128, 256, 2), (128, 256, 1), (128, 256, 1)]
    for i, (f1, f2, stride) in enumerate(specs):
        nxt = (fsize - 1) // 2 + 1 if stride == 2 else fsize - 2
        if nxt < 1:
            break
        body = _conv_act(body, f"multi_feat_{i}_conv_1x1", f1, kernel=(1, 1),
                         pad=(0, 0))
        body = _conv_act(
            body, f"multi_feat_{i}_conv_3x3", f2, kernel=(3, 3),
            pad=(1, 1) if stride == 2 else (0, 0), stride=(stride, stride),
        )
        layers.append(body)
        fsize = nxt
    return layers


# per-scale anchor configs (reference vgg16_ssd_300)
_SIZES = [(0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
          (0.71, 0.79), (0.88, 0.961)]
_RATIOS = [(1, 2, 0.5), (1, 2, 0.5, 3, 1.0 / 3), (1, 2, 0.5, 3, 1.0 / 3),
           (1, 2, 0.5, 3, 1.0 / 3), (1, 2, 0.5), (1, 2, 0.5)]


def multibox_layer(from_layers, num_classes, sizes=_SIZES, ratios=_RATIOS,
                   clip=False):
    """Per-scale heads → (loc_preds, cls_preds, anchors)
    (reference common.multibox_layer)."""
    loc_layers, cls_layers, anchor_layers = [], [], []
    num_classes += 1  # background
    for k, from_layer in enumerate(from_layers):
        num_anchors = len(sizes[k]) + len(ratios[k]) - 1
        loc = sym.Convolution(
            from_layer, num_filter=num_anchors * 4, kernel=(3, 3), pad=(1, 1),
            name=f"loc_pred_conv_{k}",
        )
        # (n, A*4, h, w) → (n, h, w, A*4) → flat
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_layers.append(sym.Flatten(loc))

        cls = sym.Convolution(
            from_layer, num_filter=num_anchors * num_classes, kernel=(3, 3),
            pad=(1, 1), name=f"cls_pred_conv_{k}",
        )
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls_layers.append(sym.Flatten(cls))

        anchors = sym.MultiBoxPrior(
            from_layer, sizes=sizes[k], ratios=ratios[k], clip=clip,
            name=f"anchors_{k}",
        )
        anchor_layers.append(sym.Reshape(anchors, shape=(0, -1)))

    loc_preds = sym.Concat(*loc_layers, dim=1, name="multibox_loc_pred")
    cls_concat = sym.Concat(*cls_layers, dim=1)
    cls_preds = sym.Reshape(
        cls_concat, shape=(0, -1, num_classes), name="multibox_cls_reshape"
    )
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1))
    anchors_all = sym.Concat(*anchor_layers, dim=1)
    anchor_boxes = sym.Reshape(
        anchors_all, shape=(1, -1, 4), name="multibox_anchors"
    )
    return loc_preds, cls_preds, anchor_boxes


def _heads(num_classes, data_shape=300, dtype="float32"):
    """bf16 recipe: the VGG trunk + extra scales run low-precision; each
    feature map is cast back to f32 before L2Norm/multibox heads so the
    anchor/target math stays full precision (same shape as the resnet
    recipe — trunk on the MXU, head in f32)."""
    data = sym.Variable("data")
    data = low_precision_io(data, dtype)
    backbone = _vgg16_reduced(data)
    conv4_3, fc7 = backbone
    extras = _extra_layers(fc7, data_shape // 16)
    conv4_3 = low_precision_io(conv4_3, dtype, out=True)
    fc7 = low_precision_io(fc7, dtype, out=True)
    extras = [low_precision_io(x, dtype, out=True) for x in extras]
    conv4_3_norm = sym.L2Normalization(conv4_3, mode="channel",
                                       name="conv4_3_norm") * 20.0
    from_layers = [conv4_3_norm, fc7] + extras
    n = len(from_layers)
    return multibox_layer(from_layers, num_classes,
                          sizes=_SIZES[:n], ratios=_RATIOS[:n])


def get_symbol_train(num_classes=20, data_shape=300, dtype="float32",
                     **kwargs):
    """Training symbol (reference symbol_builder.get_symbol_train)."""
    label = sym.Variable("label")
    loc_preds, cls_preds, anchor_boxes = _heads(num_classes, data_shape,
                                                dtype)

    tmp = sym.MultiBoxTarget(
        anchor_boxes, label, cls_preds, overlap_threshold=0.5,
        ignore_label=-1, negative_mining_ratio=3, minimum_negative_samples=0,
        negative_mining_thresh=0.5, variances=(0.1, 0.1, 0.2, 0.2),
        name="multibox_target",
    )
    loc_target = tmp[0]
    loc_target_mask = tmp[1]
    cls_target = tmp[2]

    cls_prob = sym.SoftmaxOutput(
        cls_preds, cls_target, ignore_label=-1, use_ignore=True,
        multi_output=True, normalization="valid",
        name="cls_prob",
    )
    loc_loss_ = sym.smooth_l1(
        loc_target_mask * (loc_preds - loc_target), scalar=1.0,
        name="loc_loss_",
    )
    loc_loss = sym.MakeLoss(loc_loss_, grad_scale=1.0,
                            normalization="valid", name="loc_loss")
    cls_label = sym.MakeLoss(cls_target, grad_scale=0.0, name="cls_label")
    det = sym.MultiBoxDetection(
        cls_prob, loc_preds, anchor_boxes, name="detection",
        nms_threshold=0.45, force_suppress=False,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=400,
    )
    det = sym.MakeLoss(det, grad_scale=0.0, name="det_out")
    return sym.Group([cls_prob, loc_loss, cls_label, det])


def get_symbol(num_classes=20, nms_thresh=0.5, force_suppress=False,
               nms_topk=400, data_shape=300, dtype="float32", **kwargs):
    """Inference symbol (reference symbol_builder.get_symbol)."""
    loc_preds, cls_preds, anchor_boxes = _heads(num_classes, data_shape,
                                                dtype)
    cls_prob = sym.SoftmaxActivation(cls_preds, mode="channel",
                                     name="cls_prob")
    return sym.MultiBoxDetection(
        cls_prob, loc_preds, anchor_boxes, name="detection",
        nms_threshold=nms_thresh, force_suppress=force_suppress,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=nms_topk,
    )
