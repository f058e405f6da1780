"""ResNet (v2 pre-activation) — the headline benchmark model.

Reference: ``example/image-classification/symbols/resnet.py`` ("Identity
Mappings in Deep Residual Networks"). Same unit structure: BN→ReLU→Conv
pre-activation residual units, bottleneck for depth≥50, stem conv 7x7/2 +
maxpool for ImageNet or 3x3 for CIFAR, global average pool + FC + softmax.

A copy of ``mxnet_tpu/models/resnet.py``. Layout is NCHW like the
reference. The port builds the f32 graph only: ``dtype`` other than
float32 needs the ``Cast`` op, which is not yet ported.
"""

from .. import symbol as sym
from .recipe import low_precision_io


def residual_unit(data, num_filter, stride, dim_match, name, bottle_neck=True,
                  bn_mom=0.9, memonger=False):
    if bottle_neck:
        bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(act1, num_filter=int(num_filter * 0.25),
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=int(num_filter * 0.25),
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                name=name + "_conv3")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + "_sc")
        return conv3 + shortcut
    else:
        bn1 = sym.BatchNorm(data, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                            name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                                stride=stride, pad=(1, 1), no_bias=True,
                                name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                            name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                                stride=(1, 1), pad=(1, 1), no_bias=True,
                                name=name + "_conv2")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + "_sc")
        return conv2 + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9, memonger=False, dtype="float32"):
    num_unit = len(units)
    assert num_unit == num_stages
    data = sym.Variable(name="data")
    data = sym.identity(data, name="id")
    data = low_precision_io(data, dtype)
    (nchannel, height, width) = image_shape
    if height <= 32:  # cifar-style stem
        body = sym.Convolution(data, num_filter=filter_list[0], kernel=(3, 3),
                               stride=(1, 1), pad=(1, 1), no_bias=True,
                               name="conv0")
    else:  # imagenet stem
        body = sym.Convolution(data, num_filter=filter_list[0], kernel=(7, 7),
                               stride=(2, 2), pad=(3, 3), no_bias=True,
                               name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                             name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max")

    for i in range(num_stages):
        body = residual_unit(
            body, filter_list[i + 1],
            (1 if i == 0 else 2, 1 if i == 0 else 2), False,
            name=f"stage{i + 1}_unit1", bottle_neck=bottle_neck,
            bn_mom=bn_mom, memonger=memonger,
        )
        for j in range(units[i] - 1):
            body = residual_unit(
                body, filter_list[i + 1], (1, 1), True,
                name=f"stage{i + 1}_unit{j + 2}", bottle_neck=bottle_neck,
                bn_mom=bn_mom, memonger=memonger,
            )
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    flat = sym.Flatten(pool1)
    flat = low_precision_io(flat, dtype, out=True)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")


def get_symbol(num_classes=1000, num_layers=50, image_shape="3,224,224",
               **kwargs):
    """Build ResNet-<num_layers> (reference resnet.py get_symbol)."""
    if isinstance(image_shape, str):
        image_shape = tuple(int(x) for x in image_shape.split(","))
    (nchannel, height, width) = image_shape
    if height <= 28:
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError(f"no experiments done on num_layers {num_layers}")
        units = per_unit * num_stages
    else:
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        num_stages = 4
        units_map = {
            18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
            101: [3, 4, 23, 3], 152: [3, 8, 36, 3], 200: [3, 24, 36, 3],
            269: [3, 30, 48, 8],
        }
        if num_layers not in units_map:
            raise ValueError(f"no experiments done on num_layers {num_layers}")
        units = units_map[num_layers]

    return resnet(
        units=units, num_stages=num_stages, filter_list=filter_list,
        num_classes=num_classes, image_shape=image_shape,
        bottle_neck=bottle_neck, **kwargs,
    )
