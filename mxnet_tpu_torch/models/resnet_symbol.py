"""Symbolic ResNet over ``mxnet_tpu_torch.sym``.

The port's copy of ``example/image-classification/symbols/resnet.py``
(reference: the same file of MXNet's examples): CIFAR depths 6n+2 for
images of 32 pixels or fewer, ImageNet depths 18-152 above that.  For the
same arguments it composes the same graph, node names included, as the
example does over ``mxnet_tpu.sym``.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol", "residual_unit"]


def residual_unit(data, num_filter, stride, dim_match, name,
                  bottle_neck=True):
    bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=0.9,
                        name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    if bottle_neck:
        conv1 = sym.Convolution(act1, num_filter=num_filter // 4,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=0.9,
                            name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=num_filter // 4,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5, momentum=0.9,
                            name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        body = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                               stride=(1, 1), pad=(0, 0), no_bias=True,
                               name=name + "_conv3")
    else:
        conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                                stride=stride, pad=(1, 1), no_bias=True,
                                name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=0.9,
                            name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        body = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                               stride=(1, 1), pad=(1, 1), no_bias=True,
                               name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(act1, num_filter=num_filter,
                                   kernel=(1, 1), stride=stride,
                                   no_bias=True, name=name + "_sc")
    return body + shortcut


def get_symbol(num_classes=10, num_layers=20, image_shape="3,32,32",
               **kwargs):
    image_shape = [int(x) for x in image_shape.split(",")] \
        if isinstance(image_shape, str) else list(image_shape)
    _, height, _ = image_shape
    if height <= 32:                         # CIFAR
        if (num_layers - 2) % 6:
            raise ValueError("CIFAR ResNet depth must be 6n+2, not %d"
                             % num_layers)
        units = [(num_layers - 2) // 6] * 3
        filter_list = [16, 16, 32, 64]
        bottle_neck = False
    else:                                    # ImageNet
        cfg = {18: ([2, 2, 2, 2], False), 34: ([3, 4, 6, 3], False),
               50: ([3, 4, 6, 3], True), 101: ([3, 4, 23, 3], True),
               152: ([3, 8, 36, 3], True)}
        units, bottle_neck = cfg[num_layers]
        filter_list = [64, 256, 512, 1024, 2048] if bottle_neck \
            else [64, 64, 128, 256, 512]

    data = sym.Variable("data")
    body = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=0.9,
                         name="bn_data")
    if height <= 32:
        body = sym.Convolution(body, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name="conv0")
    else:
        body = sym.Convolution(body, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=0.9,
                             name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max")

    for i, n_units in enumerate(units):
        stride = (1, 1) if i == 0 else (2, 2)
        body = residual_unit(body, filter_list[i + 1], stride, False,
                             "stage%d_unit1" % (i + 1), bottle_neck)
        for j in range(n_units - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 "stage%d_unit%d" % (i + 1, j + 2),
                                 bottle_neck)

    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=0.9,
                        name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")
