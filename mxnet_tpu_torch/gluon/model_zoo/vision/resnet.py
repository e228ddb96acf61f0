"""ResNet v1 and v2, 18 to 152 layers.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``
(``BasicBlockV1/V2``, ``BottleneckV1/V2``, ``ResNetV1/V2``, ``get_resnet``
and ``resnet{18,34,50,101,152}_v{1,2}``), with the same children and
parameter names.  As there, ``BottleneckV1`` strides its first 1x1 conv
(ResNet v1, not v1.5) and its body's 1x1 convs keep their bias, and most
convs defer their input channels to the first call.  ``pretrained=True``
raises: no weights are downloaded.
"""
from __future__ import annotations

import torch

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock
from ._pretrained import check_pretrained

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2"]


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


def _downsample_v1(channels, stride, in_channels):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel_size=1, strides=stride,
                      use_bias=False, in_channels=in_channels),
            nn.BatchNorm())
    return out


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels),
                      nn.BatchNorm(), nn.Activation("relu"),
                      _conv3x3(channels, 1, channels), nn.BatchNorm())
        self.downsample = (_downsample_v1(channels, stride, in_channels)
                           if downsample else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride),
                      nn.BatchNorm(), nn.Activation("relu"),
                      _conv3x3(channels // 4, 1, channels // 4),
                      nn.BatchNorm(), nn.Activation("relu"),
                      nn.Conv2D(channels, kernel_size=1, strides=1),
                      nn.BatchNorm())
        self.downsample = (_downsample_v1(channels, stride, in_channels)
                           if downsample else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__()
        self.bn1 = nn.BatchNorm()
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels, 1, channels)
        self.downsample = (nn.Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels)
                           if downsample else None)

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__()
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False)
        self.downsample = (nn.Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels)
                           if downsample else None)

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        x = self.conv2(x)
        x = torch.relu(self.bn3(x))
        return self.conv3(x) + residual


def _make_layer(block, layers, channels, stride, in_channels):
    layer = nn.HybridSequential()
    layer.add(block(channels, stride, channels != in_channels,
                    in_channels=in_channels))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels))
    return layer


def _stem(features, channels, thumbnail):
    if thumbnail:
        features.add(_conv3x3(channels, 1, 0))
    else:
        features.add(nn.Conv2D(channels, 7, 2, 3, use_bias=False),
                     nn.BatchNorm(), nn.Activation("relu"),
                     nn.MaxPool2D(3, 2, 1))


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV1: %d layers for %d channels"
                             % (len(layers), len(channels)))
        self.features = nn.HybridSequential()
        _stem(self.features, channels[0], thumbnail)
        for i, num_layer in enumerate(layers):
            self.features.add(_make_layer(
                block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                channels[i]))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=channels[-1])

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV2: %d layers for %d channels"
                             % (len(layers), len(channels)))
        self.features = nn.HybridSequential()
        self.features.add(nn.BatchNorm(scale=False, center=False))
        _stem(self.features, channels[0], thumbnail)
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            self.features.add(_make_layer(
                block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                in_channels))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm(), nn.Activation("relu"),
                          nn.GlobalAvgPool2D(), nn.Flatten())
        self.output = nn.Dense(classes, in_units=in_channels)

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers`` (18, 34, 50, 101 or
    152) layers, parameters not yet initialized."""
    if num_layers not in resnet_spec:
        raise MXNetError("invalid resnet depth %d" % num_layers)
    if version not in (1, 2):
        raise MXNetError("resnet version must be 1 or 2")
    check_pretrained(pretrained, "resnet%d_v%d" % (num_layers, version))
    block_type, layers, channels = resnet_spec[num_layers]
    block_class = resnet_block_versions[version - 1][block_type]
    return resnet_net_versions[version - 1](block_class, layers, channels,
                                            **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
