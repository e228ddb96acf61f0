"""SqueezeNet 1.0 and 1.1.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``
(``SqueezeNet``, ``_FireExpand``, ``squeezenet1_0``, ``squeezenet1_1``),
with the same children and parameter names.  Its max pools pass
``ceil_mode=True``, which pooling accepts and does not use here or in the
JAX package, so the feature maps follow the JAX package (floor), not
upstream MXNet.
"""
from __future__ import annotations

import torch

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock
from ._pretrained import check_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(squeeze_channels, kernel_size=1, activation="relu"))
    out.add(_FireExpand(expand1x1_channels, expand3x3_channels))
    return out


class _FireExpand(HybridBlock):
    def __init__(self, e1, e3):
        super().__init__()
        self.conv1 = nn.Conv2D(e1, kernel_size=1, activation="relu")
        self.conv3 = nn.Conv2D(e3, kernel_size=3, padding=1,
                               activation="relu")

    def forward(self, x):
        return torch.cat([self.conv1(x), self.conv3(x)], dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__()
        if version not in ("1.0", "1.1"):
            raise MXNetError("version must be 1.0 or 1.1")
        self.features = nn.HybridSequential()
        if version == "1.0":
            self.features.add(nn.Conv2D(96, kernel_size=7, strides=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(64, 256, 256))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
            self.features.add(_make_fire(64, 256, 256))
        else:
            self.features.add(nn.Conv2D(64, kernel_size=3, strides=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(64, 256, 256))
            self.features.add(_make_fire(64, 256, 256))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, kernel_size=1))
        self.output.add(nn.Activation("relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, ctx=None, root=None, **kwargs):
    check_pretrained(pretrained, "squeezenet1_0")
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, ctx=None, root=None, **kwargs):
    check_pretrained(pretrained, "squeezenet1_1")
    return SqueezeNet("1.1", **kwargs)
