"""Inception-v3.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/inception.py``
(``Inception3``, ``_Concurrent``, ``_BranchSplit``, ``inception_v3``),
with the same children and parameter names: factorized 7x7 convs, the
grid-reduction blocks, branches concatenated on the channel axis; input
3x299x299.
"""
from __future__ import annotations

import torch

from ... import nn
from ...block import HybridBlock
from ._pretrained import check_pretrained

__all__ = ["Inception3", "inception_v3"]


def _conv2d(channels, kernel_size, strides=1, padding=0):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel_size, strides=strides,
                      padding=padding, use_bias=False))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Concurrent(HybridBlock):
    """Parallel branches (children "0", "1", ...) concatenated on the
    channel axis."""

    def add(self, block):
        self.register_child(block)

    def forward(self, x):
        return torch.cat([b(x) for b in self._modules.values()], dim=1)


def _make_A(pool_features):
    out = _Concurrent()
    out.add(_conv2d(64, 1))
    b2 = nn.HybridSequential()
    b2.add(_conv2d(48, 1), _conv2d(64, 5, padding=2))
    out.add(b2)
    b3 = nn.HybridSequential()
    b3.add(_conv2d(64, 1), _conv2d(96, 3, padding=1),
           _conv2d(96, 3, padding=1))
    out.add(b3)
    b4 = nn.HybridSequential()
    b4.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1),
           _conv2d(pool_features, 1))
    out.add(b4)
    return out


def _make_B():
    """35x35 -> 17x17 grid reduction."""
    out = _Concurrent()
    out.add(_conv2d(384, 3, strides=2))
    b2 = nn.HybridSequential()
    b2.add(_conv2d(64, 1), _conv2d(96, 3, padding=1),
           _conv2d(96, 3, strides=2))
    out.add(b2)
    out.add(nn.MaxPool2D(pool_size=3, strides=2))
    return out


def _make_C(channels_7x7):
    out = _Concurrent()
    out.add(_conv2d(192, 1))
    c = channels_7x7
    b2 = nn.HybridSequential()
    b2.add(_conv2d(c, 1), _conv2d(c, (1, 7), padding=(0, 3)),
           _conv2d(192, (7, 1), padding=(3, 0)))
    out.add(b2)
    b3 = nn.HybridSequential()
    b3.add(_conv2d(c, 1), _conv2d(c, (7, 1), padding=(3, 0)),
           _conv2d(c, (1, 7), padding=(0, 3)),
           _conv2d(c, (7, 1), padding=(3, 0)),
           _conv2d(192, (1, 7), padding=(0, 3)))
    out.add(b3)
    b4 = nn.HybridSequential()
    b4.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1),
           _conv2d(192, 1))
    out.add(b4)
    return out


def _make_D():
    """17x17 -> 8x8 grid reduction."""
    out = _Concurrent()
    b1 = nn.HybridSequential()
    b1.add(_conv2d(192, 1), _conv2d(320, 3, strides=2))
    out.add(b1)
    b2 = nn.HybridSequential()
    b2.add(_conv2d(192, 1), _conv2d(192, (1, 7), padding=(0, 3)),
           _conv2d(192, (7, 1), padding=(3, 0)),
           _conv2d(192, 3, strides=2))
    out.add(b2)
    out.add(nn.MaxPool2D(pool_size=3, strides=2))
    return out


class _BranchSplit(HybridBlock):
    """1x3 + 3x1 factorized pair, concatenated."""

    def __init__(self):
        super().__init__()
        self.a = _conv2d(384, (1, 3), padding=(0, 1))
        self.b = _conv2d(384, (3, 1), padding=(1, 0))

    def forward(self, x):
        return torch.cat([self.a(x), self.b(x)], dim=1)


def _make_E():
    out = _Concurrent()
    out.add(_conv2d(320, 1))
    b2 = nn.HybridSequential()
    b2.add(_conv2d(384, 1), _BranchSplit())
    out.add(b2)
    b3 = nn.HybridSequential()
    b3.add(_conv2d(448, 1), _conv2d(384, 3, padding=1), _BranchSplit())
    out.add(b3)
    b4 = nn.HybridSequential()
    b4.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1),
           _conv2d(192, 1))
    out.add(b4)
    return out


class Inception3(HybridBlock):
    """Inception-v3 (input 3x299x299)."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(_conv2d(32, 3, strides=2))
        self.features.add(_conv2d(32, 3))
        self.features.add(_conv2d(64, 3, padding=1))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_conv2d(80, 1))
        self.features.add(_conv2d(192, 3))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_A(32))
        self.features.add(_make_A(64))
        self.features.add(_make_A(64))
        self.features.add(_make_B())
        self.features.add(_make_C(128))
        self.features.add(_make_C(160))
        self.features.add(_make_C(160))
        self.features.add(_make_C(192))
        self.features.add(_make_D())
        self.features.add(_make_E())
        self.features.add(_make_E())
        self.features.add(nn.AvgPool2D(pool_size=8))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, classes=1000, ctx=None, root=None,
                 **kwargs):
    check_pretrained(pretrained, "inception_v3")
    return Inception3(classes=classes, **kwargs)
