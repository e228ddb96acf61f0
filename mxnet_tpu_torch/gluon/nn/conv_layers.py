"""Convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: ``Conv1D/2D/3D`` and
their ``Transpose`` variants, the max, average and global pooling family,
``ReflectionPad2D`` and ``PixelShuffle1D/2D/3D``, with the same parameter
names and layouts (conv weight (channels, in_channels/groups, *kernel);
transposed (in_channels, channels/groups, *kernel)).  ``in_channels=0``
defers the weight's input size to the first call.  As in the JAX package,
pooling accepts ``ceil_mode`` and does not use it, and the transposed
convs accept ``output_padding`` and do not use it (``ops.nn.deconvolution``).
``DeformableConvolution``/``ModulatedDeformableConvolution`` (DCN v1/v2)
run a regular conv for the per-tap offsets (and mask) and then
``ops.contrib_tail.deformable_convolution``.
"""
from __future__ import annotations

import math

import torch.nn.functional as TF

from ...base import MXNetError
from ...ops import nn as F
from ..block import HybridBlock
from .basic_layers import _param, _Resolving

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D",
           "PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D",
           "DeformableConvolution", "ModulatedDeformableConvolution"]


def _tuple(x, n):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,) * n


class _Conv(_Resolving):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", transpose=False,
                 output_padding=0, dtype="float32"):
        super().__init__()
        ndim = len(kernel_size)
        self._channels = channels
        self._kernel = kernel_size
        self._strides = _tuple(strides, ndim)
        self._padding = _tuple(padding, ndim)
        self._dilation = _tuple(dilation, ndim)
        self._groups = groups
        self._layout = layout
        self._activation = activation
        self._transpose = transpose
        self._output_padding = _tuple(output_padding, ndim)
        if transpose:
            wshape = (in_channels, channels // groups) + kernel_size
        else:
            wshape = (channels, in_channels // groups) + kernel_size
        self.weight = _param(wshape, dtype, init=weight_initializer)
        self.bias = (_param((channels,), dtype, init=bias_initializer)
                     if use_bias else None)

    def infer_shape(self, x, *args):
        in_c = x.shape[self._layout.index("C")]
        if self._transpose:
            shape = (in_c, self._channels // self._groups)
        else:
            shape = (self._channels, in_c // self._groups)
        self.weight._finish_deferred_init(shape + self._kernel)

    def forward(self, x):
        self._resolve(x)
        op = F.deconvolution if self._transpose else F.convolution
        kw = {"adj": self._output_padding} if self._transpose else {}
        out = op(x, self.weight, self.bias, kernel=self._kernel,
                 stride=self._strides, dilate=self._dilation,
                 pad=self._padding, num_filter=self._channels,
                 num_group=self._groups, no_bias=self.bias is None,
                 layout=self._layout, **kw)
        if self._activation:
            out = F.activation(out, act_type=self._activation)
        return out

    def __repr__(self):
        return "%s(%s, kernel_size=%s, stride=%s)" % (
            type(self).__name__, self._channels, self._kernel, self._strides)


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         transpose=True, output_padding=output_padding)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         transpose=True, output_padding=output_padding)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         transpose=True, output_padding=output_padding)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 layout, count_include_pad=True, ceil_mode=False):
        super().__init__()
        self._kernel = pool_size
        self._stride = strides if strides is not None else pool_size
        self._pad = padding
        self._global = global_pool
        self._type = pool_type
        self._layout = layout
        self._count_include_pad = count_include_pad

    def forward(self, x):
        return F.pooling(
            x, kernel=self._kernel, pool_type=self._type,
            stride=_tuple(self._stride, len(self._kernel)),
            pad=_tuple(self._pad, len(self._kernel)),
            global_pool=self._global,
            count_include_pad=self._count_include_pad, layout=self._layout)

    def __repr__(self):
        return "%s(size=%s, stride=%s)" % (type(self).__name__,
                                           self._kernel, self._stride)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 1), strides, padding, False,
                         "max", layout, ceil_mode=ceil_mode)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 2), strides, padding, False,
                         "max", layout, ceil_mode=ceil_mode)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 3), strides, padding, False,
                         "max", layout, ceil_mode=ceil_mode)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_tuple(pool_size, 1), strides, padding, False,
                         "avg", layout, count_include_pad, ceil_mode)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuple(pool_size, 2), strides, padding, False,
                         "avg", layout, count_include_pad, ceil_mode)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuple(pool_size, 3), strides, padding, False,
                         "avg", layout, count_include_pad, ceil_mode)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, 0, True, "max", layout)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, "max", layout)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, 0, True, "max", layout)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, 0, True, "avg", layout)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, "avg", layout)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, 0, True, "avg", layout)


class ReflectionPad2D(HybridBlock):
    """Reflect-pads the last two axes of an NCHW input by ``padding``."""

    def __init__(self, padding=0, **kwargs):
        super().__init__()
        self._padding = padding

    def forward(self, x):
        p = self._padding
        return TF.pad(x, (p, p, p, p), mode="reflect")


class _PixelShuffle(HybridBlock):
    """(N, C*f1*..*fk, D1..Dk) -> (N, C, f1*D1, .., fk*Dk), channel index
    c*prod(f) + (f1-major tap), as in the JAX package."""

    def __init__(self, factor, ndim):
        super().__init__()
        self._f = (factor,) * ndim if isinstance(factor, int) \
            else tuple(factor)
        if len(self._f) != ndim:
            raise MXNetError("factor must have %d elements" % ndim)
        self._ndim = ndim

    def forward(self, x):
        f, k = self._f, self._ndim
        N, spatial = x.shape[0], tuple(x.shape[2:])
        C = x.shape[1] // math.prod(f)
        xr = x.reshape((N, C) + f + spatial)
        perm = [0, 1]
        for i in range(k):
            perm += [2 + k + i, 2 + i]  # Di, fi
        out_spatial = tuple(s * fi for s, fi in zip(spatial, f))
        return xr.permute(perm).reshape((N, C) + out_spatial)


class PixelShuffle1D(_PixelShuffle):
    """(N, f*C, W) -> (N, C, f*W)."""

    def __init__(self, factor):
        super().__init__(factor, 1)


class PixelShuffle2D(_PixelShuffle):
    """(N, f1*f2*C, H, W) -> (N, C, f1*H, f2*W)."""

    def __init__(self, factor):
        super().__init__(factor, 2)


class PixelShuffle3D(_PixelShuffle):
    """(N, f1*f2*f3*C, D, H, W) -> (N, C, f1*D, f2*H, f3*W)."""

    def __init__(self, factor):
        super().__init__(factor, 3)


class DeformableConvolution(_Resolving):
    """Deformable convolution v1/v2 (Dai et al. 2017, Zhu et al. 2019).

    Two branches, as in the reference block: a regular conv gives each
    kernel tap's (dy, dx) offsets (and, when ``modulated``, its mask
    through a sigmoid), and the deformable conv samples the input there.
    The offset branch starts at zero, so a fresh layer is the plain conv.
    """

    def __init__(self, channels, kernel_size=(3, 3), strides=(1, 1),
                 padding=(1, 1), in_channels=0, num_deformable_group=1,
                 use_bias=True, modulated=False, weight_initializer=None,
                 prefix=None):
        super().__init__()
        from ... import initializer as init

        self._kernel = _tuple(kernel_size, 2)
        self._strides = _tuple(strides, 2)
        self._padding = _tuple(padding, 2)
        self._channels = channels
        self._dg = num_deformable_group
        self._modulated = modulated
        kh, kw = self._kernel
        n_off = self._dg * kh * kw * (3 if modulated else 2)
        self.offset_weight = _param((n_off, in_channels, kh, kw),
                                    init=init.Zero())
        self.offset_bias = _param((n_off,), init=init.Zero())
        self.weight = _param((channels, in_channels, kh, kw),
                             init=weight_initializer or init.Xavier())
        self.bias = _param((channels,), init=init.Zero()) if use_bias \
            else None

    def infer_shape(self, x, *args):
        in_c = x.shape[1]
        kh, kw = self._kernel
        self.weight._finish_deferred_init((self._channels, in_c, kh, kw))
        self.offset_weight._finish_deferred_init(
            (self.offset_weight.shape[0], in_c, kh, kw))

    def forward(self, x):
        from ...ops.contrib_tail import deformable_convolution

        self._resolve(x)
        kh, kw = self._kernel
        off = F.convolution(x, self.offset_weight, self.offset_bias,
                            stride=self._strides, pad=self._padding)
        mask = None
        if self._modulated:
            n2 = self._dg * kh * kw * 2
            off, mask = off[:, :n2], off[:, n2:].sigmoid()
        return deformable_convolution(
            x, off, self.weight, self.bias, kernel=self._kernel,
            stride=self._strides, pad=self._padding,
            num_deformable_group=self._dg, mask=mask)


class ModulatedDeformableConvolution(DeformableConvolution):
    """DCNv2: deformable convolution with a per-tap modulation mask."""

    def __init__(self, *args, **kwargs):
        kwargs["modulated"] = True
        super().__init__(*args, **kwargs)
