"""INT8 quantization operators.

Counterpart of ``mxnet_tpu/ops/quantization.py``: symmetric int8
quantization (zero point 0, per-tensor float32 scales), ``quantize``,
``quantize_v2``, ``dequantize``, ``requantize`` and the int8 products
``quantized_fully_connected`` / ``quantized_conv``, whose int32
accumulators are rescaled in float32.

The int8 x int8 products accumulate in float64: every partial sum of
int8 products below 2^53 is exact there, so the result equals the int32
accumulator the JAX op asks XLA for, on the CPU and on the card alike
(torch has no integer matmul or convolution on CUDA).
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["quantize", "quantize_v2", "dequantize", "requantize",
           "quantized_fully_connected", "quantized_conv"]


def _f32(v, like):
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _scale_of(min_range, max_range, dtype):
    amax = torch.maximum(torch.abs(min_range), torch.abs(max_range))
    amax = torch.clamp(amax, min=1e-12)
    qmax = 127.0 if dtype == "int8" else 255.0
    return qmax / amax


def _to_int8(x, scale):
    return torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)


@register("quantize", differentiable=False, num_outputs=3)
def quantize(data, min_range, max_range, out_type="int8"):
    """f32 -> int8 with an explicit range; returns (quantized, min_range,
    max_range), the reference's three outputs."""
    mn, mx = _f32(min_range, data), _f32(max_range, data)
    return _to_int8(data, _scale_of(mn, mx, out_type)), mn, mx


@register("quantize_v2", differentiable=False, num_outputs=3)
def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """The calibrated range if given, else the tensor's own max |x|."""
    if min_calib_range is None or max_calib_range is None:
        amax = torch.max(torch.abs(data)).to(torch.float32)
        mn, mx = -amax, amax
    else:
        mn, mx = _f32(min_calib_range, data), _f32(max_calib_range, data)
    return _to_int8(data, _scale_of(mn, mx, out_type)), mn, mx


@register("dequantize", differentiable=False)
def dequantize(data, min_range, max_range, out_type="float32"):
    scale = _scale_of(_f32(min_range, data), _f32(max_range, data), "int8")
    return data.to(torch.float32) / scale


@register("requantize", differentiable=False, num_outputs=3)
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 accumulator -> int8 in the calibrated output range."""
    mn_in, mx_in = _f32(min_range, data), _f32(max_range, data)
    real = data.to(torch.float32) * (
        torch.maximum(torch.abs(mn_in), torch.abs(mx_in)) / (2.0 ** 31))
    if min_calib_range is None:
        amax = torch.max(torch.abs(real))
        mn, mx = -amax, amax
    else:
        mn, mx = _f32(min_calib_range, data), _f32(max_calib_range, data)
    return _to_int8(real, _scale_of(mn, mx, "int8")), mn, mx


@register("quantized_fully_connected", differentiable=False)
def quantized_fully_connected(x_q, w_q, bias, scale_x, scale_w,
                              num_hidden=None, flatten=True, no_bias=False):
    """int8 (N, K) x int8 (O, K) -> int32 accumulator -> f32 / scales;
    the bias (f32) is added after the rescale."""
    if flatten and x_q.dim() > 2:
        x_q = x_q.reshape(x_q.shape[0], -1)
    acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64).T)
    y = acc.to(torch.int32).to(torch.float32) / (scale_x * scale_w)
    if bias is not None and not no_bias:
        y = y + bias
    return y


@register("quantized_conv", differentiable=False)
def quantized_conv(x_q, w_q, bias, scale_x, scale_w, kernel=None,
                   stride=None, dilate=None, pad=None, num_filter=None,
                   num_group=1, no_bias=False, layout=None):
    """int8 convolution with an int32 accumulator, x laid out by
    ``layout`` (default NCW/NCHW/NCDHW), weights OI*."""
    from .nn import _CONV, _from_nc, _layout, _to_nc

    n = x_q.dim() - 2
    x, back = _to_nc(x_q, _layout(x_q.dim(), layout))
    acc = _CONV[n](x.to(torch.float64), w_q.to(torch.float64), None,
                   stride=tuple(stride) if stride else 1,
                   padding=tuple(pad) if pad else 0,
                   dilation=tuple(dilate) if dilate else 1, groups=num_group)
    y = acc.to(torch.int32).to(torch.float32) / (scale_x * scale_w)
    if bias is not None and not no_bias:
        y = y + bias.reshape((1, -1) + (1,) * n)
    return _from_nc(y, back)
