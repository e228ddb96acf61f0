"""Tensor-op long tail: indexing, layout and shape utilities, registered
for ``mx.nd``.

Counterpart of ``mxnet_tpu/ops/tensor_tail.py``.  ``im2col`` is
``F.unfold`` (the same channel-major (c * kh + ki) * kw + kj column
order) and ``col2im`` is ``F.fold``, its adjoint, which sums overlaps.
"""
from __future__ import annotations

import builtins

import torch
import torch.nn.functional as F

from .registry import register


@register("batch_take")
def batch_take(a, indices):
    """output[i] = a[i, indices[i]]."""
    return torch.gather(a, 1, indices.long()[:, None])[:, 0]


@register("broadcast_like")
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    """Broadcast lhs to rhs's shape; with axes given, only those dims."""
    if lhs_axes is None:
        return lhs.broadcast_to(rhs.shape)
    shape = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        shape[la % lhs.dim()] = rhs.shape[ra % rhs.dim()]
    return lhs.broadcast_to(tuple(shape))


@register("reshape_like")
def reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    """Reshape lhs to rhs's shape; the begin/end window swaps only that
    slice of the shape."""
    if lhs_begin is None and rhs_begin is None:
        return lhs.reshape(rhs.shape)
    ls = list(lhs.shape)
    lb = 0 if lhs_begin is None else lhs_begin % (lhs.dim() + 1)
    le = lhs.dim() if lhs_end is None else lhs_end % (lhs.dim() + 1)
    rb = 0 if rhs_begin is None else rhs_begin % (rhs.dim() + 1)
    re_ = rhs.dim() if rhs_end is None else rhs_end % (rhs.dim() + 1)
    return lhs.reshape(tuple(ls[:lb]) + tuple(rhs.shape[rb:re_])
                       + tuple(ls[le:]))


@register("reverse")
def reverse(data, axis=0):
    """Flip along ``axis`` (an int or a tuple)."""
    return data.flip(tuple(axis) if isinstance(axis, (tuple, list))
                     else (axis,))


@register("slice")
def slice(data, begin, end, step=None):  # noqa: A001 - the op's name
    """Strided slice; None in begin, end or step takes the default."""
    step = step or (None,) * len(begin)
    slices = [builtins.slice(b, e, step[i] if i < len(step) else None)
              for i, (b, e) in enumerate(zip(begin, end))]
    return data[tuple(slices)]


@register("moments", num_outputs=2)
def moments(data, axes=None, keepdims=False):
    """Mean and (biased) variance over ``axes``."""
    ax = tuple(axes) if axes is not None else tuple(range(data.dim()))
    if not data.is_floating_point():
        data = data.to(torch.float32)     # JAX's mean promotes integers
    mean = data.mean(dim=ax, keepdim=True)
    var = (data - mean).square().mean(dim=ax, keepdim=keepdims)
    if not keepdims:
        mean = mean.reshape(var.shape)
    return mean, var


@register("depth_to_space")
def depth_to_space(data, block_size):
    """NCHW depth to space, in DCR order."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, block_size):
    """NCHW space to depth, the inverse of ``depth_to_space``."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("im2col")
def im2col(data, kernel, stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """Conv patches as columns, (N, C*kh*kw, L)."""
    return F.unfold(data, tuple(kernel), dilation=tuple(dilate),
                    padding=tuple(pad), stride=tuple(stride))


@register("col2im")
def col2im(data, input_size, kernel, stride=(1, 1), dilate=(1, 1),
           pad=(0, 0)):
    """Columns folded back to (N, C, H, W), overlaps summed."""
    return F.fold(data, tuple(input_size[-2:]), tuple(kernel),
                  dilation=tuple(dilate), padding=tuple(pad),
                  stride=tuple(stride))


@register("khatri_rao")
def khatri_rao(*matrices):
    """Column-wise Khatri-Rao product."""
    out = matrices[0]
    for m in matrices[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, m.shape[1])
    return out


@register("argmax_channel", differentiable=False)
def argmax_channel(data):
    """Argmax over the trailing axis of the 2-D flattened input, as
    float32."""
    return torch.argmax(data.reshape(data.shape[0], -1), dim=-1).to(
        torch.float32)
