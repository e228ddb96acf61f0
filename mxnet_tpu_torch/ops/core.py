"""Core tensor ops: element-wise, comparison, reduction, matrix, shape,
indexing, ordering, sequence and creation-like ops, registered for
``mx.nd``.

Counterpart of ``mxnet_tpu/ops/core.py``.  Each op is a plain function on
tensors (``register`` returns it unchanged), written so that its result
has the JAX op's value and dtype: an integer input to a transcendental op,
a mean or a ``std`` computes in float32 (JAX promotes it), a sum or count
of integers stays int32 (``invoke`` narrows torch's int64), ``argsort``
and ``topk`` indices are float32, and a Python scalar operand takes the
array's type, as JAX's weak types do.  Where torch has no counterpart
(negative-step slices, ``pad``'s modes on any axis, ``take``'s clip mode,
out-of-range ``one_hot``) the function spells out the JAX behaviour.
"""
# pylint: disable=redefined-builtin
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..base import MXNetError, _as_torch_dtype
from . import nn as _nn
from .registry import register

# ---- helpers ---------------------------------------------------------------


def _tensor(x, like):
    """``x`` as a tensor on ``like``'s device: a Python scalar becomes a
    0-dim tensor, which torch promotes as JAX promotes a weak scalar."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, device=like.device)


def _pair(lhs, rhs):
    """Both operands as tensors of their promoted dtype."""
    like = lhs if isinstance(lhs, torch.Tensor) else rhs
    lhs, rhs = _tensor(lhs, like), _tensor(rhs, like)
    dt = torch.result_type(lhs, rhs)
    return lhs.to(dt), rhs.to(dt)


def _inexact(x):
    """``x`` in float32 unless it is already floating or complex (JAX's
    promote-to-inexact rule)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(torch.float32)


def _float_pair(lhs, rhs):
    lhs, rhs = _pair(lhs, rhs)
    return _inexact(lhs), _inexact(rhs)


def _dims(x, axis):
    """``axis`` (None, int, list or tuple) -> a tuple of dims."""
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _reduce(fn, x, axis, keepdims):
    """``fn(x2d, dim=-1)`` over the dims of ``axis``, for the torch
    reductions that take one dim only."""
    dims = tuple(d % x.dim() for d in _dims(x, axis)) if x.dim() else ()
    keep = [d for d in range(x.dim()) if d not in dims]
    moved = x.permute(keep + list(dims)).reshape(
        [x.shape[d] for d in keep] + [-1])
    out = fn(moved, dim=-1)
    if keepdims:
        out = out.reshape([1 if d in dims else x.shape[d]
                           for d in range(x.dim())])
    return out


# ---- element-wise binary ---------------------------------------------------


@register("add")
def add(lhs, rhs):
    return lhs + rhs


@register("subtract")
def subtract(lhs, rhs):
    return lhs - rhs


@register("multiply")
def multiply(lhs, rhs):
    return lhs * rhs


@register("divide")
def divide(lhs, rhs):
    return lhs / rhs


@register("floor_divide")
def floor_divide(lhs, rhs):
    return lhs // rhs


@register("mod")
def mod(lhs, rhs):
    return lhs % rhs


@register("power")
def power(lhs, rhs):
    return lhs ** rhs


@register("maximum")
def maximum(lhs, rhs):
    return torch.maximum(*_pair(lhs, rhs))


@register("minimum")
def minimum(lhs, rhs):
    return torch.minimum(*_pair(lhs, rhs))


@register("hypot")
def hypot(lhs, rhs):
    return torch.hypot(*_float_pair(lhs, rhs))


@register("arctan2")
def arctan2(lhs, rhs):
    return torch.atan2(*_float_pair(lhs, rhs))


@register("logaddexp")
def logaddexp(lhs, rhs):
    return torch.logaddexp(*_float_pair(lhs, rhs))


# comparisons (not differentiable)
@register("equal", differentiable=False)
def equal(lhs, rhs):
    return lhs == rhs


@register("not_equal", differentiable=False)
def not_equal(lhs, rhs):
    return lhs != rhs


@register("greater", differentiable=False)
def greater(lhs, rhs):
    return lhs > rhs


@register("greater_equal", differentiable=False)
def greater_equal(lhs, rhs):
    return lhs >= rhs


@register("lesser", differentiable=False)
def lesser(lhs, rhs):
    return lhs < rhs


@register("lesser_equal", differentiable=False)
def lesser_equal(lhs, rhs):
    return lhs <= rhs


@register("logical_and", differentiable=False)
def logical_and(lhs, rhs):
    return torch.logical_and(*_pair(lhs, rhs))


@register("logical_or", differentiable=False)
def logical_or(lhs, rhs):
    return torch.logical_or(*_pair(lhs, rhs))


@register("logical_xor", differentiable=False)
def logical_xor(lhs, rhs):
    return torch.logical_xor(*_pair(lhs, rhs))


@register("logical_not", differentiable=False)
def logical_not(x):
    return torch.logical_not(x)


# ---- element-wise unary ----------------------------------------------------


@register("negative")
def negative(x):
    return -x


@register("abs")
def abs(x):
    return torch.abs(x)


@register("sign")
def sign(x):
    return torch.sign(x)


@register("round")
def round(x):
    return torch.round(x)   # half to even, as jnp.round


@register("rint")
def rint(x):
    return torch.round(_inexact(x))


# ceil, floor and fix return integer inputs as they are, as jnp's do
@register("ceil")
def ceil(x):
    return torch.ceil(x) if x.is_floating_point() else x


@register("floor")
def floor(x):
    return torch.floor(x) if x.is_floating_point() else x


@register("trunc")
def trunc(x):
    return torch.trunc(x) if x.is_floating_point() else x


@register("fix")
def fix(x):
    return torch.trunc(x) if x.is_floating_point() else x


@register("square")
def square(x):
    return x * x


@register("sqrt")
def sqrt(x):
    return torch.sqrt(_inexact(x))


@register("rsqrt")
def rsqrt(x):
    return torch.rsqrt(_inexact(x))


@register("cbrt")
def cbrt(x):
    x = _inexact(x)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


@register("rcbrt")
def rcbrt(x):
    return 1.0 / cbrt(x)


def _unary(name, fn):
    def op(x):
        return fn(_inexact(x))

    op.__name__ = name
    return register(name)(op)


exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log10 = _unary("log10", torch.log10)
log2 = _unary("log2", torch.log2)
log1p = _unary("log1p", torch.log1p)
reciprocal = _unary("reciprocal", torch.reciprocal)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
arcsin = _unary("arcsin", torch.asin)
arccos = _unary("arccos", torch.acos)
arctan = _unary("arctan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
arcsinh = _unary("arcsinh", torch.asinh)
arccosh = _unary("arccosh", torch.acosh)
arctanh = _unary("arctanh", torch.atanh)
degrees = _unary("degrees", torch.rad2deg)
radians = _unary("radians", torch.deg2rad)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
gamma = _unary("gamma", lambda x: torch.exp(torch.lgamma(x)))
gammaln = _unary("gammaln", torch.lgamma)


def _digamma(x):
    """NaN at the poles (0, -1, -2, ...), as ``jax.scipy.special.digamma``
    gives, where ``torch.digamma`` gives -inf at 0."""
    pole = (x <= 0) & (x == torch.floor(x))
    return torch.where(pole, torch.full_like(x, float("nan")),
                       torch.digamma(x))


digamma = _unary("digamma", _digamma)


@register("isnan", differentiable=False)
def isnan(x):
    return torch.isnan(x)


@register("isinf", differentiable=False)
def isinf(x):
    return torch.isinf(x)


@register("isfinite", differentiable=False)
def isfinite(x):
    return torch.isfinite(x)


@register("clip")
def clip(x, a_min=None, a_max=None):
    if a_min is None and a_max is None:
        return x                      # jnp.clip's answer; clamp refuses
    return torch.clamp(x, a_min, a_max)


# ---- reductions ------------------------------------------------------------


@register("sum")
def sum(x, axis=None, keepdims=False, dtype=None):
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdims,
                     dtype=None if dtype is None else _as_torch_dtype(dtype))


@register("mean")
def mean(x, axis=None, keepdims=False, dtype=None):
    x = _inexact(x) if dtype is None else x.to(_as_torch_dtype(dtype))
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdims)


@register("prod")
def prod(x, axis=None, keepdims=False):
    return _reduce(torch.prod, x, axis, keepdims)


@register("max")
def max(x, axis=None, keepdims=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdims)


@register("min")
def min(x, axis=None, keepdims=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdims)


@register("std")
def std(x, axis=None, ddof=0, keepdims=False):
    return torch.std(_inexact(x), dim=_dims(x, axis), correction=ddof,
                     keepdim=keepdims)


@register("var")
def var(x, axis=None, ddof=0, keepdims=False):
    return torch.var(_inexact(x), dim=_dims(x, axis), correction=ddof,
                     keepdim=keepdims)


@register("norm")
def norm(x, ord=2, axis=None, keepdims=False):
    x = _inexact(x)
    if ord == 2 and axis is None:
        return torch.sqrt(torch.sum(x * x))
    if isinstance(axis, (list, tuple)) and len(axis) == 1:
        axis = axis[0]
    return torch.linalg.norm(x, ord=ord, dim=None if axis is None
                             else (tuple(axis) if isinstance(axis, list)
                                   else axis), keepdim=keepdims)


@register("argmax", differentiable=False)
def argmax(x, axis=None):
    return torch.argmax(x, dim=axis)


@register("argmin", differentiable=False)
def argmin(x, axis=None):
    return torch.argmin(x, dim=axis)


@register("cumsum")
def cumsum(x, axis=None, dtype=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=axis, dtype=None if dtype is None
                        else _as_torch_dtype(dtype))


@register("cumprod")
def cumprod(x, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumprod(x, dim=axis)


@register("logsumexp")
def logsumexp(x, axis=None, keepdims=False):
    return torch.logsumexp(_inexact(x), dim=_dims(x, axis), keepdim=keepdims)


# ---- matrix products -------------------------------------------------------


@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """The last axis of lhs contracted with the first of rhs (MXNet's dot)
    in the promoted dtype of the two."""
    lhs, rhs = _nn._promote(lhs, rhs)
    if transpose_a and lhs.dim() > 1:
        lhs = lhs.transpose(-1, -2)
    if transpose_b and rhs.dim() > 1:
        rhs = rhs.transpose(-1, -2)
    if lhs.dim() <= 2 and rhs.dim() <= 2 and lhs.dim() and rhs.dim():
        return lhs @ rhs
    return torch.tensordot(lhs, rhs, dims=([lhs.dim() - 1], [0]))


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    lhs, rhs = _nn._promote(lhs, rhs)
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@register("matmul")
def matmul(a, b):
    return torch.matmul(*_nn._promote(a, b))


@register("tensordot")
def tensordot(a, b, axes=2):
    return torch.tensordot(*_nn._promote(a, b), dims=axes)


@register("einsum")
def einsum(*operands, subscripts=None, optimize=True):
    return torch.einsum(subscripts, *_nn._promote(*operands))


@register("outer")
def outer(a, b):
    a, b = _nn._promote(a, b)
    return torch.outer(a.reshape(-1), b.reshape(-1))


@register("inner")
def inner(a, b):
    return torch.inner(*_nn._promote(a, b))


@register("kron")
def kron(a, b):
    return torch.kron(*_nn._promote(a, b))


@register("trace")
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@register("diag")
def diag(x, k=0):
    return torch.diag(x, k)


@register("diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


# ---- shape manipulation ----------------------------------------------------


@register("transpose")
def transpose(x, axes=None):
    return x.permute(tuple(reversed(range(x.dim()))) if axes is None
                     else tuple(axes))


@register("swapaxes")
def swapaxes(x, dim1=0, dim2=1):
    return x.transpose(dim1, dim2)


@register("expand_dims")
def expand_dims(x, axis=0):
    return x.unsqueeze(axis)


@register("squeeze")
def squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    for d in _dims(x, axis):
        if x.shape[d] != 1:
            raise MXNetError("squeeze: axis %d has size %d, not 1"
                             % (d, x.shape[d]))
    return x.squeeze(_dims(x, axis))


@register("reshape")
def reshape(x, shape=None):
    return x.reshape(tuple(shape))


@register("flatten")
def flatten(x):
    return x.reshape(x.shape[0], -1)


@register("broadcast_to")
def broadcast_to(x, shape=None):
    """Broadcast to ``shape``; a 0 there keeps x's size of that axis."""
    shape = tuple(x.shape[i] if s == 0 else s for i, s in enumerate(shape))
    return x.broadcast_to(shape)


@register("tile")
def tile(x, reps=None):
    return x.tile(tuple(reps) if isinstance(reps, (list, tuple)) else
                  (reps,))


@register("repeat")
def repeat(x, repeats=1, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@register("flip")
def flip(x, axis=None):
    return x.flip(_dims(x, axis))


@register("roll")
def roll(x, shift=None, axis=None):
    return torch.roll(x, shift, dims=axis)


@register("rot90")
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, dims=tuple(axes))


@register("concat")
def concat(*xs, dim=1):
    return torch.cat(_nn._promote(*xs), dim=dim)


@register("stack")
def stack(*xs, axis=0):
    return torch.stack(_nn._promote(*xs), dim=axis)


@register("split", num_outputs=None)
def split(x, num_outputs=None, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts along ``axis`` (or the parts at the
    indices it lists), each squeezed with ``squeeze_axis``."""
    if isinstance(num_outputs, int):
        if x.shape[axis] % num_outputs:
            raise MXNetError("split: axis of size %d does not divide into "
                             "%d parts" % (x.shape[axis], num_outputs))
        outs = torch.split(x, x.shape[axis] // num_outputs, dim=axis)
    else:
        outs = torch.tensor_split(x, list(num_outputs), dim=axis)
    if squeeze_axis:
        outs = [o.squeeze(axis) for o in outs]
    return tuple(outs)


@register("array_split", num_outputs=None)
def array_split(x, indices_or_sections, axis=0):
    ios = indices_or_sections
    return tuple(torch.tensor_split(
        x, ios if isinstance(ios, int) else list(ios), dim=axis))


@register("slice_axis")
def slice_axis(x, axis=0, begin=0, end=None):
    axis = axis % x.dim()
    return x[(builtins.slice(None),) * axis + (builtins.slice(begin, end),)]


@register("slice_like")
def slice_like(x, shape_like, axes=None):
    """x cut to ``shape_like``'s shape (on ``axes``, default all; equal
    ranks are needed then)."""
    if axes is None and x.dim() != shape_like.dim():
        raise MXNetError(
            "slice_like without axes needs equal ranks, got %d vs %d; "
            "pass axes= to slice a subset" % (x.dim(), shape_like.dim()))
    slices = [builtins.slice(None)] * x.dim()
    for ax in (axes if axes is not None else range(x.dim())):
        slices[ax] = builtins.slice(0, shape_like.shape[ax])
    return x[tuple(slices)]


def _pad_widths(pad_width, ndim):
    """numpy's pad_width forms (an int, (n,), (b, a), ((b, a), ...)) or the
    legacy flat (b0, a0, b1, a1, ...) -> [(b, a)] a dim."""
    pw = pad_width
    if isinstance(pw, (int, np.integer)):
        return [(int(pw), int(pw))] * ndim
    pw = list(pw)
    if pw and not isinstance(pw[0], (tuple, list)):
        if len(pw) == 2 * ndim and ndim != 1:
            return [(int(pw[2 * i]), int(pw[2 * i + 1])) for i in range(ndim)]
        if len(pw) == 1:
            return [(int(pw[0]), int(pw[0]))] * ndim
        return [(int(pw[0]), int(pw[1]))] * ndim
    if len(pw) == 1:
        return [tuple(int(v) for v in pw[0])] * ndim
    return [tuple(int(v) for v in p) for p in pw]


@register("pad")
def pad(x, pad_width=None, mode="constant", constant_value=0):
    """numpy.pad's widths and modes on any axis: constant padding by
    ``F.pad``, the other modes by gathering the indices ``numpy.pad``
    gives a range."""
    widths = _pad_widths(pad_width, x.dim())
    if mode == "constant":
        flat = [v for b, a in reversed(widths) for v in (b, a)]
        return torch.nn.functional.pad(x, flat, value=constant_value)
    for d, (b, a) in enumerate(widths):
        if b or a:
            idx = np.pad(np.arange(x.shape[d]), (b, a), mode=mode)
            x = torch.index_select(x, d, torch.as_tensor(idx,
                                                         device=x.device))
    return x


@register("where")
def where(cond, x, y):
    return torch.where(cond.bool() if isinstance(cond, torch.Tensor)
                       else cond, *_pair(x, y))


@register("tril")
def tril(x, k=0):
    return torch.tril(x, k)


@register("triu")
def triu(x, k=0):
    return torch.triu(x, k)


@register("meshgrid", num_outputs=None)
def meshgrid(*xs, indexing="xy"):
    return tuple(torch.meshgrid(*xs, indexing=indexing))


# ---- indexing --------------------------------------------------------------


@register("take")
def take(x, indices, axis=0, mode="clip"):
    """x's slices at ``indices`` along ``axis``; an index out of range is
    clipped (``mode='clip'``) or wrapped (``'wrap'``)."""
    idx = _tensor(indices, x).long()
    n = x.shape[axis]
    idx = idx.remainder(n) if mode == "wrap" else idx.clamp(0, n - 1)
    axis = axis % x.dim()
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


register("pick")(_nn.pick)
register("take_along_axis")(_nn.take_along_axis)


def _in_bounds(idx, n):
    """Indices as XLA's gather reads them: a negative one counts from the
    end, and one out of range is clamped to the edge."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


@register("gather_nd")
def gather_nd(data, indices):
    return data[tuple(_in_bounds(indices[i], data.shape[i])
                      for i in range(indices.shape[0]))]


@register("scatter_nd")
def scatter_nd(data, indices, shape=None):
    idx = tuple(indices[i].long() for i in range(indices.shape[0]))
    return torch.zeros(tuple(shape), dtype=data.dtype,
                       device=data.device).index_put(idx, data)


register("embedding")(_nn.embedding)


@register("one_hot")
def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """One-hot rows of ``depth``; an index outside [0, depth) gives a row
    of ``off_value``."""
    hot = indices.long().unsqueeze(-1) == torch.arange(
        depth, device=indices.device)
    oh = hot.to(_as_torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register("boolean_mask", differentiable=False)
def boolean_mask(data, mask):
    return data[mask.bool()]


# ---- ordering --------------------------------------------------------------


@register("sort")
def sort(x, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else out.flip(axis)


@register("argsort", differentiable=False)
def argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        out = out.flip(axis)
    return out.to(_as_torch_dtype(dtype))


@register("topk", differentiable=False, num_outputs=None)
def topk(x, k=1, axis=-1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    vals, idx = torch.topk(x, k, dim=axis, largest=not is_ascend,
                           sorted=True)
    idx = idx.to(_as_torch_dtype(dtype))
    if ret_typ == "indices":
        return idx
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return (vals, idx)
    raise ValueError("unknown ret_typ %s" % ret_typ)


@register("unique", differentiable=False)
def unique(x):
    return torch.unique(x)


@register("nonzero", differentiable=False)
def nonzero(x):
    return torch.nonzero(x)


@register("histogram", differentiable=False, num_outputs=2)
def histogram(x, bins=10, range=None):
    """Counts and edges (x's float type): numpy's bins, the last one
    closed."""
    x = _inexact(x).reshape(-1)
    if isinstance(bins, torch.Tensor):
        edges = bins.to(x.dtype)
    else:
        lo, hi = (range if range is not None
                  else (x.min().item(), x.max().item()))
        edges = torch.linspace(float(lo), float(hi), bins + 1,
                               dtype=x.dtype, device=x.device)
    n = edges.numel() - 1
    which = torch.bucketize(x, edges, right=True) - 1
    which = torch.where(x == edges[-1], n - 1, which)
    inside = (which >= 0) & (which < n)
    cnt = torch.zeros(n, dtype=x.dtype, device=x.device).index_add(
        0, which[inside], torch.ones_like(x[inside]))
    return cnt, edges


# ---- sequence ops ----------------------------------------------------------


@register("sequence_mask")
def sequence_mask(data, sequence_length=None, use_sequence_length=True,
                  value=0.0, axis=0):
    """Set the time steps at and past each sequence's length to ``value``;
    data is (T, B, ...) for axis=0, (B, T, ...) for axis=1."""
    if sequence_length is None or not use_sequence_length:
        return data
    pos = torch.arange(data.shape[axis], device=data.device)
    sl = sequence_length.long()
    mask = pos[:, None] < sl[None, :] if axis == 0 else \
        pos[None, :] < sl[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.as_tensor(value, dtype=data.dtype,
                                                   device=data.device))


@register("sequence_last")
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    idx = sequence_length.long() - 1
    batch = torch.arange(data.shape[1 - axis], device=data.device)
    return data[idx, batch] if axis == 0 else data[batch, idx]


@register("sequence_reverse")
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.flip(axis)
    pos = torch.arange(data.shape[axis], device=data.device)
    sl = sequence_length.long()
    rev = torch.where(pos[:, None] < sl[None, :],
                      sl[None, :] - 1 - pos[:, None], pos[:, None])
    batch = torch.arange(data.shape[1], device=data.device)
    return data[rev, batch[None, :]]


# ---- casting and misc ------------------------------------------------------


@register("cast")
def cast(x, dtype="float32"):
    return x.to(_as_torch_dtype(dtype))


@register("identity")
def identity(x):
    return x


@register("stop_gradient", differentiable=False)
def stop_gradient(x):
    return x.detach()


@register("shape_array", differentiable=False)
def shape_array(x):
    return torch.tensor(x.shape, dtype=torch.int32, device=x.device)


@register("size_array", differentiable=False)
def size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int32, device=x.device)


@register("zeros_like")
def zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like")
def ones_like(x):
    return torch.ones_like(x)


@register("full_like")
def full_like(x, fill_value=0.0):
    if isinstance(fill_value, torch.Tensor):      # broadcast, as JAX does
        return torch.broadcast_to(fill_value.to(x.dtype), x.shape).clone()
    return torch.full_like(x, fill_value)


@register("add_n")
def add_n(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out
