"""NumPy-semantics long-tail operators (the reference's ``_npi_*``).

Counterpart of ``mxnet_tpu/ops/np_tail.py``: percentile, cross, pad,
window functions, polynomial, insert/delete, the nan-reductions, the
bitwise family.  The JAX ops are ``jax.numpy`` expressions; here an op is
the ``torch._numpy`` function of the same name where that module has it
(torch's own NumPy layer: torch ops on the input's device, on torch's
autograd tape), and a torch expression written out below where it has
not (``compress``, ``delete``, ``digitize``, ``ediff1d``, ``extract``,
``insert``, ``interp``, the nan-reductions, ``polyval``, ``spacing``,
``unravel_index``, ``trim_zeros``, ``choose``, ``fill_diagonal``...).
Registering them puts them on the same ``invoke`` path as every op (the
tape, amp's classification, ``mx.nd``/``mx.npx`` names).

``torch._numpy`` follows NumPy's 64-bit defaults (float64 windows,
int64 indices); ``invoke`` narrows results to the JAX package's x32
types.  ``tnp`` and ``unwrap`` are the bridge ``mx.np`` uses as well.
"""
from __future__ import annotations

import math

import torch
import torch._numpy as _tnp

from ..context import current_context
from .registry import register

__all__ = ["tnp", "unwrap"]


def unwrap(out):
    """A ``torch._numpy`` result as tensors (tuples stay tuples)."""
    if isinstance(out, _tnp.ndarray):
        return out.tensor
    if isinstance(out, (tuple, list)):
        return tuple(unwrap(o) for o in out)
    return out


def _device(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (list, tuple)):
            d = _device(a)
            if d is not None:
                return d
    return None


def tnp(name):
    """``torch._numpy.<name>`` taking and returning tensors; the tensors
    it makes land on its inputs' device (the current context's when it
    has no tensor input)."""
    f = getattr(_tnp, name)

    def call(*args, **kwargs):
        dev = _device(list(args) + list(kwargs.values())) or \
            current_context().torch_device
        with torch.device(dev):
            return unwrap(f(*args, **kwargs))

    call.__name__ = name
    return call


def _reg(name, fn, differentiable=True, num_outputs=1):
    fn.__name__ = name
    register(name, num_outputs=num_outputs,
             differentiable=differentiable)(fn)


def _axes(a, axis):
    if axis is None:
        return tuple(range(a.dim()))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _flat_or(a, axis):
    return (a.reshape(-1), 0) if axis is None else (a, axis)


# ---- nan-reductions -------------------------------------------------------

def _float(a):
    return a if a.is_floating_point() or a.is_complex() else a.to(
        torch.float32)


def _nan_extreme(a, axis, keepdims, fill, reduce):
    if not (a.is_floating_point() or a.is_complex()):
        # no NaN to skip: the extreme in the input's dtype, as JAX gives
        return reduce(a, dim=_axes(a, axis), keepdim=keepdims)
    nan = torch.isnan(a)
    out = reduce(torch.where(nan, torch.full_like(a, fill), a),
                 dim=_axes(a, axis), keepdim=keepdims)
    allnan = nan.all(dim=_axes(a, axis), keepdim=keepdims) if a.dim() else nan
    return torch.where(allnan, torch.full_like(out, float("nan")), out)


def nanmax(a, axis=None, keepdims=False):
    return _nan_extreme(a, axis, keepdims, float("-inf"), torch.amax)


def nanmin(a, axis=None, keepdims=False):
    return _nan_extreme(a, axis, keepdims, float("inf"), torch.amin)


def nansum(a, axis=None, keepdims=False):
    return torch.nansum(a, dim=_axes(a, axis), keepdim=keepdims)


def nanprod(a, axis=None, keepdims=False):
    a = torch.where(torch.isnan(a), torch.ones_like(a), a)
    if axis is None and not keepdims:
        return a.prod()
    for d in sorted(_axes(a, axis), reverse=True):
        a = a.prod(dim=d, keepdim=True)
    return a if keepdims else a.squeeze(_axes(a, axis))


def nanmean(a, axis=None, keepdims=False):
    return torch.nanmean(_float(a), dim=_axes(a, axis), keepdim=keepdims)


def nanvar(a, axis=None, ddof=0, keepdims=False):
    a = _float(a)
    dims = _axes(a, axis)
    ok = ~torch.isnan(a)
    mean = torch.nanmean(a, dim=dims, keepdim=True)
    d = torch.where(ok, a - mean, torch.zeros_like(a))
    cnt = ok.sum(dim=dims, keepdim=keepdims).to(a.dtype)
    return (d * d).sum(dim=dims, keepdim=keepdims) / (cnt - ddof)


def nanstd(a, axis=None, ddof=0, keepdims=False):
    return torch.sqrt(nanvar(a, axis, ddof, keepdims))


# ---- reductions / statistics ---------------------------------------------

def quantile(a, q=0.5, axis=None, keepdims=False):
    """numpy's linear-interpolation quantile (``torch.quantile``; a scalar
    ``q`` gives numpy's shape, where ``torch._numpy`` adds an axis)."""
    a = a if a.is_floating_point() else a.to(torch.float32)
    q = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    if axis is None:
        out = torch.quantile(a.reshape(-1), q)
        return out.reshape(q.shape + (1,) * a.dim()) if keepdims else out
    return torch.quantile(a, q, dim=axis, keepdim=keepdims)


def percentile(a, q=50.0, axis=None, keepdims=False):
    q = torch.as_tensor(q, dtype=torch.float64) / 100.0
    return quantile(a, q, axis=axis, keepdims=keepdims)


def median(a, axis=None, keepdims=False):
    return quantile(a, 0.5, axis=axis, keepdims=keepdims)


_average = tnp("average")
_cov = tnp("cov")
_corrcoef = tnp("corrcoef")
_ptp = tnp("ptp")
_reg("percentile", percentile)
_reg("quantile", quantile)
_reg("median", median)
_reg("average", lambda a, weights=None, axis=None:
     _average(a, axis=axis) if weights is None
     else _average(a, axis=axis, weights=weights))
_reg("cov", lambda m, y=None, rowvar=True, bias=False:
     _cov(m, y, rowvar=rowvar, bias=bias))
_reg("corrcoef", lambda x, y=None, rowvar=True:
     _corrcoef(x, y, rowvar=rowvar))
_reg("ptp", lambda a, axis=None, keepdims=False:
     _ptp(a, axis=axis, keepdims=keepdims))
_reg("nanmax", nanmax)
_reg("nanmin", nanmin)
_reg("nansum", nansum)
_reg("nanprod", nanprod)
_reg("nanmean", nanmean)
_reg("nanstd", nanstd)
_reg("nanvar", nanvar)
_reg("count_nonzero", lambda a, axis=None:
     torch.count_nonzero(a, dim=axis).to(torch.int32), differentiable=False)
_reg("bincount", lambda x, weights=None, minlength=0:
     torch.bincount(x.reshape(-1), weights=weights, minlength=minlength),
     differentiable=False)


def digitize(x, bins, right=False):
    """Bin index of each ``x`` in increasing ``bins`` (numpy's rule:
    ``bins[i-1] <= x < bins[i]``, or ``<`` / ``<=`` with ``right``)."""
    return torch.bucketize(x, bins, right=not right).to(torch.int32)


def searchsorted(a, v, side="left"):
    return torch.searchsorted(a, v, side=side).to(torch.int32)


_reg("digitize", digitize, differentiable=False)
_reg("searchsorted", searchsorted, differentiable=False)

# ---- elementwise / math ---------------------------------------------------


def interp(x, xp, fp, left=None, right=None):
    """One-dimensional linear interpolation, written as ``jnp.interp``
    writes it (so the gradients reach ``x``, ``xp`` and ``fp`` alike)."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp.detach(), x.detach(),
                                       right=True), 1, n - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    tiny = dx.abs() <= torch.finfo(dx.dtype).eps
    f = torch.where(tiny, f0,
                    f0 + (x - x0) / torch.where(tiny, torch.ones_like(dx),
                                                dx) * (f1 - f0))
    lo = fp[0] if left is None else torch.as_tensor(left, dtype=f.dtype,
                                                    device=f.device)
    hi = fp[-1] if right is None else torch.as_tensor(right, dtype=f.dtype,
                                                      device=f.device)
    f = torch.where(x < xp[0], lo, f)
    return torch.where(x > xp[-1], hi, f)


def polyval(p, x):
    """Horner's rule: ``p[0] x^(n-1) + ... + p[n-1]``, in floating point
    (``jnp.polyval`` promotes integers)."""
    p, x = _float(p), _float(x)
    y = torch.zeros_like(x * p[0])
    for i in range(p.shape[0]):
        y = y * x + p[i]
    return y


def spacing(x):
    """Distance from ``x`` to the next float away from zero."""
    x = _float(x)
    away = torch.where(torch.signbit(x), torch.full_like(x, float("-inf")),
                       torch.full_like(x, float("inf")))
    return torch.nextafter(x, away) - x


def ediff1d(a, to_end=None, to_begin=None):
    d = torch.diff(a.reshape(-1))
    parts = [torch.as_tensor(v, dtype=d.dtype, device=d.device).reshape(-1)
             for v in (to_begin,) if v is not None] + [d] + \
        [torch.as_tensor(v, dtype=d.dtype, device=d.device).reshape(-1)
         for v in (to_end,) if v is not None]
    return torch.cat(parts)


_reg("interp", interp)
_nan_to_num = tnp("nan_to_num")
_reg("nan_to_num", lambda x, nan=0.0, posinf=None, neginf=None:
     _nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf))
_reg("heaviside", lambda x1, x2: torch.heaviside(
    _float(x1), _float(x2).to(_float(x1).dtype)))
_reg("copysign", lambda x1, x2: torch.copysign(x1, x2))
_reg("ldexp", lambda x1, x2: torch.ldexp(x1, x2))
_reg("signbit", lambda x: torch.signbit(x), differentiable=False)
_reg("float_power", lambda x1, x2: torch.float_power(x1, x2))
_reg("fmod", lambda x1, x2: torch.fmod(x1, x2))
_reg("remainder", lambda x1, x2: torch.remainder(x1, x2))
_reg("gcd", lambda x1, x2: torch.gcd(x1, x2), differentiable=False)
_reg("lcm", lambda x1, x2: torch.lcm(x1, x2), differentiable=False)
_reg("bitwise_and", lambda x1, x2: torch.bitwise_and(x1, x2),
     differentiable=False)
_reg("bitwise_or", lambda x1, x2: torch.bitwise_or(x1, x2),
     differentiable=False)
_reg("bitwise_xor", lambda x1, x2: torch.bitwise_xor(x1, x2),
     differentiable=False)
_reg("bitwise_not", lambda x: torch.bitwise_not(x), differentiable=False)
_reg("left_shift", lambda x1, x2: torch.bitwise_left_shift(x1, x2),
     differentiable=False)
_reg("right_shift", lambda x1, x2: torch.bitwise_right_shift(x1, x2),
     differentiable=False)
_cross = tnp("cross")
_reg("cross", lambda a, b, axis=-1: _cross(a, b, axis=axis))
_reg("polyval", polyval)
_vander = tnp("vander")
_reg("vander", lambda x, N=None, increasing=False:
     _vander(x, N=N, increasing=increasing))
_reg("ediff1d", ediff1d)
_reg("diff", lambda a, n=1, axis=-1: torch.diff(a, n=n, dim=axis))
_reg("trapz", lambda y, x=None, dx=1.0, axis=-1:
     torch.trapezoid(y, dim=axis, dx=dx) if x is None
     else torch.trapezoid(y, x, dim=axis))


def unwrap_phase(p, discont=None, axis=-1, period=2 * math.pi):
    """numpy.unwrap: jumps of at least ``discont`` (default half the
    period) folded by multiples of ``period``."""
    half = period / 2
    discont = half if discont is None else discont
    dd = torch.diff(p, dim=axis)
    ddmod = torch.remainder(dd + half, period) - half
    ddmod = torch.where((ddmod == -half) & (dd > 0),
                        torch.full_like(ddmod, half), ddmod)
    corr = torch.where(dd.abs() < discont, torch.zeros_like(dd), ddmod - dd)
    head = p.narrow(axis, 0, 1)
    return torch.cat([head, p.narrow(axis, 1, p.shape[axis] - 1)
                      + torch.cumsum(corr, dim=axis)], dim=axis)


_reg("unwrap", lambda p, axis=-1: unwrap_phase(p, axis=axis))
_reg("isclose", lambda a, b, rtol=1e-5, atol=1e-8, equal_nan=False:
     torch.isclose(a, b.to(a.dtype) if isinstance(b, torch.Tensor) else
                   torch.as_tensor(b, dtype=a.dtype, device=a.device),
                   rtol=rtol, atol=atol, equal_nan=equal_nan),
     differentiable=False)
_reg("isposinf", lambda x: torch.isposinf(x), differentiable=False)
_reg("isneginf", lambda x: torch.isneginf(x), differentiable=False)

# ---- shape / assembly -----------------------------------------------------

for _n in ("hstack", "vstack", "dstack", "column_stack"):
    _reg(_n, (lambda f: lambda *arrays: f(arrays))(tnp(_n)))
_reg("atleast_1d", lambda a: torch.atleast_1d(a))
_reg("atleast_2d", lambda a: torch.atleast_2d(a))
_reg("atleast_3d", lambda a: torch.atleast_3d(a))
_reg("moveaxis", lambda a, source, destination:
     torch.movedim(a, source, destination))


def rollaxis(a, axis, start=0):
    """numpy.rollaxis: ``axis`` moved to sit before ``start``."""
    n = a.dim()
    axis, start = axis % n, start + n if start < 0 else start
    if axis < start:
        start -= 1
    return a if axis == start else torch.movedim(a, axis, start)


_reg("rollaxis", rollaxis)
_append = tnp("append")
_reg("append", lambda arr, values, axis=None:
     _append(arr, values, axis=axis))


def _index_list(obj, n):
    if isinstance(obj, torch.Tensor):
        obj = obj.reshape(-1).tolist()
    if isinstance(obj, slice):
        obj = list(range(*obj.indices(n)))
    return [obj] if isinstance(obj, int) else [int(i) for i in obj]


def insert(arr, obj, values, axis=None):
    """numpy.insert: ``values`` before the indices ``obj`` along ``axis``
    (flattened when None)."""
    arr, axis = _flat_or(arr, axis)
    axis = axis % arr.dim()
    n = arr.shape[axis]
    scalar = isinstance(obj, int)
    idx = [i + n if i < 0 else i for i in _index_list(obj, n)]
    values = torch.as_tensor(values, dtype=arr.dtype, device=arr.device) \
        if not isinstance(values, torch.Tensor) else values.to(arr.dtype)
    shape = list(arr.shape)
    if scalar:
        # numpy: values raised to arr's rank, its first axis moved to axis
        vals = values.reshape((1,) * (arr.dim() - values.dim())
                              + tuple(values.shape))
        vals = torch.movedim(vals, 0, axis)
        shape[axis] = vals.shape[axis]
        vals = vals.expand(*shape)
        parts = [arr.narrow(axis, 0, idx[0]), vals,
                 arr.narrow(axis, idx[0], n - idx[0])]
        return torch.cat(parts, dim=axis)
    k = len(idx)
    shape[axis] = k
    vals = values
    if vals.dim() == 1 and arr.dim() > 1:
        vals = torch.movedim(vals.reshape((-1,) + (1,) * (arr.dim() - 1)),
                             0, axis)
    vals = vals.expand(*shape) if vals.dim() else vals.reshape(
        (1,) * arr.dim()).expand(*shape)
    order = sorted(range(k), key=lambda j: idx[j])
    new_pos = [idx[j] + r for r, j in enumerate(order)]
    total, taken = n + k, set(new_pos)
    keep = [p for p in range(total) if p not in taken]
    out = torch.empty(arr.shape[:axis] + (total,) + arr.shape[axis + 1:],
                      dtype=arr.dtype, device=arr.device)
    dev = arr.device
    out = out.index_copy(axis, torch.tensor(keep, device=dev), arr)
    return out.index_copy(axis, torch.tensor(new_pos, device=dev),
                          vals.index_select(
                              axis, torch.tensor(order, device=dev)))


def delete(arr, obj, axis=None):
    arr, axis = _flat_or(arr, axis)
    n = arr.shape[axis]
    drop = {i % n for i in _index_list(obj, n)}
    keep = torch.tensor([i for i in range(n) if i not in drop],
                        dtype=torch.long, device=arr.device)
    return arr.index_select(axis, keep)


def resize_array(a, new_shape):
    shape = (new_shape,) if isinstance(new_shape, int) else tuple(new_shape)
    total = 1
    for s in shape:
        total *= s
    flat = a.reshape(-1)
    reps = -(-total // max(flat.numel(), 1))
    return flat.repeat(reps)[:total].reshape(shape)


def trim_zeros(filt, trim="fb"):
    nz = torch.nonzero(filt).reshape(-1).tolist()
    if not nz:
        return filt[:0]
    lo = nz[0] if "f" in trim.lower() else 0
    hi = nz[-1] + 1 if "b" in trim.lower() else filt.shape[0]
    return filt[lo:hi]


def compress(condition, a, axis=None):
    a, axis = _flat_or(a, axis)
    cond = condition.reshape(-1).to(torch.bool)
    idx = torch.nonzero(cond).reshape(-1)
    return a.index_select(axis, idx[idx < a.shape[axis]])


def choose(a, *choices):
    """``choices[a]`` element by element, ``a`` clipped to the range
    (numpy's ``mode='clip'``)."""
    stack = torch.stack(torch.broadcast_tensors(*choices))
    idx = torch.clamp(a.long(), 0, len(choices) - 1)
    idx = idx.expand(stack.shape[1:]).unsqueeze(0)
    return stack.gather(0, idx).squeeze(0)


def unravel_index(indices, shape):
    out, rest = [], indices.long()
    for s in reversed(tuple(shape)):
        out.append(rest % s)
        rest = rest // s
    return torch.stack(out[::-1])


def ravel_multi_index(multi_index, dims):
    idx = multi_index.long() if isinstance(multi_index, torch.Tensor) \
        else torch.stack([torch.as_tensor(m) for m in multi_index]).long()
    flat = torch.zeros_like(idx[0])
    for i, d in enumerate(dims):
        flat = flat * d + torch.clamp(idx[i], 0, d - 1)
    return flat


def fill_diagonal(a, val):
    n = min(a.shape)
    idx = torch.arange(n, device=a.device)
    out = a.clone()
    v = torch.as_tensor(val, dtype=a.dtype, device=a.device).reshape(-1)
    if v.numel() > 1:      # numpy's rule: the values in order, repeated
        v = v.repeat(-(-n // v.numel()))[:n]
    out[(idx,) * a.dim()] = v
    return out


_reg("insert", insert)
_reg("delete", delete)
_reg("resize_array", resize_array)
_reg("trim_zeros", trim_zeros, differentiable=False)
_reg("flatnonzero", lambda a: torch.nonzero(a.reshape(-1)).reshape(-1),
     differentiable=False)
_reg("argwhere", lambda a: torch.argwhere(a), differentiable=False)
_reg("compress", compress)
_reg("extract", lambda condition, arr:
     arr.reshape(-1)[condition.reshape(-1).to(torch.bool)],
     differentiable=False)
_reg("choose", choose)
_reg("unravel_index", unravel_index, differentiable=False)
_reg("ravel_multi_index", ravel_multi_index, differentiable=False)
_reg("tri", lambda N, M=None, k=0: torch.ones(
    N, N if M is None else M,
    device=current_context().torch_device).tril(k), differentiable=False)
_reg("fill_diagonal", fill_diagonal)

# ---- window functions -----------------------------------------------------

_kaiser = tnp("kaiser")
for _n in ("hamming", "hanning", "blackman", "bartlett"):
    _reg(_n, (lambda f: lambda M: f(M))(tnp(_n)), differentiable=False)
_reg("kaiser", lambda M, beta=14.0: _kaiser(M, beta), differentiable=False)
