"""``mx.np``: the NumPy-compatible front door of MXNet 2.0.

Counterpart of ``mxnet_tpu/numpy/__init__.py``.  The JAX package adapts
``jax.numpy`` wholesale; the port resolves ``mx.np.<name>`` through a
table, first hit wins:

1. the functions defined in this module (``array``, ``zeros``, ``arange``
   ... with MXNet's float32 default, ``copyto``, ``round_``,
   ``row_stack``);
2. ``_OWN``: the port's own torch functions, each with the signature of
   ``jax.numpy``'s: direct torch expressions for the hot element-wise
   ops, ``matmul`` and the common reductions (a call costs a few µs,
   where ``torch._numpy``'s argument normalisation costs tens), and the
   names ``torch._numpy`` lacks or computes otherwise than ``jax.numpy``
   (``interp``, ``polyval``, ``insert``/``delete``, the nan-reductions,
   ``digitize``, ``spacing`` ...; mostly the ops of ``ops/np_tail.py``);
3. ``torch._numpy``, torch's own NumPy layer (torch ops on the inputs'
   device, on torch's tape);
4. host numpy, logged once per name (``fallback_names()``): it runs off
   the device and off the tape.  Of ``jax.numpy``'s functions only
   printing, file I/O, ``poly``/``polyfit``/``polydiv``/``roots``,
   ``packbits``, ``block`` and the helpers that take Python functions
   (``apply_along_axis``, ``vectorize``, ``piecewise``...) land here;
   numpy's types (``bool``, ``dtype``...) are numpy's own, unadapted.

``resolve_source(name)`` says which: ``'torch'`` for 1-3, ``'numpy'`` for
4.  Every adapted call takes and returns ``NDArray``s; numpy arrays among
its arguments move to the call's device (the first NDArray's, else the
current context's), where factories run as well.  Results take the JAX
package's x32 types (float64 -> float32, int64 -> int32).  Inside
``autograd.record()`` a call records on torch's tape (NDArrays nested one
level in list/tuple arguments too); names in ``_NON_DIFF`` never do.
No call takes ``out=``: it raises ``NotImplementedError``, as
``jax.numpy`` does.

Adapted names are cached in ``_adapted_cache``, never set on the module:
module attributes are the globals of the functions here, so a cached
``any``/``all``/``sum``/``round`` would shadow the builtin inside them.
"""
from __future__ import annotations

import contextlib
import logging
import sys
import types

import numpy as _onp
import torch
import torch._numpy as _tnp

from .. import autograd as _ag
from ..base import MXNetError, _as_np_dtype, _as_torch_dtype, _canonical
from ..context import current_context
from ..ndarray.ndarray import NDArray
from ..ops import linalg as _la
from ..ops import np_tail as _tail
from ..ops.registry import get_op as _get_op

ndarray = NDArray

pi = _onp.pi
e = _onp.e
euler_gamma = _onp.euler_gamma
inf = _onp.inf
nan = _onp.nan
newaxis = None

_NON_DIFF = {
    "argmax", "argmin", "argsort", "argwhere", "around", "round", "round_",
    "sign", "floor", "ceil", "trunc", "rint", "fix", "equal", "not_equal",
    "greater", "greater_equal", "less", "less_equal", "isnan", "isinf",
    "isfinite", "logical_and", "logical_or", "logical_not", "logical_xor",
    "nonzero", "unique", "searchsorted", "digitize", "bincount",
}

# names that must not be adapted
_SKIP = {"ndarray", "dtype", "generic"}


def _dims(axis):
    return axis if axis is None or isinstance(axis, int) else tuple(axis)


def _float(a):
    return a if a.is_floating_point() or a.is_complex() else a.to(
        torch.float32)


def _no_out(name, out):
    if out is not None:
        raise NotImplementedError(
            "The 'out' argument to mx.np.%s is not supported." % name)


def _fill_outside(a, where, fill):
    """``a`` with the elements where ``where`` is false set to ``fill``."""
    if where is None:
        return a
    keep = torch.broadcast_to(torch.as_tensor(where, device=a.device).to(
        torch.bool), a.shape)
    return torch.where(keep, a, torch.as_tensor(fill, dtype=a.dtype,
                                                device=a.device))


def _with_initial(out, initial, combine):
    if initial is None:
        return out
    return combine(out, torch.as_tensor(initial, dtype=out.dtype,
                                        device=out.device))


def _reduce(fn, a, axis, keepdims, dtype=None):
    dt = None if dtype is None else _as_torch_dtype(dtype)
    if dt is not None:
        a = a.to(dt)
    if axis is None:
        out = fn(a)
        out = out.reshape((1,) * a.dim()) if keepdims else out
    else:
        out = fn(a, dim=_dims(axis), keepdim=keepdims)
    return out if dt is None else out.to(dt)


def _integral(a):
    return not (a.is_floating_point() or a.is_complex())


def _sum(a, axis=None, dtype=None, out=None, keepdims=False, initial=None,
         where=None, promote_integers=True):
    _no_out("sum", out)
    if (dtype is None and not promote_integers and _integral(a)
            and a.dtype != torch.bool):
        dtype = a.dtype
    return _with_initial(_reduce(torch.sum, _fill_outside(a, where, 0), axis,
                                 keepdims, dtype), initial, torch.add)


def _mean(a, axis=None, dtype=None, out=None, keepdims=False, *,
          where=None):
    _no_out("mean", out)
    a = _float(a) if dtype is None else a.to(_as_torch_dtype(dtype))
    if where is None:
        return _reduce(torch.mean, a, axis, keepdims)
    total = _reduce(torch.sum, _fill_outside(a, where, 0), axis, keepdims)
    count = _reduce(torch.sum, _fill_outside(torch.ones_like(a), where, 0),
                    axis, keepdims)
    return total / count


def _need_initial(name, where, initial):
    if where is not None and initial is None:
        raise ValueError(
            "reduction operation %s does not have an identity, so to use a "
            "where mask one has to specify 'initial'" % name)


def _extreme(name, reduce, combine):
    """``max``/``min`` and their nan versions: ``where`` keeps elements,
    ``initial`` joins the reduction (and is required with ``where``, as
    in numpy)."""

    def call(a, axis=None, out=None, keepdims=False, initial=None,
             where=None):
        _no_out(name, out)
        _need_initial(name.replace("nan", ""), where, initial)
        return _with_initial(reduce(_fill_outside(a, where, initial), axis,
                                    keepdims), initial, combine)

    return call


def _amax(a, axis, keepdims):
    return _reduce(torch.amax, a, axis, keepdims)


def _amin(a, axis, keepdims):
    return _reduce(torch.amin, a, axis, keepdims)


def _nan_total(name, fn, identity, combine):
    """``nansum``/``nanprod``: masked elements count as the identity."""

    def call(a, axis=None, dtype=None, out=None, keepdims=False,
             initial=None, where=None):
        _no_out(name, out)
        dt = None if dtype is None else _as_torch_dtype(dtype)
        a = a if dt is None else a.to(dt)
        r = fn(_fill_outside(a, where, identity), axis, keepdims)
        r = r if dt is None else r.to(dt)
        return _with_initial(r, initial, combine)

    return call


def _nan_input(a, dtype, where):
    """A nan-statistic's input: floating (or ``dtype``), with the elements
    outside ``where`` made NaN so that they drop out."""
    a = _float(a) if dtype is None else a.to(_as_torch_dtype(dtype))
    return _fill_outside(a, where, float("nan"))


def _nanmean(a, axis=None, dtype=None, out=None, keepdims=False,
             where=None):
    _no_out("nanmean", out)
    return _tail.nanmean(_nan_input(a, dtype, where), axis, keepdims)


def _nanvar(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
            where=None, mean=None):
    _no_out("nanvar", out)
    a = _nan_input(a, dtype, where)
    if mean is None:
        return _tail.nanvar(a, axis, ddof, keepdims)
    dims = _tail._axes(a, axis)
    ok = ~torch.isnan(a)
    d = torch.where(ok, a - mean, torch.zeros_like(a))
    cnt = ok.sum(dim=dims, keepdim=keepdims).to(a.dtype)
    return (d * d).sum(dim=dims, keepdim=keepdims) / (cnt - ddof)


def _nanstd(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
            where=None, mean=None):
    _no_out("nanstd", out)
    return torch.sqrt(_nanvar(a, axis, dtype, None, ddof, keepdims, where,
                              mean))


def _tensors(x1, x2):
    """Python scalars beside a tensor as 0-dim tensors on its device (they
    then promote as scalars do)."""
    dev = next((x.device for x in (x1, x2) if isinstance(x, torch.Tensor)),
               None)
    return [x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, device=dev) for x in (x1, x2)]


def _maximum(x1, x2):
    return torch.maximum(*_tensors(x1, x2))


def _minimum(x1, x2):
    return torch.minimum(*_tensors(x1, x2))


def _divide(x1, x2):
    return torch.true_divide(x1, x2)


def _matmul(x1, x2):
    return torch.matmul(x1, x2)


def _unary(fn):
    def call(x):
        return fn(_float(x))

    return call


def _op_fn(name):
    return _get_op(name).fn


def _histogram(a, bins=10, range=None, weights=None, density=None):
    """numpy.histogram written with ``bucketize`` (``torch.histogram``
    has no CUDA kernel); counts as float32, as ``jnp.histogram`` gives
    them."""
    a = _float(a).reshape(-1)
    if isinstance(bins, int):
        lo, hi = (a.min().item(), a.max().item()) if range is None \
            else range
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        edges = torch.linspace(lo, hi, bins + 1, dtype=a.dtype,
                               device=a.device)
    else:
        edges = torch.as_tensor(bins, device=a.device).to(a.dtype)
    n = edges.shape[0] - 1
    idx = torch.bucketize(a, edges, right=True) - 1
    idx = torch.where(a == edges[-1], torch.full_like(idx, n - 1), idx)
    keep = (idx >= 0) & (idx < n)
    w = torch.ones_like(a) if weights is None else \
        weights.reshape(-1).to(a.dtype)
    counts = torch.zeros(n, dtype=a.dtype, device=a.device).index_add(
        0, idx[keep], w[keep])
    if density:
        counts = counts / counts.sum() / torch.diff(edges)
    return counts.to(torch.float32), edges


def _histogram_bin_edges(a, bins=10, range=None, weights=None):
    # the edges do not depend on the weights (numpy's rule)
    return _histogram(a, bins=bins, range=range)[1]


def _nan_fill(a, fill):
    if _integral(a):
        return a                # no NaN to fill (and no room for +-inf)
    return torch.where(torch.isnan(a), torch.full_like(a, fill), a)


def _nanarg(name, fn, fill):
    def call(a, axis=None, out=None, keepdims=None):
        _no_out(name, out)
        a2, ax = _tail._flat_or(a, axis)
        r = fn(_nan_fill(a2, fill), dim=ax, keepdim=bool(keepdims))
        return r.reshape((1,) * a.dim()) if keepdims and axis is None else r

    return call


def _nancum(name, fn, fill):
    def call(a, axis=None, dtype=None, out=None):
        _no_out(name, out)
        a, ax = _tail._flat_or(a, axis)
        dt = a.dtype if dtype is None else _as_torch_dtype(dtype)
        return fn(_nan_fill(a, fill), dim=ax, dtype=dt)

    return call


def _cumulative(fn, identity):
    """``cumulative_sum``/``cumulative_prod`` (the array API's)."""

    def call(x, /, *, axis=None, dtype=None, include_initial=False):
        if axis is None:
            if x.dim() != 1:
                raise ValueError(
                    "The input array has rank %d, however axis was not set "
                    "to an explicit value. The axis argument is only "
                    "optional for one-dimensional arrays." % x.dim())
            axis = 0
        r = fn(x, dim=axis, dtype=None if dtype is None
               else _as_torch_dtype(dtype))
        if include_initial:
            shape = list(r.shape)
            shape[axis] = 1
            r = torch.cat([torch.full(shape, identity, dtype=r.dtype,
                                      device=r.device), r], dim=axis)
        return r

    return call


_QUANTILE_METHODS = ("linear", "lower", "higher", "midpoint", "nearest")


def _quantile_fn(name, nan, scale, fixed_q=None):
    """numpy's quantile family (``torch.quantile``/``nanquantile``, whose
    ``interpolation`` is numpy's ``method``); ``scale`` 100 for the
    percentiles, ``fixed_q`` 0.5 for the medians."""
    fn = torch.nanquantile if nan else torch.quantile

    def compute(a, q, axis, out, overwrite_input, method, keepdims):
        if overwrite_input or out is not None:
            raise ValueError("mx.np.%s does not support overwrite_input=True"
                             " or out != None" % name)
        if method not in _QUANTILE_METHODS:
            raise ValueError("method can only be 'linear', 'lower', "
                             "'higher', 'midpoint', or 'nearest'")
        a = _float(a)
        q = (torch.as_tensor(q, dtype=torch.float64) / scale).to(
            dtype=a.dtype, device=a.device)
        dims = [d % max(a.dim(), 1) for d in _tail._axes(a, axis)]
        rest = [d for d in range(a.dim()) if d not in dims]
        flat = a.permute(rest + list(dims)).reshape(
            [a.shape[d] for d in rest] + [-1])
        if method == "nearest":
            # ties go to the lower neighbour, as in jax.numpy (numpy and
            # torch round the position half to even)
            n = (~torch.isnan(flat)).sum(-1) if nan else torch.full(
                flat.shape[:-1], flat.shape[-1], device=a.device)
            pos = q.reshape(q.shape + (1,) * n.dim()) * (n.to(q.dtype) - 1)
            r = torch.where(pos - torch.floor(pos) <= 0.5,
                            fn(flat, q, dim=-1, interpolation="lower"),
                            fn(flat, q, dim=-1, interpolation="higher"))
        else:
            r = fn(flat, q, dim=-1, interpolation=method)
        if keepdims:
            r = r.reshape(tuple(q.shape) + tuple(
                1 if d in dims else s for d, s in enumerate(a.shape)))
        return r

    if fixed_q is not None:
        def call(a, axis=None, out=None, overwrite_input=False,
                 keepdims=False):
            return compute(a, fixed_q, axis, out, overwrite_input, "linear",
                           keepdims)
    else:
        def call(a, q, axis=None, out=None, overwrite_input=False,
                 method="linear", keepdims=False):
            return compute(a, q, axis, out, overwrite_input, method,
                           keepdims)
    return call


def _unique(a, **kw):
    return torch.unique(a.reshape(-1), sorted=True, **kw)


def _as_tensor_like(x, ref):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, device=ref.device if isinstance(ref, torch.Tensor) else None)


_ISIN_METHODS = ("auto", "compare_all", "binary_search", "sort")


def _isin(element, test_elements, assume_unique=False, invert=False, *,
          method="auto"):
    # ``method`` picks jax's algorithm; every one gives the same answer
    if method not in _ISIN_METHODS:
        raise ValueError("method=%r is not implemented; options are "
                         "'compare_all', 'binary_search', 'sort', and "
                         "'auto'" % (method,))
    element = _as_tensor_like(element, test_elements)
    return torch.isin(element, _as_tensor_like(test_elements, element),
                      assume_unique=assume_unique, invert=invert)


def _no_size(name, size, fill_value):
    if size is not None or fill_value is not None:
        raise NotImplementedError(
            "mx.np.%s: size= and fill_value= (a static output size) are "
            "not supported" % name)


def _first_index(x, values):
    """The index of each of ``values``' first occurrence in 1-D ``x``."""
    order = torch.argsort(x, stable=True)
    return order[torch.searchsorted(x[order], values)]


# ``assume_unique`` only lets numpy skip a step: the answer for unique
# inputs is the same either way
def _intersect1d(ar1, ar2, assume_unique=False, return_indices=False, *,
                 size=None, fill_value=None):
    _no_size("intersect1d", size, fill_value)
    a, b = ar1.reshape(-1), ar2.reshape(-1)
    ua, ub = _unique(a), _unique(b)
    common = ua[torch.isin(ua, ub)]
    if not return_indices:
        return common
    return common, _first_index(a, common), _first_index(b, common)


def _setdiff1d(ar1, ar2, assume_unique=False, *, size=None,
               fill_value=None):
    _no_size("setdiff1d", size, fill_value)
    a = _unique(ar1)
    return a[~torch.isin(a, _unique(ar2))]


def _union1d(ar1, ar2, *, size=None, fill_value=None):
    _no_size("union1d", size, fill_value)
    return _unique(torch.cat([ar1.reshape(-1), ar2.reshape(-1)]))


def _setxor1d(ar1, ar2, assume_unique=False, *, size=None,
              fill_value=None):
    _no_size("setxor1d", size, fill_value)
    a, b = _unique(ar1), _unique(ar2)
    return _unique(torch.cat([a[~torch.isin(a, b)], b[~torch.isin(b, a)]]))


def _lexsort(keys, axis=-1):
    order = None
    for k in keys:                      # the last key sorts first
        if order is None:
            order = torch.argsort(k, dim=axis, stable=True)
        else:
            order = order.gather(axis, torch.argsort(
                k.gather(axis, order), dim=axis, stable=True))
    return order


def _select(condlist, choicelist, default=0):
    out = torch.as_tensor(default, device=choicelist[0].device
                          if isinstance(choicelist[0], torch.Tensor)
                          else None)
    for cond, choice in zip(reversed(list(condlist)),
                            reversed(list(choicelist))):
        out = torch.where(cond.to(torch.bool), choice, out)
    return out


def _choose(a, choices, out=None, mode="raise"):
    _no_out("choose", out)
    n = len(choices)
    if mode == "raise":
        if bool(((a < 0) | (a >= n)).any()):
            raise ValueError("invalid entry in choice array")
    elif mode == "wrap":
        a = torch.remainder(a, n)
    elif mode != "clip":
        raise ValueError("mode=%r not understood. Must be 'raise', 'wrap', "
                         "or 'clip'" % (mode,))
    return _tail.choose(a, *choices)


def _ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    dims = tuple(int(d) for d in dims)
    idx = [_as_tensor_like(m, multi_index[0]).long() for m in multi_index]
    if mode == "raise":
        if any(bool(((i < 0) | (i >= d)).any()) for i, d in zip(idx, dims)):
            raise ValueError("invalid entry in coordinates array")
    elif mode == "wrap":
        idx = [torch.remainder(i, d) for i, d in zip(idx, dims)]
    elif mode != "clip":             # clip: the op clamps
        raise ValueError("invalid mode=%r. Expected 'raise', 'wrap', or "
                         "'clip'" % (mode,))
    if order == "F":
        idx, dims = idx[::-1], dims[::-1]
    elif order != "C":
        raise ValueError("invalid order=%r. Expected 'C' or 'F'" % (order,))
    return _tail.ravel_multi_index(torch.stack(torch.broadcast_tensors(
        *idx)), dims)


def _fill_diagonal(a, val, wrap=False, *, inplace=True):
    if inplace:
        raise NotImplementedError(
            "mx.np.fill_diagonal returns a new array: use inplace=False")
    if wrap:
        raise NotImplementedError("wrap=True is not implemented, must use "
                                  "wrap=False")
    return _tail.fill_diagonal(a, val)


def _polyadd(a1, a2):
    n = max(a1.shape[0], a2.shape[0])
    pad = [torch.nn.functional.pad(a, (n - a.shape[0], 0)) for a in (a1, a2)]
    return pad[0] + pad[1]


def _polymul(a1, a2):
    k = a2.flip(0).reshape(1, 1, -1).to(torch.promote_types(a1.dtype,
                                                             a2.dtype))
    x = a1.to(k.dtype).reshape(1, 1, -1)
    return torch.nn.functional.conv1d(x, k, padding=a2.shape[0] - 1)[0, 0]


def _polyder(p, m=1):
    p = _float(p)               # jnp.polyder promotes integers
    for _ in range(m):
        n = p.shape[0] - 1
        p = p[:-1] * torch.arange(n, 0, -1, device=p.device, dtype=p.dtype)
    return p


def _polyint(p, m=1, k=None):
    """numpy.polyint: the ``i``-th integration adds the constant
    ``k[i]`` (a scalar ``k`` serves every one)."""
    p = _float(p)
    k = torch.zeros(m, dtype=p.dtype, device=p.device) if k is None else \
        torch.as_tensor(k, dtype=p.dtype, device=p.device).reshape(-1)
    if k.numel() == 1 and m > 1:
        k = k.expand(m)
    if m and k.numel() != m:
        raise ValueError("k must be a scalar or a rank-1 array of length 1 "
                         "or m.")
    for i in range(m):
        n = p.shape[0]
        p = torch.cat([p / torch.arange(n, 0, -1, device=p.device,
                                        dtype=p.dtype), k[i:i + 1]])
    return p


def _astype(x, dtype, /, *, copy=False):
    return x.to(_as_torch_dtype(dtype), copy=copy)


# numpy's newer (array API) spellings and the other names jax.numpy has
_ALIASES = {"acos": "arccos", "acosh": "arccosh", "asin": "arcsin",
            "asinh": "arcsinh", "atan": "arctan", "atan2": "arctan2",
            "atanh": "arctanh", "pow": "power", "concat": "concatenate",
            "permute_dims": "transpose", "bitwise_invert": "bitwise_not"}


def _unravel_index(indices, shape):
    return tuple(_tail.unravel_index(indices, shape))


def _np_eigh(a, UPLO=None, symmetrize_input=True):
    if symmetrize_input:
        a = (a + a.mH) / 2
    return _la._eigh(a, "L" if UPLO is None else UPLO)


def _np_eigvalsh(a, UPLO="L", *, symmetrize_input=True):
    if symmetrize_input:
        a = (a + a.mH) / 2
    return _la._eigh(a, UPLO, eigenvectors=False)


def _np_svd(a, full_matrices=True, compute_uv=True, hermitian=False,
            subset_by_index=None):
    if hermitian or subset_by_index is not None:
        raise NotImplementedError("mx.np.linalg.svd: hermitian= and "
                                  "subset_by_index= are not supported")
    a = _float(a)
    return _la._svd(a, full_matrices) if compute_uv else _la._svdvals(a)


def _np_pinv(a, rtol=None, hermitian=False, *, rcond=None):
    if rcond is not None:
        if rtol is not None:
            raise ValueError("pinv: only one of rtol and rcond may be "
                             "specified.")
        rtol = rcond
    if hermitian:
        raise NotImplementedError("mx.np.linalg.pinv: hermitian=True is "
                                  "not supported")
    return _la.linalg_pinv(_float(a), rcond=rtol)


def _np_matrix_rank(M, rtol=None, *, tol=None):
    if tol is not None:
        if rtol is not None:
            raise ValueError("matrix_rank: only one of tol or rtol may be "
                             "specified.")
        rtol = tol
    M = _float(M)
    if M.dim() < 2:
        return (M != 0).any().to(torch.int32)
    s = _la._svdvals(M)
    # as in jax.numpy: a given ``rtol`` is the cutoff itself
    cut = s.amax(-1) * max(M.shape[-2:]) * torch.finfo(s.dtype).eps \
        if rtol is None else torch.as_tensor(rtol, dtype=s.dtype,
                                              device=s.device)
    return (s > cut[..., None]).sum(-1)


def _np_cond(x, p=None):
    if x.dim() < 2:
        raise ValueError("jnp.linalg.cond: input array must be at least 2D;"
                         " got arr.shape=%s" % (tuple(x.shape),))
    return _la.linalg_cond(_float(x), p)


# the port's own functions of the submodules: ``jax.numpy.linalg``'s
# signatures, the decompositions of ``ops/linalg.py`` (float32 on the card
# decomposes in float64, as ``nd.linalg`` does), and ``eigh`` symmetrizes
# its input as ``jax.numpy``'s does
_OWN_SUB = {"linalg": {
    "eigh": _np_eigh, "eigvalsh": _np_eigvalsh, "svd": _np_svd,
    "svdvals": lambda x, /: _la._svdvals(_float(x)), "pinv": _np_pinv,
    "matrix_rank": _np_matrix_rank, "cond": _np_cond,
    "norm": lambda x, ord=None, axis=None, keepdims=False: _la.linalg_norm(
        _float(x), ord, axis, keepdims)}}


def _floats(x1, x2):
    """Both operands as tensors (a Python scalar becomes a 0-dim one) with
    integers promoted to float32, as ``jax.numpy`` promotes them."""
    return [_float(x) for x in _tensors(x1, x2)]


def _binary_float(name, fn):
    def call(x1, x2, /, out=None, where=None):
        _no_out(name, out)
        if where is not None:
            raise NotImplementedError(
                "The 'where' argument to mx.np.%s is not supported." % name)
        return fn(*_floats(x1, x2))

    return call


def _modf(x, /, out=None):
    _no_out("modf", out)
    x = _float(x)
    whole = torch.trunc(x)      # numpy's split, toward zero
    return x - whole, whole


def _frexp(x, /):
    m, e = torch.frexp(_float(x))
    return m, e.to(torch.int32)


def _heaviside(x1, x2, /):
    x1, x2 = _floats(x1, x2)
    dt = torch.promote_types(x1.dtype, x2.dtype)
    x1, x2 = x1.to(dt), x2.to(dt)
    return torch.where(x1 < 0, torch.zeros_like(x1),
                       torch.where(x1 > 0, torch.ones_like(x1), x2))


def _clip(arr=None, /, min=None, max=None, *, a=None, a_min=None,
          a_max=None):
    """``jnp.clip`` (``a``, ``a_min``, ``a_max`` are its deprecated
    spellings)."""
    arr = a if arr is None else arr
    lo = a_min if min is None else min
    hi = a_max if max is None else max
    return _op_fn("clip")(arr, lo, hi)


def _full_like(a, fill_value, dtype=None, shape=None, *, device=None):
    if device is not None:
        raise NotImplementedError("mx.np.full_like(device=...): pass ctx "
                                  "through the input array")
    dt = a.dtype if dtype is None else _as_torch_dtype(dtype)
    shape = tuple(a.shape) if shape is None else (
        (shape,) if isinstance(shape, int) else tuple(shape))
    fill = torch.as_tensor(fill_value, device=a.device).to(dt)
    return torch.broadcast_to(fill, shape).clone()


def _take_along_axis(arr, indices, axis=-1, mode=None, fill_value=None):
    if mode is not None or fill_value is not None:
        raise NotImplementedError("mx.np.take_along_axis takes no mode or "
                                  "fill_value")
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    n = arr.shape[axis]
    idx = indices.long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    out = torch.take_along_dim(arr, torch.where(ok, idx, 0), dim=axis)
    # jnp's default mode "fill": an index out of range reads NaN, or the
    # least value of a signed integer type (the greatest of an unsigned)
    if out.is_floating_point() or out.is_complex():
        fill = float("nan")
    elif out.dtype == torch.bool:
        fill = True
    else:
        info = torch.iinfo(out.dtype)
        fill = info.min if info.min < 0 else info.max
    return torch.where(ok, out, torch.full_like(out, fill))


def _tri_indices_from(fn):
    def call(arr, k=0):
        rows, cols = arr.shape[-2], arr.shape[-1]
        ij = fn(rows, cols, k, device=arr.device, dtype=torch.int32)
        return ij[0], ij[1]

    return call


def _unique_all(x, /, *, size=None, fill_value=None):
    """(values, first indices, inverse indices, counts), as
    ``jnp.unique_all`` returns them."""
    _no_size("unique_all", size, fill_value)
    flat = x.reshape(-1)
    values, inverse, counts = torch.unique(
        flat, sorted=True, return_inverse=True, return_counts=True)
    pos = torch.arange(flat.numel(), device=flat.device)
    first = torch.full((values.numel(),), flat.numel(), dtype=pos.dtype,
                       device=flat.device).scatter_reduce(
        0, inverse, pos, reduce="amin")
    return values, first, inverse.reshape(x.shape), counts


# 2. the port's own torch functions: the hot element-wise ops, ``matmul``
# and the common reductions as direct torch expressions (a call costs a
# few µs, where ``torch._numpy``'s argument normalisation costs tens), and
# the names ``torch._numpy`` lacks or computes otherwise than
# ``jax.numpy``.  Each takes the arguments of ``jax.numpy``'s function of
# its name and implements them, or raises on a value it does not take.
_OWN = {
    "add": torch.add, "subtract": torch.subtract,
    "multiply": torch.multiply, "divide": _divide, "true_divide": _divide,
    "negative": torch.negative, "maximum": _maximum,
    "minimum": _minimum, "matmul": _matmul,
    "exp": _unary(torch.exp), "log": _unary(torch.log),
    "sqrt": _unary(torch.sqrt), "tanh": _unary(torch.tanh),
    "sin": _unary(torch.sin), "cos": _unary(torch.cos),
    "square": torch.square, "abs": torch.abs, "absolute": torch.abs,
    "sum": _sum, "mean": _mean,
    "max": _extreme("max", _amax, torch.maximum),
    "amax": _extreme("max", _amax, torch.maximum),
    "min": _extreme("min", _amin, torch.minimum),
    "amin": _extreme("min", _amin, torch.minimum),
    "percentile": _quantile_fn("percentile", False, 100.0),
    "quantile": _quantile_fn("quantile", False, 1.0),
    "median": _quantile_fn("median", False, 1.0, 0.5),
    "nanpercentile": _quantile_fn("nanpercentile", True, 100.0),
    "nanquantile": _quantile_fn("nanquantile", True, 1.0),
    "nanmedian": _quantile_fn("nanmedian", True, 1.0, 0.5),
    "histogram": _histogram, "histogram_bin_edges": _histogram_bin_edges,
    "interp": _tail.interp, "polyval": _tail.polyval,
    "spacing": _tail.spacing, "ediff1d": _tail.ediff1d,
    "insert": _tail.insert, "delete": _tail.delete,
    "compress": _tail.compress, "digitize": _tail.digitize,
    "unravel_index": _unravel_index,
    "nanmax": _extreme("nanmax", _tail.nanmax, torch.fmax),
    "nanmin": _extreme("nanmin", _tail.nanmin, torch.fmin),
    "nansum": _nan_total("nansum", _tail.nansum, 0, torch.add),
    "nanprod": _nan_total("nanprod", _tail.nanprod, 1, torch.multiply),
    "nanmean": _nanmean, "nanstd": _nanstd, "nanvar": _nanvar,
    "extract": _op_fn("extract"), "trapz": _op_fn("trapz"),
    "trapezoid": _op_fn("trapz"), "unwrap": _tail.unwrap_phase,
    "resize": _tail.resize_array, "trim_zeros": _tail.trim_zeros,
    "choose": _choose, "fill_diagonal": _fill_diagonal,
    "rollaxis": _tail.rollaxis,
    "bitwise_left_shift": torch.bitwise_left_shift,
    "bitwise_right_shift": torch.bitwise_right_shift,
    "matrix_transpose": lambda x, /: x.transpose(-1, -2),
    "astype": _astype, "frexp": _frexp, "isin": _isin,
    "nanargmax": _nanarg("nanargmax", torch.argmax, float("-inf")),
    "nanargmin": _nanarg("nanargmin", torch.argmin, float("inf")),
    "nancumsum": _nancum("nancumsum", torch.cumsum, 0.0),
    "nancumprod": _nancum("nancumprod", torch.cumprod, 1.0),
    "unique_values": lambda x, /: _unique(x),
    "unique_counts": lambda x, /: _unique(x, return_counts=True),
    "unique_inverse": lambda x, /: (lambda v, i: (v, i.reshape(x.shape)))(
        *_unique(x, return_inverse=True)),
    "intersect1d": _intersect1d, "setdiff1d": _setdiff1d,
    "union1d": _union1d, "setxor1d": _setxor1d,
    # a full sort is one of numpy's valid partitions
    "partition": lambda a, kth, axis=-1: torch.sort(a, dim=axis)[0],
    "argpartition": lambda a, kth, axis=-1: torch.argsort(a, dim=axis),
    "lexsort": _lexsort, "select": _select,
    "vecdot": lambda x1, x2, /, *, axis=-1: (x1.conj() * x2).sum(axis),
    "polyadd": _polyadd, "polysub": lambda a1, a2: _polyadd(a1, -a2),
    "polymul": _polymul, "polyder": _polyder, "polyint": _polyint,
    "ravel_multi_index": _ravel_multi_index,
    "unstack": lambda x, /, *, axis=0: torch.unbind(x, dim=axis),
    "cumulative_sum": _cumulative(torch.cumsum, 0),
    "cumulative_prod": _cumulative(torch.cumprod, 1),
    "matvec": lambda x1, x2, /: torch.matmul(
        x1, x2.unsqueeze(-1)).squeeze(-1),
    "vecmat": lambda x1, x2, /: torch.matmul(x1.conj().unsqueeze(-2),
                                             x2).squeeze(-2),
    # where ``torch._numpy`` answers otherwise than ``jax.numpy``: a NaN
    # cube root of a negative, a floor split in modf, integer results
    # where JAX promotes (or promoted ones where it keeps integers),
    # integer inputs refused, 1-D outer only, a Number-only fill
    "cbrt": lambda x, /: _op_fn("cbrt")(x), "modf": _modf,
    "fabs": lambda x, /: torch.abs(_float(x)),
    "rint": lambda x, /: torch.round(_float(x)),
    "trunc": lambda x: _op_fn("trunc")(x), "heaviside": _heaviside,
    "hypot": _binary_float("hypot", torch.hypot),
    "logaddexp": _binary_float("logaddexp", torch.logaddexp),
    "logaddexp2": _binary_float("logaddexp2", torch.logaddexp2),
    "nextafter": lambda x, y, /: torch.nextafter(*_floats(x, y)),
    "outer": lambda a, b, out=None: (_no_out("outer", out),
                                     _op_fn("outer")(a, b))[1],
    "full_like": _full_like, "clip": _clip,
    "take_along_axis": _take_along_axis,
    "tril_indices_from": _tri_indices_from(torch.tril_indices),
    "triu_indices_from": _tri_indices_from(torch.triu_indices),
    "unique_all": _unique_all,
}
# names of ``_OWN`` whose functions make no tensor of their own, so their
# calls skip the ``torch.device`` scope (µs a call on the hot path)
_UNSCOPED = frozenset((
    "add", "subtract", "multiply", "divide", "true_divide", "negative",
    "maximum", "minimum", "matmul", "exp", "log", "sqrt", "tanh", "sin",
    "cos", "square", "abs", "absolute", "sum", "mean", "max", "amax", "min",
    "amin"))


def _device_of(datas):
    for d in datas:
        if isinstance(d, torch.Tensor):
            return d.device
    return current_context().torch_device


def _from_host(v, dev):
    """A numpy array argument as a tensor on ``dev`` (x32 types)."""
    if isinstance(v, _onp.ndarray):
        return _canonical(torch.from_numpy(_onp.array(v)).to(dev))
    return v


def _wrap_out(out):
    if isinstance(out, _tnp.ndarray):
        out = out.tensor
    if isinstance(out, torch.Tensor):
        return NDArray(_canonical(out))
    if isinstance(out, (list, tuple)):
        return type(out)(_wrap_out(o) for o in out)
    return out


class _Seq:
    """Marker for a positional list/tuple argument holding NDArrays."""

    __slots__ = ("container", "items")

    def __init__(self, container, items):
        self.container = container
        self.items = items


def _adapt(name, fn, factory=False):
    """``fn`` (on tensors) as an ``mx.np`` function on NDArrays.
    ``factory``: run it under the call's device (``torch._numpy`` makes
    its own tensors on the default device)."""

    def wrapped(*args, **kwargs):
        _no_out(name, kwargs.get("out"))
        nd_args, positions, plain_args = [], [], []
        for i, a in enumerate(args):
            if isinstance(a, NDArray):
                positions.append((i, None))
                nd_args.append(a)
                plain_args.append(None)
            elif isinstance(a, (list, tuple)) and any(
                    isinstance(v, NDArray) for v in a):
                sub = []
                for j, v in enumerate(a):
                    if isinstance(v, NDArray):
                        positions.append((i, j))
                        nd_args.append(v)
                        sub.append(None)
                    else:
                        sub.append(v)
                plain_args.append(_Seq(type(a), sub))
            else:
                plain_args.append(a)
        datas = [a._data for a in nd_args]
        kw_datas = {k: v._data for k, v in kwargs.items()
                    if isinstance(v, NDArray)}
        dev = _device_of(datas + list(kw_datas.values()))

        def host(v):
            if isinstance(v, (list, tuple)):
                return type(v)(host(x) for x in v)
            return _from_host(v, dev)

        kw = {k: kw_datas.get(k, host(v)) for k, v in kwargs.items()}
        merged = [list(host(p.items)) if isinstance(p, _Seq) else host(p)
                  for p in plain_args]
        for (i, j), d in zip(positions, datas):
            if j is None:
                merged[i] = d
            else:
                merged[i][j] = d
        final = [orig.container(m) if isinstance(orig, _Seq) else m
                 for orig, m in zip(plain_args, merged)]
        record = (name not in _NON_DIFF and _ag.is_recording())
        grads = torch.is_grad_enabled() and any(
            d.requires_grad for d in datas + list(kw_datas.values()))
        with torch.device(dev) if factory else contextlib.nullcontext(), \
                torch.no_grad() if grads and not record else \
                contextlib.nullcontext():
            out = fn(*final, **kw)
        return _wrap_out(out)

    wrapped.__name__ = name
    wrapped.__qualname__ = name
    wrapped.__doc__ = getattr(fn, "__doc__", None)
    return wrapped


_adapted_cache = {}

# host-numpy fallbacks: announced once per name (off with
# MXNET_NP_FALLBACK_LOG_VERBOSE=0), listed by fallback_names()
_fallback_seen = set()


def _log_np_fallback(name):
    if name in _fallback_seen:
        return
    _fallback_seen.add(name)
    from ..base import get_env

    if get_env("MXNET_NP_FALLBACK_LOG_VERBOSE", bool, True):
        logging.getLogger("mxnet_tpu_torch").warning(
            "mx.np.%s has no torch implementation; falling back to host "
            "numpy (runs off-device and outside autograd)", name)


def fallback_names():
    """Names this process resolved through the host-numpy fallback."""
    return sorted(_fallback_seen)


def _target(name):
    """(source, object) for ``mx.np.<name>``; AttributeError if none."""
    module = sys.modules[__name__]
    if name in module.__dict__ and not name.startswith("_"):
        return "torch", module.__dict__[name]
    if name in _OWN:
        return "torch", _OWN[name]
    name = _ALIASES.get(name, name)
    obj = getattr(_tnp, name, None)
    if obj is not None and name not in _SKIP:
        return "torch", obj
    obj = getattr(_onp, name, None)
    if obj is not None:
        return "numpy", obj
    raise AttributeError("mx.np has no attribute %r" % name)


def resolve_source(name):
    """Where ``mx.np.<name>`` resolves: ``'torch'`` (on the device) or
    ``'numpy'`` (the host fallback).  AttributeError for unknown names."""
    return _target(name)[0]


def _host_adapt(name, fn):
    """A host-numpy function on NDArrays: arguments read back, the
    results placed on the current context."""

    def wrapped(*args, **kwargs):
        def host(v):
            if isinstance(v, NDArray):
                return v.asnumpy()
            if isinstance(v, (list, tuple)):
                return type(v)(host(x) for x in v)
            return v

        out = fn(*host(args), **{k: host(v) for k, v in kwargs.items()})
        return _place(out)

    wrapped.__name__ = name
    return wrapped


def _place(out):
    if isinstance(out, _onp.ndarray):
        return array(out, dtype=out.dtype if out.dtype.kind not in "fc"
                     else None)
    if isinstance(out, (list, tuple)):
        return type(out)(_place(o) for o in out)
    return out


class _NPModule(types.ModuleType):
    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        cached = _adapted_cache.get(name)
        if cached is not None:
            return cached
        source, target = _target(name)
        if isinstance(target, types.ModuleType):
            out = _SubModule("%s.%s" % (__name__, name), target,
                             _OWN_SUB.get(name, {}))
        elif source == "numpy" and callable(target) and not isinstance(
                target, type):
            _log_np_fallback(name)
            out = _host_adapt(name, target)
        elif callable(target) and not isinstance(target, type):
            out = _adapt(name, target, factory=name not in _UNSCOPED)
        else:
            out = target
        _adapted_cache[name] = out
        return out


class _SubModule(types.ModuleType):
    """An adapted ``torch._numpy`` submodule (``linalg``, ``fft``); names
    in ``own`` resolve to the port's functions first."""

    def __init__(self, name, target, own):
        super().__init__(name)
        self._target = target
        self._own = own
        self._cache = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        cached = self.__dict__["_cache"].get(name)
        if cached is not None:
            return cached
        obj = self.__dict__["_own"].get(name) or getattr(self._target, name)
        if callable(obj):
            obj = _adapt(name, obj, factory=True)
        self.__dict__["_cache"][name] = obj
        return obj


# ---- aliases numpy 2.x dropped but the reference surface still exports ---

def round_(*args, **kwargs):
    return sys.modules[__name__].round(*args, **kwargs)


def row_stack(*args, **kwargs):
    return sys.modules[__name__].vstack(*args, **kwargs)


def copyto(dst, src, casting="same_kind", where=True):
    """numpy.copyto on NDArrays: write ``src`` into ``dst`` on its device.
    ``casting`` is checked with numpy's rule table; ``src`` broadcasts to
    ``dst``."""
    if not isinstance(dst, NDArray):
        raise MXNetError("mx.np.copyto: dst must be an NDArray")
    module = sys.modules[__name__]
    src_dtype = getattr(src, "dtype", None)
    if src_dtype is None:
        src_dtype = _onp.asarray(src).dtype
    if not _onp.can_cast(src_dtype, _as_np_dtype(dst.dtype), casting):
        raise MXNetError(
            "mx.np.copyto: cannot cast %s to %s under rule %r"
            % (src_dtype, dst.dtype, casting))
    src_nd = src if isinstance(src, NDArray) else \
        array(src, dtype=dst.dtype, ctx=dst.context)
    if str(src_nd.dtype) != str(dst.dtype):
        # cast before any where-merge: a promoted merge dtype would
        # round-trip the untouched (where=False) dst elements
        src_nd = src_nd.astype(dst.dtype)
    if tuple(src_nd.shape) != tuple(dst.shape):
        src_nd = module.broadcast_to(src_nd, tuple(dst.shape))
    if where is True:
        src_nd.copyto(dst)
        return
    module.where(where, src_nd, dst).copyto(dst)


# ---- creation / conversion with MXNet's defaults --------------------------

def _ctx(ctx, device):
    return ctx or device or current_context()


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(obj, dtype=None, ctx=None, device=None):
    """A new array holding a copy of ``obj`` on ``ctx`` (float64 data
    becomes float32 and int64 data int32 unless ``dtype`` says)."""
    from .. import ndarray as nd

    return nd.array(obj, ctx=_ctx(ctx, device), dtype=dtype)


def zeros(shape, dtype="float32", ctx=None, device=None, order="C"):
    c = _ctx(ctx, device)
    return NDArray(torch.zeros(_shape(shape), dtype=_as_torch_dtype(
        dtype or "float32"), device=c.torch_device))


def ones(shape, dtype="float32", ctx=None, device=None, order="C"):
    c = _ctx(ctx, device)
    return NDArray(torch.ones(_shape(shape), dtype=_as_torch_dtype(
        dtype or "float32"), device=c.torch_device))


def full(shape, fill_value, dtype=None, ctx=None, device=None):
    c = _ctx(ctx, device)
    if dtype is None:
        fill = torch.as_tensor(fill_value)
        dt = _canonical(fill).dtype
        if dt == torch.float64:
            dt = torch.float32
    else:
        dt = _as_torch_dtype(dtype)
    return NDArray(torch.full(_shape(shape), fill_value, dtype=dt,
                              device=c.torch_device))


def empty(shape, dtype="float32", ctx=None, device=None):
    return zeros(shape, dtype, ctx, device)


def arange(start, stop=None, step=1, dtype=None, ctx=None, device=None):
    c = _ctx(ctx, device)
    if stop is None:
        start, stop = 0, start
    out = _tnp.arange(start, stop, step).tensor
    if dtype is not None:
        out = out.to(_as_torch_dtype(dtype))
    return NDArray(_canonical(out).to(c.torch_device))


def eye(N, M=None, k=0, dtype="float32", ctx=None, device=None):
    c = _ctx(ctx, device)
    M = N if M is None else M
    out = torch.ones(N, M, dtype=_as_torch_dtype(dtype),
                     device=c.torch_device)
    return NDArray(out.tril(k).triu(k))


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None, device=None):
    c = _ctx(ctx, device)
    out = _tnp.linspace(start, stop, num, endpoint=endpoint,
                        retstep=retstep, axis=axis)
    data = out[0] if retstep else out
    t = data.tensor.to(_as_torch_dtype(dtype) if dtype else torch.float32)
    arr = NDArray(t.to(c.torch_device))
    return (arr, float(out[1])) if retstep else arr


# install the auto-adapting module class
_mod = sys.modules[__name__]
_mod.__class__ = _NPModule

from .. import random  # noqa: E402,F401  (mx.np.random is mx.random)
