"""NDArray: the imperative tensor handle of ``mx.nd``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  An ``NDArray`` wraps
exactly one ``torch.Tensor`` (``_data``), as the JAX one wraps one
``jax.Array``.  It is not a ``torch.Tensor`` subclass: MXNet's ``size``
(an int), ``dtype`` (a numpy dtype), ``reshape`` (code 0 copies a
dimension), ``sum(axis=)``, ``grad`` (an NDArray), ``T`` and ``detach``
mean other things than a tensor's members of the same names.

It keeps the JAX package's value semantics: an op returns a new array, and
``x[key] = v`` gives ``x`` a new tensor with the write made (never a write
into storage another NDArray may share).  ``wait_to_read`` waits for the
card's current stream.  Arithmetic, comparison and indexing go through the
op registry (``ops/registry.py``), so they record inside
``autograd.record()`` like any op.  Gradients: ``attach_grad`` makes
``_data`` a torch leaf with a zero gradient buffer, and ``grad`` is an
NDArray over the leaf's gradient.
"""
from __future__ import annotations

import torch

from .. import autograd as _ag
from ..base import MXNetError, _as_np_dtype, _as_torch_dtype, _bfloat16
from ..context import Context
from ..ops import registry as _reg

__all__ = ["NDArray", "waitall", "from_torch", "concatenate"]


def _op(name):
    return _reg._OP_REGISTRY[name]


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        bf16 = _bfloat16()
        if bf16 is None:
            return t.float().cpu().numpy()
        return t.view(torch.int16).cpu().numpy().view(bf16)
    arr = t.cpu().numpy()
    return arr.copy() if t.device.type == "cpu" else arr


class NDArray:
    """An n-dimensional array on a device: one ``torch.Tensor``."""

    __slots__ = ("_data", "__weakref__")
    __array_priority__ = 100.0

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        if ctx is not None:
            data = ctx.place(data)
        self._data = data

    # ---- basic properties -------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype (``torch.bfloat16`` itself for bfloat16 where
        ``ml_dtypes`` is not installed)."""
        dt = self._data.dtype
        if dt == torch.bfloat16 and _bfloat16() is None:
            return dt
        return _as_np_dtype(dt)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return Context.of(self._data)

    ctx = context
    device = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return self.transpose()

    @property
    def grad(self):
        """The gradient buffer of an ``attach_grad``'d array (None
        otherwise): one NDArray handle, brought up to date on read."""
        t = self._data
        if getattr(t, "grad_req", None) is None:
            return None
        handle = getattr(t, "_mx_grad", None)
        if handle is None:
            handle = t._mx_grad = NDArray(t.grad)
        elif t.grad is not None:
            handle._data = t.grad
        return handle

    # ---- sync / transfer --------------------------------------------------
    def wait_to_read(self):
        """Wait until the pending work on this array's card is done."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self):
        return _to_numpy(self._data)

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self._data.detach().reshape(()).item()

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __index__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def tolist(self):
        return self.asnumpy().tolist()

    def as_in_context(self, ctx):
        if ctx == self.context:
            return self
        return NDArray(self._data, ctx=ctx)

    as_in_ctx = as_in_context
    to_device = as_in_context

    def as_nd_ndarray(self):
        return self

    def copyto(self, other):
        """A copy on context ``other``, or written into NDArray ``other``
        (its shape, dtype and device kept)."""
        if isinstance(other, Context):
            return NDArray(other.place(self._data.detach(), copy=True))
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto shape mismatch %s vs %s"
                                 % (self.shape, other.shape))
            other._assign(self._data.detach().to(
                other._data.device, other._data.dtype, copy=True))
            return other
        raise TypeError("copyto: unsupported target %r" % (other,))

    def copy(self):
        return _reg.apply_op(torch.clone, self)

    def astype(self, dtype, copy=True):
        if not copy and self._data.dtype == _as_torch_dtype(dtype):
            return self
        return _op("cast")(self, dtype=dtype)

    def detach(self):
        return NDArray(self._data.detach())

    def _assign(self, new):
        """Give this handle the tensor ``new``; an attached leaf stays a
        leaf, with its gradient buffer and grad_req."""
        old = self._data
        req = getattr(old, "grad_req", None)
        if req is not None and old.is_leaf:
            new = _ag._make_leaf(new, req, old.grad)
            if hasattr(old, "_mx_grad"):
                new._mx_grad = old._mx_grad
                _ag._HANDLED[id(new)] = new
        self._data = new

    # ---- autograd ---------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a leaf with a zero gradient buffer."""
        self._data = _ag._make_leaf(self._data, grad_req)

    def zero_grad(self):
        if getattr(self._data, "grad_req", None) is not None:
            self._data.grad = torch.zeros_like(self._data)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _ag.backward([self], None if out_grad is None else [out_grad],
                     retain_graph=retain_graph)

    # ---- indexing ---------------------------------------------------------
    def __getitem__(self, key):
        key, flips = _clean_key(key, self.shape)

        def getitem(x):
            out = x[key]
            return out.flip(flips) if flips else out

        return _reg.apply_op(getitem, self)

    def __setitem__(self, key, value):
        if _ag.is_recording() and self._data.requires_grad:
            raise MXNetError("in-place write to an array on the autograd tape "
                             "inside record() is not supported; use pause()")
        key, flips = _clean_key(key, self.shape)
        if isinstance(value, NDArray):
            value = value._data
        with torch.no_grad():
            new = self._data.detach().clone()
            if flips:
                if not isinstance(value, torch.Tensor):
                    value = torch.as_tensor(value, dtype=new.dtype)
                value = value.to(new.device).expand(new[key].shape).flip(
                    flips)
            elif isinstance(value, torch.Tensor):
                value = value.to(new.device)
            new[key] = value
        self._assign(new)

    def slice(self, begin, end, step=None):
        key = tuple(slice(b, e, s) for b, e, s in
                    zip(begin, end, step or [None] * len(begin)))
        return self[key]

    def take(self, indices, axis=0):
        return _op("take")(self, indices, axis=axis)

    # ---- shape manipulation ----------------------------------------------
    def reshape(self, *shape, **kwargs):
        """Reshape; in ``shape`` a 0 copies that dimension of this array
        and -1 is inferred.  MXNet's other codes (-2, -3, -4) raise, as
        in the JAX package."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        out = []
        for i, s in enumerate(shape):
            s = int(s)
            if s < -1:
                raise MXNetError("reshape: code %d is not supported" % s)
            out.append(self.shape[i] if s == 0 else s)
        out = tuple(out)

        def reshape(x):
            return x.reshape(out)

        return _reg.apply_op(reshape, self)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def expand_dims(self, axis):
        return _op("expand_dims")(self, axis=axis)

    def squeeze(self, axis=None):
        return _op("squeeze")(self, axis=axis)

    def flatten(self):
        return self.reshape((self.shape[0], -1)) if self.ndim > 1 else self

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _op("transpose")(self, axes=axes if axes else None)

    def swapaxes(self, dim1, dim2):
        return _op("swapaxes")(self, dim1, dim2)

    def broadcast_to(self, shape):
        return _op("broadcast_to")(self, shape=shape)

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def tile(self, reps):
        return _op("tile")(self, reps=reps)

    def repeat(self, repeats, axis=None):
        return _op("repeat")(self, repeats=repeats, axis=axis)

    def pad(self, pad_width, mode="constant", constant_value=0):
        return _op("pad")(self, pad_width, mode=mode,
                          constant_value=constant_value)

    def split(self, num_outputs, axis=0):
        return _op("split")(self, num_outputs=num_outputs, axis=axis)

    # ---- reductions / math methods ---------------------------------------
    def sum(self, axis=None, keepdims=False, **kw):
        return _op("sum")(self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False, **kw):
        return _op("mean")(self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False, **kw):
        return _op("max")(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False, **kw):
        return _op("min")(self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False, **kw):
        return _op("prod")(self, axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _op("norm")(self, ord=ord, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return _op("argmax")(self, axis=axis)

    def argmin(self, axis=None, keepdims=False):
        return _op("argmin")(self, axis=axis)

    def clip(self, a_min=None, a_max=None):
        return _op("clip")(self, a_min, a_max)

    def softmax(self, axis=-1):
        return _op("softmax")(self, axis=axis)

    def log_softmax(self, axis=-1):
        return _op("log_softmax")(self, axis=axis)

    def dot(self, other):
        return _op("dot")(self, other)

    def topk(self, k=1, axis=-1, ret_typ="indices", is_ascend=False):
        return _op("topk")(self, k=k, axis=axis, ret_typ=ret_typ,
                           is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return _op("sort")(self, axis=axis, is_ascend=is_ascend)

    def argsort(self, axis=-1, is_ascend=True):
        return _op("argsort")(self, axis=axis, is_ascend=is_ascend)

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return _op("one_hot")(self, depth, on_value=on_value,
                              off_value=off_value)

    def tostype(self, stype):
        """This array in ``stype`` storage (``'default'``: itself;
        ``'row_sparse'``/``'csr'``: ``nd.sparse.cast_storage``)."""
        if stype == "default":
            return self
        from . import sparse

        return sparse.cast_storage(self, stype)

    # ---- operators --------------------------------------------------------
    def _binop(self, other, name, reverse=False):
        op = _op(name)
        return op(other, self) if reverse else op(self, other)

    def __add__(self, o):
        return self._binop(o, "add")

    def __radd__(self, o):
        return self._binop(o, "add", True)

    def __sub__(self, o):
        return self._binop(o, "subtract")

    def __rsub__(self, o):
        return self._binop(o, "subtract", True)

    def __mul__(self, o):
        return self._binop(o, "multiply")

    def __rmul__(self, o):
        return self._binop(o, "multiply", True)

    def __truediv__(self, o):
        return self._binop(o, "divide")

    def __rtruediv__(self, o):
        return self._binop(o, "divide", True)

    def __floordiv__(self, o):
        return self._binop(o, "floor_divide")

    def __rfloordiv__(self, o):
        return self._binop(o, "floor_divide", True)

    def __mod__(self, o):
        return self._binop(o, "mod")

    def __rmod__(self, o):
        return self._binop(o, "mod", True)

    def __pow__(self, o):
        return self._binop(o, "power")

    def __rpow__(self, o):
        return self._binop(o, "power", True)

    # in-place forms rebind the name to a new array, as in the JAX package
    __iadd__ = __add__
    __isub__ = __sub__
    __imul__ = __mul__
    __itruediv__ = __truediv__

    def __matmul__(self, o):
        return _op("dot")(self, o)

    def __neg__(self):
        return self._binop(-1, "multiply")

    def __abs__(self):
        return _op("abs")(self)

    def __eq__(self, o):
        return self._binop(o, "equal")

    def __ne__(self, o):
        return self._binop(o, "not_equal")

    def __lt__(self, o):
        return self._binop(o, "lesser")

    def __le__(self, o):
        return self._binop(o, "lesser_equal")

    def __gt__(self, o):
        return self._binop(o, "greater")

    def __ge__(self, o):
        return self._binop(o, "greater_equal")

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(map(str, self.shape)),
            self.context)

    # ---- interchange ------------------------------------------------------
    def __array__(self, dtype=None, copy=None):
        arr = self.asnumpy()
        return arr.astype(dtype) if dtype is not None else arr

    # NEP-18/NEP-13 dispatch: numpy calls on NDArray operands route
    # through mx.np, so ``numpy.mean(x)`` stays on x's device and on the
    # autograd tape instead of reading x back to the host
    def __array_function__(self, func, types, args, kwargs):
        from .. import numpy as _mxnp

        target = _mxnp
        mod = getattr(func, "__module__", "") or ""
        for part in mod.split(".")[1:]:       # numpy.linalg -> .linalg
            target = getattr(target, part, None)
            if target is None:
                return NotImplemented
        f = getattr(target, func.__name__, None)
        if f is None:
            return NotImplemented
        return f(*args, **kwargs)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__" or kwargs.get("out") is not None:
            return NotImplemented
        from .. import numpy as _mxnp

        f = getattr(_mxnp, ufunc.__name__, None)
        if f is None:
            return NotImplemented
        return f(*inputs, **kwargs)

    def __dlpack__(self, stream=None):
        return self._data.detach().__dlpack__(stream=stream)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()


# the unary methods the JAX NDArray has, each its registry op
def _unary(name):
    def method(self):
        return _op(name)(self)

    method.__name__ = name
    return method


for _name in ("abs", "sqrt", "exp", "log", "sigmoid", "relu", "tanh",
              "round", "floor", "ceil", "sign", "square", "expm1", "log1p"):
    setattr(NDArray, _name, _unary(_name))
_reg.NDArray = NDArray


def _clean_key(key, shape):
    """``key`` with NDArrays unwrapped and each negative-step slice made a
    positive one, plus the output dimensions to flip back (a torch slice
    takes no negative step)."""
    if isinstance(key, NDArray):
        return key._data, ()
    if not isinstance(key, tuple):
        key = (key,)
    key = tuple(k._data if isinstance(k, NDArray) else k for k in key)
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in key):
        return key, ()
    if not all(k is None or k is Ellipsis or isinstance(k, (slice, int))
               for k in key):
        raise MXNetError("a negative-step slice together with an index "
                         "array is not supported")
    if Ellipsis in key:
        i = key.index(Ellipsis)
        n_rest = sum(k is not None for k in key) - 1
        key = key[:i] + (slice(None),) * (len(shape) - n_rest) + key[i + 1:]
    flips, out_dim, in_dim, new_key = [], 0, 0, []
    for k in key:
        if k is None:
            out_dim += 1
        elif isinstance(k, slice):
            if k.step is not None and k.step < 0:
                r = range(*k.indices(shape[in_dim]))
                k = (slice(r[-1], r[0] + 1, -k.step) if len(r)
                     else slice(0, 0))
                flips.append(out_dim)
            out_dim += 1
            in_dim += 1
        else:
            in_dim += 1
        new_key.append(k)
    return tuple(new_key), tuple(flips)


def waitall():
    """Wait for every pending computation on every card this process has
    used."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def from_torch(t):
    """An NDArray over tensor ``t`` (no copy)."""
    return NDArray(t)


def concatenate(arrays, axis=0):
    return _op("concat")(*arrays, dim=axis)
