"""``mx.nd``: the imperative NDArray API.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``.  Every registered op is
exposed under its MXNet name as its ``Operator`` (``nd.add``,
``nd.multi_head_attention``, the CamelCase and ``broadcast_*`` names), so
every call flows through ``ops.registry.invoke``.  Arrays are made on
``ctx`` (default the current context: the card, or the CPU inside ``with
mx.cpu():``).  Types follow the JAX package: float64 data becomes float32
and int64 data int32.  ``save``/``load`` use the JAX package's ``npz``
layout or the reference's binary format, so a file written by one
package loads in the other.
"""
# pylint: disable=redefined-builtin
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, _as_torch_dtype
from ..context import current_context, device_of
from ..ops.registry import get_op, list_ops
from .ndarray import NDArray, concatenate, from_torch, waitall

# ---- every registered op under its MXNet name -----------------------------
_namespace = globals()
for _name in list_ops():
    _namespace.setdefault(_name, get_op(_name))

for _name in ("power", "maximum", "minimum", "equal", "not_equal", "greater",
              "greater_equal", "lesser", "lesser_equal"):
    _namespace["broadcast_" + _name] = get_op(_name)
SoftmaxActivation = get_op("softmax")
L2Normalization = get_op("l2_normalization")
BlockGrad = stop_gradient = get_op("stop_gradient")


def dropout(data, p=0.5, mode="training", axes=None):
    """Dropout with the port's generator, active in training (the legacy
    ``Dropout`` op)."""
    return get_op("Dropout")(data, p=p, mode=mode,
                             axes=tuple(axes) if axes else None)


# ---- creation -------------------------------------------------------------


def _dtype(dtype):
    return _as_torch_dtype(dtype if dtype is not None else "float32")


def array(source_array, ctx=None, dtype=None):
    """A new array holding a copy of ``source_array`` (float64 data
    becomes float32, int64 data int32, unless ``dtype`` says otherwise)."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach()
    else:
        arr = _np.asarray(source_array)
        if not arr.flags.writeable:
            arr = arr.copy()
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(_np.int16)).view(torch.bfloat16)
        else:
            # np.ascontiguousarray would raise a 0-d array to 1-d
            t = torch.from_numpy(arr if arr.flags.c_contiguous
                                 else arr.copy(order="C"))
    dt = _as_torch_dtype(t.dtype if dtype is None else dtype)
    return NDArray(_ctx(ctx).place(t.to(dtype=dt), copy=True))


def _ctx(ctx):
    return ctx if ctx is not None else current_context()


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32", **kw):
    c = _ctx(ctx)
    return NDArray(c.place(torch.zeros(_shape(shape), dtype=_dtype(dtype),
                                    device=c.torch_device)))


def ones(shape, ctx=None, dtype="float32", **kw):
    c = _ctx(ctx)
    return NDArray(c.place(torch.ones(_shape(shape), dtype=_dtype(dtype),
                                    device=c.torch_device)))


def full(shape, val, ctx=None, dtype="float32", **kw):
    return NDArray(torch.full(_shape(shape), val, dtype=_dtype(dtype),
                              device=device_of(ctx)))


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    if stop is None:
        start, stop = 0, start
    data = torch.arange(start, stop, step, dtype=torch.float64).to(
        _dtype(dtype))
    if repeat > 1:
        data = data.repeat_interleave(repeat)
    return NDArray(data.to(device_of(ctx)))


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    if endpoint:
        data = torch.linspace(start, stop, num, dtype=torch.float64)
    else:
        data = torch.linspace(start, stop, num + 1,
                              dtype=torch.float64)[:num]
    return NDArray(data.to(device_of(ctx), _dtype(dtype)))


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    M = M if M else N
    data = torch.ones(N, M, dtype=_dtype(dtype)).tril(k).triu(k)
    return NDArray(data.to(device_of(ctx)))


def zeros_like(other, **kw):
    return get_op("zeros_like")(other)


def ones_like(other, **kw):
    return get_op("ones_like")(other)


# ---- serialization: the JAX package's npz layout, or the reference's -----


def _host(v):
    """(numpy, manifest dtype) of an NDArray: a bf16 one as its uint16
    bits, written with the ``<V2`` header ``ml_dtypes.bfloat16`` has."""
    from ..checkpoint import layout

    return layout.snapshot_leaf(v), layout.dtype_name(v)


def save(fname, data, format="npz"):
    """Save an NDArray, a list or a dict of NDArrays.

    ``format='npz'`` (default) writes the JAX package's ``.npz``: a single
    array under ``__mx_single__``, a list under ``__mx_list_<i>__``, a dict
    under its keys.  ``format='reference'`` writes the incumbent's binary
    NDArray-list format (``legacy_io``).  Either way the file is written
    beside ``fname`` and moved into place (``checkpoint.layout
    .atomic_file``), so a crash never leaves a truncated ``fname``."""
    if format == "reference":
        from .. import legacy_io

        return legacy_io.save(fname, data)
    if format != "npz":
        raise MXNetError("save: unknown format %r (npz or reference)"
                         % (format,))
    if isinstance(data, NDArray):
        items = {"__mx_single__": data}
    elif isinstance(data, dict):
        items = dict(data)
    elif isinstance(data, (list, tuple)):
        items = {"__mx_list_%d__" % i: v for i, v in enumerate(data)}
    else:
        raise MXNetError("save: unsupported data type %r" % type(data))
    from ..checkpoint import layout

    payload, dtypes = {}, {}
    for k, v in items.items():
        payload[k], dtypes[k] = _host(v)
    layout.atomic_file(fname, lambda f: layout.write_npz(f, payload, dtypes))


def _from_npz(arr, ctx):
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # bfloat16
        arr = torch.from_numpy(arr.view(_np.int16)).view(torch.bfloat16)
    return array(arr, ctx=ctx)


def load(fname, ctx=None):
    """Load what ``save`` wrote (by either package, in either format,
    told apart by the reference's magic number): an NDArray, a list or a
    dict of NDArrays on ``ctx``."""
    from .. import legacy_io

    with open(fname, "rb") as f:
        head = f.read(8)
    if legacy_io.is_reference_format(head):
        return legacy_io.load(fname, ctx=ctx)
    with _np.load(fname, allow_pickle=False) as npz:
        keys = list(npz.keys())
        if keys == ["__mx_single__"]:
            return _from_npz(npz["__mx_single__"], ctx)
        if keys and all(k.startswith("__mx_list_") for k in keys):
            out = [None] * len(keys)
            for k in keys:
                out[int(k[len("__mx_list_"):-2])] = _from_npz(npz[k], ctx)
            return out
        return {k: _from_npz(npz[k], ctx) for k in keys}


from . import contrib  # noqa: E402  (mx.nd.contrib)
from . import image, linalg  # noqa: E402  (mx.nd.image, mx.nd.linalg)
from . import sparse  # noqa: E402  (mx.nd.sparse: row_sparse and CSR)
from .. import random  # noqa: E402  (mx.nd.random is mx.random)
from ..operator import Custom  # noqa: E402  (mx.nd.Custom)

__all__ = ["NDArray", "waitall", "array", "zeros", "ones", "full", "empty",
           "arange", "linspace", "eye", "zeros_like", "ones_like",
           "save", "load", "concatenate", "from_torch", "random", "sparse",
           "contrib", "image", "linalg", "Custom", "dropout"] + list_ops()
