"""``mx.operator``: user-defined Python operators.

Counterpart of ``mxnet_tpu/operator.py``: ``CustomOp`` / ``CustomOpProp``
registered by name and called as ordinary ops (``mx.nd.Custom(x,
op_type='sigmoid')``, ``mx.npx.Custom``), with req-aware output
assignment.  A call is one ``torch.autograd.Function``: its forward runs
the user's ``forward`` on NDArrays over the input tensors, and its
backward the user's ``backward``, so inside ``autograd.record()`` the op
sits on torch's tape between the ops around it.
"""
from __future__ import annotations

import torch

from . import autograd as _ag
from .base import MXNetError, _as_torch_dtype
from .ndarray.ndarray import NDArray

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered",
           "Custom"]

_CUSTOM_REGISTRY = {}


class CustomOp:
    """Base class of user ops."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise MXNetError("backward not implemented for this CustomOp")

    def assign(self, dst, req, src):
        """Store ``src`` into ``dst`` as ``req`` says (write, inplace,
        add or null)."""
        if req == "null":
            return
        src = src if isinstance(src, NDArray) else NDArray(src)
        if req in ("write", "inplace"):
            dst._data = src._data
        elif req == "add":
            dst._data = dst._data + src._data
        else:
            raise MXNetError("unknown req %r" % req)


class CustomOpProp:
    """Describes a custom op: its arguments, outputs, shapes and types."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """Register a ``CustomOpProp`` subclass under ``reg_name``."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return deco


def get_all_registered():
    return dict(_CUSTOM_REGISTRY)


class _CustomFunction(torch.autograd.Function):
    """One call of a custom op on torch's tape."""

    @staticmethod
    def forward(ctx, call, *tensors):
        in_data = [NDArray(t) for t in tensors]
        out_data = call.new_outputs(tensors)
        with _ag.pause(train_mode=call.is_train):
            call.op.forward(call.is_train, ["write"] * len(out_data),
                            in_data, out_data, call.aux)
        ctx.call, ctx.in_data, ctx.out_data = call, in_data, out_data
        outs = tuple(o._data.detach() for o in out_data)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        call = ctx.call
        in_grad = [NDArray(torch.zeros_like(x._data)) for x in ctx.in_data]
        out_grad = [NDArray(g if g is not None else torch.zeros_like(
            o._data)) for g, o in zip(grads, ctx.out_data)]
        with _ag.pause():
            call.op.backward(["write"] * len(in_grad), out_grad,
                             ctx.in_data, ctx.out_data, in_grad, call.aux)
        return (None,) + tuple(g._data for g in in_grad)


class _Call:
    __slots__ = ("op", "is_train", "aux", "oshapes", "otypes")

    def new_outputs(self, tensors):
        dev = tensors[0].device if tensors else None
        return [NDArray(torch.zeros(tuple(s), dtype=_as_torch_dtype(t),
                                    device=dev))
                for s, t in zip(self.oshapes, self.otypes)]


def Custom(*inputs, op_type=None, **kwargs):
    """Invoke the custom op registered as ``op_type`` on ``inputs``; its
    other keyword arguments reach the ``CustomOpProp`` as strings."""
    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    prop_cls = _CUSTOM_REGISTRY.get(op_type)
    if prop_cls is None:
        raise MXNetError("custom op %r is not registered" % op_type)
    prop = prop_cls(**{k: str(v) for k, v in kwargs.items()})
    in_data = [x if isinstance(x, NDArray) else NDArray(x) for x in inputs]
    n_args = len(prop.list_arguments())
    if len(in_data) != n_args:
        raise MXNetError("custom op %r expects %d inputs, got %d"
                         % (op_type, n_args, len(in_data)))
    ishapes, oshapes, aux_shapes = prop.infer_shape(
        [list(x.shape) for x in in_data])
    itypes, otypes, aux_types = prop.infer_type([x.dtype for x in in_data])
    call = _Call()
    call.op = prop.create_operator(None, ishapes, itypes)
    call.is_train = _ag.is_training() or _ag.is_recording()
    call.oshapes, call.otypes = oshapes, otypes
    dev = in_data[0]._data.device if in_data else None
    call.aux = [NDArray(torch.zeros(tuple(s), dtype=_as_torch_dtype(t),
                                    device=dev))
                for s, t in zip(aux_shapes, aux_types)]
    tensors = [x._data for x in in_data]
    if _ag.is_recording():
        outs = _CustomFunction.apply(call, *tensors)
    else:
        with torch.no_grad():
            outs = _CustomFunction.apply(call, *tensors)
    out_data = [NDArray(o) for o in outs]
    return out_data[0] if len(out_data) == 1 else tuple(out_data)
