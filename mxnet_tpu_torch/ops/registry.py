"""Operator registry and imperative dispatch for ``mx.nd``.

Counterpart of ``mxnet_tpu/ops/registry.py``.  An op is a plain function
on tensors, ``fn(*tensors, **attrs)``, registered under its MXNet name with
its dispatch metadata.  ``register`` returns the function the registry
keeps: the function itself, or for an op that automatic mixed precision
rewrites (``contrib/amp/lists.py``: every op whose category is not
``passthrough``) the ``amp_rewritten`` wrapper of it.  A module's names
stay plain functions on tensors: the serve, train, capture and
``FusedTrainer`` paths call ``ops.nn`` directly and never pass through
``invoke``, and ``mx.nd`` exposes the registered ``Operator`` objects.

Automatic mixed precision has one chokepoint, the wrapper, which both
routes pass.  While ``amp.init`` is on (``AMP.dtype`` set), the outermost
rewritten call of a thread casts its positional tensor inputs by the op's
category before calling the function: ``target_dtype`` ops take float32
inputs to the target dtype, ``fp32`` ops take bf16/fp16 inputs to float32,
``widest`` ops promote mixed floating inputs to the widest.  The casts are
``tensor.to`` inside the autograd graph, so each input's gradient comes
back in its own dtype (float32 parameters get float32 gradients), as in
the JAX package, whose ``invoke`` casts inside the differentiated
function.  Rewritten ops called from inside one run as they are, as the
JAX ops' own bodies do.  With amp off, the wrapper costs one test of
``AMP.dtype``.

``invoke`` unwraps ``NDArray`` inputs (and NDArray-valued attrs) to their
tensors, calls the function, and wraps the results.  The tape is torch's
own: inside ``autograd.record()`` torch records the op; outside it, or for
an op registered ``differentiable=False``, the op runs without a graph
(under ``torch.no_grad()`` when an input would otherwise build one), as
the JAX package records nothing there.  There is no vjp cache: the JAX
package keeps one only because ``jax.vjp`` retraces.  Results follow the
JAX package's types: an ``int64`` or ``float64`` result is narrowed to
``int32`` or ``float32`` (64-bit types are off there).

``num_outputs`` and ``mutates`` may be callables of the attr dict;
``num_outputs=None`` marks an op whose output count depends on its attrs
(``split``, ``topk``).  A mutating op's function stays pure: it returns
``(*outputs, *new_state_values)`` and ``invoke`` writes the trailing values
back into the NDArray handles at the declared input positions.  ``out=``
writes the result into the caller's handle(s) and returns them.
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from .. import autograd as _ag
from ..base import MXNetError, _canonical

__all__ = ["Operator", "register", "alias", "get_op", "list_ops", "invoke",
           "apply_op", "amp_rewritten", "AMP"]

_OP_REGISTRY = {}
# ndarray.NDArray, set when that module is imported (it imports this one);
# gluon's blocks read it here too, to take and return NDArrays
NDArray = None


class Operator:
    """A registered op: name, function, doc and dispatch metadata."""

    __slots__ = ("name", "fn", "num_outputs", "differentiable", "doc",
                 "mutates")

    def __init__(self, name, fn, num_outputs=1, differentiable=True, doc=None,
                 mutates=None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.differentiable = differentiable
        self.doc = doc or fn.__doc__
        self.mutates = mutates

    def __call__(self, *inputs, **attrs):
        return invoke(self, inputs, attrs)

    def __repr__(self):
        return "Operator(%s)" % self.name


class _Amp:
    """``amp.init``'s state: ``dtype`` the target (None while amp is off);
    ``local.inside`` marks a thread inside a rewritten op."""

    def __init__(self):
        self.dtype = None
        self.local = threading.local()


AMP = _Amp()
_LOW = (torch.bfloat16, torch.float16)


def _to_target(args, to):
    return [a.to(to) if isinstance(a, torch.Tensor)
            and a.dtype == torch.float32 else a for a in args]


def _to_fp32(args, to):
    return [a.float() if isinstance(a, torch.Tensor) and a.dtype in _LOW
            else a for a in args]


def _to_widest(args, to):
    dts = {a.dtype for a in args
           if isinstance(a, torch.Tensor) and a.is_floating_point()}
    if len(dts) < 2:
        return args
    wide = functools.reduce(torch.promote_types, dts)
    return [a.to(wide) if isinstance(a, torch.Tensor)
            and a.is_floating_point() else a for a in args]


_CASTS = {"target_dtype": _to_target, "fp32": _to_fp32,
          "widest": _to_widest}


def amp_rewritten(name, fn):
    """``fn`` as the op called ``name`` runs under amp: ``fn`` itself for a
    ``passthrough`` op, else a wrapper that casts the positional tensor
    inputs by the op's category while amp is on (``amp_category`` names
    it; ``__wrapped__`` is ``fn``)."""
    from ..contrib.amp import lists

    cat = lists.category(name, fn.__module__)
    if cat == "passthrough":
        return fn
    cast = _CASTS[cat]
    local = AMP.local

    @functools.wraps(fn)
    def rewritten(*args, **kwargs):
        to = AMP.dtype
        if to is None or getattr(local, "inside", False):
            return fn(*args, **kwargs)
        local.inside = True
        try:
            return fn(*cast(args, to), **kwargs)
        finally:
            local.inside = False

    rewritten.amp_category = cat
    return rewritten


def register(name=None, num_outputs=1, differentiable=True, mutates=None):
    """Register a function on tensors as a framework op; returns the
    function the registry keeps (``amp_rewritten``: the function itself
    unless amp rewrites the op).

    Usage::

        @register("relu")
        def relu(x):
            return torch.relu(x)
    """

    def deco(fn):
        opname = name or fn.__name__
        if opname in _OP_REGISTRY:
            raise MXNetError("op '%s' registered twice" % opname)
        fn = amp_rewritten(opname, fn)
        _OP_REGISTRY[opname] = Operator(opname, fn, num_outputs,
                                        differentiable, mutates=mutates)
        return fn

    return deco


def alias(new_name, existing):
    """Register another name for an existing op (the same ``Operator``)."""
    op = existing if isinstance(existing, Operator) else get_op(existing)
    if new_name in _OP_REGISTRY:
        raise MXNetError("op '%s' registered twice" % new_name)
    _OP_REGISTRY[new_name] = op
    return op


def get_op(name):
    try:
        return _OP_REGISTRY[name]
    except KeyError:
        raise MXNetError("unknown op '%s'" % name) from None


def list_ops():
    return sorted(_OP_REGISTRY)


def _count(spec, attrs):
    return spec(attrs) if callable(spec) else spec


def _from_numpy(datas):
    """numpy array inputs as tensors on the device of the op's tensors
    (the JAX op takes them as they are)."""
    dev = next((d.device for d in datas if isinstance(d, torch.Tensor)),
               torch.device("cpu"))
    return [_canonical(torch.from_numpy(np.array(d)).to(dev))
            if isinstance(d, np.ndarray) else d for d in datas]


def _builds_graph(datas):
    return torch.is_grad_enabled() and any(
        isinstance(d, torch.Tensor) and d.requires_grad for d in datas)


def invoke(op, inputs, attrs):
    """Run ``op`` on ``inputs`` (NDArrays, tensors or scalars) and wrap its
    results as NDArrays."""
    out_arg = attrs.pop("out", None) if attrs else None
    datas = [x._data if isinstance(x, NDArray) else x for x in inputs]
    if any(isinstance(d, np.ndarray) for d in datas):
        datas = _from_numpy(datas)
    if attrs:
        attrs = {k: (v._data if isinstance(v, NDArray) else v)
                 for k, v in attrs.items()}
    if (not (op.differentiable and _ag.is_recording())
            and _builds_graph(datas)):
        with torch.no_grad():
            out = op.fn(*datas, **attrs)
    else:
        out = op.fn(*datas, **attrs)
    if not isinstance(out, (tuple, list)):
        return _deliver(NDArray(_canonical(out)), out_arg)
    outs = [_canonical(o) for o in out]
    mut = _count(op.mutates, attrs)
    if mut:
        n_primary = _count(op.num_outputs, attrs)
        for pos, val in zip(mut, outs[n_primary:]):
            if isinstance(inputs[pos], NDArray):
                inputs[pos]._data = val
        outs = outs[:n_primary]
    result = (NDArray(outs[0]) if len(outs) == 1
              else tuple(NDArray(o) for o in outs))
    return _deliver(result, out_arg)


def _deliver(result, out_arg):
    """The ``out=`` contract: write the result into the caller's handle(s)
    and return them."""
    if out_arg is None:
        return result
    results = result if isinstance(result, tuple) else (result,)
    targets = out_arg if isinstance(out_arg, (tuple, list)) else (out_arg,)
    if len(results) != len(targets):
        raise MXNetError("out= expects %d arrays, got %d"
                         % (len(results), len(targets)))
    for tgt, res in zip(targets, results):
        tgt._data = res._data
    return out_arg if not isinstance(out_arg, list) else tuple(targets)


def apply_op(fn, *inputs, **attrs):
    """One-off invoke of an unregistered function through the same path."""
    return invoke(Operator(getattr(fn, "__name__", "lambda"), fn), inputs,
                  attrs)
