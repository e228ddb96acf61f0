"""Gluon Parameter over ``torch.nn.Parameter``, with deferred shapes.

Counterpart of ``mxnet_tpu/gluon/parameter.py``.  A ``Parameter`` is a
``torch.nn.Parameter`` that carries Gluon's attributes: ``name``,
``grad_req`` (``'write'`` by default, ``'add'``, or ``'null'`` for no
gradient), ``lr_mult``, ``wd_mult`` and ``init``.  It is declared the
Gluon way, ``Parameter("alpha", shape=(1,), init="ones")``, with the JAX
package's arguments; the port's own layers hand it its first values
instead (``Parameter(data=tensor)``, or a tensor as the first argument).
A parameter assigned to a block attribute under one of the default names
(``weight``, ``bias``, ``gamma``, ``beta``, ``const``, ``param``) takes
the attribute's name, as in the JAX package.  ``stype`` and
``grad_stype`` take ``'default'``, ``'row_sparse'`` or ``'csr'``: the data
and the gradient stay dense tensors, and ``gluon.Trainer`` hands a
lazy-update optimizer a ``'row_sparse'`` gradient as an
``nd.sparse.RowSparseNDArray`` of its nonzero rows, as the JAX package
does.  A ``sharding`` is not ported (sharded parameters wait in
``ROADMAP.md`` Queue 1 item 7) and raises.  ``Constant`` is a parameter
with ``grad_req='null'`` that
keeps its value through ``initialize``.

Two of the JAX package's methods are spelled the PyTorch way, because a
tensor's own fields carry those names: the data is the parameter itself
(``p`` or ``p.data``, where the JAX package has ``p.data()``) and its
gradient is ``p.grad`` (``p.grad()`` there).  ``grad_req='write'`` means
the gradient of one backward replaces the last one (``autograd.backward``
drops a stale one first; ``Trainer.step`` also clears it after applying
it), ``'add'`` sums them.

Deferred shapes: a parameter whose shape holds a 0 (``Dense(units,
in_units=0)`` has weight shape ``(units, 0)``) has no values yet.
``initialize`` records the initializer and moves it to its device; the
layer's first call infers the shape from its input and fills it
(``_finish_deferred_init``), and ``set_data`` gives it the shape of the
array it receives.  Before either, a deferred parameter is an empty tensor
of its partial shape.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import autograd
from ..base import MXNetError, _as_torch_dtype
from ..context import Context, device_of

__all__ = ["Parameter", "Constant", "DeferredInitializationError"]

_GRAD_REQS = ("write", "add", "null")
_STYPES = ("default", "row_sparse", "csr")


class DeferredInitializationError(MXNetError):
    """A parameter is used before its shape is known."""


_DEFAULT_NAMES = ("weight", "bias", "gamma", "beta", "const", "param")


def _compatible(partial, shape):
    """Whether ``shape`` completes ``partial`` (a 0 there is unknown; None
    is a shape not declared at all)."""
    if partial is None:
        return True
    return len(partial) == len(shape) and all(
        s in (0, n) for s, n in zip(partial, shape))


class Parameter(torch.nn.Parameter):
    def __new__(cls, name="weight", grad_req="write", shape=None,
                dtype="float32", lr_mult=1.0, wd_mult=1.0, init=None,
                allow_deferred_init=False, differentiable=True,
                stype="default", grad_stype="default", sharding=None,
                data=None):
        if isinstance(name, (torch.Tensor, _np.ndarray)):
            name, data = "weight", name      # the port's own spelling
        if isinstance(grad_req, bool):       # torch's (data, requires_grad)
            grad_req = "write" if grad_req else "null"
        for what, st in (("stype", stype), ("grad_stype", grad_stype)):
            if st not in _STYPES:
                raise MXNetError("Parameter(%s=%r): one of %s"
                                 % (what, st, _STYPES))
        if sharding is not None:
            raise MXNetError("Parameter(sharding=...): sharded parameters "
                             "are not ported")
        if not differentiable:
            grad_req = "null"
        if grad_req not in _GRAD_REQS:
            raise MXNetError("grad_req must be one of %s, got %r"
                             % (_GRAD_REQS, grad_req))
        partial = tuple(int(s) for s in shape) if shape is not None \
            else None
        if data is None:
            data = torch.zeros(partial if partial is not None else (0,),
                               dtype=_as_torch_dtype(dtype))
        else:
            data = torch.as_tensor(data)
            partial = tuple(data.shape)
        self = super().__new__(cls, data, grad_req != "null")
        self._name = name
        self._partial = partial     # the declared shape (0 = unknown)
        self._grad_req = grad_req
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self.stype = stype
        self.grad_stype = grad_stype
        self._initialized = False   # zeros from the constructor until set
        self._deferred = None       # (init, default_init, name) until shaped
        autograd._register_leaf(self)
        return self

    def __init__(self, *args, **kwargs):  # all set in __new__
        pass

    @property
    def name(self):
        """The parameter's own name (``'weight'``, ``'alpha'``)."""
        return self._name

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in _GRAD_REQS:
            raise MXNetError("grad_req must be one of %s, got %r"
                             % (_GRAD_REQS, req))
        self._grad_req = req
        self.requires_grad_(req != "null")
        if req == "null":
            self.grad = None

    def _needs_shape(self):
        return self._partial is None or 0 in self.shape

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, name=None):
        """Move to ``device_of(ctx)`` (the card unless ``ctx=mx.cpu()``)
        and, unless already initialized or set, fill with ``init``, else
        this parameter's own ``init``, else ``default_init``
        (``initializer.Uniform()``); ``name`` (default the parameter's
        own) picks the rule
        (``*bias``/``*beta`` zeros, ``*gamma`` ones, running means zeros
        and variances ones).  A parameter of unknown shape keeps the
        choice until its shape is known.  The device moves in place, so
        the object stays the one the block holds."""
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        name = name or self._name
        device = device_of(ctx)
        if self.device != device:
            self.data = self.data.to(device)
            self.grad = None
        if self._initialized and not force_reinit:
            return
        if self._needs_shape():
            self._deferred = (init, default_init, name)
            return
        self._fill(init, default_init, name)

    def _fill(self, init, default_init, name):
        from .. import initializer as init_mod

        chosen = init or self.init or default_init or init_mod.Uniform()
        init_mod.create(chosen)(name, self)
        self._initialized = True
        self._deferred = None

    def _reshape(self, shape):
        """Give a parameter of partial shape its full ``shape`` (values
        undefined until filled)."""
        shape = tuple(int(s) for s in shape)
        if not _compatible(self._partial, shape) or 0 in shape:
            raise MXNetError("cannot give parameter of shape %s the shape %s"
                             % (self._partial, shape))
        self.data = torch.empty(shape, dtype=self.dtype, device=self.device)
        self._partial = shape
        self.grad = None

    def _finish_deferred_init(self, shape):
        """Called by the layer with the shape its input implies: a
        parameter still of partial shape takes it and its recorded
        initializer; one already shaped must agree."""
        shape = tuple(int(s) for s in shape)
        if not self._needs_shape():
            if tuple(self.shape) != shape:
                raise MXNetError("parameter of shape %s met an input that "
                                 "implies %s" % (tuple(self.shape), shape))
            return
        if self._deferred is None:
            raise DeferredInitializationError(
                "parameter of partial shape %s has not been initialized; "
                "call .initialize() (or set its data) before the first "
                "call" % (tuple(self.shape),))
        self._reshape(shape)
        self._fill(*self._deferred)

    def set_data(self, data):
        """Copy ``data`` (a tensor or array of this shape) into the
        parameter, keeping its dtype and device.  A parameter of partial
        shape takes the shape of ``data``."""
        data = torch.as_tensor(data)
        if self._needs_shape():
            self._reshape(data.shape)
        with torch.no_grad():
            self.copy_(data)
        self._initialized = True
        self._deferred = None

    def cast(self, dtype):
        """Give the parameter ``dtype`` in place (its gradient is dropped);
        a deferred parameter keeps the dtype for when it is shaped."""
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        self.data = self.data.to(dtype)
        self.grad = None

    def zero_grad(self):
        if self.grad is not None:
            self.grad.zero_()

    def list_data(self):
        """The data on each device: one card, so ``[p.data]``."""
        return [self.data]

    def list_grad(self):
        """The gradient on each device: ``[p.grad]``; raises for
        ``grad_req='null'``."""
        if self._grad_req == "null":
            raise MXNetError("Parameter %s has grad_req='null'" % self._name)
        return [self.grad]

    def list_ctx(self):
        """The contexts the parameter lives on: ``[its context]``."""
        return [Context.from_device(self.device)]

    def reset_ctx(self, ctx):
        """Move the values to ``ctx``'s device (the gradient is dropped)."""
        device = device_of(ctx)
        if self.device != device:
            self.data = self.data.to(device)
            self.grad = None


class Constant(Parameter):
    """A parameter that is not learned (``grad_req='null'``) and holds
    ``value`` from the start; ``initialize`` keeps it."""

    def __new__(cls, value, name="const"):
        value = value._data if hasattr(value, "_data") else value
        arr = torch.as_tensor(_np.asarray(value, dtype=_np.float32)
                              if not isinstance(value, torch.Tensor)
                              else value)
        self = super().__new__(cls, name, grad_req="null",
                               data=arr.detach().clone())
        self._initialized = True
        return self

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, name=None):
        """Move to ``device_of(ctx)``; the value stays."""
        super().initialize(ctx=ctx)
