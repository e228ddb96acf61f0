"""Gluon Parameter over ``torch.nn.Parameter``.

Counterpart of ``mxnet_tpu/gluon/parameter.py``.  A ``Parameter`` is a
``torch.nn.Parameter`` that carries Gluon's attributes: ``grad_req``
(``'write'`` by default, ``'add'``, or ``'null'`` for no gradient),
``lr_mult``, ``wd_mult`` and ``init``.

Two of the JAX package's methods are spelled the PyTorch way, because a
tensor's own fields carry those names: the data is the parameter itself
(``p`` or ``p.data``, where the JAX package has ``p.data()``) and its
gradient is ``p.grad`` (``p.grad()`` there).  ``grad_req='write'`` means
the gradient of one backward replaces the last one: ``Trainer.step``
clears it after applying it (``'add'`` keeps it).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..context import device_of

__all__ = ["Parameter"]

_GRAD_REQS = ("write", "add", "null")


class Parameter(torch.nn.Parameter):
    def __new__(cls, data=None, requires_grad=True, grad_req=None,
                lr_mult=1.0, wd_mult=1.0, init=None):
        if grad_req is None:
            grad_req = "write" if requires_grad else "null"
        if grad_req not in _GRAD_REQS:
            raise MXNetError("grad_req must be one of %s, got %r"
                             % (_GRAD_REQS, grad_req))
        self = super().__new__(cls, data, grad_req != "null")
        self._grad_req = grad_req
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._initialized = False   # zeros from the constructor until set
        return self

    def __init__(self, *args, **kwargs):  # all set in __new__
        pass

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

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, name="weight"):
        """Move to ``device_of(ctx)`` (the card unless ``ctx=mx.cpu()``)
        and, unless already initialized or set, fill with ``init``, else
        this parameter's own ``init``, else ``default_init``
        (``initializer.Uniform()``); ``name`` picks the rule
        (``*bias``/``*beta`` zeros, ``*gamma`` ones).  The device moves in
        place, so the object stays the one the block holds."""
        from .. import initializer as init_mod

        device = device_of(ctx)
        if self.device != device:
            self.data = self.data.to(device)
            self.grad = None
        if self._initialized and not force_reinit:
            return
        chosen = init or self.init or default_init or init_mod.Uniform()
        init_mod.create(chosen)(name, self)
        self._initialized = True

    def set_data(self, data):
        """Copy ``data`` (a tensor or array of this shape) into the
        parameter, keeping its dtype and device."""
        with torch.no_grad():
            self.copy_(torch.as_tensor(data))
        self._initialized = True

    def zero_grad(self):
        if self.grad is not None:
            self.grad.zero_()

