"""Gluon Trainer: applies an optimizer to a block's parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` on one device.
``step(batch_size)`` sets ``rescale_grad = 1/batch_size``, reduces the
gradients across devices (nothing to reduce on one device) and updates
every parameter that takes a gradient, under a ``trainer_step`` span of
the port's ``trace``.  Parameters stay where they are: the update runs on
their device.  With ``grad_req='write'`` the gradient is cleared after it
is applied, so the next backward writes a fresh one (``'add'`` keeps it).

Not ported yet (they raise): ZeRO sharding (``zero=``, ``mesh=``),
distributed kvstores, ``update_on_kvstore`` and optimizer checkpoints.
"""
from __future__ import annotations

import torch

from .. import optimizer as opt_mod
from .. import trace
from ..base import MXNetError

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "None", "local", "device")


def _not_ported(what):
    return MXNetError("Trainer: %s is not ported" % what)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, zero=False, mesh=None):
        if zero or mesh is not None:
            raise _not_ported("ZeRO sharding (zero=, mesh=)")
        if update_on_kvstore or compression_params:
            raise _not_ported("update_on_kvstore / compression_params")
        if kvstore not in _LOCAL_KVSTORES:
            raise _not_ported("kvstore %r" % (kvstore,))
        if isinstance(params, dict):
            params = list(params.values())
        elif not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a dict or a list of Parameter")
        self._params = list(params)
        for p in self._params:
            if not isinstance(p, torch.nn.Parameter):
                raise MXNetError("invalid parameter %r" % (p,))
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **(optimizer_params or {}))
        self._scale = self._optimizer.rescale_grad
        self._states = {}
        self._step_count = 0

    def step(self, batch_size):
        """allreduce_grads + update, gradients scaled by 1/batch_size."""
        self._optimizer.rescale_grad = self._scale / batch_size
        with trace.span("trainer_step", hist=False,
                        args={"step": self._step_count}):
            self.allreduce_grads()
            self._update()

    def allreduce_grads(self):
        """Reduce gradients across devices: one device has nothing to
        reduce."""

    def update(self, batch_size):
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
        with torch.no_grad():
            for i, p in enumerate(self._params):
                req = getattr(p, "grad_req", "write")
                if req == "null":
                    continue
                if i not in self._states:
                    self._states[i] = self._optimizer.create_state(i, p)
                # a parameter no backward reached: a zero gradient, as the
                # JAX package's zero-filled gradient buffer gives
                grad = p.grad if p.grad is not None else torch.zeros_like(p)
                self._optimizer.update(i, p, grad, self._states[i])
                if req == "write":
                    p.grad = None
        self._step_count += 1

    def save_states(self, fname):
        raise _not_ported("save_states")

    def load_states(self, fname):
        raise _not_ported("load_states")
