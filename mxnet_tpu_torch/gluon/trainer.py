"""Gluon Trainer: applies an optimizer to a block's parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` on one device.
``step(batch_size)`` sets ``rescale_grad = 1/batch_size``, reduces the
gradients across devices (nothing to reduce on one device) and updates
every parameter that takes a gradient through the grouped multi-tensor
apply (``optimizer/multi_tensor.py``): each group of parameters with the
same optimizer, dtypes, multipliers and state layout runs the optimizer's
list rule once; parameters that cannot be grouped take the per-parameter
path, counted by reason.  Under ``mx.monitor``'s ``skip_step`` sentinel a
step with nonfinite gradients changes nothing and does not count.
Parameters stay where they are: the update runs on their device.  With
``grad_req='write'`` the gradient is cleared after the step, so the next
backward writes a fresh one (``'add'`` keeps it).

``capture(block, loss_fn)`` returns an ``mx.step`` ``StepProgram``: the
whole training step as one CUDA graph on the card.

Not ported yet (they raise): ZeRO sharding (``zero=``, ``mesh=``),
distributed kvstores, ``update_on_kvstore`` and the optimizer checkpoints
(``save_states``/``load_states``, with ``checkpoint/``).
"""
from __future__ import annotations

import weakref

import torch

from .. import optimizer as opt_mod
from .. import trace
from ..base import MXNetError
from ..optimizer import multi_tensor as _mt

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
            names, params = list(params.keys()), list(params.values())
        elif isinstance(params, (list, tuple)):
            names, params = list(range(len(params))), list(params)
        else:
            raise MXNetError("params must be a dict or a list of Parameter")
        self._param_names = names
        self._params = params
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
        self._mt_groups = {}      # group key -> multi_tensor._Group
        self._step_programs = []  # weakrefs to mx.step StepPrograms

    # ---- properties ---------------------------------------------------------
    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def step_count(self):
        """Optimizer steps applied so far (a skipped step does not
        count)."""
        return self._step_count

    def set_learning_rate(self, lr):
        """Set the optimizer's lr.  The groups (and any captured step)
        rebuild with it at the next step."""
        self._optimizer.set_learning_rate(lr)

    # ---- whole-step capture (mx.step) --------------------------------------
    def capture(self, block, loss_fn, **kwargs):
        """The whole training step -- ``block`` forward, ``loss_fn``,
        backward, this trainer's grouped apply and the mx.monitor stats --
        as one ``mx.step`` ``StepProgram``: ``loss = program(data,
        label)``.  It runs the stitched record/backward/step sequence
        whenever capture does not apply, counted by reason."""
        from .. import step as _step

        return _step.capture(block, loss_fn, trainer=self, **kwargs)

    def _register_step_program(self, program):
        self._step_programs = [r for r in self._step_programs
                               if r() is not None]
        self._step_programs.append(weakref.ref(program))

    def _invalidate_step_programs(self):
        """Drop every captured step of this trainer (their graphs hold the
        optimizer-state tensors they were captured over)."""
        for ref in self._step_programs:
            program = ref()
            if program is not None:
                program.invalidate()

    # ---- the step -----------------------------------------------------------
    def _maybe_init_states(self, i, param):
        if i not in self._states:
            with torch.no_grad():
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(i, param)

    def step(self, batch_size, ignore_stale_grad=False):
        """allreduce_grads + update, gradients scaled by 1/batch_size."""
        self._optimizer.rescale_grad = self._scale / batch_size
        with trace.span("trainer_step", hist=False,
                        args={"step": self._step_count}):
            self.allreduce_grads()
            self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Reduce gradients across devices: one device has nothing to
        reduce."""

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _items(self):
        """``[(index, param, grad)]`` of every parameter that takes a
        gradient, states made on first use.  A parameter no backward
        reached gets a zero gradient, as the JAX package's zero-filled
        gradient buffer gives."""
        items = []
        for i, p in enumerate(self._params):
            if getattr(p, "grad_req", "write") == "null":
                continue
            self._maybe_init_states(i, p)
            items.append((i, p, p.grad if p.grad is not None
                          else torch.zeros_like(p)))
        return items

    def _update(self, ignore_stale_grad=False):
        items = self._items()
        with trace.span("trainer_update", hist=False):
            applied = _mt.apply_updates(self, items)
        for _, p, _ in items:
            if getattr(p, "grad_req", "write") == "write":
                p.grad = None
        if applied is not False:
            self._step_count += 1

    def _eager_update(self, i, param, grad):
        """The per-parameter update (the grouped path's fallback)."""
        self._optimizer.update_multi_precision(i, param, grad,
                                               self._states[i])

    def save_states(self, fname):
        raise _not_ported("save_states (optimizer checkpoints)")

    def load_states(self, fname):
        raise _not_ported("load_states (optimizer checkpoints)")
