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

Persistence, in the JAX package's formats: ``save_states``/``load_states``
pickle the optimizer state by parameter index, and ``save_checkpoint``/
``load_checkpoint`` write one ``mx.checkpoint`` step holding the
parameters, the optimizer state and update counts (keyed by parameter
name), the step counter and, after ``attach_loader``, the data cursor.  A
restore copies the parameters in place, rebuilds the state, drops the
grouped-apply groups and invalidates every captured step (its graph holds
the state it was captured over); the next step captures anew.  The state
tree carries no RNG state, as in the JAX package.

Not ported yet (they raise): ZeRO sharding (``zero=``, ``mesh=``),
distributed kvstores and ``update_on_kvstore``.
"""
from __future__ import annotations

import pickle
import time as _time
import weakref

import torch

from .. import optimizer as opt_mod
from .. import trace
from ..resilience import inject as _inject
from ..base import MXNetError
from ..checkpoint import cached_manager
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
        self._data_loader = None         # weakref to a StreamLoader
        self._pending_data_state = None  # cursor restored before attach

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
        """allreduce_grads + update, gradients scaled by 1/batch_size.

        The ``trainer_step`` fault site fires first, keyed by the step
        count, before anything changes (a faulted step is cleanly
        retryable from the last checkpoint); with ``mx.obs`` on the
        step's host time feeds the cadence (``obs.core.note_step``)."""
        from .. import obs as _obs

        self._optimizer.rescale_grad = self._scale / batch_size
        t0 = _time.perf_counter() if _obs.core.ENABLED else 0.0
        with trace.span("trainer_step", hist=False, anomaly=True,
                        args={"step": self._step_count}), \
                trace.watchdog.watch("trainer_step"):
            _inject.fire("trainer_step", seq=self._step_count)
            self.allreduce_grads()
            self._update(ignore_stale_grad)
        if _obs.core.ENABLED:
            # the captured path notes its own steps
            _obs.core.note_step(_time.perf_counter() - t0)

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
        gradient buffer gives.  A ``grad_stype='row_sparse'`` gradient
        goes to an optimizer with a lazy update (``lazy_update``: SGD,
        Adam) as an ``nd.sparse.RowSparseNDArray`` of its nonzero rows, so
        that only those rows and their state change; other optimizers
        take it dense, as in the JAX package."""
        from ..ndarray import sparse

        lazy = getattr(self._optimizer, "lazy_update", False)
        items = []
        for i, p in enumerate(self._params):
            if getattr(p, "grad_req", "write") == "null":
                continue
            self._maybe_init_states(i, p)
            grad = p.grad if p.grad is not None else torch.zeros_like(p)
            if lazy and getattr(p, "grad_stype", "default") == "row_sparse":
                grad = sparse.row_sparse_from_dense(grad)
            items.append((i, p, grad))
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

    # ---- persistence ------------------------------------------------------
    def _restored(self):
        """After the optimizer state is replaced: the groups and every
        captured step close over the old state tensors."""
        self._mt_groups.clear()
        self._invalidate_step_programs()

    def save_states(self, fname):
        """Pickle the optimizer state ({parameter index: numpy state}), the
        JAX package's file: either package loads the other's."""
        from ..optimizer.optimizer import _state_np

        with open(fname, "wb") as f:
            pickle.dump({k: _state_np(v) for k, v in self._states.items()},
                        f)

    def load_states(self, fname):
        """Load a ``save_states`` file of either package; each state goes
        to its parameter's device.  As in the JAX package the update
        counts are not in the file."""
        from ..optimizer.optimizer import _state_tensor

        with open(fname, "rb") as f:
            states = pickle.load(f)
        self._states = {k: _state_tensor(v, self._params[k].device)
                        for k, v in states.items()}
        self._restored()

    # ---- mx.data integration -----------------------------------------------
    def attach_loader(self, loader):
        """Attach an ``mx.data.StreamLoader``: its cursor (epoch, batch,
        seed) rides ``state_dict()`` into every checkpoint, so a restore
        resumes the exact remaining sample order.  Attach before the first
        save or restore; a cursor restored before the loader was attached
        is applied here."""
        self._data_loader = None if loader is None \
            else weakref.ref(loader)
        if loader is not None and self._pending_data_state is not None:
            loader.load_state_dict(self._pending_data_state)
            self._pending_data_state = None
        return loader

    def _attached_loader(self):
        ref = self._data_loader
        return ref() if ref is not None else None

    # ---- mx.checkpoint integration -----------------------------------------
    def state_dict(self):
        """The whole training state as one checkpointable tree:
        ``{"params", "states", "updates": {"num_update", "counts"},
        "step"}`` (and ``"data"``, the attached loader's cursor).  States
        and counts are keyed by parameter name, not index, so a restoring
        trainer that lists its parameters in another order attaches each
        moment to the right weight."""
        opt = self._optimizer
        names = [str(n) for n in self._param_names]
        tree = {"params": {names[i]: p.detach()
                           for i, p in enumerate(self._params)
                           if p._initialized},
                "states": {names[i]: s for i, s in self._states.items()},
                "updates": {"num_update": int(opt.num_update),
                            "counts": {names[i]: int(c) for i, c in
                                       opt._index_update_count.items()
                                       if i < len(names)}},
                "step": self._step_count}
        loader = self._attached_loader()
        if loader is not None:
            tree["data"] = loader.state_dict()
        return tree

    def save_checkpoint(self, root, step=None, **manager_kwargs):
        """Save ``state_dict()`` as one atomic ``mx.checkpoint`` step under
        ``root`` (default tag: the trainer's update count); ``max_keep``,
        ``keep_every``, ... configure the manager.  Returns the committed
        directory."""
        tree = self.state_dict()
        step = self._step_count if step is None else int(step)
        mgr = cached_manager(self, root, **manager_kwargs)
        return mgr.save(step, tree)

    def load_checkpoint(self, root, step=None):
        """Restore a ``save_checkpoint`` step of either package (default:
        the latest) onto the parameters' device.  Returns the step."""
        mgr = cached_manager(self, root)
        device = self._params[0].device if self._params else None
        step, tree = mgr.restore(step=step, ctx=device)
        try:
            self.load_state_dict(tree)
        except MXNetError as exc:
            raise MXNetError("checkpoint at %s step %d: %s"
                             % (root, step, exc)) from exc
        return step

    def load_state_dict(self, tree):
        """Apply a ``state_dict`` tree (leaves tensors, NDArrays or numpy
        arrays).  Parameters are copied into in place."""
        from ..optimizer.optimizer import _state_tensor

        loaded = tree["params"]
        for n, param in zip(self._param_names, self._params):
            key = str(n)
            if key in loaded:
                param.set_data(getattr(loaded[key], "_data", loaded[key]))
            elif param._initialized:
                raise MXNetError(
                    "checkpoint state is missing parameter %r" % (key,))
        index_of = {str(n): i for i, n in enumerate(self._param_names)}
        unknown = [k for k in tree["states"] if k not in index_of]
        if unknown:
            raise MXNetError(
                "checkpoint state has optimizer state for unknown "
                "parameter(s) %s -- the model structure changed"
                % (sorted(unknown),))
        self._states = {
            index_of[k]: _state_tensor(v, self._params[index_of[k]].device)
            for k, v in tree["states"].items()}
        updates = tree.get("updates")
        if updates is not None:
            self._optimizer.num_update = int(updates["num_update"])
            self._optimizer._index_update_count = {
                index_of[k]: int(v)
                for k, v in updates["counts"].items() if k in index_of}
        self._restored()
        self._step_count = int(tree["step"])
        data = tree.get("data")
        if data is not None:
            data = {k: int(v) for k, v in data.items()}
            loader = self._attached_loader()
            if loader is not None:
                loader.load_state_dict(data)
            else:
                self._pending_data_state = data
