"""Grouped multi-tensor optimizer apply for the imperative Trainer.

Counterpart of ``mxnet_tpu/optimizer/multi_tensor.py``.  The Trainer groups
its parameters by (optimizer, dtype, grad dtype, lr/wd multipliers, state
structure, device), and each group runs the optimizer's one list rule
(``Optimizer._rule``, ``torch._foreach_*`` ops) over all its members: a
few multi-tensor launches a step where the per-parameter loop makes a few
per parameter.

Per-step values: the rule reads the scheduled lr and wd, ``rescale_grad``
and the Adam-family bias corrections from a group's ``Slots``, 0-dim f32
tensors on the device (the JAX package's ``_HostScalar`` slots).  Each
step the host evaluates them in float64 (``Optimizer._scalars``), after
the update counts moved, and writes them into the slot buffer with one
copy before the group runs: the one f64 -> f32 rounding the JAX slot
takes.  The grouped path always reads its slots, captured or not, so a
step captured into a CUDA graph (``step/capture.py``) and a stitched step
run the same operations in the same order; a new scheduler lr moves a
captured step without recapture.  While a step is being captured a slot
refuses ``float()`` and ``bool()``, which would bake a per-step value into
the graph.  Members whose host values differ (update counts apart) run
as separate sub-groups.

Fallbacks, per parameter, counted in ``trainer_eager_updates_total``:
optimizers not registered fusable (``optimizer``; Nadam moves host state
per update and SGLD draws noise, so both are left out by design, as are
custom subclasses until ``register_fusable``), sparse gradients
(``row_sparse``) or parameters (``stype``), and ``MXNET_MULTI_TENSOR=0``
(``disabled``).  A group whose host preparation fails degrades to eager
updates (``trace-error``); a failure once the group's device work has
begun raises, as the JAX package does once its donated buffers are gone.

Not ported: the compile-cache provenance of a group program (the port
builds none); ``group_table`` says ``"provenance": "not ported"``.
"""
from __future__ import annotations

import logging
import time as _time

import torch

from .. import telemetry as _tel
from .. import trace as _trace
from ..base import MXNetError, get_env

__all__ = ["apply_updates", "partition", "group_table", "is_fusable",
           "register_fusable", "Slots", "capturing"]

_LOGGER = logging.getLogger("mxnet_tpu_torch.multi_tensor")
_f32 = torch.float32

# ---------------------------------------------------------------------------
# slots: per-step hyper-parameters as device tensors
# ---------------------------------------------------------------------------

_CAPTURING = [False]


class capturing:  # noqa: N801 - a context manager named like the flag
    """Scope of a whole-step capture: slots refuse host reads inside it."""

    def __enter__(self):
        self._prev = _CAPTURING[0]
        _CAPTURING[0] = True
        return self

    def __exit__(self, *exc):
        _CAPTURING[0] = self._prev


class _Slot(torch.Tensor):
    """A 0-dim f32 slot.  Arithmetic is a plain tensor's; ``float()`` or
    ``bool()`` while a step is being captured raises, since it would bake
    the current value into the graph."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def _host_read(self, what):
        if _CAPTURING[0]:
            raise MXNetError(
                "optimizer rule %s a per-step hyper-parameter while the "
                "step is being captured; it must stay a device tensor"
                % what)

    def __float__(self):
        self._host_read("concretizes (float())")
        return super().__float__()

    def __bool__(self):
        self._host_read("branches on (bool())")
        return super().__bool__()

    def item(self):
        self._host_read("concretizes (item())")
        return super().item()


class Slots:
    """Named per-step values on ``device``: one f32 buffer, a 0-dim view
    of it per name (``values``).  ``write(values)`` refills the buffer from
    float64 host values with one copy; on the card an asynchronous one
    from a pinned host buffer of its own (rewritten only once its last
    copy has run), so the host does not wait for the card's queue."""

    def __init__(self, values, device):
        self.names = tuple(values)
        self.buf = torch.empty(len(self.names), dtype=_f32, device=device)
        self.values = {n: self.buf[k].as_subclass(_Slot)
                       for k, n in enumerate(self.names)}
        self._host = self._copied = None
        if self.buf.is_cuda:
            self._host = torch.empty(len(self.names), dtype=_f32,
                                     pin_memory=True)
            self._copied = torch.cuda.Event()
        self.write(values)

    def write(self, values):
        if tuple(values) != self.names:
            raise MXNetError("slot names changed: %s -> %s"
                             % (self.names, tuple(values)))
        host = torch.tensor([float(values[n]) for n in self.names],
                            dtype=torch.float64).to(_f32)
        if self._host is None:
            self.buf.copy_(host)
            return
        self._copied.synchronize()
        self._host.copy_(host)
        self.buf.copy_(self._host, non_blocking=True)
        self._copied.record()


def refill(slots, values, device):
    """``slots`` refilled with ``values``, or new ``Slots`` where there are
    none yet or their names or device changed."""
    if slots is None or slots.names != tuple(values) or \
            slots.buf.device != device:
        return Slots(values, device)
    slots.write(values)
    return slots


# ---------------------------------------------------------------------------
# fusability registry
# ---------------------------------------------------------------------------

_FUSABLE = set()
_FUSABLE_READY = [False]


def register_fusable(cls):
    """Declare an Optimizer class safe for the grouped path: its update is
    its list rule (``_rule``) over the weights, gradients and states plus
    the host values of ``_scalars`` -- no random draws, no host state
    moved per update, no branch on a per-step value."""
    _FUSABLE.add(cls)
    return cls


def _builtin_fusable():
    if _FUSABLE_READY[0]:
        return
    from . import optimizer as _opt

    # left out by design: Nadam (moves its host m_schedule every update),
    # SGLD (draws noise during the update)
    for name in ("SGD", "NAG", "Adam", "AdamW", "Adamax", "LAMB", "LANS",
                 "LARS", "Ftrl", "FTML", "AdaGrad", "AdaDelta", "RMSProp",
                 "Signum", "DCASGD", "LBSGD", "Test"):
        _FUSABLE.add(getattr(_opt, name))
    _FUSABLE_READY[0] = True


def is_fusable(optimizer):
    """Exact-class check: a subclass must opt in with ``register_fusable``
    (fusing an overridden update unseen would be wrong, not slow)."""
    _builtin_fusable()
    return type(optimizer) in _FUSABLE


# ---------------------------------------------------------------------------
# grouping
# ---------------------------------------------------------------------------

def _hparams_sig(opt):
    """Scalar hyper-parameters a group's rule bakes in (momentum, betas,
    eps, clip_gradient, the raw ``lr`` ...).  A change -- e.g.
    ``set_learning_rate`` -- rebuilds the groups and any captured step;
    per-step values (counts, rescale, scheduler lr) flow through slots."""
    return tuple(sorted(
        (k, repr(v)) for k, v in vars(opt).items()
        if k not in ("num_update", "rescale_grad", "begin_num_update")
        and isinstance(v, (int, float, bool, str, type(None)))))


def _state_sig(state):
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return str(state.dtype)
    if isinstance(state, (tuple, list)):
        return tuple(_state_sig(s) for s in state)
    return type(state).__name__


def _group_key(trainer, i, param, grad):
    opt = trainer._optimizer
    return (type(opt).__name__, id(opt), str(param.dtype), str(grad.dtype),
            repr(float(getattr(param, "lr_mult", 1.0))),
            repr(float(getattr(param, "wd_mult", 1.0))),
            _state_sig(trainer._states[i]), str(param.device))


def _sparse_grad(g):
    """A gradient the grouped rule cannot take: an
    ``nd.sparse.RowSparseNDArray`` (or a ``torch.sparse`` tensor)."""
    return not isinstance(g, torch.Tensor) or g.layout != torch.strided


def _sparse_param(p):
    return getattr(p, "stype", "default") != "default" \
        or p.layout != torch.strided


def partition(trainer, items):
    """Split ``[(index, param, grad)]`` into groups and eager leftovers.
    Returns ``(groups, eager)``: ``groups`` maps group key -> members
    (insertion-ordered, ascending parameter index), ``eager`` is
    ``[(i, param, grad, reason)]``.

    A parameter listed under several names (``share_parameters``) takes
    one update for each listing, in index order, as the JAX Trainer's
    loop gives it.  No group holds one tensor twice: a parameter's k-th
    listing goes to a group of the k-th round, and every round's groups
    run after the earlier rounds', so one multi-tensor launch never
    updates a buffer from two list entries at once."""
    opt = trainer._optimizer
    if not get_env("MXNET_MULTI_TENSOR", bool, True):
        return {}, [(i, p, g, "disabled") for i, p, g in items]
    if not is_fusable(opt):
        return {}, [(i, p, g, "optimizer") for i, p, g in items]
    rounds, eager, listed = [], [], {}
    for i, param, grad in items:
        if _sparse_grad(grad):
            eager.append((i, param, grad, "row_sparse"))
            continue
        if _sparse_param(param):
            eager.append((i, param, grad, "stype"))
            continue
        k = listed.get(id(param), 0)
        listed[id(param)] = k + 1
        if k == len(rounds):
            rounds.append({})
        key = _group_key(trainer, i, param, grad)
        if k:
            key = key[:-1] + ("listing %d" % (k + 1), key[-1])
        rounds[k].setdefault(key, []).append((i, param, grad))
    groups = {}
    for r in rounds:
        groups.update(r)
    return groups, eager


# ---------------------------------------------------------------------------
# one group
# ---------------------------------------------------------------------------

class _Group:
    """One group's standing parts: member signature, hyper-parameter
    signature and the slot buffer its rule reads."""

    __slots__ = ("key", "indices", "members_sig", "hsig", "slots", "nbytes",
                 "opt_name", "masters")

    def __init__(self, key, indices, members_sig, hsig, nbytes, opt_name,
                 masters):
        self.key = key
        self.indices = indices
        self.members_sig = members_sig
        self.hsig = hsig
        self.nbytes = nbytes
        self.opt_name = opt_name
        self.masters = masters
        self.slots = None


def _members_sig(members):
    return tuple((i, tuple(p.shape), str(p.dtype), tuple(g.shape),
                  str(g.dtype)) for i, p, g in members)


def group_for(trainer, key, members, hsig):
    """The cached ``_Group`` of ``key``, rebuilt when its members or the
    optimizer's hyper-parameters changed."""
    opt = trainer._optimizer
    cache = trainer._mt_groups
    sig = _members_sig(members)
    group = cache.get(key)
    if group is None or group.members_sig != sig or group.hsig != hsig:
        i0, p0, _ = members[0]
        group = _Group(key, tuple(i for i, _, _ in members), sig, hsig,
                       sum(p.numel() * p.element_size()
                           for _, p, _ in members),
                       type(opt).__name__,
                       opt._has_master(p0, trainer._states[i0]))
        cache[key] = group
        if _tel.ENABLED:
            _tel.TRAINER_FUSED_BUILDS.labels(optimizer=group.opt_name).inc()
    return group


def prepare(trainer, group, members):
    """Host half of one group's step: bump the members' update counts and
    fill the slots.  Returns ``[(positions, values)]``: the members split
    by equal host values (one entry when every count agrees), the first
    run's values written into ``group.slots``.  Counts are rewound if it
    fails."""
    opt = trainer._optimizer
    counts = opt._index_update_count
    prev = {i: counts.get(i) for i, _, _ in members}
    prev_num = opt.num_update
    try:
        for i, _, _ in members:
            opt._update_count(i)
        runs = {}
        for pos, (i, _, _) in enumerate(members):
            runs.setdefault(tuple(opt._scalars(i).items()), []).append(pos)
        plan = [(pos, dict(k)) for k, pos in runs.items()]
        group.slots = refill(group.slots, plan[0][1], members[0][1].device)
        return plan
    except Exception:
        rewind(opt, prev, prev_num)
        raise


def rewind(opt, prev_counts, prev_num_update):
    """Undo count bumps: ``prev_counts`` {index: count or None}."""
    counts = opt._index_update_count
    for i, v in prev_counts.items():
        if v is None:
            counts.pop(i, None)
        else:
            counts[i] = v
    opt.num_update = prev_num_update


def run(trainer, group, members, grads, plan=None):
    """Device half: the optimizer's rule over the group's members, with
    ``grads`` (one per member) in place of the members' own; ``plan`` as
    ``prepare`` returned it, or None for one run over every member with
    the group's slots."""
    opt = trainer._optimizer
    states = [trainer._states[i] for i, _, _ in members]
    params = [p for _, p, _ in members]
    if plan is None:
        plan = [(range(len(members)), None)]
    for k, (positions, vals) in enumerate(plan):
        slots = group.slots if k == 0 else Slots(vals, params[0].device)
        opt._apply([params[j] for j in positions],
                   [grads[j] for j in positions],
                   [states[j] for j in positions], slots.values,
                   group.masters)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def apply_updates(trainer, items):
    """Apply one optimizer step over ``items = [(index, param, grad)]``:
    the grouped rule for every eligible group, the per-parameter path for
    the rest.  Called by ``gluon.Trainer._update``.  Returns False when
    the mx.monitor nonfinite sentinel skipped the step whole (no
    parameter, state or update count changed), else True."""
    tel_on = _tel.ENABLED
    t0 = _time.perf_counter() if tel_on else 0.0
    groups, eager = partition(trainer, items)
    hsig = _hparams_sig(trainer._optimizer)
    from .. import monitor as mon

    if mon.core.ENABLED:
        # the step is vetoed here, before any count moves, so a skipped
        # step is the same as never calling step()
        if mon.core.observe_update(trainer, groups, eager) == "skip":
            if tel_on:
                _tel.TRAINER_UPDATE_SECONDS.observe(
                    _time.perf_counter() - t0)
            return False
    for key, members in groups.items():
        group = group_for(trainer, key, members, hsig)
        try:
            plan = prepare(trainer, group, members)
        except Exception:
            # the host half failed before anything moved: this step's
            # members take the per-parameter path
            trainer._mt_groups.pop(key, None)
            _LOGGER.warning("multi-tensor group %s degraded to eager "
                            "updates", key[0], exc_info=True)
            for i, param, grad in members:
                trainer._eager_update(i, param, grad)
                if tel_on:
                    _tel.TRAINER_EAGER_UPDATES.labels(
                        reason="trace-error").inc()
            continue
        with _trace.span("fused_apply", hist=False,
                         args={"optimizer": key[0], "params": len(members)}):
            run(trainer, group, members, [g for _, _, g in members], plan)
        if tel_on:
            _tel.TRAINER_FUSED_APPLY.labels(optimizer=group.opt_name).inc()
    for i, param, grad, reason in eager:
        trainer._eager_update(i, param, grad)
        if tel_on:
            _tel.TRAINER_EAGER_UPDATES.labels(reason=reason).inc()
    if tel_on:
        _tel.TRAINER_FUSED_GROUPS.set(len(groups))
        _tel.TRAINER_UPDATE_SECONDS.observe(_time.perf_counter() - t0)
    return True


def group_table(trainer):
    """One row per live group: optimizer, members, parameter bytes,
    launches of the rule per step (always 1 group apply), the slots in
    use and the device.  ``provenance`` is the JAX package's compile-cache
    provenance, which the port does not have."""
    rows = []
    for group in trainer._mt_groups.values():
        rows.append({
            "optimizer": group.opt_name,
            "params": len(group.indices),
            "bytes": int(group.nbytes),
            "programs_per_step": 1,
            "provenance": "not ported",
            "zero": 0,
            "masters": bool(group.masters),
            "device": group.key[-1],
            "host_scalar_slots": 0 if group.slots is None
            else len(group.slots.names),
        })
    return rows
