"""mx.step: the whole training step as one program.

Counterpart of ``mxnet_tpu/step/capture.py``.  ``capture(net, loss_fn,
trainer=trainer)`` returns a ``StepProgram``; one call of it is one
training step:

- **forward + loss** through the block under ``autograd.record()``;
- **backward** as one ``torch.autograd.grad`` seeded with ones, the
  cotangent ``autograd.backward`` seeds on a loss that is not a scalar;
- the **bucket plan** of the gradients (``kvstore.collective.
  plan_buckets``); in a world of one each bucket's reduction is the
  identity;
- the trainer's **grouped optimizer apply** (``optimizer/multi_tensor``),
  whose per-step values (scheduled lr and wd, ``rescale_grad``, bias
  corrections) come from the groups' slot tensors, written by the host
  before each step, so a new scheduler lr needs no recapture;
- under ``mx.monitor``, the **stat reductions** of each group, and under
  a ``skip_step``/``raise`` sentinel a ``torch.where`` select that keeps
  the old weights and states when a gradient is nonfinite;
- an opt-in **recompute policy** (``MXNET_STEP_REMAT``: ``all`` wraps
  forward + loss in ``torch.utils.checkpoint``, ``blocks`` each direct
  child of the block), the draws of the port's generators replayed in
  the recompute (``random.replayable``).

On the card the step is a CUDA graph (``torch.cuda.CUDAGraph``): the
first call for an input signature runs the step eagerly on a side stream
(this warms up the kernels' build and load, cuDNN's algorithm search and
cuBLAS's workspaces, the deferred-shape probe having run before it); the
second captures the step and replays it, and every later call copies the
batch into the graph's static inputs, writes the slots and replays.  The
port's generator of the card is registered with the graph, so each
replay draws fresh dropout masks and attention-dropout seeds (the flash
kernels read their seed from device memory).  Kernel wrappers count a
launch when the graph is captured, not on a replay.  The returned loss is
a copy of the graph's output.  On the CPU the same step function runs
eagerly on every call, with no graph.

Every capture failure degrades to the stitched path (``autograd.record``
forward, ``autograd.backward``, ``Trainer.step``), counted by reason in
``step_capture_fallback_total`` -- never a lost step; a failure once the
step's update has begun raises instead.  ``MXNET_STEP_CAPTURE=0`` is the
kill switch.

The ``step_capture`` fault site (``mx.resilience``) fires at a program's
build, keyed by the trainer's step count: that signature then runs
stitched, with reason ``injected_fault``.  It fires again at dispatch,
after the update counts are bumped and before the step runs: an injected
fault there, or any failure that carries ``mx_fault_kind``, is re-raised
with the counts rewound, never replayed stitched, so the supervisor owns
the recovery.  With ``mx.obs`` on, both paths note the step's host time
and hand ``obs.attribution`` its parts (stitched: forward, backward,
update; captured: slots, stage, dispatch and, under the monitor,
host_publish).  No synchronize is added for them: they are host times.
``cap.flops`` (the ``flops`` of ``report()``'s programs) is counted once,
by ``torch.utils.flop_counter.FlopCounterMode`` over the program's first
eager pass made with obs on (None until then); the flash kernels are
ctypes launches it does not see.

Not ported: the ZeRO and mesh branches, ``axis_name`` (cross-process
psum), the collective deadline around a multi-process dispatch and the
compile-cache fingerprint.
"""
from __future__ import annotations

import contextlib
import logging
import time as _time

import torch

from .. import autograd
from .. import obs as _obs
from .. import random as _random
from .. import telemetry as _tel
from .. import trace as _trace
from ..base import MXNetError, get_env
from ..kvstore.collective import (default_bucket_bytes, observe_bucket_fill,
                                  plan_buckets)
from ..optimizer import multi_tensor as _mt
from ..resilience import inject as _inject

__all__ = ["StepProgram", "capture", "is_enabled", "CaptureError",
           "remat_mode"]

_LOGGER = logging.getLogger("mxnet_tpu_torch.step")

# index of g_nonfinite in monitor.stats.STAT_FIELDS
_G_NONFINITE = 5

REMAT_MODES = ("off", "all", "blocks")

# eager steps a signature runs on the card before it is captured
WARMUP_STEPS = 1


def is_enabled():
    """The ``MXNET_STEP_CAPTURE`` kill switch (default on), read per call."""
    return get_env("MXNET_STEP_CAPTURE", bool, True)


def remat_mode():
    """The recompute policy (``MXNET_STEP_REMAT``): ``off`` (default),
    ``all`` (one checkpoint around forward + loss) or ``blocks`` (one per
    direct child of the block; a block whose forward writes state drops
    to ``all``)."""
    v = str(get_env("MXNET_STEP_REMAT", str, "off") or "off").lower()
    if v in ("0", "", "none", "false"):
        return "off"
    if v in ("1", "true"):
        return "all"
    if v not in REMAT_MODES:
        raise MXNetError("MXNET_STEP_REMAT=%r is not a remat policy "
                         "(choose from %s)" % (v, "|".join(REMAT_MODES)))
    return v


class CaptureError(MXNetError):
    """Whole-step capture does not apply to this trainer or signature;
    the step runs stitched (``reason`` becomes the telemetry label)."""

    def __init__(self, reason, detail=""):
        super().__init__("step capture unavailable (%s)%s"
                         % (reason, ": " + detail if detail else ""))
        self.reason = reason


def _bucket_allreduce(grads, plan_pos, axis_name):
    """Reduce gradients bucket by bucket.  In a world of one (``axis_name``
    None) the sum over one replica is the gradient itself."""
    if axis_name is not None:
        raise CaptureError("axis_name", "cross-process reduction is not "
                           "ported")
    return list(grads)


def _tensors(state):
    """The tensors of an optimizer state (None, a tensor or nested
    tuples), in order."""
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for s in state for t in _tensors(s)]


def _replaying(fn, log, training):
    """``fn`` as a recompute region: its draws are recorded on the first
    call and replayed on later ones, recording with the training mode of
    the first call (the recompute may run on autograd's own thread), and
    forward state written only the first time."""
    def region(*args):
        replay = bool(log.get("replay"))
        with _random.replayable(log), autograd.record(train_mode=training), \
                autograd.recomputing(replay):
            out = fn(*args)
        log["replay"] = True
        return out

    return region


def _checkpoint(fn, *args):
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


@contextlib.contextmanager
def _remat_block_boundaries(root, training):
    """Scope: each direct child of ``root`` runs as one recompute region
    (``MXNET_STEP_REMAT=blocks``)."""
    from ..gluon.block import Block

    boundaries = {id(c) for c in root.children()}
    orig = Block.__call__

    def remat_call(self, *args, **kwargs):
        if id(self) not in boundaries:
            return orig(self, *args, **kwargs)
        log = {"draws": [], "replay": False}
        return _checkpoint(_replaying(
            lambda *a: orig(self, *a, **kwargs), log, training), *args)

    Block.__call__ = remat_call
    try:
        yield
    finally:
        Block.__call__ = orig


class _Captured:
    """One input signature's whole-step program."""

    def __init__(self, sig):
        self.sig = sig
        self.graph = None       # torch.cuda.CUDAGraph once captured
        self.static_in = None   # the graph's input tensors
        self.static_lbl = None
        self.out = None         # the graph's (loss, stat vectors)
        self.warm = 0           # eager warm-up steps run
        self.replays = 0
        self.mutating = False   # the update of the running step began
        self.flops = None       # counted over the first eager pass
        self.counted = False


class StepProgram:
    """The whole training step as one callable.

    ``program(data, label)`` runs forward, loss, backward, the bucket
    plan, the grouped optimizer apply and the monitor stats -- on the card
    as one CUDA graph per input signature -- and returns the loss.  When
    capture does not apply (kill switch, an optimizer or parameter the
    grouped apply leaves to the per-parameter path, ``grad_req='add'``, a
    capture failure) the same call runs the stitched imperative sequence,
    so the step is never lost."""

    def __init__(self, block, trainer, loss_fn, axis_name=None):
        from ..gluon.block import HybridBlock

        if not isinstance(block, HybridBlock):
            raise MXNetError(
                "mx.step.capture needs a HybridBlock; got %r"
                % type(block).__name__)
        if not callable(loss_fn):
            raise MXNetError("loss_fn must be callable")
        if axis_name is not None:
            raise MXNetError("mx.step.capture: axis_name (a cross-process "
                             "psum) is not ported")
        self._block = block
        self._trainer = trainer
        self._loss_fn = loss_fn
        self._axis_name = axis_name
        self._programs = {}      # sig -> _Captured
        self._dead = {}          # sig -> fallback reason
        self._remat_override = None
        self._fallbacks = []
        self._path_counts = {"captured": 0, "stitched": 0}
        self._skipped = 0
        self._disabled_noted = False
        self._world = 1

    # ---- public surface ------------------------------------------------------
    def __call__(self, data, label=None, batch_size=None):
        datas = tuple(data) if isinstance(data, (list, tuple)) else (data,)
        labels = () if label is None else (
            tuple(label) if isinstance(label, (list, tuple)) else (label,))
        if batch_size is None:
            batch_size = datas[0].shape[0]
        if not is_enabled():
            if not self._disabled_noted:
                self._disabled_noted = True
                self._note_fallback("disabled", "MXNET_STEP_CAPTURE=0")
            return self._stitched(datas, labels, batch_size)
        cap = self._get_program(datas, labels)
        if cap is None:
            return self._stitched(datas, labels, batch_size)
        try:
            return self._run_captured(cap, datas, labels, batch_size)
        except Exception as exc:
            if getattr(exc, "mx_step_no_fallback", False):
                # the step's update began (or ran and was vetoed): a
                # stitched replay would apply it twice
                raise
            if isinstance(exc, (_inject.InjectedFault,
                                _inject.InjectedIOError)) or \
                    getattr(exc, "mx_fault_kind", None) is not None:
                # injected faults and DistTimeout carry resilience
                # semantics: the supervisor owns the recovery, and a
                # stitched replay here would hide the drill or failure
                raise
            self._programs.pop(cap.sig, None)
            if cap.sig[5] == "blocks":
                self._remat_override = "all"
                fall = ("remat_blocks_degraded", repr(exc))
            else:
                self._dead[cap.sig] = getattr(exc, "reason", None) \
                    or "dispatch_error"
                fall = (self._dead[cap.sig], repr(exc))
            _LOGGER.warning("mx.step: captured step failed; it runs "
                            "stitched", exc_info=True)
        self._note_fallback(*fall)
        return self._stitched(datas, labels, batch_size)

    def step(self, data, label=None, batch_size=None):
        """Alias of ``__call__``."""
        return self(data, label=label, batch_size=batch_size)

    def invalidate(self):
        """Drop every captured program; the next step captures anew."""
        self._programs.clear()
        self._dead.clear()

    def gather(self):
        raise MXNetError("StepProgram.gather: mesh placement is not ported")

    def report(self):
        """Per-signature programs (graph or eager, remat, monitor, segments,
        bucket plan, slots), path counts and fallback reasons."""
        return {
            "enabled": is_enabled(),
            "world": self._world,
            "axis_name": self._axis_name,
            "mesh": None,
            "zero": 0,
            "paths": dict(self._path_counts),
            "skipped_steps": self._skipped,
            "programs": [{
                "provenance": "not ported",
                "fingerprint": None,
                "graph": cap.graph is not None,
                "device": str(cap.device),
                "warmup_steps": cap.warm,
                "replays": cap.replays,
                "flops": cap.flops,
                "remat": cap.remat,
                "monitor_fused": cap.monitor,
                "gate": cap.gate,
                "zero": 0,
                "host_scalar_slots": sum(len(g.slots.names)
                                         for g, _ in cap.groups
                                         if g.slots is not None),
                "segments": list(cap.segments),
                "bucket_plan": [list(b) for b in cap.bucket_plan],
                "bucket_bytes": int(cap.bucket_bytes),
                "bucket_bytes_provenance": "default",
            } for cap in self._programs.values()],
            "fallbacks": list(self._fallbacks),
        }

    # ---- stitched path -------------------------------------------------------
    def _device(self):
        return self._trainer._params[0].device

    def _stitched(self, datas, labels, batch_size):
        """The imperative sequence: record forward + loss, backward seeded
        with ones, ``Trainer.step``."""
        self._path_counts["stitched"] += 1
        if _tel.ENABLED:
            _tel.STEP_CAPTURE_STEPS.labels(path="stitched").inc()
        dev = self._device()

        def put(x):
            return None if x is None else torch.as_tensor(x, device=dev)

        parts = _obs.attribution.StepParts(self._trainer._step_count)
        with _trace.span("train_step", hist=False, args={"captured": 0}):
            with _trace.span("forward", hist=False):
                with autograd.record():
                    out = self._block(*map(put, datas))
                    loss = self._loss_fn(out, *map(put, labels))
            parts.mark("forward")
            with _trace.span("backward", hist=False):
                autograd.backward(loss)
            parts.mark("backward")
            self._trainer.step(batch_size)
        parts.mark("update")
        # note_step fired inside Trainer.step; attribution is this path's
        parts.observe()
        return loss.detach()

    def _note_fallback(self, reason, detail=""):
        if _tel.ENABLED:
            _tel.STEP_CAPTURE_FALLBACKS.labels(reason=reason).inc()
        _trace.instant("step_capture_fallback", cat="step",
                       args={"reason": reason})
        self._fallbacks.append({"reason": reason, "detail": str(detail)[:200],
                                "step": self._trainer._step_count})
        del self._fallbacks[:-32]

    # ---- build ---------------------------------------------------------------
    def _sig(self, datas, labels):
        from .. import monitor as _mon
        from ..monitor import sentinel as _sentinel

        mon_on = _mon.core.ENABLED
        gate = mon_on and _sentinel.policy() in _sentinel.SYNC_POLICIES
        remat = self._remat_override or remat_mode()

        def spec(x):
            return None if x is None else (tuple(x.shape), str(x.dtype))

        return (tuple(map(spec, datas)), tuple(map(spec, labels)), mon_on,
                gate, _mt._hparams_sig(self._trainer._optimizer), remat)

    def _get_program(self, datas, labels):
        sig = self._sig(datas, labels)
        if sig in self._dead:
            return None
        cap = self._programs.get(sig)
        if cap is not None:
            return cap
        try:
            with _trace.span("step_capture", hist=False,
                             args={"step": self._trainer._step_count}):
                cap = self._build(sig, datas, labels)
        except Exception as exc:
            reason = getattr(exc, "reason", None) or (
                "injected_fault" if isinstance(
                    exc, (_inject.InjectedFault, _inject.InjectedIOError))
                else "trace_error")
            self._dead[sig] = reason
            if reason == "trace_error" and sig[5] == "blocks":
                self._remat_override = "all"
                reason = "remat_blocks_degraded"
            self._note_fallback(reason, repr(exc))
            _LOGGER.warning("mx.step: capture failed (%s); this signature "
                            "runs stitched", reason, exc_info=True)
            return None
        self._programs[sig] = cap
        return cap

    def _build(self, sig, datas, labels):
        from ..monitor.core import _group_label

        trainer = self._trainer
        # mx.resilience drill site: a planned fault here poisons the
        # capture; the signature degrades to the stitched path
        _inject.fire("step_capture", seq=trainer._step_count)
        opt = trainer._optimizer
        block = self._block
        named = block.collect_params()
        if any(getattr(p, "_needs_shape", lambda: False)()
               for p in named.values()):
            # the deferred-shape probe, before anything is captured
            dev = self._device()
            with autograd.pause():
                block(*(None if x is None else torch.as_tensor(x, device=dev)
                        for x in datas))
        items = []
        for i, p in enumerate(trainer._params):
            req = getattr(p, "grad_req", "write")
            if req == "null":
                continue
            if req == "add":
                raise CaptureError("grad_req_add",
                                   "parameter %s accumulates gradients"
                                   % (trainer._param_names[i],))
            if getattr(p, "grad_stype", "default") == "row_sparse" and \
                    getattr(trainer._optimizer, "lazy_update", False):
                # the lazy update's rows depend on the batch's ids
                raise CaptureError("row_sparse",
                                   "parameter %s has a row_sparse gradient"
                                   % (trainer._param_names[i],))
            trainer._maybe_init_states(i, p)
            items.append((i, p, p))   # gradients take the parameter's form
        if not items:
            raise CaptureError("no_trainable_params")
        groups, eager = _mt.partition(trainer, items)
        if eager:
            raise CaptureError("eager_members", eager[0][3])
        name_of = {}
        for n, p in named.items():
            name_of.setdefault(id(p), n)
        missing = [i for i, p, _ in items if id(p) not in name_of]
        if missing:
            raise CaptureError("params_not_in_block",
                               "trainer indices %s" % missing[:5])
        devices = {p.device for _, p, _ in items}
        if len(devices) != 1:
            raise CaptureError("devices", "parameters on %s"
                               % sorted(map(str, devices)))
        remat = sig[5]
        if remat == "blocks" and any(
                getattr(p, "grad_req", "write") == "null"
                for p in named.values()):
            # a child's forward writes state (BatchNorm's running
            # statistics): no per-block recompute for it
            raise CaptureError("trace_error", "remat=blocks with forward "
                               "state")

        cap = _Captured(sig)
        cap.device = devices.pop()
        cap.cuda = cap.device.type == "cuda"
        cap.remat = remat
        cap.monitor, cap.gate = bool(sig[2]), bool(sig[3])
        cap.train_idx = tuple(i for i, _, _ in items)
        cap.params = [p for _, p, _ in items]
        pos_of = {i: j for j, i in enumerate(cap.train_idx)}
        hsig = _mt._hparams_sig(opt)
        cap.groups = []
        cap.labels = []
        cap.positions = []
        for key, members in groups.items():
            cap.groups.append((_mt.group_for(trainer, key, members, hsig),
                               members))
            cap.labels.append(_group_label(trainer, key, members))
            cap.positions.append([pos_of[i] for i, _, _ in members])
        sizes = [(p.numel() * p.element_size(), str(p.dtype))
                 for p in cap.params]
        cap.bucket_bytes = default_bucket_bytes()
        cap.bucket_plan = plan_buckets(sizes, bucket_bytes=cap.bucket_bytes)
        cap.plan_pos = [list(b) for b in cap.bucket_plan]
        cap.bucket_nbytes = [sum(sizes[j][0] for j in b)
                             for b in cap.bucket_plan]
        cap.segments = [
            {"segment": "forward", "params": len(named), "remat": remat},
            {"segment": "loss", "fn": type(self._loss_fn).__name__},
            {"segment": "backward", "grads": len(items)},
            {"segment": "allreduce", "buckets": len(cap.bucket_plan),
             "world": self._world, "bytes": int(sum(cap.bucket_nbytes)),
             "collective": "all_reduce", "axis": self._axis_name}]
        if cap.monitor:
            cap.segments.append({"segment": "stats",
                                 "groups": len(cap.groups)})
        cap.segments.append({"segment": "apply", "groups": len(cap.groups),
                             "optimizer": type(opt).__name__})
        if cap.gate:
            cap.segments.append({"segment": "gate",
                                 "policy": "sync-sentinel"})
        if cap.cuda:
            if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
                raise CaptureError("generator", "this torch cannot register "
                                   "a generator with a CUDA graph")

            def static(x):
                if x is None:
                    return None
                x = torch.as_tensor(x)
                return torch.empty(x.shape, dtype=x.dtype, device=cap.device)

            cap.static_in = [static(x) for x in datas]
            cap.static_lbl = [static(y) for y in labels]
        if _tel.ENABLED:
            _tel.STEP_CAPTURE_BUILDS.inc()
        return cap

    # ---- the step ------------------------------------------------------------
    def _forward_loss(self, cap, xs, ys):
        block, loss_fn = self._block, self._loss_fn

        def fwd(*args):
            out = block(*args[:len(xs)])
            return loss_fn(out, *args[len(xs):])

        training = autograd.is_training()
        if cap.remat == "all":
            log = {"draws": [], "replay": False}
            return _checkpoint(_replaying(fwd, log, training), *xs, *ys)
        ctx = _remat_block_boundaries(block, training) \
            if cap.remat == "blocks" else contextlib.nullcontext()
        with ctx:
            return fwd(*xs, *ys)

    def _step_fn(self, cap, xs, ys, capturing):
        """The device half of one step: forward, loss, gradients, stats,
        the grouped apply and the gate.  -> (loss, stat vectors)."""
        from ..monitor import stats as _mstats

        trainer = self._trainer
        with autograd.record():
            loss = self._forward_loss(cap, xs, ys)
        if not isinstance(loss, torch.Tensor):
            raise CaptureError("loss_not_tensor", type(loss).__name__)
        grads = torch.autograd.grad(loss, cap.params,
                                    grad_outputs=torch.ones_like(loss),
                                    allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p)
                 for g, p in zip(grads, cap.params)]
        grads = _bucket_allreduce(grads, cap.plan_pos, self._axis_name)
        statvecs = []
        with torch.no_grad():
            if cap.monitor:
                for (_, members), pos in zip(cap.groups, cap.positions):
                    statvecs.append(_mstats.group_stats(
                        [p for _, p, _ in members], [grads[j] for j in pos]))
            keep = backup = ok = None
            if cap.gate:
                ok = torch.stack([v[_G_NONFINITE]
                                  for v in statvecs]).sum() == 0
                keep = list(cap.params) + [
                    t for i in cap.train_idx
                    for t in _tensors(trainer._states[i])]
                backup = [t.clone() for t in keep]
            cap.mutating = not capturing
            for (group, members), pos in zip(cap.groups, cap.positions):
                _mt.run(trainer, group, members, [grads[j] for j in pos])
            if cap.gate:
                # the sentinel's skip on the device: a nonfinite gradient
                # selects the old values back, as if no update ran
                for t, b in zip(keep, backup):
                    t.copy_(torch.where(ok, t, b))
        return loss.detach(), statvecs

    def _stage(self, cap, datas, labels):
        """The tensors the step reads: on the card the graph's static
        inputs, refilled with this batch; on the CPU the batch itself."""
        if not cap.cuda:
            def put(x):
                return None if x is None else torch.as_tensor(
                    x, device=cap.device)

            return [put(x) for x in datas], [put(y) for y in labels]
        for dst, src in zip(cap.static_in + cap.static_lbl,
                            list(datas) + list(labels)):
            if dst is not None:
                dst.copy_(torch.as_tensor(src), non_blocking=False)
        return cap.static_in, cap.static_lbl

    def _prepare(self, cap):
        """Host half: bump the update counts and write every group's
        slots.  Raises ``CaptureError`` (counts rewound) when a group's
        members stopped sharing their host values."""
        trainer = self._trainer
        for group, members in cap.groups:
            plan = _mt.prepare(trainer, group, members)
            if len(plan) != 1:
                raise CaptureError("scalars_diverged", group.opt_name)

    def _eager_step(self, cap, xs, ys):
        """One eager pass of the step; the first one of a program made
        with obs on is counted by ``FlopCounterMode`` into ``cap.flops``
        (the flash kernels' ctypes launches are invisible to it), since
        only obs' attribution reads it."""
        if cap.counted or not _obs.core.ENABLED:
            return self._step_fn(cap, xs, ys, False)
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        with counter:
            out = self._step_fn(cap, xs, ys, False)
        cap.counted = True
        cap.flops = float(counter.get_total_flops()) or None
        return out

    def _capture(self, cap):
        """Capture the step into a CUDA graph (nothing runs on the card);
        the port's generator of the card joins the graph, so each replay
        draws anew."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(_random.generator(cap.device))
        with _mt.capturing(), torch.cuda.graph(graph):
            out = self._step_fn(cap, cap.static_in, cap.static_lbl, True)
        cap.graph, cap.out = graph, out

    def _run_captured(self, cap, datas, labels, batch_size):
        from .. import monitor as _mon

        trainer = self._trainer
        opt = trainer._optimizer
        step = trainer._step_count
        obs_on = _obs.core.ENABLED
        t0 = _time.perf_counter() if (_tel.ENABLED or obs_on) else 0.0
        marks = [0.0] * 5   # obs phase marks: slots/stage/dispatch/publish
        opt.rescale_grad = trainer._scale / batch_size
        counts = opt._index_update_count
        prev = {i: counts.get(i) for i in cap.train_idx}
        prev_num = opt.num_update
        cap.mutating = False
        with _trace.span("train_step", hist=False, anomaly=True,
                         args={"step": step, "captured": 1}), \
                _trace.watchdog.watch("train_step"):
            try:
                if obs_on:
                    marks[0] = _time.perf_counter()
                with _trace.span("step_slots", hist=False):
                    self._prepare(cap)
                # mx.resilience drill site, after the count bump: a fault
                # here exercises the rewind and the supervisor's restore
                _inject.fire("step_capture", seq=step)
                if obs_on:
                    marks[1] = _time.perf_counter()
                xs, ys = self._stage(cap, datas, labels)
                if obs_on:
                    marks[2] = _time.perf_counter()
                with _trace.span("step_dispatch", hist=False,
                                 args={"groups": len(cap.groups),
                                       "buckets": len(cap.bucket_plan)}):
                    if not cap.cuda:
                        loss, statvecs = self._eager_step(cap, xs, ys)
                    elif cap.warm < WARMUP_STEPS:
                        side = torch.cuda.Stream(cap.device)
                        side.wait_stream(
                            torch.cuda.current_stream(cap.device))
                        with torch.cuda.stream(side):
                            loss, statvecs = self._eager_step(cap, xs, ys)
                        torch.cuda.current_stream(cap.device).wait_stream(
                            side)
                        cap.warm += 1
                    else:
                        if cap.graph is None:
                            self._capture(cap)
                        cap.mutating = True
                        cap.graph.replay()
                        cap.replays += 1
                        loss, statvecs = cap.out
                if obs_on:
                    marks[3] = _time.perf_counter()
            except Exception as exc:
                if cap.mutating:
                    exc.mx_step_no_fallback = True
                else:
                    _mt.rewind(opt, prev, prev_num)
                raise
            # the update ran (or was gated to a no-op): errors from here on
            # must not send the step through the stitched path again
            try:
                applied = True
                if cap.monitor:
                    with _trace.span("step_publish", hist=False):
                        try:
                            verdict = _mon.core.observe_captured(
                                trainer, step,
                                list(zip(cap.labels, statvecs)))
                        except MXNetError:
                            _mt.rewind(opt, prev, prev_num)
                            raise
                    if obs_on:
                        marks[4] = _time.perf_counter()
                    if verdict == "skip":
                        _mt.rewind(opt, prev, prev_num)
                        self._skipped += 1
                        applied = False
                if applied:
                    trainer._step_count += 1
                self._path_counts["captured"] += 1
                if self._world > 1:
                    observe_bucket_fill(cap.bucket_nbytes, op="allreduce",
                                        bucket_bytes=cap.bucket_bytes)
                if _tel.ENABLED:
                    _tel.STEP_CAPTURE_STEPS.labels(path="captured").inc()
                    _tel.STEP_PROGRAM_SECONDS.observe(
                        _time.perf_counter() - t0)
                if obs_on:
                    self._observe(cap, step, t0, marks)
                return loss.clone()
            except Exception as exc:
                exc.mx_step_no_fallback = True
                raise

    @staticmethod
    def _observe(cap, step, t0, marks):
        """The captured step's cadence and attribution (host times; never
        raises into the step)."""
        try:
            total = _time.perf_counter() - t0
            parts = {"slots": marks[1] - marks[0],
                     "stage": marks[2] - marks[1],
                     "dispatch": marks[3] - marks[2]}
            if marks[4]:
                parts["host_publish"] = marks[4] - marks[3]
            _obs.core.note_step(total)
            _obs.attribution.observe_step(step, total, parts=parts,
                                          flops=cap.flops, path="captured")
        except Exception:  # noqa: BLE001 - obs never raises into the step
            pass


def capture(block_or_trainer, loss_fn, trainer=None, block=None,
            axis_name=None):
    """The whole training step -- ``block`` forward, ``loss_fn``, backward,
    the bucket plan, the trainer's grouped apply and the monitor stats --
    as one ``StepProgram`` (a CUDA graph on the card).

    Takes the block or the trainer first (``capture(net, loss_fn,
    trainer=t)`` or ``capture(t, loss_fn, block=net)``); both are needed.
    Each call of the program runs one step (``program(data, label)`` ->
    loss) and takes the stitched imperative path whenever capture does
    not apply.  The program registers with the trainer, which drops its
    captured graphs when the trainer's state is replaced."""
    from ..gluon.trainer import Trainer

    obj = block_or_trainer
    if isinstance(obj, Trainer):
        if trainer is not None and trainer is not obj:
            raise MXNetError("capture: two different trainers supplied")
        trainer = obj
    else:
        if block is not None and block is not obj:
            raise MXNetError("capture: two different blocks supplied")
        block = obj
    if trainer is None:
        raise MXNetError(
            "mx.step.capture needs the gluon.Trainer that owns the "
            "parameters: capture(net, loss_fn, trainer=trainer)")
    if block is None:
        raise MXNetError(
            "mx.step.capture needs the block to capture: "
            "capture(trainer, loss_fn, block=net)")
    prog = StepProgram(block, trainer, loss_fn, axis_name=axis_name)
    register = getattr(trainer, "_register_step_program", None)
    if register is not None:
        register(prog)
    return prog
