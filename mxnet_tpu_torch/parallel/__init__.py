"""Fused training on one card: ``FusedTrainer``.

Counterpart of ``mxnet_tpu/parallel/__init__.py``'s ``FusedTrainer``,
``make_train_step`` and their helpers, on one device.  The JAX package
compiles forward, backward and update into one XLA program over a mesh;
here a step is eager PyTorch: the forward and the loss under
``autograd.record()``, ``torch.autograd.grad`` for the gradients, and one
multi-tensor update (``parallel.optim``, ``torch._foreach_*``) over all the
trainable parameters.

Mixed precision (``dtype='bfloat16'`` or ``'float16'``): the block's own
float32 ``Parameter``s are the master weights.  Each step makes compute
copies in ``dtype`` of every float32 parameter except the normalisation
ones (``contrib.amp.FP32_PARAM_SUFFIXES``), casts the floating inputs
alike, and runs the block through ``torch.func.functional_call`` on the
copies; the gradients reach the masters through the casts, and the update
runs in f32.  Where a product meets operands of two dtypes, ``ops.nn``
follows the JAX package's rules (a bf16 side takes both to bf16; f32 x
fp16 promotes to f32), so in bf16 every dense layer and the attention run
in bf16 while the residual stream stays f32, and in fp16 they run in f32
on fp16-rounded weights, as in the JAX package.

State that is not trained (``grad_req='null'``: BatchNorm's running
mean and variance) is left out of the update and stays float32 under
mixed precision; the step's forward writes it in place (``BatchNorm``
in training mode), so with ``grad_accum=k`` it threads through the k
microbatches in order, as the JAX package's scan carries it.  A block
with parameters of deferred shape is probed once with the first batch,
outside autograd and in predict mode, before the optimizer state is
built.

``state_dict()`` is the JAX package's tree, ``{"params": {name: tensor},
"opt_state": {name: state}, "step": uint32}``, each trainable parameter's
state by its name: ``(mean, var)`` for adam, adamw and lamb, the momentum
for sgd and nag (nothing without momentum).  ``save_checkpoint`` writes it
as one ``mx.checkpoint`` step (``block=False`` returns a ``SaveFuture``
once the snapshot is taken) and ``load_checkpoint`` restores a step of
either package.  A parameter held under several names is trained once,
under its first name.

Not ported (they raise): ``mesh=`` and ``zero=`` (multi-device training),
``PipelineTrainer`` and ``moe_apply``.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .. import autograd
from ..base import MXNetError
from ..checkpoint import cached_manager
from ..contrib.amp import keeps_fp32
from ..ops import registry as _registry
from .optim import make_optimizer

__all__ = ["FusedTrainer", "make_train_step", "make_optimizer",
           "PipelineTrainer", "moe_apply"]

_DTYPES = {None: None, "float32": None, "fp32": None,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           torch.bfloat16: torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           torch.float16: torch.float16}


def _not_ported(what):
    return MXNetError("parallel: %s is not ported" % what)


class FusedTrainer:
    """One-call training steps on one card.

    Usage::

        trainer = parallel.FusedTrainer(
            net, loss_fn=loss, optimizer="adam",
            optimizer_params={"learning_rate": 1e-4}, dtype="bfloat16")
        loss = trainer.step(x, y)      # x, y: a tensor or a tuple of them

    ``loss_fn(outputs, *labels)`` receives every output of the block as a
    list and every label; without one, ``loss`` names a built-in loss
    (``'softmax_ce'``, ``'l2'`` or a callable ``loss(output, label)``) on
    the first output.  The step's loss is the mean of what the loss
    returns.  The parameters update in place on their device."""

    def __init__(self, block, loss=None, optimizer="sgd",
                 optimizer_params=None, mesh=None, loss_fn=None,
                 batch_axes=("dp",), dtype=None, grad_accum=1, zero=False):
        if mesh is not None or zero:
            raise _not_ported("multi-device training (mesh=, zero=)")
        try:
            self._dtype = _DTYPES[dtype]
        except (KeyError, TypeError):
            raise MXNetError("unsupported FusedTrainer dtype %r"
                             % (dtype,)) from None
        if grad_accum < 1:
            raise MXNetError("grad_accum must be >= 1, got %r" % grad_accum)
        self._block = block
        self._grad_accum = int(grad_accum)
        optimizer_params = dict(optimizer_params or {})
        self._lr, self._lr_scheduler = _pop_lr_schedule(optimizer_params)
        self._opt_init, self._opt_update = make_optimizer(
            optimizer, learning_rate=self._lr, **optimizer_params)
        self._user_loss = loss_fn is not None
        self._loss_fn = loss_fn or _make_loss(loss)
        self._named = None        # {name: Parameter}, set at the first step
        self._opt_state = None
        self._pending_state = None
        self._step_count = 0

    # -- set-up -------------------------------------------------------------
    def _setup(self, xs):
        block = self._block
        if any(p._needs_shape() for p in block.collect_params().values()):
            with autograd.pause():
                block(*xs)
        named = OrderedDict()
        for n, p in block.collect_params().items():
            if all(p is not q for q in named.values()):
                named[n] = p       # a shared parameter once, first name
        self._named = named
        self._trainable = [n for n, p in named.items()
                           if p.grad_req != "null"]
        self._cast = {n for n, p in named.items()
                      if self._dtype is not None
                      and p.dtype == torch.float32 and not keeps_fp32(n)}
        with torch.no_grad():
            self._opt_state = self._opt_init(self._masters())
        if self._pending_state is not None:
            state, self._pending_state = self._pending_state, None
            self._apply_state(state)

    def _masters(self):
        return [self._named[n] for n in self._trainable]

    def _device(self):
        named = self._named or self._block.collect_params()
        return next(iter(named.values())).device

    # -- one step -----------------------------------------------------------
    def _forward_loss(self, xs, ys):
        """The mean loss of one (micro)batch, recorded for autograd."""
        with autograd.record():
            if self._dtype is None:
                outs = self._block(*xs)
            else:
                dt = self._dtype
                copies = {n: (p.to(dt) if n in self._cast else p)
                          for n, p in self._named.items()}
                xs = tuple(x.to(dt) if x.is_floating_point() else x
                           for x in xs)
                outs = torch.func.functional_call(self._block, copies, xs)
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
            if self._user_loss:
                loss = self._loss_fn(outs, *ys)
            else:
                if len(ys) > 1:
                    raise MXNetError(
                        "built-in losses take ONE label array; pass a "
                        "custom loss_fn(outputs, *labels) for multi-label "
                        "training (got %d label arrays)" % len(ys))
                loss = self._loss_fn(outs[0], ys[0])
            return loss.mean()

    def _loss_and_grads(self, xs, ys):
        masters = self._masters()
        loss = self._forward_loss(xs, ys)
        grads = torch.autograd.grad(loss, masters, allow_unused=True)
        # a parameter the loss does not reach: a zero gradient, as JAX's
        return loss.detach(), [g if g is not None else torch.zeros_like(p)
                               for g, p in zip(grads, masters)]

    def step(self, x, y):
        """One training step: forward, loss, gradients (over
        ``grad_accum`` microbatches) and the update.  ``x``/``y`` may each
        be one tensor (or NDArray, or array) or a tuple; every leading dim
        is the batch.  Returns the loss, a 0-d tensor.  The
        ``trainer_step`` fault site fires first, before anything is
        launched, so a faulted step leaves the weights and the optimizer
        state untouched and a restore-and-replay is exact."""
        from ..resilience import inject as _inject

        _inject.fire("trainer_step", seq=self._step_count)
        device = self._device()
        NDArray = _registry.NDArray

        def as_tensor(v):
            if NDArray is not None and isinstance(v, NDArray):
                v = v._data
            return torch.as_tensor(v, device=device)

        xs = tuple(map(as_tensor, x)) if isinstance(x, (tuple, list)) \
            else (as_tensor(x),)
        ys = tuple(map(as_tensor, y)) if isinstance(y, (tuple, list)) \
            else (as_tensor(y),)
        if self._named is None:
            self._setup(xs)
        k = self._grad_accum
        if k == 1:
            loss, grads = self._loss_and_grads(xs, ys)
        else:
            n = xs[0].shape[0]
            if n % k:
                raise MXNetError("batch size %d not divisible by "
                                 "grad_accum=%d" % (n, k))
            mb = n // k
            loss, grads = 0.0, None
            for i in range(k):
                part = slice(i * mb, (i + 1) * mb)
                li, gi = self._loss_and_grads(
                    tuple(v[part] for v in xs), tuple(v[part] for v in ys))
                loss = loss + li
                if grads is None:
                    grads = gi
                else:
                    torch._foreach_add_(grads, gi)
            loss = loss / k
            torch._foreach_div_(grads, float(k))
        # the reference's update count starts at 1 (optimizer.py:100)
        lr = (self._lr_scheduler(self._step_count + 1)
              if self._lr_scheduler is not None else self._lr)
        self._opt_update(self._step_count, self._masters(), grads,
                         self._opt_state, lr)
        self._step_count += 1
        return loss

    # -- state --------------------------------------------------------------
    def sync_block(self):
        """Write the trained weights back into the block.  The block's own
        parameters are the master weights here, updated in place each
        step, so there is nothing to write."""

    @property
    def params(self):
        """{name: tensor} of the block's weights (None before the first
        step, as in the JAX package)."""
        if self._named is None:
            return None
        return {n: p.detach() for n, p in self._named.items()}

    # the port's list-of-tensors state (``parallel.optim``) against the JAX
    # package's {name: state}: these keys, in this order, per name
    _STATE_KEYS = (("mean", "var"), ("mom",))

    def _state_by_name(self):
        for keys in self._STATE_KEYS:
            if keys[0] in self._opt_state:
                if len(keys) == 1:
                    return {n: t for n, t in zip(self._trainable,
                                                 self._opt_state[keys[0]])}
                return {n: tuple(self._opt_state[k][i] for k in keys)
                        for i, n in enumerate(self._trainable)}
        return {}

    def state_dict(self):
        """The whole training state, the JAX package's tree (``params``,
        ``opt_state`` by parameter name, ``step`` as uint32), copied in
        memory; None before the first step."""
        if self._named is None:
            return None

        def copy(v):
            if isinstance(v, tuple):
                return tuple(t.detach().clone() for t in v)
            return v.detach().clone()

        return {"params": {n: p.detach().clone()
                           for n, p in self._named.items()},
                "opt_state": {n: copy(v)
                              for n, v in self._state_by_name().items()},
                "step": np.uint32(self._step_count)}

    def load_state_dict(self, state):
        """Restore a ``state_dict`` (of either package: leaves tensors,
        NDArrays or numpy arrays).  Before the first step the state is
        kept and applied once the trainer is set up, so the set-up's fresh
        optimizer state does not overwrite it."""
        if self._named is None:
            self._pending_state = state
            return
        self._apply_state(state)

    def _apply_state(self, state):
        def value(v):
            v = getattr(v, "_data", v)
            return torch.as_tensor(np.asarray(v)) \
                if not isinstance(v, torch.Tensor) else v

        names = set(self._named)
        # a stateless rule (sgd without momentum) keeps no state a name
        by_name = self._state_by_name()
        extra = sorted(set(state["params"]) - names)
        missing = sorted(set(by_name) - set(state["opt_state"]))
        if extra or missing:
            raise MXNetError(
                "FusedTrainer state does not fit this block: unknown "
                "parameters %s, no optimizer state for %s" % (extra,
                                                              missing))

        with torch.no_grad():
            for n, v in state["params"].items():
                self._named[n].copy_(value(v))
            for n, dst in by_name.items():
                src = state["opt_state"][n]
                if isinstance(dst, tuple):
                    for d, t in zip(dst, src):
                        d.copy_(value(t))
                else:
                    dst.copy_(value(src))
        self._step_count = int(value(state["step"]))

    def save_checkpoint(self, root, step=None, block=True, manager=None,
                        **manager_kwargs):
        """Save the training state (``state_dict()``'s tree, not copied
        first: the snapshot is the copy) as one ``mx.checkpoint`` step.
        ``block=False`` returns a ``SaveFuture`` once the device->host
        snapshot is taken, while the background writer commits; the next
        step cannot reach the snapshot's bytes.  ``manager`` shares one
        ``CheckpointManager``; otherwise one is cached per root."""
        if self._named is None:
            raise MXNetError(
                "save_checkpoint before the first step: the trainer has "
                "no state yet")
        tree = {"params": dict(self._named),
                "opt_state": self._state_by_name(),
                "step": np.uint32(self._step_count)}
        mgr = manager or cached_manager(self, root, **manager_kwargs)
        step = self._step_count if step is None else int(step)
        fut = mgr.save_async(step, tree)
        return fut.result() if block else fut

    def load_checkpoint(self, root, step=None, manager=None):
        """Restore a ``save_checkpoint`` step of either package (default:
        the latest) onto the block's device.  Before the first step the
        state is applied at set-up.  Returns the restored step."""
        mgr = manager or cached_manager(self, root)
        step, state = mgr.restore(step=step, ctx=self._device())
        self.load_state_dict(state)
        return step


def _pop_lr_schedule(optimizer_params):
    """(lr, scheduler) out of ``optimizer_params``.  As in the reference
    optimizer (optimizer.py:65), an explicit ``learning_rate`` re-bases the
    scheduler; a defaulted one leaves the scheduler's own base_lr."""
    explicit = "learning_rate" in optimizer_params
    lr = optimizer_params.pop("learning_rate", 0.01)
    scheduler = optimizer_params.pop("lr_scheduler", None)
    if scheduler is not None and explicit and hasattr(scheduler, "base_lr"):
        scheduler.base_lr = lr
    return lr, scheduler


def _make_loss(loss):
    """A built-in loss ``fn(pred, label)`` per example, computed in f32
    whatever the compute dtype."""
    if loss in (None, "softmax_ce", "softmax_cross_entropy"):
        def fn(pred, label):
            logp = torch.log_softmax(pred.float(), dim=-1)
            return -torch.gather(logp, -1,
                                 label.long().unsqueeze(-1)).squeeze(-1)

        return fn
    if loss == "l2":
        return lambda pred, label: 0.5 * torch.square(pred.float()
                                                      - label.float())
    if callable(loss):
        return loss
    raise MXNetError("unknown fused loss %r" % (loss,))


def make_train_step(block, loss="softmax_ce", optimizer="sgd",
                    optimizer_params=None, mesh=None, **kwargs):
    return FusedTrainer(block, loss=loss, optimizer=optimizer,
                        optimizer_params=optimizer_params, mesh=mesh,
                        **kwargs)


def PipelineTrainer(*args, **kwargs):  # noqa: N802 (the JAX class's name)
    raise _not_ported("PipelineTrainer (pipeline parallelism)")


def moe_apply(*args, **kwargs):
    raise _not_ported("moe_apply (expert parallelism)")

