"""Optimizers: ``Optimizer`` (rescale, clip, lr/wd with per-parameter
multipliers, per-index update counts), ``SGD``, ``NAG``, ``Adam`` and
``AdamW``, with ``register``/``create``.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py`` (the dense branches).
``update(index, weight, grad, state)`` changes ``weight`` and ``state`` in
place under ``torch.no_grad()``: the JAX package returns new arrays, the
port reuses the parameter's and the state's memory.  The arithmetic runs
in fp32; a bf16 weight is updated through an fp32 copy.  One update runs
per parameter (the fused multi-tensor apply is not ported yet).
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "create", "register", "SGD", "NAG", "Adam",
           "AdamW"]

_OPT_REGISTRY = {}


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    key = name.lower()
    if key not in _OPT_REGISTRY:
        raise MXNetError("unknown optimizer %r (have %s)"
                         % (name, sorted(_OPT_REGISTRY)))
    return _OPT_REGISTRY[key](**kwargs)


class Optimizer:
    """Base optimizer: hyper-parameters and their per-parameter scaling."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False,
                 param_dict=None):
        if lr_scheduler is not None or multi_precision:
            raise MXNetError("lr_scheduler and multi_precision are not "
                             "ported yet")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index, self.begin_num_update)
        self._index_update_count[index] = count + 1
        self.num_update = max(self.num_update, count + 1)

    def _mult(self, index, attr, table):
        param = self.param_dict.get(index)
        if param is not None:
            return getattr(param, attr, 1.0)
        return table.get(self.idx2name.get(index, index), 1.0)

    def _get_lr(self, index):
        return self.lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    def _preprocess_grad(self, grad):
        g = grad.float() * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        """Apply one step to ``weight`` in place; ``state`` as made by
        ``create_state``."""
        self._update_count(index)
        with torch.no_grad():
            w = weight if weight.dtype == torch.float32 else weight.float()
            self._step(index, w, self._preprocess_grad(grad), state)
            if w is not weight:
                weight.copy_(w)

    def _step(self, index, w, g, state):
        """Update fp32 ``w`` in place from the preprocessed grad ``g``."""
        raise NotImplementedError

    def __repr__(self):
        return "%s(lr=%s, wd=%s)" % (type(self).__name__, self.lr, self.wd)


def _zeros_like(weight):
    return torch.zeros(weight.shape, dtype=torch.float32,
                       device=weight.device)


@register
class SGD(Optimizer):
    """SGD with momentum: mom = momentum*mom - lr*(g + wd*w); w += mom."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def _step(self, index, w, g, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = g.add_(w, alpha=wd) if wd else g
        if state is None:
            w.add_(g, alpha=-lr)
            return
        state.mul_(self.momentum).add_(g, alpha=-lr)
        w.add_(state)


@register
class NAG(SGD):
    """Nesterov momentum: w += momentum*mom - lr*g, mom as SGD's."""

    def _step(self, index, w, g, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = g.add_(w, alpha=wd) if wd else g
        if state is None:
            w.add_(g, alpha=-lr)
            return
        state.mul_(self.momentum).add_(g, alpha=-lr)
        w.add_(state, alpha=self.momentum).add_(g, alpha=-lr)


@register
class Adam(Optimizer):
    """Adam with bias correction; weight decay added to the gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _moments(self, index, g, state):
        """Update (m, v) in place; returns the bias-corrected m and v."""
        t = self._index_update_count[index]
        m, v = state
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        return m / (1 - self.beta1 ** t), v / (1 - self.beta2 ** t)

    def _step(self, index, w, g, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = g.add_(w, alpha=wd) if wd else g
        mhat, vhat = self._moments(index, g, state)
        w.sub_(lr * mhat / (vhat.sqrt_() + self.epsilon))


@register
class AdamW(Adam):
    """Adam with decoupled weight decay: w -= lr*(step + wd*w)."""

    def _step(self, index, w, g, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        mhat, vhat = self._moments(index, g, state)
        w.sub_(lr * (mhat / (vhat.sqrt_() + self.epsilon) + wd * w))
