"""Optimizers: the ``Optimizer`` base (rescale, clip, lr/wd with
per-parameter multipliers, an ``lr_scheduler``, per-index update counts,
``multi_precision`` f32 masters), eighteen update rules, ``Updater`` and
``register``/``create``.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py`` (the dense branches).
Each rule is written once, over lists of tensors, with ``torch._foreach_*``
ops (``_rule``).  The per-parameter ``update(index, weight, grad, state)``
runs it on one-element lists; the imperative ``gluon.Trainer`` runs it on
a whole parameter group at once (``optimizer/multi_tensor.py``), so the
two paths run the same operations in the same order and cannot drift
apart.  Weights and states change in place under ``torch.no_grad()``: the
JAX package returns new arrays, the port reuses their memory.

Per-step host values (the scheduled lr, wd, ``rescale_grad``, Adam's bias
corrections, ...) come from ``_scalars(index)``, evaluated in float64 on
the host after the update count moved, and reach the rule as 0-dim
float32 tensors on the weights' device (``multi_tensor.Slots``): the one
float64 -> float32 rounding the JAX package's Python scalar takes where it
meets an array.  Constants (momentum, betas, eps) stay Python numbers.
The arithmetic runs in float32: a 16-bit weight updates through an f32
copy, or, with ``multi_precision``, through the f32 master its state
carries.  
A row_sparse gradient (``nd.sparse.RowSparseNDArray``, which
``gluon.Trainer`` makes for a ``grad_stype='row_sparse'`` parameter)
takes the lazy update of SGD and Adam when ``lazy_update`` is set (and of
their subclasses that keep the rule, ``LBSGD``): repeated indices summed,
only the stored rows of the weight and of its state change, with Python
scalars as the JAX rule has them.  Every other rule takes it densified.
"""
from __future__ import annotations

import math
import pickle

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "create", "register", "SGD", "NAG", "Adam", "AdamW",
           "Adamax", "Nadam", "LAMB", "LANS", "LARS", "Ftrl", "FTML",
           "AdaGrad", "AdaDelta", "RMSProp", "SGLD", "Signum", "DCASGD",
           "LBSGD", "Test", "Updater", "get_updater"]

_OPT_REGISTRY = {}
_f32 = torch.float32
_LOW = (torch.float16, torch.bfloat16)

# torch._foreach_* shorthands: each works on a whole list of tensors
_mul, _mul_ = torch._foreach_mul, torch._foreach_mul_
_div, _div_ = torch._foreach_div, torch._foreach_div_
_add, _add_ = torch._foreach_add, torch._foreach_add_
_sub, _sub_ = torch._foreach_sub, torch._foreach_sub_
_sqrt, _sqrt_ = torch._foreach_sqrt, torch._foreach_sqrt_


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


def _zeros_like(weight):
    return torch.zeros(weight.shape, dtype=_f32, device=weight.device)


def _square(xs):
    return _mul(xs, xs)


def _stack(ts):
    return torch.stack(list(ts))


class Optimizer:
    """Base optimizer: hyper-parameters and their per-parameter scaling."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, aggregate_num=None, use_fused_step=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.aggregate_num = aggregate_num or 1
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}
        self._slots = {}    # index -> the per-parameter path's Slots

    # ---- hyper-parameters --------------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is active; set lr via scheduler")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
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
        lr = (self.lr_scheduler(self.num_update)
              if self.lr_scheduler is not None else self.lr)
        return lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    def _scalars(self, index):
        """The per-step host values the rule reads for ``index`` (float64,
        in slot order), evaluated after its update count moved."""
        return {"lr": self._get_lr(index), "wd": self._get_wd(index),
                "rescale": float(self.rescale_grad)}

    # ---- state ---------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def _uses_master(self, weight):
        return self.multi_precision and weight.dtype in _LOW

    def create_state_multi_precision(self, index, weight):
        """``(f32 master, state)`` for a 16-bit weight under
        ``multi_precision``, else ``create_state``."""
        if self._uses_master(weight):
            master = weight.detach().to(_f32)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    # ---- update --------------------------------------------------------------
    def _preprocess(self, grads, s):
        """f32 gradients times ``rescale_grad``, clipped to
        +-clip_gradient: new tensors, the caller's stay as they were."""
        g = _mul([x.to(_f32) for x in grads], s["rescale"])
        if self.clip_gradient is not None:
            torch._foreach_clamp_min_(g, -self.clip_gradient)
            torch._foreach_clamp_max_(g, self.clip_gradient)
        return g

    def _rule(self, w, grads, states, s):
        """Update the f32 weights ``w`` and their ``states`` in place from
        the raw ``grads``; ``s`` maps each ``_scalars`` name to its 0-dim
        f32 tensor."""
        raise NotImplementedError

    @torch.no_grad()
    def _apply(self, weights, grads, states, s, masters=False):
        """Run ``_rule`` over lists.  f32 weights update in place; others
        through f32 copies cast back; with ``masters`` each state is
        ``(f32 master, state)`` and the master takes the update."""
        if masters:
            work = [st[0] for st in states]
            states = [st[1] for st in states]
        else:
            work = [w if w.dtype == _f32 else w.to(_f32) for w in weights]
        self._rule(work, grads, states, s)
        pairs = [(w, m) for w, m in zip(weights, work) if m is not w]
        if pairs:
            torch._foreach_copy_([w for w, _ in pairs],
                                 [m for _, m in pairs])

    def _bump(self, index):
        self._update_count(index)

    def _step_one(self, index, weight, grad, state, masters):
        from ..ndarray.sparse import RowSparseNDArray
        from .multi_tensor import refill

        if isinstance(grad, RowSparseNDArray):
            if getattr(self, "lazy_update", False) and \
                    self._lazy_rule is not None:
                return self._lazy_step(index, weight, grad, state, masters)
            grad = grad.tostype("default")._data
        self._bump(index)
        slots = self._slots[index] = refill(
            self._slots.get(index), self._scalars(index), weight.device)
        self._apply([weight], [grad], [state], slots.values, masters)

    # ---- the lazy update of a row_sparse gradient ---------------------------
    _lazy_rule = None   # (index, w, idx, g, state, lr, wd): rows in place

    def _sparse_rows(self, grad):
        """(indices, f32 rows) of a RowSparseNDArray gradient: repeated
        indices summed (a host sync on the card, unless the array's rows
        are known unique), then rescaled and clipped."""
        idx = grad.indices_.long()
        rows = grad._data.to(_f32)
        if not grad._unique_rows:
            uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
            if uniq.numel() != rows.shape[0]:
                rows = torch.zeros((uniq.numel(),) + rows.shape[1:],
                                   dtype=_f32, device=rows.device
                                   ).index_add(0, inv, rows)
                idx = uniq
        rows = rows * self.rescale_grad
        if self.clip_gradient is not None:
            rows = rows.clamp(-self.clip_gradient, self.clip_gradient)
        return idx, rows

    @torch.no_grad()
    def _lazy_step(self, index, weight, grad, state, masters):
        self._bump(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        idx, g = self._sparse_rows(grad)
        work, st = (state[0], state[1]) if masters else (weight, state)
        self._lazy_rule(index, work, idx, g, st, lr, wd)
        if masters:
            weight.copy_(work)

    def update(self, index, weight, grad, state):
        """Apply one step to ``weight`` in place; ``state`` as made by
        ``create_state``."""
        self._step_one(index, weight, grad, state, False)

    def update_multi_precision(self, index, weight, grad, state):
        """``update``, through the f32 master when ``state`` carries one
        (``create_state_multi_precision``)."""
        self._step_one(index, weight, grad, state,
                       self._has_master(weight, state))

    def _has_master(self, weight, state):
        return (self._uses_master(weight) and isinstance(state, tuple)
                and len(state) == 2 and isinstance(state[0], torch.Tensor))

    def __repr__(self):
        return "%s(lr=%s, wd=%s)" % (type(self).__name__, self.lr, self.wd)


def _with_wd(g, w, s):
    """g + wd*w, as the JAX rules add weight decay to the gradient."""
    _add_(g, _mul(w, s["wd"]))
    return g


@register
class SGD(Optimizer):
    """SGD with momentum: mom = momentum*mom - lr*(g + wd*w); w += mom."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=True,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def _momentum_step(self, w, g, states, s):
        """(mom, lr*g); mom updated in place, None without momentum."""
        lg = _mul(g, s["lr"])
        if states[0] is None:
            return None, lg
        _mul_(states, self.momentum)
        _sub_(states, lg)
        return states, lg

    def _rule(self, w, grads, states, s):
        g = _with_wd(self._preprocess(grads, s), w, s)
        mom, lg = self._momentum_step(w, g, states, s)
        if mom is None:
            _sub_(w, lg)
        else:
            _add_(w, mom)

    def _lazy_rule(self, index, w, idx, g, state, lr, wd):
        w_rows = w[idx].to(_f32)
        g = g + wd * w_rows
        if state is not None:
            mom_rows = state[idx] * self.momentum - lr * g
            state[idx] = mom_rows
            new_rows = w_rows + mom_rows
        else:
            new_rows = w_rows - lr * g
        w[idx] = new_rows.to(w.dtype)


@register
class NAG(SGD):
    """Nesterov momentum: w += momentum*mom - lr*g, mom as SGD's."""

    _lazy_rule = None

    def _rule(self, w, grads, states, s):
        g = _with_wd(self._preprocess(grads, s), w, s)
        mom, lg = self._momentum_step(w, g, states, s)
        if mom is not None:
            _add_(w, _mul(mom, self.momentum))
        _sub_(w, lg)


class _Moments(Optimizer):
    """Adam-family state: (mean, var) f32 and their EMA update."""

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _moments(self, g, states):
        """m = b1*m + (1-b1)*g, v = b2*v + (1-b2)*g^2 in place -> (m, v)."""
        m = [st[0] for st in states]
        v = [st[1] for st in states]
        _mul_(m, self.beta1)
        _add_(m, _mul(g, 1 - self.beta1))
        g2 = _square(g)
        _mul_(g2, 1 - self.beta2)
        _mul_(v, self.beta2)
        _add_(v, g2)
        return m, v

    def _bias_scalars(self, index, out):
        t = self._index_update_count[index]
        out["c1"] = 1 - self.beta1 ** t
        out["c2"] = 1 - self.beta2 ** t
        return out

    def _direction(self, m, v, s, eps):
        """(m/c1) / (sqrt(v/c2) + eps) as a new list; lr not applied."""
        mhat = _div(m, s["c1"])
        den = _div(v, s["c2"])
        _sqrt_(den)
        _add_(den, eps)
        return mhat, den


@register
class Adam(_Moments):
    """Adam with bias correction; weight decay added to the gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def _scalars(self, index):
        return self._bias_scalars(index, super()._scalars(index))

    def _rule(self, w, grads, states, s):
        g = _with_wd(self._preprocess(grads, s), w, s)
        m, v = self._moments(g, states)
        mhat, den = self._direction(m, v, s, self.epsilon)
        step = _mul(mhat, s["lr"])          # lr * mhat first, as the JAX rule
        _div_(step, den)
        _sub_(w, step)

    def _lazy_rule(self, index, w, idx, g, state, lr, wd):
        t = self._index_update_count[index]
        w_rows = w[idx].to(_f32)
        g = g + wd * w_rows
        m, v = state
        m_rows = self.beta1 * m[idx] + (1 - self.beta1) * g
        v_rows = self.beta2 * v[idx] + (1 - self.beta2) * torch.square(g)
        m[idx] = m_rows
        v[idx] = v_rows
        mhat = m_rows / (1 - self.beta1 ** t)
        vhat = v_rows / (1 - self.beta2 ** t)
        new_rows = w_rows - lr * mhat / (torch.sqrt(vhat) + self.epsilon)
        w[idx] = new_rows.to(w.dtype)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay: w -= lr*(step + wd*w)."""

    _lazy_rule = None

    def _rule(self, w, grads, states, s):
        g = self._preprocess(grads, s)
        m, v = self._moments(g, states)
        mhat, den = self._direction(m, v, s, self.epsilon)
        _div_(mhat, den)
        _add_(mhat, _mul(w, s["wd"]))
        _mul_(mhat, s["lr"])
        _sub_(w, mhat)


@register
class Adamax(_Moments):
    """Adam on the infinity norm: u = max(b2*u, |g|), lr / (1 - b1^t)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1, self.beta2 = beta1, beta2

    def _scalars(self, index):
        out = super()._scalars(index)
        out["lr"] /= (1 - self.beta1 ** self._index_update_count[index])
        return out

    def _rule(self, w, grads, states, s):
        g = _with_wd(self._preprocess(grads, s), w, s)
        m = [st[0] for st in states]
        u = [st[1] for st in states]
        _mul_(m, self.beta1)
        _add_(m, _mul(g, 1 - self.beta1))
        _mul_(u, self.beta2)
        torch._foreach_maximum_(u, torch._foreach_abs(g))
        step = _mul(m, s["lr"])
        _div_(step, _add(u, 1e-8))
        _sub_(w, step)


@register
class Nadam(_Moments):
    """Adam with Nesterov momentum and a momentum schedule.  The schedule
    product ``m_schedule`` is host state that moves with every update,
    so Nadam is never grouped."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def _scalars(self, index):
        out = super()._scalars(index)
        t = self._index_update_count[index]
        momentum_t = self.beta1 * (1 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        out.update(g_den=1 - self.m_schedule,
                   m_den=1 - self.m_schedule * momentum_t_1,
                   c2=1 - self.beta2 ** t, a=1 - momentum_t, b=momentum_t_1)
        return out

    def _rule(self, w, grads, states, s):
        g = _with_wd(self._preprocess(grads, s), w, s)
        m, v = self._moments(g, states)
        g_prime = _div(g, s["g_den"])
        m_prime = _div(m, s["m_den"])
        v_prime = _div(v, s["c2"])
        m_bar = _mul(g_prime, s["a"])
        _add_(m_bar, _mul(m_prime, s["b"]))
        _sqrt_(v_prime)
        _add_(v_prime, self.epsilon)
        step = _mul(m_bar, s["lr"])
        _div_(step, v_prime)
        _sub_(w, step)


@register
class LAMB(_Moments):
    """Layer-wise adaptive moments: the Adam direction plus wd*w, scaled
    per tensor by the trust ratio ||w|| / ||r||."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def _scalars(self, index):
        out = super()._scalars(index)
        return self._bias_scalars(index, out) if self.bias_correction \
            else out

    def _lamb(self, w, g, states, s):
        m, v = self._moments(g, states)
        if self.bias_correction:
            r, den = self._direction(m, v, s, self.epsilon)
        else:
            r, den = list(m), _sqrt(v)
            _add_(den, self.epsilon)
        r = _div(r, den)
        _add_(r, _mul(w, s["wd"]))
        w_norm = _stack(torch._foreach_norm(w))
        r_norm = _stack(torch._foreach_norm(r))
        if self.lower_bound is not None:
            w_norm = torch.clamp_min(w_norm, self.lower_bound)
        if self.upper_bound is not None:
            w_norm = torch.clamp_max(w_norm, self.upper_bound)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        _mul_(r, list((s["lr"] * ratio).unbind()))
        _sub_(w, r)

    def _rule(self, w, grads, states, s):
        self._lamb(w, self._preprocess(grads, s), states, s)


@register
class LANS(LAMB):
    """LANS: LAMB on the gradient normalised per tensor."""

    def _rule(self, w, grads, states, s):
        g = self._preprocess(grads, s)
        norms = torch._foreach_norm(g)
        g = [torch.where(n > 0, x / n, x) for x, n in zip(g, norms)]
        if self.clip_gradient is not None:   # the JAX rule clips again
            torch._foreach_clamp_min_(g, -self.clip_gradient)
            torch._foreach_clamp_max_(g, self.clip_gradient)
        self._lamb(w, g, states, s)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: g scaled per tensor by
    eta*||w|| / (||g|| + wd*||w|| + eps), then momentum."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum else None

    def _rule(self, w, grads, states, s):
        g = self._preprocess(grads, s)
        w_norm = _stack(torch._foreach_norm(w))
        g_norm = _stack(torch._foreach_norm(g))
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + s["wd"] * w_norm + self.epsilon),
            torch.ones_like(w_norm))
        g = _with_wd(g, w, s)
        _mul_(g, list(trust.unbind()))
        lg = _mul(g, s["lr"])
        if states[0] is None:
            _sub_(w, lg)
            return
        _mul_(states, self.momentum)
        _add_(states, lg)
        _sub_(w, states)


@register
class Ftrl(Optimizer):
    """Follow the regularised leader: state (z, n)."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))  # z, n

    def _rule(self, w, grads, states, s):
        g = self._preprocess(grads, s)
        z = [st[0] for st in states]
        n = [st[1] for st in states]
        g2 = _square(g)
        sigma = _sqrt(_add(n, g2))
        _sub_(sigma, _sqrt(n))
        _div_(sigma, s["lr"])
        _add_(z, g)
        _mul_(sigma, w)
        _sub_(z, sigma)
        _add_(n, g2)
        den = _sqrt(n)
        _add_(den, self.beta)
        _div_(den, s["lr"])
        _add_(den, s["wd"])
        num = _sub(z, _mul(torch._foreach_sign(z), self.lamda1))
        torch._foreach_neg_(num)
        _div_(num, den)
        for wi, zi, qi in zip(w, z, num):
            wi.copy_(torch.where(zi.abs() <= self.lamda1,
                                 torch.zeros_like(wi), qi))


@register
class FTML(Optimizer):
    """Follow the moving leader: state (d, v, z)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                _zeros_like(weight))  # d, v, z

    def _scalars(self, index):
        out = super()._scalars(index)
        t = self._index_update_count[index]
        out["k"] = (1 - self.beta1 ** t) / out["lr"]
        out["c2"] = 1 - self.beta2 ** t
        return out

    def _rule(self, w, grads, states, s):
        g = _with_wd(self._preprocess(grads, s), w, s)
        d = [st[0] for st in states]
        v = [st[1] for st in states]
        z = [st[2] for st in states]
        g2 = _square(g)
        _mul_(g2, 1 - self.beta2)
        _mul_(v, self.beta2)
        _add_(v, g2)
        d_t = _div(v, s["c2"])
        _sqrt_(d_t)
        _add_(d_t, self.epsilon)
        _mul_(d_t, s["k"])
        sigma = _sub(d_t, _mul(d, self.beta1))
        _mul_(z, self.beta1)
        _add_(z, _mul(g, 1 - self.beta1))
        _mul_(sigma, w)
        _sub_(z, sigma)
        torch._foreach_copy_(d, d_t)
        q = _div(z, d_t)
        torch._foreach_neg_(q)
        torch._foreach_copy_(w, q)


@register
class AdaGrad(Optimizer):
    """AdaGrad: h += g^2; w -= lr*g / (sqrt(h) + eps)."""

    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def _rule(self, w, grads, states, s):
        g = _with_wd(self._preprocess(grads, s), w, s)
        _add_(states, _square(g))
        den = _sqrt(states)
        _add_(den, self.epsilon)
        step = _mul(g, s["lr"])
        _div_(step, den)
        _sub_(w, step)


@register
class AdaDelta(Optimizer):
    """AdaDelta: state (acc_g, acc_delta); the raw ``lr`` attribute scales
    the step (no scheduler), as in the JAX rule."""

    def __init__(self, learning_rate=1.0, rho=0.9, epsilon=1e-5, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _scalars(self, index):
        return {"lr": float(self.lr), "wd": self._get_wd(index),
                "rescale": float(self.rescale_grad)}

    def _rule(self, w, grads, states, s):
        g = _with_wd(self._preprocess(grads, s), w, s)
        acc_g = [st[0] for st in states]
        acc_d = [st[1] for st in states]
        g2 = _square(g)
        _mul_(g2, 1 - self.rho)
        _mul_(acc_g, self.rho)
        _add_(acc_g, g2)
        delta = _sqrt(_add(acc_d, self.epsilon))
        _div_(delta, _sqrt(_add(acc_g, self.epsilon)))
        _mul_(delta, g)
        d2 = _square(delta)
        _mul_(d2, 1 - self.rho)
        _mul_(acc_d, self.rho)
        _add_(acc_d, d2)
        _sub_(w, _mul(delta, s["lr"]))


@register
class RMSProp(Optimizer):
    """RMSProp, plain (sqrt(n) + eps) or centred with momentum."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.rho, self.momentum, self.epsilon = rho, momentum, epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return (_zeros_like(weight),)

    def _rule(self, w, grads, states, s):
        g = _with_wd(self._preprocess(grads, s), w, s)
        n = [st[0] for st in states]
        g2 = _square(g)
        _mul_(g2, 1 - self.rho)
        _mul_(n, self.rho)
        _add_(n, g2)
        step = _mul(g, s["lr"])
        if self.centered:
            gm = [st[1] for st in states]
            delta = [st[2] for st in states]
            _mul_(gm, self.rho)
            _add_(gm, _mul(g, 1 - self.rho))
            den = _sub(n, _square(gm))
            _add_(den, self.epsilon)
            _sqrt_(den)
            _div_(step, den)
            _mul_(delta, self.momentum)
            _sub_(delta, step)
            _add_(w, delta)
        else:
            den = _sqrt(n)
            _add_(den, self.epsilon)
            _div_(step, den)
            _sub_(w, step)
        if self.clip_weights:
            torch._foreach_clamp_min_(w, -self.clip_weights)
            torch._foreach_clamp_max_(w, self.clip_weights)


def _sgld_noise(w):
    """Standard normal draws shaped like each of ``w``, from the port's
    generator of their device."""
    from .. import random as _random

    return [_random.normal_tensor(shape=x.shape, ctx=x.device) for x in w]


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: w += -lr/2*g + N(0, lr).
    It draws noise during the update, so it is never grouped."""

    def _scalars(self, index):
        out = super()._scalars(index)
        out.update(half_lr=out["lr"] / 2, sqrt_lr=math.sqrt(out["lr"]))
        return out

    def _rule(self, w, grads, states, s):
        g = _with_wd(self._preprocess(grads, s), w, s)
        noise = _sgld_noise(w)
        _mul_(noise, s["sqrt_lr"])
        _sub_(w, _mul(g, s["half_lr"]))
        _add_(w, noise)


@register
class Signum(Optimizer):
    """signSGD with momentum and decoupled decay ``wd_lh``."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def _scalars(self, index):
        out = super()._scalars(index)
        out["decay"] = 1 - out["lr"] * self.wd_lh
        return out

    def _rule(self, w, grads, states, s):
        g = _with_wd(self._preprocess(grads, s), w, s)
        _mul_(w, s["decay"])
        if states[0] is not None:
            _mul_(states, self.momentum)
            _sub_(states, _mul(g, 1 - self.momentum))
            _add_(w, _mul(torch._foreach_sign(states), s["lr"]))
        else:
            _sub_(w, _mul(torch._foreach_sign(g), s["lr"]))


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD: state (momentum or None, previous weight)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (_zeros_like(weight) if self.momentum != 0.0 else None,
                weight.detach().to(_f32).clone())

    def _rule(self, w, grads, states, s):
        g = _with_wd(self._preprocess(grads, s), w, s)
        prev = [st[1] for st in states]
        comp = _mul(g, self.lamda)
        _mul_(comp, g)
        _mul_(comp, _sub(w, prev))
        _add_(comp, g)
        lc = _mul(comp, s["lr"])
        if states[0][0] is None:
            _sub_(w, lc)
        else:
            mom = [st[0] for st in states]
            _mul_(mom, self.momentum)
            _sub_(mom, lc)
            _add_(w, mom)
        torch._foreach_copy_(prev, w)


@register
class LBSGD(SGD):
    """Large-batch SGD: a linear lr warm-up over ``warmup_epochs``."""

    def __init__(self, learning_rate=0.01, momentum=0.0,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60, **kw):
        super().__init__(learning_rate=learning_rate, momentum=momentum,
                         **kw)
        self.warmup_updates = warmup_epochs * updates_per_epoch

    def _get_lr(self, index):
        lr = super()._get_lr(index)
        if self.num_update < self.warmup_updates:
            lr = lr * (self.num_update + 1) / self.warmup_updates
        return lr


@register
class Test(Optimizer):
    """The reference's test optimizer: w -= lr*g, no count."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def _bump(self, index):
        pass

    def _scalars(self, index):
        return {"lr": float(self.lr), "rescale": float(self.rescale_grad)}

    def _rule(self, w, grads, states, s):
        _sub_(w, _mul(self._preprocess(grads, s), s["lr"]))


class Updater:
    """Wraps an optimizer for per-index updates (the kvstore's server-side
    update in the JAX package)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        return pickle.dumps({k: _state_np(v)
                             for k, v in self.states.items()})

    def set_states(self, states):
        self.states = {k: _state_tensor(v)
                       for k, v in pickle.loads(states).items()}


def _state_np(state):
    """An optimizer state (a tensor, a tuple of them, or None) as numpy,
    copied: the pickled form both packages read."""
    from ..ndarray.ndarray import _to_numpy

    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return _to_numpy(state)
    if isinstance(state, tuple):
        return tuple(_state_np(s) for s in state)
    return state


def _state_tensor(state, device=None):
    """The inverse of ``_state_np``: numpy (or restored tensor) leaves as
    tensors on ``device`` (default: where they are, numpy on the CPU)."""
    import numpy as np

    if state is None:
        return None
    if isinstance(state, np.ndarray):
        state = torch.from_numpy(np.require(state, requirements="C"))
    if isinstance(state, torch.Tensor):
        return state if device is None else state.to(device)
    if hasattr(state, "_data"):                      # an NDArray
        return _state_tensor(state._data, device)
    if isinstance(state, (tuple, list)):
        return tuple(_state_tensor(s, device) for s in state)
    return state


def get_updater(optimizer):
    return Updater(optimizer)
