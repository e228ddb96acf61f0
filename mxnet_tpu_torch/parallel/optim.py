"""Multi-tensor optimizer rules for ``parallel.FusedTrainer``.

Counterpart of ``mxnet_tpu/parallel/optim.py:make_optimizer``.  There each
rule is a pure function over dicts of arrays that XLA fuses into the one
training program.  Here ``update`` works in place on lists of tensors with
``torch._foreach_*`` ops: each line of a rule is one multi-tensor launch
over all the parameters (a few launches a step), not one launch per op and
parameter.

- ``init(params) -> state``: ``{}``, ``{"mom": [...]}`` or
  ``{"mean": [...], "var": [...]}``, f32 tensors shaped like the params.
- ``update(step, params, grads, state, lr)``: the step number (from 0),
  the parameters, their gradients, the state and the learning rate; the
  parameters and the state change in place, outside autograd (the JAX
  package returns new ones); returns ``(params, state)``.

Math runs in f32: f32 parameters update in place, others (bf16, fp16)
through an f32 copy that is cast back.  The Adam and LAMB bias corrections
are computed in float32 from the step, as the reference computes them on
the device.  ``shard_update`` (ZeRO over a mesh) is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["make_optimizer"]

_f32 = torch.float32


def _master(ts):
    """The f32 tensors the math updates: f32 ones themselves, others as
    f32 copies."""
    return [t if t.dtype == _f32 else t.float() for t in ts]


def _write_back(params, p32):
    for p, m in zip(params, p32):
        if m is not p:
            p.copy_(m)


def _bias_corrections(step, beta1, beta2):
    """1 - beta1^t and 1 - beta2^t at t = step + 1, in float32."""
    t = np.float32(step) + np.float32(1.0)
    one = np.float32(1.0)
    return (float(one - np.float32(beta1) ** t),
            float(one - np.float32(beta2) ** t))


def make_optimizer(name, learning_rate=0.01, wd=0.0, momentum=0.9,
                   beta1=0.9, beta2=0.999, epsilon=1e-8,
                   clip_gradient=None, **kwargs):
    """Return ``(init(params) -> state, update(step, params, grads, state,
    lr) -> (params, state))`` for sgd, nag, adam, adamw or lamb over lists
    of tensors.  ``learning_rate`` is the trainer's; ``update`` takes the
    step's ``lr``."""
    name = name.lower()

    def preprocess(grads):
        """f32 gradients, clipped to +-clip_gradient; new tensors wherever
        the values change, so the caller's gradients stay as they were."""
        g = _master(grads)
        if clip_gradient is not None:
            g = torch._foreach_clamp_min(g, -clip_gradient)
            torch._foreach_clamp_max_(g, clip_gradient)
        return g

    def zeros(params):
        return [torch.zeros_like(p, dtype=_f32) for p in params]

    def moments(g, state, step):
        """Adam's first and second moments, updated in place; -> the
        bias-corrected step direction m_hat / (sqrt(v_hat) + eps)."""
        m, v = state["mean"], state["var"]
        c1, c2 = _bias_corrections(step, beta1, beta2)
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, g, alpha=1 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, g, g, value=1 - beta2)
        denom = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, epsilon)
        upd = torch._foreach_div(m, c1)
        torch._foreach_div_(upd, denom)
        return upd

    if name in ("sgd", "nag"):
        def init(params):
            return {} if momentum == 0.0 else {"mom": zeros(params)}

        @torch.no_grad()
        def update(step, params, grads, state, lr):
            lr = float(np.float32(lr))
            p32 = _master(params)
            g = preprocess(grads)
            if wd:
                g = torch._foreach_add(g, p32, alpha=wd)
            if momentum != 0.0:
                mom = state["mom"]
                torch._foreach_mul_(mom, momentum)
                torch._foreach_add_(mom, g, alpha=-lr)
                if name == "nag":
                    upd = torch._foreach_mul(mom, momentum)
                    torch._foreach_add_(upd, g, alpha=-lr)
                else:
                    upd = mom
                torch._foreach_add_(p32, upd)
            else:
                torch._foreach_add_(p32, g, alpha=-lr)
            _write_back(params, p32)
            return params, state

        return init, update

    if name in ("adam", "adamw", "lamb"):
        def init(params):
            return {"mean": zeros(params), "var": zeros(params)}

    if name in ("adam", "adamw"):
        @torch.no_grad()
        def update(step, params, grads, state, lr):
            lr = float(np.float32(lr))
            p32 = _master(params)
            g = preprocess(grads)
            if name == "adam" and wd:
                g = torch._foreach_add(g, p32, alpha=wd)
            upd = moments(g, state, step)
            if name == "adamw" and wd:
                torch._foreach_add_(upd, p32, alpha=wd)
            torch._foreach_add_(p32, upd, alpha=-lr)
            _write_back(params, p32)
            return params, state

        return init, update

    if name == "lamb":
        @torch.no_grad()
        def update(step, params, grads, state, lr):
            lr = float(np.float32(lr))
            p32 = _master(params)
            r = moments(preprocess(grads), state, step)
            if wd:
                torch._foreach_add_(r, p32, alpha=wd)
            # the per-tensor trust ratio ||w|| / ||r|| (1 where either is 0)
            wn = torch.stack(torch._foreach_norm(p32))
            rn = torch.stack(torch._foreach_norm(r))
            ratio = torch.where((wn > 0) & (rn > 0), wn / rn,
                                torch.ones_like(wn))
            torch._foreach_mul_(r, list(ratio.unbind()))
            torch._foreach_add_(p32, r, alpha=-lr)
            _write_back(params, p32)
            return params, state

        return init, update

    raise MXNetError("fused optimizer %r not available (use sgd/nag/adam/"
                     "adamw/lamb, or the imperative Trainer)" % name)
