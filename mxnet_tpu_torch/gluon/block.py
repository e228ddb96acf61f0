"""Gluon blocks over ``torch.nn.Module``.

Counterpart of ``mxnet_tpu/gluon/block.py``.  A ``Block`` is an
``nn.Module`` whose parameters carry the JAX package's structured names
(``encoder.layers.0.attention.query_proj.weight``), so weights cross
between the two packages by name (``convert.load_jax_params``).

Training mode follows ``autograd``, not ``nn.Module.training``: dropout
acts while ``autograd.is_training()``, and a block builds an autograd graph
only inside ``autograd.record()`` (outside it, it runs under
``torch.no_grad()``), as the JAX package's blocks do.

A block called with ``mx.nd`` NDArrays takes their tensors and returns its
outputs as NDArrays (a tuple or list of them for several); called with
tensors it returns tensors.

``collect_params(select)`` filters the structured names by a regular
expression (``re.match``), and a parameter assigned under a default name
(``weight``, ``bias``, ...) takes the attribute's name, as in the JAX
package.  A parameter held under several names (``share_parameters``)
is listed once, under its first name (``nn.Module``'s rule).

Forward hooks take the JAX package's form: ``register_forward_pre_hook(
hook)`` calls ``hook(block, args)`` and ``register_forward_hook(hook)``
calls ``hook(block, args, output)`` around each call, with the arguments
and output the caller passed and got (NDArrays where those were given);
what a hook returns is ignored, and the handle's ``detach()`` (or
``remove()``) takes it off.  ``apply(fn)`` is ``nn.Module``'s, which
visits the children first and then the block, as the JAX package's does.
"""
from __future__ import annotations

import itertools
import math
import re
from collections import OrderedDict

import torch
from torch import nn

from .. import autograd
from ..ops import registry as _registry

__all__ = ["Block", "HybridBlock"]


def _wrap(out, NDArray):
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o, NDArray) for o in out)
    return out


def _unwrap(x, NDArray):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (tuple, list)):
        return type(x)(_unwrap(v, NDArray) for v in x)
    return x


def _has_ndarray(xs, NDArray):
    """Whether an NDArray is among ``xs`` or inside a list/tuple there (a
    plain loop: it runs on every block call)."""
    for x in xs:
        if isinstance(x, NDArray) or (isinstance(x, (tuple, list))
                                      and _has_ndarray(x, NDArray)):
            return True
    return False


def _call_with_ndarrays(block, NDArray, args, kwargs):
    """``block`` called on the tensors of its NDArray arguments (also
    inside lists and tuples, as recurrent states come), its outputs
    wrapped as NDArrays."""
    args = _unwrap(args, NDArray)
    kwargs = {k: _unwrap(v, NDArray) for k, v in kwargs.items()}
    return _wrap(block._call(*args, **kwargs), NDArray)


_HOOK_IDS = itertools.count(1)


class _HookHandle:
    def __init__(self, hooks, hid):
        self._hooks, self._hid = hooks, hid

    def detach(self):
        self._hooks.pop(self._hid, None)

    remove = detach


class Block(nn.Module):
    """Base block: an ``nn.Module`` with Gluon's parameter naming."""

    _pre_hooks = None    # {id: hook(block, args)}, made at the first one
    _post_hooks = None   # {id: hook(block, args, output)}

    def __call__(self, *args, **kwargs):
        if self._pre_hooks is None and self._post_hooks is None:
            return self._call(*args, **kwargs)
        for hook in list((self._pre_hooks or {}).values()):
            hook(self, args)
        out = self._call(*args, **kwargs)
        for hook in list((self._post_hooks or {}).values()):
            hook(self, args, out)
        return out

    def _call(self, *args, **kwargs):
        NDArray = _registry.NDArray
        if NDArray is not None and (
                _has_ndarray(args, NDArray)
                or (kwargs and _has_ndarray(kwargs.values(), NDArray))):
            return _call_with_ndarrays(self, NDArray, args, kwargs)
        if autograd.is_recording() or not torch.is_grad_enabled():
            return super().__call__(*args, **kwargs)
        with torch.no_grad():   # not recording: no graph, as in JAX
            return super().__call__(*args, **kwargs)

    def _add_hook(self, table, hook):
        hooks = getattr(self, table)
        if hooks is None:
            hooks = OrderedDict()
            object.__setattr__(self, table, hooks)
        hid = next(_HOOK_IDS)
        hooks[hid] = hook
        return _HookHandle(hooks, hid)

    def register_forward_pre_hook(self, hook):
        """Call ``hook(block, args)`` before each call; returns a handle
        whose ``detach()`` takes it off."""
        return self._add_hook("_pre_hooks", hook)

    def register_forward_hook(self, hook):
        """Call ``hook(block, args, output)`` after each call; returns a
        handle whose ``detach()`` takes it off."""
        return self._add_hook("_post_hooks", hook)

    def __setattr__(self, name, value):
        from .parameter import _DEFAULT_NAMES, Parameter

        if isinstance(value, Parameter) and value._name in _DEFAULT_NAMES:
            value._name = name
        super().__setattr__(name, value)

    def collect_params(self, select=None):
        """Structured-name parameter dict ``{name: Parameter}``; with
        ``select``, only the names the regular expression matches."""
        out = OrderedDict(self.named_parameters())
        if select:
            pat = re.compile(select)
            out = OrderedDict((k, v) for k, v in out.items()
                              if pat.match(k))
        return out

    @property
    def params(self):
        """``collect_params()``."""
        return self.collect_params()

    def share_parameters(self, shared):
        """Hold the parameters of ``shared`` ({structured name:
        Parameter}, as ``collect_params`` gives) in place of this block's
        own of the same names; returns the block."""
        own = self.collect_params()
        for name, param in shared.items():
            if name not in own:
                continue
            *path, leaf = name.split(".")
            blk = self
            for part in path:
                blk = blk._modules[part]
            nn.Module.__setattr__(blk, leaf, param)
        return self

    def setattr(self, name, value):
        """Set attribute ``name`` (``grad_req``, ``lr_mult``, ...) of every
        parameter to ``value``."""
        for param in self.collect_params().values():
            setattr(param, name, value)

    def reset_ctx(self, ctx):
        """Move every parameter to ``ctx``, keeping its values."""
        for param in self.collect_params().values():
            param.reset_ctx(ctx)

    def infer_shape(self, *args):
        """Shape-propagation hook; the layers with deferred shapes
        override it."""

    def summary(self, *inputs):
        """The JAX package's text table: each parameter's structured name
        and shape (``Layer``, ``Params``), then ``Total params``."""
        lines = ["%-44s %-20s" % ("Layer", "Params")]
        total = 0
        for name, p in self.collect_params().items():
            shape = tuple(p.shape)
            total += math.prod(shape)
            lines.append("%-44s %-20s" % (name, shape))
        lines.append("Total params: %d" % total)
        return "\n".join(lines)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Place every parameter on ``ctx`` (default the card; raises
        without one unless ``ctx=mx.cpu()``) and fill those not yet
        initialized or set: a parameter's own ``init`` first, else
        ``init``, else ``initializer.Uniform()``.  The initializer sees
        the parameter's own name (``weight``, ``running_var``), as in the
        JAX package.  A parameter of deferred shape is filled at the
        block's first call.  ``verbose`` is accepted and prints nothing,
        as in the JAX package."""
        from .. import initializer

        default = init or initializer.Uniform()
        for param in self.collect_params().values():
            param.initialize(ctx=ctx, default_init=default,
                             force_reinit=force_reinit)

    def zero_grad(self, set_to_none=False):
        """Zero every parameter's gradient in place (Gluon semantics;
        ``set_to_none=True`` drops them instead, as ``nn.Module`` does)."""
        for param in self.parameters():
            if set_to_none:
                param.grad = None
            elif param.grad is not None:
                param.grad.zero_()

    def cast(self, dtype):
        """Cast every parameter to ``dtype`` in place (the objects stay
        the ones the block holds), then tell each child (``_on_cast``)."""
        for param in self.collect_params().values():
            param.cast(dtype)
        for child in self.children():
            child._on_cast(dtype)

    def _on_cast(self, dtype):
        """Hook run after ``cast``: a block that keeps dtype-dependent
        state beside its parameters overrides it."""
        for child in self.children():
            child._on_cast(dtype)

    def register_child(self, block, name=None):
        name = name or str(len(self._modules))
        self.add_module(name, block)
        return block


class HybridBlock(Block):
    """A block the JAX package can trace into one compiled program.

    ``hybridize()`` is accepted and does nothing in this port: blocks run
    eagerly, and there is no ``torch.compile``."""

    def hybridize(self, active=True, **kwargs):
        """Accepted for API parity; does nothing (eager execution)."""
