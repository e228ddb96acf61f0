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
package.
"""
from __future__ import annotations

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
    return _wrap(block(*args, **kwargs), NDArray)


class Block(nn.Module):
    """Base block: an ``nn.Module`` with Gluon's parameter naming."""

    def __call__(self, *args, **kwargs):
        NDArray = _registry.NDArray
        if NDArray is not None and (
                _has_ndarray(args, NDArray)
                or (kwargs and _has_ndarray(kwargs.values(), NDArray))):
            return _call_with_ndarrays(self, NDArray, args, kwargs)
        if autograd.is_recording() or not torch.is_grad_enabled():
            return super().__call__(*args, **kwargs)
        with torch.no_grad():   # not recording: no graph, as in JAX
            return super().__call__(*args, **kwargs)

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
