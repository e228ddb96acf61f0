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
is listed under each of them, in the JAX package's order.

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
from ..base import MXNetError
from ..checkpoint import cached_manager
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
        """Structured-name parameter dict ``{name: Parameter}``, a
        parameter held under several names listed under each; with
        ``select``, only the names the regular expression matches."""
        out = OrderedDict(self.named_parameters(remove_duplicate=False))
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

    # ---- persistence ------------------------------------------------------
    def _initialized_params(self, deduplicate):
        """{name: param} of the parameters that hold values; with
        ``deduplicate``, a parameter held under several names appears once,
        under its first.  The one contract behind ``save_parameters`` and
        ``save_checkpoint``."""
        out, seen = OrderedDict(), set()
        for name, param in self.collect_params().items():
            if not param._initialized:
                continue
            if deduplicate and id(param) in seen:
                continue
            seen.add(id(param))
            out[name] = param
        return out

    def _param_device(self):
        """The device of the first parameter that holds values (None if
        none does): where a restore without ``ctx`` puts the leaves."""
        for param in self.collect_params().values():
            if param._initialized:
                return param.device
        return None

    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter that holds values to ``filename`` (the
        ``nd.save`` npz, by structured name); with ``deduplicate`` a
        parameter held under several names is written once."""
        from .. import ndarray as nd

        nd.save(filename, {name: nd.NDArray(p.detach()) for name, p in
                           self._initialized_params(deduplicate).items()})

    def _apply_loaded(self, loaded, source, ctx, allow_missing,
                      ignore_extra, require_all):
        """Copy loaded arrays ({name: tensor, NDArray or array}) into this
        block's parameters: the one restore loop behind
        ``load_parameters`` and ``load_checkpoint``.  A
        parameter held under several names is satisfied by any one of
        them.  With ``require_all`` every name must be present; else only
        the parameters that hold values (a checkpoint skips the rest)."""
        params = self.collect_params()
        restored = set()
        for name, param in params.items():
            if name not in loaded:
                continue
            value = loaded[name]
            if not param._initialized:
                param.initialize(ctx=ctx)
            elif ctx is not None:
                param.reset_ctx(ctx)
            param.set_data(getattr(value, "_data", value))
            restored.add(id(param))
        if not allow_missing:
            for name, param in params.items():
                if name in loaded or id(param) in restored:
                    continue
                if require_all or param._initialized:
                    raise MXNetError("Parameter %s missing in %s"
                                     % (name, source))
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise MXNetError("%s has extra parameters: %s"
                                 % (source, sorted(extra)))

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a ``save_parameters`` file of either package (npz or the
        reference's binary ``.params``) into the parameters, each keeping
        its dtype (``cast_dtype``/``dtype_source`` are accepted and, as in
        the JAX package, change nothing).  A parameter with no values yet
        is placed on ``ctx`` (default the current context)."""
        from .. import ndarray as nd
        from ..context import cpu

        self._apply_loaded(nd.load(filename, ctx=cpu()),
                           "file %s" % filename, ctx, allow_missing,
                           ignore_extra, require_all=True)

    def save_checkpoint(self, root, step=0, **manager_kwargs):
        """Save the parameters as one ``mx.checkpoint`` step under
        directory ``root`` (manifest, checksums, ``COMMITTED`` marker); a
        parameter held under several names is written once.  Returns the
        committed directory."""
        params = dict(self._initialized_params(deduplicate=True))
        if self.collect_params() and not params:
            raise MXNetError(
                "save_checkpoint: no parameter is initialized yet -- a "
                "zero-leaf checkpoint would restore nothing; run a "
                "forward pass (or pass static shapes) first")
        mgr = cached_manager(self, root, **manager_kwargs)
        return mgr.save(step, params)

    def load_checkpoint(self, root, step=None, ctx=None,
                        allow_missing=False, ignore_extra=False):
        """Restore the parameters from a ``save_checkpoint`` directory of
        either package (default: the latest committed step).  The leaves
        are read onto ``ctx``, else the parameters' device, else the
        current context.  Returns the restored step."""
        mgr = cached_manager(self, root)
        where = ctx if ctx is not None else self._param_device()
        step, loaded = mgr.restore(step=step, ctx=where)
        if self.collect_params() and not loaded:
            raise MXNetError(
                "load_checkpoint: step %d of %s contains no parameters "
                "-- restoring it would silently keep the random init"
                % (step, root))
        # require_all=False: save_checkpoint skips parameters without
        # values, so one without values on both sides is not an error
        self._apply_loaded(loaded, "checkpoint %s" % root, ctx,
                           allow_missing, ignore_extra, require_all=False)
        return step

    def load_dict(self, param_dict, ctx=None, allow_missing=False,
                  ignore_extra=False):
        """Copy ``param_dict`` ({name: tensor, NDArray or array}) into the
        parameters of the same names; as in the JAX package, a name left
        over is ignored."""
        for name, param in self.collect_params().items():
            if name in param_dict:
                value = param_dict[name]
                param.set_data(getattr(value, "_data", value))
            elif not allow_missing:
                raise MXNetError("Parameter %s missing" % name)


class HybridBlock(Block):
    """A block the JAX package can trace into one compiled program.

    ``hybridize()`` is accepted and does nothing in this port: blocks run
    eagerly, and there is no ``torch.compile``."""

    def hybridize(self, active=True, **kwargs):
        """Accepted for API parity; does nothing (eager execution)."""
