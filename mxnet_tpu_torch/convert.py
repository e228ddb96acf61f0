"""Weights across the package boundary.

``load_jax_params`` is the one way weights cross from the JAX package:
the caller turns the JAX block's parameters into numpy arrays by name,
``{k: v.data().asnumpy() for k, v in jax_net.collect_params().items()}``,
and this module copies them into the port's block of the same structure.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .gluon.parameter import _compatible

__all__ = ["load_jax_params"]


def load_jax_params(block, params):
    """Copy ``params`` ({structured name: numpy array}) into ``block``.

    Strict: every parameter of ``block`` must be named in ``params``, no
    name may be left over, and every shape must match; otherwise it raises
    ``MXNetError`` and changes nothing.  A parameter whose shape is still
    deferred (a 0 in it) takes the array's shape where the known sizes
    agree.  Values keep each parameter's dtype and device."""
    own = block.collect_params()
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise MXNetError("load_jax_params: missing %s, unexpected %s"
                         % (missing, extra))
    arrays = {}
    for name, p in own.items():
        a = np.array(params[name])  # a writable copy
        want = tuple(p.shape)
        if not (_compatible(p._partial, a.shape) if p._needs_shape()
                else tuple(a.shape) == want):
            raise MXNetError("load_jax_params: %s has shape %s, the block "
                             "expects %s" % (name, tuple(a.shape),
                                             want))
        arrays[name] = a
    for name, p in own.items():
        p.set_data(torch.from_numpy(arrays[name]))
    return block
