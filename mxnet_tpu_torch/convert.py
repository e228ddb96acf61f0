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

__all__ = ["load_jax_params"]


def load_jax_params(block, params):
    """Copy ``params`` ({structured name: numpy array}) into ``block``.

    Strict: every parameter of ``block`` must be named in ``params``, no
    name may be left over, and every shape must match; otherwise it raises
    ``MXNetError`` and changes nothing.  Values keep each parameter's
    dtype and device."""
    own = block.collect_params()
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise MXNetError("load_jax_params: missing %s, unexpected %s"
                         % (missing, extra))
    arrays = {}
    for name, p in own.items():
        a = np.array(params[name])  # a writable copy
        if tuple(a.shape) != tuple(p.shape):
            raise MXNetError("load_jax_params: %s has shape %s, the block "
                             "expects %s" % (name, tuple(a.shape),
                                             tuple(p.shape)))
        arrays[name] = a
    for name, p in own.items():
        p.set_data(torch.from_numpy(arrays[name]))
    return block
