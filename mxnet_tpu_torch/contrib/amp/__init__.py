"""Automatic mixed precision: the parameter half.

Counterpart of ``mxnet_tpu/contrib/amp/__init__.py``.  ``convert_model``
casts a block's parameters to the target dtype in place and leaves those
whose last name component is in ``FP32_PARAM_SUFFIXES`` (normalisation
scales, shifts and statistics) in float32; ``parallel.FusedTrainer`` reads
the same suffixes for its compute copies.

The op half (``init``: the per-op target/f32 lists applied at op-invoke
time) needs the op registry, which is not ported: ``init`` and
``amp_init`` raise.
"""
from __future__ import annotations

import torch

from ...base import MXNetError

__all__ = ["FP32_PARAM_SUFFIXES", "keeps_fp32", "convert_model",
           "convert_hybrid_block", "init", "amp_init"]

# parameters that stay f32 under mixed precision
FP32_PARAM_SUFFIXES = ("gamma", "beta", "running_mean", "running_var",
                       "moving_mean", "moving_var")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def keeps_fp32(name):
    """Whether the parameter called ``name`` stays float32."""
    return name.split(".")[-1] in FP32_PARAM_SUFFIXES


def _dtype(target_dtype):
    if isinstance(target_dtype, torch.dtype):
        return target_dtype
    try:
        return _DTYPES[str(target_dtype)]
    except KeyError:
        raise MXNetError("unsupported amp target dtype %r (have %s)"
                         % (target_dtype, sorted(_DTYPES))) from None


def convert_model(block, target_dtype="bfloat16"):
    """Cast ``block``'s parameters to ``target_dtype`` in place, except
    the normalisation ones (``FP32_PARAM_SUFFIXES``); returns ``block``.
    Each cast parameter loses its gradient."""
    dtype = _dtype(target_dtype)
    for name, param in block.collect_params().items():
        if keeps_fp32(name):
            continue
        param.data = param.data.to(dtype)
        param.grad = None
    return block


convert_hybrid_block = convert_model


def init(target_dtype="bfloat16"):
    raise MXNetError("amp.init is not ported: the per-op precision lists "
                     "need the op registry (use convert_model, or "
                     "parallel.FusedTrainer(dtype=...))")


amp_init = init

