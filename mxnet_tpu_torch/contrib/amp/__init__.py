"""Automatic mixed precision.

Counterpart of ``mxnet_tpu/contrib/amp/__init__.py``.

The parameter half: ``convert_model`` casts a block's parameters to the
target dtype in place and leaves those whose last name component is in
``FP32_PARAM_SUFFIXES`` (normalisation scales, shifts and statistics) in
float32; ``parallel.FusedTrainer`` reads the same suffixes for its
compute copies.

The op half: ``init(target_dtype)`` turns on the per-op rewrite of
``lists.py`` (``target_dtype`` ops compute in bf16 or fp16, ``fp32`` ops
in float32, ``widest`` ops promote), which every rewritten op applies at
its call (``ops.registry.amp_rewritten``), so ``mx.nd`` and the Gluon
layers alike; parameters stay float32 and so do their gradients.
``init`` first checks that the rewrite reaches the ops the Gluon layers
call and raises if it does not, rather than train in float32 without a
word.  ``LossScaler`` is the dynamic loss scaler of fp16 training:
``scale`` the loss, and after the backward ``has_overflow`` (a fused
check and one host read for all the gradients), ``unscale`` (in place),
skip the update on an overflow, and ``update_scale``.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from . import lists  # noqa: F401
from .lists import (FP32_OPS, TARGET_DTYPE_OPS, WIDEST_OPS,  # noqa: F401
                    category_of, classification)

__all__ = ["FP32_PARAM_SUFFIXES", "keeps_fp32", "convert_model",
           "convert_hybrid_block", "init", "amp_init", "disable",
           "is_active", "target_dtype", "init_trainer", "LossScaler"]

# parameters that stay f32 under mixed precision
FP32_PARAM_SUFFIXES = ("gamma", "beta", "running_mean", "running_var",
                       "moving_mean", "moving_var")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_TARGETS = ("bfloat16", "float16")
_last = {"dtype": "bfloat16"}   # what ``target_dtype()`` names

# the ops the Gluon layers call (``gluon/nn``, the model zoo, the losses):
# ``init`` refuses to run if any of them misses the rewrite
_LAYER_OPS = ("fully_connected", "convolution", "deconvolution", "dot",
              "multi_head_attention", "batch_norm", "layer_norm",
              "group_norm", "instance_norm", "rms_norm", "softmax",
              "log_softmax", "softmax_cross_entropy", "ctc_loss")


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


def _check_reach():
    """The rewrite must be what the layers and ``mx.nd`` call: each of
    ``_LAYER_OPS`` in ``ops.nn`` and every registered op that
    ``classification`` does not pass through carries it."""
    from ...ops import nn as ops_nn
    from ...ops import registry

    missing = [n for n in _LAYER_OPS
               if not hasattr(getattr(ops_nn, n), "amp_category")]
    missing += [n for n, cat in classification().items()
                if cat != "passthrough" and getattr(
                    registry.get_op(n).fn, "amp_category", None) != cat]
    if missing:
        raise MXNetError("amp.init: the op rewrite does not reach %s"
                         % sorted(set(missing)))


def init(target_dtype="bfloat16"):
    """Turn on the per-op rewrite: from here on, ``TARGET_DTYPE_OPS``
    compute in ``target_dtype`` ('bfloat16' or 'float16') and
    ``FP32_OPS`` in float32, on every path."""
    from ...ops import registry

    if str(target_dtype) not in _TARGETS:
        raise MXNetError("amp.init: target_dtype must be one of %s, got %r"
                         % (_TARGETS, target_dtype))
    _check_reach()
    _last["dtype"] = str(target_dtype)
    registry.AMP.dtype = _DTYPES[str(target_dtype)]


amp_init = init


def disable():
    """Turn the per-op rewrite off."""
    from ...ops import registry

    registry.AMP.dtype = None


def is_active():
    from ...ops import registry

    return registry.AMP.dtype is not None


def target_dtype():
    """The name of the last ``init``'s target dtype ('bfloat16' before
    any)."""
    return _last["dtype"]


def init_trainer(trainer):
    """Give ``trainer`` its loss scaler (``trainer._amp_loss_scaler``, a
    ``LossScaler``); returns the trainer."""
    trainer._amp_loss_scaler = LossScaler()
    return trainer


def _tensor(g):
    return g._data if hasattr(g, "_data") else g


class LossScaler:
    """Dynamic loss scaler: ``loss_scale`` starts at ``init_scale``, halves
    (by ``scale_factor``, not below 1) on an overflow and grows by it after
    ``scale_window`` steps without one."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.05):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def scale(self, loss):
        return loss * self.loss_scale

    def unscale(self, grads):
        """Divide each gradient (tensors or NDArrays) by ``loss_scale`` in
        place."""
        ts = [_tensor(g) for g in grads]
        if ts:
            torch._foreach_mul_(ts, 1.0 / self.loss_scale)

    def has_overflow(self, grads):
        """Whether any gradient holds a non-finite value: PyTorch's fused
        check (``_amp_foreach_non_finite_check_and_unscale_``, a few
        multi-tensor launches for each device and dtype) with a scale of
        1, which leaves every value as it is, then one host read."""
        groups = {}
        for g in grads:
            t = _tensor(g)
            groups.setdefault((t.device, t.dtype), []).append(t)
        if not groups:
            return False
        found = []
        for (device, _), ts in groups.items():
            flag = torch.zeros(1, device=device)
            torch._amp_foreach_non_finite_check_and_unscale_(
                ts, flag, torch.ones(1, device=device))
            found.append(flag.to(found[0].device) if found else flag)
        return bool(torch.cat(found).any())

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
