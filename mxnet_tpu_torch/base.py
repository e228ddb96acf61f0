"""Base utilities: the framework error type, the typed env reader and the
dtype rules.

Counterpart of ``mxnet_tpu/base.py``, kept as a copy so the port never
imports the JAX package.  The JAX package runs with 64-bit types off, so
an ``int64`` or ``float64`` it is given becomes ``int32`` or ``float32``;
``_as_torch_dtype`` and ``_canonical`` give the port the same rule.
"""
from __future__ import annotations

import os

import numpy as _np
import torch

__all__ = ["MXNetError", "get_env", "string_types", "numeric_types",
           "integer_types", "_as_np_dtype"]

string_types = (str,)
numeric_types = (float, int, _np.generic)
integer_types = (int, _np.integer)


class MXNetError(RuntimeError):
    """Framework error type."""


def get_env(name, dtype=str, default=None):
    """Typed environment-variable reader (``MXNET_*`` runtime config)."""
    val = os.environ.get(name)
    if val is None:
        return default
    if dtype is bool:
        return val.lower() not in ("0", "false", "off", "")
    return dtype(val)


def _bfloat16():
    """numpy's bfloat16 (``ml_dtypes``), or None where it is not
    installed."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return _np.dtype(ml_dtypes.bfloat16)


_DTYPE_ALIASES = {
    "float32": _np.float32,
    "float64": _np.float64,
    "float16": _np.float16,
    "uint8": _np.uint8,
    "int8": _np.int8,
    "int32": _np.int32,
    "int64": _np.int64,
    "bool": _np.bool_,
}


def _as_np_dtype(dtype):
    """A dtype name, numpy dtype, Python type or ``torch.dtype`` -> the
    numpy dtype (bfloat16 needs ``ml_dtypes``)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            dtype = "bfloat16"
        else:
            return _np.dtype(torch.empty((), dtype=dtype).numpy().dtype)
    if isinstance(dtype, str):
        if dtype == "bfloat16":
            bf16 = _bfloat16()
            if bf16 is None:
                raise MXNetError("bfloat16 as a numpy dtype needs ml_dtypes")
            return bf16
        if dtype in _DTYPE_ALIASES:
            return _np.dtype(_DTYPE_ALIASES[dtype])
    return _np.dtype(dtype)


# 64-bit types become 32-bit ones, as in the JAX package (x64 off)
_CANONICAL = {torch.int64: torch.int32, torch.float64: torch.float32,
              torch.complex128: torch.complex64}
_NP_TO_TORCH = {
    _np.dtype(_np.float32): torch.float32, _np.dtype(_np.float64):
    torch.float32, _np.dtype(_np.float16): torch.float16,
    _np.dtype(_np.uint8): torch.uint8, _np.dtype(_np.int8): torch.int8,
    _np.dtype(_np.int16): torch.int16, _np.dtype(_np.int32): torch.int32,
    _np.dtype(_np.int64): torch.int32, _np.dtype(_np.bool_): torch.bool,
    _np.dtype(_np.complex64): torch.complex64,
    _np.dtype(_np.complex128): torch.complex64}


def _as_torch_dtype(dtype):
    """A dtype name, numpy dtype, Python type or ``torch.dtype`` -> the
    ``torch.dtype`` the JAX package would give (64-bit types narrowed)."""
    if isinstance(dtype, torch.dtype):
        return _CANONICAL.get(dtype, dtype)
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    if getattr(dtype, "name", None) == "bfloat16":   # ml_dtypes' bfloat16
        return torch.bfloat16
    try:
        return _NP_TO_TORCH[_np.dtype(dtype)]
    except (KeyError, TypeError):
        raise MXNetError("unsupported dtype %r" % (dtype,)) from None


def _canonical(t):
    """``t`` with a 64-bit dtype narrowed as the JAX package narrows it."""
    to = _CANONICAL.get(t.dtype)
    return t if to is None else t.to(to)
