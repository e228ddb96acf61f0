"""Base utilities: the framework error type and the typed env reader.

Counterpart of ``mxnet_tpu/base.py``, kept as a copy so the port never
imports the JAX package.
"""
from __future__ import annotations

import os

__all__ = ["MXNetError", "get_env"]


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
