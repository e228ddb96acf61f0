"""Structured error classes: ``MXNetError`` subclasses keyed by kind, so
callers can catch precisely.

Counterpart of ``mxnet_tpu/error.py``, kept as a copy.  ``register_error``
maps a kind string to a class; ``base.MXNetError`` stays the root.  Each
class also subclasses the matching builtin, so ``except ValueError`` and
``except mx.error.ValueError`` both work."""
from __future__ import annotations

import builtins

from .base import MXNetError

__all__ = ["MXNetError", "register_error", "InternalError", "ValueError",
           "TypeError", "IndexError", "KeyError", "AttributeError",
           "NotImplementedForSymbol"]

_ERROR_TYPES = {}


def register_error(func_name=None, cls=None):
    """Register an error class under its name (reference error.py:31;
    bare-decorator and named forms both supported)."""
    if callable(func_name) and cls is None:
        klass = func_name
        _ERROR_TYPES[klass.__name__] = klass
        return klass

    def deco(klass):
        _ERROR_TYPES[func_name or klass.__name__] = klass
        return klass

    return deco


@register_error
class InternalError(MXNetError):
    """Framework-internal invariant violation [error.py:47]."""


@register_error("ValueError")
class ValueError(MXNetError, builtins.ValueError):  # noqa: A001
    pass


@register_error("TypeError")
class TypeError(MXNetError, builtins.TypeError):  # noqa: A001
    pass


@register_error("IndexError")
class IndexError(MXNetError, builtins.IndexError):  # noqa: A001
    pass


@register_error("KeyError")
class KeyError(MXNetError, builtins.KeyError):  # noqa: A001
    pass


@register_error("AttributeError")
class AttributeError(MXNetError, builtins.AttributeError):  # noqa: A001
    pass


class NotImplementedForSymbol(MXNetError):
    """Raised when an NDArray-only API is called on a Symbol
    [reference base.py:1420]."""

    def __init__(self, function, alias=None, *args):
        super().__init__()
        self.function = function.__name__ if callable(function) \
            else str(function)
        self.alias = alias

    def __str__(self):
        msg = "Function %s is not implemented for Symbol" % self.function
        if self.alias:
            msg += " (use %s instead)" % self.alias
        return msg
