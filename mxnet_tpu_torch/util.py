"""np-mode switches and small helpers (``mx.util``).

Counterpart of ``mxnet_tpu/util.py``.  In the reference these flags flip
global C++ state (``MXSetIsNumpyShape``).  In the port, as in the JAX
package, numpy semantics are always on (torch tensors are numpy-shaped):
the flags are kept per thread so that scripts which set them, and code
that asks ``is_np_array()``, run unchanged.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

_state = threading.local()


def _get(flag, default=True):
    return getattr(_state, flag, default)


def set_np_shape(active=True):
    prev = _get("np_shape")
    _state.np_shape = active
    return prev


def is_np_shape():
    return _get("np_shape")


def set_np_array(active=True):
    prev = _get("np_array")
    _state.np_array = active
    return prev


def is_np_array():
    return _get("np_array")


def set_np(shape=True, array=True, dtype=False):
    set_np_shape(shape)
    set_np_array(array)


def reset_np():
    set_np(True, True)


def use_np(func):
    """Decorator form (reference ``util.use_np``): numpy semantics are
    always on, so it returns ``func`` (a function or a class) as it is."""
    return func


def use_np_shape(func):
    return func


def use_np_array(func):
    return func


@contextlib.contextmanager
def _flag(setter, active):
    prev = setter(active)
    try:
        yield
    finally:
        setter(prev)


def np_shape(active=True):
    return _flag(set_np_shape, active)


def np_array(active=True):
    return _flag(set_np_array, active)


def wrap_ctx_to_device_func(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if "device" in kwargs and "ctx" not in kwargs:
            kwargs["ctx"] = kwargs.pop("device")
        return func(*args, **kwargs)

    return wrapper


def get_cuda_compute_capability(ctx):
    """The card's compute capability as ``10 * major + minor`` (90 on an
    H100); None for a context that is not a card."""
    if getattr(ctx, "device_type", None) != "gpu":
        return None
    major, minor = torch.cuda.get_device_capability(ctx.device_id)
    return 10 * major + minor
