"""Device context: ``cpu()``, ``cpu_pinned()`` and ``gpu(i)`` name a
``torch.device``.

Counterpart of ``mxnet_tpu/context.py``.  The default context is
``gpu(0)``: entry points run on the card unless the caller passes
``ctx=mx.cpu()`` or opens a ``with mx.cpu():`` scope, which makes its
context the default on this thread until the scope ends.  Asking for the
card where there is none raises; nothing falls back to the CPU behind the
caller's back.

``cpu_pinned()`` is the CPU with page-locked memory: a tensor placed there
(``ctx.place``) is pinned, so a ``non_blocking`` copy to the card is a
true asynchronous DMA.  Pinning needs CUDA, so on a host
without a card it raises, as ``gpu(0)`` does; it never hands back
unpinned memory.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "cpu_pinned", "gpu", "current_context",
           "device_of", "num_gpus"]


class Context:
    """A device context: (device_type, device_id); ``with ctx:`` makes it
    the default context."""

    _default_ctx = threading.local()   # .stack: the open scopes

    def __init__(self, device_type, device_id=0):
        if device_type not in ("cpu", "cpu_pinned", "gpu"):
            raise MXNetError("unknown device type %r (have cpu, cpu_pinned, "
                             "gpu)" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self):
        """The ``torch.device`` this context names; raises for a card
        that is not there."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        n = num_gpus()
        if self.device_type == "cpu_pinned":
            if n == 0:
                raise MXNetError(
                    "%r needs CUDA to pin memory, but this "
                    "process sees no card; use mx.cpu()" % (self,))
            return torch.device("cpu")
        if self.device_id >= n:
            raise MXNetError(
                "%r needs a CUDA device, but this process sees %d; pass "
                "ctx=mx.cpu() to run on the CPU" % (self, n))
        return torch.device("cuda", self.device_id)

    def place(self, tensor, copy=False):
        """``tensor`` on this context (a copy when ``copy``): moved to its
        device, and page-locked for ``cpu_pinned``."""
        out = tensor.to(self.torch_device, copy=copy)
        if self.device_type == "cpu_pinned" and not out.is_pinned():
            out = out.pin_memory()
        return out

    @classmethod
    def from_device(cls, device):
        """The context of a ``torch.device``."""
        if device.type == "cuda":
            return cls("gpu", device.index or 0)
        return cls("cpu", 0)

    @classmethod
    def of(cls, tensor):
        """The context of a tensor: ``cpu_pinned`` for page-locked CPU
        memory."""
        if tensor.device.type == "cpu" and tensor.is_pinned():
            return cls("cpu_pinned", 0)
        return cls.from_device(tensor.device)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __enter__(self):
        if not hasattr(self._default_ctx, "stack"):
            self._default_ctx.stack = []
        self._default_ctx.stack.append(self)
        return self

    def __exit__(self, *args):
        self._default_ctx.stack.pop()


def cpu(device_id=0):
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def num_gpus():
    """The CUDA devices this process sees."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The default context: the innermost open ``with ctx:`` scope of
    this thread, else the first card."""
    stack = getattr(Context._default_ctx, "stack", None)
    if stack:
        return stack[-1]
    return gpu(0)


def device_of(ctx=None):
    """``ctx`` (default ``current_context()``) -> ``torch.device``."""
    return (ctx if ctx is not None else current_context()).torch_device
