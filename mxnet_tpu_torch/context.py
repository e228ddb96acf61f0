"""Device context: ``cpu()`` and ``gpu(i)`` name a ``torch.device``.

Counterpart of ``mxnet_tpu/context.py``.  The default context is
``gpu(0)``: entry points run on the card unless the caller passes
``ctx=mx.cpu()``.  Asking for the card where there is none raises; nothing
falls back to the CPU behind the caller's back.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "device_of"]


class Context:
    """A device context: (device_type, device_id)."""

    def __init__(self, device_type, device_id=0):
        if device_type not in ("cpu", "gpu"):
            raise MXNetError("unknown device type %r (have cpu, gpu)"
                             % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self):
        """The ``torch.device`` this context names; raises for a card
        that is not there."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if self.device_id >= n:
            raise MXNetError(
                "%r needs a CUDA device, but this process sees %d; pass "
                "ctx=mx.cpu() to run on the CPU" % (self, n))
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def current_context():
    """The default context: the first card."""
    return gpu(0)


def device_of(ctx=None):
    """``ctx`` (default ``current_context()``) -> ``torch.device``."""
    return (ctx if ctx is not None else current_context()).torch_device
