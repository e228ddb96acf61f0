"""Gluon blocks over ``torch.nn.Module``.

Counterpart of ``mxnet_tpu/gluon/block.py``.  A ``Block`` is an
``nn.Module`` whose parameters carry the JAX package's structured names
(``encoder.layers.0.attention.query_proj.weight``), so weights cross
between the two packages by name (``convert.load_jax_params``).

Blocks start in inference mode (``training`` False), as the JAX package's
blocks run outside ``autograd.record()``.
"""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

__all__ = ["Block", "HybridBlock"]


class Block(nn.Module):
    """Base block: an ``nn.Module`` with Gluon's parameter naming."""

    def __init__(self):
        super().__init__()
        self.training = False

    def collect_params(self):
        """Structured-name parameter dict ``{name: torch.nn.Parameter}``."""
        return OrderedDict(self.named_parameters())

    def register_child(self, block, name=None):
        name = name or str(len(self._modules))
        self.add_module(name, block)
        return block


class HybridBlock(Block):
    """A block the JAX package can trace into one compiled program.

    ``hybridize()`` is accepted and does nothing in this port: blocks run
    eagerly, and there is no ``torch.compile``."""

    def hybridize(self, active=True, **kwargs):
        """Accepted for API parity; does nothing (eager execution)."""
