"""Basic layers: Dense, Dropout, LayerNorm, Embedding and
HybridSequential.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``.  Parameter names
and layouts match (Dense weight (units, in_units), LayerNorm gamma/beta,
Embedding weight (input_dim, output_dim)).  Shapes are static: ``in_units``
and ``in_channels`` must be given, as every layer of BERT gives them.
Parameters are trainable ``gluon.Parameter``s, created zero-filled
(LayerNorm gamma one) on the CPU; ``Block.initialize`` moves and fills them,
or weights come in through ``convert.load_jax_params``.
"""
from __future__ import annotations

import torch

from ... import autograd
from ... import random as _random
from ...base import MXNetError
from ...ops import nn as F
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["HybridSequential", "Dense", "Dropout", "LayerNorm", "Embedding"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _param(shape, dtype="float32", fill=0.0):
    return Parameter(torch.full(tuple(shape), fill, dtype=_DTYPES[dtype]),
                     grad_req="write")


def _static(n, what, layer):
    if not n:
        raise MXNetError("%s needs %s: deferred shape inference is not "
                         "ported" % (layer, what))
    return int(n)


class HybridSequential(HybridBlock):
    """Stack of blocks; children are named "0", "1", ..."""

    def __init__(self, *blocks):
        super().__init__()
        self.add(*blocks)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x)
        return x

    def __iter__(self):
        return iter(self._modules.values())


class Dense(HybridBlock):
    """Fully-connected layer, weight layout (units, in_units)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", in_units=0, **kwargs):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self._activation = activation
        in_units = _static(in_units, "in_units", "Dense")
        self.weight = _param((units, in_units), dtype)
        self.bias = _param((units,), dtype) if use_bias else None

    def forward(self, x):
        out = F.fully_connected(x, self.weight, self.bias,
                                num_hidden=self._units,
                                flatten=self._flatten,
                                no_bias=self.bias is None)
        if self._activation:
            out = F.activation(out, act_type=self._activation)
        return out


class Dropout(HybridBlock):
    """Drops while ``autograd.is_training()`` (inside ``record()``), with a
    mask from the port's generator of x's device; identity otherwise."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__()
        if axes:
            raise MXNetError("Dropout(axes=...) is not ported")
        self._rate = rate

    def forward(self, x):
        if not autograd.is_training() or self._rate <= 0.0:
            return x
        return F.dropout(x, self._rate, _random.generator(x.device))


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, in_channels=0, **kwargs):
        super().__init__()
        self._axis = axis
        self._eps = epsilon
        c = _static(in_channels, "in_channels", "LayerNorm")
        self.gamma = _param((c,), fill=1.0)
        self.beta = _param((c,))

    def forward(self, x):
        return F.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                            eps=self._eps)


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32", **kwargs):
        super().__init__()
        self.weight = _param((input_dim, output_dim), dtype)

    def forward(self, x):
        return F.embedding(x, self.weight)
