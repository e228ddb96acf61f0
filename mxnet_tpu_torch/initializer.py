"""Weight initializers: ``Uniform`` (the default), ``Normal``, ``Constant``,
``Zero``, ``One`` and ``Xavier``, with ``register``/``create``.

Counterpart of ``mxnet_tpu/initializer.py``.  An initializer fills a
parameter in place, drawing from the port's generator of the parameter's
device (``random.generator``).  As there, ``init_weight`` dispatches on the
name: ``*bias`` and ``*beta`` get zeros, ``*gamma`` ones, the rest the
initializer's own draw.
"""
from __future__ import annotations

import math

import torch

from . import random as _random
from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Constant", "Zero", "One",
           "Xavier", "register", "create"]

_INIT_REGISTRY = {}
_ALIASES = {"zeros": "zero", "ones": "one", "gaussian": "normal"}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer) or callable(name):
        return name
    key = _ALIASES.get(name.lower(), name.lower())
    if key not in _INIT_REGISTRY:
        raise MXNetError("unknown initializer %r" % name)
    return _INIT_REGISTRY[key](**kwargs)


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr):
        """Fill tensor ``arr`` (the parameter called ``name``) in place."""
        with torch.no_grad():
            self.init_weight(str(name), arr)

    def init_weight(self, name, arr):
        if name.endswith("bias") or name.endswith("beta"):
            arr.zero_()
        elif name.endswith("gamma"):
            arr.fill_(1.0)
        else:
            self._init_weight(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._kwargs)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        _random.uniform(-self.scale, self.scale, out=arr)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        _random.normal(0.0, self.sigma, out=arr)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        arr.fill_(self.value)


@register
class Zero(Constant):
    def __init__(self):
        super().__init__(0.0)


@register
class One(Constant):
    def __init__(self):
        super().__init__(1.0)


@register
class Xavier(Initializer):
    """rnd_type uniform/gaussian, factor_type avg/in/out, weight layout
    (out, in, *kernel)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError("Xavier requires ndim >= 2, got %s for %s"
                             % (tuple(shape), name))
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _random.uniform(-scale, scale, out=arr)
        else:
            _random.normal(0.0, scale, out=arr)
