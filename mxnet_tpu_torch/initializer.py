"""Weight initializers: ``Uniform`` (the default), ``Normal``, ``Constant``,
``Zero``, ``One``, ``Xavier``, ``MSRAPrelu``, ``Orthogonal``, ``Bilinear``,
``LSTMBias`` and ``Mixed``, with ``InitDesc`` and ``register``/``create``.

Counterpart of ``mxnet_tpu/initializer.py``.  An initializer fills a
parameter in place, drawing from the port's generator of the parameter's
device (``random.generator``).  As there, ``init_weight`` dispatches on the
name: ``*bias`` and ``*beta`` get zeros, ``*gamma`` ones, running (moving)
means zeros and variances ones, the rest the initializer's own draw.
``Orthogonal`` draws its matrix from the CPU generator (the JAX package
draws it from numpy's global state) and takes its SVD there.
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Constant", "Zero", "One",
           "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear", "LSTMBias",
           "Mixed", "InitDesc", "register", "create"]

_INIT_REGISTRY = {}
_ALIASES = {"zeros": "zero", "ones": "one", "gaussian": "normal",
            "msra": "msraprelu"}


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


class InitDesc(str):
    """The name of what is being initialized, with its attributes."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


def _fill(arr, value):
    """Copy a numpy array into ``arr`` in place, in its dtype."""
    arr.copy_(torch.from_numpy(np.asarray(value, dtype=np.float32)))


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
        elif "running_mean" in name or "moving_mean" in name:
            arr.zero_()
        elif "running_var" in name or "moving_var" in name:
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
        _random.uniform_tensor(-self.scale, self.scale, out=arr)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        _random.normal_tensor(0.0, self.sigma, out=arr)


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
            _random.uniform_tensor(-scale, scale, out=arr)
        else:
            _random.normal_tensor(0.0, scale, out=arr)


@register
class MSRAPrelu(Xavier):
    """Xavier with gaussian draws and magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal basis (the SVD factor of the
    weight's shape, flattened to (out, prod(rest))) of a uniform [-1, 1)
    or normal draw."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        if self.rand_type == "uniform":
            tmp = _random.uniform_tensor(-1.0, 1.0, (nout, nin), torch.float64)
        else:
            tmp = _random.normal_tensor(0.0, 1.0, (nout, nin), torch.float64)
        u, _, v = np.linalg.svd(tmp.numpy(), full_matrices=False)
        q = u if u.shape == tmp.shape else v
        _fill(arr, (self.scale * q).reshape(arr.shape))


@register
class Bilinear(Initializer):
    """Bilinear up-sampling weights over the last two axes."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        n = math.prod(shape)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(n)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c)))
        _fill(arr, weight.astype(np.float32).reshape(shape))


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter set to ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = np.zeros(arr.shape, dtype=np.float32)
        num_hidden = int(b.shape[0] / 4)
        b[num_hidden:2 * num_hidden] = self.forget_bias
        _fill(arr, b)


class Mixed:
    """The first initializer whose pattern matches the name (``re.match``)
    fills the parameter; no match raises."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("Mixed: %d patterns for %d initializers"
                             % (len(patterns), len(initializers)))
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise MXNetError("no initializer pattern matches %r" % str(name))
