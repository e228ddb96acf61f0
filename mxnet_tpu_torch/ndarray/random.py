"""``mx.nd.random``: sampling functions over the registry's random ops.

Counterpart of the sampling half of ``mxnet_tpu/random.py``, which the JAX
package exposes as ``mx.nd.random``.  Each function calls its
``ops/random_ops.py`` op, so every draw comes from the port's generator
of the output's device (``mx.random.generator``); ``seed`` seeds them all.
Arrays are made on ``ctx`` (default the current context) and written into
``out`` when it is given.
"""
from __future__ import annotations

import torch

from ..ops.registry import get_op
from ..random import seed  # noqa: F401
from .ndarray import NDArray

__all__ = ["seed", "uniform", "normal", "randn", "randint", "gamma",
           "exponential", "poisson", "negative_binomial",
           "generalized_negative_binomial", "multinomial", "shuffle"]


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _draw(name, params, shape, dtype, ctx, out, **attrs):
    """The ``sample_*`` op when a parameter is an NDArray (a scalar one
    filled to its shape), else the ``random_*`` op."""
    like = next((p for p in params.values() if isinstance(p, NDArray)),
                None)
    if like is not None:
        args = [p if isinstance(p, NDArray)
                else NDArray(torch.full_like(like._data, float(p)))
                for p in params.values()]
        res = get_op("sample_" + name)(*args, shape=shape, dtype=dtype)
    else:
        res = get_op("random_" + name)(**params, shape=_shape(shape),
                                       dtype=dtype, ctx=ctx, **attrs)
    if out is not None:
        out._data = res._data
        return out
    return res


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **kw):
    return _draw("uniform", {"low": low, "high": high}, shape, dtype, ctx,
                 out)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **kw):
    if isinstance(loc, NDArray) or isinstance(scale, NDArray):
        return _draw("normal", {"mu": loc, "sigma": scale}, shape, dtype,
                     ctx, out)
    return _draw("normal", {"loc": loc, "scale": scale}, shape, dtype, ctx,
                 out)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc, scale, shape, dtype=dtype, ctx=ctx)


def randint(low, high=None, shape=(1,), dtype="int32", ctx=None, out=None):
    if high is None:
        low, high = 0, low
    return _draw("randint", {"low": low, "high": high}, shape, dtype, ctx,
                 out)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None):
    return _draw("gamma", {"alpha": alpha, "beta": beta}, shape, dtype, ctx,
                 out)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _draw("exponential", {"lam": 1.0 / scale}, shape, dtype, ctx, out)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _draw("poisson", {"lam": lam}, shape, dtype, ctx, out)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None):
    return _draw("negative_binomial", {"k": k, "p": p}, shape, dtype, ctx,
                 out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None, out=None):
    return _draw("generalized_negative_binomial", {"mu": mu, "alpha": alpha},
                 shape, dtype, ctx, out)


def multinomial(data, shape=None, get_prob=False, dtype="int32", **kw):
    """Category indices drawn from (batched) probability rows."""
    return get_op("sample_multinomial")(data, shape=shape, get_prob=get_prob,
                                        dtype=dtype)


def shuffle(data, **kw):
    return get_op("shuffle")(data)
