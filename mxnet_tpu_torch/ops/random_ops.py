"""Sampling ops: the ``sample_*`` (tensor-parameter) and ``random_*``
(scalar-parameter) families and ``shuffle``, registered for ``mx.nd``.

Counterpart of ``mxnet_tpu/ops/random_ops.py``.  Every draw comes from the
port's explicit generator of the output's device (``random.generator``),
never from torch's global one.  A ``sample_*`` op draws one sample of
each element's distribution, with ``shape`` extra trailing dims; a
``random_*`` op with no tensor input draws on ``ctx`` (default the current
context).  Gamma draws use Marsaglia and Tsang's method on the generator's
normal and uniform draws (``torch._standard_gamma`` takes no generator).
The streams never match the JAX package's: tests check shapes, dtypes and
moments.  None of these ops is differentiable.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import _as_torch_dtype
from ..context import device_of
from .registry import register


def _extra(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _bcast(param, shape):
    """``param`` broadcast against the trailing sample dims: output shape
    param.shape + shape."""
    out = tuple(param.shape) + _extra(shape)
    return param.reshape(tuple(param.shape)
                         + (1,) * (len(out) - param.dim())).expand(out), out


def _uniform(shape, dtype, device):
    return torch.rand(shape, dtype=dtype, device=device,
                      generator=_random.generator(device))


def _normal(shape, dtype, device):
    return torch.randn(shape, dtype=dtype, device=device,
                       generator=_random.generator(device))


def _gamma(alpha):
    """Gamma(alpha, 1) draws of alpha's shape (float32): Marsaglia-Tsang
    rejection, with alpha < 1 boosted by U ** (1 / alpha)."""
    alpha = alpha.to(torch.float32)
    dev = alpha.device
    a = torch.where(alpha < 1.0, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        z = _normal(a.shape, torch.float32, dev)
        u = _uniform(a.shape, torch.float32, dev)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    boost = _uniform(a.shape, torch.float32, dev) ** (1.0 / alpha)
    return torch.where(alpha < 1.0, out * boost, out)


def _poisson(rate):
    return torch.poisson(rate.to(torch.float32),
                         generator=_random.generator(rate.device))


def _scalar(value, shape, device):
    return torch.full(shape, float(value), dtype=torch.float32,
                      device=device)


@register("sample_uniform", differentiable=False)
def sample_uniform(low, high, shape=None, dtype="float32"):
    lo, out = _bcast(low, shape)
    hi, _ = _bcast(high, shape)
    return lo + _uniform(out, _as_torch_dtype(dtype), low.device) * (hi - lo)


@register("sample_normal", differentiable=False)
def sample_normal(mu, sigma, shape=None, dtype="float32"):
    m, out = _bcast(mu, shape)
    s, _ = _bcast(sigma, shape)
    return m + s * _normal(out, _as_torch_dtype(dtype), mu.device)


@register("sample_gamma", differentiable=False)
def sample_gamma(alpha, beta, shape=None, dtype="float32"):
    """Gamma with shape ``alpha`` and scale ``beta``."""
    a, _ = _bcast(alpha, shape)
    b, _ = _bcast(beta, shape)
    return (_gamma(a) * b).to(_as_torch_dtype(dtype))


@register("sample_exponential", differentiable=False)
def sample_exponential(lam, shape=None, dtype="float32"):
    l, out = _bcast(lam, shape)
    e = torch.empty(out, dtype=_as_torch_dtype(dtype), device=lam.device)
    return e.exponential_(generator=_random.generator(lam.device)) / l


@register("sample_poisson", differentiable=False)
def sample_poisson(lam, shape=None, dtype="float32"):
    l, _ = _bcast(lam, shape)
    return _poisson(l).to(_as_torch_dtype(dtype))


@register("sample_negative_binomial", differentiable=False)
def sample_negative_binomial(k, p, shape=None, dtype="float32"):
    """NB(k failures, success probability p) as a Gamma-Poisson mixture."""
    kk, _ = _bcast(k, shape)
    pp, _ = _bcast(p, shape)
    rate = _gamma(kk) * (1.0 - pp) / pp
    return _poisson(rate).to(_as_torch_dtype(dtype))


@register("sample_generalized_negative_binomial", differentiable=False)
def sample_generalized_negative_binomial(mu, alpha, shape=None,
                                         dtype="float32"):
    """Poisson with a Gamma(1/alpha, mu*alpha) rate."""
    m, _ = _bcast(mu, shape)
    a, _ = _bcast(alpha, shape)
    rate = _gamma(1.0 / torch.clamp(a, min=1e-12)) * m * a
    return _poisson(rate).to(_as_torch_dtype(dtype))


@register("sample_multinomial", differentiable=False)
def sample_multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """Category draws from (batch, k) probabilities: output (batch,) +
    shape indices; with ``get_prob`` also their log-probabilities."""
    extra = _extra(shape)
    n = 1
    for s in extra:
        n *= s
    probs = data.reshape(-1, data.shape[-1]).to(torch.float32)
    idx = torch.multinomial(probs, n, replacement=True,
                            generator=_random.generator(data.device))
    out = idx.reshape(tuple(data.shape[:-1]) + extra)
    if get_prob:
        logp = torch.gather(torch.log_softmax(torch.log(torch.clamp(
            probs, min=1e-37)), dim=-1), -1, idx).reshape(out.shape)
        return out.to(_as_torch_dtype(dtype)), logp
    return out.to(_as_torch_dtype(dtype))


# ---- scalar-parameter family ------------------------------------------------


@register("random_uniform", differentiable=False)
def random_uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", ctx=None):
    dev = device_of(ctx)
    return low + _uniform(tuple(shape), _as_torch_dtype(dtype), dev) * (
        high - low)


@register("random_normal", differentiable=False)
def random_normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", ctx=None):
    return loc + scale * _normal(tuple(shape), _as_torch_dtype(dtype),
                                 device_of(ctx))


@register("random_gamma", differentiable=False)
def random_gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", ctx=None):
    a = _scalar(alpha, tuple(shape), device_of(ctx))
    return (_gamma(a) * beta).to(_as_torch_dtype(dtype))


@register("random_exponential", differentiable=False)
def random_exponential(lam=1.0, shape=(1,), dtype="float32", ctx=None):
    dev = device_of(ctx)
    e = torch.empty(tuple(shape), dtype=_as_torch_dtype(dtype), device=dev)
    return e.exponential_(generator=_random.generator(dev)) / lam


@register("random_poisson", differentiable=False)
def random_poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None):
    rate = _scalar(lam, tuple(shape), device_of(ctx))
    return _poisson(rate).to(_as_torch_dtype(dtype))


@register("random_negative_binomial", differentiable=False)
def random_negative_binomial(k=1, p=1.0, shape=(1,), dtype="float32",
                             ctx=None):
    rate = _gamma(_scalar(k, tuple(shape), device_of(ctx))) * (1.0 - p) / p
    return _poisson(rate).to(_as_torch_dtype(dtype))


@register("random_generalized_negative_binomial", differentiable=False)
def random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,),
                                         dtype="float32", ctx=None):
    a = _scalar(1.0 / max(alpha, 1e-12), tuple(shape), device_of(ctx))
    return _poisson(_gamma(a) * mu * alpha).to(_as_torch_dtype(dtype))


@register("random_randint", differentiable=False)
def random_randint(low=0, high=1, shape=(1,), dtype="int32", ctx=None):
    dev = device_of(ctx)
    return torch.randint(int(low), int(high), tuple(shape),
                         dtype=_as_torch_dtype(dtype), device=dev,
                         generator=_random.generator(dev))


@register("random_uniform_like", differentiable=False)
def random_uniform_like(data, low=0.0, high=1.0):
    return low + _uniform(data.shape, data.dtype, data.device) * (high - low)


@register("random_normal_like", differentiable=False)
def random_normal_like(data, loc=0.0, scale=1.0):
    return loc + scale * _normal(data.shape, data.dtype, data.device)


@register("shuffle", differentiable=False)
def shuffle(data):
    """A random permutation along axis 0."""
    perm = torch.randperm(data.shape[0], device=data.device,
                          generator=_random.generator(data.device))
    return data[perm]


@register("random_exponential_like", differentiable=False)
def random_exponential_like(data, lam=1.0):
    e = torch.empty_like(data)
    return e.exponential_(generator=_random.generator(data.device)) / lam


@register("random_gamma_like", differentiable=False)
def random_gamma_like(data, alpha=1.0, beta=1.0):
    a = _scalar(alpha, data.shape, data.device)
    return (_gamma(a) * beta).to(data.dtype)


@register("random_poisson_like", differentiable=False)
def random_poisson_like(data, lam=1.0):
    return _poisson(_scalar(lam, data.shape, data.device)).to(data.dtype)


@register("random_negative_binomial_like", differentiable=False)
def random_negative_binomial_like(data, k=1, p=1.0):
    rate = _gamma(_scalar(k, data.shape, data.device)) * (1 - p) / p
    return _poisson(rate).to(data.dtype)


@register("random_generalized_negative_binomial_like", differentiable=False)
def random_generalized_negative_binomial_like(data, mu=1.0, alpha=1.0):
    a = _scalar(1.0 / alpha, data.shape, data.device)
    return _poisson(_gamma(a) * alpha * mu).to(data.dtype)
