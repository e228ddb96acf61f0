"""``mx.random`` of the PyTorch port against the JAX package's sampling
API, on the CPU.

In both packages ``mx.random`` and ``mx.nd.random`` are one module of
samplers that return NDArrays.  The port's streams never match threefry,
so each sampler is held to the JAX sampler's shape and dtype, to the
context it was asked for, to its distribution's support, and to its mean
and standard deviation over 20000 draws within 10 % of max(1, |moment|).
Without ``ctx`` a sampler draws on the current context: the card, which
this host lacks, so it raises rather than draw on the CPU.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError

N = 20000
EULER = 0.5772156649015329

# name: (args, kwargs, support (lo, hi), mean, std); kwargs get shape=(N,)
CASES = {
    "uniform": ((1.0, 3.0), {}, (1.0, 3.0), 2.0, 2 / 12 ** 0.5),
    "normal": ((1.0, 2.0), {}, None, 1.0, 2.0),
    "randint": ((0, 10), {}, (0, 9), 4.5, (99 / 12) ** 0.5),
    "gamma": ((2.0, 1.5), {}, (0, None), 3.0, 1.5 * 2 ** 0.5),
    "exponential": ((2.0,), {}, (0, None), 2.0, 2.0),
    "poisson": ((4.0,), {}, (0, None), 4.0, 2.0),
    "bernoulli": ((0.3,), {}, (0, 1), 0.3, (0.21) ** 0.5),
    "laplace": ((1.0, 2.0), {}, None, 1.0, 2.0 * 2 ** 0.5),
    "pareto": ((5.0,), {}, (0, None), 0.25, (5 / 48) ** 0.5),
    "weibull": ((2.0,), {}, (0, None), math.gamma(1.5),
                (1 - math.gamma(1.5) ** 2) ** 0.5),
    "rayleigh": ((2.0,), {}, (0, None), 2.0 * (math.pi / 2) ** 0.5,
                 2.0 * ((4 - math.pi) / 2) ** 0.5),
    "gumbel": ((1.0, 2.0), {}, None, 1.0 + 2.0 * EULER,
               math.pi * 2.0 / 6 ** 0.5),
    "logistic": ((1.0, 2.0), {}, None, 1.0, math.pi * 2.0 / 3 ** 0.5),
}


def _moments_ok(x, mean, std, tol=0.1):
    x = x.astype(np.float64)
    assert abs(x.mean() - mean) < tol * max(1.0, abs(mean)), (x.mean(), mean)
    assert abs(x.std() - std) < tol * max(1.0, std), (x.std(), std)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sampler_matches_jax_shape_dtype_and_moments(name):
    args, kw, support, mean, std = CASES[name]
    ref = getattr(mj.random, name)(*args, shape=(3, 2), **kw)
    mt.random.seed(7)
    small = getattr(mt.random, name)(*args, shape=(3, 2), ctx=mt.cpu(), **kw)
    assert isinstance(small, mt.nd.NDArray)
    assert small.shape == ref.shape and small.dtype == ref.dtype
    assert small.context == mt.cpu()
    out = getattr(mt.random, name)(*args, shape=(N,), ctx=mt.cpu(), **kw)
    x = out.asnumpy()
    assert np.isfinite(x).all()
    if support is not None:
        lo, hi = support
        assert x.min() >= lo and (hi is None or x.max() <= hi)
    _moments_ok(x, mean, std)


def test_randn_shuffle_and_multinomial_match_jax():
    r = mt.random.randn(2, 3, ctx=mt.cpu())
    assert r.shape == mj.random.randn(2, 3).shape == (2, 3)
    with mt.cpu():
        x = mt.nd.arange(10)
        sh = mt.random.shuffle(x)
        probs = np.array([[0.1, 0.6, 0.3], [0.8, 0.1, 0.1]], np.float32)
        idx = mt.random.multinomial(mt.nd.array(probs), shape=N)
    assert sorted(sh.asnumpy().tolist()) == list(range(10))
    ref = mj.random.multinomial(mj.nd.array(probs), shape=4)
    assert idx.shape == (2, N) and idx.dtype == ref.dtype
    counts = np.stack([np.bincount(r, minlength=3) for r in idx.asnumpy()])
    np.testing.assert_allclose(counts / N, probs, atol=0.02)


def test_choice_and_categorical_match_jax():
    p = np.array([0.1, 0.2, 0.7], np.float32)
    ref = mj.random.choice(3, size=(4,), p=mj.nd.array(p))
    got = mt.random.choice(3, size=(N,), p=p, ctx=mt.cpu())
    assert got.dtype == ref.dtype and got.shape == (N,)
    np.testing.assert_allclose(np.bincount(got.asnumpy(), minlength=3) / N,
                               p, atol=0.02)
    perm = mt.random.choice(10, size=(10,), replace=False, ctx=mt.cpu())
    assert sorted(perm.asnumpy().tolist()) == list(range(10))
    logits = np.log(np.array([[0.5, 0.25, 0.25], [0.1, 0.1, 0.8]],
                             np.float32))
    ref = mj.random.categorical(mj.nd.array(logits))
    with mt.cpu():
        one = mt.random.categorical(mt.nd.array(logits))
        many = mt.random.categorical(mt.nd.array(logits), shape=(N,))
    assert one.shape == ref.shape == (2,) and one.dtype == ref.dtype
    freq = np.stack([np.bincount(r, minlength=3) / N
                     for r in many.asnumpy()])
    np.testing.assert_allclose(freq, np.exp(logits), atol=0.02)


def test_tensor_parameters_draw_one_sample_per_element():
    with mt.cpu():
        loc = mt.nd.array(np.array([0.0, 10.0], np.float32))
        out = mt.random.normal(loc, 1.0, shape=(N,))
    assert out.shape == (2, N)
    _moments_ok(out.asnumpy()[1], 10.0, 1.0)


def test_one_module_and_seeded_streams():
    assert mt.nd.random is mt.random and mj.nd.random is mj.random
    mt.random.seed(5)
    a = mt.random.uniform(shape=(4,), ctx=mt.cpu())
    mt.random.seed(5)
    b = mt.random.uniform(shape=(4,), ctx=mt.cpu())
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    out = mt.nd.zeros((5,), ctx=mt.cpu())
    assert mt.random.exponential(2.0, shape=(5,), out=out) is out
    # the port's own users keep their generator functions
    for fn in ("generator", "draw_seed", "take_key", "draw", "replayable",
               "uniform_tensor", "normal_tensor"):
        assert callable(getattr(mt.random, fn))
    t = mt.random.uniform_tensor(-1.0, 1.0, (3,), ctx=mt.cpu())
    assert isinstance(t, torch.Tensor) and t.abs().max() <= 1.0


def test_default_context_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for name in ("uniform", "bernoulli", "laplace", "randint"):
        args = CASES[name][0]
        with pytest.raises(MXNetError, match=r"ctx=mx\.cpu\(\)"):
            getattr(mt.random, name)(*args, shape=(2,))
    with mt.cpu():
        assert mt.random.uniform(shape=(2,)).context == mt.cpu()
