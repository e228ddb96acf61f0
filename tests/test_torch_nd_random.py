"""The PyTorch port's sampling ops (``ops/random_ops.py``, ``mx.nd.random``)
and its ``dropout`` op, on the CPU.

The port draws from its own generators (``mx.random.generator``) and the
JAX package from threefry keys, so the streams never match: each op is
held to its shape and dtype (the JAX op's, where it is cheap to ask) and to
its distribution's mean and standard deviation over 20000 draws, within
10 % of max(1, |moment|).
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg


def _moments_ok(x, mean, std, tol=0.1):
    x = x.asnumpy().astype(np.float64)
    assert abs(x.mean() - mean) < tol * max(1.0, abs(mean)), (x.mean(), mean)
    if std is not None:
        assert abs(x.std() - std) < tol * max(1.0, std), (x.std(), std)


N = 20000


@pytest.mark.parametrize("name,inputs,attrs,mean,std,dtype", [
    ("random_uniform", (), {"low": 1.0, "high": 3.0, "shape": (N,)},
     2.0, 2 / 12 ** 0.5, "float32"),
    ("random_normal", (), {"loc": 1.0, "scale": 2.0, "shape": (N,)},
     1.0, 2.0, "float32"),
    ("random_gamma", (), {"alpha": 2.0, "beta": 1.5, "shape": (N,)},
     3.0, 1.5 * 2 ** 0.5, "float32"),
    ("random_gamma", (), {"alpha": 0.5, "beta": 1.0, "shape": (N,)},
     0.5, 0.5 ** 0.5, "float32"),
    ("random_exponential", (), {"lam": 2.0, "shape": (N,)}, 0.5, 0.5,
     "float32"),
    ("random_poisson", (), {"lam": 4.0, "shape": (N,)}, 4.0, 2.0, "float32"),
    ("random_negative_binomial", (), {"k": 3, "p": 0.5, "shape": (N,)},
     3.0, 6 ** 0.5, "float32"),
    ("random_generalized_negative_binomial", (),
     {"mu": 2.0, "alpha": 0.5, "shape": (N,)}, 2.0, 4 ** 0.5, "float32"),
    ("random_randint", (), {"low": 0, "high": 10, "shape": (N,)}, 4.5,
     None, "int32"),
    ("random_uniform_like", ((N,),), {"low": 0.0, "high": 2.0}, 1.0, None,
     "float32"),
    ("random_normal_like", ((N,),), {"loc": -1.0, "scale": 1.0}, -1.0, 1.0,
     "float32"),
    ("random_exponential_like", ((N,),), {"lam": 1.0}, 1.0, 1.0, "float32"),
    ("random_gamma_like", ((N,),), {"alpha": 3.0, "beta": 1.0}, 3.0,
     3 ** 0.5, "float32"),
    ("random_poisson_like", ((N,),), {"lam": 2.0}, 2.0, 2 ** 0.5,
     "float32"),
    ("random_negative_binomial_like", ((N,),), {"k": 2, "p": 0.4}, 3.0,
     7.5 ** 0.5, "float32"),
    ("random_generalized_negative_binomial_like", ((N,),),
     {"mu": 1.0, "alpha": 1.0}, 1.0, 2 ** 0.5, "float32"),
])
def test_random_scalar_family(name, inputs, attrs, mean, std, dtype):
    with mt.cpu():
        mt.random.seed(7)
        args = [mt.nd.zeros(s) for s in inputs]
        out = treg.get_op(name)(*args, **attrs)
    assert out.shape == (N,) and str(out.dtype) == dtype
    _moments_ok(out, mean, std)


@pytest.mark.parametrize("name,params,mean,std", [
    ("sample_uniform", ([0.0, 2.0], [1.0, 4.0]), [0.5, 3.0],
     [1 / 12 ** 0.5, 2 / 12 ** 0.5]),
    ("sample_normal", ([0.0, 5.0], [1.0, 0.5]), [0.0, 5.0], [1.0, 0.5]),
    ("sample_gamma", ([2.0, 0.7], [1.0, 2.0]), [2.0, 1.4],
     [2 ** 0.5, 2 * 0.7 ** 0.5]),
    ("sample_exponential", ([1.0, 4.0],), [1.0, 0.25], [1.0, 0.25]),
    ("sample_poisson", ([1.0, 6.0],), [1.0, 6.0], [1.0, 6 ** 0.5]),
    ("sample_negative_binomial", ([2.0, 5.0], [0.5, 0.5]), [2.0, 5.0],
     [2.0, 10 ** 0.5]),
    ("sample_generalized_negative_binomial", ([2.0, 1.0], [0.5, 1.0]),
     [2.0, 1.0], [2.0, 2 ** 0.5]),
])
def test_random_sample_family(name, params, mean, std):
    with mt.cpu():
        mt.random.seed(11)
        args = [mt.nd.array(np.array(p, np.float32)) for p in params]
        out = treg.get_op(name)(*args, shape=(N,))
    ref = jreg.get_op(name)(*[mj.nd.array(np.array(p, np.float32))
                              for p in params], shape=(N,))
    assert out.shape == ref.shape == (2, N)
    assert out.dtype == ref.dtype
    for i in range(2):
        _moments_ok(out[i], mean[i], std[i])


def test_multinomial_and_shuffle():
    probs = np.array([[0.1, 0.6, 0.3], [0.8, 0.1, 0.1]], np.float32)
    with mt.cpu():
        mt.random.seed(3)
        out = mt.nd.sample_multinomial(mt.nd.array(probs), shape=(N,))
        idx, logp = mt.nd.sample_multinomial(mt.nd.array(probs), shape=(4,),
                                             get_prob=True)
        x = mt.nd.arange(10)
        sh = mt.nd.shuffle(x)
    ref = mj.nd.sample_multinomial(mj.nd.array(probs), shape=(N,))
    assert out.shape == ref.shape == (2, N) and out.dtype == ref.dtype
    counts = np.stack([np.bincount(r, minlength=3) for r in out.asnumpy()])
    np.testing.assert_allclose(counts / N, probs, atol=0.02)
    assert idx.shape == logp.shape == (2, 4)
    np.testing.assert_allclose(
        logp.asnumpy(), np.log(np.take_along_axis(probs, idx.asnumpy(), 1)),
        rtol=1e-5)
    assert sorted(sh.asnumpy().tolist()) == list(range(10))


def test_nd_random_namespace():
    with mt.cpu():
        mt.nd.random.seed(5)
        a = mt.nd.random.uniform(0, 1, shape=(3, 4))
        mt.nd.random.seed(5)
        b = mt.nd.random.uniform(0, 1, shape=(3, 4))
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
        assert mt.nd.random.normal(shape=(2,)).shape == (2,)
        assert mt.nd.random.randn(2, 3).shape == (2, 3)
        r = mt.nd.random.randint(5, shape=(100,))
        assert r.dtype == np.int32 and 0 <= r.asnumpy().min() <= \
            r.asnumpy().max() < 5
        loc = mt.nd.array(np.zeros((2,), np.float32))
        assert mt.nd.random.normal(loc, 1.0, shape=(3,)).shape == (2, 3)
        out = mt.nd.zeros((5,))
        assert mt.nd.random.exponential(2.0, shape=(5,), out=out) is out
        for fn in (mt.nd.random.gamma, mt.nd.random.poisson,
                   mt.nd.random.negative_binomial,
                   mt.nd.random.generalized_negative_binomial):
            assert fn(shape=(4,)).shape == (4,)
        assert mt.nd.random.multinomial(
            mt.nd.array([0.5, 0.5]), shape=3).shape == (3,)
        assert mt.nd.random.shuffle(mt.nd.arange(4)).shape == (4,)


def test_dropout_op():
    x = np.ones((200, 100), np.float32)
    with mt.cpu():
        a = mt.nd.array(x)
        y1 = treg.get_op("dropout")(a, 42, p=0.25)
        y2 = treg.get_op("dropout")(a, 42, p=0.25)
        np.testing.assert_array_equal(y1.asnumpy(), y2.asnumpy())  # seeded
        kept = y1.asnumpy() != 0
        assert abs(kept.mean() - 0.75) < 0.02
        np.testing.assert_allclose(y1.asnumpy()[kept], 1 / 0.75, rtol=1e-6)
        ax = treg.get_op("dropout")(a, None, p=0.5, axes=(1,)).asnumpy()
        assert (ax == ax[:, :1]).all()         # one mask value a row
        np.testing.assert_array_equal(mt.nd.dropout(a, p=0.5).asnumpy(), x)
        with mt.autograd.record():
            y = mt.nd.Dropout(a, p=0.5)
        assert abs((y.asnumpy() != 0).mean() - 0.5) < 0.02
        y = mt.nd.Dropout(a, p=0.5, mode="always")   # outside training too
        assert abs((y.asnumpy() != 0).mean() - 0.5) < 0.02
