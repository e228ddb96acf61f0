"""The reference-name parity ops (``ops/parity.py``) against the JAX package
on the CPU: every case of ``parity_cases.py`` through both packages
(results equal in count, shape and dtype, within ``RTOL``/``ATOL``); every
alias the same operator as its target in both; the draws of
``categorical`` and ``_sample_unique_zipfian`` with the same draws
injected into both; and every name the JAX ``parity.py`` registers
accounted for.  The element-wise aliases also go through
``test_torch_nd_sweep.py``'s float32 and int32 calls."""
import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import parity as jparity
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import parity as tparity
from mxnet_tpu_torch.ops import registry as treg
from parity_cases import ALIASES_OWN, CASES, DRAWS

RTOL, ATOL = 1e-5, 1e-6


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    return [x]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _args(mx, args):
    return [mx.nd.array(a, dtype=a.dtype) if isinstance(a, onp.ndarray)
            else mx.nd.array(onp.asarray(a), dtype=onp.asarray(a).dtype)
            for a in args]


def run(mx, name, args, kwargs):
    return getattr(mx.nd, name)(*_args(mx, args), **kwargs)


def assert_same(got, ref, what):
    got, ref = [_host(x) for x in _flat(got)], [_host(x) for x in _flat(ref)]
    assert len(got) == len(ref), what
    for g, r in zip(got, ref):
        assert g.shape == r.shape, (what, g.shape, r.shape)
        assert g.dtype == r.dtype, (what, g.dtype, r.dtype)
        if r.dtype.kind in "fc":
            onp.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL,
                                        err_msg=what)
        else:
            onp.testing.assert_array_equal(g, r, err_msg=what)


@pytest.mark.parametrize("name,args,kwargs", CASES,
                         ids=["%s_%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_parity_case_matches_jax(name, args, kwargs):
    ref = run(mj, name, args, dict(kwargs))
    with mt.cpu():
        got = run(mt, name, args, dict(kwargs))
    assert_same(got, ref, name)


def test_parity_gradients_match_jax():
    """make_loss seeds ones, the gradient multiplier scales, the STE
    roundings pass the gradient straight through."""
    x = onp.array([[-1.5, 0.25, 2.0], [3.0, -0.5, -8.0]], onp.float32)

    def grads(mx):
        out = []
        for name, kw in (("make_loss", {}),
                         ("_contrib_gradientmultiplier", {"scalar": -0.5}),
                         ("_contrib_round_ste", {}),
                         ("_contrib_sign_ste", {})):
            a = mx.nd.array(x)
            a.attach_grad()
            with mx.autograd.record():
                y = getattr(mx.nd, name)(a * 2.0, **kw)
            y.backward()
            out.append(a.grad)
        return out

    ref = grads(mj)
    with mt.cpu():
        got = grads(mt)
    assert_same(got, ref, "gradients")


def test_constraint_check_raises_in_both():
    bad = onp.array([True, False])
    with pytest.raises(mj.base.MXNetError):
        mj.nd._npx_constraint_check(mj.nd.array(bad), msg="nope")
    with mt.cpu(), pytest.raises(mt.MXNetError):
        mt.nd._npx_constraint_check(mt.nd.array(bad), msg="nope")


@pytest.mark.parametrize("name,target", ALIASES_OWN + sorted(
    jparity.ALIASES.items()) + sorted(jparity._SCALAR_CAMEL.items()))
def test_alias_is_its_target_in_both(name, target):
    assert jreg.get_op(name) is jreg.get_op(target)
    assert treg.get_op(name) is treg.get_op(target)


def test_categorical_with_injected_draws(monkeypatch):
    logits = onp.log(onp.random.RandomState(3).dirichlet(
        onp.ones(5), size=4)).astype(onp.float32)
    u = onp.random.RandomState(4).uniform(1e-6, 1.0, (4, 5)).astype(
        onp.float32)
    g = -onp.log(-onp.log(u))

    def jax_categorical(key, lg, axis=-1, shape=None):
        return jax.numpy.argmax(lg + g, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", jax_categorical)
    monkeypatch.setattr(tparity, "_gumbel_uniform",
                        lambda shape, like: torch.from_numpy(u))
    ref = mj.nd.categorical(mj.nd.array(logits))
    with mt.cpu():
        got = mt.nd.categorical(mt.nd.array(logits))
    assert_same(got, ref, "categorical")


def test_unique_zipfian_with_injected_generator(monkeypatch):
    orig = onp.random.default_rng
    monkeypatch.setattr(onp.random, "default_rng",
                        lambda seed=None: orig(1234))
    ref = mj.nd._sample_unique_zipfian(range_max=50, shape=(3, 6))
    with mt.cpu():
        got = mt.nd._sample_unique_zipfian(range_max=50, shape=(3, 6))
    assert_same(got, ref, "_sample_unique_zipfian")


def test_every_jax_parity_name_is_covered():
    """Each name the JAX package registers in its parity module (those
    after ``SpatialTransformer``, the last of ``image_ops``) has a case,
    is an alias held above, or is a draw."""
    names = list(jreg._OP_REGISTRY)
    theirs = set(names[names.index("SpatialTransformer") + 1:])
    aliases = ({n for n, _ in ALIASES_OWN} | set(jparity.ALIASES)
               | set(jparity._SCALAR_CAMEL)
               | {"_random_%s_like" % k for k in (
                   "exponential", "gamma", "poisson", "negative_binomial",
                   "generalized_negative_binomial")}
               | {n for n in theirs if n.startswith("_contrib_quantiz")
                  or n in ("_contrib_dequantize", "_contrib_requantize")})
    covered = {c[0] for c in CASES} | aliases | set(DRAWS)
    assert sorted(theirs - covered) == []
    assert all(n in treg._OP_REGISTRY for n in theirs)
