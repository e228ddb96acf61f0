"""NDArray autograd of the PyTorch port against the JAX package, on the CPU.

The gradient cases of ``tests/python/unittest/test_autograd.py`` run in
both packages on the same numpy inputs: ``attach_grad`` with ``write`` and
``add``, ``mark_variables``, ``grad()`` (with ``create_graph`` for second
and third order), head gradients, ``retain_graph``, ``pause()``,
``detach``/``stop_gradient`` and ``grad_req='null'``.  Gradients agree
within 1e-5 (float32, the same expressions in another order) unless a case
says otherwise.

The ``grad_req`` repair: two ``backward()`` calls before a step give the
JAX package's gradient (``write`` replaces, ``add`` sums) for an NDArray
and for a ``gluon.Parameter``, and the ``Trainer.step`` after them moves
the weight as the JAX one moves.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn

TOL = 1e-5
RS = np.random.RandomState(7)
X34 = RS.rand(3, 4).astype(np.float32)


def both(fn):
    """``fn(mx)`` with the JAX package and with the port (on the CPU); the
    results as numpy arrays."""
    ref = fn(mj)
    with mt.cpu():
        got = fn(mt)
    return _np(ref), _np(got)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def check(fn, tol=TOL):
    ref, got = both(fn)
    for r, g in zip(ref if isinstance(ref, list) else [ref],
                    got if isinstance(got, list) else [got]):
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol)


def test_simple_grad():
    def fn(mx):
        x = mx.nd.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward()
        return x.grad

    check(fn)


def test_chain_and_branches():
    def fn(mx):
        x = mx.nd.array(X34)
        x.attach_grad()
        with mx.autograd.record():
            a = x * 2
            b = mx.nd.sin(x)
            y = (a + b).sum()
        y.backward()
        return x.grad

    check(fn)


@pytest.mark.parametrize("req", ["write", "add"])
def test_attach_grad_write_and_add(req):
    def fn(mx):
        x = mx.nd.array([1.0, -2.0])
        x.attach_grad(grad_req=req)
        for k in (2.0, 3.0, 5.0):
            with mx.autograd.record():
                y = k * x * x
            y.backward()
        return x.grad

    ref, got = both(fn)
    want = {"write": [10.0, -20.0], "add": [20.0, -40.0]}[req]
    np.testing.assert_allclose(ref, want)
    np.testing.assert_allclose(got, want)


def test_head_grad_and_nonscalar_head():
    def fn(mx):
        x = mx.nd.array(np.arange(4, dtype=np.float32))
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
        y.backward(mx.nd.array(np.array([1.0, 0, 2, 0], np.float32)))
        g1 = x.grad.copy()
        with mx.autograd.record():
            z = x * 3
        z.backward()           # a non-scalar head: ones
        return g1, x.grad

    check(fn)


def test_detach_and_stop_gradient():
    def fn(mx):
        x = mx.nd.array([3.0])
        x.attach_grad()
        with mx.autograd.record():
            y = (x * x).detach() * x + mx.nd.stop_gradient(x * x) + x
        y.backward()
        return x.grad

    check(fn)


def test_grad_function():
    def fn(mx):
        x = mx.nd.array([1.0, 2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = (x ** 3).sum()
        g = mx.autograd.grad(y, [x])
        return g[0], x.grad     # grad() leaves .grad as it was

    check(fn)


def test_mark_variables():
    def fn(mx):
        x = mx.nd.array([1.0, 2.0])
        g = mx.nd.zeros((2,))
        mx.autograd.mark_variables([x], [g])
        with mx.autograd.record():
            y = (5 * x * x).sum()
        y.backward()
        return x.grad, g

    check(fn)
    with mt.cpu():     # the handle passed in is the one .grad returns
        x, g = mt.nd.array([1.0]), mt.nd.zeros((1,))
        mt.autograd.mark_variables([x], [g], grad_reqs="add")
        for _ in range(2):
            with mt.autograd.record():
                y = 4 * x
            y.backward()
        assert x.grad is g and g.asscalar() == 8.0


def test_higher_order_grad():
    def second(mx):
        x = mx.nd.array(np.array([0.3, -0.7], np.float32))
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.tanh(x)
            g1 = mx.autograd.grad(y, [x], create_graph=True)[0]
            gsum = g1.sum()
        gsum.backward()
        return x.grad

    def third(mx):
        x = mx.nd.array(np.array([1.5], np.float32))
        x.attach_grad()
        with mx.autograd.record():
            y = (x ** 4).sum()
            g1 = mx.autograd.grad(y, [x], create_graph=True)[0]
            g2 = mx.autograd.grad(g1.sum(), [x], create_graph=True)[0]
            g3 = g2.sum()
        g3.backward()
        return x.grad

    check(second, tol=1e-4)
    check(third, tol=1e-4)
    ref, got = both(third)
    np.testing.assert_allclose(got, [36.0], rtol=1e-5)


def test_create_graph_outside_record():
    def fn(mx):
        x = mx.nd.array(np.array([0.5], np.float32))
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.tanh(x)
        g1 = mx.autograd.grad(y, [x], create_graph=True)[0]
        with mx.autograd.record():
            s = g1.sum()
        return mx.autograd.grad(s, [x])[0]

    check(fn, tol=1e-4)


def test_multiple_inputs_and_retain_graph():
    def fn(mx):
        a = mx.nd.array(np.array([2.0], np.float32))
        b = mx.nd.array(np.array([3.0], np.float32))
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            u = a * b
            v = a + b
            L = (u * v).sum()
        L.backward(retain_graph=True)
        first = [a.grad.copy(), b.grad.copy()]
        L.backward()            # the retained graph, once more: write
        return first + [a.grad, b.grad]

    check(fn)


def test_graph_freed_without_retain_graph():
    with mt.cpu():
        x = mt.nd.array([1.0])
        x.attach_grad()
        with mt.autograd.record():
            y = mt.nd.exp(x).sum()
        y.backward()
        with pytest.raises(RuntimeError):
            y.backward()


def test_pause_and_null_req():
    def fn(mx):
        x = mx.nd.array(np.ones(3, np.float32))
        w = mx.nd.array(np.full(3, 2.0, np.float32))
        n = mx.nd.array(np.ones(3, np.float32))
        x.attach_grad()
        n.attach_grad(grad_req="null")
        with mx.autograd.record():
            y = x * w
            with mx.autograd.pause():
                c = x * 10          # not recorded: a constant
            L = (y * c + n * x).sum()
        L.backward()
        return x.grad, n.grad

    check(fn)
    with mt.cpu():
        x = mt.nd.array([1.0])
        x.attach_grad()
        with mt.autograd.record():
            with mt.autograd.pause():
                assert not mt.autograd.is_recording()
                y = x * 2
        with pytest.raises(MXNetError):
            y.backward()            # no graph, as in the JAX package


def test_ops_outside_record_build_no_graph():
    with mt.cpu():
        x = mt.nd.array([1.0, 2.0])
        x.attach_grad()
        y = x * x
        assert not y._data.requires_grad
        with pytest.raises(MXNetError):
            mt.autograd.backward(y)


def test_backward_through_concat_split():
    def fn(mx):
        a = mx.nd.array(np.ones((2, 2), np.float32))
        b = mx.nd.array(np.full((2, 2), 2.0, np.float32))
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            c = mx.nd.concat(a, b, dim=1)
            parts = mx.nd.split(c, num_outputs=2, axis=1)
            L = (parts[0] * 3 + parts[1] * 5).sum()
        L.backward()
        return a.grad, b.grad

    check(fn)


def test_hessian_vector_product():
    rs = np.random.RandomState(0)
    w0 = rs.randn(3, 3).astype(np.float32) * 0.5
    x0 = rs.randn(2, 3).astype(np.float32)
    v0 = rs.randn(3, 3).astype(np.float32)

    def fn(mx):
        w, x, v = mx.nd.array(w0), mx.nd.array(x0), mx.nd.array(v0)
        w.attach_grad()
        with mx.autograd.record():
            loss = (mx.nd.tanh(mx.nd.dot(x, w)) ** 2).sum()
            g = mx.autograd.grad(loss, [w], create_graph=True)[0]
            gv = (g * v).sum()
        gv.backward()
        return w.grad

    check(fn, tol=1e-4)


# ---- the grad_req repair ----------------------------------------------------


def _dense_pair(req, in_units=3):
    mj.random.seed(0)
    jnet = jnn.Dense(2, in_units=in_units)
    for p in jnet.collect_params().values():
        p.grad_req = req       # read at initialize() in the JAX package
    jnet.initialize()
    tnet = tnn.Dense(2, in_units=in_units)
    tnet.initialize(ctx=mt.cpu())
    convert.load_jax_params(tnet, {k: v.data().asnumpy() for k, v in
                                   jnet.collect_params().items()})
    return jnet, tnet


@pytest.mark.parametrize("req", ["write", "add"])
@pytest.mark.parametrize("inputs", ["ndarray", "tensor"])
def test_two_backwards_then_a_step_match_jax(req, inputs):
    """Dense(2, in_units=3), all-ones input, record + sum + backward twice,
    then Trainer.step: ``write`` keeps the last gradient (1 each), ``add``
    their sum (2 each), and SGD moves the weight by lr times it."""
    jnet, tnet = _dense_pair(req)
    for p in tnet.collect_params().values():
        p.grad_req = req
    jtr = mj.gluon.Trainer(jnet.collect_params(), "sgd",
                           {"learning_rate": 0.5})
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd",
                           {"learning_rate": 0.5})
    xj = mj.nd.ones((1, 3))
    xt = mt.nd.ones((1, 3), ctx=mt.cpu()) if inputs == "ndarray" \
        else torch.ones(1, 3)
    for _ in range(2):
        with mj.autograd.record():
            yj = jnet(xj).sum()
        yj.backward()
        with mt.autograd.record():
            yt = tnet(xt).sum()
        mt.autograd.backward(yt)
    want = {"write": 1.0, "add": 2.0}[req]
    jg = jnet.weight.grad().asnumpy()
    tg = tnet.weight.grad.numpy()
    np.testing.assert_array_equal(jg, np.full((2, 3), want, np.float32))
    np.testing.assert_array_equal(tg, jg)
    jtr.step(1)
    ttr.step(1)
    np.testing.assert_allclose(tnet.weight.detach().numpy(),
                               jnet.weight.data().asnumpy(), rtol=0,
                               atol=1e-7)


def test_write_req_keeps_grads_the_backward_does_not_reach():
    with mt.cpu():
        a, b = mt.nd.array([1.0]), mt.nd.array([1.0])
        a.attach_grad()
        b.attach_grad()
        with mt.autograd.record():
            y = (3 * a * b).sum()
        y.backward()
        with mt.autograd.record():
            z = (7 * a).sum()         # b is not on this graph
        z.backward()
        assert a.grad.asscalar() == 7.0 and b.grad.asscalar() == 3.0


@pytest.mark.parametrize("req", ["write", "add"])
def test_leaf_outside_the_trainer_follows_its_grad_req(req):
    """Two Dense layers, a Trainer over the first only: the second layer's
    gradient is never cleared by a step, so the second backward meets it
    still held.  ``write`` replaces it, ``add`` sums, as in the JAX
    package, and the trained layer moves as the JAX one does."""
    j1, t1 = _dense_pair("write")
    j2, t2 = _dense_pair(req, in_units=2)
    for p in t2.collect_params().values():
        p.grad_req = req
    jtr = mj.gluon.Trainer(j1.collect_params(), "sgd",
                           {"learning_rate": 0.5})
    ttr = mt.gluon.Trainer(t1.collect_params(), "sgd",
                           {"learning_rate": 0.5})
    x = RS.rand(4, 3).astype(np.float32)
    for _ in range(2):
        with mj.autograd.record():
            yj = j2(j1(mj.nd.array(x))).sum()
        yj.backward()
        jtr.step(1)
        with mt.autograd.record():
            yt = t2(t1(mt.nd.array(x, ctx=mt.cpu()))).sum()
        yt.backward()
        ttr.step(1)
    np.testing.assert_allclose(t2.weight.grad.numpy(),
                               j2.weight.grad().asnumpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(t1.weight.detach().numpy(),
                               j1.weight.data().asnumpy(), rtol=TOL,
                               atol=TOL)
