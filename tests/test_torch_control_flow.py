"""The port's ``mx.nd.contrib`` control flow (``foreach``, ``while_loop``,
``cond``) and small contrib helpers against the JAX package's, on the CPU.

Each case runs the same body through both packages' ``nd.contrib`` on the
same numpy inputs, recorded for autograd and not (the JAX package then
takes its ``lax.scan`` path, the port its one Python loop), and compares
every output, final state and gradient within 1e-5 x max(1, max|ref|):
cumulative sums, nested states and outputs, a gradient to a closure
capture, the RNN-style loop of ``test_control_flow.py``'s
``test_foreach_rnn_style`` (an ``RNNCell`` over time steps, its weights
moved by name, the gradients of every cell parameter), ``while_loop``'s
zero padding to ``max_iterations`` (also when no step runs) and its
gradient, and both branches of ``cond`` with theirs.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.ndarray import contrib as jcontrib
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.ndarray import contrib as tcontrib


def _close(got, want, tol=1e-5):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _flat(v)]
    return [x.asnumpy()]


def _foreach_cumsum(mx, contrib, record):
    data = mx.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3))

    def body(x, s):
        new_s = s + x
        return new_s, new_s

    with mx.autograd.record() if record else _null():
        outs, final = contrib.foreach(body, data, mx.nd.zeros((3,)))
    return _flat([outs, final])


def _foreach_nested(mx, contrib, record):
    data = mx.nd.array(np.linspace(-1, 1, 10, dtype=np.float32)
                       .reshape(5, 2))
    extra = mx.nd.array(np.arange(5, dtype=np.float32))

    def body(xs, states):
        x, e = xs
        a, b = states
        return [a + x, b * 2 + e], [a + x, b * 2 + e]

    with mx.autograd.record() if record else _null():
        outs, states = contrib.foreach(
            body, [data, extra], [mx.nd.zeros((2,)), mx.nd.ones((2,))])
    return _flat([outs, states])


def _foreach_gradient(mx, contrib, record):
    data = mx.nd.array(np.array([[1.0, 0.5], [0.2, -1.0], [0.3, 0.7]],
                                np.float32))
    w = mx.nd.array(np.array([2.0, 3.0], np.float32))
    w.attach_grad()

    def body(x, s):
        new_s = s * w + x
        return new_s, new_s

    with mx.autograd.record():
        outs, final = contrib.foreach(body, data, mx.nd.ones((2,)))
        loss = outs.sum() + (final * final).sum()
    loss.backward()
    return _flat([outs, final, w.grad])


def _rnn_params():
    cell = jrnn.RNNCell(4)
    cell.initialize()
    cell(jmx.nd.zeros((2, 3)), [jmx.nd.zeros((2, 4))])
    rs = np.random.RandomState(5)
    return {k: (rs.randn(*v.shape) * 0.5).astype(np.float32)
            for k, v in cell.collect_params().items()}


RNN_PARAMS = _rnn_params()


def _foreach_rnn_style(mx, contrib, record):
    rnn = jrnn if mx is jmx else trnn
    cell = rnn.RNNCell(4)
    if mx is jmx:
        cell.initialize()
        cell(jmx.nd.zeros((2, 3)), [jmx.nd.zeros((2, 4))])
        for k, v in cell.collect_params().items():
            v.set_data(jmx.nd.array(RNN_PARAMS[k]))
    else:
        cell.initialize(ctx=tmx.cpu())
        tmx.convert.load_jax_params(cell, RNN_PARAMS)
    seq = mx.nd.array(np.random.RandomState(6).rand(6, 2, 3)
                      .astype(np.float32))

    def body(x, states):
        return cell(x, states)

    with mx.autograd.record():
        outs, final = contrib.foreach(body, seq, [mx.nd.zeros((2, 4))])
        loss = (outs * outs).sum()
    loss.backward()
    grads = [p.grad() if mx is jmx else p.grad
             for p in cell.collect_params().values()]
    return _flat([outs, final]) + [
        g.asnumpy() if mx is jmx else g.numpy() for g in grads]


def _while_loop(mx, contrib, record):
    def cond_fn(i, s):
        return i < 5

    def func(i, s):
        return [i * 2, s * 0.5], [i + 1, s + i]

    with mx.autograd.record() if record else _null():
        outs, states = contrib.while_loop(
            cond_fn, func, [mx.nd.array(np.array([0.0], np.float32)),
                            mx.nd.array(np.array([0.5], np.float32))],
            max_iterations=8)
    return _flat([outs, states])


def _while_loop_gradient(mx, contrib, record):
    x = mx.nd.array(np.array([1.5], np.float32))
    x.attach_grad()

    def cond_fn(v):
        return (v < 10.0).sum() > 0

    def func(v):
        return v * v, [v * 2]

    with mx.autograd.record():
        outs, states = contrib.while_loop(cond_fn, func, [x],
                                          max_iterations=6)
        loss = states[0].sum() + outs.sum()
    loss.backward()
    return _flat([outs, states, x.grad])


def _while_loop_no_step(mx, contrib, record):
    v = mx.nd.array(np.array([5.0, 1.0], np.float32))
    with mx.autograd.record() if record else _null():
        outs, states = contrib.while_loop(
            lambda a: (a < 0.0).sum() > 0, lambda a: (a * 3, [a + 1]),
            [v], max_iterations=3)
    return _flat([outs, states])


def _cond(mx, contrib, record):
    a = mx.nd.array(np.array([3.0, -1.0], np.float32))
    a.attach_grad()
    with mx.autograd.record():
        hi = contrib.cond(a.sum() > 0, lambda: a * a, lambda: a * 2)
        lo = contrib.cond(a.sum() > 5, lambda: a * a, lambda: a * 2 + 1)
        loss = (hi * lo).sum()
    loss.backward()
    return _flat([hi, lo, a.grad])


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


CASES = {"foreach_cumsum": _foreach_cumsum,
         "foreach_nested": _foreach_nested,
         "foreach_gradient": _foreach_gradient,
         "foreach_rnn_style": _foreach_rnn_style,
         "while_loop": _while_loop,
         "while_loop_gradient": _while_loop_gradient,
         "while_loop_no_step": _while_loop_no_step,
         "cond": _cond}


@pytest.mark.parametrize("record", [False, True], ids=["plain", "recorded"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_control_flow_matches_jax(case, record):
    want = CASES[case](jmx, jcontrib, record)
    with tmx.cpu():
        got = CASES[case](tmx, tcontrib, record)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


def test_while_loop_pads_with_zeros():
    with tmx.cpu():
        i_doubled = _while_loop(tmx, tcontrib, False)[0]
    np.testing.assert_array_equal(i_doubled.ravel(),
                                  [0, 2, 4, 6, 8, 0, 0, 0])


def test_while_loop_needs_max_iterations():
    with tmx.cpu(), pytest.raises(tmx.MXNetError, match="max_iterations"):
        tcontrib.while_loop(lambda v: True, lambda v: (v, [v]),
                            [tmx.nd.zeros((1,))])


HELPERS = {
    "isfinite": lambda c, nd: c.isfinite(nd.array(
        np.array([1.0, np.inf, np.nan, -2.0], np.float32))),
    "isnan": lambda c, nd: c.isnan(nd.array(
        np.array([1.0, np.inf, np.nan, -2.0], np.float32))),
    "isinf": lambda c, nd: c.isinf(nd.array(
        np.array([1.0, -np.inf, np.nan, -2.0], np.float32))),
    "arange_like": lambda c, nd: c.arange_like(nd.zeros((2, 3)),
                                               start=0.5, step=2.0),
    "arange_like_axis": lambda c, nd: c.arange_like(nd.zeros((2, 3)),
                                                    start=1.0, axis=1),
    "index_copy": lambda c, nd: c.index_copy(
        nd.zeros((4, 2)), nd.array(np.array([1, 3], np.float32)),
        nd.array(np.array([[1, 2], [3, 4]], np.float32))),
    "index_array": lambda c, nd: c.index_array(nd.zeros((2, 3))),
    "index_array_axes": lambda c, nd: c.index_array(nd.zeros((2, 3, 2)),
                                                    axes=(2, 0)),
    "getnnz": lambda c, nd: c.getnnz(nd.array(
        np.array([[1.0, 0.0], [2.0, 3.0]], np.float32))),
    "getnnz_axis": lambda c, nd: c.getnnz(nd.array(
        np.array([[1.0, 0.0], [2.0, 3.0]], np.float32)), axis=0),
    "boolean_mask": lambda c, nd: c.boolean_mask(
        nd.array(np.arange(8, dtype=np.float32).reshape(4, 2)),
        nd.array(np.array([1, 0, 1, 0], np.float32))),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_contrib_helper_matches_jax(name):
    want = HELPERS[name](jcontrib, jmx.nd).asnumpy()
    with tmx.cpu():
        got = HELPERS[name](tcontrib, tmx.nd).asnumpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_boolean_mask_gradient():
    with tmx.cpu():
        x = tmx.nd.array(np.arange(8, dtype=np.float32).reshape(4, 2))
        x.attach_grad()
        with tmx.autograd.record():
            loss = tcontrib.boolean_mask(
                x, tmx.nd.array(np.array([1, 0, 1, 0], np.float32))).sum()
        loss.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(),
                                  [[1, 1], [0, 0], [1, 1], [0, 0]])
