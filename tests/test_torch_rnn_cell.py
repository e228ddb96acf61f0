"""The port's recurrent cells and ``unroll`` against the JAX package's, on
the CPU.

- ``RNNCell`` (tanh, relu), ``LSTMCell``, ``GRUCell``, a
  ``SequentialRNNCell`` (and its alias ``HybridSequentialRNNCell``),
  ``ResidualCell``, ``BidirectionalCell``, and ``DropoutCell``,
  ``ZoneoutCell`` and ``VariationalDropoutCell`` in predict mode (where
  they pass the base cell through), unrolled over NTC and TNC inputs with
  and without ``merge_outputs`` and ``valid_length``: the outputs and
  states against the JAX cells on the same weights, and every parameter's
  gradient of a weighted sum of the outputs under ``autograd.record()``,
  within 1e-5 x max(1, max|ref|).
- ``VariationalDropoutCell``'s locked mask (the port of ``test_gluon.py``'s
  ``test_variational_dropout_cell_locked_mask``): the same mask at every
  step, a new one after ``reset()``, none in predict mode; and the
  training forms of ``DropoutCell`` and ``ZoneoutCell`` against their
  formulas on the masks they drew.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import rnn as jrnn
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon import rnn as trnn

T, B, I, H = 4, 3, 5, 5


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _build(rnn, name):
    """The cell ``name`` of package ``rnn`` (both build it alike)."""
    if name == "rnn_tanh":
        return rnn.RNNCell(H)
    if name == "rnn_relu":
        return rnn.RNNCell(H, activation="relu")
    if name == "lstm":
        return rnn.LSTMCell(H)
    if name == "gru":
        return rnn.GRUCell(H)
    if name in ("sequential", "hybrid_sequential"):
        cell = (rnn.SequentialRNNCell() if name == "sequential"
                else rnn.HybridSequentialRNNCell())
        cell.add(rnn.LSTMCell(H))
        cell.add(rnn.GRUCell(H))
        return cell
    if name == "residual":
        return rnn.ResidualCell(rnn.GRUCell(I))
    if name == "bidirectional":
        return rnn.BidirectionalCell(rnn.LSTMCell(H), rnn.GRUCell(H))
    if name == "dropout":
        cell = rnn.SequentialRNNCell()
        cell.add(rnn.LSTMCell(H))
        cell.add(rnn.DropoutCell(0.5))
        return cell
    if name == "zoneout":
        return rnn.ZoneoutCell(rnn.LSTMCell(H), 0.3, 0.3)
    if name == "variational":
        return rnn.VariationalDropoutCell(rnn.GRUCell(H), 0.3, 0.3, 0.3)
    raise ValueError(name)


def _pair(name, seed=0):
    jcell = _build(jrnn, name)
    jcell.initialize()
    # one eager call shapes the deferred weights, then numpy fills them
    layout_x = jmx.nd.zeros((B, 1, I))
    jcell.unroll(1, layout_x)
    rs = np.random.RandomState(seed)
    params = {}
    for k, v in jcell.collect_params().items():
        params[k] = (rs.randn(*v.shape) * 0.4).astype(np.float32)
        v.set_data(jmx.nd.array(params[k]))
    tcell = _build(trnn, name)
    tcell.initialize(ctx=mx.cpu())
    mx.convert.load_jax_params(tcell, params)
    return jcell, tcell


def _flat(states):
    if isinstance(states, (list, tuple)):
        return [s for x in states for s in _flat(x)]
    return [states]


CASES = [("rnn_tanh", "NTC", None, None), ("rnn_relu", "TNC", None, None),
         ("lstm", "NTC", None, None), ("lstm", "TNC", False, None),
         ("lstm", "NTC", None, [4, 2, 3]), ("gru", "TNC", None, [1, 4, 2]),
         ("sequential", "NTC", None, None),
         ("hybrid_sequential", "TNC", True, None),
         ("residual", "NTC", None, None),
         ("bidirectional", "NTC", None, None),
         ("bidirectional", "TNC", None, [3, 4, 2]),
         ("dropout", "NTC", None, None), ("zoneout", "NTC", None, None),
         ("variational", "TNC", None, None)]


@pytest.mark.parametrize("name,layout,merge,valid", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_unroll_matches_jax(name, layout, merge, valid):
    jcell, tcell = _pair(name)
    rs = np.random.RandomState(1)
    x = rs.randn(*((B, T, I) if layout == "NTC" else (T, B, I))) \
        .astype(np.float32)
    vl = None if valid is None else np.array(valid, np.float32)
    kw = dict(layout=layout, merge_outputs=merge)

    with jmx.autograd.record(train_mode=False):
        jout, jst = jcell.unroll(
            T, jmx.nd.array(x), valid_length=None if vl is None
            else jmx.nd.array(vl), **kw)
        jlist = jout if isinstance(jout, list) else [jout]
        probes = [rs.randn(*o.shape).astype(np.float32) for o in jlist]
        jloss = sum((o * jmx.nd.array(p)).sum()
                    for o, p in zip(jlist, probes))
    jloss.backward()

    with mx.autograd.record(train_mode=False):
        tout, tst = tcell.unroll(
            T, torch.from_numpy(x), valid_length=None if vl is None
            else torch.from_numpy(vl), **kw)
        tlist = tout if isinstance(tout, list) else [tout]
        tloss = sum((o * torch.from_numpy(p)).sum()
                    for o, p in zip(tlist, probes))
    mx.autograd.backward(tloss)

    assert len(tlist) == len(jlist) == (T if merge is False else 1)
    for g, w in zip(tlist, jlist):
        _close(g, w.asnumpy())
    jflat, tflat = _flat(jst), _flat(tst)
    assert len(tflat) == len(jflat)
    for g, w in zip(tflat, jflat):
        _close(g, w.asnumpy())
    jparams = jcell.collect_params()
    for k, p in tcell.collect_params().items():
        _close(p.grad, jparams[k].grad().asnumpy())


def test_ndarray_unroll_returns_ndarrays():
    _, tcell = _pair("lstm")
    x = np.random.RandomState(2).randn(B, T, I).astype(np.float32)
    with mx.cpu():
        out, st = tcell.unroll(T, mx.nd.array(x))
    assert isinstance(out, mx.nd.NDArray)
    assert all(isinstance(s, mx.nd.NDArray) for s in st)
    _close(out.asnumpy(), tcell.unroll(T, torch.from_numpy(x))[0])


def test_begin_state_shapes_match_jax():
    for name in ("lstm", "gru", "sequential", "bidirectional", "zoneout"):
        jcell, tcell = _pair(name)
        assert [s["shape"] for s in tcell.state_info(B)] == \
            [tuple(s["shape"]) for s in jcell.state_info(B)]
        if name != "bidirectional":
            assert [tuple(s.shape) for s in _flat(tcell.begin_state(B))] \
                == [s.shape for s in _flat(jcell.begin_state(B))]


def test_variational_dropout_cell_locked_mask():
    mx.random.seed(0)
    cell = trnn.VariationalDropoutCell(trnn.RNNCell(8, input_size=8),
                                       drop_inputs=0.5)
    cell.initialize(ctx=mx.cpu())
    x = torch.ones(2, 8)
    states = cell.begin_state(batch_size=2)
    with mx.autograd.record():
        cell(x, states)
        m1 = cell._mask_i.clone()
        cell(x, states)
        m2 = cell._mask_i.clone()
    torch.testing.assert_close(m1, m2, rtol=0, atol=0)  # locked
    assert set(m1.unique().tolist()) <= {0.0, 2.0}
    cell.reset()
    with mx.autograd.record():
        cell(x, states)
    assert not torch.equal(m1, cell._mask_i)  # new sequence, new mask
    cell.reset()
    cell(x, states)   # predict mode: no dropout at all
    assert cell._mask_i is None


def test_dropout_and_zoneout_cells_in_training():
    p = 0.5
    x = torch.randn(B, I, generator=torch.Generator().manual_seed(3))
    log = {"draws": []}
    with trandom.replayable(log), mx.autograd.record():
        out, _ = trnn.DropoutCell(p)(x, [])
    (mask,) = log["draws"]
    _close(out, (x * mask / (1 - p)).numpy())

    _, zcell = _pair("zoneout")
    states = zcell.begin_state(B)
    log = {"draws": []}
    with trandom.replayable(log), mx.autograd.record():
        base_out, base_st = zcell.base_cell(x, states)
        out, st = zcell(x, states)
    m_out, m_s0, m_s0b, m_s1, m_s1b = log["draws"]
    _close(out, (m_out * base_out).detach().numpy())    # no previous output: zeros
    for ns, s, m, mb, got in ((base_st[0], states[0], m_s0, m_s0b, st[0]),
                              (base_st[1], states[1], m_s1, m_s1b, st[1])):
        _close(got, (m * ns + (1 - mb) * s).detach().numpy())
