"""The port's fused recurrent layers (``gluon.rnn.RNN``/``LSTM``/``GRU``)
against the JAX package's, on the CPU.

- Every mode (LSTM, GRU, RNN relu/tanh), one or two layers, one or two
  directions, TNC and NTC, with and without states: the outputs and the
  final states against the JAX layer on the same weights (moved by name
  through ``convert.load_jax_params``), and the gradients of a weighted sum
  of all three against ``jax.grad`` of the JAX package's ``_rnn_forward``
  (inputs, states and every weight), within 1e-5 x max(1, max|ref|).
  Both packages stack the gates alike (LSTM i, f, g, o; GRU r, z, n with r
  on ``W_hn·h + b_hn``), and these cases pin it: a permuted gate block
  would miss by far more.
- The plain per-step version (``rnn_reference``) against the fused op,
  outputs and gradients.
- The deferred input size, ``begin_state``'s shapes, a backward after
  ``record(train_mode=False)``, and an update in place seen by the next
  forward.
- Dropout between layers: the identity in predict mode; in training the
  mask the fused call drew (read back from a ``random.replayable`` log)
  scaled by 1/(1-p), against the JAX recurrence run a layer at a time with
  that mask.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.gluon.rnn.rnn_layer import _rnn_forward
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.rnn import rnn_layer as tlayer

T, B, I, H = 5, 3, 4, 6
CLASSES = {"lstm": "LSTM", "gru": "GRU", "rnn_relu": "RNN",
           "rnn_tanh": "RNN"}


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _layers(mode, L, bi, layout="TNC", dropout=0.0, seed=0):
    """The JAX layer (initialised, weights from numpy) and the port's
    layer holding the same weights."""
    kw = dict(num_layers=L, layout=layout, bidirectional=bi,
              dropout=dropout)
    if mode.startswith("rnn_"):
        kw["activation"] = mode[4:]
    jnet = getattr(jrnn, CLASSES[mode])(H, input_size=I, **kw)
    jnet.initialize()
    rs = np.random.RandomState(seed)
    params = {k: (rs.randn(*v.shape) * 0.3).astype(np.float32)
              for k, v in jnet.collect_params().items()}
    for k, v in jnet.collect_params().items():
        v.set_data(jmx.nd.array(params[k]))
    tnet = getattr(trnn, CLASSES[mode])(H, **kw)   # input size deferred
    tnet.initialize(ctx=mx.cpu())
    mx.convert.load_jax_params(tnet, params)
    return jnet, tnet, params


def _weight_list(params, L, ndir):
    return [params["l%d%s_%s" % (layer, "_r" if d else "", part)]
            for layer in range(L) for d in range(ndir)
            for part in ("i2h_weight", "h2h_weight", "i2h_bias",
                         "h2h_bias")]


CASES = [(mode, L, bi, layout, states)
         for mode in ("lstm", "gru", "rnn_relu", "rnn_tanh")
         for L, bi, layout, states in ((1, False, "TNC", False),
                                       (2, True, "NTC", True))] + [
    ("lstm", 2, False, "TNC", True), ("lstm", 1, True, "NTC", False),
    ("gru", 2, False, "NTC", True)]


@pytest.mark.parametrize("mode,L,bi,layout,states", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_layer_matches_jax(mode, L, bi, layout, states):
    ndir = 2 if bi else 1
    jnet, tnet, params = _layers(mode, L, bi, layout)
    rs = np.random.RandomState(1)
    x = rs.randn(*((T, B, I) if layout == "TNC" else (B, T, I))) \
        .astype(np.float32)
    h0 = rs.randn(L * ndir, B, H).astype(np.float32)
    c0 = rs.randn(L * ndir, B, H).astype(np.float32)
    lstm = mode == "lstm"
    jstates = ([jmx.nd.array(h0), jmx.nd.array(c0)] if lstm
               else [jmx.nd.array(h0)])

    # forward: the JAX layer itself
    if states:
        jout, jst = jnet(jmx.nd.array(x), jstates)
    else:
        jout, jst = jnet(jmx.nd.array(x)), None

    # gradients: jax.grad of the pure recurrence on the same weights
    ws = [jnp.asarray(w) for w in _weight_list(params, L, ndir)]
    xt = x if layout == "TNC" else x.transpose(1, 0, 2)
    r_out = rs.randn(T, B, ndir * H).astype(np.float32)
    r_h, r_c = (rs.randn(L * ndir, B, H).astype(np.float32)
                for _ in range(2))
    h0_, c0_ = (h0, c0) if states else (np.zeros_like(h0),) * 2
    if not lstm:
        c0_ = np.zeros_like(h0)

    def loss(x_, h_, c_, *w):
        out, hT, cT = _rnn_forward(x_, h_, c_, mode, L, bi, 0.0, None, *w)
        val = jnp.sum(out * r_out)
        if states:
            val = val + jnp.sum(hT * r_h)
            if lstm:
                val = val + jnp.sum(cT * r_c)
        return val, out

    (_, ref_out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(3 + len(ws))), has_aux=True))(
        jnp.asarray(xt), jnp.asarray(h0_), jnp.asarray(c0_), *ws)
    np.testing.assert_allclose(
        np.asarray(ref_out),
        jout.asnumpy() if layout == "TNC"
        else jout.asnumpy().transpose(1, 0, 2), rtol=0, atol=1e-6)

    xp = torch.tensor(x, requires_grad=True)
    hp = torch.tensor(h0, requires_grad=True)
    cp = torch.tensor(c0, requires_grad=True)
    with mx.autograd.record():
        if states:
            out, st = tnet(xp, [hp, cp] if lstm else [hp])
        else:
            out, st = tnet(xp), None
        outt = out if layout == "TNC" else out.transpose(0, 1)
        if states:
            val = (outt * torch.from_numpy(r_out)).sum() \
                + (st[0] * torch.from_numpy(r_h)).sum()
            if lstm:
                val = val + (st[1] * torch.from_numpy(r_c)).sum()
        else:
            val = (outt * torch.from_numpy(r_out)).sum()
    _close(out, jout.asnumpy())
    if states:
        assert len(st) == len(jst)
        for g, w in zip(st, jst):
            _close(g, w.asnumpy())
    else:
        grads = (grads[0],) + grads[3:]   # the states took no gradient
    val.backward()
    tweights = tnet._weights()
    got = [xp.grad if layout == "TNC" else xp.grad.transpose(0, 1)]
    if states:
        got += [hp.grad, cp.grad if lstm else torch.zeros_like(cp)]
    got += [w.grad for w in tweights]
    assert len(got) == len(grads)
    for g, r in zip(got, grads):
        _close(g, r)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_relu", "rnn_tanh"])
def test_plain_per_step_version_matches_the_fused_op(mode):
    L, ndir = 2, 2
    rs = np.random.RandomState(2)
    G = tlayer._GATES[mode] * H
    ws = []
    for layer in range(L):
        isz = I if layer == 0 else ndir * H
        for _ in range(ndir):
            ws += [rs.randn(G, isz), rs.randn(G, H), rs.randn(G),
                   rs.randn(G)]
    leaves = [torch.tensor((a * 0.3).astype(np.float32), requires_grad=True)
              for a in [rs.randn(T, B, I), rs.randn(L * ndir, B, H),
                        rs.randn(L * ndir, B, H)] + ws]
    x, h0, c0, *weights = leaves
    c0 = c0 if mode == "lstm" else None
    got = tlayer.rnn_forward(mode, x, h0, c0, weights, L, True)
    want = tlayer.rnn_reference(mode, x, h0, c0, weights, L, True)
    outs = [o for o in got if o is not None]
    for g, w in zip(outs, want):
        _close(g, w.detach().numpy())
    probe = [torch.randn(o.shape, generator=torch.Generator().manual_seed(3))
             for o in outs]
    g1 = torch.autograd.grad(sum((o * p).sum() for o, p in zip(outs, probe)),
                             leaves, allow_unused=True)
    g2 = torch.autograd.grad(sum((o * p).sum() for o, p in zip(
        [w for w in want if w is not None], probe)), leaves,
        allow_unused=True)
    for a, b in zip(g1, g2):
        if b is not None:
            _close(a, b.numpy())


def test_deferred_input_size_and_begin_state():
    net = trnn.LSTM(H, num_layers=2, bidirectional=True)
    net.initialize(ctx=mx.cpu())
    assert tuple(net.l0_i2h_weight.shape) == (4 * H, 0)
    assert tuple(net.l1_i2h_weight.shape) == (4 * H, 2 * H)
    out = net(torch.randn(T, B, I))
    assert tuple(net.l0_i2h_weight.shape) == (4 * H, I)
    assert tuple(net.l0_r_i2h_weight.shape) == (4 * H, I)
    assert tuple(out.shape) == (T, B, 2 * H)
    states = net.begin_state(B)
    assert [tuple(s.shape) for s in states] == [(4, B, H)] * 2
    nd_states = net.begin_state(B, func=mx.nd.zeros, ctx=mx.cpu())
    assert all(isinstance(s, mx.nd.NDArray) for s in nd_states)
    gru = trnn.GRU(H, num_layers=3, layout="NTC")
    assert [tuple(s.shape) for s in gru.begin_state(7)] == [(3, 7, H)]
    # the JAX layer's state shapes
    assert [tuple(s.shape) for s in jrnn.LSTM(H, num_layers=2,
                                              bidirectional=True)
            .begin_state(B)] == [(4, B, H)] * 2


def test_ndarray_call_with_states():
    """NDArrays in, NDArrays out, the states inside a list too."""
    _, tnet, _ = _layers("lstm", 1, False)
    x = np.random.RandomState(4).randn(T, B, I).astype(np.float32)
    with mx.cpu():
        out, st = tnet(mx.nd.array(x), tnet.begin_state(B, func=mx.nd.zeros))
    assert isinstance(out, mx.nd.NDArray)
    assert all(isinstance(s, mx.nd.NDArray) for s in st)
    _close(out.asnumpy(), tnet(torch.from_numpy(x)).numpy())


def test_backward_after_predict_mode_record_and_update_seen():
    """``record(train_mode=False)`` still gives gradients (the op runs in
    its training form whenever one is asked for), and a weight updated in
    place is what the next forward reads."""
    _, tnet, _ = _layers("lstm", 2, False)
    x = torch.randn(T, B, I, generator=torch.Generator().manual_seed(5))
    with mx.autograd.record(train_mode=False):
        loss = tnet(x).sum()
    mx.autograd.backward(loss)
    assert all(w.grad is not None and torch.isfinite(w.grad).all()
               for w in tnet._weights())
    before = tnet(x)
    trainer = mx.gluon.Trainer(tnet.collect_params(), "sgd",
                               {"learning_rate": 0.5})
    trainer.step(1)
    after = tnet(x)
    assert (after - before).abs().max() > 1e-3
    fresh = tlayer.rnn_reference("lstm", x, torch.zeros(2, B, H),
                                 torch.zeros(2, B, H),
                                 [w.detach() for w in tnet._weights()], 2,
                                 False)[0]
    _close(after, fresh.numpy())


def test_dropout_identity_in_predict_mode_and_scaled_mask_in_training():
    p, L = 0.4, 3
    jnet, tnet, params = _layers("lstm", L, False, dropout=p, seed=6)
    x = np.random.RandomState(7).randn(T, B, I).astype(np.float32)
    # predict mode: no mask, the JAX layer's numbers
    _close(tnet(torch.from_numpy(x)), jnet(jmx.nd.array(x)).asnumpy())
    # training: the masks the fused call drew, read back from the log
    log = {"draws": []}
    mx.random.seed(11)
    with trandom.replayable(log), mx.autograd.record():
        got = tnet(torch.from_numpy(x))
    masks = [m.numpy() for m in log["draws"]]
    assert len(masks) == L - 1
    assert all(set(np.unique(m)) <= {0.0, 1.0} for m in masks)
    ws = [jnp.asarray(w) for w in _weight_list(params, L, 1)]
    h = jnp.asarray(x)
    zeros = jnp.zeros((1, B, H), jnp.float32)
    for layer in range(L):
        h, _, _ = _rnn_forward(h, zeros, zeros, "lstm", 1, False, 0.0,
                               None, *ws[4 * layer:4 * layer + 4])
        if layer < L - 1:
            h = h * masks[layer] / (1.0 - p)
    _close(got, np.asarray(h))
    # and the plain per-step version given the same masks
    ref = tlayer.rnn_reference(
        "lstm", torch.from_numpy(x), torch.zeros(L, B, H),
        torch.zeros(L, B, H), [w.detach() for w in tnet._weights()], L,
        False, dropout=p, masks=[torch.from_numpy(m) for m in masks])[0]
    _close(got, ref.numpy())


def test_cudnn_refusal_raises_instead_of_falling_back(monkeypatch):
    """An input cuDNN would refuse on the card raises; the check passes
    once cuDNN takes it."""

    class CardTensor:
        is_cuda = True
        dtype = torch.bfloat16
        shape = (T, B, I)
        device = torch.device("cuda", 0)

        @staticmethod
        def numel():
            return T * B * I

    with pytest.raises(mx.MXNetError, match="cuDNN"):
        tlayer._check_cudnn(CardTensor())
    monkeypatch.setattr(torch.backends.cudnn, "is_acceptable",
                        lambda t: True)
    tlayer._check_cudnn(CardTensor())
