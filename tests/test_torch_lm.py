"""The port's language models (``StandardRNNLM``, ``TransformerLM``) against
the JAX package's, on the CPU.

- A small ``StandardRNNLM`` (LSTM and GRU, tied and untied) on the same
  numpy weights and ids: the logits, and the logits and states when states
  are passed in, within 1e-5 x max(1, max|ref|).
- One ``parallel.FusedTrainer`` SGD step (``bench.py``'s config-5 recipe:
  ``loss='softmax_ce'``, lr 1.0, dropout 0) at a small size: the loss and
  every weight after the step against the JAX ``FusedTrainer``'s, within
  1e-5.
- The falling loss of ``test_transformer.py``'s ``test_lstm_lm_trains``
  (``standard_lstm_lm_200``, vocab 30, Adam 1e-2, five imperative steps
  with dropout 0.2), and an imperative loop that carries and detaches the
  states.
- A small ``TransformerLM`` (tied and untied) against the JAX model's
  logits, and the causality check of ``test_gpt_lm_causal``: changing the
  last token leaves every earlier position's logits as they were.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.model_zoo import language_model as jlm
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.gluon.model_zoo import language_model as tlm

V, E, B, T = 23, 8, 3, 6


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _ids(seed, shape=(B, T), vocab=V):
    return np.random.RandomState(seed).randint(0, vocab, shape) \
        .astype(np.int32)


def _pair(make, probe, seed=0):
    """The JAX model (shaped by one call on ``probe``, weights from numpy)
    and the port's model holding the same weights."""
    jnet = make(jlm)
    jnet.initialize()
    jnet(jmx.nd.array(probe))
    rs = np.random.RandomState(seed)
    params = {k: (rs.randn(*v.shape) * 0.3).astype(np.float32)
              for k, v in jnet.collect_params().items()}
    for k, v in jnet.collect_params().items():
        if k.endswith("gamma"):
            params[k] += 1.0
        v.set_data(jmx.nd.array(params[k]))
    tnet = make(tlm)
    tnet.initialize(ctx=mx.cpu())
    mx.convert.load_jax_params(tnet, params)
    return jnet, tnet, params


RNN_CASES = [("lstm", False), ("lstm", True), ("gru", True)]


@pytest.mark.parametrize("mode,tie", RNN_CASES,
                         ids=["%s-%s" % (m, "tied" if t else "untied")
                              for m, t in RNN_CASES])
def test_rnn_lm_matches_jax(mode, tie):
    def make(lm):
        return lm.StandardRNNLM(V, E, E, num_layers=2, dropout=0.0,
                                tie_weights=tie, mode=mode)

    ids = _ids(1)
    jnet, tnet, _ = _pair(make, ids)
    _close(tnet(torch.from_numpy(ids)), jnet(jmx.nd.array(ids)).asnumpy())
    rs = np.random.RandomState(2)
    states = [rs.randn(2, B, E).astype(np.float32)
              for _ in range(2 if mode == "lstm" else 1)]
    jlog, jst = jnet(jmx.nd.array(ids), [jmx.nd.array(s) for s in states])
    tlog, tst = tnet(torch.from_numpy(ids),
                     [torch.from_numpy(s) for s in states])
    _close(tlog, jlog.asnumpy())
    assert len(tst) == len(jst)
    for g, w in zip(tst, jst):
        _close(g, w.asnumpy())


def test_fused_trainer_sgd_step_matches_jax():
    ids, labels = _ids(3), _ids(4)

    def make(lm):
        return lm.StandardRNNLM(V, E, E, num_layers=2, dropout=0.0)

    jnet, tnet, _ = _pair(make, ids, seed=5)
    jtr = jpar.FusedTrainer(jnet, loss="softmax_ce", optimizer="sgd",
                            optimizer_params={"learning_rate": 1.0})
    ttr = parallel.FusedTrainer(tnet, loss="softmax_ce", optimizer="sgd",
                                optimizer_params={"learning_rate": 1.0})
    want = float(jtr.step(ids, labels).asnumpy())
    got = ttr.step(torch.from_numpy(ids), torch.from_numpy(labels)).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jtr.sync_block()
    jparams = jnet.collect_params()
    for k, p in tnet.collect_params().items():
        _close(p, jparams[k].data().asnumpy())


def test_lstm_lm_trains():
    rs = np.random.RandomState(3)
    mx.random.seed(0)
    net = tlm.standard_lstm_lm_200(vocab_size=30)
    net.initialize(ctx=mx.cpu())
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-2})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x = torch.from_numpy(rs.randint(0, 30, (4, 6)))
    y = torch.from_numpy(rs.randint(0, 30, (4, 6)))
    losses = []
    for _ in range(5):
        with mx.autograd.record():
            logits = net(x)
            L = loss_fn(logits.reshape(-1, 30), y.reshape(-1)).mean()
        mx.autograd.backward(L)
        trainer.step(1)
        losses.append(L.item())
    assert losses[-1] < losses[0]


def test_states_carried_and_detached_across_steps():
    """The imperative LM loop: states in and out, detached between steps
    (NDArrays), gradients clipped by ``clip_global_norm``."""
    mx.random.seed(1)
    with mx.cpu():
        net = tlm.StandardRNNLM(V, E, E, num_layers=2, dropout=0.3)
        net.initialize(ctx=mx.cpu())
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.5})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        states = net.begin_state(B, func=mx.nd.zeros)
        x, y = mx.nd.array(_ids(6)), mx.nd.array(_ids(7))
        losses = []
        for _ in range(6):
            states = [s.detach() for s in states]
            with mx.autograd.record():
                logits, states = net(x, states)
                L = loss_fn(logits.reshape((-1, V)), y.reshape((-1,))).mean()
            L.backward()
            grads = [p.grad for p in net.collect_params().values()]
            mx.gluon.utils.clip_global_norm(grads, 1.0)
            trainer.step(1)
            losses.append(float(L.asnumpy()))
    assert all(isinstance(s, mx.nd.NDArray) for s in states)
    assert [s.shape for s in states] == [(2, B, E)] * 2
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_transformer_lm_matches_jax(tie):
    def make(lm):
        return lm.TransformerLM(V, units=16, hidden_size=32, num_layers=2,
                                num_heads=2, max_length=16, dropout=0.0,
                                tie_weights=tie)

    ids = _ids(8, (2, 9))
    jnet, tnet, _ = _pair(make, ids)
    _close(tnet(torch.from_numpy(ids)), jnet(jmx.nd.array(ids)).asnumpy())


def test_gpt_lm_causal():
    net = tlm.TransformerLM(vocab_size=20, units=16, hidden_size=32,
                            num_layers=1, num_heads=2, max_length=16,
                            dropout=0.0)
    net.initialize(ctx=mx.cpu())
    ids = _ids(4, (1, 8), 20)
    logits1 = net(torch.from_numpy(ids)).numpy()
    ids2 = ids.copy()
    ids2[0, -1] = (ids2[0, -1] + 1) % 20
    logits2 = net(torch.from_numpy(ids2)).numpy()
    np.testing.assert_allclose(logits1[0, :-1], logits2[0, :-1], rtol=1e-4,
                               atol=1e-5)
    assert np.abs(logits1[0, -1] - logits2[0, -1]).max() > 1e-6


def test_gpt_lm_defaults_take_the_causal_flash_path(monkeypatch):
    """``gpt_lm()``'s own widths (units 256, 8 heads: D=32) at T=1024 send
    ``impl='auto'`` to the flash route, causal, on the card; on the CPU
    that route's wrapper runs its plain version (the call is spied, not
    run at full size here)."""
    from mxnet_tpu_torch.ops import nn as ops_nn

    net = tlm.gpt_lm()
    cell = next(iter(net.layers))
    assert cell.attention._causal and cell.attention._num_heads == 8
    seen = []
    real = ops_nn.fa.flash_attention

    def spy(q, k, v, causal=False, *args, **kw):
        seen.append((tuple(q.shape), causal))
        return real(q, k, v, causal, *args, **kw)

    monkeypatch.setattr(ops_nn.fa, "flash_attention", spy)
    q = torch.randn(1, 1024, 256)
    with torch.no_grad():
        ops_nn.multi_head_attention(q, q, q, num_heads=8, causal=True)
    assert seen == [((1, 8, 1024, 32), True)]
