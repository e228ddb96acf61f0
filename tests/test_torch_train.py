"""The port's training path against the JAX package's, on the CPU:
``BERTForPretraining`` + ``pretraining_loss`` under ``autograd.record()``,
``backward()`` and ``gluon.Trainer``.

The 2-layer BERT of ``test_torch_bert.py`` with dropout 0, B=2, T=256 (so
both sides take the flash path: JAX reaches the Pallas kernels in
interpret mode, the port the kernels' plain versions) and 38 masked
positions.  Same numpy weights and batch on both sides; fp32 on both,
summation order differs:
- outputs and loss within atol 1e-4, every gradient within
  1e-4·max(1, max|g|);
- 3-step trajectories: each loss within 1e-4, final weights within 1e-4
  (SGD, momentum 0.9) and 3·lr (Adam: its normalised step amplifies
  rounding in small gradients up to about lr).
The JAX side's Pallas call is wrapped in ``jax.jit`` for this module (the
same interpret-mode kernels, compiled once instead of on every call).
"""
import functools

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.parameter import _trace_stack as _jax_trace_stack
from mxnet_tpu.ops import pallas_attention as pa
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, convert, gluon
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.ops import flash_attention as fa

CFG = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=256)
B, T, M = 2, 256, 38
ATOL = 1e-4
OPTS = {"sgd": {"learning_rate": 1e-2, "momentum": 0.9},
        "adam": {"learning_rate": 1e-3}}


@pytest.fixture(scope="module")
def jit_pallas():
    orig = pa.flash_attention

    @functools.partial(jax.jit, static_argnums=(3, 4))
    def jitted(q, k, v, causal, sm_scale):
        return orig(q, k, v, causal, sm_scale)

    def flash(q, k, v, causal=False, sm_scale=None, dropout_p=0.0,
              dropout_key=None, **kw):
        assert dropout_p == 0.0 and not kw
        return jitted(q, k, v, causal, sm_scale)

    mp = pytest.MonkeyPatch()
    mp.setattr(pa, "flash_attention", flash)
    yield
    mp.undo()


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    w = np.ones((B, M), np.float32)
    w[1, -5:] = 0.0                              # padded prediction slots
    return dict(
        ids=rs.randint(0, CFG["vocab_size"], (B, T)).astype(np.int32),
        types=(np.arange(T)[None, :] >= rs.randint(1, T, (B, 1)))
        .astype(np.int32),
        pos=np.stack([rs.choice(T, M, replace=False) for _ in range(B)])
        .astype(np.int32),
        labels=rs.randint(0, CFG["vocab_size"], (B, M)).astype(np.int32),
        weights=w,
        nsp=rs.randint(0, 2, (B,)).astype(np.int32))


def _init_params(names_shapes, seed=0):
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in names_shapes:
        val = rs.randn(*shape).astype(np.float32) * 0.1
        if name.endswith(".gamma"):
            val += 1.0
        out[name] = val
    return out


def _jax_step(net, batch):
    a = {k: jmx.nd.array(v, dtype=str(v.dtype)) for k, v in batch.items()}
    with jautograd.record():
        mlm, nsp = net(a["ids"], a["types"], None, a["pos"])
        loss = jbert.pretraining_loss(mlm, nsp, a["labels"], a["weights"],
                                      a["nsp"])
    loss.backward()
    return mlm, nsp, loss


def _port_step(net, batch):
    a = {k: torch.from_numpy(v) for k, v in batch.items()}
    with autograd.record():
        mlm, nsp = net(a["ids"], a["types"], None, a["pos"])
        loss = tbert.pretraining_loss(mlm, nsp, a["labels"], a["weights"],
                                      a["nsp"])
    loss.backward()
    return mlm, nsp, loss


@pytest.fixture(scope="module")
def jax_runs(jit_pallas):
    """For each optimizer: 3 steps from the same weights; step 0's outputs,
    loss and gradients are kept from the SGD run."""
    net = jbert.BERTForPretraining(dropout=0.0, **CFG)
    net.initialize()
    params = net.collect_params()
    init = _init_params([(k, p.shape) for k, p in params.items()])
    batch = _batch()
    runs = {}
    for opt, kw in OPTS.items():
        for name, p in params.items():
            p.set_data(jmx.nd.array(init[name]))
        trainer = jgluon.Trainer(params, opt, dict(kw))
        losses = []
        for step in range(3):
            mlm, nsp, loss = _jax_step(net, batch)
            losses.append(float(loss.asnumpy()))
            if step == 0 and opt == "sgd":
                runs["step0"] = dict(
                    mlm=mlm.asnumpy(), nsp=nsp.asnumpy(), loss=losses[0],
                    grads={k: p.grad().asnumpy() for k, p in params.items()})
            trainer.step(1)
        runs[opt] = (losses, {k: p.data().asnumpy()
                              for k, p in params.items()})
    return init, batch, runs


def _port_net(init):
    net = tbert.BERTForPretraining(dropout=0.0, **CFG)
    net.initialize(ctx=mx.cpu())
    convert.load_jax_params(net, init)
    return net


def test_pretraining_outputs_and_gradients_match_jax(jax_runs):
    init, batch, runs = jax_runs
    want = runs["step0"]
    net = _port_net(init)
    assert list(net.collect_params()) == list(init)   # same names
    launches = fa.flash_attention.launches
    mlm, nsp, loss = _port_step(net, batch)
    assert fa.flash_attention.launches == launches    # CPU: plain versions
    np.testing.assert_allclose(mlm.detach().numpy(), want["mlm"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(nsp.detach().numpy(), want["nsp"], rtol=0,
                               atol=ATOL)
    assert abs(loss.item() - want["loss"]) <= ATOL
    for name, p in net.collect_params().items():
        g = want["grads"][name]
        assert p.grad is not None, name
        np.testing.assert_allclose(
            p.grad.numpy(), g, rtol=0,
            atol=ATOL * max(1.0, float(np.abs(g).max())), err_msg=name)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_trainer_trajectory_matches_jax(jax_runs, opt):
    init, batch, runs = jax_runs
    want_losses, want_params = runs[opt]
    net = _port_net(init)
    trainer = gluon.Trainer(net.collect_params(), opt, dict(OPTS[opt]))
    losses = []
    for _ in range(3):
        losses.append(_port_step(net, batch)[2].item())
        trainer.step(1)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=ATOL)
    tol = 1e-4 if opt == "sgd" else 3 * OPTS[opt]["learning_rate"]
    for name, p in net.collect_params().items():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name],
                                   rtol=0, atol=tol, err_msg=name)
        assert p.grad is None        # grad_req='write': cleared once applied


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01,
                 clip_gradient=0.5)),
    ("adam", dict(learning_rate=0.01, wd=0.01, rescale_grad=0.5)),
    ("adamw", dict(learning_rate=0.01, wd=0.1))])
def test_optimizer_update_matches_jax(name, kw):
    rs = np.random.RandomState(1)
    w0 = rs.randn(5, 7).astype(np.float32)
    grads = [rs.randn(5, 7).astype(np.float32) for _ in range(3)]
    jo, to = jopt.create(name, **kw), topt.create(name, **kw)
    jw = jmx.nd.array(w0)
    tw = torch.from_numpy(w0.copy())
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    for g in grads:
        jo.update(0, jw, jmx.nd.array(g), js)
        to.update(0, tw, torch.from_numpy(g), ts)
    np.testing.assert_allclose(tw.numpy(), jw.asnumpy(), rtol=0, atol=1e-6)


def test_record_pause_and_training_flags():
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        assert torch.is_grad_enabled()
        with autograd.pause():
            assert not autograd.is_recording()
            assert not autograd.is_training()
            assert not torch.is_grad_enabled()
        with autograd.predict_mode():
            assert autograd.is_recording() and not autograd.is_training()
    with autograd.record(train_mode=False):
        assert autograd.is_recording() and not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training() and not autograd.is_recording()
    assert not autograd.is_recording() and not autograd.is_training()
    assert torch.is_grad_enabled()     # torch's global mode is untouched


def _tiny_bert(dropout):
    cfg = dict(CFG, max_length=64)
    net = tbert.BERTForPretraining(dropout=dropout, **cfg)
    net.initialize(ctx=mx.cpu())
    return net


def test_head_outside_record_has_no_graph():
    net = _tiny_bert(0.0)
    ids = torch.zeros(1, 16, dtype=torch.int32)
    mlm, _ = net(ids, ids)
    assert not mlm.requires_grad
    with pytest.raises(MXNetError, match="record"):
        autograd.backward(mlm.sum())
    with autograd.record():
        mlm, _ = net(ids, ids)
    autograd.backward(mlm.sum())
    w = net.bert.word_embed.weight
    g_tied = w.grad.clone()
    [g_alone] = autograd.grad(_tiny_bert_head(net, ids), [w])
    # the tied decoder adds its own term to the embedding's gradient
    assert not torch.allclose(g_tied, g_alone)


def _tiny_bert_head(net, ids):
    with autograd.record():
        return net.bert(ids, ids)[0].sum()


def test_dropout_only_inside_record():
    net = _tiny_bert(0.5)
    ids = torch.arange(32, dtype=torch.int32).reshape(2, 16)
    types = torch.zeros_like(ids)
    a, _ = net(ids, types)
    b, _ = net(ids, types)
    assert torch.equal(a, b)                         # predict: no dropout
    with autograd.record(train_mode=False):
        c, _ = net(ids, types)
    torch.testing.assert_close(c.detach(), a, rtol=0, atol=1e-6)
    mx.random.seed(4)
    with autograd.record():
        d, _ = net(ids, types)
    mx.random.seed(4)
    with autograd.record():
        e, _ = net(ids, types)
    assert not torch.allclose(d, a)                  # training drops
    assert torch.equal(d, e)                         # seeded


def test_initialize_and_grad_req():
    net = tbert.BERTModel(**dict(CFG, max_length=64, num_layers=1))
    dense = net.pooler
    dense.weight.init = "zeros"                      # its own init wins
    net.initialize(ctx=mx.cpu())
    params = net.collect_params()
    emb = params["word_embed.weight"]
    assert 0 < emb.detach().abs().max() <= 0.07      # Uniform(0.07)
    assert not dense.weight.detach().any()
    assert params["embed_ln.gamma"].detach().eq(1.0).all()
    assert not params["pooler.bias"].detach().any()
    before = emb.detach().clone()
    net.initialize(ctx=mx.cpu())                     # already initialized
    assert torch.equal(emb, before)
    emb.grad_req = "null"
    assert not emb.requires_grad
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 1.0})
    ids = torch.zeros(1, 8, dtype=torch.int32)
    with autograd.record():
        loss = net(ids, ids)[1].sum()
    loss.backward()
    trainer.step(1)
    assert torch.equal(emb, before)                  # 'null': never updated
    assert any(e["name"] == "trainer_step" for e in mx.trace.events())
    with pytest.raises(MXNetError, match="not ported"):
        gluon.Trainer(params, "sgd", zero=1)


def test_jax_hybridized_call_mistakes_none_for_an_input():
    """A fault of the reference (ROADMAP.md Queue 3): a hybridized JAX
    block marks its traced inputs with None (``mxnet_tpu/gluon/block.py``
    ``_make_pure_fn``, ``merged.append(NDArray(next(di)) if x is None``),
    so the BERT recipe's own ``valid_length=None`` argument raises
    StopIteration once the block is hybridized.  The port's hybridize()
    leaves eager execution as it is and takes the call."""
    cfg = dict(vocab_size=20, units=16, hidden_size=32, num_layers=1,
               num_heads=2, max_length=16)
    ids = np.zeros((1, 8), np.int32)
    pos = np.zeros((1, 2), np.int32)
    jnet = jbert.BERTForPretraining(dropout=0.0, **cfg)
    jnet.initialize()
    jnet.hybridize()
    depth = len(_jax_trace_stack)
    try:
        with pytest.raises(StopIteration):
            jnet(jmx.nd.array(ids, dtype="int32"),
                 jmx.nd.array(ids, dtype="int32"), None,
                 jmx.nd.array(pos, dtype="int32"))
        # the raise also leaves the call's trace context on the JAX
        # package's trace stack (pushed before the failing line, popped
        # only by a later finally)
        assert len(_jax_trace_stack) == depth + 1
    finally:
        # left there, its id()-keyed substitutions would hand this net's
        # tracers to any later JAX Parameter that reuses one of its ids
        del _jax_trace_stack[depth:]
    tnet = tbert.BERTForPretraining(dropout=0.0, **cfg)
    tnet.initialize(ctx=mx.cpu())
    tnet.hybridize()
    t = torch.from_numpy(ids)
    mlm, nsp = tnet(t, t, None, torch.from_numpy(pos))
    assert mlm.shape == (1, 2, 20) and nsp.shape == (1, 2)
