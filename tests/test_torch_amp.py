"""The op half of the port's ``contrib.amp`` against the JAX package's, on
the CPU.

- The classification (``contrib/amp/lists.py``) covers every name the
  port's registry has, each with the category the JAX package gives it.
- Under ``amp.init('bfloat16')`` and ``amp.init('float16')`` an op of each
  category, called through ``mx.nd`` on the same inputs, gives the JAX
  package's output dtype and each input's gradient dtype (float32 inputs
  keep float32 gradients), and values within the target's rounding:
  2e-2 (bf16) or 2e-3 (fp16) x max(1, max|ref|).
- The Gluon route: a small conv net and a transformer cell under amp give
  the JAX dtypes inside (read by forward hooks) and out, and float32
  parameter gradients, values within the same limits (the JAX side is the
  block's pure function, traced under amp, in ``jax.jit``).
- ``amp.init`` that would not reach the ops the layers call raises; an
  op called inside another rewritten op is not rewritten again; with amp
  off a rewritten op is the plain function, bit for bit.
- ``LossScaler``'s overflow cycle (``has_overflow``, ``unscale``,
  ``update_scale``, ``scale``) matches the JAX one step for step, with one
  inf and one NaN gradient among the steps.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.contrib.amp import lists as jlists
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.contrib.amp import lists
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops import nn as ops_nn
from mxnet_tpu_torch.ops import registry

TOL = {"bfloat16": 2e-2, "float16": 2e-3}


@pytest.fixture(autouse=True)
def amp_off():
    yield
    amp.disable()
    jamp.disable()


def _close(got, want, tol, what):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _dt(x):
    return str(x.dtype).replace("torch.", "")


def test_classification_covers_every_port_registry_name():
    table = lists.classification()
    assert set(table) == set(registry.list_ops())
    jtable = jlists.classification()
    assert {n: table[n] for n in table if n in jtable} == \
        {n: jtable[n] for n in table if n in jtable}
    for name, cat in table.items():
        fn = registry.get_op(name).fn
        assert getattr(fn, "amp_category", "passthrough") == cat, name
    assert lists.category_of("fully_connected") == "target_dtype"
    assert lists.category_of("no_such_op") == "passthrough"


# op: (inputs as (shape, dtype or None for the target), attrs)
OPS = {
    "fully_connected": ([((2, 5), "float32"), ((3, 5), "float32"),
                         ((3,), "float32")], {"num_hidden": 3}),
    "dot": ([((2, 4), "float32"), ((4, 3), "float32")], {}),
    "convolution": ([((1, 2, 5, 5), "float32"), ((3, 2, 3, 3), "float32"),
                     ((3,), "float32")], {"kernel": (3, 3), "num_filter": 3}),
    "softmax": ([((2, 6), None)], {}),
    "layer_norm": ([((2, 6), None), ((6,), "float32"), ((6,), "float32")],
                   {}),
    "sum": ([((3, 4), None)], {}),
    "exp": ([((3, 4), None)], {}),
    "add": ([((3, 4), "float32"), ((3, 4), None)], {}),
    "maximum": ([((3, 4), None), ((3, 4), "float32")], {}),
    "relu": ([((3, 4), None)], {}),
}


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("target", ["bfloat16", "float16"])
def test_op_rewrite_gives_the_jax_dtypes(op, target):
    specs, attrs = OPS[op]
    rs = np.random.RandomState(len(op))
    arrays = [(rs.randn(*shape) * 0.5).astype(np.float32)
              for shape, _ in specs]
    dtypes = [dt or target for _, dt in specs]

    jamp.init(target)
    jin = [jmx.nd.array(a).astype(d) for a, d in zip(arrays, dtypes)]
    for x in jin:
        x.attach_grad()
    with jmx.autograd.record():
        jout = getattr(jmx.nd, op)(*jin, **attrs)
        jmx.nd.sum(jout.astype("float32")).backward()

    amp.init(target)
    assert amp.is_active() and amp.target_dtype() == target
    tin = [torch.from_numpy(a).to(getattr(torch, d)).requires_grad_()
           for a, d in zip(arrays, dtypes)]
    with autograd.record():
        tout = getattr(mx.nd, op)(*[mx.nd.NDArray(t) for t in tin], **attrs)
        tout._data.float().sum().backward()

    assert _dt(tout) == str(jout.dtype)
    assert [_dt(t.grad) for t in tin] == [str(x.grad.dtype) for x in jin]
    assert [_dt(t.grad) for t in tin] == dtypes
    tol = TOL[target]
    _close(tout._data.float(), jout.astype("float32").asnumpy(), tol, "out")
    for t, x in zip(tin, jin):
        _close(t.grad.float(), x.grad.astype("float32").asnumpy(), tol,
               "gradient")


def _convnet(pkg):
    return pkg.HybridSequential(
        pkg.Conv2D(4, 3, padding=1, in_channels=2),
        pkg.BatchNorm(in_channels=4), pkg.Activation("relu"),
        pkg.Dense(3, in_units=4 * 5 * 5))


def _cell(pkg):
    return pkg.TransformerEncoderCell(8, 16, 2)


@pytest.mark.parametrize("net,shape", [("convnet", (2, 2, 5, 5)),
                                       ("transformer_cell", (2, 6, 8))])
@pytest.mark.parametrize("target", ["bfloat16", "float16"])
def test_gluon_layers_pass_the_rewrite(net, shape, target):
    make = {"convnet": _convnet, "transformer_cell": _cell}[net]
    rs = np.random.RandomState(7)
    x = rs.randn(*shape).astype(np.float32)
    tnet = make(tnn)
    tnet.initialize(ctx=mx.cpu())
    w = {k: (1.0 + 0.1 * rs.randn(*p.shape) if k.endswith(("gamma",
                                                           "running_var"))
             else 0.3 * rs.randn(*p.shape)).astype(np.float32)
         for k, p in tnet.collect_params().items()}
    mx.convert.load_jax_params(tnet, w)
    jnet = make(jnn)
    jnet.initialize()
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(w[k]))

    inner = {}       # the dtype out of each net's first child
    for tag, n in (("jax", jnet), ("port", tnet)):
        first = n[0] if net == "convnet" else n.attention
        first.register_forward_hook(
            lambda blk, args, out, tag=tag: inner.setdefault(tag, _dt(out)))

    jamp.init(target)
    apply_fn, params = jnet.export_pure(training=True)

    def vjp(p, xx):
        out, pull = jax.vjp(
            lambda pp: apply_fn(pp, jax.random.PRNGKey(0), xx)[0][0], p)
        return out, pull(jax.numpy.ones_like(out))[0]

    jout, jgrads = jax.jit(vjp)(params, jax.numpy.asarray(x))
    amp.init(target)
    with autograd.record():
        tout = tnet(torch.from_numpy(x))
    tout.float().sum().backward()

    assert inner == {"jax": target, "port": target}
    assert _dt(tout) == str(jout.dtype) == {"convnet": target,
                                            "transformer_cell": "float32"}[net]
    tol = TOL[target]
    _close(tout, jout.astype("float32"), tol, "output")
    for k, p in tnet.collect_params().items():
        assert p.dtype == torch.float32, k
        if p.grad_req == "null":
            continue
        assert _dt(p.grad) == str(jgrads[k].dtype) == "float32", k
        _close(p.grad, jgrads[k], tol, "gradient of " + k)


def test_init_that_would_miss_a_layer_raises(monkeypatch):
    monkeypatch.setattr(ops_nn, "fully_connected",
                        ops_nn.fully_connected.__wrapped__)
    with pytest.raises(MXNetError, match="fully_connected"):
        amp.init("float16")
    assert not amp.is_active()


def test_init_arguments_and_state():
    with pytest.raises(MXNetError, match="target_dtype"):
        amp.init("float32")
    assert not amp.is_active() and not jamp.is_active()
    for a in (amp, jamp):
        a.init("float16")
        assert a.is_active() and a.target_dtype() == "float16"
        a.disable()
        assert not a.is_active() and a.target_dtype() == "float16"
    assert amp.amp_init is amp.init


def test_amp_off_costs_nothing_but_the_flag():
    rs = np.random.RandomState(3)
    x, w = (torch.from_numpy(rs.randn(4, 5).astype(np.float32))
            for _ in range(2))
    plain = ops_nn.fully_connected.__wrapped__(x, w)
    got = ops_nn.fully_connected(x, w)
    assert got.dtype == torch.float32 and torch.equal(got, plain)
    assert registry.AMP.dtype is None


def test_rewrite_applies_at_the_outermost_op_only():
    seen = []

    def inner(x):
        seen.append(("inner", x.dtype))
        return x

    inner_op = registry.amp_rewritten("softmax", inner)

    def outer(x):
        seen.append(("outer", x.dtype))
        return inner_op(x)

    outer_op = registry.amp_rewritten("dot", outer)
    amp.init("bfloat16")
    outer_op(torch.ones(2))
    inner_op(torch.ones(2, dtype=torch.bfloat16))
    assert seen == [("outer", torch.bfloat16), ("inner", torch.bfloat16),
                    ("inner", torch.float32)]


def test_init_trainer_attaches_a_loss_scaler():
    net = tnn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    tr = mx.gluon.Trainer(net.collect_params(), "sgd")
    assert amp.init_trainer(tr) is tr
    assert isinstance(tr._amp_loss_scaler, amp.LossScaler)
    assert tr._amp_loss_scaler.loss_scale == 2.0 ** 16


def test_loss_scaler_overflow_cycle_matches_jax():
    rs = np.random.RandomState(5)
    steps = []
    for i in range(10):
        g = [rs.randn(3, 4).astype(np.float32) * 1e3,
             rs.randn(5).astype(np.float32) * 1e3]
        if i == 2:
            g[1][3] = np.inf
        if i == 6:
            g[0][1, 2] = np.nan
        steps.append(g)
    logs = {}
    for tag, mod, wrap in (
            ("jax", jamp, lambda a: jmx.nd.array(a)),
            ("port", amp, lambda a: torch.from_numpy(a.copy())),
            ("port_nd", amp, lambda a: mx.nd.array(a, ctx=mx.cpu()))):
        sc = mod.LossScaler(init_scale=2.0 ** 4, scale_window=3)
        log = logs[tag] = []
        for g in steps:
            grads = [wrap(a) for a in g]
            ov = sc.has_overflow(grads)
            if not ov:
                sc.unscale(grads)
            sc.update_scale(ov)
            vals = [np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)
                    for x in grads]
            log.append((ov, sc.loss_scale, vals))
        log.append(float(np.asarray(sc.scale(wrap(np.float32([2.0])))
                                    .asnumpy() if tag != "port" else
                                    sc.scale(wrap(np.float32([2.0]))))[0]))
    want = logs["jax"]
    assert [s[0] for s in want[:-1]] == [False, False, True] + [False] * 3 \
        + [True] + [False] * 3
    for tag in ("port", "port_nd"):
        got = logs[tag]
        assert got[-1] == want[-1]
        for (ov, scale, vals), (jov, jscale, jvals) in zip(got[:-1],
                                                            want[:-1]):
            assert (ov, scale) == (jov, jscale)
            for v, jv in zip(vals, jvals):
                np.testing.assert_array_equal(v, jv)


def test_jax_unscale_rescales_in_place_as_the_port_does():
    g = torch.full((2, 2), 8.0)
    before = g.data_ptr()
    sc = amp.LossScaler(init_scale=4.0)
    sc.unscale([g])
    assert g.data_ptr() == before and g.tolist() == [[2.0, 2.0]] * 2
    jg = jmx.nd.array(np.full((2, 2), 8.0, np.float32))
    jamp.LossScaler(init_scale=4.0).unscale([jg])
    assert jg.asnumpy().tolist() == g.tolist()
    assert isinstance(jax.numpy.zeros(1), jax.Array)


@pytest.mark.parametrize("loss", ["L2Loss", "SigmoidBCELoss",
                                  "SoftmaxCELoss", "KLDivLoss",
                                  "PoissonNLLLoss", "CosineEmbeddingLoss"])
def test_losses_of_fp16_predictions_match_jax(loss):
    rs = np.random.RandomState(len(loss))
    pred = rs.randn(4, 5).astype(np.float16)
    label = (rs.randint(0, 5, (4,)) if loss == "SoftmaxCELoss"
             else rs.rand(4, 5)).astype(np.float32)
    extra = ([np.float32([1, -1, 1, -1])] if loss == "CosineEmbeddingLoss"
             else [])
    jamp.init("float16")
    want = getattr(jmx.gluon.loss, loss)()(
        *[jmx.nd.array(a).astype(str(a.dtype))
          for a in [pred, label] + extra])
    amp.init("float16")
    got = getattr(mx.gluon.loss, loss)()(
        *[torch.from_numpy(a) for a in [pred, label] + extra])
    assert _dt(got) == str(want.dtype)
    _close(got, want.astype("float32").asnumpy(), TOL["float16"], loss)


def test_lstm_cell_gates_match_jax_under_amp():
    from mxnet_tpu.gluon import rnn as jrnn
    from mxnet_tpu_torch.gluon import rnn as trnn

    rs = np.random.RandomState(11)
    x, h, c = (rs.randn(3, 4).astype(np.float32) for _ in range(3))
    t, j = trnn.LSTMCell(4, input_size=4), jrnn.LSTMCell(4, input_size=4)
    t.initialize(ctx=mx.cpu())
    j.initialize()
    w = {k: (0.3 * rs.randn(*p.shape)).astype(np.float32)
         for k, p in t.collect_params().items()}
    mx.convert.load_jax_params(t, w)
    for k, p in j.collect_params().items():
        p.set_data(jmx.nd.array(w[k]))
    jamp.init("float16")
    jout, jstates = j(jmx.nd.array(x), [jmx.nd.array(h), jmx.nd.array(c)])
    amp.init("float16")
    tout, tstates = t(torch.from_numpy(x),
                      [torch.from_numpy(h), torch.from_numpy(c)])
    assert [_dt(s) for s in [tout] + list(tstates)] == \
        [str(s.dtype) for s in [jout] + list(jstates)]
    for got, want in zip([tout] + list(tstates), [jout] + list(jstates)):
        _close(got, want.astype("float32").asnumpy(), TOL["float16"],
               "LSTMCell")
