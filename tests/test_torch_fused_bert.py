"""Mixed-precision BERT pretraining through the port's
``parallel.FusedTrainer`` against the JAX package's, on the CPU.

A 2-layer BERT (64 units, 2 heads, so D=32) at B=2, T=256 (so that
``impl='auto'`` takes the flash path: the JAX side reaches the Pallas
kernels in interpret mode, the port the kernels' plain versions), dropout
0, 38 masked positions, the same numpy weights and batch on both sides.
Two SGD steps (lr 0.1, no momentum: the weights move by lr x the gradient,
so a bound on them is a bound on the gradients).

- bf16: both sides compute the dense layers and attention in bf16 (8
  significant bits, 2^-9 relative a rounding) but round at different
  places (torch fuses the bias into the product; XLA rounds, then adds).
  Bound: each loss within 2e-2, each weight within 2e-3 (the largest
  update is ~0.05).
- float16: the JAX package's dense layers promote f32 x fp16 to f32, so
  both sides compute in f32 on fp16-rounded weights and gradients.
  Bound: each loss within 1e-4 and each weight within 5e-4 (an fp16
  rounding of a ~0.3 weight is 1.5e-4).
- The dtypes: in bf16 q/k/v reach the attention in bf16 and the residual
  stream stays f32; in fp16 the attention runs in f32, on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.block import HybridBlock as JHybridBlock
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.ops import pallas_attention as pa
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import nn as tops

CFG = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
           num_heads=2, max_length=256)
B, T, M, STEPS = 2, 256, 38, 2
OPT = {"learning_rate": 0.1, "momentum": 0.0}
BOUND = {"bfloat16": (2e-2, 2e-3), "float16": (1e-4, 5e-4)}  # loss, weight


class _JStep(JHybridBlock):
    def __init__(self):
        super().__init__()
        self.model = jbert.BERTForPretraining(dropout=0.0, **CFG)

    def forward(self, ids, types, pos):
        return self.model(ids, types, valid_length=None,
                          masked_positions=pos)


class _TStep(mx.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.model = tbert.BERTForPretraining(dropout=0.0, **CFG)

    def forward(self, ids, types, pos):
        return self.model(ids, types, valid_length=None,
                          masked_positions=pos)


def _jax_loss(outs, labels, nsp):
    mlm, nsp_scores = outs
    logp = jax.nn.log_softmax(mlm.astype(jnp.float32), -1)
    ll = jnp.take_along_axis(logp, labels[..., None].astype(jnp.int32),
                             -1)[..., 0]
    nlogp = jax.nn.log_softmax(nsp_scores.astype(jnp.float32), -1)
    nll = jnp.take_along_axis(nlogp, nsp[:, None].astype(jnp.int32),
                              -1)[..., 0]
    return -jnp.mean(ll) - jnp.mean(nll)


def _port_loss(outs, labels, nsp):
    mlm, nsp_scores = outs
    logp = torch.log_softmax(mlm.float(), -1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    nlogp = torch.log_softmax(nsp_scores.float(), -1)
    nll = torch.gather(nlogp, -1, nsp.long()[:, None])[..., 0]
    return -ll.mean() - nll.mean()


def _data(names_shapes):
    rs = np.random.RandomState(0)
    init = {}
    for name, shape in names_shapes:
        init[name] = (rs.randn(*shape) * 0.1).astype(np.float32)
        if name.endswith(".gamma"):
            init[name] += 1.0
    x = (rs.randint(0, CFG["vocab_size"], (B, T)).astype(np.int32),
         rs.randint(0, 2, (B, T)).astype(np.int32),
         np.sort(rs.choice(T, (B, M)), 1).astype(np.int32))
    y = (rs.randint(0, CFG["vocab_size"], (B, M)).astype(np.int32),
         rs.randint(0, 2, B).astype(np.int32))
    return init, x, y


@pytest.fixture(scope="module")
def jax_runs():
    """Per dtype: the losses, final weights and the dtypes q took into
    the Pallas attention, from the JAX FusedTrainer."""
    net = _JStep()
    net.initialize()
    params = net.collect_params()
    init, x, y = _data([(k, p.shape) for k, p in params.items()])
    seen = []
    orig = pa.flash_attention

    def spy(q, *a, **kw):
        seen.append(str(q.dtype))
        return orig(q, *a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(pa, "flash_attention", spy)
    runs = {}
    try:
        for dtype in BOUND:
            for k, p in params.items():
                p.set_data(jmx.nd.array(init[k]))
            seen.clear()
            tr = jpar.FusedTrainer(net, loss_fn=_jax_loss, optimizer="sgd",
                                   optimizer_params=dict(OPT), dtype=dtype)
            losses = [float(tr.step(x, y).asnumpy()) for _ in range(STEPS)]
            tr.sync_block()
            runs[dtype] = (losses, {k: p.data().asnumpy()
                                    for k, p in params.items()},
                           sorted(set(seen)))
    finally:
        mp.undo()
    return init, x, y, runs


def _port_run(init, x, y, dtype):
    net = _TStep()
    net.initialize(ctx=mx.cpu())
    mx.convert.load_jax_params(net, init)
    tr = parallel.FusedTrainer(net, loss_fn=_port_loss, optimizer="sgd",
                               optimizer_params=dict(OPT), dtype=dtype)
    xs, ys = tuple(map(torch.from_numpy, x)), tuple(map(torch.from_numpy, y))
    losses = [tr.step(xs, ys).item() for _ in range(STEPS)]
    return net, losses


@pytest.mark.parametrize("dtype", sorted(BOUND))
def test_mixed_precision_step_matches_jax(jax_runs, dtype):
    init, x, y, runs = jax_runs
    want_losses, want, _ = runs[dtype]
    launches = fa.flash_attention.launches
    net, losses = _port_run(init, x, y, dtype)
    assert fa.flash_attention.launches == launches    # CPU: plain versions
    tol_loss, tol_w = BOUND[dtype]
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=tol_loss)
    assert losses[-1] < losses[0]
    moved = 0.0
    for name, p in net.collect_params().items():
        assert p.dtype == torch.float32, name          # f32 masters
        w = p.detach().numpy()
        np.testing.assert_allclose(w, want[name], rtol=0, atol=tol_w,
                                   err_msg=name)
        moved = max(moved, float(np.abs(w - init[name]).max()))
    assert moved > 10 * tol_w                          # the bound is not void


@pytest.mark.parametrize("dtype", sorted(BOUND))
def test_mixed_precision_dtype_flow(jax_runs, dtype, monkeypatch):
    """bf16: q/k/v reach the flash path in bf16 and the residual stream
    (the input of each encoder cell's LayerNorms) is f32; fp16: attention
    in f32.  The attention dtype matches the JAX package's."""
    init, x, y, runs = jax_runs
    seen = {"q": set(), "ln": []}
    orig_fa, orig_ln = fa.flash_attention, tops.layer_norm

    def fa_spy(q, k, v, *a, **kw):
        seen["q"].add((q.dtype, k.dtype, v.dtype))
        return orig_fa(q, k, v, *a, **kw)

    def ln_spy(x, *a, **kw):
        seen["ln"].append(x.dtype)
        return orig_ln(x, *a, **kw)

    monkeypatch.setattr(fa, "flash_attention", fa_spy)
    monkeypatch.setattr(tops, "layer_norm", ln_spy)
    _port_run(init, x, y, dtype)
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert seen["q"] == {(want,) * 3}
    assert [str(want).replace("torch.", "")] == runs[dtype][2]
    # per step: embed_ln, then attn_ln and ffn_ln per layer, then mlm_ln
    per_step = 2 + 2 * CFG["num_layers"]
    lns = seen["ln"][:per_step]
    assert len(seen["ln"]) == STEPS * per_step
    if dtype == "bfloat16":
        assert lns[0] == torch.bfloat16          # the embeddings' sum
        assert set(lns[1:-1]) == {torch.float32}  # the residual stream
        assert lns[-1] == torch.bfloat16         # the MLM transform's out
    else:
        assert set(lns[1:]) == {torch.float32}
