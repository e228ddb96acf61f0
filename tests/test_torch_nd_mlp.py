"""``BASELINE.json`` config 1 (the Gluon MLP of ``examples/mnist_mlp.py``)
and ``nd.multi_head_attention`` through the PyTorch port's ``mx.nd``,
against the JAX package, on the CPU.

- The MLP, 784 -> 128 -> 64 -> 10 with ReLU, starts from the JAX
  package's weights (carried by ``convert.load_jax_params``) and takes 5
  Adam steps at lr 1e-3 and B=32 in both packages, every array an NDArray:
  ``nd.array(batch)`` -> ``net(x)`` -> ``SoftmaxCrossEntropyLoss`` ->
  ``.mean()`` -> ``backward()`` -> ``trainer.step(1)`` -> ``asnumpy()``.
  Per-step losses and the final weights agree within 1e-5.
- ``nd.multi_head_attention`` on NDArrays under ``autograd.record()`` at
  (2, 256, 64) with 2 heads: ``impl='auto'`` takes the flash route (on CPU
  tensors the kernels' plain version) and is held to the JAX op with
  ``impl='pallas'`` (the Pallas kernels in interpret mode, under
  ``jax.jit``, as ``tests/test_torch_flash_backward.py`` runs them) within
  1e-5 for the output and the q/k/v gradients; ``impl='dense'`` to the
  JAX dense route, no dropout.  With dropout the port's route is held to
  its own dense route fed the kernels' mask.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops import nn as jops
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops import flash_attention as fa

TOL = 1e-5
B, STEPS = 32, 5


def _mlp(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(128, activation="relu", in_units=784),
            nn.Dense(64, activation="relu", in_units=128),
            nn.Dense(10, in_units=64))
    return net


def _batches(seed=0):
    """Synthetic MNIST-like batches: 10 class prototypes plus noise."""
    rs = np.random.RandomState(seed)
    protos = rs.rand(10, 784).astype(np.float32)
    out = []
    for _ in range(STEPS):
        y = rs.randint(0, 10, B)
        x = np.clip(protos[y] + 0.3 * rs.randn(B, 784), 0, 1)
        out.append((x.astype(np.float32), y.astype(np.float32)))
    return out


def _train(mx, nn, net, batches):
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
    losses = []
    for xb, yb in batches:
        x, y = mx.nd.array(xb), mx.nd.array(yb)
        with mx.autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
    return losses


@pytest.fixture(scope="module")
def mlp_runs():
    mj.random.seed(0)
    jnet = _mlp(jnn)
    jnet.initialize()
    init = {k: v.data().asnumpy() for k, v in jnet.collect_params().items()}
    tnet = _mlp(tnn)
    tnet.initialize(ctx=mt.cpu())
    convert.load_jax_params(tnet, init)
    batches = _batches()
    jl = _train(mj, jnn, jnet, batches)
    with mt.cpu():
        tl = _train(mt, tnn, tnet, batches)
    return jl, tl, jnet, tnet


def test_mlp_losses_match_jax(mlp_runs):
    jl, tl, _, _ = mlp_runs
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)


def test_mlp_weights_match_jax(mlp_runs):
    _, _, jnet, tnet = mlp_runs
    tparams = tnet.collect_params()
    for name, p in jnet.collect_params().items():
        np.testing.assert_allclose(tparams[name].detach().numpy(),
                                   p.data().asnumpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_mlp_outputs_are_ndarrays():
    net = _mlp(tnn)
    net.initialize(ctx=mt.cpu())
    with mt.cpu():
        out = net(mt.nd.ones((2, 784)))
    assert isinstance(out, mt.nd.NDArray) and out.shape == (2, 10)
    raw = net(torch.ones(2, 784))
    assert isinstance(raw, torch.Tensor)   # tensors in, tensors out
    np.testing.assert_array_equal(raw.numpy(), out.asnumpy())
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with mt.cpu():
        label = mt.nd.array([1.0, 3.0])
        by_name = loss_fn(pred=out, label=label)   # NDArrays as keywords
    assert isinstance(by_name, mt.nd.NDArray)
    np.testing.assert_array_equal(by_name.asnumpy(),
                                  loss_fn(out, label).asnumpy())


# ---- nd.multi_head_attention -------------------------------------------------

SHAPE, HEADS = (2, 256, 64), 2


def _qkv_do(seed=3):
    rs = np.random.RandomState(seed)
    return [rs.randn(*SHAPE).astype(np.float32) for _ in range(4)]


def _jax_ref(impl, q, k, v, do):
    fn = jax.jit(lambda a, b, c: jops.multi_head_attention.fn(
        a, b, c, num_heads=HEADS, impl=impl))
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port(impl, q, k, v, do, **kw):
    with mt.cpu():
        qs = [mt.nd.array(a) for a in (q, k, v)]
        for a in qs:
            a.attach_grad()
        with mt.autograd.record():
            out = mt.nd.multi_head_attention(*qs, num_heads=HEADS,
                                             impl=impl, **kw)
        out.backward(mt.nd.array(do))
    assert isinstance(out, mt.nd.NDArray)
    return [out.asnumpy()] + [a.grad.asnumpy() for a in qs]


@pytest.mark.parametrize("impl,jax_impl", [("auto", "pallas"),
                                           ("dense", "dense")])
def test_multi_head_attention_matches_jax(impl, jax_impl):
    q, k, v, do = _qkv_do()
    assert fa.use_flash(SHAPE[1], SHAPE[1], SHAPE[2] // HEADS, False)
    want = _jax_ref(jax_impl, q, k, v, do)
    got = _port(impl, q, k, v, do)
    for g, w, name in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=name)


def test_multi_head_attention_dropout_routes_agree():
    """With dropout 0.1 the flash route and the dense route use the same
    kernel mask for one seed: outputs and gradients agree."""
    q, k, v, do = _qkv_do(5)
    flash = _port("auto", q, k, v, do, attn_dropout=0.1, dropout_seed=1234)
    dense = _port("dense", q, k, v, do, attn_dropout=0.1, dropout_seed=1234)
    plain = _port("auto", q, k, v, do)
    for f, d in zip(flash, dense):
        np.testing.assert_allclose(f, d, rtol=0, atol=TOL)
    assert np.abs(flash[0] - plain[0]).max() > 1e-3   # dropout acted
