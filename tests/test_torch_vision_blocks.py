"""The blocks the port's vision families are made of, in train mode,
against the JAX package's, on the CPU.

MobileNet v2's ``LinearBottleneck`` (with its ReLU6, stride 1 with the
shortcut and stride 2), MobileNet v1's depthwise pair, a DenseNet dense
block and transition, a SqueezeNet fire module and Inception-v3's grid
blocks A-E (``_Concurrent``, ``_BranchSplit``) are built in both packages
from the family modules, given the same random numpy weights (BatchNorm
statistics included), and run in train mode: the output, the input's and
every parameter's gradient of ``sum(out * ct)`` and the running
statistics the call leaves agree within 1e-4 x max(1, max|ref|), the JAX
side being the block's pure function under ``jax.jit`` and ``jax.vjp``.

Whole nets are compared in eval mode only (``test_torch_vision_zoo.py``):
through 50-120 layers of batch statistics at a few values a channel, f32
rounding moves some activations across a ReLU kink in one package and
not the other, and a few input-gradient elements then differ by ~1e-2 of
their range.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

from test_torch_vision_zoo import _close, random_weights

# block: (build(module), input shape)
BLOCKS = {
    "mobilenet_v2_bottleneck": (
        lambda m: m.mobilenet.LinearBottleneck(8, 8, 6, 1), (4, 8, 6, 6)),
    "mobilenet_v2_bottleneck_stride2": (
        lambda m: m.mobilenet.LinearBottleneck(8, 16, 6, 2), (4, 8, 6, 6)),
    "mobilenet_v1_depthwise": (lambda m: _dw(m), (4, 8, 6, 6)),
    "densenet_block_transition": (lambda m: _dense(m), (4, 8, 6, 6)),
    "squeezenet_fire": (lambda m: m.squeezenet._make_fire(4, 8, 8),
                        (4, 8, 6, 6)),
    "inception_A": (lambda m: m.inception._make_A(8), (2, 16, 7, 7)),
    "inception_B": (lambda m: m.inception._make_B(), (2, 16, 7, 7)),
    "inception_C": (lambda m: m.inception._make_C(8), (2, 16, 7, 7)),
    "inception_D": (lambda m: m.inception._make_D(), (2, 16, 7, 7)),
    "inception_E": (lambda m: m.inception._make_E(), (2, 16, 5, 5)),
}


def _dw(m):
    out = m.mobilenet.nn.HybridSequential()
    m.mobilenet._add_conv_dw(out, 8, 12, 2)
    return out


def _dense(m):
    out = m.densenet.nn.HybridSequential()
    out.add(m.densenet._make_dense_block(2, 2, 4, 0),
            m.densenet._make_transition(8))
    return out



@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_train_grads_and_running_stats_match_jax(name):
    build, shape = BLOCKS[name]
    rs = np.random.RandomState(len(name))
    x = rs.randn(*shape).astype(np.float32)
    tnet = build(tvision)
    tnet.initialize(ctx=mx.cpu())
    with autograd.pause():
        probe = tnet(torch.from_numpy(x))
    ct = rs.randn(*probe.shape).astype(np.float32)
    w = random_weights({k: tuple(p.shape) for k, p in
                        tnet.collect_params().items()}, rs)
    mx.convert.load_jax_params(tnet, w)
    jnet = build(jvision)
    assert list(jnet.collect_params()) == list(w)
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(w[k]))
    apply_fn, params = jnet.export_pure(training=True)

    def fwd(p, xx):
        outs, states = apply_fn(p, jax.random.PRNGKey(0), xx)
        return outs[0], states

    def vjp(p, xx, c):
        (out, states), pull = jax.vjp(fwd, p, xx)
        zero = jax.tree_util.tree_map(jnp.zeros_like, states)
        return out, states, pull((c, zero))

    jout, jstates, (jgp, jgx) = jax.jit(vjp)(params, jnp.asarray(x),
                                              jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    with autograd.record():
        out = tnet(xt)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out, jout, "train output")
    _close(xt.grad, jgx, "input gradient")
    tparams = tnet.collect_params()
    for k, p in tparams.items():
        if p.grad_req != "null":
            _close(p.grad, jgp[k], "gradient of " + k)
    stats = sorted(k for k in w if "running_" in k)
    assert sorted(jstates) == stats
    for k in stats:
        _close(tparams[k], jstates[k], "running stat " + k)
