"""The port's ``gluon.nn.MoE`` against the JAX package's, on the CPU.

Both packages build the layer (stacked experts ``w1``, ``b1``, ``w2``,
``b2`` and ``gate``, the same names and shapes), take the same random
numpy weights, and run the dense-gather forward on the same tokens; the
output, the input's gradient and every parameter's gradient of
``sum(out * ct)`` agree within 1e-5 x max(1, max|ref|) (f32).  The JAX
side is the block's pure function under ``jax.jit`` and ``jax.vjp``.

``jax.lax.top_k`` and ``torch.topk`` break ties differently, so the
inputs are checked to have no two gate probabilities of a token within
1e-6 of each other: then both pick the same experts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd
from mxnet_tpu_torch.gluon import nn as tnn

TOL = 1e-5


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=TOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


CASES = {
    # name: (num_experts, hidden, units, top_k, in_units, activation, x)
    "relu_top2": (4, 16, 8, 2, 0, "relu", (12, 8)),
    "gelu_top2_3d": (6, 12, 10, 2, 0, "gelu", (2, 5, 10)),
    "relu_top1_in_units": (3, 8, 6, 1, 5, "relu", (7, 5)),
    "gelu_top3": (5, 8, 4, 3, 6, "gelu", (3, 4, 6)),
}


def _no_ties(x, gate, k):
    logits = x.reshape(-1, x.shape[-1]) @ gate.T
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    gaps = p[:, :k] - p[:, 1:k + 1]
    return float(gaps.min()) > 1e-6


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_matches_jax(case):
    E, hidden, units, k, in_units, act, shape = CASES[case]
    rs = np.random.RandomState(len(case))
    kwargs = dict(top_k=k, in_units=in_units, activation=act)
    jblk = jnn.MoE(E, hidden, units, **kwargs)
    tblk = tnn.MoE(E, hidden, units, **kwargs)
    shapes = {n: tuple(p.shape) for n, p in jblk.collect_params().items()}
    assert [(n, tuple(p.shape)) for n, p in tblk.collect_params().items()] \
        == list(shapes.items())
    assert list(shapes) == ["w1", "b1", "w2", "b2", "gate"]
    w = {n: (rs.randn(*s) * (0.5 if n == "gate" else 0.3)).astype(np.float32)
         for n, s in shapes.items()}
    x = rs.randn(*shape).astype(np.float32)
    assert _no_ties(x, w["gate"], k)
    ct = rs.randn(*(shape[:-1] + (units,))).astype(np.float32)
    for n, p in jblk.collect_params().items():
        p.set_data(jax.numpy.asarray(w[n]))
    tblk.initialize(ctx=mx.cpu())
    mx.convert.load_jax_params(tblk, w)

    apply_fn, params = jblk.export_pure(training=True)

    def vjp(p, xx, c):
        out, pull = jax.vjp(
            lambda pp, xv: apply_fn(pp, jax.random.PRNGKey(0), xv)[0][0],
            p, xx)
        return (out,) + pull(c)

    want, want_gp, want_gx = jax.jit(vjp)(params, jnp.asarray(x),
                                          jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    with autograd.record():
        out = tblk(xt)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out, want, "output")
    _close(xt.grad, want_gx, "input gradient")
    for n, p in tblk.collect_params().items():
        _close(p.grad, want_gp[n], "gradient of " + n)


def test_moe_arguments():
    with pytest.raises(MXNetError, match="top_k"):
        tnn.MoE(4, 8, 8, top_k=5)
    with pytest.raises(MXNetError, match="activation"):
        tnn.MoE(4, 8, 8, activation="tanh")
    blk = tnn.MoE(4, 8, 8)
    blk.initialize(ctx=mx.cpu())
    assert blk.b1.abs().max() == 0 and blk.w1.abs().max() > 0
    assert repr(blk) == repr(jnn.MoE(4, 8, 8))
