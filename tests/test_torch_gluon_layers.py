"""The port's remaining ``gluon.nn`` layers and the Block/Parameter methods
against the JAX package's, on the CPU.

Each layer is built in both packages, shaped by one call of the port's,
given the same random numpy weights by name (``convert.load_jax_params``
on the port's side, ``set_data`` on the JAX side), and run under
``autograd.record()`` on the same input: the output, the input's
gradient and every parameter's gradient of ``sum(out * ct)`` agree
within 1e-5 x max(1, max|ref|) (f32).  The traps the JAX package sets
are pinned: ``Swish`` is the later ``x * sigmoid(beta * x)`` class, not
``SiLU``; ``GELU()`` is the exact erf form; ``PReLU`` is not deferred
(``alpha`` has its one entry before any call).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.gluon import nn as tnn

TOL = 1e-5


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=TOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _weights(shapes, rs):
    out = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        v = (1.0 + 0.1 * rs.randn(*shape) if leaf == "gamma"
             else 0.3 * rs.randn(*shape))
        out[name] = v.astype(np.float32)
    return out


def _run_jax(jblk, x, ct):
    """Output, input gradient and parameter gradients of ``sum(out * ct)``:
    one jitted ``jax.vjp`` of the block's pure function (a hybrid block),
    else eager ``autograd``."""
    if hasattr(jblk, "export_pure"):
        apply_fn, params = jblk.export_pure(training=True)
        train = {k for k, p in jblk.collect_params().items()
                 if p.grad_req != "null"}

        def vjp(p, xx, c):
            out, pull = jax.vjp(
                lambda pp, xv: apply_fn(pp, jax.random.PRNGKey(0), xv)[0][0],
                p, xx)
            return (out,) + pull(c)

        out, gp, gx = jax.jit(vjp)(params, jnp.asarray(x), jnp.asarray(ct))
        return out, gx, {k: gp[k] for k in train}
    xj = jmx.nd.array(x)
    xj.attach_grad()
    with jmx.autograd.record():
        out = jblk(xj)
        loss = (out * jmx.nd.array(ct)).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in jblk.collect_params().items()
             if p.grad_req != "null"}
    return out.asnumpy(), xj.grad.asnumpy(), grads


def _run_port(tblk, x, ct):
    xt = torch.from_numpy(x).requires_grad_()
    with autograd.record():
        out = tblk(xt)
    (out * torch.from_numpy(ct)).sum().backward()
    grads = {k: p.grad for k, p in tblk.collect_params().items()
             if p.grad_req != "null"}
    return out, xt.grad, grads


def check_pair(make_j, make_t, x_shape, seed):
    """Build, weigh and run one layer in both packages; compare."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*x_shape).astype(np.float32)
    tblk = make_t()
    tblk.initialize(ctx=mx.cpu())
    with autograd.pause():
        probe = tblk(torch.from_numpy(x))
    ct = rs.randn(*probe.shape).astype(np.float32)
    shapes = {k: tuple(p.shape) for k, p in tblk.collect_params().items()}
    w = _weights(shapes, rs)
    jblk = make_j()
    assert sorted(jblk.collect_params()) == sorted(shapes)
    for k, p in jblk.collect_params().items():
        p.set_data(jmx.nd.array(w[k]))
    mx.convert.load_jax_params(tblk, w)
    want, want_gx, want_g = _run_jax(jblk, x, ct)
    got, got_gx, got_g = _run_port(tblk, x, ct)
    _close(got, want, "output")
    _close(got_gx, want_gx, "input gradient")
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        _close(got_g[k], want_g[k], "gradient of " + k)


def _concat(pkg, cls, axis):
    blk = getattr(pkg, cls)(axis=axis)
    blk.add(pkg.Dense(3, in_units=4), pkg.Dense(2, in_units=4))
    return blk


LAYERS = {
    # name: (JAX block, port block, input shape)
    "Identity": (lambda: jnn.Identity(), lambda: tnn.Identity(), (2, 3)),
    "Lambda_relu": (lambda: jnn.Lambda("relu"), lambda: tnn.Lambda("relu"),
                    (2, 5)),
    "HybridLambda_fn": (lambda: jnn.HybridLambda(lambda x: x * x + 1),
                        lambda: tnn.HybridLambda(lambda x: x * x + 1),
                        (3, 4)),
    "LeakyReLU": (lambda: jnn.LeakyReLU(0.1), lambda: tnn.LeakyReLU(0.1),
                  (2, 6)),
    "PReLU": (lambda: jnn.PReLU(), lambda: tnn.PReLU(), (2, 3, 4)),
    "PReLU_channels": (lambda: jnn.PReLU(in_channels=3),
                       lambda: tnn.PReLU(in_channels=3), (2, 3, 4)),
    "ELU": (lambda: jnn.ELU(0.7), lambda: tnn.ELU(0.7), (2, 6)),
    "SELU": (lambda: jnn.SELU(), lambda: tnn.SELU(), (2, 6)),
    "GELU_erf": (lambda: jnn.GELU(), lambda: tnn.GELU(), (2, 6)),
    "GELU_tanh": (lambda: jnn.GELU(approximation="tanh"),
                  lambda: tnn.GELU(approximation="tanh"), (2, 6)),
    "SiLU": (lambda: jnn.SiLU(), lambda: tnn.SiLU(), (2, 6)),
    "Swish_beta": (lambda: jnn.Swish(beta=1.7), lambda: tnn.Swish(beta=1.7),
                   (2, 6)),
    "Mish": (lambda: jnn.Mish(), lambda: tnn.Mish(), (2, 6)),
    "Concatenate": (lambda: _concat(jnn, "Concatenate", 1),
                    lambda: _concat(tnn, "Concatenate", 1), (2, 4)),
    "HybridConcatenate": (lambda: _concat(jnn, "HybridConcatenate", -1),
                          lambda: _concat(tnn, "HybridConcatenate", -1),
                          (2, 4)),
    "RMSNorm": (lambda: jnn.RMSNorm(), lambda: tnn.RMSNorm(), (2, 3, 8)),
    "GroupNorm": (lambda: jnn.GroupNorm(num_groups=2),
                  lambda: tnn.GroupNorm(num_groups=2), (2, 4, 3, 3)),
    "GroupNorm_frozen": (
        lambda: jnn.GroupNorm(num_groups=1, center=False, scale=False),
        lambda: tnn.GroupNorm(num_groups=1, center=False, scale=False),
        (2, 4, 5)),
    "InstanceNorm": (lambda: jnn.InstanceNorm(),
                     lambda: tnn.InstanceNorm(), (2, 3, 4, 4)),
    "SinusoidalPositionalEmbedding": (
        lambda: jnn.SinusoidalPositionalEmbedding(7),
        lambda: tnn.SinusoidalPositionalEmbedding(7), (2, 5, 7)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    make_j, make_t, shape = LAYERS[name]
    check_pair(make_j, make_t, shape, seed=len(name))


def test_swish_is_the_beta_class_not_silu():
    assert tnn.Swish is not tnn.SiLU and jnn.Swish is not jnn.SiLU
    x = torch.linspace(-3, 3, 7)
    torch.testing.assert_close(tnn.Swish(beta=2.0)(x),
                               x * torch.sigmoid(2.0 * x))
    assert not torch.allclose(tnn.Swish(beta=2.0)(x), tnn.SiLU()(x))


def test_gelu_defaults_to_erf_where_the_op_defaults_to_tanh():
    x = torch.linspace(-3, 3, 13)
    exact = 0.5 * x * (1 + torch.erf(x / np.sqrt(2.0)))
    torch.testing.assert_close(tnn.GELU()(x), exact)
    assert not torch.allclose(mx.ops.nn.gelu(x), exact, atol=1e-6)
    want = jnn.GELU()(jmx.nd.array(x.numpy())).asnumpy()
    _close(tnn.GELU()(x), want, "GELU()")


def test_prelu_is_not_deferred():
    for blk in (jnn.PReLU(), tnn.PReLU()):
        assert tuple(blk.alpha.shape) == (1,)
    t = tnn.PReLU()
    t.initialize(ctx=mx.cpu())
    assert t.alpha.tolist() == [0.25]


def test_norm_layers_defer_their_channels():
    t = tnn.GroupNorm(num_groups=2)
    assert tuple(t.gamma.shape) == (0,)
    t.initialize(ctx=mx.cpu())
    t(torch.ones(1, 6, 2))
    assert tuple(t.gamma.shape) == (6,) and t.gamma.tolist() == [1.0] * 6
    r = tnn.RMSNorm(in_channels=4)
    assert tuple(r.gamma.shape) == (4,)


# ---- Block and Parameter methods ------------------------------------------


def _mlp(pkg, deferred=False):
    return pkg.HybridSequential(
        pkg.Dense(3, in_units=0 if deferred else 4),
        pkg.BatchNorm(in_channels=3), pkg.Dense(2, in_units=3))


def test_summary_is_the_jax_table():
    for deferred in (False, True):
        assert _mlp(tnn, deferred).summary() == _mlp(jnn, deferred).summary()
    text = _mlp(tnn).summary().splitlines()
    assert text[0].split() == ["Layer", "Params"]
    assert text[-1] == "Total params: %d" % (12 + 3 + 4 * 3 + 6 + 2)


def test_params_property_and_setattr():
    t, j = _mlp(tnn), _mlp(jnn)
    assert list(t.params) == list(j.params) == list(t.collect_params())
    t.setattr("grad_req", "null")
    j.setattr("grad_req", "null")
    assert {p.grad_req for p in t.collect_params().values()} == {"null"}
    assert {p.grad_req for p in j.collect_params().values()} == {"null"}
    t.setattr("lr_mult", 0.5)
    assert {p.lr_mult for p in t.collect_params().values()} == {0.5}


def test_apply_visits_children_first():
    seen = {"t": [], "j": []}
    _mlp(tnn).apply(lambda b: seen["t"].append(type(b).__name__))
    _mlp(jnn).apply(lambda b: seen["j"].append(type(b).__name__))
    assert seen["t"] == seen["j"] == ["Dense", "BatchNorm", "Dense",
                                      "HybridSequential"]


def test_forward_hooks_take_the_jax_form():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 4).astype(np.float32)
    logs = {}
    for tag, pkg, arr in (("j", jnn, lambda a: jmx.nd.array(a)),
                          ("t", tnn, lambda a: mx.nd.array(a,
                                                           ctx=mx.cpu()))):
        net = pkg.Dense(3, in_units=4)
        net.initialize(ctx=mx.cpu()) if tag == "t" else net.initialize()
        log = logs[tag] = []
        pre = net.register_forward_pre_hook(
            lambda blk, args: log.append(("pre", type(blk).__name__,
                                          type(args[0]).__name__,
                                          len(args))))
        net.register_forward_hook(
            lambda blk, args, out: log.append(
                ("post", type(blk).__name__, type(out).__name__,
                 tuple(out.shape))))
        net(arr(x))
        pre.detach()
        net(arr(x))
    assert logs["t"] == logs["j"] == [
        ("pre", "Dense", "NDArray", 1), ("post", "Dense", "NDArray", (2, 3)),
        ("post", "Dense", "NDArray", (2, 3))]
    # on tensors the hooks see tensors; what a hook returns is ignored
    net = tnn.Dense(3, in_units=4)
    net.initialize(ctx=mx.cpu())
    seen = []
    handle = net.register_forward_hook(
        lambda blk, args, out: seen.append(type(out)) or torch.zeros(1))
    out = net(torch.from_numpy(x))
    assert seen == [torch.Tensor] and out.shape == (2, 3)
    handle.remove()
    net(torch.from_numpy(x))
    assert len(seen) == 1


def test_share_parameters_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 4).astype(np.float32)
    w = _weights({k: tuple(p.shape) for k, p in
                  _mlp(tnn).collect_params().items()}, rs)
    outs = {}
    for tag, pkg in (("j", jnn), ("t", tnn)):
        a, b = _mlp(pkg), _mlp(pkg)
        for net in (a, b):
            net.initialize(ctx=mx.cpu()) if tag == "t" else net.initialize()
        shared = {k: v for k, v in a.collect_params().items()
                  if k.startswith("0.")}
        assert b.share_parameters(shared) is b
        for k, p in a.collect_params().items():
            p.set_data(jmx.nd.array(w[k]) if tag == "j"
                       else torch.from_numpy(w[k]))
        assert b[0].weight is a[0].weight and b[0].bias is a[0].bias
        assert b[2].weight is not a[2].weight
        xin = jmx.nd.array(x) if tag == "j" else torch.from_numpy(x)
        outs[tag] = [(net[0](xin)).asnumpy() if tag == "j"
                     else net[0](xin).numpy() for net in (a, b)]
    for got, want in zip(outs["t"], outs["j"]):
        _close(got, want, "shared layer output")


def test_parameter_lists_and_reset_ctx():
    t, j = tnn.Dense(3, in_units=4), jnn.Dense(3, in_units=4)
    t.initialize(ctx=mx.cpu())
    j.initialize()
    tw, jw = t.weight, j.weight
    assert [str(c) for c in tw.list_ctx()] == [str(c) for c in jw.list_ctx()]
    assert len(tw.list_data()) == len(jw.list_data()) == 1
    assert torch.equal(tw.list_data()[0], tw.data)
    x = torch.ones(2, 4)
    with autograd.record():
        out = t(x)
    out.sum().backward()
    (g,) = tw.list_grad()
    assert torch.equal(g, tw.grad) and g.shape == (3, 4)
    frozen = (jmx.gluon.Parameter("c", grad_req="null", shape=(2,)),
              mx.gluon.Parameter("c", grad_req="null", shape=(2,)))
    frozen[0].initialize()
    frozen[1].initialize(ctx=mx.cpu())
    for p in frozen:
        with pytest.raises(Exception, match="grad_req='null'"):
            p.list_grad()
    before = tw.detach().clone()
    t.reset_ctx(mx.cpu())
    assert torch.equal(t.weight, before) and t.weight is tw
    assert t.infer_shape(x) is None and j.infer_shape(x) is None
