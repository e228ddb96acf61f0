"""The port's ResNet ops (``mxnet_tpu_torch.ops.nn``: convolution,
deconvolution, pooling, adaptive average pooling, batch norm, softmax and
softmax cross-entropy) against the JAX package's, on the CPU.

Each case feeds the same numpy inputs to both sides and compares the
outputs and the gradients of ``sum(out * ct)`` for a random cotangent
``ct`` (``jax.vjp`` under ``jax.jit`` on the JAX side, ``backward`` on the
port's): within 1e-5 x max(1, max|ref|) in f32 and 2e-2 x max(1, max|ref|)
where an input is bf16.  ``batch_norm`` cases also compare the returned
running statistics (the biased batch variance, kept at weight 0.9).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import nn as tnn

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _check(jfn, tfn, arrays, dtypes=None, n_out=1, grads=None, jit=True):
    """Run ``jfn``/``tfn`` on ``arrays`` (numpy f32; ``dtypes`` casts some
    to bf16 on both sides) and compare outputs and the gradients of the
    inputs named by ``grads`` (default all).  ``jit=False`` runs the JAX
    side eagerly (an op whose windows are not static under ``jit``)."""
    dtypes = dtypes or ["float32"] * len(arrays)
    tol = TOL["bfloat16" if "bfloat16" in dtypes else "float32"]
    grads = range(len(arrays)) if grads is None else grads
    jx = [jnp.asarray(a).astype(d) for a, d in zip(arrays, dtypes)]
    tx = [torch.from_numpy(a).to(getattr(torch, d)).requires_grad_(i in grads)
          for i, (a, d) in enumerate(zip(arrays, dtypes))]
    touts = tfn(*tx)
    touts = touts if isinstance(touts, tuple) else (touts,)
    rs = np.random.RandomState(7)
    cts = [np.asarray(rs.randn(*o.shape), np.float32) for o in touts[:1]]

    def vjp(*a):
        out, pull = jax.vjp(lambda *b: jfn(*b), *a)
        outs = out if isinstance(out, tuple) else (out,)
        ct = (jnp.asarray(cts[0]).astype(outs[0].dtype),) + tuple(
            jnp.zeros_like(o) for o in outs[1:])
        return outs, pull(ct if isinstance(out, tuple) else ct[0])

    jouts, jgrads = (jax.jit(vjp) if jit else vjp)(*jx)
    assert len(jouts) == len(touts) == n_out
    for i, (t, j) in enumerate(zip(touts, jouts)):
        assert t.dtype == getattr(torch, str(j.dtype)), (i, t.dtype, j.dtype)
        _close(t, j, tol, "output %d" % i)
    (touts[0].float() * torch.from_numpy(cts[0])).sum().backward()
    for i in grads:
        want = np.asarray(jgrads[i], np.float32)
        got = tx[i].grad if tx[i].grad is not None \
            else torch.zeros_like(tx[i])
        _close(got, want, tol, "grad of input %d" % i)


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


# (x shape, weight shape, attrs, with bias, x dtype)
CONV = {
    "2d": ((2, 4, 9, 9), (6, 4, 3, 3), dict(pad=(1, 1)), True, "float32"),
    "2d_stride2_nopad": ((2, 4, 9, 9), (6, 4, 3, 3), dict(stride=(2, 2)),
                         False, "float32"),
    "2d_dilate2": ((2, 4, 11, 11), (6, 4, 3, 3),
                   dict(dilate=(2, 2), pad=(2, 2)), True, "float32"),
    "2d_groups2": ((2, 4, 8, 8), (6, 2, 3, 3),
                   dict(pad=(1, 1), num_group=2), True, "float32"),
    "2d_nhwc": ((2, 8, 8, 4), (6, 4, 3, 3),
                dict(pad=(1, 1), layout="NHWC"), True, "float32"),
    "1d": ((2, 4, 16), (6, 4, 3), dict(stride=(2,), pad=(1,)), True,
           "float32"),
    "3d": ((1, 2, 5, 6, 6), (3, 2, 3, 3, 3), dict(pad=(1, 1, 1)), True,
           "float32"),
    "2d_bf16_x_f32_w": ((2, 4, 9, 9), (6, 4, 3, 3),
                        dict(stride=(2, 2), pad=(1, 1)), True, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CONV))
def test_convolution_matches_jax(case):
    xs, ws, attrs, bias, xdt = CONV[case]
    rs = np.random.RandomState(len(case))
    arrays = [_rand(rs, *xs), _rand(rs, *ws) * 0.3]
    dtypes = [xdt, "float32"]
    if bias:
        arrays.append(_rand(rs, ws[0]))
        dtypes.append("float32")
    kw = dict(attrs, kernel=ws[2:], num_filter=ws[0], no_bias=not bias)
    _check(functools.partial(jnn.convolution.fn, **kw),
           functools.partial(tnn.convolution, **kw), arrays, dtypes)


# (x shape, weight shape (in, out, *k), attrs)
DECONV = {
    "2d_stride2_pad1": ((2, 4, 5, 5), (4, 3, 3, 3),
                        dict(stride=(2, 2), pad=(1, 1))),
    "2d_nopad": ((2, 4, 5, 5), (4, 3, 3, 3), {}),
    "2d_dilate2": ((1, 4, 6, 6), (4, 3, 3, 3),
                   dict(dilate=(2, 2), pad=(1, 1))),
    "2d_pad_past_kernel": ((1, 4, 5, 5), (4, 3, 2, 2),
                           dict(stride=(2, 2), pad=(2, 2))),
    "1d": ((2, 4, 7), (4, 3, 4), dict(stride=(2,), pad=(1,))),
    "3d": ((1, 2, 3, 4, 4), (2, 3, 3, 3, 3), dict(stride=(1, 2, 2),
                                                   pad=(1, 1, 1))),
}


@pytest.mark.parametrize("case", sorted(DECONV))
def test_deconvolution_matches_jax(case):
    xs, ws, attrs = DECONV[case]
    rs = np.random.RandomState(len(case) + 1)
    arrays = [_rand(rs, *xs), _rand(rs, *ws) * 0.3, _rand(rs, ws[1])]
    kw = dict(attrs, kernel=ws[2:], num_filter=ws[1])
    _check(functools.partial(jnn.deconvolution.fn, **kw),
           functools.partial(tnn.deconvolution, **kw), arrays)


def test_deconvolution_refuses_groups():
    x = torch.zeros(1, 4, 5, 5)
    with pytest.raises(MXNetError, match="num_group"):
        tnn.deconvolution(x, torch.zeros(4, 2, 3, 3), num_group=2)


# (x shape, attrs)
POOL = {
    "max_2d_k3s2p1": ((2, 3, 9, 9), dict(kernel=(3, 3), stride=(2, 2),
                                          pad=(1, 1))),
    "max_1d": ((2, 3, 10), dict(kernel=(2,), stride=(2,))),
    "max_3d": ((1, 2, 5, 6, 6), dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                                     pad=(1, 1, 1))),
    "max_pad_past_half": ((2, 3, 7, 7), dict(kernel=(3, 3), pad=(2, 2))),
    "max_nhwc": ((2, 9, 9, 3), dict(kernel=(3, 3), stride=(2, 2),
                                    pad=(1, 1), layout="NHWC")),
    "avg_incl_pad": ((2, 3, 9, 9), dict(pool_type="avg", kernel=(3, 3),
                                        stride=(2, 2), pad=(1, 1))),
    "avg_excl_pad": ((2, 3, 9, 9), dict(pool_type="avg", kernel=(3, 3),
                                        stride=(2, 2), pad=(1, 1),
                                        count_include_pad=False)),
    "avg_incl_pad_past_half": ((2, 3, 7, 7), dict(
        pool_type="avg", kernel=(3, 3), pad=(2, 2))),
    "avg_excl_pad_past_half": ((2, 3, 7, 7), dict(
        pool_type="avg", kernel=(3, 3), pad=(2, 2),
        count_include_pad=False)),
    "avg_1d": ((2, 3, 10), dict(pool_type="avg", kernel=(3,), pad=(1,))),
    "avg_3d_excl_pad": ((1, 2, 5, 6, 6), dict(
        pool_type="avg", kernel=(3, 3, 3), stride=(2, 2, 2), pad=(1, 1, 1),
        count_include_pad=False)),
    "sum_2d": ((2, 3, 8, 8), dict(pool_type="sum", kernel=(2, 2),
                                  pad=(1, 1))),
    "sum_1d": ((2, 3, 10), dict(pool_type="sum", kernel=(3,),
                                stride=(2,))),
    "lp_2d": ((2, 3, 8, 8), dict(pool_type="lp", kernel=(2, 2),
                                 stride=(2, 2))),
    "lp_pad_past_half": ((2, 3, 6, 6), dict(pool_type="lp", kernel=(2, 2),
                                            pad=(2, 2))),
    "global_max": ((2, 3, 7, 7), dict(global_pool=True)),
    "global_avg": ((2, 3, 7, 7), dict(pool_type="avg", global_pool=True)),
    "global_sum_is_mean": ((2, 3, 7, 7), dict(pool_type="sum",
                                              global_pool=True)),
    "global_avg_3d": ((1, 2, 3, 4, 5), dict(pool_type="avg",
                                            global_pool=True)),
}


@pytest.mark.parametrize("case", sorted(POOL))
def test_pooling_matches_jax(case):
    xs, attrs = POOL[case]
    rs = np.random.RandomState(len(case) + 2)
    _check(functools.partial(jnn.pooling.fn, **attrs),
           functools.partial(tnn.pooling, **attrs), [_rand(rs, *xs)])


@pytest.mark.parametrize("xs,size", [((2, 3, 8, 8), 1), ((2, 3, 8, 8), 2),
                                     ((2, 3, 7, 7), 3),
                                     ((1, 2, 6, 7), (2, 3)),
                                     ((1, 2, 5, 9), (3, 4))],
                         ids=["1", "2", "3_uneven", "2x3_uneven",
                              "3x4_uneven"])
def test_adaptive_avg_pooling_matches_jax(xs, size):
    rs = np.random.RandomState(3)
    _check(functools.partial(jnn.adaptive_avg_pooling.fn, output_size=size),
           functools.partial(tnn.adaptive_avg_pooling, output_size=size),
           [_rand(rs, *xs)], jit=False)


# (x shape, x dtype, attrs)
BN = {
    "train": ((4, 3, 5, 5), "float32", dict(training=True)),
    "infer": ((4, 3, 5, 5), "float32", dict(training=False)),
    "train_fix_gamma": ((4, 3, 5, 5), "float32",
                        dict(training=True, fix_gamma=True)),
    "train_global_stats": ((4, 3, 5, 5), "float32",
                           dict(training=True, use_global_stats=True)),
    "train_momentum_eps": ((4, 3, 5, 5), "float32",
                           dict(training=True, momentum=0.5, eps=1e-3)),
    "train_2d": ((8, 6), "float32", dict(training=True)),
    "train_axis_last": ((2, 5, 4), "float32", dict(training=True, axis=2)),
    "train_bf16_x": ((4, 3, 5, 5), "bfloat16", dict(training=True)),
    "infer_bf16_x": ((4, 3, 5, 5), "bfloat16", dict(training=False)),
}


@pytest.mark.parametrize("case", sorted(BN))
def test_batch_norm_matches_jax(case):
    xs, xdt, attrs = BN[case]
    c = xs[attrs.get("axis", 1)]
    rs = np.random.RandomState(len(case) + 4)
    x = _rand(rs, *xs) * 2.0 + 0.5
    gamma = 1.0 + 0.3 * _rand(rs, c)
    beta = 0.3 * _rand(rs, c)
    mean = 0.2 * _rand(rs, c)
    var = 0.5 + rs.rand(c).astype(np.float32)
    _check(functools.partial(jnn.batch_norm.fn, **attrs),
           functools.partial(tnn.batch_norm, **attrs),
           [x, gamma, beta, mean, var], [xdt] + ["float32"] * 4, n_out=3,
           grads=(0, 1, 2))


@pytest.mark.parametrize("case", ["plain", "temperature", "length"])
def test_softmax_matches_jax(case):
    rs = np.random.RandomState(5)
    x = _rand(rs, 3, 4, 6)
    if case == "length":
        length = np.array([[1, 6, 3, 4]] * 3, np.int32)
        jfn = lambda a: jnn.softmax.fn(a, length=jnp.asarray(length))  # noqa
        tfn = lambda a: tnn.softmax(a, length=torch.from_numpy(length))  # noqa
    else:
        kw = {"temperature": 2.0} if case == "temperature" else {}
        jfn = functools.partial(jnn.softmax.fn, **kw)
        tfn = functools.partial(tnn.softmax, **kw)
    _check(jfn, tfn, [x])


def test_softmax_cross_entropy_matches_jax():
    rs = np.random.RandomState(6)
    logits = _rand(rs, 5, 7)
    labels = rs.randint(0, 7, 5).astype(np.int32)
    _check(lambda a: jnn.softmax_cross_entropy.fn(a, jnp.asarray(labels)),
           lambda a: tnn.softmax_cross_entropy(a, torch.from_numpy(labels)),
           [logits])
