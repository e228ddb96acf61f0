"""The contrib long tail of the PyTorch port against the JAX package's, on
the CPU: AdamW, multi-LAMB/LANS, count_sketch, fft/ifft, index_copy/
index_add, sync_batch_norm (one device), hawkes_ll, deformable
convolution, GluonNLP's interleaved attention matmuls and div_sqrt_dim,
and the Gluon ``DeformableConvolution`` layers.

Each op runs in both packages on the same numpy inputs through ``mx.nd``;
results (and the state handles an update op writes) agree in shape,
dtype and value within ``RTOL``/``ATOL``, and the differentiable ops'
gradients agree too.  The interleaved route (``selfatt_qk`` -> softmax
-> ``selfatt_valatt``) is also held against the port's own
``multi_head_attention`` on the same projections, the check the card
repeats at BERT width.
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

RTOL, ATOL = 1e-5, 1e-5
RS = np.random.RandomState(9)


def f32(*shape, lo=-1.0, hi=1.0):
    return (RS.rand(*shape) * (hi - lo) + lo).astype(np.float32)


W, G, M, V = f32(4, 3), f32(4, 3), f32(4, 3), f32(4, 3, lo=0.1)
T_, B_, H_, D_ = 6, 2, 2, 4
QKV = f32(T_, B_, 3 * H_ * D_)
KV = f32(5, B_, 2 * H_ * D_)
Q = f32(T_, B_, H_ * D_)
ATT = np.abs(f32(B_ * H_, T_, T_))
ATT_ED = np.abs(f32(B_ * H_, T_, 5))
XD = f32(2, 4, 6, 6)
OFF = f32(2, 2 * 9 * 2, 6, 6, lo=-1.5, hi=1.5)
MASK = f32(2, 2 * 9, 6, 6, lo=0.0, hi=1.0)
WD = f32(5, 4, 3, 3)
BD = f32(5)
LAGS = f32(3, 5, lo=0.1, hi=1.0)
MARKS = RS.randint(0, 2, (3, 5)).astype(np.int32)

# name: (inputs, attrs, differentiable input positions)
CASES = {
    "adamw_update": ([W, G, M, V, np.float32([0.5])],
                     {"lr": 0.01, "eta": 0.7, "wd": 0.01}, []),
    "adamw_update_skip": ([W, G, M, V, np.float32([np.inf])],
                          {"lr": 0.01}, []),
    "mp_adamw_update": ([W.astype(np.float16), G.astype(np.float16), M, V,
                         np.float32([1.0]), W], {"lr": 0.01}, []),
    "multi_lamb_update": ([W, G, M, V, W[:2], G[:2], M[:2], V[:2]],
                          {"learning_rates": (0.01, 0.02),
                           "wds": (0.0, 0.01), "step_count": (1, 3),
                           "num_tensors": 2}, []),
    "multi_lans_update": ([W, G, M, V], {"learning_rates": (0.01,),
                                         "wds": (0.01,),
                                         "step_count": (2,),
                                         "num_tensors": 1}, []),
    "count_sketch": ([f32(3, 8), RS.randint(0, 5, 8).astype(np.float32),
                      np.sign(f32(8))], {"out_dim": 5}, [0]),
    "fft": ([f32(3, 8)], {}, [0]),
    "ifft": ([f32(3, 16)], {}, [0]),
    "index_copy": ([f32(5, 3), np.int32([4, 0]), f32(2, 3)], {}, [0, 2]),
    "index_add": ([f32(5, 3), np.int32([4, 0, 4]), f32(3, 3)], {}, [0, 2]),
    "sync_batch_norm": ([XD, f32(4), f32(4), f32(4), f32(4, lo=0.5)],
                        {"fix_gamma": False}, [0, 1, 2]),
    "hawkes_ll": ([f32(3, 2, lo=0.2), f32(2, lo=0.1, hi=0.5),
                   f32(2, lo=0.5), f32(3, 2, lo=0.0), LAGS, MARKS,
                   np.float32([5, 3, 4]), np.float32([6.0, 5.0, 7.0])],
                  {}, [0, 1, 2, 3]),
    "deformable_convolution": ([XD, OFF, WD, BD],
                               {"kernel": (3, 3), "pad": (1, 1),
                                "num_deformable_group": 2}, [0, 1, 2, 3]),
    "deformable_convolution_v2": ([XD, OFF, WD, BD],
                                  {"kernel": (3, 3), "pad": (1, 1),
                                   "num_deformable_group": 2,
                                   "mask": MASK}, [0, 1, 2, 3]),
    "interleaved_matmul_selfatt_qk": ([QKV], {"heads": H_}, [0]),
    "interleaved_matmul_selfatt_valatt": ([QKV, ATT], {"heads": H_},
                                          [0, 1]),
    "interleaved_matmul_encdec_qk": ([Q, KV], {"heads": H_}, [0, 1]),
    "interleaved_matmul_encdec_valatt": ([KV, ATT_ED], {"heads": H_},
                                         [0, 1]),
    "div_sqrt_dim": ([Q], {}, [0]),
}


def _name(key):
    for suffix in ("_skip", "_v2"):
        if key.endswith(suffix):
            return key[:-len(suffix)]
    return key


def _call(mx, key):
    inputs, attrs, _ = CASES[key]
    attrs = {k: mx.nd.array(v) if isinstance(v, np.ndarray) else v
             for k, v in attrs.items()}
    handles = [mx.nd.array(x) for x in inputs]
    op = mx.nd.__dict__[_name(key)]
    out = op(*handles, **attrs)
    outs = list(out) if isinstance(out, tuple) else [out]
    if op.mutates:
        muts = op.mutates(attrs) if callable(op.mutates) else op.mutates
        outs += [handles[p] for p in muts]
    return [o.asnumpy() for o in outs]


def _same(got, ref, key, rtol=RTOL, atol=ATOL):
    assert len(got) == len(ref), key
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, (
            key, g.shape, r.shape, g.dtype, r.dtype)
        tol = 1e-3 if r.dtype == np.float16 else rtol
        np.testing.assert_allclose(g.astype(np.float32), r.astype(np.float32),
                                   rtol=tol, atol=max(atol, tol * 0.1),
                                   err_msg=key)


def test_every_contrib_tail_op_has_a_case():
    from mxnet_tpu_torch.ops import registry

    own = {n for n in registry.list_ops()
           if registry.get_op(n).fn.__module__.endswith("contrib_tail")
           and registry.get_op(n).name == n}
    assert own == {_name(k) for k in CASES}


@pytest.mark.parametrize("key", sorted(CASES))
def test_contrib_op_matches_jax(key):
    ref = _call(mj, key)
    with mt.cpu():
        got = _call(mt, key)
    _same(got, ref, key, atol=1e-4 if "hawkes" in key or "deform" in key
          else ATOL)


def _grads(mx, key):
    inputs, attrs, diff = CASES[key]
    attrs = {k: mx.nd.array(v) if isinstance(v, np.ndarray) else v
             for k, v in attrs.items()}
    xs = [mx.nd.array(x) for x in inputs]
    for i in diff:
        xs[i].attach_grad()
    with mx.autograd.record():
        out = mx.nd.__dict__[_name(key)](*xs, **attrs)
        outs = list(out) if isinstance(out, tuple) else [out]
        rs = np.random.RandomState(4)
        loss = sum(mx.nd.sum(o * mx.nd.array(
            rs.rand(*o.shape).astype(np.float32))) for o in outs[:1])
    loss.backward()
    return [xs[i].grad.asnumpy() for i in diff]


@pytest.mark.parametrize("key", sorted(k for k in CASES if CASES[k][2]))
def test_contrib_gradients_match_jax(key):
    ref = _grads(mj, key)
    with mt.cpu():
        got = _grads(mt, key)
    _same(got, ref, key, rtol=1e-4, atol=1e-4)


def test_interleaved_route_is_multi_head_attention():
    """selfatt_qk -> softmax -> selfatt_valatt on the interleaved (T, B,
    3*H*D) projections equals multi_head_attention on q, k, v, forward
    and backward."""
    def route(qkv, interleaved):
        if interleaved:
            s = mt.nd.interleaved_matmul_selfatt_qk(qkv, heads=H_)
            return mt.nd.interleaved_matmul_selfatt_valatt(
                qkv, mt.nd.softmax(s, axis=-1), heads=H_)
        x = qkv.reshape((T_, B_, H_, 3, D_))
        q, k, v = (x[:, :, :, i, :].reshape((T_, B_, H_ * D_)).transpose(
            (1, 0, 2)) for i in range(3))
        o = mt.nd.multi_head_attention(q, k, v, num_heads=H_, impl="dense")
        return o.transpose((1, 0, 2))

    res = []
    with mt.cpu():
        for interleaved in (True, False):
            qkv = mt.nd.array(QKV)
            qkv.attach_grad()
            with mt.autograd.record():
                o = route(qkv, interleaved)
                loss = mt.nd.sum(o * mt.nd.array(np.cos(np.arange(
                    o.size, dtype=np.float32)).reshape(o.shape)))
            loss.backward()
            res.append((o.asnumpy(), qkv.grad.asnumpy()))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res[0][1], res[1][1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("modulated", [False, True])
def test_deformable_layers_match_jax(modulated):
    cls = ("ModulatedDeformableConvolution" if modulated
           else "DeformableConvolution")
    jnet = getattr(mj.gluon.nn, cls)(5, in_channels=4,
                                     num_deformable_group=2)
    jnet.initialize()
    tnet = getattr(mt.gluon.nn, cls)(5, in_channels=4,
                                     num_deformable_group=2)
    tnet.initialize(ctx=mt.cpu())
    rs = np.random.RandomState(1)
    params = {}
    for name, p in jnet.collect_params().items():
        params[name] = (rs.rand(*p.shape).astype(np.float32) - 0.5) * 0.3
        p.set_data(mj.nd.array(params[name]))
    mt.convert.load_jax_params(tnet, params)

    def run(mx, net):
        x = mx.nd.array(XD)
        x.attach_grad()
        with mx.autograd.record():
            y = net(x)
            loss = mx.nd.sum(y * y)
        loss.backward()
        grads = [net.collect_params()[n].grad for n in sorted(params)]
        return [y.asnumpy(), x.grad.asnumpy()] + [
            g().asnumpy() if callable(g) else g.numpy() for g in grads]

    ref = run(mj, jnet)
    with mt.cpu():
        got = run(mt, tnet)
    _same(got, ref, cls, rtol=1e-4, atol=1e-4)
