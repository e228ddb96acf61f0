"""The optimizer update ops of the PyTorch port against the JAX package's,
on the CPU, called as users call them: ``nd.<op>(weight, grad, *state,
out=weight, **hyper)``.

Each op runs once in both packages on the same numpy weights, gradients
and states (float32; float16 weights with float32 masters for the
``mp_*`` forms).  After the call the ``out=`` handle and every state
handle the op updates (``mutates``) hold the new values: the port's agree
with JAX's in shape, dtype and value within ``RTOL``/``ATOL``, and the
returned array is the ``out=`` handle itself.  ``all_finite`` stays on
the device: the port's answer is a tensor, read back only by the test.
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

RTOL, ATOL = 1e-5, 1e-6
RS = np.random.RandomState(11)
SHAPE = (3, 5)


def f32(lo=-1.0, hi=1.0):
    return (RS.rand(*SHAPE) * (hi - lo) + lo).astype(np.float32)


W, G = f32(), f32()
M, V = f32(), f32(0.1, 1.0)
D, Z = f32(0.1, 1.0), f32()
W16 = W.astype(np.float16)

# name: (arrays, hyper-parameters); arrays[0] is the weight (out=)
CASES = {
    "sgd_update": ([W, G], {"lr": 0.1, "wd": 0.01, "clip_gradient": 0.5}),
    "sgd_mom_update": ([W, G, M], {"lr": 0.1, "momentum": 0.9,
                                   "wd": 0.01}),
    "mp_sgd_update": ([W16, G.astype(np.float16), W], {"lr": 0.1,
                                                        "wd": 0.01}),
    "mp_sgd_mom_update": ([W16, G.astype(np.float16), M, W],
                          {"lr": 0.1, "momentum": 0.9}),
    "nag_mom_update": ([W, G, M], {"lr": 0.1, "momentum": 0.9,
                                   "wd": 0.01}),
    "mp_nag_mom_update": ([W16, G.astype(np.float16), M, W],
                          {"lr": 0.1, "momentum": 0.9}),
    "adam_update": ([W, G, M, V], {"lr": 0.01, "wd": 0.01,
                                   "rescale_grad": 0.5}),
    "ftml_update": ([W, G, D, V, Z], {"lr": 0.01, "t": 3}),
    "rmsprop_update": ([W, G, V], {"lr": 0.01, "clip_weights": 0.8}),
    "rmspropalex_update": ([W, G, V, M * 0.1, Z], {"lr": 0.01}),
    "ftrl_update": ([W, G, Z, V], {"lr": 0.1, "wd": 0.01}),
    "signsgd_update": ([W, G], {"lr": 0.1, "wd": 0.01}),
    "signum_update": ([W, G, M], {"lr": 0.1, "momentum": 0.9,
                                  "wd_lh": 0.01}),
    "lamb_update_phase1": ([W, G, M, V], {"t": 2, "wd": 0.01}),
    "lamb_update_phase2": ([W, G, np.float32([1.5]), np.float32([0.7])],
                           {"lr": 0.01, "lower_bound": 0.1}),
    "mp_lamb_update_phase1": ([W16, G.astype(np.float16), M, V, W],
                              {"t": 2}),
    "mp_lamb_update_phase2": ([W16, G, np.float32([1.5]),
                               np.float32([0.7]), W], {"lr": 0.01}),
    "multi_sgd_update": ([W, G, M, V], {"lrs": (0.1, 0.2),
                                        "wds": (0.0, 0.01),
                                        "num_weights": 2}),
    "multi_sgd_mom_update": ([W, G, M, V, Z, D],
                             {"lrs": (0.1, 0.2), "wds": (0.0, 0.01),
                              "momentum": 0.9, "num_weights": 2}),
    "multi_mp_sgd_update": ([W16, G, W, W16, G, W],
                            {"lrs": (0.1, 0.2), "wds": (0.0, 0.01),
                             "num_weights": 2}),
    "multi_mp_sgd_mom_update": ([W16, G, M, W], {"lrs": (0.1,),
                                                 "wds": (0.01,),
                                                 "momentum": 0.9,
                                                 "num_weights": 1}),
    "preloaded_multi_sgd_update": ([W, G, np.float32([0.1]),
                                    np.float32([0.01])],
                                   {"num_weights": 1}),
    "preloaded_multi_sgd_mom_update": ([W, G, M, np.float32([0.1]),
                                        np.float32([0.01])],
                                       {"momentum": 0.9,
                                        "num_weights": 1}),
    "preloaded_multi_mp_sgd_update": ([W16, G, W, np.float32([0.1]),
                                       np.float32([0.01])],
                                      {"num_weights": 1}),
    "preloaded_multi_mp_sgd_mom_update": ([W16, G, M, W,
                                           np.float32([0.1]),
                                           np.float32([0.01])],
                                          {"momentum": 0.9,
                                           "num_weights": 1}),
}
# ops whose outputs are not written through out= (reductions, casts)
PLAIN = {
    "multi_sum_sq": ([W, G, M], {"num_arrays": 3}),
    "multi_lars": ([np.float32([0.1, 0.2]), np.float32([4.0, 0.0]),
                    np.float32([1.0, 2.0]), np.float32([0.01, 0.0])],
                   {"eta": 0.01, "rescale_grad": 0.5}),
    "all_finite": ([W], {}),
    "multi_all_finite": ([W, G], {"num_arrays": 2}),
    "amp_cast": ([W], {"dtype": "float16"}),
    "amp_multicast": ([W, W16], {"num_outputs": 2}),
}


def _call(mx, name, arrays, hyper):
    op = mx.nd.__dict__[name]
    handles = [mx.nd.array(a) for a in arrays]
    n_out = op.num_outputs(hyper) if callable(op.num_outputs) \
        else op.num_outputs
    mutates = op.mutates(hyper) if callable(op.mutates) else \
        (op.mutates or ())
    if n_out == 1:
        out = [handles[0]]
    else:
        stride = len(arrays) // n_out
        out = [handles[i * stride] for i in range(n_out)]
    ret = op(*handles, out=out[0] if n_out == 1 else out, **hyper)
    rets = list(ret) if isinstance(ret, tuple) else [ret]
    assert all(r is o for r, o in zip(rets, out)), name
    return [h.asnumpy() for h in out] + [handles[p].asnumpy()
                                         for p in mutates]


def _same(got, ref, name):
    assert len(got) == len(ref), name
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, (
            name, g.shape, r.shape, g.dtype, r.dtype)
        tol = 1e-3 if r.dtype == np.float16 else RTOL
        np.testing.assert_allclose(g.astype(np.float32),
                                   r.astype(np.float32), rtol=tol,
                                   atol=ATOL if tol == RTOL else 1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_update_op_writes_what_jax_writes(name):
    arrays, hyper = CASES[name]
    ref = _call(mj, name, arrays, hyper)
    with mt.cpu():
        got = _call(mt, name, arrays, hyper)
    _same(got, ref, name)


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_helper_op_matches_jax(name):
    arrays, hyper = PLAIN[name]
    ref = mj.nd.__dict__[name](*[mj.nd.array(a) for a in arrays], **hyper)
    with mt.cpu():
        got = mt.nd.__dict__[name](*[mt.nd.array(a) for a in arrays],
                                   **hyper)
    ref = [r.asnumpy() for r in (ref if isinstance(ref, tuple) else [ref])]
    got = [g.asnumpy() for g in (got if isinstance(got, tuple) else [got])]
    _same(got, ref, name)


def test_all_finite_stays_on_the_device():
    bad = W.copy()
    bad[1, 2] = np.inf
    with mt.cpu():
        out = mt.nd.all_finite(mt.nd.array(bad))
        multi = mt.nd.multi_all_finite(mt.nd.array(W), mt.nd.array(bad),
                                       num_arrays=2)
    assert out._data.shape == (1,) and out._data.dtype.is_floating_point
    assert float(out.asnumpy()[0]) == 0.0 and float(multi.asnumpy()[0]) == 0
    with mt.cpu():
        ok = mt.nd.all_finite(mt.nd.array(W))
    assert float(ok.asnumpy()[0]) == 1.0


def test_reset_arrays_zeroes_every_input():
    with mt.cpu():
        a, b = mt.nd.array(W), mt.nd.array(G)
        mt.nd.reset_arrays(a, b, num_arrays=2)
    assert not a.asnumpy().any() and not b.asnumpy().any()


def test_adam_update_is_the_optimizer_step():
    """nd.adam_update with the bias correction folded into lr is one step
    of the port's optimizer.Adam."""
    import torch

    lr, b1, b2, eps, t = 0.01, 0.9, 0.999, 1e-8, 1
    with mt.cpu():
        w, m, v = mt.nd.array(W), mt.nd.zeros(SHAPE), mt.nd.zeros(SHAPE)
        lr_t = lr * np.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        mt.nd.adam_update(w, mt.nd.array(G), m, v, lr=lr_t, beta1=b1,
                          beta2=b2, epsilon=eps, out=w)
    p = torch.nn.Parameter(torch.from_numpy(W.copy()))
    opt = mt.optimizer.Adam(learning_rate=lr, beta1=b1, beta2=b2,
                            epsilon=eps)
    state = opt.create_state(0, p.data)
    opt.update(0, p.data, torch.from_numpy(G), state)
    np.testing.assert_allclose(w.asnumpy(), p.data.numpy(), rtol=1e-5,
                               atol=1e-6)
