"""The 35 ``linalg_*`` ops of the PyTorch port against the JAX package's, on
the CPU, through ``mx.nd`` (and ``nd.linalg``'s short names).

Each op runs in both packages on the same numpy inputs (a batch of two
matrices where the op is batched).  Outputs agree in count, shape and
dtype, and in value within ``RTOL``/``ATOL`` (float32 on both sides), or
exactly for integer results.  Where the answer has more than one right
form (the signs of eigen-, singular and QR/LQ vectors, the order of a
nonsymmetric spectrum) the test holds what is fixed instead: the
reconstruction of the input, orthonormality, and the values up to sign
(``CHECKS``).  For every differentiable op the gradient of ``sum(w *
out)`` (an invariant for the sign-free decompositions) agrees with JAX's.
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

RTOL, ATOL = 1e-4, 1e-5
RS = np.random.RandomState(7)


def _m(*shape):
    return RS.rand(*shape).astype(np.float32) - 0.5


def _spd(b, n):
    a = RS.rand(b, n, n).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


A = _m(2, 4, 4)
B = _m(2, 4, 3)
C = _m(2, 4, 3)
W34 = _m(2, 3, 4)
SPD = _spd(2, 4)
L = np.linalg.cholesky(SPD).astype(np.float32)
GEN = (RS.rand(2, 4, 4) + 2 * np.eye(4)).astype(np.float32)
V = _m(2, 4)
TRI = _m(2, 10)
TINV = (RS.rand(24, 24) * 0.1 + 4 * np.eye(24)).reshape(4, 6, 8, 3).astype(
    np.float32)

# name: (inputs, attrs)
CASES = {
    "gemm": ((A, B, C), {"transpose_a": True, "alpha": 0.5, "beta": 2.0}),
    "gemm2": ((A, B), {"alpha": 1.5}),
    "potrf": ((SPD,), {}),
    "potri": ((L,), {}),
    "trmm": ((L, B), {"alpha": 2.0}),
    "trsm": ((L, B), {"transpose": True}),
    "syrk": ((W34,), {"alpha": 0.5}),
    "gelqf": ((W34,), {}),
    "syevd": ((SPD,), {}),
    "sumlogdiag": ((SPD,), {}),
    "extractdiag": ((A,), {"offset": 1}),
    "makediag": ((V,), {"offset": -1}),
    "extracttrian": ((A,), {}),
    "maketrian": ((TRI,), {}),
    "inverse": ((GEN,), {}),
    "det": ((GEN,), {}),
    "slogdet": ((GEN,), {}),
    "cholesky": ((SPD,), {"upper": True}),
    "qr": ((A,), {}),
    "svd": ((W34,), {}),
    "svdvals": ((W34,), {}),
    "eig": ((SPD[0],), {}),
    "eigh": ((SPD,), {}),
    "eigvals": ((SPD[0],), {}),
    "eigvalsh": ((SPD,), {}),
    "solve": ((GEN, B), {}),
    "lstsq": ((B[0], V[0]), {}),
    "pinv": ((W34,), {}),
    "matrix_rank": ((W34,), {}),
    "matrix_power": ((A,), {"n": 3}),
    "norm": ((A,), {"axis": (1, 2)}),
    "cond": ((GEN,), {}),
    "multi_dot": ((A[0], B[0], C[0].T), {}),
    "tensorinv": ((TINV,), {"ind": 2}),
    "tensorsolve": ((TINV, _m(4, 6)), {}),
}


def _abs(xs):
    return [np.abs(x) for x in xs]


def _qr_like(outs, a):
    q, r = outs
    np.testing.assert_allclose(q @ r, a, rtol=RTOL, atol=ATOL)
    return [np.abs(r)]


# checks for the ops whose answer has free signs or order: a function of
# the port's outputs (numpy) and the inputs that asserts what is fixed and
# returns values comparable with the same function of JAX's outputs
CHECKS = {
    "gelqf": lambda o, a: (np.testing.assert_allclose(
        o[0] @ o[1], a[0], rtol=RTOL, atol=ATOL), _abs(o))[1],
    "syevd": lambda o, a: (np.testing.assert_allclose(
        np.swapaxes(o[0], -1, -2) @ (o[1][..., None] * o[0]), a[0],
        rtol=RTOL, atol=1e-4), [o[1], np.abs(o[0])])[1],
    "qr": lambda o, a: _qr_like(o, a[0]),
    "svd": lambda o, a: (np.testing.assert_allclose(
        (o[0] * o[1][..., None, :]) @ o[2], a[0], rtol=RTOL, atol=ATOL),
        [o[1], np.abs(o[0]), np.abs(o[2])])[1],
    "eigh": lambda o, a: (np.testing.assert_allclose(
        o[1] @ (o[0][..., None] * np.swapaxes(o[1], -1, -2)), a[0],
        rtol=RTOL, atol=1e-4), [o[0], np.abs(o[1])])[1],
    "eig": lambda o, a: (np.testing.assert_allclose(
        a[0] @ o[1], o[1] * o[0][None, :], rtol=RTOL, atol=1e-4),
        [np.sort(o[0].real)])[1],
    "eigvals": lambda o, a: [np.sort(o[0].real)],
}

DIFFERENTIABLE = sorted(n for n in CASES
                        if mt.nd.linalg.__dict__[n].differentiable)
# gradients of an invariant where the outputs carry free signs
GRAD_OUTPUTS = {"gelqf": None, "qr": None, "svd": [1], "eigh": [0],
                "syevd": [1]}


def _run(mx, name, inputs, attrs):
    outs = getattr(mx.nd.linalg, name)(*[mx.nd.array(x) for x in inputs],
                                       **attrs)
    return [o.asnumpy() for o in (outs if isinstance(outs, tuple)
                                  else (outs,))]


def _compare(got, ref, name):
    assert len(got) == len(ref), name
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, (
            name, g.shape, r.shape, g.dtype, r.dtype)
        if r.dtype.kind in "fc":
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


def test_the_table_holds_every_linalg_op():
    ops = {n[len("linalg_"):] for n in mt.ops.list_ops()
           if n.startswith("linalg_")}
    assert ops == set(CASES) == set(mt.nd.linalg.__all__)
    assert len(ops) == 35


@pytest.mark.parametrize("name", sorted(CASES))
def test_linalg_op_matches_jax(name):
    inputs, attrs = CASES[name]
    ref = _run(mj, name, inputs, attrs)
    with mt.cpu():
        got = _run(mt, name, inputs, attrs)
    assert [(g.shape, g.dtype) for g in got] == [(r.shape, r.dtype)
                                                for r in ref], name
    if name in CHECKS:
        got, ref = CHECKS[name](got, inputs), CHECKS[name](ref, inputs)
    _compare(got, ref, name)


def _grads(mx, name, inputs, attrs, weights):
    xs = [mx.nd.array(x) for x in inputs]
    for x in xs:
        x.attach_grad()
    with mx.autograd.record():
        outs = getattr(mx.nd.linalg, name)(*xs, **attrs)
        outs = list(outs) if isinstance(outs, tuple) else [outs]
        keep = GRAD_OUTPUTS.get(name, range(len(outs)))
        if keep is None:        # QR/LQ: |R| and |L| diagonals' squares
            d = mx.nd.linalg.extractdiag(outs[0] if name == "gelqf"
                                         else outs[1])
            loss = mx.nd.sum(d * d)
        else:
            loss = sum(mx.nd.sum(outs[i] * mx.nd.array(weights[i]))
                       for i in keep)
    loss.backward()
    return [x.grad.asnumpy() for x in xs]


@pytest.mark.parametrize("name", DIFFERENTIABLE)
def test_linalg_gradient_matches_jax(name):
    inputs, attrs = CASES[name]
    outs = _run(mj, name, inputs, attrs)
    rs = np.random.RandomState(3)
    weights = [rs.rand(*o.shape).astype(np.float32) for o in outs]
    ref = _grads(mj, name, inputs, attrs, weights)
    with mt.cpu():
        got = _grads(mt, name, inputs, attrs, weights)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4, err_msg=name)


# ---- mx.np.linalg: the decompositions through the port's ops --------------

NSYM = RS.rand(4, 4).astype(np.float32)
RANK2 = (RS.rand(4, 2) @ RS.rand(2, 5)).astype(np.float32)
NP_LINALG = [
    ("eigvalsh", (SPD,), {}), ("eigvalsh", (NSYM,), {}),
    ("eigvalsh", (NSYM,), {"UPLO": "U", "symmetrize_input": False}),
    ("svdvals", (RANK2,), {}), ("svd", (NSYM,), {"compute_uv": False}),
    ("pinv", (RANK2,), {}), ("pinv", (NSYM,), {"rtol": 0.1}),
    ("matrix_rank", (RANK2,), {}), ("matrix_rank", (SPD,), {"rtol": 5.0}),
    ("matrix_rank", (np.float32([0.0, 2.0]),), {}),
    ("cond", (SPD,), {}), ("cond", (NSYM,), {"p": "fro"}),
    ("norm", (NSYM,), {}), ("norm", (NSYM,), {"ord": 2}),
    ("norm", (RANK2,), {"ord": "nuc"}),
    ("norm", (RANK2,), {"ord": 1, "axis": 1, "keepdims": True}),
]


def _np_linalg(mx, name, args, kwargs):
    return getattr(mx.np.linalg, name)(
        *[mx.np.array(a) if isinstance(a, np.ndarray) else a for a in args],
        **kwargs)


@pytest.mark.parametrize("name,args,kwargs", NP_LINALG,
                         ids=["%s_%d" % (c[0], i) for i, c in
                              enumerate(NP_LINALG)])
def test_np_linalg_matches_jax(name, args, kwargs):
    ref = _np_linalg(mj, name, args, kwargs)
    with mt.cpu():
        got = _np_linalg(mt, name, args, kwargs)
    assert got.dtype == ref.dtype and got.shape == ref.shape, name
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=1e-4,
                               atol=1e-5, err_msg=name)


@pytest.mark.parametrize("full_matrices", [True, False])
@pytest.mark.parametrize("a", [NSYM, RANK2], ids=["square", "wide"])
def test_np_linalg_svd_matches_jax(a, full_matrices):
    """Singular vectors carry a sign each: held by the values, the
    reconstruction and the shapes."""
    ref = mj.np.linalg.svd(mj.np.array(a), full_matrices=full_matrices)
    with mt.cpu():
        got = mt.np.linalg.svd(mt.np.array(a), full_matrices=full_matrices)
    u, s, vh = (x.asnumpy() for x in got)
    assert [x.shape for x in (u, s, vh)] == [x.shape for x in ref]
    np.testing.assert_allclose(s, ref[1].asnumpy(), rtol=1e-5, atol=1e-6)
    k = s.shape[-1]
    np.testing.assert_allclose((u[:, :k] * s) @ vh[:k], a, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("a", [SPD, NSYM], ids=["symmetric", "not"])
def test_np_linalg_eigh_symmetrizes_as_jax_does(a):
    ref = mj.np.linalg.eigh(mj.np.array(a))
    with mt.cpu():
        w, v = (x.asnumpy() for x in mt.np.linalg.eigh(mt.np.array(a)))
    np.testing.assert_allclose(w, ref[0].asnumpy(), rtol=1e-5, atol=1e-5)
    sym = (a + a.swapaxes(-1, -2)) / 2
    np.testing.assert_allclose((v * w[..., None, :]) @ v.swapaxes(-1, -2),
                               sym, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,kwargs", [
    ("svd", {"hermitian": True}), ("pinv", {"hermitian": True}),
    ("pinv", {"rtol": 0.1, "rcond": 0.1}),
    ("matrix_rank", {"rtol": 0.1, "tol": 0.1})])
def test_np_linalg_refuses_what_it_does_not_take(name, kwargs):
    with mt.cpu(), pytest.raises((NotImplementedError, ValueError)):
        getattr(mt.np.linalg, name)(mt.np.array(NSYM), **kwargs)
