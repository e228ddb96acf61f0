"""``mx.np`` of the PyTorch port against the JAX package's ``mx.np``, on
the CPU.

The cases are the tables of ``tests/python/unittest/test_numpy_op.py``
(``np_cases.py`` holds a copy, held equal to them below, so both suites
hold the same ones; ``test_torch_np_tail.py`` runs that module's other
tables): every case
runs through both packages on the same numpy inputs, and the results
agree in count, shape and dtype (the JAX package's x32 types), exactly
for integer and boolean results and within ``RTOL``/``ATOL`` for floating
ones (both sides compute in float32, where ``torch._numpy`` may round
through float64 first).  The gradients of its ``GRAD_CASES`` are held
against JAX's autograd, the NEP-18/NEP-13 protocols and the tape against
the same calls in JAX, and every name of its ``_REFERENCE_NP_SURFACE``
must resolve on the device (``'torch'``), none through host numpy.
"""
import logging

import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
import np_cases as T
from np_cases import CASES

RTOL, ATOL = 1e-5, 1e-6
IDS = ["%s_%d" % (c[0], i) for i, c in enumerate(CASES)]


def to_nd(mx, v, **kw):
    if isinstance(v, onp.ndarray):
        return mx.np.array(v, dtype=v.dtype, **kw)
    if isinstance(v, list):
        return [to_nd(mx, x, **kw) for x in v]
    if isinstance(v, tuple):
        return tuple(to_nd(mx, x, **kw) for x in v)
    return v


def flat(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in flat(v)]
    return [x]


def host(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def assert_same(got, ref, name, rtol=RTOL, atol=ATOL):
    got, ref = flat(got), flat(ref)
    assert len(got) == len(ref), name
    for g, r in zip(got, ref):
        g, r = host(g), host(r)
        assert g.shape == r.shape, (name, g.shape, r.shape)
        assert g.dtype == r.dtype, (name, g.dtype, r.dtype)
        if r.dtype.kind in "fc":
            onp.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                        err_msg=name)
        else:
            onp.testing.assert_array_equal(g, r, err_msg=name)


def run_case(name, args, kwargs, **ctx_kw):
    """(port result, JAX result) of one table case; ``ctx_kw`` places
    the port's inputs (the CPU by default)."""
    ref = getattr(mj.np, name)(*to_nd(mj, args), **kwargs)
    with mt.cpu():
        got = getattr(mt.np, name)(*to_nd(mt, args, **ctx_kw), **kwargs)
    return got, ref


@pytest.mark.parametrize("name,args,kwargs", CASES, ids=IDS)
def test_np_case_matches_jax(name, args, kwargs):
    got, ref = run_case(name, args, kwargs)
    assert_same(got, ref, name)


def _same_data(a, b):
    if isinstance(a, onp.ndarray) or isinstance(b, onp.ndarray):
        return (isinstance(a, onp.ndarray) and isinstance(b, onp.ndarray)
                and a.dtype == b.dtype and onp.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(map(_same_data, a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_data(a[k], b[k])
                                            for k in a)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("ours,theirs", [
    ("CASES", "ALL_CASES"), ("GRAD_CASES", "GRAD_CASES"),
    ("REFERENCE_NP_SURFACE", "_REFERENCE_NP_SURFACE")])
def test_np_tables_equal_the_jax_suites(ours, theirs):
    """``np_cases.py``'s copies of the JAX suite's tables hold the same
    names, arguments and arrays (values and dtypes) as the originals."""
    import importlib.util
    from pathlib import Path

    path = (Path(__file__).parent / "python" / "unittest"
            / "test_numpy_op.py")
    spec = importlib.util.spec_from_file_location("jax_numpy_op_tables",
                                                  path)
    jax_tables = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tables)
    assert _same_data(getattr(T, ours), getattr(jax_tables, theirs))


def test_the_table_covers_110_names():
    assert len({c[0] for c in CASES}) >= 110


def _grad(mx, name, args):
    static = [a for a in args if not isinstance(a, onp.ndarray)]
    xs = [mx.nd.array(a) for a in args if isinstance(a, onp.ndarray)]
    for x in xs:
        x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.sum(getattr(mx.np, name)(*(static + xs)))
    y.backward()
    return [x.grad for x in xs]


@pytest.mark.parametrize("name,args", T.GRAD_CASES,
                         ids=[c[0] for c in T.GRAD_CASES])
def test_np_gradients_match_jax(name, args):
    ref = _grad(mj, name, args)
    with mt.cpu():
        got = _grad(mt, name, args)
    assert_same(got, ref, name, rtol=1e-5, atol=1e-5)


# ---- NEP-18 / NEP-13 and the tape ------------------------------------------

def test_array_function_routes_through_mx_np():
    with mt.cpu():
        a = mt.np.array(T.A34)
        out = onp.mean(a)
        cat = onp.concatenate([a, a], axis=0)
        det = onp.linalg.det(mt.np.array(T.SPD))
    assert isinstance(out, mt.nd.NDArray) and isinstance(cat, mt.nd.NDArray)
    assert isinstance(det, mt.nd.NDArray)
    assert_same(out, onp.mean(mj.np.array(T.A34)), "mean")
    assert_same(cat, onp.concatenate([mj.np.array(T.A34)] * 2), "concat")
    assert_same(det, onp.linalg.det(mj.np.array(T.SPD)), "det", rtol=1e-4)


def test_array_ufunc_routes_through_mx_np():
    with mt.cpu():
        a = mt.np.array(T.V6)
        outs = [onp.exp(a), onp.add(a, a), onp.multiply(T.V6, a), T.V6 + a]
    j = mj.np.array(T.V6)
    refs = [onp.exp(j), onp.add(j, j), onp.multiply(T.V6, j), T.V6 + j]
    for got, ref in zip(outs, refs):
        assert isinstance(got, mt.nd.NDArray)
        assert_same(got, ref, "ufunc")


def test_out_and_ufunc_methods_are_not_implemented():
    with mt.cpu():
        a = mt.np.array(T.V6)
        assert a.__array_ufunc__(onp.add, "reduce", a) is NotImplemented
        assert a.__array_ufunc__(onp.add, "__call__", a, a,
                                 out=(a,)) is NotImplemented
        with pytest.raises(TypeError):
            onp.add.reduce(a)


def test_dispatch_stays_on_the_tape():
    def grads(mx):
        x = mx.nd.array(T.V6)
        x.attach_grad()
        with mx.autograd.record():
            y = onp.sum(onp.exp(x) * onp.mean(x))
        y.backward()
        return x.grad

    ref = grads(mj)
    with mt.cpu():
        got = grads(mt)
    assert_same(got, ref, "tape")


def test_nested_sequences_ride_the_tape():
    def grads(mx):
        x, y = mx.nd.array(T.V6), mx.nd.array(T.W6)
        x.attach_grad()
        y.attach_grad()
        with mx.autograd.record():
            z = mx.nd.sum(mx.np.stack([x, y * 3]) ** 2)
        z.backward()
        return [x.grad, y.grad]

    ref = grads(mj)
    with mt.cpu():
        got = grads(mt)
    assert_same(got, ref, "stack")


def test_non_diff_names_stay_off_the_tape():
    with mt.cpu():
        x = mt.nd.array(T.P3)
        x.attach_grad()
        with mt.autograd.record():
            s = mt.np.sign(x)
            r = mt.np.exp(x)
    assert not s._data.requires_grad and r._data.requires_grad


# ---- the surface, the fallback and copyto ---------------------------------

def test_reference_surface_resolves_on_the_device():
    from mxnet_tpu_torch.numpy import resolve_source

    srcs = {n: resolve_source(n) for n in T.REFERENCE_NP_SURFACE}
    assert {n for n, s in srcs.items() if s != "torch"} == set()
    with mt.cpu():
        for name in T.REFERENCE_NP_SURFACE:
            assert getattr(mt.np, name) is not None, name


def test_creation_defaults_match_jax():
    with mt.cpu():
        got = [mt.np.zeros((2, 3)), mt.np.ones(4), mt.np.full((2,), 3),
               mt.np.full((2,), 2.5), mt.np.arange(5), mt.np.arange(0.5, 3),
               mt.np.eye(3, k=1), mt.np.linspace(0, 1, 5),
               mt.np.array([1, 2]), mt.np.array([1.5, 2.0]),
               mt.np.empty((2,)), mt.np.identity(3), mt.np.tri(3),
               mt.np.zeros_like(mt.np.ones((2,), dtype="int32"))]
    ref = [mj.np.zeros((2, 3)), mj.np.ones(4), mj.np.full((2,), 3),
           mj.np.full((2,), 2.5), mj.np.arange(5), mj.np.arange(0.5, 3),
           mj.np.eye(3, k=1), mj.np.linspace(0, 1, 5),
           mj.np.array([1, 2]), mj.np.array([1.5, 2.0]), mj.np.empty((2,)),
           mj.np.identity(3), mj.np.tri(3),
           mj.np.zeros_like(mj.np.ones((2,), dtype="int32"))]
    assert_same(got, ref, "creation")


def test_fallback_is_logged_once(caplog):
    import mxnet_tpu_torch.numpy as mnp

    name = "in1d"                # neither torch._numpy nor the port has it
    assert mnp.resolve_source(name) == "numpy"
    mnp._adapted_cache.pop(name, None)
    mnp._fallback_seen.discard(name)
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch"):
        fn = getattr(mt.np, name)
        mnp._adapted_cache.pop(name, None)
        getattr(mt.np, name)
        with mt.cpu():
            out = fn(mt.np.array(T.I6), mt.np.array(T.J6))
    msgs = [r for r in caplog.records if name in r.getMessage()]
    assert len(msgs) == 1
    assert name in mnp.fallback_names()
    assert_same(out, onp.isin(T.I6, T.J6), name)
    mnp._fallback_seen.discard(name)


def test_copyto_writes_on_the_device():
    from mxnet_tpu_torch.numpy import resolve_source

    assert resolve_source("copyto") == "torch"
    with mt.cpu():
        dst = mt.np.zeros((4,))
        mt.np.copyto(dst, onp.arange(4, dtype=onp.float32))
        onp.testing.assert_array_equal(dst.asnumpy(), [0, 1, 2, 3])
        mt.np.copyto(dst, onp.full(4, 9.0, onp.float32),
                     where=onp.array([True, False, True, False]))
        onp.testing.assert_array_equal(dst.asnumpy(), [9, 1, 9, 3])
        with pytest.raises(mt.MXNetError):
            mt.np.copyto(onp.zeros(3), onp.ones(3))
        with pytest.raises(mt.MXNetError):
            mt.np.copyto(mt.np.zeros((2,), dtype="int32"),
                         onp.ones(2, onp.float32))


def test_aliases_and_submodules():
    with mt.cpu():
        a = mt.np.array(T.P3)
        assert_same(mt.np.round_(a, 1), mj.np.round_(mj.np.array(T.P3), 1),
                    "round_")
        assert_same(mt.np.row_stack([a, a]),
                    mj.np.row_stack([mj.np.array(T.P3)] * 2), "row_stack")
        spd = mt.np.array(T.SPD)
        assert_same(mt.np.linalg.inv(spd),
                    mj.np.linalg.inv(mj.np.array(T.SPD)), "inv", rtol=1e-4)
        assert_same(mt.np.fft.rfft(a), mj.np.fft.rfft(mj.np.array(T.P3)),
                    "rfft")
    assert mt.np.random is mt.random

