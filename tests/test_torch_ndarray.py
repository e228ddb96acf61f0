"""``mx.nd.NDArray`` of the PyTorch port against the JAX package's, on the
CPU.

The same expression runs in both packages on the same numpy inputs (the
port inside ``with mx.cpu():``) and the results must agree in shape,
dtype and value: exactly for integer, boolean and data-movement results,
within 1e-6 for float32 arithmetic.  Covers creation, indexing and
``__setitem__`` (value semantics: a write never shows through another
array), the ``reshape`` codes, arithmetic with scalars on either side,
reductions, ``astype``/``copyto``/``as_in_context``, the JAX package's
result dtypes, ``nd.save`` in one package read by ``nd.load`` in the
other, and the context scope.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-6
RS = np.random.RandomState(0)
A = RS.uniform(-2, 2, (3, 4)).astype(np.float32)
B = RS.uniform(0.5, 2, (3, 4)).astype(np.float32)
I = RS.randint(-5, 6, (3, 4)).astype(np.int32)


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def both(fn):
    """``fn(nd)`` in the JAX package and in the port (on the CPU)."""
    ref = fn(mj.nd)
    with mt.cpu():
        got = fn(mt.nd)
    return ref, got


def check(fn, tol=TOL):
    ref, got = both(fn)
    for r, g in zip(*(_flat(ref), _flat(got))):
        r, g = _np(r), _np(g)
        assert g.shape == r.shape
        assert g.dtype == r.dtype, (g.dtype, r.dtype)
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(g, r, rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(g, r)


def _flat(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


@pytest.mark.parametrize("make", [
    lambda nd: nd.array(A),
    lambda nd: nd.array(I),
    lambda nd: nd.array([[1, 2], [3, 4]]),
    lambda nd: nd.array(A.astype(np.float64)),
    lambda nd: nd.array(A, dtype="float16"),
    lambda nd: nd.zeros((2, 3)),
    lambda nd: nd.ones(4, dtype="int32"),
    lambda nd: nd.full((2, 2), 7.5),
    lambda nd: nd.empty((2, 3)),
    lambda nd: nd.arange(5),
    lambda nd: nd.arange(1, 7, 2, repeat=2),
    lambda nd: nd.linspace(0, 1, 5),
    lambda nd: nd.linspace(0, 1, 4, endpoint=False),
    lambda nd: nd.eye(3),
    lambda nd: nd.eye(3, 4, 1),
    lambda nd: nd.zeros_like(nd.array(A)),
    lambda nd: nd.ones_like(nd.array(I)),
    lambda nd: nd.moveaxis(nd.array(A).reshape((3, 2, 2)), 0, -1),
], ids=["array", "array_int", "array_list", "array_f64", "array_dtype",
        "zeros", "ones", "full", "empty", "arange", "arange_repeat",
        "linspace", "linspace_open", "eye", "eye_mk", "zeros_like",
        "ones_like", "moveaxis"])
def test_creation(make):
    check(make)


@pytest.mark.parametrize("key", [
    1, -1, (1, 2), slice(1, 3), (slice(None), 2), (Ellipsis, 1),
    (slice(None, None, -1),), (slice(None), slice(3, 0, -2)),
    (None, 1), np.array([0, 2]), (slice(None), np.array([1, 3])),
], ids=["int", "neg", "pair", "slice", "col", "ellipsis", "rev", "revstep",
        "newaxis", "array", "fancy"])
def test_getitem(key):
    check(lambda nd: nd.array(A)[key])


def test_getitem_with_ndarray_index():
    check(lambda nd: nd.array(A)[nd.array([2, 0])])
    check(lambda nd: nd.array(A)[nd.array(A) > 0])


@pytest.mark.parametrize("key,value", [
    ((0, 1), 5.0), (slice(1, 3), 0.0), ((slice(None), 2), B[:, 2]),
    ((slice(None, None, -1), 0), np.arange(3, dtype=np.float32)),
    (Ellipsis, B),
], ids=["elem", "rows", "col", "revcol", "all"])
def test_setitem(key, value):
    def fn(nd):
        x = nd.array(A)
        view = x.reshape((12,))
        x[key] = nd.array(value) if isinstance(value, np.ndarray) else value
        return x, view   # the reshape taken before the write is unchanged

    check(fn)


def test_setitem_on_the_tape_raises_inside_record():
    with mt.cpu():
        x = mt.nd.array(A)
        x.attach_grad()
        with mt.autograd.record():
            with pytest.raises(MXNetError):
                x[0] = 1.0
        x[0, 0] = 3.0          # outside record: written, still a leaf
        assert x.asnumpy()[0, 0] == 3.0
        with mt.autograd.record():
            y = (x * x).sum()
        y.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), 2 * x.asnumpy(),
                                   rtol=TOL)


@pytest.mark.parametrize("shape", [(0, -1), (-1,), (-1, 0), (2, -1, 2),
                                   (12,), (0, 2, 2)])
def test_reshape_codes(shape):
    check(lambda nd: nd.array(A).reshape(shape))
    check(lambda nd: nd.array(A).reshape(*shape))


def test_reshape_special_codes_raise_in_both():
    with pytest.raises(Exception):
        mj.nd.array(A).reshape((-3,))
    with mt.cpu(), pytest.raises(MXNetError):
        mt.nd.array(A).reshape((-3,))


_BINOPS = {
    "add": lambda x, y: x + y, "sub": lambda x, y: x - y,
    "mul": lambda x, y: x * y, "div": lambda x, y: x / y,
    "floordiv": lambda x, y: x // y, "mod": lambda x, y: x % y,
    "pow": lambda x, y: x ** y, "eq": lambda x, y: x == y,
    "ne": lambda x, y: x != y, "lt": lambda x, y: x < y,
    "le": lambda x, y: x <= y, "gt": lambda x, y: x > y,
    "ge": lambda x, y: x >= y,
}


@pytest.mark.parametrize("name", sorted(_BINOPS))
@pytest.mark.parametrize("kind", ["array", "scalar_rhs", "scalar_lhs",
                                  "int_array", "int_scalar"])
def test_arithmetic(name, kind):
    op = _BINOPS[name]
    if kind == "array":
        check(lambda nd: op(nd.array(B), nd.array(A[0])))
    elif kind == "scalar_rhs":
        check(lambda nd: op(nd.array(B), 1.5))
    elif kind == "scalar_lhs":
        check(lambda nd: op(1.5, nd.array(B)))
    elif kind == "int_array":
        if name == "pow":
            check(lambda nd: op(nd.array(I), nd.array(np.abs(I) % 3)))
        elif name in ("floordiv", "mod"):
            check(lambda nd: op(nd.array(I), nd.array(np.abs(I) + 1)))
        else:
            check(lambda nd: op(nd.array(I), nd.array(I[::-1] + 7)))
    else:
        check(lambda nd: op(nd.array(I), 2))


def test_unary_methods_and_neg():
    for name in ("abs", "sqrt", "exp", "log", "sigmoid", "relu", "tanh",
                 "round", "floor", "ceil", "sign", "square", "expm1",
                 "log1p"):
        check(lambda nd: getattr(nd.array(B), name)())
    check(lambda nd: -nd.array(A))
    check(lambda nd: abs(nd.array(A)))
    check(lambda nd: nd.array(A).T)


@pytest.mark.parametrize("red", ["sum", "mean", "max", "min", "prod"])
@pytest.mark.parametrize("axis,keepdims", [(None, False), (0, False),
                                           (1, True), ((0, 1), False)])
def test_reductions(red, axis, keepdims):
    check(lambda nd: getattr(nd.array(B), red)(axis=axis,
                                               keepdims=keepdims), tol=1e-5)
    check(lambda nd: getattr(nd.array(I), red)(axis=axis, keepdims=keepdims),
          tol=1e-5)


def test_norm_argmax_clip_and_friends():
    check(lambda nd: nd.array(A).norm(), tol=1e-5)
    check(lambda nd: nd.array(A).norm(ord=1, axis=1), tol=1e-5)
    check(lambda nd: nd.array(A).argmax(axis=1))
    check(lambda nd: nd.array(A).argmin())
    check(lambda nd: nd.array(A).clip(-0.5, 0.5))
    check(lambda nd: nd.array(A).softmax())
    check(lambda nd: nd.array(A).log_softmax(axis=0))
    check(lambda nd: nd.array(A).dot(nd.array(B).T), tol=1e-5)
    check(lambda nd: nd.array(A) @ nd.array(B).T, tol=1e-5)
    check(lambda nd: nd.array(A).topk(k=2, ret_typ="both"))
    check(lambda nd: nd.array(A).sort(is_ascend=False))
    check(lambda nd: nd.array(A).argsort(axis=0))
    check(lambda nd: nd.array([0, 2, 1]).one_hot(3))
    check(lambda nd: nd.array(A).split(2, axis=1))
    check(lambda nd: nd.array(A).expand_dims(1).squeeze(1))
    check(lambda nd: nd.array(A).flatten())
    check(lambda nd: nd.array(A).transpose((1, 0)))
    check(lambda nd: nd.array(A).swapaxes(0, 1))
    check(lambda nd: nd.array(A[:1]).broadcast_to((3, 4)))
    check(lambda nd: nd.array(A).tile((2, 1)))
    check(lambda nd: nd.array(A).repeat(2, axis=0))
    check(lambda nd: nd.array(A).pad(((1, 0), (0, 2))))
    check(lambda nd: nd.array(A).slice((0, 1), (2, 3)))
    check(lambda nd: nd.array(A).take(nd.array([2, 0])))


@pytest.mark.parametrize("dtype", ["float16", "int32", "uint8", "bool",
                                   "bfloat16", "float64", "int64"])
def test_astype(dtype):
    check(lambda nd: nd.array(B).astype(dtype))


def test_copyto_copy_and_context():
    def fn(nd):
        x, y = nd.array(A), nd.zeros((3, 4), dtype="float16")
        x.copyto(y)
        z = x.copy()
        return y, z, x.as_in_context(x.context), x.copyto(x.context)

    check(fn)
    with mt.cpu():
        x = mt.nd.array(A)
        assert x.context == mt.cpu() and x.ctx == mt.cpu()
        assert x.size == 12 and x.ndim == 2 and x.shape == (3, 4)
        assert x.dtype == np.float32 and x.stype == "default"
        with pytest.raises(MXNetError):
            x.copyto(mt.nd.zeros((2, 2)))
        assert float(mt.nd.array([2.5])) == 2.5
        assert int(mt.nd.array([3])) == 3 and len(x) == 3
        assert mt.nd.array([4.0]).asscalar() == 4.0
        assert x.tolist() == A.tolist()


# (expression, the dtype the JAX package gives: probed against it below)
DTYPES = [
    ("array_f64", lambda nd: nd.array(np.ones(3)), "float32"),
    ("array_i64", lambda nd: nd.array(np.ones(3, np.int64)), "int32"),
    ("array_list", lambda nd: nd.array([1, 2]), "int32"),
    ("f_eq_f", lambda nd: nd.array(A) == nd.array(A), "bool"),
    ("equal", lambda nd: nd.equal(nd.array(A), nd.array(B)), "bool"),
    ("sum_i32", lambda nd: nd.sum(nd.array(I)), "int32"),
    ("cumsum_i32", lambda nd: nd.cumsum(nd.array(I)), "int32"),
    ("mean_i32", lambda nd: nd.mean(nd.array(I)), "float32"),
    ("argmax", lambda nd: nd.argmax(nd.array(A), axis=1), "int32"),
    ("topk", lambda nd: nd.topk(nd.array(A), k=2), "float32"),
    ("argsort", lambda nd: nd.argsort(nd.array(A)), "float32"),
    ("arange", lambda nd: nd.arange(4), "float32"),
    ("one_hot", lambda nd: nd.one_hot(nd.array([0, 2]), 3), "float32"),
    ("i32_div_2", lambda nd: nd.array(I) / 2, "float32"),
]


@pytest.mark.parametrize("name,fn,want", DTYPES, ids=[d[0] for d in DTYPES])
def test_result_dtypes_follow_jax(name, fn, want):
    ref, got = both(fn)
    assert str(ref.dtype) == want
    assert str(got.dtype) == want
    np.testing.assert_allclose(_np(got).astype(np.float64),
                               _np(ref).astype(np.float64), rtol=TOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["single", "list", "dict"])
def test_save_load_cross_package(tmp_path, writer, kind):
    fname = str(tmp_path / "arrays.npz")
    data = {"single": [A], "list": [A, I], "dict": [A, B]}[kind]

    def pack(nd):
        arrs = [nd.array(d) for d in data]
        if kind == "single":
            return arrs[0]
        return arrs if kind == "list" else {"a": arrs[0], "b": arrs[1]}

    if writer == "jax":
        mj.nd.save(fname, pack(mj.nd))
        with mt.cpu():
            got = mt.nd.load(fname)
    else:
        with mt.cpu():
            mt.nd.save(fname, pack(mt.nd))
        got = mj.nd.load(fname)
    if kind == "dict":
        assert sorted(got) == ["a", "b"]
        got = [got["a"], got["b"]]
    for g, d in zip(_flat(got), data):
        assert str(g.dtype) == str(d.dtype)
        np.testing.assert_array_equal(_np(g), d)


def test_context_scope_and_default():
    assert mt.current_context() == mt.gpu(0)
    with mt.cpu():
        assert mt.current_context() == mt.cpu()
        assert mt.nd.zeros((2,)).context == mt.cpu()
        with mt.gpu(0):
            assert mt.current_context() == mt.gpu(0)
        assert mt.current_context() == mt.cpu()
    assert mt.current_context() == mt.gpu(0)
    assert mt.num_gpus() == (torch.cuda.device_count()
                             if torch.cuda.is_available() else 0)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            mt.nd.zeros((2,))      # the default context is the card
    x = mt.nd.array(A, ctx=mt.cpu())
    assert x.context == mt.cpu()


def test_numpy_interchange():
    with mt.cpu():
        x = mt.nd.array(A)
        np.testing.assert_array_equal(np.asarray(x), A)
        y = np.float32(2.0) * x
        assert isinstance(y, mt.nd.NDArray)
        np.testing.assert_allclose(y.asnumpy(), 2 * A, rtol=TOL)
        z = A + x               # numpy defers to the NDArray's operator
        assert isinstance(z, mt.nd.NDArray)
        t = torch.from_dlpack(x)
        np.testing.assert_array_equal(t.numpy(), A)
        arr = x.asnumpy()
        arr[0, 0] = 99.0          # asnumpy is a copy
        assert x.asnumpy()[0, 0] == A[0, 0]
        src = A.copy()
        w = mt.nd.array(src)
        src[0, 0] = 99.0          # array() copies its source
        assert w.asnumpy()[0, 0] == A[0, 0]
        mt.nd.waitall()
        x.wait_to_read()


def test_out_argument_and_concatenate():
    def fn(nd):
        out = nd.zeros((3, 4))
        r = nd.add(nd.array(A), nd.array(B), out=out)
        assert r is out
        return out, nd.concatenate([nd.array(A), nd.array(B)], axis=1)

    check(fn)
