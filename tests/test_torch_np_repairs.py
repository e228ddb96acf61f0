"""The repairs of ``ROADMAP.md`` Queue 3 items 1-8, one test each, against
the JAX package on the CPU: values and dtypes as the JAX package gives
them (``test_torch_np_sweep.py`` and ``test_torch_nd_sweep.py`` hold every
name; these pin the faults the sweep first found)."""
import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

F = onp.array([[-1.5, 0.25, 2.0], [3.0, -0.5, -8.0]], onp.float32)
I = onp.array([[-3, 1, 2], [4, 0, -8]], onp.int32)
I2 = onp.array([[2, 1, 3], [1, 2, 1]], onp.int32)


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    return [x]


def both(ns, name, *args, **kw):
    """(port, JAX) results of ``mx.<ns>.<name>`` on NDArrays of ``args``."""
    def call(mx):
        conv = mx.np.array if ns == "np" else mx.nd.array
        return getattr(getattr(mx, ns), name)(
            *[conv(a, dtype=a.dtype) if isinstance(a, onp.ndarray) else a
              for a in args], **kw)

    ref = call(mj)
    with mt.cpu():
        got = call(mt)
    g, r = _flat(got), _flat(ref)
    assert len(g) == len(r), name
    out = []
    for a, b in zip(g, r):
        a, b = a.asnumpy(), b.asnumpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype,
                                                           b.dtype)
        onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                    err_msg=name)
        out.append(a)
    return out


def test_item1_cbrt_of_negatives():
    (got,) = both("np", "cbrt", onp.float32([-8.0, -1.0, 27.0]))
    onp.testing.assert_allclose(got, [-2.0, -1.0, 3.0], rtol=1e-6)
    both("np", "cbrt", I)


def test_item2_modf_splits_toward_zero():
    frac, whole = both("np", "modf", onp.float32([-1.5, 2.25]))
    onp.testing.assert_array_equal(frac, [-0.5, 0.25])
    onp.testing.assert_array_equal(whole, [-1.0, 2.0])
    frac, _ = both("np", "modf", I)
    assert frac.dtype == onp.float32


@pytest.mark.parametrize("ns,name", [
    ("np", "nanmax"), ("np", "nanmin"), ("np", "nanargmax"),
    ("np", "nanargmin"), ("nd", "nanmax"), ("nd", "nanmin")])
def test_item3_nan_extremes_of_integers(ns, name):
    (got,) = both(ns, name, I)
    assert got.dtype.kind == "i"


@pytest.mark.parametrize("name", ["nanmean", "nanstd", "nanvar",
                                  "moments"])
def test_item3_nan_statistics_of_integers_in_float32(name):
    for got in both("nd", name, I):
        assert got.dtype == onp.float32


def test_item4_average_without_weights_and_unique_all():
    both("nd", "average", F)
    both("nd", "average", F, axis=1)
    got = both("np", "unique_all", onp.int32([3, 1, 3, 2, 1, 3]))
    assert len(got) == 4
    onp.testing.assert_array_equal(got[0], [1, 2, 3])
    onp.testing.assert_array_equal(got[1], [1, 3, 0])
    onp.testing.assert_array_equal(got[3], [2, 1, 3])


def test_item5_outer_of_nd_arrays_and_an_array_fill():
    (got,) = both("np", "outer", F, I2)
    assert got.shape == (6, 6)
    for ns in ("np", "nd"):
        both(ns, "full_like", F, onp.float32([1.0, 2.0, 3.0]))
    both("np", "full_like", I, onp.float32(2.5))


@pytest.mark.parametrize("ns,name,args", [
    ("nd", "ceil", (I,)), ("nd", "floor", (I,)), ("nd", "fix", (I,)),
    ("np", "fabs", (I,)), ("np", "rint", (I,)), ("np", "trunc", (I,)),
    ("np", "heaviside", (I, I2)), ("np", "polyval", (onp.int32([1, 2]), I)),
    ("nd", "heaviside", (I, I2)), ("nd", "polyval", (onp.int32([1, 2]), I))])
def test_item6_rounding_family_dtypes(ns, name, args):
    both(ns, name, *args)


@pytest.mark.parametrize("ns,name,args", [
    ("np", "hypot", (I, I2)), ("np", "logaddexp", (I, I2)),
    ("np", "logaddexp2", (I, I2)), ("np", "nextafter", (I, I2)),
    ("np", "spacing", (I,)), ("np", "frexp", (I,)),
    ("nd", "softmax", (I,)), ("nd", "log_softmax", (I,)),
    ("nd", "softmin", (I,)), ("nd", "gelu", (I,)), ("nd", "mish", (I,)),
    ("nd", "selu", (I,)), ("nd", "softrelu", (I,)),
    ("nd", "log_sigmoid", (I,)), ("nd", "linalg_qr", (I,)),
    ("nd", "linalg_gelqf", (I,)), ("nd", "linalg_norm", (I,)),
    ("nd", "linalg_pinv", (I,)), ("nd", "linalg_matrix_rank", (I,)),
    ("nd", "linalg_cond", (I[:, :2],)), ("nd", "linalg_svdvals", (I,)),
    ("np", "clip", (I,)), ("nd", "clip", (F,))])
def test_item7_integer_inputs_promote(ns, name, args):
    both(ns, name, *args)


def test_item7_svd_of_integers_reconstructs():
    with mt.cpu():
        u, s, v = mt.nd.linalg_svd(mt.nd.array(I, dtype="int32"))
    rec = (u.asnumpy() * s.asnumpy()[None]) @ v.asnumpy()
    onp.testing.assert_allclose(rec, I, atol=1e-5)


def test_item8_metric_at_the_root():
    assert mt.metric.Accuracy is mt.gluon.metric.Accuracy
    assert sorted(mt.metric.__all__) == sorted(mj.metric.__all__)
    m = mt.metric.create("accuracy")
    m.update([mt.nd.array(onp.int32([1, 0]), ctx=mt.cpu())],
             [mt.nd.array(onp.float32([[0.2, 0.8], [0.9, 0.1]]),
                          ctx=mt.cpu())])
    assert m.get() == ("accuracy", 1.0)
