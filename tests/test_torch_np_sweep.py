"""The sweep of ``mx.np`` (here) and ``mx.nd`` (``test_torch_nd_sweep.py``)
against the JAX package, on the CPU.

Every public function of ``jax.numpy`` (what the JAX ``mx.np`` resolves)
and every op of the JAX registry that the port's ``mx.nd`` exports is
called once on a float32 array with negative entries and once on an
int32 array, with one argument, or with two where one does not do; the
first call the JAX package answers is the case.  The port must answer it
too, with the same count, shapes and dtypes of results, integer and
boolean ones exactly and floating ones within ``RTOL``/``ATOL``.

The JAX side runs in one ``jax.jit`` over NDArrays that wrap the traced
inputs (one compile for the whole table, where each call eagerly would
compile its own program); calls that need concrete values, or that do not
return arrays, run eagerly.  Each name the sweep leaves out stands in
``NP_SKIP``/``ND_SKIP`` with its reason.
"""
import functools
import inspect
import logging
import warnings

import jax
import jax.numpy as jnp
import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import registry as jreg

RTOL, ATOL = 1e-5, 1e-6

F32 = onp.array([[-1.5, 0.25, 2.0], [3.0, -0.5, -8.0]], onp.float32)
F32_B = onp.array([[2.0, 0.5, 1.5], [1.0, 3.0, 2.5]], onp.float32)
I32 = onp.array([[-3, 1, 2], [4, 0, -8]], onp.int32)
I32_B = onp.array([[2, 1, 3], [1, 2, 1]], onp.int32)
INPUTS = {"f32": (F32, F32_B), "i32": (I32, I32_B)}

_FACTORY = "builds an array from a shape or a count, not from its input"
_IO = "file, text or printing I/O"
_TYPE = "a dtype or scalar type, numpy's own in both packages"
_RNG = "draws from a generator; the streams differ by design (ROADMAP RNG)"
NP_SKIP = {
    **{n: _FACTORY for n in (
        "empty", "zeros", "ones", "full", "arange", "linspace", "logspace",
        "geomspace", "eye", "identity", "tri", "indices", "tril_indices",
        "triu_indices", "mask_indices", "diag_indices", "bartlett",
        "blackman", "hamming", "hanning", "kaiser", "fromfunction",
        "fromiter", "frombuffer", "fromstring", "empty_like")},
    **{n: _IO for n in (
        "load", "save", "savez", "fromfile", "array_repr", "array_str",
        "printoptions", "set_printoptions", "get_printoptions")},
    **{n: "a shape or count argument: the array input would be one"
       for n in ("reshape", "resize", "broadcast_to", "tile", "repeat",
                 "pad", "unravel_index", "ravel_multi_index", "bincount")},
    **{n: "takes a Python function (host numpy in the port)"
       for n in ("vectorize", "frompyfunc", "piecewise",
                 "apply_along_axis", "apply_over_axes")},
    "lexsort": "sorts by a sequence of keys: a 2-D array is one key "
               "per row in numpy, which jax.numpy reads otherwise",
    "histogram": "float32 edges from a data-dependent range; held by "
                 "test_torch_numpy.py's histogram cases",
    "histogram_bin_edges": "as histogram",
    "histogram2d": "as histogram", "histogramdd": "as histogram",
    "polydiv": "host numpy in the port (logged fallback)",
    "roots": "host numpy in the port (logged fallback)",
    "poly": "host numpy in the port (logged fallback)",
    "polyfit": "host numpy in the port (logged fallback)",
    "finfo": "a numpy finfo object", "iinfo": "a numpy iinfo object",
    "isdtype": "tests dtypes, not arrays",
    "promote_types": "tests dtypes, not arrays",
    "result_type": "returns a dtype object",
    "can_cast": "tests dtypes, not arrays",
    "issubdtype": "tests dtypes, not arrays",
    **{n: "a Python int or tuple in the port, as numpy returns; the JAX "
       "package wraps it in an NDArray it cannot print (ROADMAP.md, "
       "reference faults)" for n in ("shape", "ndim", "size")},
}
ND_SKIP = {
    **{n: _FACTORY for n in (
        "_zeros", "_ones", "_full", "_arange", "_linspace", "_eye",
        "_zeros_without_dtype", "bartlett", "blackman", "hamming", "hanning",
        "kaiser")},
    **{n: "ids out of range of the table: JAX fills NaN rows, the port "
       "raises (ROADMAP.md, reference faults)"
       for n in ("embedding", "Embedding")},
    "linalg_extracttrian": "a non-square input, which the reference "
                           "refuses (JAX's gather clamps it)",
    "linalg_multi_dot": "one matrix, which the reference refuses (JAX "
                        "returns 0)",
    "linalg_svd": "singular vectors are fixed only up to sign; "
                  "test_torch_linalg.py holds the factors' products",
    **{n: "the sweep's (2, 3) arrays are no boxes (4 coordinates a row); "
       "tests/test_torch_detection.py holds the op"
       for n in ("box_iou", "box_nms",
                 "_contrib_box_non_maximum_suppression")},
    "_linalg_extracttrian": "as linalg_extracttrian",
    **{n: "an integer remainder by the int32 input's zero: JAX answers "
       "an arbitrary value, torch raises; tests/parity_cases.py holds "
       "the op on inputs without a zero" for n in ("_rmod_scalar",
                                                   "_RModScalar")},
}
_RNG_PREFIXES = ("random", "sample", "_random", "_sample", "shuffle",
                 "_shuffle", "normal", "uniform", "bernoulli", "dropout", "Dropout",
                 "categorical", "multinomial", "_image_random",
                 "image_random", "rrelu", "_sample_unique_zipfian")
# calls whose JAX function reads its input on the host (a callback at run
# time): they run eagerly
_EAGER = {"linalg_eig", "linalg_eigvals"}
_TRACE_ERRORS = (jax.errors.ConcretizationTypeError,
                 jax.errors.NonConcreteBooleanIndexError,
                 jax.errors.TracerArrayConversionError,
                 jax.errors.TracerIntegerConversionError)


def _np_names():
    out = []
    for n in sorted(dir(jnp)):
        obj = getattr(jnp, n)
        if n.startswith("_") or n in NP_SKIP or not callable(obj) \
                or inspect.isclass(obj) or inspect.ismodule(obj):
            continue
        out.append(n)
    return out


def _nd_names():
    return [n for n in sorted(jreg._OP_REGISTRY)
            if hasattr(mt.nd, n) and n not in ND_SKIP
            and not n.startswith(_RNG_PREFIXES)]


NAMES = {"np": _np_names(), "nd": _nd_names()}


def _is_array(x):
    return isinstance(x, (jax.Array, mj.nd.NDArray))


def _leaves(r):
    if isinstance(r, (list, tuple)):
        return [y for v in r for y in _leaves(v)]
    return [r]


def _unwrap(r):
    if isinstance(r, (list, tuple)):
        return [_unwrap(v) for v in r]
    return r._data if isinstance(r, mj.nd.NDArray) else r


def _call(ns, name, arrays, pkg):
    fn = getattr(getattr(pkg, ns), name)
    return fn(*[pkg.nd.array(a, dtype=a.dtype) if ns == "nd"
                else pkg.np.array(a, dtype=a.dtype) for a in arrays])


@functools.lru_cache(maxsize=None)
def jax_cases(ns):
    """{(name, kind): (args, JAX results as numpy)} of one namespace."""
    names = NAMES[ns]
    nargs, eager = {}, []

    def wrap(t):
        return mj.nd.NDArray(t)

    def program(f, fb, i, ib):
        out = {}
        for name in names:
            if name in _EAGER:
                eager.extend((name, k) for k in INPUTS)
                continue
            fn = getattr(getattr(mj, ns), name)
            for kind, pair in (("f32", (f, fb)), ("i32", (i, ib))):
                for k in (1, 2):
                    try:
                        with warnings.catch_warnings():
                            warnings.simplefilter("ignore")
                            r = fn(*[wrap(t) for t in pair[:k]])
                    except _TRACE_ERRORS:
                        eager.append((name, kind))
                        break
                    except Exception:   # not a call of this arity
                        continue
                    if r is None or not all(map(_is_array, _leaves(r))):
                        eager.append((name, kind))
                        break
                    nargs[(name, kind)] = k
                    out["%s|%s" % (name, kind)] = _unwrap(r)
                    break
        return out

    res = jax.jit(program)(F32, F32_B, I32, I32_B)
    cases = {}
    for (name, kind), k in nargs.items():
        r = res["%s|%s" % (name, kind)]
        cases[(name, kind)] = (INPUTS[kind][:k], jax.tree_util.tree_map(
            onp.asarray, r))
    logging.disable(logging.CRITICAL)     # mx.np's host-fallback notes
    try:
        for name, kind in eager:
            for k in (1, 2):
                args = INPUTS[kind][:k]
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        r = _host_all(_call(ns, name, args, mj))
                except Exception:
                    continue
                cases[(name, kind)] = (args, r)
                break
    finally:
        logging.disable(logging.NOTSET)
    return cases


def _host_all(r):
    if isinstance(r, (list, tuple)):
        return [_host_all(v) for v in r]
    return r.asnumpy() if hasattr(r, "asnumpy") else onp.asarray(r)


def _assert_same(got, ref, what):
    got, ref = _leaves(_host_all(got)), _leaves(ref)
    assert len(got) == len(ref), (what, len(got), len(ref))
    for g, r in zip(got, ref):
        g, r = onp.asarray(g), onp.asarray(r)
        assert g.shape == r.shape, (what, g.shape, r.shape)
        assert g.dtype == r.dtype, (what, g.dtype, r.dtype)
        if r.dtype.kind in "fc":
            onp.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL,
                                        equal_nan=True, err_msg=what)
        else:
            onp.testing.assert_array_equal(g, r, err_msg=what)


def _sweep(ns, name):
    cases = [(kind, jax_cases(ns)[(name, kind)]) for kind in INPUTS
             if (name, kind) in jax_cases(ns)]
    if not cases:
        pytest.skip("the JAX package answers no call of %s on one or two "
                    "arrays" % name)
    for kind, (args, ref) in cases:
        with mt.cpu(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = _call(ns, name, args, mt)
        _assert_same(got, ref, "%s.%s(%s x%d)" % (ns, name, kind,
                                                  len(args)))


@pytest.mark.parametrize("name", NAMES["np"])
def test_np_name_matches_jax(name):
    _sweep("np", name)


def test_skipped_names_exist_in_the_jax_package():
    """The skip lists name only what the JAX package has."""
    assert all(hasattr(jnp, n) for n in NP_SKIP)
    assert all(n in jreg._OP_REGISTRY for n in ND_SKIP)
