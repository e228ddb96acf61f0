"""Every op the PyTorch port registers, against the JAX op of the same name,
on the CPU.

Each op runs once through ``mx.nd``'s registry in both packages on the
same numpy inputs (drawn with a fixed seed; ``dropout`` at p=0 and
``Dropout`` outside training, where both are the identity).  Generators
and attrs are the rows of ``tests/python/unittest/test_dtype_shape_rigor.py``'s
``SPECS`` for the ops the port has (copied, one shape each).  Both sides
compute in float32, so the limits are set from the gaps measured between
them, not from that file's cross-dtype tolerances: an element-wise op is
held to 1e-6 (``TOL``; the widest gap measured is 1.2e-7), and a
reduction, contraction, normalisation or special function (gamma family)
to 1e-5 (``ACC``; the widest gap measured is 9.5e-7, deconvolution's).
Outputs must
agree in count, shape and dtype, and in value within the tolerance
(exactly for integer and boolean results).  This file runs the ops of
``ops/core.py`` (and their aliases), ``test_torch_nd_ops_nn.py`` the
rest; the sampling ops are in ``test_torch_nd_random.py``.  The registry itself: the port's names are a
subset of the JAX package's, and each shared name agrees on
``num_outputs`` and ``differentiable``.
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

TOL = 1e-6
RS = np.random.RandomState(1234)


def _r(shape, lo=-1.0, hi=1.0):
    return (RS.rand(*shape) * (hi - lo) + lo).astype(np.float32)


def rnd(lo=-1.0, hi=1.0):
    return lambda s: _r(s, lo, hi)


def pos(s):
    return _r(s, 0.3, 1.7)


def unit(s):
    return _r(s, -0.9, 0.9)


def ints(lo=0, hi=8):
    return lambda s: RS.randint(lo, hi, s).astype(np.int32)


def dint(s):
    return RS.randint(-4, 5, s).astype(np.float32)


def perm(s):
    n = int(np.prod(s))
    return (RS.permutation(n).reshape(s) * 0.25 - n * 0.125).astype(
        np.float32)


def const(arr):
    return lambda s: np.asarray(arr)


class S:
    """One op case: positional generators, attrs, shape, tolerance."""

    def __init__(self, *gens, attrs=None, shape=(4, 5), rtol=None, atol=None):
        self.gens, self.attrs, self.shape = gens, attrs or {}, shape
        self.rtol = TOL if rtol is None else rtol
        self.atol = TOL if atol is None else atol


SPECS = {}


def add(names, *gens, **kw):
    for n in ([names] if isinstance(names, str) else names):
        SPECS[n] = S(*gens, **kw)


NCHW = (2, 3, 8, 8)
ACC = {"rtol": 1e-5, "atol": 1e-5}

# ---- element-wise unary ------------------------------------------------------
add(["abs", "negative", "square", "relu", "sigmoid", "hard_sigmoid",
     "log_sigmoid", "softsign", "tanh", "sin", "cos", "arctan", "arcsinh",
     "erf", "degrees", "radians", "mish", "silu", "gelu", "selu", "elu",
     "isfinite", "isnan", "isinf", "logical_not", "identity",
     "stop_gradient", "zeros_like", "ones_like", "shape_array",
     "size_array"], rnd(-2, 2))
add(["sign", "ceil", "floor", "rint", "round", "trunc", "fix"],
    lambda s: dint(s) + 0.25)
add(["exp", "expm1", "sinh", "cosh", "tan", "softrelu", "arcsin", "arccos",
     "arctanh"], unit)
add(["sqrt", "rsqrt", "cbrt", "rcbrt", "log", "log10", "log2", "log1p",
     "reciprocal"], pos)
add(["digamma", "gammaln", "gamma"], pos, **ACC)
add("erfinv", unit)
add("arccosh", rnd(1.5, 3.0))
add("l2_normalization", rnd())
add("rms_norm", rnd(), pos, attrs={"axis": -1}, shape=(4, 6))
add("clip", rnd(-2, 2), attrs={"a_min": -0.5, "a_max": 0.5})
add(["softmax", "softmin", "log_softmax"], rnd())
add(["leaky_relu"], rnd(), attrs={"slope": 0.1})
add("prelu", rnd(), lambda s: pos((1,)))
add("LeakyReLU", rnd(), attrs={"act_type": "leaky"})
add("Activation", rnd(), attrs={"act_type": "tanh"})
add("smooth_l1", rnd(-2, 2), attrs={"scalar": 1.0})
add("Dropout", rnd(), attrs={"p": 0.5})   # outside training: identity
add("dropout", rnd(), lambda s: None, attrs={"p": 0.0})

# ---- element-wise binary -----------------------------------------------------
add(["add", "subtract", "multiply", "maximum", "minimum", "hypot",
     "arctan2", "logaddexp", "elemwise_add", "elemwise_sub", "elemwise_mul",
     "broadcast_add", "broadcast_sub", "broadcast_mul"], rnd(), rnd())
add(["divide", "floor_divide", "mod", "elemwise_div", "broadcast_div"],
    rnd(0.1, 0.9), rnd(1.0, 2.0))
add("power", pos, rnd(0, 2))
add(["equal", "not_equal", "greater", "greater_equal", "lesser",
     "lesser_equal", "logical_and", "logical_or", "logical_xor"],
    dint, dint)
add("add_n", rnd(), rnd(), rnd())
add("where", lambda s: (RS.rand(*s) > 0.5).astype(np.float32), rnd(), rnd())

# ---- reductions ----------------------------------------------------------------
add(["sum", "mean", "max", "min", "prod", "std", "var", "logsumexp",
     "norm"], rnd(0.2, 1.2), attrs={"axis": -1}, **ACC)
add(["cumsum", "cumprod"], rnd(0.5, 1.5), attrs={"axis": -1}, **ACC)
add("moments", rnd(), attrs={"axes": (0,)})
add(["argmax", "argmin"], perm, attrs={"axis": -1})
add("argmax_channel", perm)
add("trace", rnd(), shape=(4, 4))

# ---- shape manipulation --------------------------------------------------------
add(["transpose", "sort", "argsort", "unique", "nonzero", "Flatten",
     "flatten"], perm)
add("squeeze", rnd(), shape=(4, 1, 5))
add("expand_dims", dint, attrs={"axis": 1})
add(["flip", "reverse"], dint, attrs={"axis": 0})
add("roll", dint, attrs={"shift": 2, "axis": 0})
add("rot90", rnd(), shape=(3, 4))
add("tile", rnd(), attrs={"reps": (2, 1)}, shape=(2, 3))
add("repeat", dint, attrs={"repeats": 2, "axis": 0})
add(["SwapAxis", "swapaxes"], rnd(), attrs={"dim1": 0, "dim2": 1},
    shape=(2, 3, 4))
add(["Reshape", "reshape"], dint, attrs={"shape": (-1,)})
add("reshape_like", rnd(), lambda s: _r((2, 10)))
add("broadcast_to", lambda s: _r((1, 5)), attrs={"shape": (4, 5)})
add("broadcast_like", lambda s: _r((1,) + s[1:]), rnd())
add("depth_to_space", rnd(), attrs={"block_size": 2}, shape=(2, 8, 3, 3))
add("space_to_depth", rnd(), attrs={"block_size": 2}, shape=(2, 2, 4, 4))
add("Pad", rnd(), attrs={"mode": "constant",
                         "pad_width": (0, 0, 0, 0, 1, 1, 1, 1)},
    shape=(2, 3, 4, 5))
add("pad", rnd(), attrs={"pad_width": ((1, 1), (0, 2))}, shape=(3, 4))
add(["tril", "triu"], rnd(), shape=(4, 4))
add(["diag", "diagonal"], rnd(), shape=(4, 4))
add("slice", rnd(), attrs={"begin": (1,), "end": (3,)})
add("slice_axis", rnd(), attrs={"axis": 0, "begin": 0, "end": 2})
add("slice_like", rnd(), lambda s: _r((2,) + s[1:]), attrs={"axes": (0,)})
add(["Cast", "cast"], dint, attrs={"dtype": "int32"})
add(["Concat", "concat"], dint, dint, attrs={"dim": 0})
add("stack", rnd(), rnd())
add(["SliceChannel", "split", "slice_channel"], rnd(),
    attrs={"num_outputs": 2, "axis": 1}, shape=(3, 4))
add("array_split", rnd(), attrs={"indices_or_sections": 2}, shape=(4, 3))
add("meshgrid", rnd(), rnd(), shape=(4,))
add("full_like", dint, attrs={"fill_value": 2.0})

# ---- contraction ---------------------------------------------------------------
add(["dot", "matmul", "inner"], rnd(), rnd(), shape=(4, 4), **ACC)
add("batch_dot", lambda s: _r((2, 3, 4)), lambda s: _r((2, 4, 5)), **ACC)
add("outer", rnd(), rnd(), shape=(4,))
add("tensordot", rnd(), rnd(), shape=(4, 4), **ACC)
add("kron", rnd(), rnd(), shape=(2, 2))
add("khatri_rao", lambda s: _r((3, 4)), lambda s: _r((2, 4)))
add("einsum", rnd(), rnd(), attrs={"subscripts": "ij,jk->ik"},
    shape=(4, 4), **ACC)
add(["FullyConnected", "fully_connected"], rnd(),
    lambda s: _r((6, int(np.prod(s[1:])))), lambda s: _r((6,)),
    attrs={"num_hidden": 6}, **ACC)

# ---- indexing ------------------------------------------------------------------
add(["Embedding", "embedding"], ints(0, 9), lambda s: _r((10, 6)),
    shape=(4,))
add("batch_take", rnd(), lambda s: ints(0, 4)((s[0],)), shape=(5, 5))
add("take", rnd(), ints(0, 3), attrs={"axis": 0})
add("take_along_axis", rnd(), lambda s: ints(0, 3)((2,) + s[1:]),
    attrs={"axis": 0})
add("gather_nd", rnd(), lambda s: RS.randint(0, 2, (2, 3)).astype(np.int32),
    shape=(3, 4))
add("scatter_nd", lambda s: _r((3,)),
    const(np.array([[0, 1, 2], [0, 1, 3]], np.int32)),
    attrs={"shape": (3, 4)})
add("one_hot", ints(0, 5), attrs={"depth": 6}, shape=(4,))
add("pick", rnd(), lambda s: ints(0, 4)((s[0],)), attrs={"axis": -1})
add("boolean_mask", rnd(), lambda s: (RS.rand(s[0]) > 0.3).astype(np.int32))
add("histogram", rnd(), attrs={"bins": 5, "range": (-1.0, 1.0)})
add("topk", rnd(), attrs={"k": 2, "axis": -1})

# ---- nn ------------------------------------------------------------------------
add(["Convolution", "convolution"], rnd(), lambda s: _r((4, s[1], 3, 3)),
    lambda s: _r((4,)), attrs={"kernel": (3, 3), "num_filter": 4},
    shape=NCHW, **ACC)
add(["Deconvolution", "deconvolution"], rnd(),
    lambda s: _r((s[1], 4, 3, 3)), lambda s: _r((4,)),
    attrs={"kernel": (3, 3), "num_filter": 4}, shape=NCHW, **ACC)
add(["Pooling", "pooling"], rnd(), attrs={"kernel": (2, 2),
                                          "pool_type": "max",
                                          "stride": (2, 2)}, shape=NCHW)
add("adaptive_avg_pooling", rnd(), attrs={"output_size": (2, 2)},
    shape=NCHW)
add("bilinear_resize", rnd(), attrs={"height": 6, "width": 6}, shape=NCHW,
    **ACC)
add(["UpSampling", "upsampling"], rnd(),
    attrs={"scale": 2, "sample_type": "nearest"}, shape=NCHW)
add(["BatchNorm", "batch_norm"], rnd(), lambda s: pos((s[1],)),
    lambda s: _r((s[1],)), lambda s: _r((s[1],)), lambda s: pos((s[1],)),
    shape=NCHW, **ACC)
add(["LayerNorm", "layer_norm"], rnd(), lambda s: pos((s[-1],)),
    lambda s: _r((s[-1],)), **ACC)
add(["GroupNorm", "group_norm"], rnd(), lambda s: pos((s[1],)),
    lambda s: _r((s[1],)), attrs={"num_groups": 2}, shape=(2, 4, 5),
    **ACC)
add(["InstanceNorm", "instance_norm"], rnd(), lambda s: pos((s[1],)),
    lambda s: _r((s[1],)), shape=(2, 3, 5), **ACC)
add(["LRN", "lrn"], rnd(), attrs={"nsize": 3}, shape=NCHW, **ACC)
add("softmax_cross_entropy", rnd(), lambda s: ints(0, 5)((s[0],)))
add("im2col", rnd(), attrs={"kernel": (2, 2)}, shape=NCHW)
add("col2im", lambda s: _r((2, 12, 16)),
    attrs={"input_size": (3, 5, 5), "kernel": (2, 2)})
for _name in ("SequenceMask", "SequenceLast", "SequenceReverse",
              "sequence_mask", "sequence_last", "sequence_reverse"):
    add(_name, lambda s: _r((5, 3, 4)),
        const(np.array([3, 5, 2], np.float32)),
        attrs={"use_sequence_length": True})
add(["ctc_loss", "CTCLoss"], lambda s: _r((6, 2, 5), -2, 2),
    const(np.array([[1, 2, -1], [3, 3, 4]], np.float32)), **ACC)
# one LSTM layer: i2h (4H, I), h2h (4H, H), then the two biases, I=3, H=5
add("RNN", lambda s: _r((4, 2, 3)),
    lambda s: _r((20 * 3 + 20 * 5 + 2 * 20,), -0.5, 0.5),
    lambda s: _r((1, 2, 5)), lambda s: _r((1, 2, 5)),
    attrs={"state_size": 5, "mode": "lstm", "state_outputs": True}, **ACC)
add("multi_head_attention", lambda s: _r((2, 8, 16)),
    lambda s: _r((2, 8, 16)), lambda s: _r((2, 8, 16)),
    attrs={"num_heads": 2, "impl": "dense"}, **ACC)

RANDOM = {n for n in treg.list_ops()
          if n.startswith(("sample_", "random_")) or n == "shuffle"}


def _arrays(spec):
    rs_state = RS.get_state()
    arrays = [g(spec.shape) for g in spec.gens]
    RS.set_state(rs_state)
    return arrays


def _nd(nd, a):
    return None if a is None else nd.array(a)


def _outs(x):
    return list(x) if isinstance(x, tuple) else [x]


def _held_elsewhere():
    """The ops whose cases live in the files of their own modules (the np
    tail, linear algebra, quantization, image, optimizer update, contrib
    tail, detection and parity ops), each against the JAX op of the same
    name, and the reference-name aliases of any op with a case."""
    from parity_cases import CASES as parity, DRAWS
    from test_torch_contrib_tail import CASES as contrib, _name
    from test_torch_detection import OPS as detection
    from test_torch_image_quant import IMAGE, QUANT, SAMPLING
    from test_torch_linalg import CASES as linalg
    from np_cases import NP_TAIL
    from test_torch_optimizer_ops import CASES as updates, PLAIN

    names = set(NP_TAIL) | {"linalg_" + n for n in linalg}
    names |= {_name(k) for k in contrib} | set(updates) | set(PLAIN)
    names |= {"reset_arrays"} | set(SAMPLING) - {"GridGenerator_warp"}
    names |= {k.replace("_calib", "").replace("_nhwc", "") for k in QUANT}
    image = {k.split("_batched")[0] for k in IMAGE}
    names |= {"image_" + k.rsplit("_", 1)[0] if k.startswith("resize")
              else "image_" + k for k in image}
    names.add("image_random_resized_crop")
    names |= {c[0] for c in parity} | set(DRAWS) | detection | set(SPECS)
    names |= set(RANDOM)
    return {n for n in treg.list_ops() if treg.get_op(n).name in names}


def test_every_op_has_a_case():
    missing = sorted(set(treg.list_ops()) - RANDOM - set(SPECS)
                     - _held_elsewhere())
    assert not missing, missing


def test_port_registry_is_a_subset_with_the_same_metadata():
    ported = set(treg.list_ops())
    assert ported <= set(jreg.list_ops())
    assert len(ported) >= 240
    for name in ported:
        a, b = jreg.get_op(name), treg.get_op(name)
        assert a.differentiable == b.differentiable, name
        if callable(a.num_outputs) or callable(b.num_outputs):
            assert callable(a.num_outputs) and callable(b.num_outputs), name
        else:
            assert a.num_outputs == b.num_outputs, name


def test_nd_exposes_every_op():
    for name in treg.list_ops():
        # functions of the same name, as in the JAX package
        if name not in ("dropout", "zeros_like", "ones_like"):
            assert getattr(mt.nd, name) is treg.get_op(name), name
    for name in ("broadcast_power", "broadcast_maximum", "broadcast_equal",
                 "broadcast_lesser_equal", "SoftmaxActivation",
                 "L2Normalization", "BlockGrad", "stop_gradient"):
        assert getattr(mt.nd, name).name == getattr(mj.nd, name).name


def check_op(name):
    """``name`` through both registries on its case's inputs."""
    spec = SPECS[name]
    arrays = _arrays(spec)
    ref = _outs(jreg.get_op(name)(*[_nd(mj.nd, a) for a in arrays],
                                  **spec.attrs))
    with mt.cpu():
        got = _outs(treg.get_op(name)(*[_nd(mt.nd, a) for a in arrays],
                                      **spec.attrs))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = g.asnumpy(), r.asnumpy()
        assert g.shape == r.shape, (g.shape, r.shape)
        assert g.dtype == r.dtype, (g.dtype, r.dtype)
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(g, r, rtol=spec.rtol, atol=spec.atol)
        else:
            np.testing.assert_array_equal(g, r)


# the ops of ops/core.py here; the others in test_torch_nd_ops_nn.py
CORE = sorted(n for n in SPECS
              if treg.get_op(n).fn.__module__.endswith(".ops.core"))


@pytest.mark.parametrize("name", CORE)
def test_op_matches_jax(name):
    check_op(name)
