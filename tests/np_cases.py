"""The ``mx.np`` case tables of the port's tests, as plain numpy data
(``chip_smoke.py`` runs them on the card, so this file imports numpy
only).

The arrays, ``ALL_CASES`` (``CASES``), ``GRAD_CASES`` and
``REFERENCE_NP_SURFACE`` are copies of the tables of the JAX package's
``tests/python/unittest/test_numpy_op.py``;
``tests/test_torch_numpy.py::test_np_tables_equal_the_jax_suites`` holds
them equal.  ``EXTRA`` holds names ``jax.numpy`` has beyond that table,
``KEYWORDS`` the keyword arguments of the port's own ``mx.np`` functions
(each against ``jax.numpy``'s), ``RAISES`` the calls both ``mx.np``s
refuse, and ``NP_TAIL`` one case of each registered op of
``ops/np_tail.py`` (positional inputs, keyword attrs) for ``mx.nd``.
"""
import numpy as onp

rs = onp.random.RandomState(42)

A22 = rs.rand(2, 2).astype(onp.float32)
A34 = rs.rand(3, 4).astype(onp.float32)
B34 = rs.rand(3, 4).astype(onp.float32)
A44 = rs.rand(4, 4).astype(onp.float32)
SPD = (A44 @ A44.T + 4 * onp.eye(4)).astype(onp.float32)
V6 = rs.rand(6).astype(onp.float32)
W6 = rs.rand(6).astype(onp.float32)
P3 = rs.rand(6).astype(onp.float32) * 4 - 2  # mixed signs
I6 = rs.randint(0, 5, 6).astype(onp.int32)
J6 = rs.randint(1, 5, 6).astype(onp.int32)
BO = onp.array([True, False, True, True, False, True])

# (name, args, kwargs) — compared elementwise vs numpy on the same inputs
UNARY = [
    ("abs", (P3,)), ("absolute", (P3,)), ("negative", (V6,)),
    ("exp", (V6,)), ("expm1", (V6,)), ("log", (V6 + 0.5,)),
    ("log2", (V6 + 0.5,)), ("log10", (V6 + 0.5,)), ("log1p", (V6,)),
    ("sqrt", (V6,)), ("cbrt", (V6,)), ("square", (V6,)),
    ("reciprocal", (V6 + 0.5,)), ("sign", (P3,)),
    ("sin", (V6,)), ("cos", (V6,)), ("tan", (V6,)),
    ("arcsin", (V6 * 0.9,)), ("arccos", (V6 * 0.9,)), ("arctan", (P3,)),
    ("sinh", (V6,)), ("cosh", (V6,)), ("tanh", (P3,)),
    ("arcsinh", (P3,)), ("arccosh", (V6 + 1.5,)), ("arctanh", (V6 * 0.8,)),
    ("floor", (P3,)), ("ceil", (P3,)), ("trunc", (P3,)), ("rint", (P3,)),
    ("degrees", (V6,)), ("radians", (V6,)),
    ("isnan", (P3,)), ("isinf", (P3,)), ("isfinite", (P3,)),
    ("logical_not", (BO,)),
    ("cumsum", (V6,)), ("cumprod", (V6,)),
    ("sort", (P3,)), ("argsort", (P3,)),
    ("ravel", (A34,)), ("transpose", (A34,)),
    ("squeeze", (A34[None],)), ("flip", (V6,)),
    ("exp2", (V6,)), ("signbit", (P3,)), ("spacing", (V6,)),
    ("nan_to_num", (P3,)), ("unique", (I6,)),
    ("diff", (V6,)), ("ediff1d", (V6,)),
    ("atleast_1d", (V6,)), ("atleast_2d", (V6,)), ("atleast_3d", (A34,)),
    ("hamming", (8,)), ("hanning", (8,)), ("blackman", (8,)),
    ("bartlett", (8,)),
]

BINARY = [
    ("add", (V6, W6)), ("subtract", (V6, W6)), ("multiply", (V6, W6)),
    ("divide", (V6, W6 + 0.5)), ("true_divide", (V6, W6 + 0.5)),
    ("floor_divide", (V6, W6 + 0.5)), ("mod", (V6, W6 + 0.5)),
    ("remainder", (V6, W6 + 0.5)), ("fmod", (V6, W6 + 0.5)),
    ("power", (V6 + 0.5, W6)), ("float_power", (V6 + 0.5, W6)),
    ("maximum", (V6, W6)), ("minimum", (V6, W6)),
    ("hypot", (V6, W6)), ("arctan2", (P3, V6 + 0.1)),
    ("logaddexp", (V6, W6)), ("copysign", (V6, P3)),
    ("heaviside", (P3, V6)), ("ldexp", (V6, I6)),
    ("equal", (I6, J6)), ("not_equal", (I6, J6)),
    ("greater", (V6, W6)), ("greater_equal", (V6, W6)),
    ("less", (V6, W6)), ("less_equal", (V6, W6)),
    ("logical_and", (BO, ~BO)), ("logical_or", (BO, ~BO)),
    ("logical_xor", (BO, ~BO)),
    ("bitwise_and", (I6, J6)), ("bitwise_or", (I6, J6)),
    ("bitwise_xor", (I6, J6)),
    ("gcd", (I6, J6)), ("lcm", (I6, J6)),
    ("dot", (A34, A34.T)), ("matmul", (A34, A34.T)),
    ("inner", (V6, W6)), ("outer", (V6, W6)),
    ("kron", (A22, A22)), ("cross", (V6[:3], W6[:3])),
    ("tensordot", (A34, B34)), ("vdot", (V6, W6)),
    ("searchsorted", (onp.sort(V6), W6)),
    ("polyval", (P3[:3], V6)),
]

REDUCTION = [
    ("sum", (A34,), {}), ("prod", (V6,), {}), ("mean", (A34,), {}),
    ("std", (A34,), {}), ("var", (A34,), {}),
    ("max", (A34,), {}), ("min", (A34,), {}),
    ("argmax", (A34,), {}), ("argmin", (A34,), {}),
    ("ptp", (A34,), {}), ("median", (V6,), {}),
    ("percentile", (V6, 30.0), {}), ("quantile", (V6, 0.3), {}),
    ("average", (V6,), {}), ("count_nonzero", (I6,), {}),
    ("nanmax", (P3,), {}), ("nanmin", (P3,), {}), ("nansum", (P3,), {}),
    ("nanmean", (P3,), {}), ("nanstd", (P3,), {}), ("nanvar", (P3,), {}),
    ("nanprod", (P3,), {}),
    ("sum", (A34,), {"axis": 1}), ("mean", (A34,), {"axis": 0}),
    ("cumsum", (A34,), {"axis": 1}),
    ("all", (BO,), {}), ("any", (BO,), {}),
    ("trace", (A44,), {}), ("bincount", (I6,), {}),
]

SHAPE = [
    ("reshape", (A34, (4, 3)), {}),
    ("concatenate", ([A34, B34],), {}),
    ("stack", ([V6, W6],), {}),
    ("hstack", ([V6, W6],), {}),
    ("vstack", ([V6, W6],), {}),
    ("dstack", ([A22, A22],), {}),
    ("column_stack", ([V6, W6],), {}),
    ("split", (V6, 3), {}),
    ("array_split", (V6, 4), {}),
    ("tile", (V6, 2), {}),
    ("repeat", (V6, 2), {}),
    ("roll", (V6, 2), {}),
    ("rot90", (A34,), {}),
    ("expand_dims", (V6, 0), {}),
    ("swapaxes", (A34, 0, 1), {}),
    ("moveaxis", (A34[None], 0, 2), {}),
    ("broadcast_to", (V6, (2, 6)), {}),
    ("pad", (V6, 2), {}),
    ("append", (V6, W6), {}),
    ("insert", (V6, 1, 9.0), {}),
    ("delete", (V6, 1), {}),
    ("tril", (A44,), {}),
    ("triu", (A44,), {}),
    ("diag", (V6,), {}),
    ("diagonal", (A44,), {}),
    ("meshgrid", (V6[:3], W6[:2]), {}),
    ("where", (BO, V6, W6), {}),
    ("take", (V6, I6 % 6), {}),
    ("compress", (BO, V6), {}),
    ("extract", (BO, V6), {}),
    ("flatnonzero", (P3,), {}),
    ("argwhere", (BO,), {}),
    ("interp", (V6, onp.sort(W6), P3), {}),
    ("cov", (A34,), {}),
    ("corrcoef", (A34,), {}),
    ("histogram", (V6,), {}),
    ("digitize", (V6, onp.sort(W6[:3])), {}),
    ("vander", (V6[:4],), {}),
    ("tri", (4,), {}),
    ("einsum", ("ij,kj->ik", A34, B34), {}),
]

ALL_CASES = ([(n, a, {}) for n, a in UNARY] +
             [(n, a, {}) for n, a in BINARY] +
             REDUCTION + SHAPE)
CASES = ALL_CASES

GRAD_CASES = [
    ("exp", (V6,)),
    ("log", (V6 + 0.5,)),
    ("tanh", (P3,)),
    ("sqrt", (V6 + 0.1,)),
    ("sin", (V6,)),
    ("matmul", (A34, A34.T.copy())),
    ("multiply", (V6, W6)),
    ("divide", (V6, W6 + 0.5)),
    ("power", (V6 + 0.5, W6)),
    ("logaddexp", (V6, W6)),
    ("mean", (A34,)),
    ("std", (A34 + 0.1,)),
    ("einsum", ("ij,kj->ik", A34, B34)),
    ("kron", (A22, A22)),
    ("interp", (V6, onp.sort(W6), P3)),
]

# the reference's public mx.np op surface
REFERENCE_NP_SURFACE = [
    "abs", "absolute", "add", "all", "amax", "amin", "any", "append",
    "arange", "arccos", "arccosh", "arcsin", "arcsinh", "arctan",
    "arctan2", "arctanh", "argmax", "argmin", "argsort", "around",
    "array", "array_split", "atleast_1d", "atleast_2d", "atleast_3d",
    "average", "bincount", "bitwise_and", "bitwise_not", "bitwise_or",
    "bitwise_xor", "blackman", "broadcast_to", "cbrt", "ceil", "clip",
    "column_stack", "concatenate", "copy", "copysign", "cos", "cosh",
    "cross", "cumsum", "deg2rad", "degrees", "delete", "diag",
    "diag_indices_from", "diagflat", "diagonal", "diff", "divide", "dot",
    "dsplit", "dstack", "ediff1d", "einsum", "empty", "empty_like",
    "equal", "exp", "expand_dims", "expm1", "eye", "fabs",
    "fill_diagonal", "fix", "flatnonzero", "flip", "fliplr", "flipud",
    "floor", "fmax", "fmin", "fmod", "full", "full_like", "greater",
    "greater_equal", "hamming", "hanning", "histogram", "hsplit",
    "hstack", "hypot", "identity", "indices", "inner", "insert",
    "interp", "invert", "isfinite", "isinf", "isnan", "isneginf",
    "isposinf", "kron", "lcm", "ldexp", "less", "less_equal", "linspace",
    "log", "log10", "log1p", "log2", "logical_and", "logical_not",
    "logical_or", "logical_xor", "logspace", "matmul", "max", "maximum",
    "mean", "median", "meshgrid", "min", "minimum", "mod", "moveaxis",
    "multiply", "nan_to_num", "negative", "nonzero", "not_equal", "ones",
    "ones_like", "outer", "pad", "percentile", "polyval", "power",
    "prod", "quantile", "rad2deg", "radians", "ravel", "reciprocal",
    "remainder", "repeat", "reshape", "resize", "rint", "roll",
    "rollaxis", "rot90", "round", "round_", "row_stack", "shape", "sign",
    "sin", "sinh", "sort", "split", "sqrt", "square", "squeeze", "stack",
    "std", "subtract", "sum", "swapaxes", "take", "tan", "tanh",
    "tensordot", "tile", "trace", "transpose", "tri", "tril",
    "tril_indices", "triu", "triu_indices", "triu_indices_from",
    "true_divide", "trunc", "unique", "unravel_index", "var", "vdot",
    "vsplit", "vstack", "where", "zeros", "zeros_like",
]

NANS = onp.array([0.5, onp.nan, -1.0, 2.0, onp.nan, 0.25], onp.float32)
J1 = onp.int32([1, 0, 2, 1, 3, 1])
# names jax.numpy has beyond the table: the port's own torch versions
EXTRA = [
    ("asin", (V6 * 0.9,), {}), ("atan2", (P3, V6 + 0.1), {}),
    ("pow", (V6 + 0.5, W6), {}), ("concat", ([A34, B34],), {}),
    ("permute_dims", (A34, (1, 0)), {}),
    ("matrix_transpose", (A34,), {}), ("nanargmax", (NANS,), {}),
    ("nanargmin", (NANS,), {}), ("nancumsum", (NANS,), {}),
    ("nancumprod", (NANS,), {}), ("nanmedian", (NANS,), {}),
    ("nanpercentile", (NANS, 30.0), {}), ("isin", (I6, J6), {}),
    ("intersect1d", (I6, J6), {}), ("union1d", (I6, J6), {}),
    ("setdiff1d", (I6, J6), {}), ("setxor1d", (I6, J6), {}),
    ("lexsort", ((I6, J6),), {}),
    ("select", ([BO, ~BO], [V6, W6]), {}),
    ("polyadd", (P3[:3], V6[:2]), {}), ("polysub", (P3, V6), {}),
    ("polymul", (P3[:3], V6[:4]), {}), ("polyder", (P3,), {}),
    ("polyint", (P3,), {}), ("vecdot", (A34, B34), {}),
    ("unique_counts", (I6,), {}), ("unique_values", (I6,), {}),
    ("frexp", (P3,), {}), ("astype", (V6, "int32"), {}),
    ("histogram_bin_edges", (V6,), {}), ("unstack", (A34,), {}),
    ("cumulative_sum", (V6,), {}), ("matvec", (A34, V6[:4]), {}),
    ("sum", (A34,), {"axis": (0, 1), "keepdims": True}),
    ("maximum", (V6, 0.5), {}), ("mean", (I6,), {}),
    ("insert", (A34, onp.int32([3, 1]), B34[:, :2]), {"axis": 1}),
]


SRT = onp.sort(W6)
NP_TAIL = {
    "append": ([V6, W6], {}), "argwhere": ([BO], {}),
    "atleast_1d": ([onp.asarray(V6[0])], {}), "atleast_2d": ([V6], {}),
    "atleast_3d": ([A34], {}), "average": ([A34, B34], {"axis": 1}),
    "bartlett": ([], {"M": 7}), "bincount": ([I6], {"minlength": 7}),
    "bitwise_and": ([I6, J6], {}), "bitwise_not": ([I6], {}),
    "bitwise_or": ([I6, J6], {}), "bitwise_xor": ([I6, J6], {}),
    "blackman": ([], {"M": 7}), "choose": ([I6 % 2, V6, W6], {}),
    "column_stack": ([V6, W6], {}),
    "compress": ([BO[:4], A34], {"axis": 1}),
    "copysign": ([V6, P3], {}), "corrcoef": ([A34], {}),
    "count_nonzero": ([I6], {}), "cov": ([A34], {"bias": True}),
    "cross": ([A34[:, :3], B34[:, :3]], {}),
    "delete": ([A34], {"obj": 2, "axis": 1}),
    "diff": ([A34], {"n": 2, "axis": 1}),
    "digitize": ([V6, SRT[:4]], {"right": True}),
    "dstack": ([A22, A22], {}),
    "ediff1d": ([V6], {"to_end": 1.0, "to_begin": -1.0}),
    "extract": ([BO, V6], {}), "fill_diagonal": ([A34, 2.0], {}),
    "flatnonzero": ([P3 > 0], {}), "float_power": ([V6 + 0.5, W6], {}),
    "fmod": ([P3, W6 + 0.5], {}), "gcd": ([I6, J6], {}),
    "hamming": ([], {"M": 7}), "hanning": ([], {"M": 7}),
    "heaviside": ([P3, V6], {}), "hstack": ([V6, W6], {}),
    "insert": ([A34, 1, V6[:3]], {"axis": 1}),
    "interp": ([V6, SRT, P3], {"left": -1.0}),
    "isclose": ([V6, V6 + 1e-7], {}),
    "isneginf": ([onp.float32([1, -onp.inf, onp.inf])], {}),
    "isposinf": ([onp.float32([1, -onp.inf, onp.inf])], {}),
    "kaiser": ([], {"M": 7, "beta": 5.0}), "lcm": ([I6, J6], {}),
    "ldexp": ([V6, I6], {}), "left_shift": ([I6, J6], {}),
    "median": ([A34], {"axis": 0}), "moveaxis": ([A34[None], 0, 2], {}),
    "nan_to_num": ([NANS], {"nan": 7.0}),
    "nanmax": ([NANS.reshape(2, 3)], {"axis": 1}),
    "nanmean": ([NANS], {}), "nanmin": ([NANS], {}),
    "nanprod": ([NANS.reshape(2, 3)], {"axis": 0}),
    "nanstd": ([NANS], {"ddof": 1}), "nansum": ([NANS], {}),
    "nanvar": ([NANS.reshape(3, 2)], {"axis": 0}),
    "percentile": ([A34], {"q": 30.0, "axis": 1, "keepdims": True}),
    "polyval": ([P3[:3], V6], {}), "ptp": ([A34], {"axis": 1}),
    "quantile": ([V6], {"q": 0.75}),
    "ravel_multi_index": ([onp.int32([[0, 1, 2], [3, 0, 1]]), (3, 4)], {}),
    "remainder": ([P3, W6 + 0.5], {}),
    "resize_array": ([V6, (3, 5)], {}), "right_shift": ([I6, J1], {}),
    "rollaxis": ([A34[None], 2], {"start": 1}),
    "searchsorted": ([SRT, V6], {"side": "right"}),
    "signbit": ([P3], {}), "trapz": ([A34], {"dx": 0.5}),
    "tri": ([], {"N": 3, "M": 4, "k": 1}),
    "trim_zeros": ([onp.float32([0, 0, 1, 2, 0, 3, 0])], {}),
    "unravel_index": ([onp.int32([1, 7, 11]), (3, 4)], {}),
    "unwrap": ([onp.float32([0.0, 3.0, 6.5, 0.5, 4.0])], {}),
    "vander": ([V6[:4]], {"N": 3}), "vstack": ([V6, W6], {}),
}

# the keyword arguments of the port's own mx.np functions, each through
# both mx.np's
I8 = I6.astype(onp.int8)
NANS23 = NANS.reshape(2, 3)
M23 = onp.array([[True, False, True], [True, True, False]])
KEYWORDS = [
    ("sum", (A34,), {"where": A34 > 0.5}),
    ("sum", (A34,), {"axis": 1, "initial": 1.5}),
    ("sum", (I6,), {"initial": 2, "where": BO}),
    ("sum", (I8,), {"promote_integers": False}),
    ("sum", (I6,), {"dtype": "int8"}),
    ("mean", (A34,), {"axis": 1, "where": A34 > 0.3}),
    ("mean", (I6,), {"where": BO}),
    ("max", (A34,), {"axis": 0, "where": A34 > 0.5, "initial": -1.0}),
    ("amax", (A34,), {"initial": 0.9}),
    ("min", (A34,), {"axis": 1, "where": A34 < 0.5, "initial": 2.0}),
    ("amin", (I6,), {"initial": 1}),
    ("nanmax", (NANS23,), {"axis": 1, "where": M23, "initial": -5.0}),
    ("nanmin", (NANS,), {"initial": -3.0}),
    ("nansum", (NANS23,), {"axis": 0, "where": M23, "initial": 1.0}),
    ("nanprod", (NANS,), {"where": BO, "initial": 2.0}),
    ("nanmean", (NANS23,), {"axis": 1, "where": M23}),
    ("nanvar", (NANS,), {"where": BO, "ddof": 1}),
    ("nanstd", (A34,), {"axis": 1, "keepdims": True,
                        "mean": A34.mean(1, keepdims=True)}),
    ("isin", (I6, J6), {"invert": True}),
    ("isin", (I6, J6), {"assume_unique": False, "method": "sort"}),
    ("intersect1d", (I6, J6), {"return_indices": True}),
    ("intersect1d", (onp.int32([3, 1, 2, 1]), onp.int32([1, 3, 5, 3])),
     {"return_indices": True}),
    ("nanpercentile", (NANS, 30.0), {"method": "lower"}),
    ("nanpercentile", (NANS, 30.0), {"method": "higher"}),
    ("nanpercentile", (NANS, 30.0), {"method": "midpoint"}),
    ("nanpercentile", (NANS, 30.0), {"method": "nearest"}),
    ("nanquantile", (NANS23, 0.4), {"axis": 1, "method": "nearest",
                                    "keepdims": True}),
    ("quantile", (A34, 0.3), {"axis": (0, 1), "method": "lower"}),
    ("quantile", (V6, 0.3), {"method": "nearest"}),
    ("percentile", (A34, onp.float32([10.0, 90.0])), {"axis": -1,
                                                      "method": "higher"}),
    ("median", (A34,), {"axis": 1, "keepdims": True}),
    ("nanmedian", (NANS23,), {"axis": 0}),
    ("cumulative_sum", (A34,), {"axis": 1, "include_initial": True}),
    ("cumulative_sum", (I6,), {"dtype": "float32"}),
    ("cumulative_prod", (V6,), {"include_initial": True}),
    ("nancumsum", (I6,), {"dtype": "float32"}),
    ("nancumsum", (I8,), {}),
    ("nancumprod", (NANS23,), {"axis": 1}),
    ("nanargmax", (NANS23,), {"keepdims": True}),
    ("nanargmin", (NANS23,), {"axis": 1, "keepdims": True}),
    ("choose", (onp.int32([0, 3, -1, 2, 1, 4]), [V6, W6, P3]),
     {"mode": "wrap"}),
    ("choose", (onp.int32([0, 3, -1, 2, 1, 4]), [V6, W6, P3]),
     {"mode": "clip"}),
    ("ravel_multi_index", ((onp.int32([0, 5, 2]), onp.int32([1, 1, 7])),
                           (3, 4)), {"mode": "wrap", "order": "F"}),
    ("ravel_multi_index", ((onp.int32([0, 5]), onp.int32([1, 9])), (3, 4)),
     {"mode": "clip"}),
    ("polyint", (P3[:3],), {"m": 2, "k": 3.0}),
    ("polyint", (P3[:3],), {"m": 2, "k": onp.float32([1.0, 2.0])}),
    ("unwrap", (onp.float32([0.0, 3.0, 6.5, 0.5, 4.0]), 4.0),
     {"period": 5.0}),
    ("unwrap", (A34 * 9.0,), {"axis": 0}),
    ("fill_diagonal", (A34, 2.0), {"inplace": False}),
    ("astype", (V6, "float32"), {"copy": True}),
]

# calls both mx.np's refuse, with the exception they raise; an array in
# the keywords goes in as an array of the package under test
RAISES = [
    ("sum", (A34,), {"out": B34}, NotImplementedError),
    ("add", (A34, B34), {"out": B34}, NotImplementedError),
    ("mean", (A34,), {"out": B34}, NotImplementedError),
    ("max", (A34,), {"where": A34 > 0.5}, ValueError),
    ("nanmax", (NANS,), {"where": BO}, ValueError),
    ("quantile", (A34, 0.3), {"method": "inverted_cdf"}, ValueError),
    ("median", (A34,), {"overwrite_input": True}, ValueError),
    ("isin", (I6, J6), {"method": "bogus"}, ValueError),
    ("choose", (onp.int32([0, 3]), [V6[:2], W6[:2]]), {}, ValueError),
    ("ravel_multi_index", ((onp.int32([0, 5]), onp.int32([1, 1])), (3, 4)),
     {}, ValueError),
    ("cumulative_sum", (A34,), {}, ValueError),
    ("fill_diagonal", (A34, 2.0), {}, NotImplementedError),
    ("partition", (V6, 2), {"kind": "introselect"}, TypeError),
]
