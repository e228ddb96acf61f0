"""The cases of the reference-name parity ops (``ops/parity.py``), as plain
numpy data: ``tests/test_torch_parity_ops.py`` runs each through both
packages on the CPU, and ``chip_smoke.py`` (phase ``nd_tail``) runs each
on the card against the port's CPU, so this file imports numpy only.

``CASES`` holds (name, positional arrays, keyword attributes), one or more
per op that ``parity.py`` registers under a name of its own, on float32
inputs with negative entries and on int32 inputs where the op takes them.
``ALIASES_OWN`` lists the names it registers as another name of one of
its own ops or of another module's (the same operator in both packages);
``DRAWS`` the ops whose results are draws (their tests inject the same
draws into both packages).
"""
import numpy as onp

rs = onp.random.RandomState(16)

F = onp.array([[-1.5, 0.25, 2.0], [3.0, -0.5, -8.0]], onp.float32)
I = onp.array([[-3, 1, 2], [4, 0, -8]], onp.int32)
P = (rs.rand(2, 3) + 0.5).astype(onp.float32)        # positive
Q = (rs.rand(2, 3) * 0.8 + 0.1).astype(onp.float32)  # in (0, 1)
W4 = rs.randn(4, 3).astype(onp.float32)
G4 = rs.randn(4, 3).astype(onp.float32)
H4 = rs.rand(4, 3).astype(onp.float32)
Q8 = onp.clip(onp.round(rs.randn(2, 3, 4, 4) * 40), -127, 127).astype(
    onp.int8)
R8 = onp.clip(onp.round(rs.randn(2, 3) * 40), -127, 127).astype(onp.int8)
MIN, MAX = onp.float32(-2.0), onp.float32(3.0)

_SCALARS = ["_plus_scalar", "_minus_scalar", "_rminus_scalar",
            "_mul_scalar", "_div_scalar", "_rdiv_scalar", "_mod_scalar",
            "_rmod_scalar", "_power_scalar", "_rpower_scalar",
            "_maximum_scalar", "_minimum_scalar", "_hypot_scalar",
            "_equal_scalar", "_not_equal_scalar", "_greater_scalar",
            "_greater_equal_scalar", "_lesser_scalar",
            "_lesser_equal_scalar", "_logical_and_scalar",
            "_logical_or_scalar", "_logical_xor_scalar"]
_NO_ZERO_I = onp.array([[-3, 1, 2], [4, 5, -8]], onp.int32)

CASES = []
for _n in _SCALARS:
    # integer division by a zero entry differs between the packages
    _i = _NO_ZERO_I if _n in ("_rdiv_scalar", "_rmod_scalar") else I
    _f = P if _n in ("_rpower_scalar",) else F
    CASES += [(_n, (_f,), {"scalar": 2.5}), (_n, (_i,), {"scalar": 2}),
              (_n, (_i,), {"scalar": 1.5})]
CASES = [c for c in CASES
         # an integer raised to a negative integer power is undefined
         if not (c[0] == "_rpower_scalar" and c[1][0].dtype.kind == "i")]

CASES += [
    ("_zeros", (), {"shape": (2, 3)}),
    ("_zeros", (), {"shape": 4, "dtype": "int32"}),
    ("_ones", (), {"shape": (3,), "dtype": "float32"}),
    ("_full", (), {"shape": (2, 2), "value": 1.5}),
    ("_zeros_without_dtype", (), {"shape": (2,)}),
    ("_arange", (), {"start": 1.0, "stop": 7.0, "step": 1.5}),
    ("_arange", (), {"start": 0, "stop": 5, "repeat": 2, "dtype": "int32"}),
    ("_linspace", (), {"start": -1.0, "stop": 1.0, "num": 7}),
    ("_linspace", (), {"start": 0.0, "stop": 1.0, "num": 4,
                       "endpoint": False}),
    ("_eye", (), {"N": 3, "M": 4, "k": 1}),
    ("_random_pdf_uniform", (Q, onp.float32([0.0, -1.0]),
                             onp.float32([1.0, 2.0])), {}),
    ("_random_pdf_normal", (F, onp.float32([0.5, -1.0]),
                            onp.float32([1.5, 2.0])), {"is_log": True}),
    ("_random_pdf_gamma", (P, onp.float32([2.0, 3.0]),
                           onp.float32([1.0, 0.5])), {}),
    ("_random_pdf_exponential", (P, onp.float32([2.0, 0.5])),
     {"is_log": True}),
    ("_random_pdf_poisson", (onp.float32([[0, 1, 4], [2, 3, 0]]),
                             onp.float32([1.5, 2.5])), {}),
    ("_random_pdf_negative_binomial", (onp.float32([[0, 1, 4], [2, 3, 0]]),
                                       onp.float32([2.0, 3.0]),
                                       onp.float32([0.4, 0.6])), {}),
    ("_random_pdf_generalized_negative_binomial",
     (onp.float32([[0, 1, 4], [2, 3, 0]]), onp.float32([1.5, 2.0]),
      onp.float32([0.5, 0.3])), {"is_log": True}),
    ("_random_pdf_dirichlet", (onp.float32([[[0.2, 0.3, 0.5]],
                                            [[0.6, 0.1, 0.3]]]),
                               onp.float32([[1.5, 2.0, 3.0],
                                            [0.8, 1.0, 2.0]])), {}),
    ("_slice_assign", (W4, onp.ones((2, 3), onp.float32)),
     {"begin": (1,), "end": (3,)}),
    ("_slice_assign", (W4, onp.ones((2, 3), onp.float32)),
     {"begin": (3, 2), "end": (None, None), "step": (-2, -1)}),
    ("_slice_assign_scalar", (I,), {"scalar": 7, "begin": (0, 1),
                                    "end": (2, 3)}),
    ("_scatter_set_nd", (W4, onp.float32([9.0, 8.0]),
                         onp.int32([[0, 3], [2, 1]])), {}),
    ("split_v2", (W4,), {"sections": 2}),
    ("split_v2", (I,), {"indices": (1, 2), "axis": 1}),
    ("split_v2", (W4,), {"indices": (1,), "axis": 0,
                         "squeeze_axis": False}),
    ("broadcast_axis", (onp.float32([[1.0], [2.0]]),),
     {"axis": 1, "size": 3}),
    ("broadcast_axis", (onp.int32([[[1]], [[2]]]),),
     {"axis": (1, 2), "size": (2, 3)}),
    ("make_loss", (F,), {}),
    ("_identity_with_attr_like_rhs", (F, P), {}),
    ("_square_sum", (F,), {"axis": 1}),
    ("_square_sum", (I,), {"axis": None, "keepdims": True}),
    ("_contrib_quadratic", (F,), {"a": 2.0, "b": -1.0, "c": 0.5}),
    ("_contrib_gradientmultiplier", (F,), {"scalar": -0.5}),
    ("_contrib_round_ste", (F,), {}),
    ("_contrib_sign_ste", (F,), {}),
    ("_contrib_dynamic_reshape", (F, onp.int32([3, 2])), {}),
    ("_contrib_allclose", (F, F + 1e-7), {}),
    ("_contrib_allclose", (F, P), {"rtol": 0.1, "atol": 0.0}),
    ("_npx_constraint_check", (onp.array([True, True]),), {}),
    ("index_update", (W4, onp.int32([[0, 1], [3, 2]]),
                      onp.float32([5.0, 6.0])), {}),
    ("index_update", (onp.arange(5, dtype=onp.int32), onp.int32([1, 3]),
                      onp.int32([10, 30])), {}),
    ("group_adagrad_update", (W4, G4, H4[:, :1]), {"lr": 0.1}),
    ("group_adagrad_update", (W4, G4, H4[:, :1]),
     {"lr": 0.1, "rescale_grad": 0.5, "clip_gradient": 0.3}),
    ("_sparse_adagrad_update",
     (W4, onp.where(onp.arange(4)[:, None] % 2 == 0, G4, 0.0).astype(
         onp.float32), H4), {"lr": 0.1, "wd": 0.01}),
    ("_multi_mp_lamb_update",
     (W4.astype(onp.float16), G4, H4 * 0.1, H4 * 0.01, W4,
      W4[:2].astype(onp.float16), G4[:2], H4[:2] * 0.1, H4[:2] * 0.01,
      W4[:2]),
     {"learning_rates": (0.01, 0.02), "wds": (0.0, 0.01),
      "step_count": (1, 2), "num_tensors": 2}),
    ("_multi_mp_lans_update",
     (W4.astype(onp.float16), G4, H4 * 0.1, H4 * 0.01, W4),
     {"learning_rates": (0.01,), "wds": (0.01,), "step_count": (3,),
      "num_tensors": 1}),
    ("_multi_adamw_update",
     (W4, G4, H4 * 0.1, H4 * 0.01, W4[:2], G4[:2], H4[:2] * 0.1,
      H4[:2] * 0.01, onp.float32([0.5])),
     {"lrs": (0.01, 0.02), "wds": (0.0, 0.01), "etas": (1.0, 0.5),
      "num_tensors": 2}),
    ("_multi_mp_adamw_update",
     (W4.astype(onp.float16), G4, H4 * 0.1, H4 * 0.01, W4,
      onp.float32([1.0])),
     {"lrs": (0.01,), "wds": (0.01,), "etas": (1.0,), "num_tensors": 1}),
    ("quantized_pooling", (Q8, MIN, MAX), {"kernel": (2, 2),
                                           "stride": (2, 2)}),
    ("quantized_pooling", (Q8, MIN, MAX), {"kernel": (2, 2),
                                           "pool_type": "avg"}),
    ("quantized_act", (R8, MIN, MAX), {}),
    ("quantized_flatten", (Q8, MIN, MAX), {}),
    ("quantized_concat", (R8, R8[::-1].copy(), MIN, onp.float32(-1.0),
                          MAX, onp.float32(5.0)), {"num_args": 2}),
    ("quantized_elemwise_add", (R8, R8[::-1].copy(), MIN, MAX,
                                onp.float32(-1.0), onp.float32(5.0)), {}),
    ("quantized_elemwise_mul", (R8, R8[::-1].copy(), MIN, MAX,
                                onp.float32(-1.0), onp.float32(5.0)), {}),
    ("quantized_embedding", (onp.int32([[0, 1], [1, 1]]), R8, MIN, MAX),
     {}),
    ("quantized_batch_norm", (Q8[:, :3], onp.float32([1.0, 0.5, 2.0]),
                              onp.float32([0.1, -0.2, 0.0]),
                              onp.float32([0.0, 1.0, -1.0]),
                              onp.float32([1.0, 2.0, 0.5]), MIN, MAX), {}),
    ("_contrib_calibrate_entropy",
     (onp.abs(rs.randn(300)).astype(onp.float32) * 10,
      onp.linspace(0, 3, 301).astype(onp.float32)),
     {"num_quantized_bins": 31}),
    ("_contrib_BatchNormWithReLU",
     (rs.randn(2, 3, 2, 2).astype(onp.float32), onp.float32([1.0, 0.5, 2.0]),
      onp.float32([0.1, -0.2, 0.0]), onp.float32([0.0, 1.0, -1.0]),
      onp.float32([1.0, 2.0, 0.5])), {}),
    ("_npi_boolean_mask_assign_scalar",
     (F, onp.array([[True, False, True], [False, True, False]])),
     {"value": 4.0}),
    ("_npi_boolean_mask_assign_scalar",
     (I, onp.array([True, False])), {"value": 9}),
    ("_npi_boolean_mask_assign_tensor",
     (F, onp.array([[True, False, True], [False, True, False]]),
      onp.float32([7.0])), {}),
    ("cast_storage", (F,), {"stype": "row_sparse"}),
    ("_sparse_retain", (W4, onp.int32([1, 3])), {}),
    ("_sparse_retain", (I, onp.int32([0])), {}),
]

# names parity.py registers as another name of an op: (name, op)
ALIASES_OWN = [
    ("_crop_assign", "_slice_assign"),
    ("_crop_assign_scalar", "_slice_assign_scalar"),
    ("_split_v2", "split_v2"), ("broadcast_axes", "broadcast_axis"),
    ("quadratic", "_contrib_quadratic"), ("allclose", "_contrib_allclose"),
    ("constraint_check", "_npx_constraint_check"),
    ("_contrib_group_adagrad_update", "group_adagrad_update"),
    ("_contrib_MultiBoxTarget", "multibox_target"),
    ("_contrib_RROIAlign", "rroi_align"),
]

# ops whose results are draws
DRAWS = ["categorical", "_sample_unique_zipfian"]
