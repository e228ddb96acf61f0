"""The amp op classification over the port's registry.

Counterpart of ``mxnet_tpu/contrib/amp/lists.py``, with the same three
seed sets.  Every registered op has a category: a name in a seed set takes
that set's, any other the default of the family module that registered it
(``op.fn.__module__``), else ``passthrough``.  A name the port does not
register is simply not in the table.

Categories
----------
``target_dtype``  matrix products: float32 inputs compute in the target
                  dtype (bf16 or fp16)
``fp32``          numerically sensitive: bf16/fp16 inputs go back to
                  float32
``widest``        mixed-dtype element-wise: floating inputs promote to the
                  widest of them
``passthrough``   dtype-agnostic: run whatever arrives

``ops.registry.amp_rewritten`` applies the category of each op where it is
registered, so the ``mx.nd`` calls and the Gluon layers (which call the
``ops`` functions) pass the same rewrite.
"""
from __future__ import annotations

# matrix-product ops: run in the target dtype
TARGET_DTYPE_OPS = {
    "fully_connected", "convolution", "deconvolution", "dot", "batch_dot",
    "matmul", "einsum", "tensordot", "inner", "outer",
    "multi_head_attention", "linalg_gemm", "linalg_gemm2",
    "interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
    "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt",
    "khatri_rao", "deformable_convolution", "RNN",
}

# numerically sensitive ops: force f32 inputs
FP32_OPS = {
    "softmax", "log_softmax", "softmin", "softmax_cross_entropy", "exp",
    "expm1", "log", "log2", "log10", "log1p", "power", "rsqrt", "rcbrt",
    "reciprocal", "norm", "logsumexp", "batch_norm", "layer_norm",
    "group_norm", "instance_norm", "rms_norm", "l2_normalization",
    "lrn", "cumsum", "cumprod", "sum", "prod", "mean", "var", "std",
    "erfinv", "gamma", "gammaln", "digamma",
    "moments", "nanprod", "nansum", "ctc_loss", "make_loss",
    "smooth_l1", "logaddexp", "average", "median",
    "quantile", "percentile", "nanmean", "nanstd", "nanvar",
    "sigmoid", "log_sigmoid", "hard_sigmoid", "erf",
}

# mixed-input element-wise arithmetic: promote to the widest float dtype
WIDEST_OPS = {
    "add", "subtract", "multiply", "divide", "mod",
    "fmod", "remainder", "maximum", "minimum", "hypot",
    "where", "clip", "add_n", "floor_divide", "copysign", "ldexp",
    "arctan2", "interp",
}

# family-module defaults for everything not seeded above
_MODULE_DEFAULTS = {
    "optimizer_ops": "fp32",
    "linalg": "fp32",
    "random_ops": "passthrough",
    "quantization": "passthrough",
    "image_ops": "passthrough",
    "detection": "passthrough",
    "legacy": "passthrough",
    "core": "passthrough",
    "parity": "passthrough",
    "np_tail": "passthrough",
    "tensor_tail": "passthrough",
    "contrib_tail": "passthrough",
    "nn": "passthrough",
}

_cache = {"table": None, "n_names": 0, "warned": set()}


def category(name, module):
    """The category of the op called ``name`` whose function lives in
    ``module`` (a dotted module name)."""
    if name in TARGET_DTYPE_OPS:
        return "target_dtype"
    if name in FP32_OPS:
        return "fp32"
    if name in WIDEST_OPS:
        return "widest"
    return _MODULE_DEFAULTS.get(module.rsplit(".", 1)[-1], "passthrough")


def _build():
    from ...ops import registry

    table = {}
    for name in registry.list_ops():
        op = registry.get_op(name)
        table[name] = table.get(op.name) or category(op.name,
                                                     op.fn.__module__)
    return table


def classification():
    """{registry name: category} for every registered op, rebuilt when the
    number of registered names moves."""
    from ...ops import registry

    n = len(registry.list_ops())
    if _cache["table"] is None or n != _cache["n_names"]:
        _cache["table"] = _build()
        _cache["n_names"] = n
    return _cache["table"]


def category_of(name):
    """The category of one op; a name not registered logs once and runs
    passthrough."""
    cat = classification().get(name)
    if cat is None:
        if name not in _cache["warned"]:
            _cache["warned"].add(name)
            import logging

            logging.getLogger("mxnet_tpu_torch").warning(
                "amp: op %r is not in the generated classification; "
                "running passthrough (no dtype rewrite)", name)
        return "passthrough"
    return cat
