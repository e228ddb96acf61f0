"""The reference's op names: the registry's tail to the full
``NNVM_REGISTER_OP`` universe, so that 1.x code finds every name.

Counterpart of ``mxnet_tpu/ops/parity.py``, with its tables and families:

1. **Aliases** (``ALIASES``): reference names that rename an op this
   registry holds (the CamelCase element-wise family, ``_linalg_*`` and
   ``_sample_*`` spellings, ``broadcast_*`` comparisons, 0.x
   ``max_axis``-style names).
2. **The scalar-operand family**: ``_plus_scalar``, ``_rdiv_scalar``...
   and their CamelCase names, one torch expression each.
3. **The tail ops**: init ops, the random-pdf family, functional
   slice/scatter assignment, ``split_v2``, ``make_loss``, the STE
   roundings, ``quadratic``, the gradient multiplier, group/sparse AdaGrad,
   the mp variants of the multi-tensor AdamW/LAMB/LANS updates (over
   ``contrib_tail``'s rules), the quantized-op tail (over
   ``quantization``'s ops), unique zipfian sampling, ``allclose`` and
   ``categorical``.

Imported last by ``ops/__init__.py``, so its aliases resolve against every
other module.  The draws (``categorical``, ``_sample_unique_zipfian``) come
from the port's generators, so they differ from the JAX package's.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, _as_torch_dtype
from ..context import current_context
from . import contrib_tail, core, nn, optimizer_ops  # noqa: F401 (dep order)
from .registry import alias, get_op, register

__all__ = []


# ---------------------------------------------------------------------------
# 1. pure aliases
# ---------------------------------------------------------------------------
# reference name -> existing registry name
ALIASES = {
    "_Plus": "broadcast_add", "_plus": "broadcast_add",
    "_add": "broadcast_add", "_grad_add": "broadcast_add",
    "_Minus": "broadcast_sub", "_minus": "broadcast_sub",
    "_sub": "broadcast_sub",
    "_Mul": "broadcast_mul", "_mul": "broadcast_mul",
    "_Div": "broadcast_div", "_div": "broadcast_div",
    "_Mod": "mod", "_mod": "mod",
    "_Power": "power", "_power": "power",
    "_Maximum": "maximum", "_maximum": "maximum",
    "_Minimum": "minimum", "_minimum": "minimum",
    "_Hypot": "hypot", "_hypot": "hypot",
    "_Equal": "equal", "_equal": "equal", "broadcast_equal": "equal",
    "_Not_Equal": "not_equal", "_not_equal": "not_equal",
    "broadcast_not_equal": "not_equal",
    "_Greater": "greater", "_greater": "greater",
    "broadcast_greater": "greater",
    "_Greater_Equal": "greater_equal", "_greater_equal": "greater_equal",
    "broadcast_greater_equal": "greater_equal",
    "_Lesser": "lesser", "_lesser": "lesser",
    "broadcast_lesser": "lesser",
    "_Lesser_Equal": "lesser_equal", "_lesser_equal": "lesser_equal",
    "broadcast_lesser_equal": "lesser_equal",
    "_Logical_And": "logical_and", "_logical_and": "logical_and",
    "broadcast_logical_and": "logical_and",
    "_Logical_Or": "logical_or", "_logical_or": "logical_or",
    "broadcast_logical_or": "logical_or",
    "_Logical_Xor": "logical_xor", "_logical_xor": "logical_xor",
    "broadcast_logical_xor": "logical_xor",
    "broadcast_maximum": "maximum", "broadcast_minimum": "minimum",
    "broadcast_hypot": "hypot", "broadcast_power": "power",
    "broadcast_mod": "mod",
    "broadcast_plus": "broadcast_add", "broadcast_minus": "broadcast_sub",
    "max_axis": "max", "min_axis": "min", "sum_axis": "sum",
    "ElementWiseSum": "add_n", "BlockGrad": "stop_gradient",
    "make_loss_legacy": "identity",
    "SoftmaxActivation": "softmax",
    "_copy": "identity", "_copyto": "identity",
    "choose_element_0index": "pick", "crop": "slice",
    "normal": "random_normal", "uniform": "random_uniform",
    "_histogram": "histogram", "_shuffle": "shuffle",
    "_unravel_index": "unravel_index",
    "_ravel_multi_index": "ravel_multi_index",
    "_rnn_param_concat": "concat",
    "_npi_rnn_param_concat": "concat",
    "batch_flatten": "flatten",
    "_contrib_AdaptiveAvgPooling2D": "adaptive_avg_pooling",
    "_contrib_BilinearResize2D": "bilinear_resize",
    "_contrib_box_non_maximum_suppression": "box_nms",
    "_contrib_ctc_loss": "ctc_loss",
    "_contrib_CTCLoss": "CTCLoss",
    "_random_uniform": "random_uniform",
    "_random_normal": "random_normal",
    "_random_exponential": "random_exponential",
    "_random_gamma": "random_gamma",
    "_random_poisson": "random_poisson",
    "_random_negative_binomial": "random_negative_binomial",
    "_random_generalized_negative_binomial":
        "random_generalized_negative_binomial",
    "_random_randint": "random_randint",
    "_random_uniform_like": "random_uniform_like",
    "_random_normal_like": "random_normal_like",
    "_sample_uniform": "sample_uniform",
    "_sample_normal": "sample_normal",
    "_sample_gamma": "sample_gamma",
    "_sample_exponential": "sample_exponential",
    "_sample_poisson": "sample_poisson",
    "_sample_negative_binomial": "sample_negative_binomial",
    "_sample_generalized_negative_binomial":
        "sample_generalized_negative_binomial",
    "_sample_multinomial": "sample_multinomial",
}

# the _linalg_* underscore names of the linalg_* ops
_LINALG = ["det", "extractdiag", "extracttrian", "gelqf", "gemm", "gemm2",
           "inverse", "makediag", "maketrian", "potrf", "potri", "slogdet",
           "sumlogdiag", "syevd", "syrk", "trmm", "trsm"]


def _try_alias(ref, ours):
    try:
        get_op(ref)
    except MXNetError:
        alias(ref, ours)


def _install_aliases():
    for la in _LINALG:
        ALIASES["_linalg_" + la] = "linalg_" + la
    for ref, ours in ALIASES.items():
        _try_alias(ref, ours)


# ---------------------------------------------------------------------------
# 2. the scalar-operand family
# ---------------------------------------------------------------------------
def _float(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def _with_scalar(x, s):
    """(x, s as a 0-dim tensor) under JAX's weak-type rule: a float scalar
    beside integers gives float32, else the scalar takes x's dtype."""
    dt = torch.float32 if isinstance(s, float) and not \
        x.is_floating_point() else x.dtype
    return x.to(dt), torch.tensor(s, dtype=dt, device=x.device)


_SCALAR_FAMILY = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(
        torch.full_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(torch.full_like(x, s), x),
    "_maximum_scalar": lambda x, s: torch.maximum(*_with_scalar(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(*_with_scalar(x, s)),
    # the scalar takes x's dtype first (an integer x truncates it), as
    # jnp.full_like gives it
    "_hypot_scalar": lambda x, s: torch.hypot(
        _float(x), _float(torch.full_like(x, s))),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
    "_logical_and_scalar": lambda x, s: ((x != 0) & bool(s)).to(x.dtype),
    "_logical_or_scalar": lambda x, s: ((x != 0) | bool(s)).to(x.dtype),
    "_logical_xor_scalar": lambda x, s: ((x != 0) ^ bool(s)).to(x.dtype),
}

_SCALAR_CAMEL = {
    "_PlusScalar": "_plus_scalar", "_MinusScalar": "_minus_scalar",
    "_RMinusScalar": "_rminus_scalar", "_MulScalar": "_mul_scalar",
    "_DivScalar": "_div_scalar", "_RDivScalar": "_rdiv_scalar",
    "_ModScalar": "_mod_scalar", "_RModScalar": "_rmod_scalar",
    "_PowerScalar": "_power_scalar", "_RPowerScalar": "_rpower_scalar",
    "_MaximumScalar": "_maximum_scalar", "_MinimumScalar": "_minimum_scalar",
    "_HypotScalar": "_hypot_scalar", "_EqualScalar": "_equal_scalar",
    "_NotEqualScalar": "_not_equal_scalar",
    "_GreaterScalar": "_greater_scalar",
    "_GreaterEqualScalar": "_greater_equal_scalar",
    "_LesserScalar": "_lesser_scalar",
    "_LesserEqualScalar": "_lesser_equal_scalar",
    "_LogicalAndScalar": "_logical_and_scalar",
    "_LogicalOrScalar": "_logical_or_scalar",
    "_LogicalXorScalar": "_logical_xor_scalar",
}


def _install_scalar_family():
    non_diff = {"_equal_scalar", "_not_equal_scalar", "_greater_scalar",
                "_greater_equal_scalar", "_lesser_scalar",
                "_lesser_equal_scalar", "_logical_and_scalar",
                "_logical_or_scalar", "_logical_xor_scalar"}
    for name, expr in _SCALAR_FAMILY.items():
        def fn(data, scalar=1.0, is_int=None, _e=expr, **_ignored):
            return _e(data, scalar)

        fn.__name__ = name
        register(name, differentiable=name not in non_diff)(fn)
    for camel, lower in _SCALAR_CAMEL.items():
        alias(camel, lower)


# ---------------------------------------------------------------------------
# 3. init ops: the shape is an attribute, the array lands on ``ctx``
# ---------------------------------------------------------------------------
def _shape(s):
    return (s,) if isinstance(s, int) else tuple(s)


def _on(arr, ctx):
    dev = (ctx if ctx is not None else current_context()).torch_device
    return torch.from_numpy(_np.ascontiguousarray(arr)).to(dev)


def _np_dtype(dtype):
    return _np.dtype(str(_as_torch_dtype(dtype)).replace("torch.", ""))


def _install_init_ops():
    @register("_zeros", differentiable=False)
    def _zeros(shape=(1,), dtype="float32", ctx=None, **_kw):
        return _on(_np.zeros(_shape(shape), _np_dtype(dtype)), ctx)

    @register("_ones", differentiable=False)
    def _ones(shape=(1,), dtype="float32", ctx=None, **_kw):
        return _on(_np.ones(_shape(shape), _np_dtype(dtype)), ctx)

    @register("_full", differentiable=False)
    def _full(shape=(1,), value=0.0, dtype="float32", ctx=None, **_kw):
        return _on(_np.full(_shape(shape), value, _np_dtype(dtype)), ctx)

    @register("_zeros_without_dtype", differentiable=False)
    def _zeros_without_dtype(shape=(1,), ctx=None, **_kw):
        return _on(_np.zeros(_shape(shape), _np.float32), ctx)

    @register("_arange", differentiable=False)
    def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
                ctx=None, **_kw):
        out = _np.arange(start, stop, step, _np_dtype(dtype))
        return _on(_np.repeat(out, repeat) if repeat > 1 else out, ctx)

    @register("_linspace", differentiable=False)
    def _linspace(start=0.0, stop=1.0, num=50, endpoint=True,
                  dtype="float32", ctx=None, **_kw):
        return _on(_np.linspace(start, stop, int(num), endpoint=endpoint,
                                dtype=_np_dtype(dtype)), ctx)

    @register("_eye", differentiable=False)
    def _eye(N=1, M=0, k=0, dtype="float32", ctx=None, **_kw):
        return _on(_np.eye(int(N), int(M) if M else None, int(k),
                           dtype=_np_dtype(dtype)), ctx)


# ---------------------------------------------------------------------------
# 4. the random-pdf family (log densities, ``is_log`` or not)
# ---------------------------------------------------------------------------
def _param_view(sample, parm):
    """A per-distribution parameter broadcast against the sample's
    trailing dims."""
    extra = sample.dim() - parm.dim()
    return parm.reshape(tuple(parm.shape) + (1,) * extra)


def _pdf(name, lpdf_fn):
    def fn(sample, *parms, is_log=False):
        views = [_param_view(sample, p) for p in parms]
        lp = lpdf_fn(sample, *views)
        return lp if is_log else torch.exp(lp)

    fn.__name__ = name
    register(name)(fn)


_lg = torch.lgamma


def _install_pdf_family():
    _pdf("_random_pdf_uniform",
         lambda x, lo, hi: -torch.log(hi - lo) * torch.ones_like(x))
    _pdf("_random_pdf_normal",
         lambda x, mu, sig: -0.5 * torch.square((x - mu) / sig)
         - torch.log(sig * _np.sqrt(2 * _np.pi)))
    # rate parameterization: a*log(b) + (a-1)log x - b x - lgamma(a)
    _pdf("_random_pdf_gamma",
         lambda x, a, b: a * torch.log(b) + (a - 1) * torch.log(x) - b * x
         - _lg(a))
    _pdf("_random_pdf_exponential",
         lambda x, lam: torch.log(lam) - lam * x)
    _pdf("_random_pdf_poisson",
         lambda x, lam: x * torch.log(lam) - lam - _lg(x + 1.0))
    # p is the failure probability
    _pdf("_random_pdf_negative_binomial",
         lambda x, k, p: _lg(x + k) - _lg(x + 1.0)
         - _lg(k) + k * torch.log(p) + x * torch.log(1 - p))

    def _gnb(x, mu, alpha):
        k = 1.0 / alpha
        p = 1.0 / (mu * alpha + 1.0)
        return (_lg(x + k) - _lg(x + 1.0) - _lg(k)
                + k * torch.log(p) + x * torch.log(1 - p))

    _pdf("_random_pdf_generalized_negative_binomial", _gnb)

    @register("_random_pdf_dirichlet")
    def _random_pdf_dirichlet(sample, alpha, is_log=False):
        """The sample carries a trailing event dim of k; alpha is
        params_shape + (k,), broadcast across the sample dims between."""
        extra = sample.dim() - alpha.dim()
        a = alpha.reshape(tuple(alpha.shape[:-1]) + (1,) * extra
                          + tuple(alpha.shape[-1:]))
        lp = torch.sum((a - 1.0) * torch.log(sample), dim=-1) \
            + _lg(torch.sum(a, dim=-1)) - torch.sum(_lg(a), dim=-1)
        return lp if is_log else torch.exp(lp)


# ---------------------------------------------------------------------------
# 5. functional slice/scatter assignment
# ---------------------------------------------------------------------------
def _grid(shape, begin, end, step=None, device=None):
    """Open-mesh index tensors of ``x[begin:end:step]`` (numpy's slice
    rules, negative steps included)."""
    step = step or [None] * len(begin)
    idx = []
    for i, n in enumerate(shape):
        if i < len(begin):
            s = step[i] if i < len(step) and step[i] not in (None, 0) else 1
            sl = slice(begin[i], end[i], s)
        else:
            sl = slice(None)
        idx.append(torch.arange(*sl.indices(n), device=device))
    return torch.meshgrid(*idx, indexing="ij")


def _install_assign_family():
    @register("_slice_assign")
    def _slice_assign(lhs, rhs, begin=(), end=(), step=None):
        """lhs with lhs[begin:end:step] = rhs, as a new array."""
        out = lhs.clone()
        out[_grid(lhs.shape, begin, end, step, lhs.device)] = rhs.to(
            lhs.dtype)
        return out

    @register("_slice_assign_scalar")
    def _slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=None):
        out = data.clone()
        out[_grid(data.shape, begin, end, step, data.device)] = scalar
        return out

    alias("_crop_assign", "_slice_assign")
    alias("_crop_assign_scalar", "_slice_assign_scalar")

    @register("_scatter_set_nd")
    def _scatter_set_nd(lhs, rhs, indices, shape=None):
        """lhs with lhs[indices] = rhs; ``indices`` (M, N) selects N cells
        across M axes."""
        out = lhs.clone()
        out[tuple(indices.long())] = rhs.to(lhs.dtype)
        return out

    @register("split_v2", num_outputs=lambda attrs: max(
        1, int(attrs.get("_num_outputs", attrs.get("sections", 1)))
        if not attrs.get("indices") else len(attrs["indices"]) + 1))
    def split_v2(data, indices=(), axis=0, squeeze_axis=False, sections=0,
                 **_kw):
        """numpy's split: ``sections`` equal parts, or at ``indices``."""
        if sections:
            if data.shape[axis] % int(sections):
                raise ValueError("array split does not result in an equal "
                                 "division")
            parts = torch.tensor_split(data, int(sections), dim=axis)
        else:
            parts = torch.tensor_split(data, list(indices), dim=axis)
        if squeeze_axis:
            parts = [p.squeeze(axis) for p in parts]
        return tuple(parts)

    alias("_split_v2", "split_v2")

    @register("broadcast_axis")
    def broadcast_axis(data, axis=(), size=(), **_kw):
        """Broadcast size-1 axes to the given sizes."""
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        sizes = (size,) if isinstance(size, int) else tuple(size)
        target = list(data.shape)
        for a, s in zip(axes, sizes):
            target[a] = s
        return torch.broadcast_to(data, tuple(target))

    alias("broadcast_axes", "broadcast_axis")


# ---------------------------------------------------------------------------
# 6. the misc tail
# ---------------------------------------------------------------------------
class _OnesGrad(torch.autograd.Function):
    """Identity forward; the gradient is ones (``make_loss``)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.ones_like(g)


class _ScaledGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scalar``."""

    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


def _install_misc():
    @register("make_loss")
    def make_loss(data):
        """Forward identity; the head gradient is ones, so a non-scalar
        "loss" backpropagates as if summed."""
        return _OnesGrad.apply(data)

    @register("_identity_with_attr_like_rhs")
    def _identity_with_attr_like_rhs(lhs, rhs):
        """lhs; rhs only lends its attributes (sparse-gradient plumbing)."""
        return lhs

    @register("_square_sum", differentiable=False)
    def _square_sum(data, axis=None, keepdims=False):
        """sum(x^2) over ``axis``."""
        sq = torch.square(data)
        if axis is None:
            out = sq.sum()
            return out.reshape((1,) * data.dim()) if keepdims else out
        return sq.sum(dim=axis, keepdim=keepdims)

    @register("_contrib_quadratic")
    def _contrib_quadratic(data, a=0.0, b=0.0, c=0.0):
        """a*x^2 + b*x + c."""
        return a * torch.square(data) + b * data + c

    alias("quadratic", "_contrib_quadratic")

    @register("_contrib_gradientmultiplier")
    def _contrib_gradientmultiplier(data, scalar=1.0):
        """Identity forward, gradient times ``scalar`` (the
        gradient-reversal trick when it is negative)."""
        return _ScaledGrad.apply(data, scalar)

    @register("_contrib_round_ste")
    def _contrib_round_ste(data):
        """round, with the straight-through gradient."""
        return data + (torch.round(data) - data).detach()

    @register("_contrib_sign_ste")
    def _contrib_sign_ste(data):
        return data + (torch.sign(data) - data).detach()

    @register("_contrib_dynamic_reshape", differentiable=False)
    def _contrib_dynamic_reshape(data, shape_like):
        """Reshape to the shape a tensor holds (read on the host)."""
        return data.reshape([int(v) for v in shape_like.reshape(-1).tolist()])

    @register("_contrib_allclose", differentiable=False)
    def _contrib_allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
        """1 if every |a-b| <= atol + rtol*|b|, else 0 (float32)."""
        return torch.all(torch.isclose(a, b, rtol=rtol, atol=atol,
                                       equal_nan=equal_nan)).to(
            torch.float32)

    alias("allclose", "_contrib_allclose")

    @register("_npx_constraint_check", differentiable=False)
    def _npx_constraint_check(data, msg="constraint violated"):
        """True, or raises ``msg`` when the boolean tensor holds a False
        (read on the host)."""
        if not bool(torch.all(data)):
            raise MXNetError(str(msg))
        return torch.tensor(True, device=data.device)

    alias("constraint_check", "_npx_constraint_check")

    @register("index_update")
    def index_update(data, indices, updates):
        """data with data[idx] = updates, as a new array; a 2-D
        ``indices`` holds one coordinate row per update."""
        idx = tuple(indices.long().T) if indices.dim() > 1 \
            else (indices.long(),)
        out = data.clone()
        out[idx] = updates.to(data.dtype)
        return out

    @register("categorical", differentiable=False)
    def categorical(logits, shape=None):
        """Class ids drawn from (batched) logits, by the Gumbel-max rule,
        from the port's generator of the logits' device."""
        batch = tuple(logits.shape[:-1])
        out_shape = batch if shape is None else _shape(shape)
        u = _gumbel_uniform(out_shape + (logits.shape[-1],), logits)
        g = -torch.log(-torch.log(u))
        return torch.argmax(logits + g, dim=-1).to(torch.int32)

    @register("_sample_unique_zipfian", differentiable=False,
              num_outputs=2)
    def _sample_unique_zipfian(range_max=1, shape=(1,)):
        """Unique log-uniform (zipfian) class draws per row, with each
        class's expected count (the sampled-softmax helper); a host numpy
        generator seeded from the port's host generator."""
        from .. import random as _random

        shp = _shape(shape)
        n_rows = 1 if len(shp) == 1 else int(shp[0])
        n = int(shp[-1])
        rs = _np.random.default_rng(_random.take_key())
        rows, counts = [], []
        log_range = _np.log(range_max + 1.0)
        for _r in range(n_rows):
            seen, out = {}, []
            num_tries = 0
            while len(out) < n:
                num_tries += 1
                v = int(_np.exp(rs.random() * log_range)) - 1
                v = min(max(v, 0), range_max - 1)
                if v not in seen:
                    seen[v] = True
                    out.append(v)
            rows.append(out)
            # the expected count of each sampled class over num_tries draws
            p = [-_np.expm1(num_tries * _np.log1p(
                -_np.log1p(1.0 / (c + 1.0)) / log_range)) for c in out]
            counts.append(p)
        samples = _np.asarray(rows, dtype=_np.int32).reshape(shp)
        cnt = _np.asarray(counts, dtype=_np.float32).reshape(shp)
        return _on(samples, None), _on(cnt, None)


def _gumbel_uniform(shape, like):
    """Uniform draws in (0, 1) of ``shape`` from the port's generator of
    ``like``'s device."""
    from .. import random as _random

    tiny = torch.finfo(torch.float32).tiny
    return _random.draw(lambda: torch.rand(
        shape, dtype=torch.float32, device=like.device,
        generator=_random.generator(like.device)).clamp(min=tiny))


# ---------------------------------------------------------------------------
# 7. the optimizer tail
# ---------------------------------------------------------------------------
def _clip(g, clip_gradient):
    if clip_gradient is not None and clip_gradient >= 0:
        return torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _install_optimizer_tail():
    @register("group_adagrad_update", differentiable=False, mutates=(2,))
    def group_adagrad_update(weight, grad, history, lr, rescale_grad=1.0,
                             clip_gradient=-1.0, epsilon=1e-5):
        """Group AdaGrad: the history gathers the MEAN square over the
        trailing dims of each row."""
        g = _clip(grad * rescale_grad, clip_gradient)
        axes = tuple(range(1, g.dim()))
        new_h = history + (torch.mean(torch.square(g), dim=axes,
                                      keepdim=True)
                           if axes else torch.square(g))
        new_w = weight - lr * g / (torch.sqrt(new_h) + epsilon)
        return new_w, new_h

    alias("_contrib_group_adagrad_update", "group_adagrad_update")

    @register("_sparse_adagrad_update", differentiable=False, mutates=(2,))
    def _sparse_adagrad_update(weight, grad, history, lr, epsilon=1e-7,
                               wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
        """AdaGrad with the reference's sparse-update rule on a dense
        gradient: rows whose gradient is all zero keep weight and
        history."""
        g = _clip(grad * rescale_grad, clip_gradient)
        live = torch.any(g != 0, dim=tuple(range(1, g.dim())),
                         keepdim=True) if g.dim() > 1 else (g != 0)
        new_h = torch.where(live, history + torch.square(g), history)
        step = lr * g / (torch.sqrt(new_h) + epsilon)
        new_w = torch.where(live, weight * (1.0 - lr * wd) - step, weight)
        return new_w, new_h

    def _mp_multi(base_fn, stride=5):
        """The mp variants interleave (w, g, mean, var, weight32): the
        rule runs on weight32 and the weights take its result cast."""
        def fn(*arrays, **attrs):
            n = len(arrays) // stride
            slim, orig = [], []
            for i in range(n):
                w, g, m, v, w32 = arrays[i * stride:(i + 1) * stride]
                slim.extend([w32, g, m, v])
                orig.append(w)
            attrs.pop("num_tensors", None)
            outs = base_fn(*slim, num_tensors=n, **attrs)
            new_w32 = outs[:n]
            states = outs[n:]
            final = [nw.to(orig[i].dtype) for i, nw in enumerate(new_w32)]
            return tuple(final) + tuple(states) + tuple(new_w32)

        return fn

    def _mp_meta(stride=5):
        def num_outputs(attrs):
            return int(attrs["num_tensors"])

        def mutates(attrs):
            n = int(attrs["num_tensors"])
            pos = []
            for i in range(n):
                pos.extend([i * stride + 2, i * stride + 3])
            for i in range(n):
                pos.append(i * stride + 4)
            return pos

        return num_outputs, mutates

    _no, _mut = _mp_meta()
    f = _mp_multi(contrib_tail._multi_lamb_fn)
    f.__name__ = "_multi_mp_lamb_update"
    register("_multi_mp_lamb_update", differentiable=False,
             num_outputs=_no, mutates=_mut)(f)
    f2 = _mp_multi(contrib_tail._multi_lans_fn)
    f2.__name__ = "_multi_mp_lans_update"
    register("_multi_mp_lans_update", differentiable=False,
             num_outputs=_no, mutates=_mut)(f2)

    def _multi_adamw(*arrays, lrs=None, wds=None, etas=None, beta1=0.9,
                     beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                     step_count=None, num_tensors=None, mp=False):
        """Multi-tensor AdamW: the trailing input is the shared
        rescale_grad tensor; a non-finite scale skips the whole
        update."""
        stride = 5 if mp else 4
        rescale = arrays[-1]
        arrays = arrays[:-1]
        n = len(arrays) // stride
        outs, states, w32outs = [], [], []
        for i in range(n):
            grp = arrays[i * stride:(i + 1) * stride]
            if mp:
                w, g, m, v, w32 = grp
            else:
                w, g, m, v = grp
                w32 = w.to(torch.float32)
            nw32, nm, nv = contrib_tail._adamw_math(
                w32, g.to(torch.float32), m, v, rescale, lrs[i], etas[i],
                beta1, beta2, epsilon, wds[i], clip_gradient)
            outs.append(nw32.to(w.dtype))
            states.extend([nm, nv])
            if mp:
                w32outs.append(nw32)
        return tuple(outs) + tuple(states) + tuple(w32outs)

    def _adamw_meta(stride):
        def num_outputs(attrs):
            return int(attrs["num_tensors"])

        def mutates(attrs):
            n = int(attrs["num_tensors"])
            pos = []
            for i in range(n):
                pos.extend([i * stride + 2, i * stride + 3])
            if stride == 5:
                for i in range(n):
                    pos.append(i * stride + 4)
            return pos

        return num_outputs, mutates

    _no4, _mut4 = _adamw_meta(4)

    def g4(*a, **kw):
        return _multi_adamw(*a, mp=False, **kw)

    g4.__name__ = "_multi_adamw_update"
    register("_multi_adamw_update", differentiable=False,
             num_outputs=_no4, mutates=_mut4)(g4)
    _no5, _mut5 = _adamw_meta(5)

    def g5(*a, **kw):
        return _multi_adamw(*a, mp=True, **kw)

    g5.__name__ = "_multi_mp_adamw_update"
    register("_multi_mp_adamw_update", differentiable=False,
             num_outputs=_no5, mutates=_mut5)(g5)


# ---------------------------------------------------------------------------
# 8. the quantized-op tail
# ---------------------------------------------------------------------------
def _amax(lo, hi):
    return torch.maximum(torch.abs(torch.as_tensor(lo)),
                         torch.abs(torch.as_tensor(hi)))


def _q127(x):
    return torch.clamp(torch.round(x), -127, 127)


def _calib_entropy_threshold(hist, bin_edges, num_quantized_bins=255):
    """The KL-divergence-optimal |threshold| of an |activation| histogram
    (the entropy calibration of the reference's calibrate.cc)."""
    hist = _np.asarray(hist, dtype=_np.float64)
    num_bins = len(hist)
    if num_bins < num_quantized_bins + 2:
        return float(bin_edges[-1])

    def smooth(d, eps=1e-4):
        # eps of mass moved onto the empty bins, so the KL stays finite
        is_zero = d == 0
        n_zero = is_zero.sum()
        n_nonzero = d.size - n_zero
        if n_nonzero == 0:
            return d
        eps1 = eps * float(n_zero) / float(n_nonzero)
        out = d.astype(_np.float64).copy()
        out[is_zero] = eps
        out[~is_zero] -= eps1
        return out

    best_kl = _np.inf
    best_thr = float(bin_edges[-1])
    for i in range(num_quantized_bins, num_bins + 1):
        ref = hist[:i].copy()
        ref[i - 1] += hist[i:].sum()     # the outliers clipped into the last
        p = ref / max(ref.sum(), 1e-12)
        chunks = _np.array_split(hist[:i], num_quantized_bins)
        q = _np.concatenate([
            _np.full(len(c), (c.sum() / max((c > 0).sum(), 1)) if
                     (c > 0).any() else 0.0) for c in chunks])
        q[hist[:i] == 0] = 0.0
        q = q / max(q.sum(), 1e-12)
        p, q = smooth(p), smooth(q)
        kl = float(_np.sum(p * _np.log(_np.maximum(p, 1e-12)
                                       / _np.maximum(q, 1e-12))))
        if kl < best_kl:
            best_kl = kl
            best_thr = float(bin_edges[i])
    return best_thr


def _install_quantized_tail():
    @register("quantized_pooling", differentiable=False, num_outputs=3)
    def quantized_pooling(data, min_range, max_range, kernel=(2, 2),
                          stride=None, pad=(0, 0), pool_type="max",
                          **kw):
        """Pooling straight on the int8 values (order-preserving: the range
        passes through)."""
        out = nn.pooling(data.to(torch.float32), kernel=kernel,
                         stride=stride, pad=pad, pool_type=pool_type, **kw)
        return _q127(out).to(data.dtype), min_range, max_range

    @register("quantized_act", differentiable=False, num_outputs=3)
    def quantized_act(data, min_range, max_range, act_type="relu"):
        """int8 relu (the reference has relu only)."""
        if act_type != "relu":
            raise MXNetError("quantized_act supports relu only (reference "
                             "quantized_activation.cc)")
        lo = torch.clamp(torch.as_tensor(min_range, dtype=torch.float32),
                         min=0.0)
        return torch.clamp(data, min=0), lo, max_range

    @register("quantized_flatten", differentiable=False, num_outputs=3)
    def quantized_flatten(data, min_range, max_range):
        return data.reshape(data.shape[0], -1), min_range, max_range

    @register("quantized_concat", differentiable=False, num_outputs=3)
    def quantized_concat(*args, num_args=None, dim=1):
        """Concat int8 inputs rescaled to the widest range."""
        n = len(args) // 3
        datas, mins, maxs = args[:n], args[n:2 * n], args[2 * n:]
        out_min = torch.minimum(*mins) if n > 1 else mins[0]
        out_max = torch.maximum(*maxs) if n > 1 else maxs[0]
        out_amax = _amax(out_min, out_max)
        parts = [_q127(d.to(torch.float32) * (_amax(mn, mx) / out_amax))
                 for d, mn, mx in zip(datas, mins, maxs)]
        return (torch.cat(parts, dim=dim).to(datas[0].dtype), out_min,
                out_max)

    @register("quantized_elemwise_add", differentiable=False, num_outputs=3)
    def quantized_elemwise_add(lhs, rhs, lhs_min, lhs_max, rhs_min,
                               rhs_max):
        """int8 add: f32 sum, requantized to the summed range."""
        ls = _amax(lhs_min, lhs_max) / 127.0
        rs = _amax(rhs_min, rhs_max) / 127.0
        f = lhs.to(torch.float32) * ls + rhs.to(torch.float32) * rs
        out_amax = torch.maximum(torch.abs(lhs_min) + torch.abs(rhs_min),
                                 torch.abs(lhs_max) + torch.abs(rhs_max))
        q = _q127(f * (127.0 / out_amax))
        return q.to(lhs.dtype), -out_amax, out_amax

    @register("quantized_elemwise_mul", differentiable=False, num_outputs=3)
    def quantized_elemwise_mul(lhs, rhs, lhs_min, lhs_max, rhs_min,
                               rhs_max):
        ls = _amax(lhs_min, lhs_max) / 127.0
        rs = _amax(rhs_min, rhs_max) / 127.0
        f = (lhs.to(torch.float32) * ls) * (rhs.to(torch.float32) * rs)
        out_amax = torch.clamp(_amax(lhs_min, lhs_max)
                               * _amax(rhs_min, rhs_max), min=1e-12)
        q = _q127(f * (127.0 / out_amax))
        return q.to(lhs.dtype), -out_amax, out_amax

    @register("quantized_embedding", differentiable=False, num_outputs=3)
    def quantized_embedding(data, weight_q, w_min, w_max, input_dim=None,
                            output_dim=None):
        """int8 embedding gather."""
        return weight_q[data.long()], w_min, w_max

    @register("quantized_batch_norm", differentiable=False, num_outputs=3)
    def quantized_batch_norm(data, gamma, beta, moving_mean, moving_var,
                             d_min, d_max, eps=1e-3, **_kw):
        """int8 batch norm folded to a per-channel affine, requantized
        (inference only)."""
        x = data.to(torch.float32) * (_amax(d_min, d_max) / 127.0)
        inv = gamma / torch.sqrt(moving_var + eps)
        shape = (1, -1) + (1,) * (data.dim() - 2)
        y = (x - moving_mean.reshape(shape)) * inv.reshape(shape) \
            + beta.reshape(shape)
        amax = torch.clamp(torch.max(torch.abs(y)), min=1e-12)
        return _q127(y * (127.0 / amax)).to(data.dtype), -amax, amax

    for ref, ours in {
            "_contrib_quantize": "quantize",
            "_contrib_quantize_v2": "quantize_v2",
            "_contrib_dequantize": "dequantize",
            "_contrib_requantize": "requantize",
            "_contrib_quantized_conv": "quantized_conv",
            "_contrib_quantized_fully_connected":
                "quantized_fully_connected",
            "_contrib_quantized_pooling": "quantized_pooling",
            "_contrib_quantized_act": "quantized_act",
            "_contrib_quantized_flatten": "quantized_flatten",
            "_contrib_quantized_concat": "quantized_concat",
            "_contrib_quantized_elemwise_add": "quantized_elemwise_add",
            "_contrib_quantized_elemwise_mul": "quantized_elemwise_mul",
            "_contrib_quantized_embedding": "quantized_embedding",
            "_contrib_quantized_batch_norm": "quantized_batch_norm",
    }.items():
        _try_alias(ref, ours)

    @register("_contrib_calibrate_entropy", differentiable=False,
              num_outputs=2)
    def _contrib_calibrate_entropy(hist, hist_edges, num_quantized_bins=255):
        """The KL-divergence threshold of a histogram: (-thr, thr)."""
        thr = _calib_entropy_threshold(hist.cpu().numpy(),
                                       hist_edges.cpu().numpy(),
                                       int(num_quantized_bins))
        return (torch.tensor(-thr, dtype=torch.float32, device=hist.device),
                torch.tensor(thr, dtype=torch.float32, device=hist.device))


def _install_misc_tail():
    bn = get_op("BatchNorm")

    @register("_contrib_BatchNormWithReLU",
              num_outputs=lambda attrs: 1 if not attrs.get(
                  "output_mean_var") else 3)
    def _contrib_BatchNormWithReLU(data, gamma, beta, moving_mean,
                                   moving_var, **attrs):
        """Batch norm with a fused ReLU, for name parity with 1.x graphs:
        the outputs of ``BatchNorm``, the first through a ReLU."""
        out = bn.fn(data, gamma, beta, moving_mean, moving_var, **attrs)
        if isinstance(out, tuple):
            return (torch.clamp(out[0], min=0),) + tuple(out[1:])
        return torch.clamp(out, min=0)

    @register("_npi_boolean_mask_assign_scalar")
    def _npi_boolean_mask_assign_scalar(data, mask, value=0.0):
        """data with data[mask] = scalar, as a new array."""
        m = mask.to(torch.bool)
        m = m.reshape(tuple(m.shape) + (1,) * (data.dim() - m.dim()))
        return torch.where(m, torch.tensor(value, dtype=data.dtype,
                                           device=data.device), data)

    @register("_npi_boolean_mask_assign_tensor")
    def _npi_boolean_mask_assign_tensor(data, mask, value):
        """data with data[mask] = value, broadcast over the masked region
        when it can be, else filled in mask order."""
        m = mask.to(torch.bool)
        mb = m.reshape(tuple(m.shape) + (1,) * (data.dim() - m.dim()))
        try:
            return torch.where(mb, value.to(data.dtype), data)
        except RuntimeError:
            out = data.clone()
            out[m] = value.to(data.dtype).reshape(out[m].shape)
            return out

    @register("cast_storage", differentiable=False)
    def cast_storage(data, stype="default"):
        """The registry's cast_storage: its arrays are dense, so this is
        the identity; sparse arrays convert through ``nd.sparse``."""
        return data

    @register("_sparse_retain", differentiable=False)
    def _sparse_retain(data, indices):
        """The dense form of sparse_retain: the given rows kept, the rest
        zero."""
        n = data.shape[0]
        idx = indices.long()
        idx = torch.where(idx < 0, idx + n, idx)
        keep = torch.zeros(n, dtype=torch.bool, device=data.device)
        keep[idx[(idx >= 0) & (idx < n)]] = True    # JAX drops the rest
        return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)),
                           data, torch.zeros_like(data))

    for like in ["exponential", "gamma", "poisson", "negative_binomial",
                 "generalized_negative_binomial"]:
        alias("_random_%s_like" % like, "random_%s_like" % like)
    alias("_contrib_MultiBoxTarget", "multibox_target")
    alias("_contrib_RROIAlign", "rroi_align")


_install_aliases()
_install_scalar_family()
_install_init_ops()
_install_pdf_family()
_install_assign_family()
_install_misc()
_install_optimizer_tail()
_install_quantized_tail()
_install_misc_tail()
