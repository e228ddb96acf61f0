"""Neural-net ops of the port: dense, convolution, pooling, batch norm,
activations, layer norm, embedding, dropout, softmax, gathers and
multi-head attention.

Counterpart of ``mxnet_tpu/ops/nn.py`` (and ``ops/core.py`` for
``embedding``, ``dot``, ``pick`` and ``take_along_axis``).  Ops are plain
functions on tensors.  What the JAX package leaves to XLA (matrix
products, convolutions, pooling windows, normalisation, elementwise
chains, the dense attention branch) is plain PyTorch here, through the
cuBLAS/cuDNN calls PyTorch makes; the flash branch runs the hand-written
CUDA kernel through ``flash_attention``.

Every op of the JAX module is registered for ``mx.nd`` at the end of
this module, and each name here is then the function the registry keeps
(``registry.register``): the plain function, or for the ops automatic
mixed precision rewrites (matrix products, normalisations, softmaxes,
losses) its ``amp_rewritten`` wrapper, which with amp off calls it after
one flag test.  So the Gluon layers, which call these names, pass the
same amp rewrite as ``mx.nd`` and pay no dispatch; the activations,
norms, resizes and losses that only ``mx.nd`` calls are plain PyTorch
here too.

Convolutions on the card run in ``torch.channels_last`` memory format
(the logical layout stays NCHW): 4-D inputs are made channels-last at the
conv, and the ops after it keep that format.  It is the faster layout of
the two for the bf16 ResNet-50 recipe on the H100 (``PERF.md`` §5); with
``mx.autotune`` on, a stored ``conv_layout`` winner of "NCHW" keeps a
convolution's input contiguous instead.  ``batch_norm`` takes the JAX
package's ``stat_dtype`` (the ``bn_stat_dtype`` site).  The
first conv on the card also turns on ``torch.backends.cudnn.benchmark``,
cuDNN's counterpart of XLA's own conv algorithm tuning: the first call at
each shape tunes.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from . import flash_attention as fa
from .registry import amp_rewritten, register

__all__ = ["fully_connected", "dot", "activation", "gelu", "layer_norm",
           "embedding", "dropout", "softmax", "log_softmax", "pick",
           "take_along_axis", "multi_head_attention", "convolution",
           "deconvolution", "pooling", "adaptive_avg_pooling", "batch_norm",
           "softmax_cross_entropy", "ctc_loss"]


def _inexact(x):
    """Integer inputs as float32, as ``jax.nn``'s functions promote them."""
    return x if x.is_floating_point() or x.is_complex() else x.to(
        torch.float32)


def gelu(x, approximate=True):
    # the JAX op defaults to the tanh approximation (jax.nn.gelu)
    return F.gelu(_inexact(x), approximate="tanh" if approximate else "none")


def relu(x):
    return torch.relu(x)


def sigmoid(x):
    return torch.sigmoid(x)


def log_sigmoid(x):
    return F.logsigmoid(_inexact(x))


def softrelu(x):
    return F.softplus(_inexact(x))


def softsign(x):
    return F.softsign(x)


def silu(x):
    return F.silu(x)


def mish(x):
    return F.mish(_inexact(x))


_ACTIVATIONS = {
    "relu": relu,
    "sigmoid": sigmoid,
    "tanh": torch.tanh,
    "softrelu": softrelu,
    "softsign": softsign,
    "log_sigmoid": log_sigmoid,
    "mish": mish,
    "gelu": gelu,
    "silu": silu,
}


def activation(data, act_type="relu"):
    """act_type dispatcher (the ``Activation`` op; ``ops/legacy.py``
    registers it under that name)."""
    try:
        fn = _ACTIVATIONS[act_type]
    except KeyError:
        raise MXNetError("Activation: unknown act_type %r" % (act_type,)) \
            from None
    return fn(data)


def _amp_pair(x, weight):
    """Mixed-precision alignment, as in the JAX package: when exactly one
    side is bf16 (the trainer casts weights, normalisation keeps f32), the
    product runs in bf16 with fp32 accumulation."""
    if x.dtype != weight.dtype and torch.bfloat16 in (x.dtype, weight.dtype):
        return x.to(torch.bfloat16), weight.to(torch.bfloat16)
    return x, weight


def _promote(*ts):
    """Cast to the common type, as JAX's ``dot_general`` promotes mixed
    operands (float32 x float16 -> float32) where ``F.linear`` would
    raise."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def fully_connected(x, weight, bias=None, num_hidden=None, flatten=True,
                    no_bias=False):
    """y = x @ W^T + b, weight layout (out, in).  Mixed dtypes follow the
    JAX op: one bf16 side takes both to bf16, others promote; the bias
    takes the product's dtype."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    x, weight = _promote(*_amp_pair(x, weight))
    if bias is None or no_bias:
        return F.linear(x, weight)
    return F.linear(x, weight, bias.to(x.dtype))


def dot(lhs, rhs):
    """lhs @ rhs (the last axis of lhs with the first of rhs) in the
    promoted dtype of the two, as the JAX ``dot`` op returns it."""
    lhs, rhs = _promote(lhs, rhs)
    return lhs @ rhs


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """(x - mean) / sqrt(var + eps) * gamma + beta over ``axis``."""
    m = x.mean(dim=axis, keepdim=True)
    v = x.var(dim=axis, keepdim=True, unbiased=False)
    out = (x - m) * torch.rsqrt(v + eps)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return out * gamma.reshape(shape) + beta.reshape(shape)


# a table of at most this many rows (token types, segment ids) takes its
# gradient as one matrix product with the one-hot indices: its runs of
# one row are long, and ``index_put_`` sums a run serially in one warp
_SMALL_TABLE = 64


def _sum_type(dtype):
    """The type ``index_put_`` sums in: float32 for a 16-bit gradient,
    whose ``index_put_`` rounds after every add of a run."""
    return torch.float32 if dtype in (torch.float16, torch.bfloat16) \
        else dtype


class _Embedding(torch.autograd.Function):
    """``F.embedding`` whose weight gradient sums each row's repeats in a
    fixed order, so a step gives the same bits run to run, as the JAX
    package's does: ``index_put_`` with ``accumulate=True`` (indices
    sorted, one pass over each row's run), or for a small table one
    matrix product with the one-hot indices.  PyTorch's own backward on
    the card reduces a long run of one row (BERT's 2-row token-type table
    takes B*T/2 repeats a row) in pieces added in no fixed order.  On the
    card only: on the CPU PyTorch's own backward is the fixed-order one,
    and ``index_put_`` adds from several threads.  A 16-bit gradient is
    summed in float32 (float64 for the one-hot product) and rounded once,
    as PyTorch's own backward sums it."""

    @staticmethod
    def forward(ctx, indices, weight):
        ctx.save_for_backward(indices)
        ctx.rows = weight.shape[0]
        return F.embedding(indices, weight)

    @staticmethod
    def backward(ctx, grad):
        indices, = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        if ctx.rows <= _SMALL_TABLE:
            # in float64: no TF32 or 16-bit reduction whatever the matmul
            # settings, one rounding to the gradient's dtype at the end
            hot = F.one_hot(indices.reshape(-1), ctx.rows).double()
            return None, (hot.t() @ g.double()).to(g.dtype)
        out = g.new_zeros((ctx.rows, g.shape[-1]), dtype=_sum_type(g.dtype))
        out.index_put_((indices.reshape(-1),), g.to(out.dtype),
                       accumulate=True)
        return None, out.to(g.dtype)


def embedding(indices, weight):
    indices = indices.long()
    if weight.is_cuda and weight.requires_grad and torch.is_grad_enabled():
        return _Embedding.apply(indices, weight)
    return F.embedding(indices, weight)


def dropout(x, p=0.5, generator=None, axes=None):
    """Inverted dropout: zero each element with probability ``p`` and scale
    the rest by 1/(1-p).  The mask is drawn from ``generator`` (on x's
    device; the port's ``random.generator``; inside a ``random.replayable``
    scope the draw is recorded or replayed); along ``axes`` it is shared.
    The caller decides whether it is training: this op always drops."""
    if p <= 0.0:
        return x
    keep = 1.0 - p
    like = x if not axes else x[tuple(slice(0, 1) if i in axes else
                                      slice(None) for i in range(x.dim()))]
    mask = _random.draw(lambda: torch.bernoulli(torch.full_like(like, keep),
                                                generator=generator))
    return x * mask / keep


def softmax(x, axis=-1, temperature=None, length=None):
    """Softmax over ``axis``; ``length`` (per leading index) masks the
    positions at and past it to -inf first."""
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if length is not None:
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        pos = torch.arange(x.shape[axis], device=x.device).reshape(shape)
        mask = pos < length.reshape(tuple(length.shape)
                                    + (1,) * (x.dim() - length.dim()))
        x = x.masked_fill(~mask, float("-inf"))
    return torch.softmax(_inexact(x), dim=axis)


def log_softmax(x, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return torch.log_softmax(_inexact(x), dim=axis)


def softmax_cross_entropy(logits, labels):
    """The summed negative log-likelihood of integer ``labels``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long().unsqueeze(-1)).sum()


def pick(x, index, axis=-1, keepdims=False):
    """x[..., index[...], ...] along ``axis`` (index has x's shape without
    that axis)."""
    out = torch.gather(x, axis, index.long().unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


class _TakeAlongAxis(torch.autograd.Function):
    """``torch.gather`` whose gradient sums repeated indices in a fixed
    order (``index_put_`` with ``accumulate=True``) where gather's own
    backward (``scatter_add_``) adds them atomically on the card: BERT's
    masked positions, drawn with replacement, repeat within a row.  On
    the card only, as ``_Embedding``.  Indices broadcast over every dim
    after ``axis`` (an ``expand``, as BERT's gather of whole positions)
    sum whole rows, one index a row; others one index an element."""

    @staticmethod
    def forward(ctx, x, indices, axis):
        ctx.save_for_backward(indices)
        ctx.shape, ctx.axis = x.shape, axis
        return torch.gather(x, axis, indices)

    @staticmethod
    def backward(ctx, grad):
        indices, = ctx.saved_tensors
        shape = ctx.shape
        axis = ctx.axis % len(shape)
        out = grad.new_zeros(shape, dtype=_sum_type(grad.dtype))
        rows = axis < len(shape) - 1 and all(
            indices.stride(d) == 0 for d in range(axis + 1, len(shape))) \
            and all(indices.shape[d] == shape[d]
                    for d in range(len(shape)) if d != axis)
        if rows:
            lead, n = math.prod(shape[:axis]), shape[axis]
            first = indices[(Ellipsis,) + (0,) * (len(shape) - 1 - axis)]
            at = torch.arange(lead, device=grad.device).view(-1, 1) * n \
                + first.reshape(lead, -1)
            out.view(lead * n, -1).index_put_(
                (at.reshape(-1),),
                grad.reshape(at.numel(), -1).to(out.dtype), accumulate=True)
            return out.to(grad.dtype), None, None
        where = []
        for d, n in enumerate(indices.shape):
            if d == axis:
                where.append(indices)
            else:
                view = [1] * indices.dim()
                view[d] = n
                where.append(torch.arange(n, device=grad.device).view(view)
                             .expand(indices.shape))
        out.index_put_(tuple(where), grad.to(out.dtype), accumulate=True)
        return out.to(grad.dtype), None, None


def take_along_axis(x, indices, axis):
    indices = indices.long()
    if x.is_cuda and x.requires_grad and torch.is_grad_enabled():
        return _TakeAlongAxis.apply(x, indices, axis)
    return torch.gather(x, axis, indices)


def multi_head_attention(q, k, v, num_heads=1, mask=None, scale=None,
                         causal=False, impl="auto", attn_dropout=0.0,
                         dropout_seed=None):
    """Batched SDPA over q, k, v of shape (B, T, H*D).

    impl: 'auto' | 'dense' | 'flash' (blockwise) | 'pallas' (the flash
    kernels; the name is kept from the JAX package, where that path is the
    Pallas kernels).  'auto' takes the kernels when ``use_flash`` says so,
    dropout included.  ``attn_dropout`` (with a 64-bit ``dropout_seed``:
    an int, or an int64 tensor on the inputs' device such as
    ``random.draw_seed(device)``, which no impl reads back to the host)
    drops attention probabilities after the softmax; every impl uses the
    kernels' mask (``dropout_keep_mask``)."""
    B, Tq, HD = q.shape
    Tk = k.shape[1]
    D = HD // num_heads
    qh = q.reshape(B, Tq, num_heads, D).transpose(1, 2)
    kh = k.reshape(B, Tk, num_heads, D).transpose(1, 2)
    vh = v.reshape(B, Tk, num_heads, D).transpose(1, 2)
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if attn_dropout > 0.0 and dropout_seed is None:
        raise MXNetError("attn_dropout > 0 requires dropout_seed (draw one "
                         "with mxnet_tpu_torch.random.draw_seed(device))")
    seed = 0 if dropout_seed is None else dropout_seed
    if impl == "auto":
        impl = "pallas" if fa.use_flash(Tq, Tk, D, mask is not None) \
            else "dense"
    if impl in ("pallas", "flash"):
        if mask is not None:
            raise MXNetError(
                "impl=%r does not support an arbitrary mask (only causal=); "
                "use impl='dense' or drop the mask" % impl)
        if impl == "pallas":
            out = fa.flash_attention(qh.contiguous(), kh.contiguous(),
                                     vh.contiguous(), causal, scale,
                                     dropout_p=attn_dropout, seed=seed)
        else:
            out = fa.blockwise_attention(qh, kh, vh, causal=causal,
                                         sm_scale=scale,
                                         dropout_p=attn_dropout, seed=seed)
        return out.transpose(1, 2).reshape(B, Tq, HD)
    if impl != "dense":
        raise MXNetError("unknown attention impl %r (have auto, dense, "
                         "flash, pallas)" % (impl,))
    scores = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * scale
    if causal:
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, -1e30)
    if mask is not None:
        scores = scores.masked_fill(~mask.bool(), -1e30)
    w = torch.softmax(scores, dim=-1).to(qh.dtype)
    if attn_dropout > 0.0:
        keep = fa.dropout_keep_mask(seed, B * num_heads, Tq, Tk,
                                    attn_dropout, q.device)
        w = w * keep.reshape(w.shape).to(w.dtype) / (1.0 - attn_dropout)
    out = torch.einsum("bhqk,bhkd->bhqd", w, vh)
    return out.transpose(1, 2).reshape(B, Tq, HD)


# ---- convolution and pooling ---------------------------------------------

# The card's conv memory format (see the module docstring); ``None`` keeps
# the input's own.
_CUDA_CONV_FORMAT = torch.channels_last


def _layout(nd, layout):
    """The default NC* layout of an ``nd``-dim input, or ``layout``."""
    return layout or {3: "NCW", 4: "NCHW", 5: "NCDHW"}[nd]


def _to_nc(x, layout):
    """``x`` in ``layout`` -> the N, C, spatial... order, and the
    permutation that undoes it (None when ``layout`` is already NC*)."""
    perm = [layout.index("N"), layout.index("C")] + [
        i for i, c in enumerate(layout) if c not in "NC"]
    if perm == list(range(x.dim())):
        return x, None
    back = [perm.index(i) for i in range(len(perm))]
    return x.permute(perm), back


def _from_nc(y, back):
    return y if back is None else y.permute(back)


def _card_format(x, weight=None, stride=None):
    """On the card, a 4-D conv input in the conv memory format, with
    cuDNN's algorithm tuning on.  A convolution (``weight`` given) asks
    the ``conv_layout`` autotune site first: a tuned "NCHW" keeps the
    input contiguous; off, cold or malformed, the hand-set format."""
    if x.is_cuda and x.dim() == 4 and _CUDA_CONV_FORMAT is not None:
        torch.backends.cudnn.benchmark = True
        if weight is not None and _tuned_conv_layout(x, weight,
                                                     stride) == "NCHW":
            return x.contiguous()
        return x.contiguous(memory_format=_CUDA_CONV_FORMAT)
    return x


def _tuned_conv_layout(x, weight, stride):
    """The ``conv_layout`` winner for a 2-D convolution ("NHWC", the
    hand-set channels-last, when autotune is off or cold)."""
    from .. import autotune as _at

    if not _at.is_enabled():
        return "NHWC"
    n, c, h, w = x.shape
    o, _i, kh, kw = weight.shape
    s0 = int(stride[0]) if stride else 1
    cfg = _at.lookup("conv_layout",
                     (n, c, h, w, o, kh, kw, s0, _dtype_name(x.dtype)),
                     "NHWC")
    if cfg not in ("NCHW", "NHWC"):
        _at.fallback("invalid_config")
        return "NHWC"
    return cfg


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def convolution(x, weight, bias=None, kernel=None, stride=None, dilate=None,
                pad=None, num_filter=None, num_group=1, no_bias=False,
                layout=None):
    """N-d convolution (1-, 2- or 3-D), weight layout (out, in/groups,
    *kernel); ``layout`` names x's axes (default NCW/NCHW/NCDHW).  Mixed
    dtypes follow ``fully_connected``; the bias takes the output's."""
    n = x.dim() - 2
    lay = _layout(x.dim(), layout)
    x, back = _to_nc(x, lay)
    x, weight = _promote(*_amp_pair(x, weight))
    b = None if bias is None or no_bias else bias.to(x.dtype)
    y = _CONV[n](_card_format(x, weight, stride), weight, b,
                 stride=tuple(stride) if stride else 1,
                 padding=tuple(pad) if pad else 0,
                 dilation=tuple(dilate) if dilate else 1, groups=num_group)
    return _from_nc(y, back)


def deconvolution(x, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=False, layout=None):
    """Transposed convolution, weight layout (in, out, *kernel), as the
    JAX package computes it: the gradient of a convolution whose
    dilated input is padded by ``pad`` on each side, so the output has
    (in - 1) * stride + 1 + 2 * pad - dilate * (k - 1) positions.  ``adj``
    is accepted and not used, and ``num_group`` must be 1, as there."""
    if num_group != 1:
        raise MXNetError("deconvolution: num_group=%d is not supported "
                         "(the JAX package's op does not group)" % num_group)
    n = x.dim() - 2
    lay = _layout(x.dim(), layout)
    x, back = _to_nc(x, lay)
    x, weight = _promote(x, weight)
    stride = tuple(stride) if stride else (1,) * n
    dilate = tuple(dilate) if dilate else (1,) * n
    pad = tuple(pad) if pad else (0,) * n
    k = weight.shape[2:]
    # lax.conv_transpose's explicit padding p is PyTorch's d*(k-1) - p;
    # past d*(k-1) the output grows by zero borders
    tpad = [d * (kk - 1) - p for d, kk, p in zip(dilate, k, pad)]
    y = _DECONV[n](_card_format(x), weight, stride=stride,
                   padding=tuple(max(t, 0) for t in tpad), dilation=dilate)
    grow = [max(-t, 0) for t in tpad]
    if any(grow):
        y = F.pad(y, [g for g in reversed(grow) for _ in (0, 1)])
    if bias is not None and not no_bias:
        y = y + bias.to(y.dtype).reshape((1, -1) + (1,) * n)
    return _from_nc(y, back)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_sum(x, kernel, stride, pad):
    """The sum over each window, zeros padded."""
    if x.dim() == 3:   # avg_pool1d has no divisor_override
        return F.avg_pool1d(x, kernel, stride, pad,
                            count_include_pad=True) * kernel[0]
    return _AVG_POOL[x.dim() - 2](x, kernel, stride, pad,
                                  count_include_pad=True, divisor_override=1)


def _pad_spatial(x, pad, value=0.0):
    return F.pad(x, [p for p in reversed(pad) for _ in (0, 1)], value=value)


def pooling(x, kernel=None, pool_type="max", stride=None, pad=None,
            global_pool=False, count_include_pad=True, layout=None):
    """Max, avg, sum or lp (p = 2) pooling over the spatial axes; max pads
    with -inf; avg divides by the window size, or with
    ``count_include_pad=False`` by the unpadded count; ``global_pool``
    takes the max or (any other type) the mean of every spatial axis."""
    n = x.dim() - 2
    x, back = _to_nc(x, _layout(x.dim(), layout))
    if global_pool:
        axes = tuple(range(2, x.dim()))
        y = (x.amax(dim=axes, keepdim=True) if pool_type == "max"
             else x.mean(dim=axes, keepdim=True))
        return _from_nc(y, back)
    kernel = tuple(kernel)
    stride = tuple(stride) if stride else (1,) * n
    pad = tuple(pad) if pad else (0,) * n
    # PyTorch's window ops pad by at most half the window; past that the
    # input is padded first
    inside = all(p <= k // 2 for p, k in zip(pad, kernel))
    nopad = (0,) * n
    if pool_type == "max":
        if not inside:
            x, pad = _pad_spatial(x, pad, float("-inf")), nopad
        y = _MAX_POOL[n](x, kernel, stride, pad)
    elif pool_type == "avg" and inside:
        y = _AVG_POOL[n](x, kernel, stride, pad,
                         count_include_pad=count_include_pad)
    elif pool_type == "avg":
        s = _window_sum(_pad_spatial(x, pad), kernel, stride, nopad)
        if count_include_pad:
            y = s / math.prod(kernel)
        else:
            ones = _pad_spatial(torch.ones_like(x[:1, :1]), pad)
            y = s / _window_sum(ones, kernel, stride, nopad)
    elif pool_type in ("sum", "lp"):
        if not inside:
            x, pad = _pad_spatial(x, pad), nopad
        y = (_window_sum(x, kernel, stride, pad) if pool_type == "sum"
             else torch.sqrt(_window_sum(x * x, kernel, stride, pad)))
    else:
        raise MXNetError("unknown pool_type %s" % pool_type)
    return _from_nc(y, back)


def adaptive_avg_pooling(x, output_size=1):
    """NCHW average pooling onto an ``output_size`` grid, with the JAX
    package's bins: [floor(i*H/oh), floor((i+1)*H/oh)) (PyTorch's
    adaptive pooling rounds the end up instead)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    N, C, H, W = x.shape
    oh, ow = output_size
    if H % oh == 0 and W % ow == 0:
        return x.reshape(N, C, oh, H // oh, ow, W // ow).mean(dim=(3, 5))
    hi = np.linspace(0, H, oh + 1, dtype=np.float32).astype(np.int32)
    wi = np.linspace(0, W, ow + 1, dtype=np.float32).astype(np.int32)
    rows = [torch.stack([x[:, :, hi[i]:hi[i + 1], wi[j]:wi[j + 1]]
                         .mean(dim=(2, 3)) for j in range(ow)], dim=-1)
            for i in range(oh)]
    return torch.stack(rows, dim=-2)


# ---- batch norm ------------------------------------------------------------


def _tuned_bn_stat_dtype(x, axis, stat_dtype):
    """The batch statistics' dtype: an explicit ``stat_dtype``, else the
    ``bn_stat_dtype`` autotune winner (a value measured bit-identical to
    float32 under the guard), else float32.  The reduction ``axis`` is in
    the key, as in the JAX package."""
    if stat_dtype is not None:
        return stat_dtype
    from .. import autotune as _at

    if not _at.is_enabled():
        return "float32"
    cfg = _at.lookup("bn_stat_dtype",
                     tuple(x.shape) + (int(axis), _dtype_name(x.dtype)),
                     "float32")
    if cfg not in ("float32", "bfloat16"):
        _at.fallback("invalid_config")
        return "float32"
    return cfg


def _dtype_name(dtype):
    """A torch dtype's numpy spelling ("float32"), as the autotune keys
    write it."""
    return str(dtype).replace("torch.", "")


def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               axis=1, training=False, stat_dtype=None):
    """Returns ``(out, new_moving_mean, new_moving_var)``.

    Training (and not ``use_global_stats``) normalises with the batch's
    mean and biased variance over every axis but ``axis`` and returns the
    moving statistics updated as ``moving * momentum + batch * (1 -
    momentum)`` (the biased variance: ``F.batch_norm``'s own update uses
    the unbiased one and weighs the batch by ``momentum``, so it is not
    called with running stats).  Otherwise it normalises with the moving
    statistics and returns them as they are.  The statistics and the
    normalisation are float32 whatever x's dtype (bf16 x with f32 gamma,
    beta and statistics under mixed precision); the output has x's
    dtype.  ``fix_gamma`` scales by one.

    ``stat_dtype`` (None: the ``bn_stat_dtype`` autotune site, default
    "float32") is the dtype the batch mean and variance are taken in; with
    "bfloat16", as in the JAX package, x is rounded to bf16, the mean and
    the biased variance are taken in float32 and rounded to bf16, and the
    normalisation runs in float32 on the unrounded x."""
    g = torch.ones_like(gamma) if fix_gamma else gamma
    moved = axis != 1 and axis != 1 - x.dim()
    if training and not use_global_stats and \
            _tuned_bn_stat_dtype(x, axis, stat_dtype) == "bfloat16":
        out, mean, var = _bn_bf16_stats(x, g, beta, axis, eps)
        with torch.no_grad():
            new_mean = moving_mean * momentum + \
                mean.to(moving_mean.dtype) * (1 - momentum)
            new_var = moving_var * momentum + \
                var.to(moving_var.dtype) * (1 - momentum)
        return out, new_mean, new_var
    if moved:
        x = x.movedim(axis, 1)
    if training and not use_global_stats:
        out, mean, invstd = torch.native_batch_norm(
            x, g, beta, None, None, True, 0.0, eps)
        with torch.no_grad():
            var = invstd.double().pow(-2).sub(eps).float()
            new_mean = moving_mean * momentum + \
                mean.to(moving_mean.dtype) * (1 - momentum)
            new_var = moving_var * momentum + \
                var.to(moving_var.dtype) * (1 - momentum)
    else:
        out = F.batch_norm(x, moving_mean, moving_var, g, beta,
                           training=False, eps=eps)
        new_mean, new_var = moving_mean, moving_var
    if moved:
        out = out.movedim(1, axis)
    return out, new_mean, new_var


def _bn_bf16_stats(x, g, beta, axis, eps):
    """Training batch norm with bf16 statistics (the JAX package's
    ``stat_dtype="bfloat16"``): -> (out, mean, biased variance)."""
    axis = axis % x.dim()
    dims = tuple(i for i in range(x.dim()) if i != axis)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    xf = x.float()
    xs = xf.to(torch.bfloat16).float()
    mean = xs.mean(dims).to(torch.bfloat16).float()
    var = xs.var(dims, unbiased=False).to(torch.bfloat16).float()
    inv = torch.rsqrt(var + eps)
    out = (xf - mean.reshape(shape)) * (g.float() * inv).reshape(shape) + \
        beta.float().reshape(shape)
    return out.to(x.dtype), mean, var


# ---- the ops only mx.nd calls ----------------------------------------------


def hard_sigmoid(x, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


def leaky_relu(x, slope=0.25):
    return torch.where(x >= 0, x, slope * x)


def prelu(x, gamma):
    return torch.where(x >= 0, x, gamma * x)


def elu(x, alpha=1.0):
    return torch.where(x >= 0, x, alpha * torch.expm1(x))


def selu(x):
    return F.selu(_inexact(x))


def softmin(x, axis=-1):
    return torch.softmax(-_inexact(x), dim=axis)


def _moments(x, dims):
    return (x.mean(dim=dims, keepdim=True),
            x.var(dim=dims, keepdim=True, unbiased=False))


def group_norm(x, gamma, beta, num_groups=1, eps=1e-5):
    """Normalise over each group of channels and the spatial axes (NC...
    layout), then scale and shift per channel."""
    N, C = x.shape[0], x.shape[1]
    spatial = tuple(x.shape[2:])
    xg = x.reshape((N, num_groups, C // num_groups) + spatial)
    m, v = _moments(xg, tuple(range(2, xg.dim())))
    out = ((xg - m) * torch.rsqrt(v + eps)).reshape(x.shape)
    shape = (1, C) + (1,) * len(spatial)
    return out * gamma.reshape(shape) + beta.reshape(shape)


def instance_norm(x, gamma, beta, eps=1e-5):
    m, v = _moments(x, tuple(range(2, x.dim())))
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    return (x - m) * torch.rsqrt(v + eps) * gamma.reshape(shape) + \
        beta.reshape(shape)


def rms_norm(x, gamma, axis=-1, eps=1e-6):
    xf = x.float()
    ms = (xf * xf).mean(dim=axis, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * gamma


def l2_normalization(x, eps=1e-10, mode="instance"):
    if mode == "instance":
        n = torch.sqrt((x * x).sum(dim=tuple(range(1, x.dim())),
                                   keepdim=True) + eps)
    elif mode == "channel":
        n = torch.sqrt((x * x).sum(dim=1, keepdim=True) + eps)
    else:
        n = torch.sqrt((x * x).sum() + eps)
    return x / n


def lrn(x, alpha=1e-4, beta=0.75, knorm=2, nsize=5):
    """Local response normalisation across channels (NC...)."""
    half = nsize // 2
    sq = F.pad(x * x, [0, 0] * (x.dim() - 2) + [half, half])
    s = sum(sq[:, i:i + x.shape[1]] for i in range(nsize))
    return x / torch.pow(knorm + alpha * s / nsize, beta)


def _dropout_op(x, seed=None, p=0.5, mode="training", axes=None):
    """The ``dropout`` op: ``dropout`` with a generator seeded by ``seed``
    (where the JAX op takes a key), or the port's generator of x's
    device."""
    gen = (_random.generator(x.device) if seed is None else
           torch.Generator(device=x.device).manual_seed(int(seed)))
    return dropout(x, p, gen, axes)


def upsampling(x, scale=2, sample_type="nearest"):
    if sample_type == "nearest":
        return x.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)


def bilinear_resize(x, height=None, width=None, align_corners=False):
    """Bilinear resize to (height, width) with half-pixel centres; a
    shrinking axis is antialiased, as ``jax.image.resize`` does."""
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False,
                         antialias=height < x.shape[2] or width < x.shape[3])


def smooth_l1(x, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * x * x,
                       torch.abs(x) - 0.5 / s2)


_CTC_NEG_INF = -1e30   # the JAX op's log of zero: finite, as there


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             blank_label="first"):
    """Connectionist temporal classification loss -> (B,) negative log
    likelihoods.

    data: (T, B, V) unnormalised activations; label: (B, L), padded past
    each label with -1 (or 0 with ``blank_label='first'``, where 0 is the
    blank).  ``blank_label`` 'first' makes class 0 the blank, 'last' class
    V-1.  Lengths missing are derived as the JAX op derives them: every
    frame; labels > 0 ('first') or >= 0 ('last').  The log-space alpha
    recursion over the extended label (blank, l1, blank, l2, ..., blank)
    is the JAX op's, step for step, with log(0) = -1e30: an alignment that
    cannot fit gives a finite loss of about 1e30 (where
    ``F.ctc_loss`` gives inf), and its gradient stays finite.  A padding
    label reads class V-1 (-1 wraps, as JAX's gather does); positions past
    each label's end never reach its loss."""
    T, B, V = data.shape
    logp = torch.log_softmax(data, dim=-1)
    blank = 0 if blank_label == "first" else V - 1
    L = label.shape[1]
    lab = label.long()
    dev = data.device
    if label_lengths is None:
        label_lengths = (lab > (0 if blank_label == "first" else -1)).sum(1)
    if data_lengths is None:
        data_lengths = torch.full((B,), T, dtype=torch.long, device=dev)
    S = 2 * L + 1
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lab
    ext = ext.remainder(V)
    pos = torch.arange(S, device=dev)
    skip = torch.cat([torch.zeros(B, 2, dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], dim=1) | (pos % 2 == 0)
    ninf = torch.tensor(_CTC_NEG_INF, dtype=logp.dtype, device=dev)
    emit = torch.gather(logp, 2, ext.unsqueeze(0).expand(T, B, S))
    alpha = torch.cat([emit[0, :, :2], ninf.expand(B, S - 2)], dim=1)
    alphas = [alpha]
    for t in range(1, T):
        a1 = torch.cat([ninf.expand(B, 1), alpha[:, :-1]], dim=1)
        a2 = torch.cat([ninf.expand(B, 2), alpha[:, :-2]], dim=1)
        a2 = torch.where(skip, ninf, a2)
        m = torch.maximum(alpha, torch.maximum(a1, a2))
        alpha = m + torch.log(torch.exp(alpha - m) + torch.exp(a1 - m)
                              + torch.exp(a2 - m)) + emit[t]
        alphas.append(alpha)
    alphas = torch.stack(alphas)                                # (T, B, S)
    t_end = (data_lengths.long() - 1).clamp(0, T - 1)
    alpha_T = alphas[t_end, torch.arange(B, device=dev)]         # (B, S)
    end = 2 * label_lengths.long()
    a_end = alpha_T.gather(1, end[:, None])[:, 0]
    a_end1 = alpha_T.gather(1, (end - 1).clamp(min=0)[:, None])[:, 0]
    m = torch.maximum(a_end, a_end1)
    return -(m + torch.log(torch.exp(a_end - m) + torch.exp(a_end1 - m)))


for _name, _fn, _n in (
        ("relu", relu, 1), ("sigmoid", sigmoid, 1),
        ("log_sigmoid", log_sigmoid, 1), ("softrelu", softrelu, 1),
        ("softsign", softsign, 1), ("hard_sigmoid", hard_sigmoid, 1),
        ("leaky_relu", leaky_relu, 1), ("prelu", prelu, 1),
        ("elu", elu, 1), ("selu", selu, 1), ("gelu", gelu, 1),
        ("silu", silu, 1), ("mish", mish, 1), ("softmax", softmax, 1),
        ("log_softmax", log_softmax, 1), ("softmin", softmin, 1),
        ("fully_connected", fully_connected, 1),
        ("convolution", convolution, 1), ("deconvolution", deconvolution, 1),
        ("pooling", pooling, 1),
        ("adaptive_avg_pooling", adaptive_avg_pooling, 1),
        ("batch_norm", batch_norm, 3), ("layer_norm", layer_norm, 1),
        ("group_norm", group_norm, 1), ("instance_norm", instance_norm, 1),
        ("rms_norm", rms_norm, 1), ("l2_normalization", l2_normalization, 1),
        ("lrn", lrn, 1), ("dropout", _dropout_op, 1),
        ("upsampling", upsampling, 1), ("bilinear_resize", bilinear_resize, 1),
        ("softmax_cross_entropy", softmax_cross_entropy, 1),
        ("smooth_l1", smooth_l1, 1), ("ctc_loss", ctc_loss, 1),
        ("multi_head_attention", multi_head_attention, 1)):
    # the module's name becomes the registered function: amp's rewrite of
    # the op (registry.amp_rewritten) then reaches the Gluon layers too
    globals()[_fn.__name__] = register(_name, num_outputs=_n)(_fn)
# ``dot`` is ``ops/core.py``'s op for ``mx.nd``; this one, which BERT's
# and the LMs' tied decoders call, takes the same rewrite
dot = amp_rewritten("dot", dot)
