"""Neural-net ops of the serving and training slices: dense, activations,
layer norm, embedding, dropout, log-softmax, gathers and multi-head
attention.

Counterpart of ``mxnet_tpu/ops/nn.py`` (and ``ops/core.py`` for
``embedding``, ``dot``, ``pick`` and ``take_along_axis``).  Ops are plain functions on tensors.  What the JAX package
leaves to XLA (matrix products, elementwise chains, the dense attention
branch) is plain PyTorch here; the flash branch runs the hand-written CUDA
kernel through ``flash_attention``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import flash_attention as fa

__all__ = ["fully_connected", "dot", "activation", "gelu", "layer_norm",
           "embedding", "dropout", "log_softmax", "pick", "take_along_axis",
           "multi_head_attention"]


def gelu(x, approximate=True):
    # the JAX op defaults to the tanh approximation (jax.nn.gelu)
    return F.gelu(x, approximate="tanh" if approximate else "none")


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "log_sigmoid": F.logsigmoid,
    "mish": F.mish,
    "gelu": gelu,
    "silu": F.silu,
}


def activation(x, act_type="relu"):
    """act_type dispatcher (the ``Activation`` op)."""
    try:
        fn = _ACTIVATIONS[act_type]
    except KeyError:
        raise MXNetError("Activation: unknown act_type %r" % (act_type,)) \
            from None
    return fn(x)


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


def embedding(indices, weight):
    return F.embedding(indices.long(), weight)


def dropout(x, p=0.5, generator=None):
    """Inverted dropout: zero each element with probability ``p`` and scale
    the rest by 1/(1-p).  The mask is drawn from ``generator`` (on x's
    device; the port's ``random.generator``).  The caller decides whether
    it is training: this op always drops."""
    if p <= 0.0:
        return x
    keep = 1.0 - p
    mask = torch.bernoulli(torch.full_like(x, keep), generator=generator)
    return x * mask / keep


def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


def pick(x, index, axis=-1, keepdims=False):
    """x[..., index[...], ...] along ``axis`` (index has x's shape without
    that axis)."""
    out = torch.gather(x, axis, index.long().unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


def take_along_axis(x, indices, axis):
    return torch.gather(x, axis, indices.long())


def multi_head_attention(q, k, v, num_heads=1, mask=None, scale=None,
                         causal=False, impl="auto", attn_dropout=0.0,
                         dropout_seed=None):
    """Batched SDPA over q, k, v of shape (B, T, H*D).

    impl: 'auto' | 'dense' | 'flash' (blockwise) | 'pallas' (the flash
    kernels; the name is kept from the JAX package, where that path is the
    Pallas kernels).  'auto' takes the kernels when ``use_flash`` says so,
    dropout included.  ``attn_dropout`` (with a 64-bit ``dropout_seed``,
    e.g. ``random.take_key()``) drops attention probabilities after the
    softmax; every impl uses the kernels' mask (``dropout_keep_mask``)."""
    B, Tq, HD = q.shape
    Tk = k.shape[1]
    D = HD // num_heads
    qh = q.reshape(B, Tq, num_heads, D).transpose(1, 2)
    kh = k.reshape(B, Tk, num_heads, D).transpose(1, 2)
    vh = v.reshape(B, Tk, num_heads, D).transpose(1, 2)
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if attn_dropout > 0.0 and dropout_seed is None:
        raise MXNetError("attn_dropout > 0 requires dropout_seed (draw one "
                         "with mxnet_tpu_torch.random.take_key())")
    seed = dropout_seed or 0
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
