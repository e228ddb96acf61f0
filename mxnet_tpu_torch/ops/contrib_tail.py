"""Contrib op long tail: AdamW, multi-LAMB/LANS, count_sketch, fft, index
ops, SyncBatchNorm on one device, the Hawkes log-likelihood, deformable
convolution and GluonNLP's interleaved attention matmuls.

Counterpart of ``mxnet_tpu/ops/contrib_tail.py``, with its semantics:

- adamw takes ``rescale_grad`` as a TENSOR; when it is not finite the
  whole update is skipped (the amp grad-scaler contract), decided on the
  device with no read-back;
- multi_lamb/multi_lans take interleaved (weight, grad, mean, var) groups
  with per-tensor learning rates, wds and step counts;
- fft returns the reference's interleaved real/imag layout (..., 2n);
- the interleaved matmuls take (T, B, 3*H*D) with q, k and v interleaved
  per head (and (Tk, B, 2*H*D) for the encoder-decoder keys/values), as
  GluonNLP 0.x's BERT feeds them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import alias, register


# ---------------------------------------------------------------------------
# AdamW (decoupled weight decay)
# ---------------------------------------------------------------------------
def _adamw_math(w32, grad, mean, var, rescale, lr, eta, beta1, beta2,
                epsilon, wd, clip_gradient):
    scale = torch.as_tensor(rescale, dtype=torch.float32,
                            device=w32.device).reshape(())
    ok = torch.isfinite(scale)
    g = grad.to(torch.float32) * torch.where(ok, scale,
                                             torch.zeros_like(scale))
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * g * g
    step = lr * new_mean / (torch.sqrt(new_var) + epsilon) + wd * w32
    new_w = w32 - eta * step
    # a non-finite scale makes the whole update a no-op
    return (torch.where(ok, new_w, w32), torch.where(ok, new_mean, mean),
            torch.where(ok, new_var, var))


@register("adamw_update", differentiable=False, mutates=(2, 3))
def adamw_update(weight, grad, mean, var, rescale_grad, lr, eta=1.0,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                 clip_gradient=-1.0):
    """W -= eta * (lr * m / (sqrt(v) + eps) + wd * W)."""
    return _adamw_math(weight, grad, mean, var, rescale_grad, lr, eta,
                       beta1, beta2, epsilon, wd, clip_gradient)


@register("mp_adamw_update", differentiable=False, mutates=(2, 3, 5))
def mp_adamw_update(weight, grad, mean, var, rescale_grad, weight32, lr,
                    eta=1.0, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                    clip_gradient=-1.0):
    """Low-precision weights with a float32 master copy."""
    new_w32, new_mean, new_var = _adamw_math(
        weight32, grad, mean, var, rescale_grad, lr, eta, beta1, beta2,
        epsilon, wd, clip_gradient)
    return new_w32.to(weight.dtype), new_mean, new_var, new_w32


alias("_adamw_update", "adamw_update")
alias("_mp_adamw_update", "mp_adamw_update")


# ---------------------------------------------------------------------------
# multi-tensor LAMB / LANS — multi_lamb.cc / multi_lans.cc
# ---------------------------------------------------------------------------
def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x.to(torch.float32))))


def _trust(lr, w_norm, d_norm, lower_bound, upper_bound):
    r1 = w_norm
    if lower_bound is not None and lower_bound >= 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound is not None and upper_bound >= 0:
        r1 = torch.clamp(r1, max=upper_bound)
    ratio = torch.where((r1 > 0) & (d_norm > 0), r1 / d_norm,
                        torch.ones_like(d_norm))
    return lr * ratio


def _multi_lamb_fn(*arrays, learning_rates=None, wds=None, step_count=None,
                   beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
                   lower_bound=-1.0, upper_bound=-1.0, clip_gradient=-1.0,
                   bias_correction=True, num_tensors=None):
    """Fused multi-tensor LAMB [multi_lamb.cc:174]: interleaved
    (weight, grad, mean, var) groups, per-tensor lr/wd/step."""
    n = len(arrays) // 4
    outs, states = [], []
    for i in range(n):
        w, g, m, v = arrays[i * 4:(i + 1) * 4]
        wf = w.to(torch.float32)
        gf = g.to(torch.float32) * rescale_grad
        if clip_gradient is not None and clip_gradient >= 0:
            gf = torch.clamp(gf, -clip_gradient, clip_gradient)
        nm = beta1 * m + (1.0 - beta1) * gf
        nv = beta2 * v + (1.0 - beta2) * gf * gf
        t = step_count[i] if step_count else 1
        if bias_correction:
            mh = nm / (1.0 - beta1 ** t)
            vh = nv / (1.0 - beta2 ** t)
        else:
            mh, vh = nm, nv
        d = mh / (torch.sqrt(vh) + epsilon) + wds[i] * wf
        lr = _trust(learning_rates[i], _norm(wf), _norm(d), lower_bound,
                    upper_bound)
        outs.append((wf - lr * d).to(w.dtype))
        states.extend([nm, nv])
    return tuple(outs) + tuple(states)


def _multi_lans_fn(*arrays, learning_rates=None, wds=None, step_count=None,
                   beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
                   lower_bound=-1.0, upper_bound=-1.0, clip_gradient=-1.0,
                   bias_correction=True, num_tensors=None):
    """Fused multi-tensor LANS [multi_lans.cc:190; Zheng et al. 2020]:
    LAMB plus a normalized-gradient term — each tensor's grad is first
    scaled by 1/||g||, and the update blends the adam direction (weight
    beta1) with the raw normalized gradient direction (weight 1-beta1),
    each with its own trust ratio."""
    n = len(arrays) // 4
    outs, states = [], []
    for i in range(n):
        w, g, m, v = arrays[i * 4:(i + 1) * 4]
        wf = w.to(torch.float32)
        gf = g.to(torch.float32) * rescale_grad
        gf = gf / torch.clamp(_norm(gf), min=1e-12)
        if clip_gradient is not None and clip_gradient >= 0:
            gf = torch.clamp(gf, -clip_gradient, clip_gradient)
        nm = beta1 * m + (1.0 - beta1) * gf
        nv = beta2 * v + (1.0 - beta2) * gf * gf
        t = step_count[i] if step_count else 1
        if bias_correction:
            mh = nm / (1.0 - beta1 ** t)
            vh = nv / (1.0 - beta2 ** t)
        else:
            mh, vh = nm, nv
        w_norm = _norm(wf)
        denom = torch.sqrt(vh) + epsilon
        d_adam = mh / denom + wds[i] * wf
        d_grad = gf / denom + wds[i] * wf
        lr_adam = _trust(learning_rates[i], w_norm, _norm(d_adam),
                         lower_bound, upper_bound)
        lr_grad = _trust(learning_rates[i], w_norm, _norm(d_grad),
                         lower_bound, upper_bound)
        new_w = wf - beta1 * lr_adam * d_adam \
            - (1.0 - beta1) * lr_grad * d_grad
        outs.append(new_w.to(w.dtype))
        states.extend([nm, nv])
    return tuple(outs) + tuple(states)


def _multi4_meta(stride=4):
    def num_outputs(attrs):
        return int(attrs["num_tensors"])

    def mutates(attrs):
        n = int(attrs["num_tensors"])
        pos = []
        for i in range(n):
            pos.extend([i * stride + 2, i * stride + 3])
        return pos

    return num_outputs, mutates


_no, _mut = _multi4_meta()
_multi_lamb_fn.__name__ = "multi_lamb_update"
_multi_lans_fn.__name__ = "multi_lans_update"
register("multi_lamb_update", num_outputs=_no, differentiable=False,
         mutates=_mut)(_multi_lamb_fn)
register("multi_lans_update", num_outputs=_no, differentiable=False,
         mutates=_mut)(_multi_lans_fn)
alias("_multi_lamb_update", "multi_lamb_update")
alias("_multi_lans_update", "multi_lans_update")


# ---------------------------------------------------------------------------
# count_sketch / fft
# ---------------------------------------------------------------------------
@register("count_sketch")
def count_sketch(data, h, s, out_dim=None, processing_batch_size=32):
    """out[b, h[i]] += s[i] * data[b, i] (Compact Bilinear Pooling's
    sketch)."""
    hh = h.reshape(-1).long()
    ss = s.reshape(-1).to(data.dtype)
    out = torch.zeros((data.shape[0], int(out_dim)), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, hh, data * ss[None, :])


@register("fft")
def fft(data, compute_size=128):
    """FFT over the last axis, real and imaginary parts interleaved:
    (..., n) -> (..., 2n) float32."""
    f = torch.fft.fft(data.to(torch.float32), dim=-1)
    return torch.stack([f.real, f.imag], dim=-1).reshape(
        data.shape[:-1] + (2 * data.shape[-1],))


@register("ifft")
def ifft(data, compute_size=128):
    """The inverse of ``fft``'s layout, unnormalized: (..., 2n) -> real
    (..., n), n times numpy's ifft."""
    n = data.shape[-1] // 2
    c = data.to(torch.float32).reshape(data.shape[:-1] + (n, 2))
    z = torch.complex(c[..., 0], c[..., 1])
    return torch.fft.ifft(z, dim=-1).real * n


# ---------------------------------------------------------------------------
# index ops
# ---------------------------------------------------------------------------
@register("index_copy")
def index_copy(old_tensor, index_vector, new_tensor):
    """old[index[i]] = new[i]."""
    return old_tensor.index_copy(0, index_vector.long(),
                                 new_tensor.to(old_tensor.dtype))


@register("index_add")
def index_add(data, indices, updates):
    """data[indices[i]] += updates[i] (repeated indices accumulate)."""
    return data.index_add(0, indices.long(), updates.to(data.dtype))


# ---------------------------------------------------------------------------
# SyncBatchNorm
# ---------------------------------------------------------------------------
@register("sync_batch_norm", num_outputs=3)
def sync_batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-3,
                    momentum=0.9, fix_gamma=True, use_global_stats=False,
                    axis_name=None, ndev=1, key=None):
    """BatchNorm whose statistics span every device of the batch.  On
    one device the batch's own statistics are the synchronized ones;
    ``axis_name`` (the JAX package's mesh axis) has no counterpart here
    and raises."""
    if axis_name:
        raise MXNetError("sync_batch_norm: axis_name=%r names a JAX mesh "
                         "axis; the port synchronizes one device only"
                         % (axis_name,))
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    if use_global_stats:
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
    else:
        axes = (0,) + tuple(range(2, x.dim()))
        mean = x.mean(dim=axes)
        var = torch.square(x).mean(dim=axes) - torch.square(mean)
        new_mm = momentum * moving_mean + (1.0 - momentum) * mean
        new_mv = momentum * moving_var + (1.0 - momentum) * var
    shape = (1, -1) + (1,) * (x.dim() - 2)
    out = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
    return out * gamma.reshape(shape) + beta.reshape(shape), new_mm, new_mv


alias("_contrib_SyncBatchNorm", "sync_batch_norm")
alias("SyncBatchNorm", "sync_batch_norm")


# ---------------------------------------------------------------------------
# Hawkes process log-likelihood
# ---------------------------------------------------------------------------
@register("hawkes_ll", num_outputs=2)
def hawkes_ll(lda, alpha, beta, state, lags, marks, valid_length, max_time):
    """Joint log likelihood of K univariate Hawkes processes.

    lda (N,K) background intensity, alpha/beta (K,), state (N,K) the
    carried exp-decay memory, lags/marks (N,T) left-aligned ragged
    sequences, valid_length/max_time (N,).  Returns (ll (N,), new_state
    (N,K)).  One step of the recursion a time step, all N rows at once;
    differentiable in lda, alpha, beta and state."""
    N, T = lags.shape
    K = lda.shape[1]
    f32 = torch.float32
    mu = lda.to(f32)
    s = state.to(f32)
    lags = lags.to(f32)
    marks = marks.long()
    rows = torch.arange(N, device=lda.device)
    last = torch.zeros((N, K), dtype=f32, device=lda.device)
    t = torch.zeros(N, dtype=f32, device=lda.device)
    ll = torch.zeros(N, dtype=f32, device=lda.device)
    zero = torch.zeros_like(ll)
    for j in range(T):
        ci = marks[:, j]
        t2 = t + lags[:, j]
        d = t2 - last[rows, ci]
        a, b = alpha[ci], beta[ci]
        ed = torch.exp(-b * d)
        sc, mc = s[rows, ci], mu[rows, ci]
        lam = mc + a * b * sc * ed
        comp = mc * d + a * sc * (1.0 - ed)
        valid = j < valid_length
        ll = ll + torch.where(valid, torch.log(lam) - comp, zero)
        oh = F.one_hot(ci, K).to(f32)
        v = valid[:, None]
        s = torch.where(v, s * (1 - oh) + oh * (1.0 + sc * ed)[:, None], s)
        last = torch.where(v, last * (1 - oh) + oh * t2[:, None], last)
        t = torch.where(valid, t2, t)
    d = max_time.to(f32)[:, None] - last
    ed = torch.exp(-beta * d)
    rem = mu * d + alpha * s * (1.0 - ed)
    return ll - rem.sum(1), s * ed


alias("_contrib_hawkesll", "hawkes_ll")


# ---------------------------------------------------------------------------
# deformable convolution (DCN v1/v2)
# ---------------------------------------------------------------------------
@register("deformable_convolution")
def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), pad=(1, 1), num_deformable_group=1,
                           mask=None):
    """Deformable convolution: ``offset`` (N, dg*K*2, OH, OW) shifts each
    kernel tap's sampling point, read by bilinear interpolation (zero
    outside), then contracted over taps and channels.  ``mask``
    (N, dg*K, OH, OW), already sigmoided, modulates each tap (DCNv2)."""
    N, C, H, W = data.shape
    kh, kw = kernel
    sh, sw = stride
    ph, pw = pad
    dg = num_deformable_group
    K = kh * kw
    OH, OW = offset.shape[2], offset.shape[3]
    dev = data.device
    offs = offset.reshape(N, dg, K, 2, OH, OW)
    oy = torch.arange(OH, device=dev) * sh - ph
    ox = torch.arange(OW, device=dev) * sw - pw
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev),
                            torch.arange(kw, device=dev), indexing="ij")
    ky, kx = ky.reshape(-1), kx.reshape(-1)
    base_y = (oy[None, :, None] + ky[:, None, None]).to(offset.dtype)
    base_x = (ox[None, None, :] + kx[:, None, None]).to(offset.dtype)
    sy = base_y[None, None] + offs[:, :, :, 0]
    sx = base_x[None, None] + offs[:, :, :, 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - y0, sx - x0
    dpg = C // dg
    src = data.reshape(N, dg, 1, dpg, H * W).expand(N, dg, K, dpg, H * W)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = torch.clamp(yi, 0, H - 1).long()
        xc = torch.clamp(xi, 0, W - 1).long()
        flat = (yc * W + xc).reshape(N, dg, K, 1, OH * OW)
        took = src.gather(-1, flat.expand(N, dg, K, dpg, OH * OW))
        took = took.reshape(N, dg, K, dpg, OH, OW)
        return took * valid[:, :, :, None].to(data.dtype)

    val = (gather(y0, x0) * ((1 - fy) * (1 - fx))[:, :, :, None]
           + gather(y0, x0 + 1) * ((1 - fy) * fx)[:, :, :, None]
           + gather(y0 + 1, x0) * (fy * (1 - fx))[:, :, :, None]
           + gather(y0 + 1, x0 + 1) * (fy * fx)[:, :, :, None])
    if mask is not None:
        val = val * mask.reshape(N, dg, K, 1, OH, OW)
    wk = weight.reshape(weight.shape[0], dg, dpg, K)
    out = torch.einsum("ngkcij,ogck->noij", val, wk)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


alias("_contrib_DeformableConvolution", "deformable_convolution")


# ---------------------------------------------------------------------------
# interleaved attention matmuls (GluonNLP 0.x's BERT route)
# ---------------------------------------------------------------------------
def _scores(q, k, D, dtype):
    """q·kᵀ / sqrt(D) per (b, h), accumulated in float32."""
    s = torch.einsum("tbhd,sbhd->bhts", q.to(torch.float32),
                     k.to(torch.float32))
    return (s / math.sqrt(D)).to(dtype)


@register("interleaved_matmul_selfatt_qk")
def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1):
    """(T, B, H*3*D) interleaved qkv -> (B*H, T, T) scores scaled by
    1/sqrt(D), accumulated in float32."""
    T, B, E3 = queries_keys_values.shape
    D = E3 // (heads * 3)
    x = queries_keys_values.reshape(T, B, heads, 3, D)
    scores = _scores(x[..., 0, :], x[..., 1, :], D,
                     queries_keys_values.dtype)
    return scores.reshape(B * heads, T, T)


@register("interleaved_matmul_selfatt_valatt")
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads=1):
    """attention (B*H, T, T) @ the interleaved values -> (T, B, H*D)."""
    T, B, E3 = queries_keys_values.shape
    D = E3 // (heads * 3)
    v = queries_keys_values.reshape(T, B, heads, 3, D)[..., 2, :]
    att = attention.reshape(B, heads, T, T)
    out = torch.einsum("bhts,sbhd->tbhd", att, v)
    return out.reshape(T, B, heads * D)


@register("interleaved_matmul_encdec_qk")
def interleaved_matmul_encdec_qk(queries, keys_values, heads=1):
    """queries (Tq, B, H*D) x interleaved kv (Tk, B, H*2*D) ->
    (B*H, Tq, Tk) scores scaled by 1/sqrt(D)."""
    Tq, B, E = queries.shape
    D = E // heads
    Tk = keys_values.shape[0]
    q = queries.reshape(Tq, B, heads, D)
    k = keys_values.reshape(Tk, B, heads, 2, D)[..., 0, :]
    scores = _scores(q, k, D, queries.dtype)
    return scores.reshape(B * heads, Tq, Tk)


@register("interleaved_matmul_encdec_valatt")
def interleaved_matmul_encdec_valatt(keys_values, attention, heads=1):
    """attention (B*H, Tq, Tk) @ the interleaved values -> (Tq, B, H*D)."""
    Tk, B, E2 = keys_values.shape
    D = E2 // (heads * 2)
    v = keys_values.reshape(Tk, B, heads, 2, D)[..., 1, :]
    Tq = attention.shape[1]
    att = attention.reshape(B, heads, Tq, Tk)
    out = torch.einsum("bhts,sbhd->tbhd", att, v)
    return out.reshape(Tq, B, heads * D)


@register("div_sqrt_dim")
def div_sqrt_dim(data):
    """data / sqrt(data.shape[-1]), the root taken in float32 and cast to
    ``data``'s dtype first, as the JAX op does (truncated for integers)."""
    root = torch.tensor(math.sqrt(data.shape[-1]), dtype=torch.float32)
    return data / root.to(device=data.device, dtype=data.dtype)


for _n in ("interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt",
           "interleaved_matmul_encdec_qk",
           "interleaved_matmul_encdec_valatt", "div_sqrt_dim"):
    alias("_contrib_" + _n, _n)
