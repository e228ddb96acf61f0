"""Optimizer update ops: the reference's fused-updater op family.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py``: sgd, nag, adam, ftml,
rmsprop, ftrl, signsgd, signum and lamb (with the ``mp_*`` forms, which
update a float32 master copy and return the low-precision weight as its
cast), the interleaved ``multi_*``/``preloaded_multi_*`` sgd family, the
LARS helpers ``multi_sum_sq``/``multi_lars`` and the amp helpers
``all_finite``, ``multi_all_finite``, ``amp_cast``, ``amp_multicast`` and
``reset_arrays``.  Users call them directly
(``mx.nd.sgd_update(w, g, lr=.1, out=w)``).

Each op is a pure function of tensors: it returns the new weight and the
new state values, and ``invoke`` writes the state into the caller's
NDArray handles at the positions ``mutates`` names and the weight into
``out=``, as the JAX package does.  ``all_finite`` and
``multi_all_finite`` stay on the device (a 1-element float32 tensor, no
read-back).
"""
from __future__ import annotations

import torch

from ..base import _as_torch_dtype
from .registry import register

__all__ = []


def _rescale_clip(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


# ---------------------------------------------------------------------------
# single-tensor updaters (optimizer_op.cc:314-1010)
# ---------------------------------------------------------------------------
@register("sgd_update", differentiable=False)
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """weight -= lr * (clip(rescale*grad) + wd*weight)   [optimizer_op.cc:501]"""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    return weight - lr * g


@register("sgd_mom_update", differentiable=False, mutates=(2,))
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom = momentum*mom - lr*(clip(rescale*grad)+wd*w); w += mom
    [optimizer_op.cc:530]"""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


@register("mp_sgd_update", differentiable=False, mutates=(2,))
def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """Multi-precision SGD: update runs on the f32 master copy; the low-
    precision weight output is a cast of it [optimizer_op.cc:583]."""
    g = _rescale_clip(grad.to(torch.float32), rescale_grad, clip_gradient)
    new_w32 = weight32 - lr * (g + wd * weight32)
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", differentiable=False, mutates=(2, 3))
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _rescale_clip(grad.to(torch.float32), rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight32)
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("nag_mom_update", differentiable=False, mutates=(2,))
def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov momentum [optimizer_op-inl.h:1029 NAGMomKernel]:
    g' = clip(rescale*g) + wd*w; mom = momentum*mom - lr*g';
    w += momentum*mom - lr*g'"""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom - lr * g
    return weight + momentum * new_mom - lr * g, new_mom


@register("mp_nag_mom_update", differentiable=False, mutates=(2, 3))
def mp_nag_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad.to(torch.float32), rescale_grad,
                      clip_gradient) + wd * weight32
    new_mom = momentum * mom - lr * g
    new_w32 = weight32 + momentum * new_mom - lr * g
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("adam_update", differentiable=False, mutates=(2, 3))
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """[optimizer_op.cc:651] m=b1*m+(1-b1)g; v=b2*v+(1-b2)g^2;
    w -= lr*m/(sqrt(v)+eps).  wd folds into g (AdamUpdate kernel)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * g * g
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var


@register("ftml_update", differentiable=False, mutates=(2, 3, 4))
def ftml_update(weight, grad, d, v, z, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                clip_grad=-1.0):
    """FTML (Zheng & Kwok 2017) [optimizer_op.cc:618]."""
    g = _rescale_clip(grad, rescale_grad, clip_grad) + wd * weight
    new_v = beta2 * v + (1.0 - beta2) * g * g
    b1t = beta1 ** t
    b2t = beta2 ** t
    new_d = (1.0 - b1t) / lr * (torch.sqrt(new_v / (1.0 - b2t)) + epsilon)
    sigma = new_d - beta1 * d
    new_z = beta1 * z + (1.0 - b1t) * g - sigma * weight
    return -new_z / new_d, new_d, new_v, new_z


@register("rmsprop_update", differentiable=False, mutates=(2,))
def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    """Hinton's RMSProp [optimizer_op.cc:755]."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1.0 - gamma1) * g * g
    # eps OUTSIDE the sqrt: RMSPropUpdateKernel divides by sqrt(n)+eps
    # (optimizer_op-inl.h:2025); only the centered variant keeps it inside
    new_w = weight - lr * g / (torch.sqrt(new_n) + epsilon)
    if clip_weights is not None and clip_weights >= 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n


@register("rmspropalex_update", differentiable=False, mutates=(2, 3, 4))
def rmspropalex_update(weight, grad, n, g, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Graves' non-centered RMSProp [optimizer_op.cc:805]."""
    gr = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1.0 - gamma1) * gr * gr
    new_g = gamma1 * g + (1.0 - gamma1) * gr
    new_delta = gamma2 * delta - lr * gr / torch.sqrt(
        new_n - new_g * new_g + epsilon)
    new_w = weight + new_delta
    if clip_weights is not None and clip_weights >= 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n, new_g, new_delta


@register("ftrl_update", differentiable=False, mutates=(2, 3))
def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL (McMahan et al. 2013) [optimizer_op.cc:847]."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_z = z + g - (torch.sqrt(n + g * g) - torch.sqrt(n)) * weight / lr
    new_n = n + g * g
    new_w = ((torch.sign(new_z) * lamda1 - new_z)
             / ((beta + torch.sqrt(new_n)) / lr + wd)
             * (torch.abs(new_z) > lamda1))
    return new_w, new_z, new_n


@register("signsgd_update", differentiable=False)
def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """w -= lr * sign(g)  [optimizer_op.cc:50]"""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    return weight * (1.0 - lr * wd) - lr * torch.sign(g)


@register("signum_update", differentiable=False, mutates=(2,))
def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """Signum [optimizer_op.cc:76]: m = b*m - (1-b)*g; w = (1-lr*wd_lh)*w +
    lr*sign(m) with m's sign convention from the kernel (mom carries -g)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom - (1.0 - momentum) * g
    new_w = (1.0 - lr * wd_lh) * weight + lr * torch.sign(new_mom)
    return new_w, new_mom


@register("lamb_update_phase1", differentiable=False, mutates=(2, 3))
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """[optimizer_op-inl.h:1573 LambUpdatePhaseOneKernel] returns the lamb
    direction g; caller computes r1/r2 norms and calls phase2."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * g * g
    if bias_correction:
        mean_hat = new_mean / (1.0 - beta1 ** t)
        var_hat = new_var / (1.0 - beta2 ** t)
        out = mean_hat / (torch.sqrt(var_hat) + epsilon) + wd * weight
    else:
        out = new_mean / (torch.sqrt(new_var) + epsilon) + wd * weight
    return out, new_mean, new_var


@register("lamb_update_phase2", differentiable=False)
def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    """[optimizer_op-inl.h:1657 LambUpdatePhaseTwoKernel]"""
    new_r1 = r1.reshape(())
    if lower_bound >= 0:
        new_r1 = torch.clamp(new_r1, min=lower_bound)
    if upper_bound >= 0:
        new_r1 = torch.clamp(new_r1, max=upper_bound)
    r2v = r2.reshape(())
    ratio = torch.where((new_r1 == 0.0) | (r2v == 0.0),
                        torch.ones_like(new_r1), new_r1 / r2v)
    return weight - lr * ratio * g


@register("mp_lamb_update_phase1", differentiable=False, mutates=(2, 3))
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t=1,
                          bias_correction=True, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0):
    """fp16 weights with f32 master copy [optimizer_op.cc mp_lamb_phase1]."""
    g = _rescale_clip(grad.to(torch.float32), rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * g * g
    if bias_correction:
        mean_hat = new_mean / (1.0 - beta1 ** t)
        var_hat = new_var / (1.0 - beta2 ** t)
        out = mean_hat / (torch.sqrt(var_hat) + epsilon) + wd * weight32
    else:
        out = new_mean / (torch.sqrt(new_var) + epsilon) + wd * weight32
    return out, new_mean, new_var


@register("mp_lamb_update_phase2", differentiable=False, mutates=(4,))
def mp_lamb_update_phase2(weight, g, r1, r2, weight32, lr, lower_bound=-1.0,
                          upper_bound=-1.0):
    new_r1 = r1.reshape(())
    if lower_bound >= 0:
        new_r1 = torch.clamp(new_r1, min=lower_bound)
    if upper_bound >= 0:
        new_r1 = torch.clamp(new_r1, max=upper_bound)
    r2v = r2.reshape(())
    ratio = torch.where((new_r1 == 0.0) | (r2v == 0.0),
                        torch.ones_like(new_r1), new_r1 / r2v)
    new_w32 = weight32 - lr * ratio * g
    return new_w32.to(weight.dtype), new_w32


# ---------------------------------------------------------------------------
# multi-tensor updaters (optimizer_op.cc:314-470; interleaved input lists)
# ---------------------------------------------------------------------------
def _norm_list(v, n):
    if isinstance(v, (int, float)):
        return [v] * n
    return list(v)


def _multi_sgd(arrays, stride, lrs, wds, momentum, rescale_grad,
               clip_gradient, has_mom, has_mp):
    """MultiSGDKernel (optimizer_op-inl.h:226) over per-tensor groups."""
    n = len(arrays) // stride
    lrs = _norm_list(lrs, n)
    wds = _norm_list(wds, n)
    new_ws, new_moms, new_w32s = [], [], []
    for i in range(n):
        grp = arrays[i * stride:(i + 1) * stride]
        w, g = grp[0], grp[1]
        mom = grp[2] if has_mom else None
        w32 = grp[-1] if has_mp else None
        master = w32 if has_mp else w
        gr = _rescale_clip(g.to(master.dtype), rescale_grad,
                           clip_gradient) + wds[i] * master
        if has_mom:
            new_mom = momentum * mom - lrs[i] * gr
            new_master = master + new_mom
            new_moms.append(new_mom)
        else:
            new_master = master - lrs[i] * gr
        new_ws.append(new_master.to(w.dtype))
        if has_mp:
            new_w32s.append(new_master)
    return new_ws, new_moms, new_w32s


def _interleaved(stride, has_mom, has_mp, preloaded=False):
    """Build fn + num_outputs/mutates resolvers for one multi_sgd variant."""

    def fn(*arrays, lrs=None, wds=None, momentum=0.0, rescale_grad=1.0,
           clip_gradient=-1.0, num_weights=None):
        if preloaded:
            arrays, lr_arr, wd_arr = arrays[:-2], arrays[-2], arrays[-1]
            lrs = [lr_arr[i] for i in range(len(arrays) // stride)]
            wds = [wd_arr[i] for i in range(len(arrays) // stride)]
        new_ws, new_moms, new_w32s = _multi_sgd(
            list(arrays), stride, lrs, wds, momentum, rescale_grad,
            clip_gradient, has_mom, has_mp)
        n = len(new_ws)
        state = []
        for i in range(n):  # mutated inputs in position order per group
            if has_mom:
                state.append(new_moms[i])
            if has_mp:
                state.append(new_w32s[i])
        return tuple(new_ws) + tuple(state)

    def num_outputs(attrs):
        nw = attrs.get("num_weights")
        if nw is None:
            raise ValueError("multi_sgd family requires num_weights=")
        return int(nw)

    def mutates(attrs):
        nw = int(attrs.get("num_weights"))
        pos = []
        for i in range(nw):
            base = i * stride
            if has_mom:
                pos.append(base + 2)
            if has_mp:
                pos.append(base + stride - 1)
        return pos

    return fn, num_outputs, mutates


for _name, _stride, _mom, _mp, _pre in [
        ("multi_sgd_update", 2, False, False, False),
        ("multi_sgd_mom_update", 3, True, False, False),
        ("multi_mp_sgd_update", 3, False, True, False),
        ("multi_mp_sgd_mom_update", 4, True, True, False),
        ("preloaded_multi_sgd_update", 2, False, False, True),
        ("preloaded_multi_sgd_mom_update", 3, True, False, True),
        ("preloaded_multi_mp_sgd_update", 3, False, True, True),
        ("preloaded_multi_mp_sgd_mom_update", 4, True, True, True)]:
    _fn, _nout, _mut = _interleaved(_stride, _mom, _mp, _pre)
    _fn.__name__ = _name
    _fn.__doc__ = ("Fused multi-tensor %s (reference optimizer_op.cc:314-470"
                   "%s); interleaved inputs, stride %d."
                   % (_name, ", lrs/wds as device arrays" if _pre else "",
                      _stride))
    register(_name, num_outputs=_nout, differentiable=False,
             mutates=_mut)(_fn)


# ---------------------------------------------------------------------------
# LARS helpers (contrib/multi_sum_sq.cc, contrib/multi_lars.cc)
# ---------------------------------------------------------------------------
@register("multi_sum_sq", differentiable=False)
def multi_sum_sq(*arrays, num_arrays=None):
    """Per-array sum of squares, one (N,) f32 output
    [contrib/multi_sum_sq.cc:36]."""
    return torch.stack([torch.sum(torch.square(a.to(torch.float32)))
                        for a in arrays])


@register("multi_lars", differentiable=False)
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001,
               eps=1e-8, rescale_grad=1.0):
    """LARS trust-ratio LR scaling [contrib/multi_lars.cc:35]:
    lr_i *= eta*||w||/(||g||*rescale + wd*||w|| + eps) when both norms > 0."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    ratio = eta * w_norm / (g_norm + wds * w_norm + eps)
    return lrs * torch.where((w_norm > 0) & (g_norm > 0), ratio,
                             torch.ones_like(ratio))


# ---------------------------------------------------------------------------
# AMP helper ops (contrib/all_finite.cc, tensor/amp_cast.cc)
# ---------------------------------------------------------------------------
@register("all_finite", differentiable=False)
def all_finite(data, init_output=True):
    """Scalar 1/0: every element finite [contrib/all_finite.cc:99]."""
    return torch.isfinite(data).all().to(torch.float32).reshape(1)


@register("multi_all_finite", differentiable=False)
def multi_all_finite(*arrays, num_arrays=None, init_output=True):
    """AND of all_finite over N arrays [contrib/all_finite.cc:127]."""
    ok = torch.stack([torch.isfinite(a).all() for a in arrays]).all()
    return ok.to(torch.float32).reshape(1)


@register("amp_cast")
def amp_cast(data, dtype="float16"):
    """Cast inserted by the AMP pass [tensor/amp_cast.cc:31]; identity-like
    and differentiable (grad casts back automatically via vjp)."""
    return data.to(_as_torch_dtype(dtype))


def _amp_multicast_fn(*arrays, num_outputs=None, cast_narrow=False):
    """Cast N arrays to a common dtype [tensor/amp_cast.cc:55]: the widest
    input type (or narrowest with cast_narrow=True)."""
    dt = arrays[0].dtype
    for a in arrays[1:]:
        dt = (torch.promote_types(dt, a.dtype) if not cast_narrow
              else (a.dtype if a.dtype.itemsize < dt.itemsize else dt))
    return tuple(a.to(dt) for a in arrays)


register("amp_multicast",
         num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)))(
             _amp_multicast_fn)


def _reset_arrays_fn(*arrays, num_arrays=None):
    return tuple(torch.zeros_like(a) for a in arrays)


_reset_arrays_fn.__doc__ = ("Zero every input in place "
                            "[contrib/reset_arrays.cc:35].")
register("reset_arrays", num_outputs=0, differentiable=False,
         mutates=lambda attrs: list(range(int(attrs["num_arrays"]))))(
             _reset_arrays_fn)
