"""Image op family: the reference's ``_image_*`` operators
(``mx.nd.image.*``, ``mx.npx.image.*``) and the spatial sampling ops.

Counterpart of ``mxnet_tpu/ops/image_ops.py``, with its conventions:

- the layout is HWC (NHWC batched), except ``normalize``, which runs on
  the CHW/NCHW output of ``to_tensor``;
- ``to_tensor`` scales uint8 [0, 255] to float32 [0, 1], channels first;
- the ``random_*`` ops draw their factors from the port's generator of the
  data's device (``random.uniform_tensor``/``normal_tensor``) and are
  registered non-differentiable; the deterministic ops keep autograd.

``resize`` follows ``jax.image.resize``: half-pixel centres, and a
triangle filter widened by the scale when it shrinks (torch's
``antialias=True``); ``nearest`` is ``nearest-exact``.

``BilinearSampler``, ``GridGenerator`` and ``SpatialTransformer`` share
one differentiable bilinear-sampling core written as the JAX one is
(zero outside the image).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import random as _random
from .registry import alias, register

_GRAY = (0.299, 0.587, 0.114)


def _batched(x):
    return x.dim() == 4


def _uniform(lo, hi, like, shape=()):
    return _random.uniform_tensor(lo, hi, shape, ctx=like.device)


@register("image_to_tensor")
def image_to_tensor(data):
    """HWC uint8 [0,255] -> CHW float32 [0,1]."""
    x = data.to(torch.float32) / 255.0
    return x.permute(0, 3, 1, 2) if _batched(data) else x.permute(2, 0, 1)


@register("image_normalize")
def image_normalize(data, mean=0.0, std=1.0):
    """(x - mean) / std per channel on CHW/NCHW."""
    mean = torch.as_tensor(mean, dtype=torch.float32,
                           device=data.device).reshape(-1)
    std = torch.as_tensor(std, dtype=torch.float32,
                          device=data.device).reshape(-1)
    shape = (1, -1, 1, 1) if _batched(data) else (-1, 1, 1)
    return (data - mean.reshape(shape)) / std.reshape(shape)


@register("image_resize")
def image_resize(data, size=None, keep_ratio=False, interp=1):
    """Resize HWC/NHWC to ``size`` = (w, h)."""
    w, h = (size, size) if isinstance(size, int) else tuple(size)
    x = data.to(torch.float32)
    x = x.permute(0, 3, 1, 2) if _batched(data) else \
        x.permute(2, 0, 1).unsqueeze(0)
    if interp == 0:
        y = F.interpolate(x, size=(h, w), mode="nearest-exact")
    else:
        y = F.interpolate(x, size=(h, w), mode="bilinear",
                          align_corners=False, antialias=True)
    y = y.permute(0, 2, 3, 1) if _batched(data) else y[0].permute(1, 2, 0)
    return y.to(data.dtype) if data.dtype == torch.uint8 else y


@register("image_crop")
def image_crop(data, x=0, y=0, width=1, height=1):
    """Fixed crop at (x, y) of size (width, height)."""
    if _batched(data):
        return data[:, y:y + height, x:x + width, :]
    return data[y:y + height, x:x + width, :]


@register("image_random_crop", differentiable=False)
def image_random_crop(data, xrange=(0.0, 1.0), yrange=(0.0, 1.0), width=1,
                      height=1, interp=1):
    """Crop at a random start; ``xrange``/``yrange`` bound it as
    fractions of the free space."""
    H, W = data.shape[-3], data.shape[-2]
    fx = float(_uniform(xrange[0], xrange[1], data))
    fy = float(_uniform(yrange[0], yrange[1], data))
    x0 = int(round(fx * max(0, W - width)))
    y0 = int(round(fy * max(0, H - height)))
    return image_crop(data, x0, y0, width, height)


@register("image_random_resized_crop", differentiable=False)
def image_random_resized_crop(data, size=None, scale=(0.08, 1.0),
                              ratio=(3 / 4, 4 / 3), interp=1,
                              max_trial=10):
    """Inception-style area/aspect crop, then resize; the geometry is
    drawn on the host from the port's CPU generator."""
    H, W = data.shape[-3], data.shape[-2]
    draws = _random.uniform_tensor(0.0, 1.0, (max_trial, 4)).tolist()
    for u_area, u_ratio, u_x, u_y in draws:
        area = (scale[0] + u_area * (scale[1] - scale[0])) * H * W
        ar = math.exp(math.log(ratio[0]) + u_ratio *
                      (math.log(ratio[1]) - math.log(ratio[0])))
        cw = int(round(math.sqrt(area * ar)))
        ch = int(round(math.sqrt(area / ar)))
        if cw <= W and ch <= H:
            x0 = int(u_x * (W - cw + 1))
            y0 = int(u_y * (H - ch + 1))
            return image_resize(image_crop(data, x0, y0, cw, ch),
                                size=size, interp=interp)
    s = min(H, W)
    return image_resize(image_crop(data, (W - s) // 2, (H - s) // 2, s, s),
                        size=size, interp=interp)


@register("image_flip_left_right")
def image_flip_left_right(data):
    return torch.flip(data, dims=(2 if _batched(data) else 1,))


@register("image_flip_top_bottom")
def image_flip_top_bottom(data):
    return torch.flip(data, dims=(1 if _batched(data) else 0,))


def _maybe(data, fn, p=0.5):
    return torch.where(_uniform(0.0, 1.0, data) < p, fn(data), data)


@register("image_random_flip_left_right", differentiable=False)
def image_random_flip_left_right(data, p=0.5):
    return _maybe(data, image_flip_left_right, p)


@register("image_random_flip_top_bottom", differentiable=False)
def image_random_flip_top_bottom(data, p=0.5):
    return _maybe(data, image_flip_top_bottom, p)


def _blend(a, b, alpha):
    return a * alpha + b * (1.0 - alpha)


def _lum(x):
    return torch.tensordot(x, torch.tensor(_GRAY, device=x.device),
                           dims=([-1], [0]))


@register("image_random_brightness", differentiable=False)
def image_random_brightness(data, min_factor=1.0, max_factor=1.0):
    """x * f, f ~ U(min_factor, max_factor)."""
    return data.to(torch.float32) * _uniform(min_factor, max_factor, data)


@register("image_random_contrast", differentiable=False)
def image_random_contrast(data, min_factor=1.0, max_factor=1.0):
    f = _uniform(min_factor, max_factor, data)
    x = data.to(torch.float32)
    lum = _lum(x)
    if _batched(data):          # per-image anchor, not batch-global
        gray = lum.mean(dim=(1, 2), keepdim=True)[..., None]
    else:
        gray = lum.mean()
    return _blend(x, gray, f)


@register("image_random_saturation", differentiable=False)
def image_random_saturation(data, min_factor=1.0, max_factor=1.0):
    f = _uniform(min_factor, max_factor, data)
    x = data.to(torch.float32)
    return _blend(x, _lum(x)[..., None], f)


@register("image_random_hue", differentiable=False)
def image_random_hue(data, min_factor=0.0, max_factor=0.0):
    """A rotation in YIQ space by f * pi, f ~ U(min_factor, max_factor)."""
    dev = data.device
    f = _uniform(min_factor, max_factor, data)
    u, w = torch.cos(f * math.pi), torch.sin(f * math.pi)
    tyiq = torch.tensor([[0.299, 0.587, 0.114],
                         [0.596, -0.274, -0.321],
                         [0.211, -0.523, 0.311]], device=dev)
    ityiq = torch.tensor([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], device=dev)
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    bt = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, u, -w]),
                      torch.stack([zero, w, u])])
    t = (ityiq @ bt @ tyiq).T
    return torch.tensordot(data.to(torch.float32), t, dims=([-1], [0]))


@register("image_random_color_jitter", differentiable=False)
def image_random_color_jitter(data, brightness=0.0, contrast=0.0,
                              saturation=0.0, hue=0.0):
    x = data.to(torch.float32)
    if brightness > 0:
        x = image_random_brightness(x, max(0.0, 1 - brightness),
                                    1 + brightness)
    if contrast > 0:
        x = image_random_contrast(x, max(0.0, 1 - contrast), 1 + contrast)
    if saturation > 0:
        x = image_random_saturation(x, max(0.0, 1 - saturation),
                                    1 + saturation)
    if hue > 0:
        x = image_random_hue(x, -hue, hue)
    return x


@register("image_adjust_lighting")
def image_adjust_lighting(data, alpha=None):
    """AlexNet's PCA lighting with a fixed ``alpha`` (3,)."""
    dev = data.device
    eigval = torch.tensor([55.46, 4.794, 1.148], device=dev)
    eigvec = torch.tensor([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]], device=dev)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    rgb = (eigvec * alpha[None, :]) @ eigval
    return data.to(torch.float32) + rgb


@register("image_random_lighting", differentiable=False)
def image_random_lighting(data, alpha_std=0.05):
    alpha = _random.normal_tensor(0.0, 1.0, (3,), ctx=data.device) * \
        alpha_std
    return image_adjust_lighting(data, alpha=alpha)


for _ref, _ours in [
        ("_image_to_tensor", "image_to_tensor"),
        ("_image_normalize", "image_normalize"),
        ("_image_resize", "image_resize"),
        ("_image_crop", "image_crop"),
        ("_image_random_crop", "image_random_crop"),
        ("_image_random_resized_crop", "image_random_resized_crop"),
        ("_image_flip_left_right", "image_flip_left_right"),
        ("_image_flip_top_bottom", "image_flip_top_bottom"),
        ("_image_random_flip_left_right", "image_random_flip_left_right"),
        ("_image_random_flip_top_bottom", "image_random_flip_top_bottom"),
        ("_image_random_brightness", "image_random_brightness"),
        ("_image_random_contrast", "image_random_contrast"),
        ("_image_random_saturation", "image_random_saturation"),
        ("_image_random_hue", "image_random_hue"),
        ("_image_random_color_jitter", "image_random_color_jitter"),
        ("_image_adjust_lighting", "image_adjust_lighting"),
        ("_image_random_lighting", "image_random_lighting")]:
    alias(_ref, _ours)


# ---- spatial sampling: BilinearSampler, GridGenerator, SpatialTransformer

def _bilinear_sample_core(data, grid):
    """data (N,C,H,W), grid (N,2,Ho,Wo) with grid[:,0] = x and grid[:,1] =
    y in [-1, 1]; samples outside the image read 0."""
    N, C, H, W = data.shape
    x = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    y = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = data.reshape(N, C, H * W)

    def take(yi, xi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = torch.clamp(xi, 0, W - 1).long()
        yc = torch.clamp(yi, 0, H - 1).long()
        idx = (yc * W + xc).reshape(N, 1, -1).expand(N, C, -1)
        vals = flat.gather(2, idx).reshape(N, C, *xi.shape[1:])
        return vals * inb[:, None].to(data.dtype)

    out = (take(y0, x0) * ((1 - wy) * (1 - wx))[:, None]
           + take(y0, x0 + 1) * ((1 - wy) * wx)[:, None]
           + take(y0 + 1, x0) * (wy * (1 - wx))[:, None]
           + take(y0 + 1, x0 + 1) * (wy * wx)[:, None])
    return out.to(data.dtype)


@register("BilinearSampler")
def bilinear_sampler(data, grid, cudnn_off=None):
    """Sample ``data`` at ``grid`` (normalized [-1, 1] x, y), zero
    outside."""
    return _bilinear_sample_core(data, grid)


@register("GridGenerator")
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """affine: ``data`` (N, 6), a row-major 2x3 theta -> grid (N,2,Ho,Wo);
    warp: ``data`` (N,2,H,W) pixel offsets -> normalized grid."""
    dev = data.device
    if transform_type == "affine":
        N = data.shape[0]
        Ho, Wo = int(target_shape[0]), int(target_shape[1])
        theta = data.reshape(N, 2, 3)
        ys, xs = torch.meshgrid(torch.linspace(-1.0, 1.0, Ho, device=dev),
                                torch.linspace(-1.0, 1.0, Wo, device=dev),
                                indexing="ij")
        base = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
        out = torch.einsum("nij,jk->nik", theta, base.to(theta.dtype))
        return out.reshape(N, 2, Ho, Wo)
    if transform_type == "warp":
        N, _two, H, W = data.shape
        ys, xs = torch.meshgrid(
            torch.arange(H, dtype=data.dtype, device=dev),
            torch.arange(W, dtype=data.dtype, device=dev), indexing="ij")
        x_new = (data[:, 0] + xs) * (2.0 / max(W - 1, 1)) - 1.0
        y_new = (data[:, 1] + ys) * (2.0 / max(H - 1, 1)) - 1.0
        return torch.stack([x_new, y_new], dim=1)
    raise ValueError("GridGenerator transform_type %r" % (transform_type,))


@register("SpatialTransformer")
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=None):
    """Affine theta from the localization net, then bilinear sampling."""
    if transform_type != "affine" or sampler_type != "bilinear":
        raise ValueError("SpatialTransformer supports affine/bilinear")
    grid = grid_generator(loc, "affine", target_shape)
    return _bilinear_sample_core(data, grid)
