"""Vision transforms: ``Compose``, ``ToTensor``, ``Normalize``, the resizes,
crops, flips, color jitters, rotations and their random-apply wrappers.

Counterpart of ``mxnet_tpu/gluon/data/vision/transforms.py``, with its
names, arguments and draws.  Each transform is a block: called with an
NDArray it returns an NDArray, with a tensor a tensor, on the input's
device (the datasets yield host images, so this is host work).  The
random ones draw from numpy's global generator with the JAX package's
calls in its order, so ``np.random.seed(s)`` gives both packages the same
crops, flips and jitters.  ``Resize`` and ``RandomResizedCrop`` resize with
``image.resize_hwc`` (``F.interpolate(mode='bilinear', antialias=True)``,
``jax.image.resize``'s 'bilinear'), then cast back with truncation, so a
uint8 result may differ from the JAX package's by one where the float
values differ in the last bits.  ``Compose`` is a ``Sequential``;
``HybridCompose`` groups runs of hybrid blocks into ``HybridSequential``s,
whose ``hybridize`` does nothing in the port.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from ....base import _as_torch_dtype
from ....image import resize_hwc
from ...block import Block, HybridBlock
from ...nn.basic_layers import HybridSequential, Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomLighting", "RandomColorJitter",
           "RandomCrop", "RandomHue", "RandomGray", "Rotate",
           "RandomRotation", "CropResize", "RandomApply", "HybridCompose",
           "HybridRandomApply"]


def _t(x):
    """A transform's input as a tensor (numpy arrays are accepted)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _nd(x):
    from ....ndarray.ndarray import NDArray

    return NDArray(x)


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return _t(x).to(_as_torch_dtype(self._dtype))


class ToTensor(HybridBlock):
    """HWC uint8 [0, 255] -> CHW float32 [0, 1] (NHWC -> NCHW for a
    batch)."""

    def forward(self, x):
        x = _t(x).to(torch.float32) / 255.0
        if x.dim() == 3:
            return x.permute(2, 0, 1)
        return x.permute(0, 3, 1, 2)


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, dtype=_np.float32).reshape(-1, 1, 1)
        self._std = _np.asarray(std, dtype=_np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        x = _t(x)
        mean = torch.from_numpy(self._mean).to(x.device)
        std = torch.from_numpy(self._std).to(x.device)
        return (x - mean) / std


def _resize(x, size):
    if isinstance(size, int):
        size = (size, size)
    return resize_hwc(x, size[1], size[0]).to(x.dtype)


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size

    def forward(self, x):
        return _resize(_t(x), self._size)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        y0 = max(0, (H - h) // 2)
        x0 = max(0, (W - w) // 2)
        return _t(x)[y0:y0 + h, x0:x0 + w, :]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        x = _t(x)
        H, W = x.shape[0], x.shape[1]
        area = H * W
        for _ in range(10):
            target_area = _np.random.uniform(*self._scale) * area
            aspect = _np.random.uniform(*self._ratio)
            w = int(round(_np.sqrt(target_area * aspect)))
            h = int(round(_np.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                x0 = _np.random.randint(0, W - w + 1)
                y0 = _np.random.randint(0, H - h + 1)
                return _resize(x[y0:y0 + h, x0:x0 + w, :], self._size)
        return _resize(x, self._size)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return torch.flip(_t(x), [1])
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return torch.flip(_t(x), [0])
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        x = _t(x)
        alpha = 1.0 + _np.random.uniform(-self._b, self._b)
        return (x.to(torch.float32) * alpha).clamp(0, 255).to(x.dtype)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        x = _t(x)
        alpha = 1.0 + _np.random.uniform(-self._c, self._c)
        xf = x.to(torch.float32)
        gray = xf.mean()
        return ((xf - gray) * alpha + gray).clamp(0, 255).to(x.dtype)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        x = _t(x)
        alpha = 1.0 + _np.random.uniform(-self._s, self._s)
        xf = x.to(torch.float32)
        gray = xf.mean(dim=-1, keepdim=True)
        return (gray + (xf - gray) * alpha).clamp(0, 255).to(x.dtype)


class RandomLighting(Block):
    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        x = _t(x)
        alpha = _np.random.normal(0, self._alpha, size=(3,))
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        rgb = torch.from_numpy((eigvec @ (alpha * eigval))
                               .astype(_np.float32)).to(x.device)
        return (x.to(torch.float32) + rgb).clamp(0, 255).to(x.dtype)


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))

    def forward(self, x):
        order = _np.random.permutation(len(self._ts))
        for i in order:
            x = self._ts[i](x)
        return x


class RandomCrop(Block):
    """Random-position crop to ``size``, optionally zero/edge-padding
    first."""

    def __init__(self, size, pad=None, pad_value=0):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size,
                                                                   size)
        self._pad = pad
        self._pad_value = pad_value

    def forward(self, x):
        from ....base import MXNetError

        x = _t(x)
        if self._pad:
            p = self._pad
            x = torch.nn.functional.pad(x, (0, 0, p, p, p, p),
                                        value=self._pad_value)
        h, w = x.shape[:2]
        tw, th = self._size
        if tw > w or th > h:
            raise MXNetError(
                "RandomCrop size (%d, %d) exceeds the %s image (%d, %d); "
                "pad= more or resize first" %
                (tw, th, "padded" if self._pad else "input", w, h))
        x0 = _np.random.randint(0, w - tw + 1)
        y0 = _np.random.randint(0, h - th + 1)
        return x[y0:y0 + th, x0:x0 + tw].clone()


class RandomHue(Block):
    """YIQ-rotation hue jitter (``image.HueJitterAug``)."""

    def __init__(self, hue):
        super().__init__()
        self._hue = hue

    def forward(self, x):
        from ....image import HueJitterAug

        return HueJitterAug(self._hue)(_nd(_t(x)))._data


class RandomGray(Block):
    """Random 3-channel grayscale conversion (``image.RandomGrayAug``)."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        from ....image import RandomGrayAug

        return RandomGrayAug(self._p)(_nd(_t(x)))._data


class Rotate(Block):
    """Rotate by a fixed angle (degrees, counter-clockwise; bilinear
    sampling over the rotated grid, zeros outside)."""

    def __init__(self, rotation_degrees, zoom_in=False, zoom_out=False):
        super().__init__()
        self._deg = rotation_degrees
        self._zoom_in = zoom_in
        self._zoom_out = zoom_out

    def forward(self, x):
        return _rotate(x, self._deg, self._zoom_in, self._zoom_out)


class RandomRotation(Block):
    """Rotate by a uniform random angle in ``angle_limits``."""

    def __init__(self, angle_limits, zoom_in=False, zoom_out=False,
                 rotate_with_proba=1.0):
        super().__init__()
        self._limits = angle_limits
        self._zoom_in = zoom_in
        self._zoom_out = zoom_out
        self._proba = rotate_with_proba

    def forward(self, x):
        if _np.random.rand() > self._proba:
            return x
        deg = _np.random.uniform(*self._limits)
        return _rotate(x, deg, self._zoom_in, self._zoom_out)


def _rotate(x, deg, zoom_in=False, zoom_out=False):
    """Bilinear rotation of an HWC image around its center (the JAX
    package's numpy arithmetic, so both packages give the same floats)."""
    x = _t(x)
    arr = x.cpu().numpy().astype(_np.float32)
    h, w = arr.shape[:2]
    theta = math.radians(deg)
    c, s = math.cos(theta), math.sin(theta)
    scale = 1.0
    if zoom_out:  # fit the whole rotated image
        scale = abs(c) + abs(s)
    elif zoom_in:  # largest axis-aligned box inside the rotation
        scale = 1.0 / (abs(c) + abs(s))
    yy, xx = _np.meshgrid(_np.arange(h, dtype=_np.float32),
                          _np.arange(w, dtype=_np.float32), indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    xr = (xx - cx) * scale
    yr = (yy - cy) * scale
    # inverse mapping for a counter-clockwise screen rotation (y points
    # down, so the math-CW matrix gives visual CCW)
    sx = c * xr - s * yr + cx
    sy = s * xr + c * yr + cy
    x0 = _np.floor(sx).astype(_np.int32)
    y0 = _np.floor(sy).astype(_np.int32)
    fx = sx - x0
    fy = sy - y0

    def sample(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yi = _np.clip(yi, 0, h - 1)
        xi = _np.clip(xi, 0, w - 1)
        return arr[yi, xi] * valid[..., None]

    out = (sample(y0, x0) * ((1 - fx) * (1 - fy))[..., None]
           + sample(y0, x0 + 1) * (fx * (1 - fy))[..., None]
           + sample(y0 + 1, x0) * ((1 - fx) * fy)[..., None]
           + sample(y0 + 1, x0 + 1) * (fx * fy)[..., None])
    return torch.from_numpy(out.astype(_np.float32)).to(x.device)


class CropResize(HybridBlock):
    """Fixed crop, then an optional resize (``image.imresize``)."""

    def __init__(self, x, y, width, height, size=None, interpolation=None):
        super().__init__()
        self._x, self._y = x, y
        self._w, self._h = width, height
        self._size = size
        self._interp = interpolation

    def forward(self, data):
        data = _t(data)
        if data.dim() == 4:  # NHWC batch: crop the spatial axes
            out = data[:, self._y:self._y + self._h,
                       self._x:self._x + self._w]
        else:
            out = data[self._y:self._y + self._h,
                       self._x:self._x + self._w]
        if self._size is not None:
            from ....image import imresize

            size = self._size if isinstance(self._size, (tuple, list)) \
                else (self._size, self._size)
            interp = self._interp if self._interp is not None else 1
            if out.dim() == 4:
                out = torch.stack([imresize(_nd(out[i]), size[0], size[1],
                                            interp)._data
                                   for i in range(out.shape[0])], dim=0)
            else:
                out = imresize(_nd(out), size[0], size[1], interp)._data
        return out


class RandomApply(Block):
    """Apply a transform with probability p."""

    def __init__(self, transforms, p=0.5):
        super().__init__()
        self.transforms = transforms
        self.p = p

    def forward(self, x):
        if _np.random.rand() < self.p:
            return self.transforms(x)
        return x


class HybridCompose(Compose):
    """A ``Compose`` whose consecutive hybrid transforms are grouped into
    one ``HybridSequential`` each (the JAX package compiles each group as
    one program; here ``hybridize`` does nothing)."""

    def __init__(self, transforms):
        grouped = []
        seg = []

        def flush():
            if not seg:
                return
            if len(seg) == 1:
                grouped.append(seg[0])
            else:
                hs = HybridSequential()
                hs.add(*seg)
                hs.hybridize()
                grouped.append(hs)
            seg.clear()

        for t in transforms:
            if isinstance(t, HybridBlock) and not isinstance(t, CropResize):
                seg.append(t)
            else:
                flush()
                grouped.append(t)
        flush()
        super().__init__(grouped)


class HybridRandomApply(RandomApply):
    """A ``RandomApply`` whose wrapped transform is hybridized."""

    def __init__(self, transforms, p=0.5):
        super().__init__(transforms, p)
        if isinstance(transforms, HybridBlock):
            transforms.hybridize()
