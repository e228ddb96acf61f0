"""Image utilities: ``imread``, ``imdecode``, ``imresize``, the crop
helpers, the ``*Aug`` augmenters, ``CreateAugmenter`` and ``ImageIter``.

Counterpart of ``mxnet_tpu/image.py``, with the same names, arguments and
draws.  Images are host arrays: the decoders return uint8 HWC NDArrays on
the CPU, and every helper and augmenter keeps its input's context, so the
per-image work of an input pipeline stays on the host and a batch crosses
to the card once.  The random ones draw from numpy's global generator with
the JAX package's calls in its order, so ``np.random.seed(s)`` gives both
packages the same crops, flips and jitters.

Decoding: JPEG through the host library's libjpeg (``native``; a host
library built without it raises), npy with numpy, other formats with PIL.
``imresize`` of a uint8 image takes the host library's bilinear resize, as
the JAX package does where its library is built; other dtypes resize with
``F.interpolate(mode='bilinear', antialias=True)``, which is what
``jax.image.resize(..., 'bilinear')`` computes (it antialiases when it
shrinks).  ``imrotate`` samples with ``F.affine_grid``/``F.grid_sample``
(``align_corners=True``, zeros outside), the JAX package's
``GridGenerator``/``BilinearSampler``.  The detection augmenters
(``image_detection.py``) are not ported.
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F

from . import ndarray as nd
from .base import MXNetError
from .context import cpu


def _host(arr, dtype="uint8"):
    """A numpy array as an NDArray on the CPU."""
    return nd.array(arr, ctx=cpu(), dtype=dtype)


def _like(src, arr, dtype=None):
    """A numpy array as an NDArray on ``src``'s context."""
    return nd.array(arr, ctx=src.context, dtype=dtype)

__all__ = ["imread", "imresize", "imdecode", "resize_short", "center_crop",
           "random_crop", "fixed_crop", "random_size_crop", "color_normalize",
           "scale_down", "ImageIter", "CreateAugmenter", "Augmenter",
           "SequentialAug", "RandomOrderAug", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "RandomSizedCropAug", "CenterCropAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "HueJitterAug", "ColorJitterAug", "LightingAug",
           "ColorNormalizeAug", "RandomGrayAug", "HorizontalFlipAug",
           "CastAug"]


def imread(filename, flag=1, to_rgb=True):
    if filename.endswith(".npy"):
        return _host(_np.load(filename))
    try:
        from PIL import Image
    except ImportError as exc:
        raise MXNetError("PIL unavailable; use .npy images") from exc
    img = Image.open(filename)
    if flag == 1:
        img = img.convert("RGB")
    else:
        img = img.convert("L")
    arr = _np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return _host(arr)


def imdecode(buf, flag=1, to_rgb=True):
    import io

    from . import native

    buf_bytes = bytes(buf)
    if buf_bytes[:2] == b"\xff\xd8":
        rgb = native.decode_jpeg(buf_bytes)
        if flag == 0:  # grayscale request: BT.601 luma, keep (H, W, 1)
            gray = (0.299 * rgb[:, :, 0] + 0.587 * rgb[:, :, 1]
                    + 0.114 * rgb[:, :, 2]).astype(_np.uint8)
            return _host(gray[:, :, None])
        return _host(rgb)
    if buf_bytes[:6] == b"\x93NUMPY":
        return _host(_np.load(io.BytesIO(buf_bytes)))
    from PIL import Image

    img = Image.open(io.BytesIO(buf_bytes))
    img = img.convert("RGB" if flag else "L")
    arr = _np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return _host(arr)


def resize_hwc(data, h, w):
    """Bilinear resize of an HWC tensor to (h, w) in float32, with
    antialiasing when it shrinks (``jax.image.resize``'s 'bilinear')."""
    x = data.to(torch.float32).permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                        antialias=True)
    return out[0].permute(1, 2, 0)


def imresize(src, w, h, interp=1):
    from . import native

    if src.dtype == _np.uint8:
        return _like(src, native.resize_bilinear(src.asnumpy(), h, w),
                     "uint8")
    return nd.NDArray(resize_hwc(src._data, h, w)).astype(src.dtype)


def copyMakeBorder(src, top, bot, left, right, border_type=0, value=0.0):
    """Pad an HWC image: border_type 0 = constant fill, 1 = replicate
    edge."""
    arr = src.asnumpy() if hasattr(src, "asnumpy") else _np.asarray(src)
    pads = ((top, bot), (left, right)) + ((0, 0),) * (arr.ndim - 2)
    if border_type == 1:
        out = _np.pad(arr, pads, mode="edge")
    else:
        out = _np.pad(arr, pads, mode="constant",
                      constant_values=_np.asarray(value, arr.dtype))
    return _like(src, out, str(arr.dtype)) if hasattr(src, "context") \
        else _host(out, str(arr.dtype))


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size if isinstance(size, tuple) else (size, size)
    x0 = max(0, (w - new_w) // 2)
    y0 = max(0, (h - new_h) // 2)
    out = src[y0:y0 + new_h, x0:x0 + new_w]
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size if isinstance(size, tuple) else (size, size)
    x0 = _np.random.randint(0, max(1, w - new_w + 1))
    y0 = _np.random.randint(0, max(1, h - new_h + 1))
    out = src[y0:y0 + new_h, x0:x0 + new_w]
    return out, (x0, y0, new_w, new_h)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop at a fixed window, optionally resizing."""
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_size_crop(src, size, area, ratio, interp=2, **kwargs):
    """Inception-style random-area/aspect crop; a center crop after 10
    failed draws."""
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _np.random.uniform(area[0], area[1]) * src_area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        new_ratio = _np.exp(_np.random.uniform(*log_ratio))
        new_w = int(round(_np.sqrt(target_area * new_ratio)))
        new_h = int(round(_np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = _np.random.randint(0, w - new_w + 1)
            y0 = _np.random.randint(0, h - new_h + 1)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    out, coord = center_crop(src, size, interp)
    return out, coord


def color_normalize(src, mean, std=None):
    """(src - mean) / std over HWC float."""
    src = src.astype("float32") if src.dtype != _np.float32 else src
    out = src - _like(src, _np.asarray(mean, _np.float32))
    if std is not None:
        out = out / _like(src, _np.asarray(std, _np.float32))
    return out


def scale_down(src_size, size):
    """Scale crop size down to fit in src."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


# ---------------------------------------------------------------------------
# Augmenter classes: each carries its params for serialization via
# dumps(); __call__(src) -> src
# ---------------------------------------------------------------------------
class Augmenter:
    """Image augmenter base."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, nd.NDArray):
                kwargs[k] = v.asnumpy().tolist()
            elif isinstance(v, _np.ndarray):
                kwargs[k] = v.tolist()

    def dumps(self):
        import json

        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    """Compose a list of augmenters in order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def dumps(self):
        return [self.__class__.__name__.lower(),
                [t.dumps() for t in self.ts]]

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    """Apply children in random order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def dumps(self):
        return [self.__class__.__name__.lower(),
                [t.dumps() for t in self.ts]]

    def __call__(self, src):
        order = _np.random.permutation(len(self.ts))
        for i in order:
            src = self.ts[i](src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size if isinstance(size, tuple) else (size, size)
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2, **kwargs):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = \
            size, area, ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size if isinstance(size, tuple) else (size, size)
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class BrightnessJitterAug(Augmenter):
    """src *= 1 + U(-brightness, brightness)."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _np.random.uniform(-self.brightness, self.brightness)
        return src.astype("float32") * alpha


class ContrastJitterAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _np.random.uniform(-self.contrast, self.contrast)
        x = src.asnumpy().astype(_np.float32)
        gray = (x * self._coef).sum() * (3.0 / x.size)
        return _like(src, x * alpha + gray * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _np.random.uniform(-self.saturation, self.saturation)
        x = src.asnumpy().astype(_np.float32)
        gray = (x * self._coef).sum(axis=2, keepdims=True)
        return _like(src, x * alpha + gray * (1.0 - alpha))


class HueJitterAug(Augmenter):
    """YIQ-rotation hue jitter."""

    _tyiq = _np.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.321],
                       [0.211, -0.523, 0.311]], _np.float32)
    _ityiq = _np.array([[1.0, 0.956, 0.621],
                        [1.0, -0.272, -0.647],
                        [1.0, -1.107, 1.705]], _np.float32)

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        alpha = _np.random.uniform(-self.hue, self.hue)
        u, w = _np.cos(alpha * _np.pi), _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                       _np.float32)
        t = _np.dot(_np.dot(self._ityiq, bt), self._tyiq).T
        x = src.asnumpy().astype(_np.float32)
        return _like(src, _np.dot(x, t))


class ColorJitterAug(RandomOrderAug):
    """brightness/contrast/saturation in random order."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval, _np.float32)
        self.eigvec = _np.asarray(eigvec, _np.float32)

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd, size=(3,))
        rgb = _np.dot(self.eigvec * alpha, self.eigval)
        return src.astype("float32") + _like(src, rgb.astype(_np.float32))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    _coef = _np.array([[0.299], [0.587], [0.114]], _np.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _np.random.rand() < self.p:
            x = src.asnumpy().astype(_np.float32)
            gray = _np.dot(x, self._coef)
            return _like(src, _np.broadcast_to(gray, x.shape).copy())
        return src


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _np.random.rand() < self.p:
            return src[:, ::-1, :]
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


def imrotate(src, rotation_degrees, zoom_in=False, zoom_out=False):
    """Rotate image(s) by ``rotation_degrees`` (counter-clockwise; CHW or
    NCHW float32; ``zoom_in`` crops so no padding shows, ``zoom_out``
    shrinks so the whole source stays visible).  The (N, 2, 3) affine
    theta is made on the host; the grid and the bilinear sampling run on
    ``src``'s device, and gradients flow to ``src``."""
    import numbers

    if zoom_in and zoom_out:
        raise ValueError("`zoom_in` and `zoom_out` cannot be both True")
    src = src if isinstance(src, nd.NDArray) else nd.array(src)
    if str(src.dtype) != "float32":
        raise TypeError("Only `float32` images are supported")
    expanded = False
    if src.ndim == 3:
        expanded = True
        if not isinstance(rotation_degrees, numbers.Number):
            raise TypeError("single image needs a scalar angle")
        src = nd.expand_dims(src, axis=0)
    elif src.ndim != 4:
        raise ValueError("Only 3D (CHW) and 4D (NCHW) are supported")
    N, _C, H, W = src.shape
    if isinstance(rotation_degrees, numbers.Number):
        angles = _np.full(N, float(rotation_degrees), _np.float32)
    else:
        angles = _np.asarray(
            rotation_degrees.asnumpy()
            if isinstance(rotation_degrees, nd.NDArray)
            else rotation_degrees, _np.float32).reshape(-1)
        if len(angles) != N:
            raise ValueError("need one angle per image")
    rad = _np.pi * angles / 180.0

    hs, ws = (H - 1) / 2.0, (W - 1) / 2.0
    c = _np.cos(rad)
    s = _np.sin(rad)
    if zoom_in or zoom_out:
        rho = _np.sqrt(H * H + W * W)
        ang = _np.arctan2(H, W)
        a = _np.abs(rad)
        max_x = _np.maximum(_np.abs(rho * _np.cos(ang + a)),
                            _np.abs(rho * _np.cos(ang - a)))
        max_y = _np.maximum(_np.abs(rho * _np.sin(ang + a)),
                            _np.abs(rho * _np.sin(ang - a)))
        if zoom_out:
            scale = _np.maximum(max_x / W, max_y / H)
        else:
            scale = _np.minimum(W / max_x, H / max_y)
    else:
        scale = _np.ones_like(rad)
    # aspect-preserving rotation in normalized coords:
    # x' = s*(c*x - (hs/ws)*sin*y), y' = s*((ws/hs)*sin*x + c*y)
    zeros = _np.zeros_like(rad)
    theta = _np.stack([
        scale * c, -scale * s * (hs / ws), zeros,
        scale * s * (ws / hs), scale * c, zeros], axis=1) \
        .astype(_np.float32).reshape(N, 2, 3)

    def rotate(x):
        th = torch.from_numpy(theta).to(x.device)
        grid = F.affine_grid(th, (N, x.shape[1], H, W), align_corners=True)
        return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    from .ops.registry import apply_op

    out = apply_op(rotate, src)
    return out[0] if expanded else out


def random_rotate(src, angle_limits, zoom_in=False, zoom_out=False):
    """Rotate by a uniform random angle in ``angle_limits``."""
    lo, hi = angle_limits
    if src.ndim == 3:
        deg = float(_np.random.uniform(lo, hi))
    else:
        deg = _np.random.uniform(lo, hi, size=src.shape[0]) \
            .astype(_np.float32)
    return imrotate(src, deg if _np.isscalar(deg) else _like(src, deg),
                    zoom_in=zoom_in, zoom_out=zoom_out)


def rgb_to_hsv(arr):
    """HWC float [0,1] RGB -> HSV (vectorized colorsys semantics)."""
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    mx_ = _np.max(arr, axis=-1)
    mn = _np.min(arr, axis=-1)
    diff = mx_ - mn
    safe = _np.where(diff == 0, 1.0, diff)
    h = _np.where(
        mx_ == r, (g - b) / safe % 6.0,
        _np.where(mx_ == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = _np.where(diff == 0, 0.0, h) / 6.0
    s = _np.where(mx_ == 0, 0.0, diff / _np.where(mx_ == 0, 1.0, mx_))
    return _np.stack([h, s, mx_], axis=-1)


def hsv_to_rgb(arr):
    """HWC float HSV -> RGB (inverse of rgb_to_hsv)."""
    h, s, v = arr[..., 0] * 6.0, arr[..., 1], arr[..., 2]
    i = _np.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.astype(_np.int32) % 6
    r = _np.choose(i, [v, q, p, p, t, v])
    g = _np.choose(i, [t, v, v, q, p, p])
    b = _np.choose(i, [p, p, t, v, v, q])
    return _np.stack([r, g, b], axis=-1)


class HSVJitterAug(Augmenter):
    """Jitter hue/saturation/value in HSV space (the exact color-space
    rendering; ``HueJitterAug`` approximates hue rotation with an RGB
    matrix)."""

    def __init__(self, hue=0.0, saturation=0.0, value=0.0):
        super().__init__(hue=hue, saturation=saturation, value=value)
        self.hue = hue
        self.saturation = saturation
        self.value = value

    def __call__(self, src):
        arr = src.asnumpy().astype(_np.float32)
        scale = 255.0 if arr.max() > 1.0 else 1.0
        hsv = rgb_to_hsv(arr / scale)
        dh = _np.random.uniform(-self.hue, self.hue)
        ds = 1.0 + _np.random.uniform(-self.saturation, self.saturation)
        dv = 1.0 + _np.random.uniform(-self.value, self.value)
        hsv[..., 0] = (hsv[..., 0] + dh) % 1.0
        hsv[..., 1] = _np.clip(hsv[..., 1] * ds, 0, 1)
        hsv[..., 2] = _np.clip(hsv[..., 2] * dv, 0, 1)
        return _like(src, hsv_to_rgb(hsv) * scale, src.dtype)


class RandomRotateAug(Augmenter):
    """Random rotation augmenter over ``imrotate`` (HWC uint8/float in,
    same out; the angle draw is ``random_rotate``'s)."""

    def __init__(self, angle_limits, zoom_in=False, zoom_out=False):
        super().__init__(angle_limits=angle_limits, zoom_in=zoom_in,
                         zoom_out=zoom_out)
        self.angle_limits = angle_limits
        self.zoom_in = zoom_in
        self.zoom_out = zoom_out

    def __call__(self, src):
        arr = src.asnumpy().astype(_np.float32)
        chw = _like(src, arr.transpose(2, 0, 1))
        out = random_rotate(chw, self.angle_limits, zoom_in=self.zoom_in,
                            zoom_out=self.zoom_out)
        return _like(src, out.asnumpy().transpose(1, 2, 0), src.dtype)


def _color_aug_tail(brightness=0, contrast=0, saturation=0, hue=0,
                    pca_noise=0, rand_gray=0, mean=None, std=None):
    """The cast + color-jitter + lighting + gray + normalize tail shared
    by CreateAugmenter and CreateDetAugmenter (constants live HERE
    once: ImageNet PCA eigen-basis and mean/std)."""
    tail = [CastAug()]
    if brightness or contrast or saturation:
        tail.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        tail.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        tail.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        tail.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and len(_np.atleast_1d(mean)):
        tail.append(ColorNormalizeAug(mean, std))
    return tail


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """The standard augmentation list (MXNet's ``CreateAugmenter``: the
    same arguments, the same order)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.extend(_color_aug_tail(brightness, contrast, saturation, hue,
                                   pca_noise, rand_gray, mean, std))
    return auglist


class ImageIter:
    """Pre-Gluon image iterator: a thin wrapper over
    ``io.ImageRecordIter``."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_root=None, shuffle=False, aug_list=None, **kwargs):
        from .io import ImageRecordIter

        if path_imgrec:
            self._iter = ImageRecordIter(path_imgrec, data_shape,
                                         batch_size, shuffle, **kwargs)
        else:
            raise MXNetError("ImageIter needs path_imgrec (or use "
                             "gluon.data.vision.ImageFolderDataset)")

    def __iter__(self):
        return self._iter.__iter__()

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()


__all__ += ["imrotate", "random_rotate", "RandomRotateAug", "HSVJitterAug",
            "rgb_to_hsv", "hsv_to_rgb", "copyMakeBorder", "resize_hwc"]
