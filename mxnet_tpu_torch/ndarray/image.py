"""``mx.nd.image``: the image op namespace.

Counterpart of ``mxnet_tpu/ndarray/image.py``.  Each name is the
registry op ``image_<name>`` (``nd.image.to_tensor(x)`` invokes
``image_to_tensor``), so it runs through ``invoke`` and the tape.
"""
from __future__ import annotations

from ..ops import image_ops as _image_ops  # noqa: F401  (registration)
from ..ops.registry import get_op as _get_op

_NAMES = [
    "to_tensor", "normalize", "resize", "crop", "random_crop",
    "random_resized_crop", "flip_left_right", "flip_top_bottom",
    "random_flip_left_right", "random_flip_top_bottom",
    "random_brightness", "random_contrast", "random_saturation",
    "random_hue", "random_color_jitter", "adjust_lighting",
    "random_lighting",
]

__all__ = list(_NAMES)

for _n in _NAMES:
    globals()[_n] = _get_op("image_" + _n)
del _n
