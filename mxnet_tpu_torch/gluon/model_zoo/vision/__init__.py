"""Vision models of the port and ``get_model``.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/__init__.py``: the
ResNets, VGG, AlexNet, MobileNet v1/v2, SqueezeNet, DenseNet and
Inception-v3.  ``get_model`` lower-cases the name and maps ``-`` to
``_``, as the JAX package does, so the upstream dotted names
(``mobilenet1.0``, ``squeezenet1.0``, ``inceptionv3``) are not found
there or here: the constructors are ``mobilenet1_0``, ``squeezenet1_0``,
``inception_v3`` and so on.
"""
from __future__ import annotations

import importlib

from ....base import MXNetError

_MODULE_NAMES = ("resnet", "vgg", "alexnet", "mobilenet", "squeezenet",
                 "densenet", "inception")
_models = {}
for _mod_name in _MODULE_NAMES:
    _mod = importlib.import_module("." + _mod_name, __name__)
    for _name in _mod.__all__:
        _obj = getattr(_mod, _name)
        globals()[_name] = _obj
        if callable(_obj) and _name[0].islower():
            _models[_name] = _obj


def get_model(name, **kwargs):
    """The model called ``name`` (``resnet50_v1``, ``mobilenet_v2_1_0``,
    ...), not initialized."""
    key = name.lower().replace("-", "_")
    if key not in _models:
        raise MXNetError("model %s not found; available: %s"
                         % (name, sorted(_models)))
    return _models[key](**kwargs)


__all__ = ["get_model"] + sorted(_models) + sorted(
    n for m in _MODULE_NAMES
    for n in importlib.import_module("." + m, __name__).__all__
    if n[0].isupper())
