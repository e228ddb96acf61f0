"""Vision models of the port: the ResNets, and ``get_model``.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/__init__.py``.  The
other families of the JAX package (vgg, alexnet, mobilenet, squeezenet,
densenet, inception) are not ported yet: ``get_model`` names the family
and raises.
"""
from __future__ import annotations

from ....base import MXNetError
from . import resnet
from .resnet import *  # noqa: F401,F403

_NOT_PORTED = ("vgg", "alexnet", "mobilenet", "squeezenet", "densenet",
               "inception")
_models = {name: getattr(resnet, name) for name in resnet.__all__
           if name[0].islower() and name != "get_resnet"}


def get_model(name, **kwargs):
    """The model called ``name`` (``resnet50_v1``, ...), not initialized."""
    key = name.lower().replace("-", "_")
    if key in _models:
        return _models[key](**kwargs)
    family = next((f for f in _NOT_PORTED if key.startswith(f)), None)
    if family is not None:
        raise MXNetError("model %s: the %s family is not ported yet "
                         "(ported: %s)" % (name, family, sorted(_models)))
    raise MXNetError("model %s not found; available: %s"
                     % (name, sorted(_models)))


__all__ = ["get_model"] + sorted(_models) + [
    n for n in resnet.__all__ if n[0].isupper() or n == "get_resnet"]
