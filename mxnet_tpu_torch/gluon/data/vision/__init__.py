"""Vision datasets and transforms (``mxnet_tpu/gluon/data/vision/``)."""
from . import transforms
from .datasets import *  # noqa: F401,F403
from . import datasets

__all__ = datasets.__all__ + ["transforms"]
