"""Gluon blocks, layers, parameters, the trainer and models of the port."""
from . import model_zoo, nn  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import Parameter  # noqa: F401
from .trainer import Trainer  # noqa: F401
