"""Gluon blocks, layers and models of the port."""
from . import model_zoo, nn  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
