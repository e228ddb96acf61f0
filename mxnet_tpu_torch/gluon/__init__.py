"""Gluon blocks, layers, parameters, losses, metrics, utilities, the
trainer and models of the port."""
from . import data, loss, metric, model_zoo, nn, rnn, utils  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import Constant, Parameter  # noqa: F401
from .trainer import Trainer  # noqa: F401
