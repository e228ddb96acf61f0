"""Gluon blocks, layers, parameters, losses, metrics, utilities, the
trainer and models of the port."""
from . import loss, metric, model_zoo, nn, rnn, utils  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import Parameter  # noqa: F401
from .trainer import Trainer  # noqa: F401
