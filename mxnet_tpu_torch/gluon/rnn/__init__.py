"""Recurrent layers and cells of the port (``gluon.rnn``): the fused
``RNN``/``LSTM``/``GRU`` layers and the step-at-a-time cells."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
from . import rnn_cell, rnn_layer

__all__ = rnn_cell.__all__ + rnn_layer.__all__
