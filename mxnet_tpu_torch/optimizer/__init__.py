"""Optimizers of the port and the learning-rate schedulers."""
from . import lr_scheduler  # noqa: F401
from .lr_scheduler import *  # noqa: F401,F403
from .optimizer import *  # noqa: F401,F403
from .optimizer import NAG, SGD, Adam, AdamW, Optimizer, create, register  # noqa: F401
