"""Optimizers of the port."""
from .optimizer import *  # noqa: F401,F403
from .optimizer import NAG, SGD, Adam, AdamW, Optimizer, create, register  # noqa: F401
