"""Optimizers of the port and the learning-rate schedulers."""
from . import lr_scheduler, multi_tensor  # noqa: F401
from .multi_tensor import register_fusable  # noqa: F401
from .lr_scheduler import *  # noqa: F401,F403
from .optimizer import *  # noqa: F401,F403
from .optimizer import Optimizer, Updater, create, get_updater, register  # noqa: F401
