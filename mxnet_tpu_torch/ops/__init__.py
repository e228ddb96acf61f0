"""Operators of the port: plain functions on tensors, plus the hand-written
CUDA kernels they launch (``csrc/``, built and loaded by ``_ext``).

``registry`` names the ops ``mx.nd`` dispatches: the modules below register
their functions as they are imported (``legacy`` after the ones its
aliases name, ``parity`` last, as its aliases resolve against all)."""
from . import flash_attention, nn  # noqa: F401
from . import core, tensor_tail, random_ops, legacy  # noqa: F401
from . import (np_tail, linalg, quantization, image_ops,  # noqa: F401
               optimizer_ops, contrib_tail, detection)
from . import parity  # noqa: F401  (last: its aliases resolve against all)
from .registry import (Operator, alias, apply_op, get_op, invoke,  # noqa: F401
                       list_ops, register)
