"""Operators of the port: plain functions on tensors, plus the hand-written
CUDA kernels they launch (``csrc/``, built and loaded by ``_ext``)."""
from . import flash_attention, nn  # noqa: F401
