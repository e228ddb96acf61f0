"""Contributed modules of the port: ``amp`` (the parameter half)."""
from . import amp  # noqa: F401
