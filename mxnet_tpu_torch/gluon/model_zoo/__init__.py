"""Model zoo of the port: BERT and the vision ResNets."""
from . import bert, vision  # noqa: F401
