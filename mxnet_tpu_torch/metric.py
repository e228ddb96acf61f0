"""``mx.metric``: the 1.x home of the metrics, an alias of
``gluon.metric`` (MXNet 2.0 keeps both importable).

Counterpart of ``mxnet_tpu/metric.py``."""
from .gluon.metric import *  # noqa: F401,F403
from .gluon.metric import __all__  # noqa: F401
