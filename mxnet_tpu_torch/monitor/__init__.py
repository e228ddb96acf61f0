"""mx.monitor: training-health numerics on the device.

Counterpart of ``mxnet_tpu/monitor/``: per-parameter-group gradient and
weight norms, max |x| and nonfinite counts, reduced on the device in the
same groups the grouped optimizer apply runs, and the nonfinite sentinel
(``MXNET_MONITOR_SENTINEL=off|warn|skip_step|raise``) that warns about,
skips or raises on a step with NaN/Inf gradients.  A captured step
(``mx.step``) computes the stats inside its graph.

Off by default; arm with ``MXNET_MONITOR=1`` or ``enable()``.  Not ported
yet: the publisher thread and its ring, the JSONL stream and the
divergence detector (``monitor/divergence.py``).
"""
from __future__ import annotations

from . import core, sentinel, stats
from .core import (disable, enable, flush, group_values, health,
                   is_enabled, observe_update, reset, summary)

__all__ = ["enable", "disable", "is_enabled", "observe_update", "flush",
           "summary", "group_values", "health", "reset", "core",
           "sentinel", "stats"]


def __getattr__(name):
    # monitor.ENABLED mirrors core.ENABLED, a flag that changes at run time
    if name == "ENABLED":
        return core.ENABLED
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
