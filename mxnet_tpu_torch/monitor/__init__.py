"""mx.monitor: training-health numerics on the device.

Counterpart of ``mxnet_tpu/monitor/``: per-parameter-group gradient and
weight norms, max |x| and nonfinite counts, reduced on the device in the
same groups the grouped optimizer apply runs, read by a publisher thread
off the step's path, and acted on:

- the nonfinite sentinel (``MXNET_MONITOR_SENTINEL=off|warn|skip_step|
  raise``) warns about, skips or raises on a step with NaN/Inf gradients;
- the divergence detector (``divergence.py``): nonfinite gradients
  naming the group, grad-norm spikes against a trailing window, a
  nonfinite loss or a plateau (``observe_loss``), each one rate-limited
  flight-record dump (reason ``divergence``) through mx.trace;
- exports: the ``monitor_*`` telemetry and a per-step JSONL stream
  (``MXNET_MONITOR_STREAM=<path>``).

A captured step (``mx.step``) computes the stats inside its graph.  Off by
default; arm with ``MXNET_MONITOR=1`` or ``enable()``.
"""
from __future__ import annotations

from . import core, divergence, sentinel, stats
from .core import (disable, enable, flush, group_values, health,
                   is_enabled, observe_update, reset, shutdown,
                   stream_path, summary)
from .divergence import DETECTOR, DivergenceDetector, observe_loss

__all__ = ["enable", "disable", "is_enabled", "observe_update",
           "observe_loss", "flush", "summary", "group_values", "health",
           "reset", "shutdown", "stream_path", "DETECTOR",
           "DivergenceDetector", "core", "divergence", "sentinel", "stats"]


def __getattr__(name):
    # monitor.ENABLED mirrors core.ENABLED, a flag that changes at run time
    if name == "ENABLED":
        return core.ENABLED
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
