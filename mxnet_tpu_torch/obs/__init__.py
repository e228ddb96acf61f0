"""mx.obs — the observability plane above telemetry, trace and monitor.

Counterpart of ``mxnet_tpu/obs/``.  ``telemetry`` aggregates one
process, ``trace`` records one process's timeline, ``monitor`` watches
one process's numerics; ``obs`` adds:

- **publishing** (``core.attach`` + ``Publisher``): a process's
  ``telemetry.snapshot()`` plus its step cadence and monitor health,
  written into a membership KV (one JSON record per generation and
  rank), rate-limited by ``MXNET_OBS_PUBLISH_SECONDS``; a failing KV
  counts ``obs_publish_failures_total`` and never raises;
- **SLO engine** (``slo_engine.py``): declarative objectives over live
  telemetry (``obs.slo("serve_p99", histogram="serve_request_seconds",
  q=0.99, target=0.2)``) evaluated with multi-window burn rates; states
  OK/WARN/PAGE surface in ``serve.Server``'s ``/statz`` and ``/healthz``
  (degraded), the ``obs_slo_*`` gauges and the telemetry log line;
- **step-time attribution** (``attribution.py``): a per-step breakdown
  (the engines' host phase times, the loader's data wait, an MFU
  estimate from the captured program's FLOP count) written as JSONL to
  ``MXNET_OBS_ATTRIBUTION``.

Everything is fail-soft and cheap: with ``MXNET_OBS=0`` (the default)
every hook costs one flag check.  Enable with ``MXNET_OBS=1`` or
``mx.obs.enable()``.

Not ported yet: the fleet view (``fleet.py``: ``FleetView``, ``fleetz``,
``fleet_summary``, ``merge_metrics``, straggler detection and the
``/fleetz`` route), with the serving fleet (``ROADMAP.md`` Queue 1 item
9).

Env knobs: ``MXNET_OBS``, ``MXNET_OBS_PUBLISH_SECONDS``,
``MXNET_OBS_SLO_FAST_SECONDS`` / ``_SLOW_SECONDS``,
``MXNET_OBS_ATTRIBUTION``, ``MXNET_OBS_PEAK_TFLOPS``.
"""
from __future__ import annotations

from . import attribution, core, slo_engine
from .core import (attach, detach, disable, enable, is_enabled,
                   local_payload, note_step, publisher)
from .slo_engine import slo  # obs.slo(...) registers an objective

__all__ = [
    "core", "slo_engine", "attribution",
    "enable", "disable", "is_enabled",
    "attach", "detach", "publisher", "note_step", "local_payload", "slo",
]


def __getattr__(name):
    # obs.ENABLED mirrors core.ENABLED (a mutable module flag —
    # re-exporting the value at import would freeze it)
    if name == "ENABLED":
        return core.ENABLED
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
