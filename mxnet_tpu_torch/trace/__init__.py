"""mx.trace: structured tracing, the flight recorder and the hang watchdog.

Counterpart of ``mxnet_tpu/trace/``.  ``mx.telemetry`` answers "how much,
how often"; ``mx.profiler`` "show me every kernel"; ``mx.trace`` "where
did this step or this request go, and what was the process doing when it
died": always on, bounded memory, dumpable after the fact.

Surface::

    with mx.trace.span("train_step"):          # nest freely; ids travel
        with mx.trace.span("forward"): ...     # in contextvars
    mx.trace.dump()                            # Chrome-trace JSON of the
                                               # flight-recorder ring
    mx.trace.watchdog.install(timeout=60)      # hang -> stacks + dump

Env knobs: ``MXNET_TRACE_DISABLE``, ``MXNET_TRACE_RING_EVENTS``,
``MXNET_TRACE_DUMP_DIR``, ``MXNET_TRACE_DUMP_ON_CRASH``,
``MXNET_TRACE_DUMP_AT_EXIT``, ``MXNET_TRACE_DUMP_MIN_SECONDS``,
``MXNET_TRACE_DUMP_MAX_EVENTS``, ``MXNET_TRACE_SLOW_STEP_FACTOR``,
``MXNET_TRACE_DEADLINE_BURST`` / ``_WINDOW``, ``MXNET_TRACE_WATCHDOG`` /
``_SECONDS``.
"""
from __future__ import annotations

from . import anomaly, core, export, watchdog
from .core import (FlightRecorder, RECORDER, TraceContext, clear,
                   current, current_trace_id, enable, disable, events,
                   instant, new_context, new_request, record_span,
                   sanitize_request_id, span, use)
from .export import chrome_trace, dump, dump_async, dump_dir, last_dumps

__all__ = [
    "span", "instant", "record_span", "use",
    "current", "current_trace_id", "new_context", "new_request",
    "sanitize_request_id",
    "TraceContext", "FlightRecorder", "RECORDER", "events", "clear",
    "chrome_trace", "dump", "dump_async", "dump_dir", "last_dumps",
    "enable", "disable", "is_enabled",
    "anomaly", "watchdog", "core", "export",
]


def is_enabled():
    """Whether trace recording is on (``trace.core.ENABLED``, read live)."""
    return core.ENABLED


def __getattr__(name):
    # trace.ENABLED mirrors core.ENABLED, a flag that changes at run time
    if name == "ENABLED":
        return core.ENABLED
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
