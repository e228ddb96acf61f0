"""Dump-on-anomaly triggers for the flight recorder.

Counterpart of ``mxnet_tpu/trace/anomaly.py``; every trigger goes through
``export.dump_async`` (rate-limited per reason):

- ``SlowStepDetector``: a trailing window of step durations; a step
  longer than ``factor`` x the trailing p99 dumps with
  ``reason="slow_step"`` (``MXNET_TRACE_SLOW_STEP_FACTOR``, default 3;
  0 turns it off).  ``trace.span(..., anomaly=True)`` feeds it: the
  trainer's step and the captured step.
- ``DeadlineMissMonitor``: ``MXNET_TRACE_DEADLINE_BURST`` serve deadline
  misses (8) within ``MXNET_TRACE_DEADLINE_WINDOW`` seconds (5) dump with
  ``reason="deadline_burst"``.
- ``divergence(extra)``: the monitor's training-health events (nonfinite
  gradients, a grad-norm spike, a nonfinite loss or a plateau) dump with
  ``reason="divergence"``, naming the group or detector; listeners
  registered with ``on_divergence`` hear of each first.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from ..base import get_env
from . import core, export

__all__ = ["SlowStepDetector", "DeadlineMissMonitor", "observe_step",
           "deadline_miss", "divergence", "straggler", "on_divergence",
           "remove_divergence_listener", "STEP_DETECTOR",
           "DEADLINE_MONITOR"]


class SlowStepDetector:
    """Trailing-p99 outlier detector over step durations."""

    # recompute the trailing p99 every N observations: sorting the
    # window per step would put an O(W log W) on the hot path
    _REFRESH = 16

    def __init__(self, factor=None, window=256, min_samples=32):
        if factor is None:
            factor = get_env("MXNET_TRACE_SLOW_STEP_FACTOR", float, 3.0)
        self.factor = float(factor)
        self.min_samples = int(min_samples)
        self._lock = threading.Lock()
        self._window = deque(maxlen=int(window))
        self._p99 = 0.0
        self._since_refresh = 0

    def trailing_p99(self):
        with self._lock:
            if self._since_refresh == 0 and self._p99:
                return self._p99
            return self._refresh_locked()

    def _refresh_locked(self):
        vals = sorted(self._window)
        if vals:
            self._p99 = vals[min(len(vals) - 1,
                                 int(0.99 * len(vals)))]
        self._since_refresh = 0
        return self._p99

    def observe(self, dur):
        """Record one step duration; returns the dump path when this
        step triggered an anomaly dump, else None."""
        if self.factor <= 0:
            return None
        with self._lock:
            n = len(self._window)
            warm = n >= self.min_samples
            if warm and (self._since_refresh >= self._REFRESH
                         or not self._p99):
                self._refresh_locked()
            p99 = self._p99
            self._window.append(dur)
            self._since_refresh += 1
        if not warm or p99 <= 0 or dur <= self.factor * p99:
            return None
        # async: observe() runs on span exit in the training thread —
        # the dump write must not stretch the very step being flagged
        return export.dump_async(
            "slow_step",
            extra={"step_seconds": round(dur, 6),
                   "trailing_p99_seconds": round(p99, 6),
                   "factor": self.factor})


class DeadlineMissMonitor:
    """Sliding-window burst detector over serve deadline misses."""

    def __init__(self, burst=None, window_seconds=None):
        if burst is None:
            burst = get_env("MXNET_TRACE_DEADLINE_BURST", int, 8)
        if window_seconds is None:
            window_seconds = get_env("MXNET_TRACE_DEADLINE_WINDOW",
                                     float, 5.0)
        self.burst = int(burst)
        self.window = float(window_seconds)
        self._lock = threading.Lock()
        self._times = deque()

    def miss(self):
        """Record one deadline miss; returns the dump path when the
        burst threshold tripped, else None."""
        if self.burst <= 0:
            return None
        now = time.monotonic()
        with self._lock:
            self._times.append(now)
            while self._times and now - self._times[0] > self.window:
                self._times.popleft()
            n = len(self._times)
            if n < self.burst:
                return None
            self._times.clear()  # one dump per burst episode
        # async is load-bearing here: miss() fires from serve's _fail,
        # which BatchQueue._expire_locked calls while holding the queue
        # condition lock — a synchronous multi-MB write there would
        # freeze submission and the scheduler during the very outage
        # being diagnosed
        return export.dump_async(
            "deadline_burst",
            extra={"misses": n, "window_seconds": self.window})


STEP_DETECTOR = SlowStepDetector()
DEADLINE_MONITOR = DeadlineMissMonitor()


def observe_step(dur):
    """Feed one train-step duration to the slow-step detector (called
    by ``trace.span(..., anomaly=True)`` on exit)."""
    if not core.ENABLED:
        return None
    return STEP_DETECTOR.observe(dur)


def deadline_miss():
    """Feed one serve deadline miss to the burst monitor."""
    if not core.ENABLED:
        return None
    return DEADLINE_MONITOR.miss()


# subscribers to the divergence feed (mx.resilience's supervisor
# registers one to roll back to the latest checkpoint); notified even
# when trace recording is disabled — reacting to divergence must not
# depend on the flight recorder being armed
_DIVERGENCE_LISTENERS = []


def on_divergence(cb):
    """Register ``cb(extra)`` to run on every divergence event (before
    the dump).  Returns ``cb`` so it can be removed later.  Listener
    exceptions are swallowed — a sick observer must not take down the
    training thread the event fired from."""
    _DIVERGENCE_LISTENERS.append(cb)
    return cb


def remove_divergence_listener(cb):
    try:
        _DIVERGENCE_LISTENERS.remove(cb)
    except ValueError:
        pass


def divergence(extra=None):
    """Dump the flight record for a training-health divergence event
    (mx.monitor: nonfinite gradients, grad-norm spike, loss
    NaN/plateau).  ``extra`` names the kind, step, and offending
    parameter group so the dump is self-describing.  Async for the
    same reason the other detectors are — the sentinel fires on the
    training thread mid-step, and the publisher fires under the
    monitor ring lock's shadow; neither may stall on a multi-MB
    write.  Rate-limited per ``MXNET_TRACE_DUMP_MIN_SECONDS`` like
    every anomaly reason."""
    for cb in list(_DIVERGENCE_LISTENERS):
        try:
            cb(extra)
        except Exception:  # noqa: BLE001 - observer must not kill training
            pass
    if not core.ENABLED:
        return None
    return export.dump_async("divergence", extra=extra)


def straggler(extra=None):
    """Dump the flight record for a fleet straggler event (mx.obs:
    a rank's step p50 drifted past MXNET_OBS_STRAGGLER_FACTOR x the
    fleet median).  ``extra`` names the rank, its p50, and the fleet
    median so the dump is self-describing.  Async + rate-limited per
    ``MXNET_TRACE_DUMP_MIN_SECONDS`` like every anomaly reason — a
    persistently slow rank produces one dump per window, not one per
    fleet-view refresh."""
    if not core.ENABLED:
        return None
    return export.dump_async("straggler", extra=extra)
