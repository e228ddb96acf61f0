"""Divergence detection over the monitor's stat stream.

Counterpart of ``mxnet_tpu/monitor/divergence.py``.  Three signatures of a
run going bad, each firing one flight-record dump through
``trace.anomaly.divergence`` (reason ``divergence``, rate-limited like the
other anomaly reasons):

- **nonfinite gradients**: reported the moment a stat vector shows
  ``g_nonfinite > 0``, naming the offending group (the first in ascending
  parameter order, the layer that diverged first);
- **grad-norm spike**: the global gradient norm exceeds
  ``MXNET_MONITOR_SPIKE_FACTOR`` x the trailing window's maximum (default
  10; 0 turns it off; ``MXNET_MONITOR_SPIKE_WINDOW`` observations, 64);
- **loss nonfinite or plateau**: ``observe_loss`` (any training loop)
  dumps on a nonfinite loss at once and, when
  ``MXNET_MONITOR_PLATEAU_WINDOW`` > 0, once an episode after that many
  observations without a new best.
"""
from __future__ import annotations

import math
import threading
from collections import deque

from ..base import get_env

__all__ = ["DivergenceDetector", "DETECTOR", "observe_loss"]


def _dump(extra):
    from ..trace import anomaly

    return anomaly.divergence(extra)


class DivergenceDetector:
    """Trailing-window detectors over grad norms and loss values."""

    def __init__(self, spike_factor=None, window=None, min_samples=8,
                 plateau_window=None):
        self._lock = threading.Lock()
        self._norms = deque(maxlen=2)
        self.min_samples = int(min_samples)
        self._configure(spike_factor, window, plateau_window)
        self.spikes = 0
        self.nonfinite_grad_steps = 0
        self.loss_best = None
        self.loss_last = None
        self.loss_nonfinite = 0
        self.plateaus = 0
        self._since_improve = 0
        self._in_plateau = False

    def _configure(self, spike_factor, window, plateau_window):
        if spike_factor is None:
            spike_factor = get_env("MXNET_MONITOR_SPIKE_FACTOR",
                                   float, 10.0)
        if window is None:
            window = get_env("MXNET_MONITOR_SPIKE_WINDOW", int, 64)
        if plateau_window is None:
            plateau_window = get_env("MXNET_MONITOR_PLATEAU_WINDOW",
                                     int, 0)
        self.spike_factor = float(spike_factor)
        self.plateau_window = int(plateau_window)
        window = max(2, int(window))
        with self._lock:
            if window != self._norms.maxlen:
                self._norms = deque(self._norms, maxlen=window)

    def refresh_env(self):
        """Re-read the MXNET_MONITOR_SPIKE_*/_PLATEAU_WINDOW knobs.
        The module-level ``DETECTOR`` is built when the package is
        imported; ``monitor.enable()`` calls this so that enabling at run
        time sees the environment as it is then (a detector built with
        explicit arguments is never refreshed: its arguments win)."""
        self._configure(None, None, None)

    # -- gradient stream ----------------------------------------------------
    def observe_grad_norm(self, norm, step=None):
        """Feed one global grad norm; returns the dump path when this
        observation tripped the spike detector, else None.  Nonfinite
        norms are counted but NOT windowed (they'd poison the trailing
        max) — the sentinel owns the nonfinite dump."""
        if not math.isfinite(norm):
            with self._lock:
                self.nonfinite_grad_steps += 1
            return None
        path = None
        with self._lock:
            # a window shorter than min_samples must still warm up (the
            # deque can never hold min_samples entries), else a small
            # MXNET_MONITOR_SPIKE_WINDOW silently disables detection
            warm = len(self._norms) >= min(self.min_samples,
                                           self._norms.maxlen)
            trailing_max = max(self._norms) if self._norms else 0.0
            spiked = (self.spike_factor > 0 and warm and trailing_max > 0
                      and norm > self.spike_factor * trailing_max)
            if spiked:
                self.spikes += 1
            self._norms.append(norm)
        if spiked:
            path = _dump({"kind": "grad_norm_spike", "step": step,
                          "grad_global_norm": round(norm, 6),
                          "trailing_max": round(trailing_max, 6),
                          "factor": self.spike_factor})
        return path

    def nonfinite(self, group, st, step=None, policy=None):
        """Sentinel trip -> the divergence dump naming the offending
        group.  Returns the dump path (None when rate-limited or the
        ring is empty)."""
        with self._lock:
            self.nonfinite_grad_steps += 1
        return _dump({"kind": "nonfinite_grads", "group": group,
                      "step": step, "policy": policy,
                      "grad_nonfinite": int(st["g_nonfinite"]),
                      "weight_nonfinite": int(st["w_nonfinite"]),
                      "grad_max_abs": round(st["g_max_abs"], 6)})

    # -- loss stream --------------------------------------------------------
    def observe_loss(self, value, step=None):
        """Feed one (host float) loss value; dumps on NaN/Inf, and once
        per plateau episode when the plateau window is armed."""
        value = float(value)
        if not math.isfinite(value):
            with self._lock:
                self.loss_nonfinite += 1
                self.loss_last = value
            return _dump({"kind": "loss_nonfinite", "step": step,
                          "loss": repr(value)})
        dump_plateau = False
        with self._lock:
            self.loss_last = value
            if self.loss_best is None or value < self.loss_best:
                self.loss_best = value
                self._since_improve = 0
                self._in_plateau = False
            else:
                self._since_improve += 1
                if (self.plateau_window > 0 and not self._in_plateau
                        and self._since_improve >= self.plateau_window):
                    self._in_plateau = True
                    self.plateaus += 1
                    dump_plateau = True
        if dump_plateau:
            return _dump({"kind": "loss_plateau", "step": step,
                          "loss": round(value, 6),
                          "best": round(self.loss_best, 6),
                          "window": self.plateau_window})
        return None

    # -- introspection ------------------------------------------------------
    def state(self):
        """The detector's counters and windows, as a dict."""
        with self._lock:
            return {
                "spike_factor": self.spike_factor,
                "window": self._norms.maxlen,
                "window_fill": len(self._norms),
                "trailing_max": max(self._norms) if self._norms else 0.0,
                "spikes": self.spikes,
                "nonfinite_grad_steps": self.nonfinite_grad_steps,
                "loss_last": self.loss_last,
                "loss_best": self.loss_best,
                "loss_nonfinite": self.loss_nonfinite,
                "plateau_window": self.plateau_window,
                "plateaus": self.plateaus,
                "since_improve": self._since_improve,
            }

    def reset(self):
        with self._lock:
            self._norms.clear()
            self.spikes = 0
            self.nonfinite_grad_steps = 0
            self.loss_best = None
            self.loss_last = None
            self.loss_nonfinite = 0
            self.plateaus = 0
            self._since_improve = 0
            self._in_plateau = False


DETECTOR = DivergenceDetector()


def observe_loss(value, step=None):
    """Module-level loss feed (works whether or not the monitor is on:
    it is host float math; the dump itself needs mx.trace on)."""
    return DETECTOR.observe_loss(value, step=step)
