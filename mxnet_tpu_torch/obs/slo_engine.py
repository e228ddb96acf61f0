"""Declarative SLOs over live telemetry, with multi-window burn rates.

Counterpart of ``mxnet_tpu/obs/slo_engine.py``, backend-free and copied
whole.  An objective binds a target to a metric family already being

collected — no second measurement path:

- **latency**: ``obs.slo("serve_p99", histogram="serve_request_seconds",
  q=0.99, target=0.2)`` — "99% of requests complete under 200 ms".
  "Bad" events are observations above ``target``, counted from the
  histogram's cumulative buckets (linear interpolation inside the
  covering bucket; observations in the +Inf overflow bucket count as
  bad — the buckets cannot prove them good).
- **error rate**: ``obs.slo("serve_errors", counter=
  "serve_requests_total", bad={"result": "error"}, objective=0.999)``
  — "99.9% of requests succeed".

Evaluation follows the standard SRE multi-window burn-rate
formulation: the error-budget burn rate over a window is
``(bad/total over the window) / (1 - objective)`` — burn 1.0 consumes
exactly the budget over the SLO period; burn 14.4 exhausts a 30-day
budget in 2 days.  Two windows guard against both noise and slow
leaks: **PAGE** when BOTH the fast (``MXNET_OBS_SLO_FAST_SECONDS``,
default 5 m) and slow (``MXNET_OBS_SLO_SLOW_SECONDS``, default 1 h)
windows burn >= ``page_burn`` (default 14.4); **WARN** when both
burn >= ``warn_burn`` (default 6.0); else **OK**.  A quiet window
(no traffic) burns 0 — absence of traffic is not an outage here.

States surface as telemetry gauges (``obs_slo_state`` 0/1/2,
``obs_slo_burn_rate{slo,window}``), in ``serve.Server`` ``/statz`` +
``/healthz`` (degraded), and in the periodic telemetry log line.
Everything is windowed from cumulative counters sampled at evaluate
time — the engine keeps a bounded series per objective and never
touches a hot path.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque

from .. import telemetry as _tel
from ..base import get_env

__all__ = ["SLObjective", "slo", "remove", "clear", "registered",
           "evaluate", "states", "worst", "STATE_LEVELS"]

STATE_LEVELS = {"OK": 0, "WARN": 1, "PAGE": 2}

_LOCK = threading.Lock()
_REGISTRY = {}


def _windows():
    return (get_env("MXNET_OBS_SLO_FAST_SECONDS", float, 300.0),
            get_env("MXNET_OBS_SLO_SLOW_SECONDS", float, 3600.0))


def _le_count(cum, bound):
    """Observations <= ``bound`` from cumulative buckets [(ub, c)]
    (linear interpolation inside the covering bucket).  Overflow
    (+Inf) observations are NOT counted below any finite bound — the
    buckets cannot prove them good, so they count against the SLO."""
    prev_ub, prev_c = 0.0, 0.0
    for ub, c in cum:
        if ub == float("inf"):
            return prev_c
        if bound < ub:
            width = ub - prev_ub
            if width <= 0:
                return float(c)
            frac = max(0.0, (bound - prev_ub)) / width
            return prev_c + (c - prev_c) * frac
        prev_ub, prev_c = ub, float(c)
    return prev_c


class SLObjective:
    """One declarative objective + its bounded cumulative series."""

    def __init__(self, name, histogram=None, q=0.99, target=None,
                 counter=None, bad=None, objective=None,
                 warn_burn=6.0, page_burn=14.4, labels=None):
        if (histogram is None) == (counter is None):
            raise ValueError(
                "slo %r: exactly one of histogram=/counter= required"
                % name)
        self.name = str(name)
        self.histogram = histogram
        self.counter = counter
        self.bad_labels = dict(bad or {})
        self.labels = dict(labels or {}) or None
        self.q = float(q)
        self.target = None if target is None else float(target)
        if histogram is not None:
            if self.target is None:
                raise ValueError("slo %r: latency objective needs "
                                 "target= (seconds)" % name)
            self.objective = self.q
        else:
            self.objective = 0.999 if objective is None \
                else float(objective)
        self.budget = max(1e-9, 1.0 - self.objective)
        self.warn_burn = float(warn_burn)
        self.page_burn = float(page_burn)
        self._series = deque()  # (t, bad, total) cumulative samples
        self._lock = threading.Lock()
        self.state = "OK"

    # -- cumulative (bad, total) from live telemetry -------------------------
    def _read(self):
        if self.histogram is not None:
            m = _tel.get_metric(self.histogram)
            if m is None or m.kind != "histogram":
                return 0.0, 0.0
            count, _total, cum = _tel._merged_read(m, match=self.labels)
            if not count:
                return 0.0, 0.0
            good = _le_count(cum, self.target)
            return max(0.0, count - good), float(count)
        total = _tel.value(self.counter)
        bad = _tel.value(self.counter, labels=self.bad_labels)
        return float(bad), float(total)

    def _burn(self, now, window):
        """Error-budget burn rate over the trailing ``window``: the
        windowed bad fraction divided by the budget fraction."""
        with self._lock:
            series = list(self._series)
        if len(series) < 2:
            return 0.0
        latest = series[-1]
        base = series[0]
        for s in series:
            if s[0] <= now - window:
                base = s
            else:
                break
        dbad = latest[1] - base[1]
        dtotal = latest[2] - base[2]
        if dtotal <= 0 or dbad <= 0:
            return 0.0
        return (dbad / dtotal) / self.budget

    def evaluate(self, now=None):
        """Sample the cumulative counters, prune the series, compute
        fast/slow burn rates, and resolve the state."""
        now = time.monotonic() if now is None else now
        fast_w, slow_w = _windows()
        bad, total = self._read()
        with self._lock:
            self._series.append((now, bad, total))
            horizon = now - (slow_w * 1.5 + 60.0)
            while len(self._series) > 2 and self._series[1][0] < horizon:
                self._series.popleft()
        fast = self._burn(now, fast_w)
        slow = self._burn(now, slow_w)
        if fast >= self.page_burn and slow >= self.page_burn:
            self.state = "PAGE"
        elif fast >= self.warn_burn and slow >= self.warn_burn:
            self.state = "WARN"
        else:
            self.state = "OK"
        return {"state": self.state,
                "burn_fast": round(fast, 4),
                "burn_slow": round(slow, 4),
                "bad": bad if not math.isnan(bad) else 0.0,
                "total": total,
                "objective": self.objective,
                "target_s": self.target,
                "windows_s": [fast_w, slow_w]}


# ---------------------------------------------------------------------------
# registry + module API
# ---------------------------------------------------------------------------

def slo(name, histogram=None, q=0.99, target=None, counter=None,
        bad=None, objective=None, warn_burn=6.0, page_burn=14.4,
        labels=None):
    """Register (or replace) a declarative objective; returns it.
    See the module docstring for the two forms.  ``labels=`` scopes a
    histogram objective to matching children only (e.g. per-tenant
    TTFT: ``labels={"tenant": "acme"}``)."""
    obj = SLObjective(name, histogram=histogram, q=q, target=target,
                      counter=counter, bad=bad, objective=objective,
                      warn_burn=warn_burn, page_burn=page_burn,
                      labels=labels)
    with _LOCK:
        _REGISTRY[obj.name] = obj
    return obj


def remove(name):
    with _LOCK:
        _REGISTRY.pop(str(name), None)


def clear():
    with _LOCK:
        _REGISTRY.clear()


def registered():
    """Registered objective names (evaluation order)."""
    with _LOCK:
        return list(_REGISTRY)


def evaluate(now=None):
    """Evaluate every objective: {name: {state, burn_fast, burn_slow,
    ...}}; refreshes the ``obs_slo_state`` / ``obs_slo_burn_rate``
    gauges.  Fail-soft per objective — one sick objective cannot take
    the rest (or the caller) down."""
    with _LOCK:
        objs = list(_REGISTRY.values())
    out = {}
    for obj in objs:
        try:
            res = obj.evaluate(now=now)
        except Exception as exc:  # noqa: BLE001
            res = {"state": "OK", "error": str(exc)[:200],
                   "burn_fast": 0.0, "burn_slow": 0.0}
        out[obj.name] = res
        if _tel.ENABLED:
            _tel.OBS_SLO_STATE.labels(slo=obj.name).set(
                STATE_LEVELS.get(res["state"], 0))
            _tel.OBS_SLO_BURN.labels(slo=obj.name, window="fast").set(
                res.get("burn_fast", 0.0))
            _tel.OBS_SLO_BURN.labels(slo=obj.name, window="slow").set(
                res.get("burn_slow", 0.0))
    return out


def states(now=None):
    """Condensed {name: state} (evaluates first)."""
    return {k: v["state"] for k, v in evaluate(now=now).items()}


def worst(now=None):
    """The worst current state across objectives ("OK" when none)."""
    best = "OK"
    for st in states(now=now).values():
        if STATE_LEVELS.get(st, 0) > STATE_LEVELS[best]:
            best = st
    return best
