"""Per-bucket circuit breakers for mx.serve.

Counterpart of ``mxnet_tpu/serve/breaker.py``.  Each bucket class gets a
three-state breaker:

- **closed** -- normal traffic; consecutive failed dispatches are counted,
  successes reset the count.
- **open** -- after ``threshold`` consecutive failures the bucket is
  quarantined: submissions and dispatches are rejected immediately for
  ``cooldown`` seconds.  Other buckets are untouched.
- **half-open** -- after the cooldown EXACTLY ONE trial dispatch is
  admitted.  Success closes the breaker, failure re-opens it, and a trial
  that never resolves lets a new trial in one cooldown after it was
  admitted.

Failures are counted per *dispatch*, not per request: the bisect retry in
``batching.Scheduler`` has already confined the damage to the poisoned
request itself.
"""
from __future__ import annotations

import threading
import time

from .. import telemetry

__all__ = ["CLOSED", "OPEN", "HALF_OPEN", "CircuitBreaker",
           "BreakerBoard"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """One bucket's breaker (see module doc).  ``clock`` is injectable
    for deterministic tests."""

    def __init__(self, threshold=5, cooldown=30.0, clock=time.monotonic,
                 label=None):
        self.threshold = max(1, int(threshold))
        self.cooldown = float(cooldown)
        self._clock = clock
        self._label = label
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive, while closed
        self._opened_at = None
        self._trial_at = None       # half-open trial admission time
        self.trips = 0              # lifetime closed/half-open -> open

    def _set_state(self, state):
        self._state = state
        if state != HALF_OPEN:
            self._trial_at = None
        if telemetry.ENABLED and self._label is not None:
            telemetry.SERVE_BREAKER_STATE.labels(
                bucket=self._label).set(_STATE_GAUGE[state])

    def _maybe_half_open_locked(self, now):
        if self._state == OPEN and now - self._opened_at >= self.cooldown:
            self._set_state(HALF_OPEN)

    def _trial_inflight_locked(self, now):
        return self._trial_at is not None and \
            now - self._trial_at < self.cooldown

    def blocked(self):
        """Submit-time probe: True while OPEN with cooldown remaining, and
        while the half-open trial is in flight."""
        with self._lock:
            now = self._clock()
            self._maybe_half_open_locked(now)
            if self._state == OPEN:
                return True
            return self._state == HALF_OPEN and \
                self._trial_inflight_locked(now)

    def allow(self):
        """Dispatch-time gate: CLOSED admits, OPEN rejects until the
        cooldown elapses, HALF_OPEN admits exactly one caller (the trial)."""
        with self._lock:
            now = self._clock()
            self._maybe_half_open_locked(now)
            if self._state == OPEN:
                return False
            if self._state == HALF_OPEN:
                if self._trial_inflight_locked(now):
                    return False
                self._trial_at = now   # this caller IS the trial
            return True

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._trial_at = None
            if self._state != CLOSED:
                self._set_state(CLOSED)
                self._opened_at = None

    def record_failure(self):
        """One failed dispatch; True when this strike opened (or re-opened)
        the breaker."""
        with self._lock:
            now = self._clock()
            self._maybe_half_open_locked(now)
            if self._state == HALF_OPEN:
                tripped = True          # the trial failed: re-open
                self._trial_at = None
            else:
                self._failures += 1
                tripped = self._state == CLOSED and \
                    self._failures >= self.threshold
            if tripped:
                self._set_state(OPEN)
                self._opened_at = now
                self._failures = 0
                self.trips += 1
        if tripped and telemetry.ENABLED and self._label is not None:
            telemetry.SERVE_BREAKER_TRIPS.labels(bucket=self._label).inc()
        return tripped

    def retry_after(self):
        """Seconds until the next half-open trial (0 when admitting)."""
        with self._lock:
            if self._state != OPEN or self._opened_at is None:
                return 0.0
            return max(0.0, self.cooldown -
                       (self._clock() - self._opened_at))

    def state(self):
        with self._lock:
            now = self._clock()
            self._maybe_half_open_locked(now)
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "trial_inflight": self._state == HALF_OPEN
                and self._trial_inflight_locked(now),
                "trips": self.trips,
                "retry_after_seconds": round(
                    max(0.0, self.cooldown - (now - self._opened_at))
                    if self._state == OPEN and self._opened_at
                    is not None else 0.0, 3),
            }


class BreakerBoard:
    """The per-bucket breaker registry one Server owns.  Read probes never
    allocate: only a recorded failure creates a breaker, so the board grows
    with failing buckets, not with traffic."""

    def __init__(self, threshold=5, cooldown=30.0, clock=time.monotonic):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers = {}

    @staticmethod
    def label(cls):
        return str(cls)

    def _get(self, cls):
        with self._lock:
            b = self._breakers.get(cls)
            if b is None:
                b = self._breakers[cls] = CircuitBreaker(
                    self.threshold, self.cooldown, clock=self._clock,
                    label=self.label(cls))
            return b

    def _peek(self, cls):
        with self._lock:
            return self._breakers.get(cls)

    def blocked(self, cls):
        b = self._peek(cls)
        return False if b is None else b.blocked()

    def allow(self, cls):
        b = self._peek(cls)
        return True if b is None else b.allow()

    def success(self, cls):
        b = self._peek(cls)
        if b is not None:
            b.record_success()

    def failure(self, cls):
        return self._get(cls).record_failure()

    def retry_after(self, cls):
        b = self._peek(cls)
        return 0.0 if b is None else b.retry_after()

    def quarantine_error(self, cls):
        """The one ``BucketQuarantined`` for this bucket: a single
        ``retry_after`` read feeds both the message and the attribute."""
        from .batching import BucketQuarantined

        ra = self.retry_after(cls)
        return BucketQuarantined(
            "bucket %r quarantined by its circuit breaker (repeated "
            "dispatch failures); retry after %.1fs" % (cls, ra),
            retry_after=ra)

    def snapshot(self):
        with self._lock:
            items = list(self._breakers.items())
        return {self.label(cls): b.state() for cls, b in items}
