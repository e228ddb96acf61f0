"""mx.obs core — the enable flag, per-rank step cadence, and the
KV publisher that rides the membership heartbeat.

Counterpart of ``mxnet_tpu/obs/core.py``, backend-free and copied whole.
The publisher is deliberately dumb transport: one JSON record per
(generation, rank) under ``obs/<gen>/<rank>`` in the SAME KV backend
mx.dist membership heartbeats through.  Records are overwritten in
place — the fleet view only ever
wants the latest — and carry their own wall clock, so staleness is
judged exactly like membership judges liveness (no mtime games).

Publish cadence piggybacks on the membership heartbeat thread
(``Membership.on_beat``) rate-limited to ``MXNET_OBS_PUBLISH_SECONDS``
— obs adds ZERO threads of its own.  A failing publish (lost shared
FS, dead coordinator) counts ``obs_publish_failures_total`` and
degrades the fleet to local-only snapshots; it never raises into the
heartbeat thread or the training loop.  ``mx.dist.Membership`` waits
for multi-GPU (``ROADMAP.md`` Queue 1 item 7): ``attach`` takes any
object with its ``rank``, ``generation`` and ``kv`` and, with no
membership module to hook, publishes from ``note_step`` alone.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque

from .. import telemetry as _tel
from ..base import get_env

_LOG = logging.getLogger("mxnet_tpu_torch.obs")

__all__ = ["ENABLED", "enable", "disable", "is_enabled", "note_step",
           "step_stats", "local_payload", "Publisher", "attach",
           "detach", "publisher", "obs_key"]

ENABLED = get_env("MXNET_OBS", bool, False)


def enable():
    """Arm the obs plane for this process (equivalent MXNET_OBS=1)."""
    global ENABLED
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


def is_enabled():
    return ENABLED


# ---------------------------------------------------------------------------
# step cadence: the per-rank series the straggler detector feeds on
# ---------------------------------------------------------------------------

_STEP_LOCK = threading.Lock()
_STEP_WINDOW = deque(maxlen=256)
_STEP_COUNT = 0


def note_step(dur):
    """Record one training-step wall duration (seconds).  Called from
    ``Trainer.step`` and the captured-step dispatch — disabled cost is
    one flag check; enabled cost is a deque append + one histogram
    observe.  Never raises."""
    global _STEP_COUNT
    if not ENABLED:
        return
    try:
        dur = float(dur)
        with _STEP_LOCK:
            _STEP_WINDOW.append(dur)
            _STEP_COUNT += 1
        if _tel.ENABLED:
            _tel.OBS_STEP_SECONDS.observe(dur)
        pub = _PUBLISHER[0]
        if pub is not None:
            pub.maybe_publish()
    except Exception:  # noqa: BLE001 - obs must never raise into step()
        pass


def step_stats():
    """{steps_observed, step_p50_s, step_last_s} over the recent
    window (the straggler detector's per-rank feed)."""
    with _STEP_LOCK:
        window = list(_STEP_WINDOW)
        n = _STEP_COUNT
    if not window:
        return {"steps_observed": n, "step_p50_s": None,
                "step_last_s": None}
    ordered = sorted(window)
    return {"steps_observed": n,
            "step_p50_s": ordered[len(ordered) // 2],
            "step_last_s": window[-1]}


def reset_steps():
    """Tests / between bench rows: forget the cadence window."""
    global _STEP_COUNT
    with _STEP_LOCK:
        _STEP_WINDOW.clear()
        _STEP_COUNT = 0


# ---------------------------------------------------------------------------
# the published payload
# ---------------------------------------------------------------------------

def _monitor_health():
    """Compact mx.monitor health for the payload, or None when the
    monitor plane is off (fail-soft: obs must publish even when the
    numerics plane is sick)."""
    try:
        from .. import monitor

        if not monitor.is_enabled():
            return None
        return monitor.core.health()
    except Exception:  # noqa: BLE001
        return None


def local_payload(rank=None, step=None):
    """This process's publishable observability record: telemetry
    snapshot + step cadence + collective-wait quantiles + monitor
    health.  The unit the fleet view merges."""
    cadence = step_stats()
    coll = _tel.histogram_quantiles("collective_seconds", qs=(0.5,))
    return {
        "rank": int(rank or 0),
        "pid": os.getpid(),
        "wall": time.time(),
        "step": step,
        "steps_observed": cadence["steps_observed"],
        "step_p50_s": cadence["step_p50_s"],
        "step_last_s": cadence["step_last_s"],
        "collective_wait_p50_s": coll.get(0.5),
        "monitor": _monitor_health(),
        "metrics": _tel.snapshot(),
    }


# ---------------------------------------------------------------------------
# publisher
# ---------------------------------------------------------------------------

def obs_key(generation, rank):
    return "obs/%d/%d" % (int(generation), int(rank))


class Publisher:
    """Publishes this rank's payload into the membership KV, at most
    every ``MXNET_OBS_PUBLISH_SECONDS`` (heartbeat-piggybacked)."""

    def __init__(self, membership, interval=None):
        self.membership = membership
        self.interval = get_env(
            "MXNET_OBS_PUBLISH_SECONDS", float, 5.0) \
            if interval is None else float(interval)
        self._last = None
        self._lock = threading.Lock()
        self.publishes = 0
        self.failures = 0

    def maybe_publish(self):
        """Rate-limited publish; the heartbeat/on_beat entry point."""
        if not ENABLED:
            return False
        now = time.monotonic()
        with self._lock:
            if self._last is not None and \
                    now - self._last < self.interval:
                return False
            self._last = now
        return self.publish()

    def publish(self):
        """Publish NOW (drills and step boundaries force it).  Returns
        True on success; a failing KV counts
        ``obs_publish_failures_total`` and degrades to local-only —
        never raises."""
        if not ENABLED:
            return False
        m = self.membership
        if m is None or m.generation is None:
            return False
        try:
            payload = local_payload(rank=m.rank,
                                    step=getattr(m, "_step", None))
            m.kv.set(obs_key(m.generation, m.rank), payload)
            self.publishes += 1
            if _tel.ENABLED:
                _tel.OBS_PUBLISHES.inc()
            return True
        except Exception as exc:  # noqa: BLE001 - degrade, never raise
            self.failures += 1
            if _tel.ENABLED:
                _tel.OBS_PUBLISH_FAILURES.inc()
            _LOG.warning("obs publish failed (local-only until the KV "
                         "recovers): %s", exc)
            return False


# module-global publisher: one per process, like the monitor publisher
_PUBLISHER = [None]
_BEAT_CB = [None]


def attach(membership, interval=None):
    """Wire the obs publisher to a joined :class:`~mxnet_tpu.dist.
    Membership`: payloads ride the heartbeat thread from here on
    (plus a forced publish per ``note_step`` window).  Returns the
    :class:`Publisher`.  Re-attaching replaces the previous wiring."""
    detach()
    pub = Publisher(membership, interval=interval)
    _PUBLISHER[0] = pub

    def _on_beat(mem):
        if mem is pub.membership:
            pub.maybe_publish()

    try:
        from ..dist import membership as _mm

        _mm.on_beat(_on_beat)
        _BEAT_CB[0] = _on_beat
    except Exception:  # noqa: BLE001 - publisher still usable directly
        _BEAT_CB[0] = None
    pub.maybe_publish()
    return pub


def detach():
    """Unhook the publisher (tests / world teardown)."""
    cb = _BEAT_CB[0]
    if cb is not None:
        try:
            from ..dist import membership as _mm

            _mm.remove_beat_listener(cb)
        except Exception:  # noqa: BLE001
            pass
    _BEAT_CB[0] = None
    _PUBLISHER[0] = None


def publisher():
    """The attached :class:`Publisher`, or None."""
    return _PUBLISHER[0]
