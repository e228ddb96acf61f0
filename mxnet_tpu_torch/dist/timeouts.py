"""Collective deadlines — no rank ever hangs forever in an all-reduce.

Counterpart of ``mxnet_tpu/dist/timeouts.py``, backend-free and copied
whole.  The classic multi-host failure: one rank dies (OOM, preemption,
SIGKILL) and every peer blocks in the next all-reduce with nothing to
time it out.  ``run_with_deadline`` closes that hole: the collective
body runs on a worker thread, the caller joins it under
``MXNET_DIST_COLLECTIVE_TIMEOUT`` seconds, and a miss raises
``DistTimeout`` — which the supervisor's taxonomy classifies
*transient* (``mx_fault_kind``), so the failure routes into the
coordinated world-stop/restart path instead of a hang.

``DistTimeout.mx_state_clean`` is True: every wired collective site
(gradient pushpull, init broadcast) runs BEFORE any optimizer state
mutates, so a rank rescued by the deadline still holds the last
completed step's state bit-exact and may emergency-checkpoint it.

The blocked worker thread itself cannot be interrupted (the hang is
inside the backend); it is a daemon and is abandoned — the caller is
expected to checkpoint and exit, which is exactly what the dist
supervisor mode does.  The trace watchdog is armed around every
deadline so the hang also leaves all-thread stacks + a flight record.
"""
from __future__ import annotations

import queue
import threading

from .. import telemetry, trace
from ..base import MXNetError, get_env

__all__ = ["DistTimeout", "collective_timeout", "run_with_deadline"]

# idle deadline workers, reused across collectives so the armed hot
# path (one pushpull_all per training step) does not create a thread
# per call.  A worker that missed its deadline is still blocked inside
# the collective and is simply never re-pooled — only an actual hang
# costs a replacement thread.
_IDLE_LOCK = threading.Lock()
_IDLE = []
_IDLE_MAX = 4


def _worker_loop(q):
    while True:
        fn, box, done = q.get()
        try:
            box["result"] = fn()
        except BaseException as exc:  # noqa: BLE001 - re-raised by caller
            box["error"] = exc
        finally:
            done.set()


def _checkout_worker():
    with _IDLE_LOCK:
        if _IDLE:
            return _IDLE.pop()
    q = queue.Queue()
    threading.Thread(target=_worker_loop, args=(q,), daemon=True,
                     name="mx-dist-deadline").start()
    return q


def _checkin_worker(q):
    with _IDLE_LOCK:
        if len(_IDLE) < _IDLE_MAX:
            _IDLE.append(q)
            return
    # excess worker: nothing will feed its queue again; it idles as a
    # parked daemon (bounded by the burst that created it)


class DistTimeout(MXNetError):
    """A collective (or pod barrier) missed its deadline.

    ``mx_fault_kind = "transient"`` routes it into the supervisor's
    retry/world-restart path (a bare ``MXNetError`` would classify
    fatal); ``mx_state_clean = True`` records that the failure fired
    before any optimizer state mutated, so the emergency checkpoint of
    the last completed step is trustworthy."""

    mx_fault_kind = "transient"
    mx_state_clean = True

    def __init__(self, msg, site=None, timeout=None):
        super().__init__(msg)
        self.site = site
        self.timeout = timeout


def collective_timeout():
    """Armed deadline in seconds (``MXNET_DIST_COLLECTIVE_TIMEOUT``);
    0 disables (the single-process default: a world of one has no peer
    to wait for)."""
    return get_env("MXNET_DIST_COLLECTIVE_TIMEOUT", float, 0.0)


def run_with_deadline(fn, site="collective", timeout=None):
    """Run ``fn()`` bounded by ``timeout`` seconds (default: the armed
    ``collective_timeout()``); returns its result, re-raises its
    exception, or raises :class:`DistTimeout` on a miss.

    ``timeout`` absent/<=0 runs ``fn`` inline — no thread, no cost.
    The watchdog scope means a deadline LONGER than the watchdog's
    no-progress bound still produces stacks before the timeout fires.
    """
    if timeout is None:
        timeout = collective_timeout()
    if not timeout or timeout <= 0:
        return fn()
    box = {}
    done = threading.Event()
    q = _checkout_worker()
    with trace.watchdog.watch(site):
        q.put((fn, box, done))
        finished = done.wait(float(timeout))
    if finished:
        _checkin_worker(q)
    else:
        if telemetry.ENABLED:
            telemetry.DIST_COLLECTIVE_TIMEOUTS.labels(site=site).inc()
        # the dump carries the blocked worker's stack: "waiting in the
        # all-reduce for rank k" is the triage line that matters

        trace.dump_async("dist_timeout", extra={
            "site": site, "timeout_seconds": float(timeout)})
        raise DistTimeout(
            "collective %r exceeded MXNET_DIST_COLLECTIVE_TIMEOUT="
            "%.1fs — a peer rank is unreachable (dead, preempted, or "
            "partitioned); the worker thread is abandoned and this "
            "rank should checkpoint and exit" % (site, float(timeout)),
            site=site, timeout=float(timeout))
    if "error" in box:
        raise box["error"]
    return box.get("result")
