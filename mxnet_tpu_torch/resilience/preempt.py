"""Preemption-aware graceful shutdown.

Counterpart of ``mxnet_tpu/resilience/preempt.py``, backend-free and
copied whole.  A cluster scheduler preempts a job by sending SIGTERM,
waiting a grace window, then SIGKILLing it; without a handler a trainer
dies mid-step with up to ``checkpoint_every`` steps of work lost and the
serve queue dropped.

The contract here:

- ``install()`` arms a SIGTERM handler (``MXNET_PREEMPT_INSTALL=1``
  arms it at import).  The handler does the absolute minimum a signal
  context allows — it records the request and the grace deadline
  (``MXNET_PREEMPT_GRACE_SECONDS``); a SECOND SIGTERM hard-exits
  immediately (the operator meant it).
- ``requested()`` / ``preemption_imminent()`` are the polls: the
  supervisor checks at every step boundary and, when set, stops the
  loop, takes an emergency checkpoint through the async writer
  (flush + ``wait()``), runs the registered shutdown hooks (mx.serve
  registers a graceful drain), and exits with the distinct
  ``MXNET_PREEMPT_EXIT_CODE`` so the pod scheduler can tell "clean
  preemption, resume me" from a crash.
- ``request()`` is the same path minus the signal — drills and tests
  trigger preemption programmatically and deterministically.
"""
from __future__ import annotations

import threading
import time

from .. import telemetry, trace
from ..base import get_env

__all__ = ["install", "uninstall", "installed", "request", "requested",
           "preemption_imminent", "remaining", "clear", "exit_code",
           "grace_seconds", "add_shutdown_hook", "remove_shutdown_hook",
           "graceful_shutdown", "state"]

_LOCK = threading.Lock()
_STATE = {
    "requested_at": None,   # time.monotonic() of the request
    "deadline": None,       # requested_at + grace
    "source": None,         # "sigterm" | "api"
    "installed": False,
    "prev_handler": None,
}
# written ONLY by the signal handler (plain dict stores — no locks: the
# handler runs on the main thread between bytecodes and may interrupt a
# frame that HOLDS _LOCK or telemetry's lock; acquiring either there
# would deadlock the process right when it most needs to shut down).
# The polling side absorbs these into _STATE under the lock.
_SIGNAL = {"count": 0, "at": None}
_HOOKS = []                 # [(name, fn)] run by graceful_shutdown


def _absorb_signal():
    """Complete the SIGTERM bookkeeping (lock, telemetry, trace) OUT of
    signal context — called by every poll/state entry point.  The
    grace deadline is anchored at the handler's timestamp, NOT at
    absorb time: the pod scheduler's SIGKILL clock started when the
    signal landed, and a long step between signal and poll must not
    inflate the budget we think we have."""
    if _SIGNAL["at"] is not None:
        request(source="sigterm", at=_SIGNAL["at"])  # first caller wins


_GRACE_OVERRIDE = None      # install(grace=...) beats the env var


def grace_seconds():
    if _GRACE_OVERRIDE is not None:
        return _GRACE_OVERRIDE
    return get_env("MXNET_PREEMPT_GRACE_SECONDS", float, 30.0)


def exit_code():
    """The distinct "clean preemption" exit status (default 85)."""
    return get_env("MXNET_PREEMPT_EXIT_CODE", int, 85)


def request(source="api", grace=None, at=None):
    """Mark preemption imminent: start the grace clock, count it, and
    leave a trace instant.  Idempotent — only the first request sets
    the deadline.  ``at`` back-dates the clock to when the signal
    actually arrived.  Returns the grace deadline (monotonic)."""
    with _LOCK:
        if _STATE["requested_at"] is None:
            now = time.monotonic() if at is None else float(at)
            _STATE["requested_at"] = now
            _STATE["source"] = source
            _STATE["deadline"] = now + (grace_seconds() if grace is None
                                        else float(grace))
            first = True
        else:
            first = False
        deadline = _STATE["deadline"]
    if first:
        if telemetry.ENABLED:
            telemetry.RESILIENCE_PREEMPTIONS.inc()
        trace.instant("preemption_requested", cat="resilience",
                      args={"source": source,
                            "grace_seconds": round(
                                deadline - _STATE["requested_at"], 3)})
    return deadline


def requested():
    _absorb_signal()
    with _LOCK:
        return _STATE["requested_at"] is not None


def preemption_imminent():
    """The supervisor's poll (alias of ``requested`` with the name the
    pod-runtime literature uses)."""
    return requested()


def remaining():
    """Seconds of grace budget left, or None when no preemption is
    pending.  Negative means the budget is already blown — shutdown
    work should be cut short (skip drains, keep the checkpoint)."""
    _absorb_signal()
    with _LOCK:
        if _STATE["deadline"] is None:
            return None
        return _STATE["deadline"] - time.monotonic()


def clear():
    """Reset the pending request (tests / a cancelled preemption)."""
    with _LOCK:
        _STATE["requested_at"] = None
        _STATE["deadline"] = None
        _STATE["source"] = None
    _SIGNAL["count"] = 0
    _SIGNAL["at"] = None


def _handler(signum, frame):  # pragma: no cover - exercised in drills
    # ASYNC-SIGNAL CONTEXT: plain stores and os._exit only.  No locks,
    # no telemetry, no logging — the interrupted main-thread frame may
    # hold any of those locks (the supervisor polls requested() under
    # _LOCK every step), and blocking here would hang the process
    # through the whole grace window, checkpoint-less.
    _SIGNAL["count"] += 1
    if _SIGNAL["count"] >= 2:
        # the scheduler (or operator) is done waiting
        import os

        os._exit(exit_code())
    _SIGNAL["at"] = time.monotonic()


def install(grace=None):
    """Arm the SIGTERM handler (main thread only; returns False when
    that is impossible, e.g. installed from a worker thread).  The
    previous handler is kept and restored by ``uninstall``.

    ``grace`` overrides ``MXNET_PREEMPT_GRACE_SECONDS`` for FUTURE
    requests (a pending request keeps its own deadline) — applied even
    when the handler is already armed, and kept in process state, not
    the environment, so it never leaks into child processes."""
    import signal

    global _GRACE_OVERRIDE
    if grace is not None:
        _GRACE_OVERRIDE = float(grace)
    with _LOCK:
        if _STATE["installed"]:
            return True
    try:
        prev = signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # not the main thread
        return False
    with _LOCK:
        _STATE["installed"] = True
        _STATE["prev_handler"] = prev
    return True


def uninstall():
    import signal

    with _LOCK:
        if not _STATE["installed"]:
            return
        prev = _STATE["prev_handler"]
        _STATE["installed"] = False
        _STATE["prev_handler"] = None
    try:
        signal.signal(signal.SIGTERM,
                      prev if prev is not None else signal.SIG_DFL)
    except ValueError:  # pragma: no cover
        pass


def installed():
    with _LOCK:
        return _STATE["installed"]


def add_shutdown_hook(name, fn):
    """Register work ``graceful_shutdown`` runs (serve drain, loader
    stop, ...).  Hooks run newest-first so the last-started subsystem
    quiesces first.  Re-registering a name replaces the old hook."""
    with _LOCK:
        _HOOKS[:] = [(n, f) for n, f in _HOOKS if n != name]
        _HOOKS.append((name, fn))


def remove_shutdown_hook(name):
    with _LOCK:
        _HOOKS[:] = [(n, f) for n, f in _HOOKS if n != name]


def graceful_shutdown():
    """Run every registered shutdown hook (newest-first), best-effort:
    a failing hook is logged and the rest still run — the emergency
    checkpoint the supervisor already took must not be hostage to a
    slow drain.  Returns ``{name: "ok" | "error: ..."}``."""
    import logging

    with _LOCK:
        hooks = list(reversed(_HOOKS))
    results = {}
    for name, fn in hooks:
        try:
            fn()
            results[name] = "ok"
        except Exception as exc:  # noqa: BLE001 - best-effort by design
            results[name] = "error: %s" % (exc,)
            logging.getLogger("mxnet_tpu_torch.resilience").warning(
                "preemption shutdown hook %r failed: %s", name, exc)
    return results


def state():
    """Snapshot of the preemption state (diagnostics)."""

    _absorb_signal()
    with _LOCK:
        return {
            "installed": _STATE["installed"],
            "requested": _STATE["requested_at"] is not None,
            "source": _STATE["source"],
            "signals": _SIGNAL["count"],
            "grace_remaining": None if _STATE["deadline"] is None
            else _STATE["deadline"] - time.monotonic(),
            "hooks": [n for n, _ in _HOOKS],
            "exit_code": exit_code(),
        }
