"""Hang watchdog: no-progress detection and all-thread stack dumps.

Counterpart of ``mxnet_tpu/trace/watchdog.py``.  When a step or a serving
dispatch stops making progress, a monitor thread notices after the
scope's timeout and writes both the flight record (the Chrome trace of
the ring) and a stack dump of every thread, so "what was the process
doing when it hung" has an answer even if it must then be killed.  Hot
loops wrap their unit of work in a watch scope::

    with trace.watchdog.watch("trainer_step"):
        ...one step...

A scope open (or not ``.beat()``-en) longer than its timeout fires once
an episode and counts ``trace_watchdog_fires_total{scope}``.  With no
watchdog armed a scope is a shared null context manager;
``MXNET_TRACE_WATCHDOG=1`` arms one at the first scope, or ``install()``
does; ``MXNET_TRACE_WATCHDOG_SECONDS`` is the default timeout (120)."""
from __future__ import annotations

import itertools
import logging
import os
import sys
import threading
import time
import traceback

from .. import telemetry
from ..base import get_env
from . import core, export

__all__ = ["Watchdog", "watch", "install", "uninstall", "get",
           "format_all_stacks"]

_LOGGER = logging.getLogger("mxnet_tpu_torch.trace")

_STACK_SEQ = itertools.count(1)


def format_all_stacks():
    """Human-readable stacks of every live thread (named, like
    faulthandler but with thread names and pure-python so it composes
    into a report file)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    lines = []
    for ident, frame in sorted(sys._current_frames().items()):
        lines.append("Thread %s (tid=%d):"
                     % (names.get(ident, "?"), ident))
        lines.extend(l.rstrip("\n")
                     for l in traceback.format_stack(frame))
        lines.append("")
    return "\n".join(lines)


class _NullWatch:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def beat(self):
        pass


_NULL = _NullWatch()


class _Watch:
    """One active watch scope (re-entrant per ``with``)."""

    __slots__ = ("name", "timeout", "start", "last", "_wd")

    def __init__(self, wd, name, timeout):
        self._wd = wd
        self.name = name
        self.timeout = timeout
        self.start = self.last = time.monotonic()

    def beat(self):
        """Progress heartbeat for long-lived scopes (per-iteration in a
        loop): resets the no-progress clock."""
        self.last = time.monotonic()

    def __enter__(self):
        self._wd._register(self)
        return self

    def __exit__(self, *exc):
        self._wd._unregister(self)
        return False


class Watchdog:
    """Monitor thread over active watch scopes.

    ``timeout`` — default no-progress bound per scope (seconds);
    ``poll`` — monitor wake interval (default: timeout/4, capped at
    5s).  ``on_fire`` — optional callback ``(scope_name, age_seconds)``
    for tests/embedders, called after the dump files are written."""

    def __init__(self, timeout=None, poll=None, on_fire=None):
        if timeout is None:
            timeout = get_env("MXNET_TRACE_WATCHDOG_SECONDS", float,
                              120.0)
        self.timeout = float(timeout)
        self.poll = float(poll) if poll is not None else \
            min(5.0, max(0.05, self.timeout / 4.0))
        self.on_fire = on_fire
        self.fires = 0
        self.last_report = None  # (scope_name, stacks_path, trace_path)
        self._lock = threading.Lock()
        self._scopes = {}
        self._stop = threading.Event()
        self._thread = None

    # -- scopes -------------------------------------------------------------
    def watch(self, name, timeout=None):
        """Context manager marking ``name`` busy until exit (or until
        the next ``.beat()``, for loops)."""
        return _Watch(self, name,
                      self.timeout if timeout is None else float(timeout))

    def _register(self, scope):
        with self._lock:
            self._scopes[id(scope)] = scope

    def _unregister(self, scope):
        with self._lock:
            self._scopes.pop(id(scope), None)

    def active(self):
        with self._lock:
            return [s.name for s in self._scopes.values()]

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="mx-trace-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(1.0, self.poll * 4))
        self._thread = None

    @property
    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def _loop(self):
        while not self._stop.wait(self.poll):
            try:
                self.check()
            except Exception:  # noqa: BLE001 - the monitor must survive
                _LOGGER.exception("trace watchdog check failed")

    # -- detection ----------------------------------------------------------
    def check(self, now=None):
        """One detection pass (the monitor loop's body, callable
        synchronously from tests).  Returns the scopes that fired."""
        now = time.monotonic() if now is None else now
        with self._lock:
            hung = [s for s in self._scopes.values()
                    if now - s.last > s.timeout]
            for s in hung:
                # resetting the clock yields one report per episode —
                # and a genuine follow-up report a full timeout later
                # when the scope is STILL hung, so operators can tell
                # "still stuck" from "recovered"
                s.last = now
        for s in hung:
            self._fire(s.name, now - s.start)
        return hung

    def _fire(self, name, age, reason="hang"):
        # mark the hang in the ring FIRST: the dump then contains the
        # hang point itself (and is never skipped for an empty ring
        # when the hang happened before any span completed)
        core.instant("watchdog_hang", cat="watchdog",
                     args={"scope": name, "age_seconds": round(age, 3)})
        # both artifacts share one stem (same reason, same sequence
        # number) so an operator triaging the dump dir pairs the right
        # stacks with the right flight record
        stem = os.path.join(
            export.dump_dir(), "mxtrace-%d-%s-%03d"
            % (os.getpid(), reason, next(_STACK_SEQ)))
        stacks_path = self._dump_stacks(stem + ".stacks.txt", name, age)
        trace_path = export.dump(
            path=stem + ".json", reason=reason,
            extra={"scope": name, "age_seconds": round(age, 3),
                   "timeout": self.timeout})
        self.fires += 1
        self.last_report = (name, stacks_path, trace_path)
        if telemetry.ENABLED:
            telemetry.TRACE_WATCHDOG_FIRES.labels(scope=name).inc()
        _LOGGER.error(
            "watchdog: no progress in scope %r for %.1fs — stacks: %s, "
            "flight record: %s", name, age, stacks_path, trace_path)
        if self.on_fire is not None:
            try:
                self.on_fire(name, age)
            except Exception:  # noqa: BLE001
                _LOGGER.exception("watchdog on_fire callback failed")
        return stacks_path, trace_path

    def _dump_stacks(self, path, name, age):
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        except OSError:
            return None
        try:
            with open(path, "w") as f:
                f.write("mx.trace watchdog report\n"
                        "scope        : %s\n"
                        "no progress  : %.1f s (timeout %.1f s)\n"
                        "wall time    : %s\n"
                        "active scopes: %s\n\n"
                        % (name, age, self.timeout, time.ctime(),
                           ", ".join(sorted(set(self.active())))
                           or "(none)"))
                f.write(format_all_stacks())
        except OSError:
            return None
        return path

    def dry_run(self):
        """Exercise the full report path without a hang (smoke tests,
        operator verification): writes stacks + flight record and
        returns ``(stacks_path, trace_path)``.  Dumps under its own
        never-rate-limited reason so a drill can't consume a real
        hang's dump budget."""
        return self._fire("dry_run", 0.0, reason="dry_run")


# ---------------------------------------------------------------------------
# module-level singleton
# ---------------------------------------------------------------------------

_WATCHDOG = None
_AUTO = get_env("MXNET_TRACE_WATCHDOG", bool, False)
# serializes the lazy auto-arm: two threads hitting their first watch()
# concurrently must not each install() (the loser would register its
# scope on a Watchdog whose monitor the winner just stopped)
_INSTALL_LOCK = threading.Lock()


def install(timeout=None, poll=None, on_fire=None, start=True):
    """Create (or replace) and start the process watchdog."""
    global _WATCHDOG
    if _WATCHDOG is not None:
        _WATCHDOG.stop()
    _WATCHDOG = Watchdog(timeout=timeout, poll=poll, on_fire=on_fire)
    if start:
        _WATCHDOG.start()
    return _WATCHDOG


def uninstall():
    """Stop and discard the process watchdog."""
    global _WATCHDOG
    if _WATCHDOG is not None:
        _WATCHDOG.stop()
        _WATCHDOG = None


def get():
    """The active process watchdog, or None."""
    return _WATCHDOG


def watch(name, timeout=None):
    """Watch scope on the process watchdog — a free null scope when no
    watchdog is armed (``MXNET_TRACE_WATCHDOG=1`` arms it lazily on
    first use)."""
    wd = _WATCHDOG
    if wd is None:
        if not _AUTO:
            return _NULL
        with _INSTALL_LOCK:
            wd = _WATCHDOG
            if wd is None:
                wd = install()
    return wd.watch(name, timeout)
