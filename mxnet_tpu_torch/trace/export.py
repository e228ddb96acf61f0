"""Flight-recorder export: Chrome-trace (Perfetto) JSON dumps.

Counterpart of ``mxnet_tpu/trace/export.py``.  ``chrome_trace()`` turns
ring events into the Trace Event Format (``ph: "X"`` complete events in
microseconds, the real pid and tid, ``thread_name`` metadata, so the
serving scheduler, the checkpoint writer and the trainer land on separate
tracks).  ``dump()`` writes it: on demand, on a crash (``sys.excepthook``
and ``threading.excepthook``, installed at import unless
``MXNET_TRACE_DUMP_ON_CRASH=0``), at exit (``MXNET_TRACE_DUMP_AT_EXIT=1``)
and on an anomaly (slow step, deadline burst, divergence, hang) through
``trace/anomaly.py`` and ``trace/watchdog.py``.  The hooks chain to the
ones installed before them, and ``uninstall_crash_hooks`` puts those back.

Anomaly dumps are rate-limited (``MXNET_TRACE_DUMP_MIN_SECONDS`` between
two dumps of one reason, default 30), so a process stuck in a bad state
writes a trickle of dumps, not a flood; ``MXNET_TRACE_DUMP_MAX_EVENTS``
keeps only the newest events of a dump, ``MXNET_TRACE_DUMP_DIR`` says
where dumps go."""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time

from .. import telemetry
from ..base import get_env
from . import core

__all__ = ["chrome_trace", "dump", "dump_async", "dump_dir",
           "install_crash_hooks", "uninstall_crash_hooks", "last_dumps"]

# reasons a human explicitly asked for are never rate-limited
_UNLIMITED_REASONS = ("manual", "crash", "exit", "dry_run")

_SEQ = itertools.count(1)
_LAST_BY_REASON = {}
_LAST_LOCK = threading.Lock()
_LAST_DUMPS = []  # newest-last [(reason, path)] for introspection


def dump_dir():
    """Where dumps land: ``MXNET_TRACE_DUMP_DIR`` (created on demand),
    default ``<tempdir>/mxnet_trace``: not the working directory, so
    crash dumps of worker processes never litter a user's project."""
    import tempfile

    d = get_env("MXNET_TRACE_DUMP_DIR", str, None)
    if not d:
        d = os.path.join(tempfile.gettempdir(), "mxnet_trace")
    return os.path.expanduser(d)


def chrome_trace(events=None):
    """Ring events -> Trace Event Format dict (Perfetto / chrome://
    tracing loadable).  ``ts``/``dur`` are microseconds on the
    monotonic clock; every event carries its trace/span/parent ids in
    ``args`` so one request/step is filterable by ``trace``."""
    if events is None:
        events = core.RECORDER.events()
    pid = os.getpid()
    out, threads = [], {}
    for ev in events:
        tid = ev.get("tid") or 0
        if ev.get("tname"):
            threads.setdefault(tid, ev["tname"])
        args = dict(ev.get("args") or {})
        for k in ("trace", "span", "parent"):
            if ev.get(k):
                args[k] = ev[k]
        rec = {"name": ev["name"], "cat": ev.get("cat", "trace"),
               "ph": ev.get("ph", "X"), "ts": ev["ts"] * 1e6,
               "pid": pid, "tid": tid, "args": args}
        if rec["ph"] == "X":
            rec["dur"] = ev.get("dur", 0.0) * 1e6
        if rec["ph"] == "i":
            rec["s"] = "t"  # instant scoped to its thread
        out.append(rec)
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": "mxnet_tpu_torch pid %d" % pid}}]
    for tid, tname in sorted(threads.items()):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": tname}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def _claim_rate_slot(reason):
    """Reserve the reason's rate-limit window; returns a rollback
    callable (or None when limited).  The caller rolls back on a FAILED
    write, so a transiently unwritable dump dir doesn't suppress the
    next real anomaly for the whole window."""
    if reason in _UNLIMITED_REASONS:
        return lambda: None
    min_s = get_env("MXNET_TRACE_DUMP_MIN_SECONDS", float, 30.0)
    now = time.monotonic()
    with _LAST_LOCK:
        last = _LAST_BY_REASON.get(reason)
        if last is not None and now - last < min_s:
            return None
        _LAST_BY_REASON[reason] = now

    def rollback():
        with _LAST_LOCK:
            if _LAST_BY_REASON.get(reason) == now:
                if last is None:
                    _LAST_BY_REASON.pop(reason, None)
                else:
                    _LAST_BY_REASON[reason] = last

    return rollback


def _default_path(reason):
    return os.path.join(dump_dir(), "mxtrace-%d-%s-%03d.json"
                        % (os.getpid(), reason, next(_SEQ)))


def _cap_events(events, extra):
    """Apply ``MXNET_TRACE_DUMP_MAX_EVENTS`` (0/unset = the full
    ring): keep the NEWEST events — the anomaly moment is at the tail
    — and record the truncation in the doc's ``extra`` block so a
    reader knows the window was clipped."""
    cap = get_env("MXNET_TRACE_DUMP_MAX_EVENTS", int, 0)
    if cap <= 0 or len(events) <= cap:
        return events, extra
    extra = dict(extra or {})
    extra["truncated_events"] = len(events) - cap
    extra["dump_max_events"] = cap
    return events[-cap:], extra


def _write_doc(path, reason, events, extra, rollback):
    """The shared dump tail: build the document, write it ATOMICALLY
    (tmp + rename — the advertised path is logged/returned before or
    while the write runs, so a reader must only ever see a complete
    document), then account for it.  Returns the path, or None after
    rolling the reason's rate slot back on I/O failure."""
    doc = chrome_trace(events)
    doc["traceEvents"].insert(0, {
        "name": "mx.trace.dump", "ph": "M", "pid": os.getpid(), "tid": 0,
        "args": {"reason": reason, "wall_time": time.time(),
                 "ring_capacity": core.RECORDER.capacity,
                 "ring_dropped": core.RECORDER.dropped,
                 **(extra or {})}})
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path + ".tmp", "w") as f:
            json.dump(doc, f)
        os.rename(path + ".tmp", path)
    except OSError:
        rollback()
        return None
    if telemetry.ENABLED:
        telemetry.TRACE_DUMPS.labels(reason=reason).inc()
    with _LAST_LOCK:
        _LAST_DUMPS.append((reason, path))
        del _LAST_DUMPS[:-16]
    return path


def dump(path=None, reason="manual", events=None, extra=None):
    """Write the flight record as chrome-trace JSON; returns the path,
    or None when nothing was written (empty ring, rate-limited reason,
    or I/O failure — a dump must never take the process down with it).

    ``extra`` (a JSON-able dict) is attached as a ``mx.trace.dump``
    metadata event — the anomaly/hang paths use it to say WHY this dump
    exists."""
    if events is None:
        events = core.RECORDER.events()
    if not events:
        return None
    rollback = _claim_rate_slot(reason)
    if rollback is None:
        return None
    if path is None:
        path = _default_path(reason)
    events, extra = _cap_events(events, extra)
    return _write_doc(path, reason, events, extra, rollback)


def dump_async(reason, extra=None):
    """Schedule a dump off the calling thread: the ring is snapshotted
    NOW (so the file reflects the anomaly moment) but serialization +
    disk I/O run on a short-lived daemon thread.  The anomaly detectors
    use this — they fire from hot paths (span exit on the training
    thread, ``_fail`` under the serve queue lock) where a synchronous
    multi-MB JSON write would stall the very traffic being diagnosed.
    Returns the path the dump WILL land at (rate-limit/empty-ring
    checked synchronously; the write itself is best-effort)."""
    events = core.RECORDER.events()
    if not events:
        return None
    rollback = _claim_rate_slot(reason)
    if rollback is None:
        return None
    path = _default_path(reason)
    events, extra = _cap_events(events, extra)
    threading.Thread(
        target=_write_doc, args=(path, reason, events, extra, rollback),
        daemon=True, name="mx-trace-dump").start()
    return path


def last_dumps():
    """Newest-last [(reason, path)] of dumps written by this process."""
    with _LAST_LOCK:
        return list(_LAST_DUMPS)


# ---------------------------------------------------------------------------
# crash hooks
# ---------------------------------------------------------------------------

_HOOKS = []  # [(previous sys.excepthook, previous threading.excepthook)]


def install_crash_hooks():
    """Chain onto ``sys.excepthook`` / ``threading.excepthook`` so an
    uncaught exception leaves a flight-record dump behind.  Once a
    process until ``uninstall_crash_hooks``; nothing is written when the
    ring is empty at crash time."""
    if _HOOKS:
        return
    prev_sys = sys.excepthook
    prev_thread = threading.excepthook

    def _sys_hook(exc_type, exc, tb):
        try:
            dump(reason="crash",
                 extra={"exception": "%s: %s" % (exc_type.__name__, exc)})
        except Exception:  # noqa: BLE001 - never mask the real crash
            pass
        prev_sys(exc_type, exc, tb)

    def _thread_hook(hook_args):
        try:
            if hook_args.exc_type is not SystemExit:
                dump(reason="crash",
                     extra={"exception": "%s: %s (thread %s)"
                            % (hook_args.exc_type.__name__,
                               hook_args.exc_value,
                               getattr(hook_args.thread, "name", "?"))})
        except Exception:  # noqa: BLE001
            pass
        prev_thread(hook_args)

    sys.excepthook = _sys_hook
    threading.excepthook = _thread_hook
    _HOOKS.append((prev_sys, prev_thread, _sys_hook, _thread_hook))


def uninstall_crash_hooks():
    """Put back the hooks that were there before ``install_crash_hooks``
    (where no one has chained a hook of their own onto ours since)."""
    if not _HOOKS:
        return
    prev_sys, prev_thread, ours_sys, ours_thread = _HOOKS.pop()
    if sys.excepthook is ours_sys:
        sys.excepthook = prev_sys
    if threading.excepthook is ours_thread:
        threading.excepthook = prev_thread


def _dump_at_exit():
    dump(reason="exit")


if get_env("MXNET_TRACE_DUMP_ON_CRASH", bool, True):
    install_crash_hooks()

if get_env("MXNET_TRACE_DUMP_AT_EXIT", bool, False):
    import atexit

    atexit.register(_dump_at_exit)
