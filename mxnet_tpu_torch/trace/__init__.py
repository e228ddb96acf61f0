"""Structured spans with trace propagation and a bounded flight ring.

A cut copy of ``mxnet_tpu/trace/core.py``: ``span``, ``instant``,
``record_span``, the per-request context (``new_request``/``use``) and the
ring they record into.  The exporters, the hang watchdog and the anomaly
detector are not part of this port.  Disabled cost is one boolean check
per hook; ``MXNET_TRACE_DISABLE=1`` flips it at import.
"""
from __future__ import annotations

import contextvars
import itertools
import random
import threading
import time
from collections import deque, namedtuple

from .. import telemetry
from ..base import get_env

__all__ = ["ENABLED", "enable", "disable", "TraceContext", "new_request",
           "sanitize_request_id", "current", "use", "span", "instant",
           "record_span", "events"]

ENABLED = not get_env("MXNET_TRACE_DISABLE", bool, False)


def enable():
    global ENABLED
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


_PREFIX = "%08x" % random.getrandbits(32)
_COUNT = itertools.count(1)


def _new_id():
    return "%s%08x" % (_PREFIX, next(_COUNT))


TraceContext = namedtuple("TraceContext", ("trace_id", "span_id"))

_CTX = contextvars.ContextVar("mxnet_tpu_torch_trace", default=None)


def sanitize_request_id(request_id):
    """Client correlation id -> printable chars only, <= 128 long."""
    if request_id is None:
        return None
    return "".join(c for c in str(request_id)[:128]
                   if c.isprintable()) or None


def new_request(request_id=None):
    """Trace identity for one serving request: a client ``request_id``
    becomes the trace id.  None when tracing is disabled."""
    if not ENABLED:
        return None
    cur = _CTX.get()
    trace_id = sanitize_request_id(request_id) if request_id is not None \
        else (cur.trace_id if cur is not None else _new_id())
    return TraceContext(str(trace_id), _new_id())


def current():
    """The active trace context of this thread, or None."""
    return _CTX.get()


class use:
    """Adopt ``ctx`` (a TraceContext or None) as the active context: the
    explicit hand-off from the submitting thread to the scheduler's."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx):
        self._ctx = ctx
        self._token = None

    def __enter__(self):
        if self._ctx is not None:
            self._token = _CTX.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        if self._token is not None:
            _CTX.reset(self._token)
            self._token = None
        return False


_RING_LOCK = threading.Lock()
_RING = deque(maxlen=max(16, get_env("MXNET_TRACE_RING_EVENTS", int, 8192)))


def events():
    """Snapshot of the flight ring, oldest first."""
    with _RING_LOCK:
        return list(_RING)


def _record(name, cat, start, dur, trace_id, span_id, parent, args=None,
            ph="X"):
    t = threading.current_thread()
    ev = {"name": name, "cat": cat, "ph": ph, "ts": start, "dur": dur,
          "trace": trace_id, "span": span_id, "parent": parent,
          "tid": t.ident, "tname": t.name}
    if args:
        ev["args"] = args
    with _RING_LOCK:
        _RING.append(ev)


class span:
    """Timing context recording into the flight ring (with trace/span/
    parent propagation) and, unless ``hist=False``, the telemetry
    histogram ``<name>_seconds``."""

    __slots__ = ("name", "cat", "args", "_hist", "_start", "_ctx",
                 "_parent", "_token")

    def __init__(self, name, hist=None, cat="trace", args=None):
        self.name = name
        self.cat = cat
        self.args = args
        self._hist = hist
        self._start = None
        self._ctx = None
        self._parent = None
        self._token = None

    def __enter__(self):
        if not ENABLED and (not telemetry.ENABLED or self._hist is False):
            return self
        self._start = time.perf_counter()
        if ENABLED:
            parent = _CTX.get()
            self._parent = parent
            self._ctx = TraceContext(
                parent.trace_id if parent is not None else _new_id(),
                _new_id())
            self._token = _CTX.set(self._ctx)
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            _CTX.reset(self._token)
            self._token = None
        if self._start is None:
            return False
        dur = time.perf_counter() - self._start
        if ENABLED and self._ctx is not None:
            _record(self.name, self.cat, self._start, dur,
                    self._ctx.trace_id, self._ctx.span_id,
                    self._parent.span_id if self._parent is not None
                    else None, self.args)
        if telemetry.ENABLED and self._hist is not False:
            hist = self._hist or telemetry.histogram(
                self.name + "_seconds", "duration of %s spans" % self.name)
            hist.observe(dur)
        self._start = None
        self._ctx = None
        return False


def instant(name, cat="trace", args=None, ctx=None):
    """One zero-duration marker event under ``ctx`` (or the active one)."""
    if not ENABLED:
        return
    if ctx is None:
        ctx = _CTX.get()
    _record(name, cat, time.perf_counter(), 0.0,
            ctx.trace_id if ctx else _new_id(), _new_id(),
            ctx.span_id if ctx else None, args, ph="i")


def record_span(name, start, dur, ctx=None, root=False, cat="trace",
                args=None):
    """A span with explicit timing (e.g. a request's queue wait,
    reconstructed at dispatch).  ``root=True`` makes the event BE the
    context's own span: the request-level root."""
    if not ENABLED:
        return
    if ctx is None:
        ctx = _CTX.get()
    if ctx is None:
        ctx = TraceContext(_new_id(), _new_id())
        root = True
    if root:
        _record(name, cat, start, dur, ctx.trace_id, ctx.span_id, None,
                args)
    else:
        _record(name, cat, start, dur, ctx.trace_id, _new_id(),
                ctx.span_id, args)
