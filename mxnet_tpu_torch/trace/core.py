"""mx.trace core: structured spans, trace propagation, the flight recorder.

Counterpart of ``mxnet_tpu/trace/core.py``.  Every instrumented phase
records one event with a ``trace_id`` / ``span_id`` / ``parent`` triple into
a bounded ring, so "where did this step or this request spend its time"
has an answer after the fact, after a crash or a hang too, when the ring
is dumped as a Chrome trace (``trace/export.py``).

- Disabled cost is one boolean check per hook; ``MXNET_TRACE_DISABLE=1``
  flips it at import, ``disable()`` at run time.
- Context travels in ``contextvars``: spans nest per thread, and
  ``use(ctx)`` hands a context across threads (the serving scheduler, the
  checkpoint writer).
- The ring holds ``MXNET_TRACE_RING_EVENTS`` events (8192): memory stays
  bounded, and the last N events are what a post-mortem needs.
- ``span`` also feeds the telemetry histogram of its name (unless
  ``hist=False``), a live ``mx.profiler`` session, and with
  ``anomaly=True`` the slow-step detector (``trace/anomaly.py``).
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

__all__ = [
    "ENABLED", "enable", "disable",
    "TraceContext", "current", "current_trace_id", "new_context",
    "new_request", "sanitize_request_id", "use", "span", "instant",
    "record_span",
    "RECORDER", "FlightRecorder", "events", "clear",
]

ENABLED = not get_env("MXNET_TRACE_DISABLE", bool, False)


def enable():
    """Turn trace recording on (module-wide)."""
    global ENABLED
    ENABLED = True


def disable():
    """Turn trace recording off; the ring keeps its current events."""
    global ENABLED
    ENABLED = False


# ---------------------------------------------------------------------------
# ids + context
# ---------------------------------------------------------------------------

# span/trace ids: process-random prefix + monotonic counter — unique,
# lock-free (itertools.count is atomic in CPython), and cheap enough
# for per-phase allocation on hot paths
_PREFIX = "%08x" % random.getrandbits(32)
_COUNT = itertools.count(1)


def _new_id():
    return "%s%08x" % (_PREFIX, next(_COUNT))


TraceContext = namedtuple("TraceContext", ("trace_id", "span_id"))

_CTX = contextvars.ContextVar("mxnet_tpu_torch_trace", default=None)


def current():
    """The active TraceContext of this thread/task (None outside any
    span)."""
    return _CTX.get()


def current_trace_id():
    ctx = _CTX.get()
    return ctx.trace_id if ctx is not None else None


def new_context(trace_id=None):
    """A fresh TraceContext: ``trace_id`` if given, else the active
    trace's id, else a new one.  The span_id is always new — use this
    to mint a root identity for a unit of work (e.g. one serve
    request) whose child spans will run on other threads."""
    if trace_id is None:
        cur = _CTX.get()
        trace_id = cur.trace_id if cur is not None else _new_id()
    return TraceContext(str(trace_id), _new_id())


def sanitize_request_id(request_id):
    """Client correlation id -> safe internal form: printable chars
    only, <= 128 long, None when nothing survives.  The ONE rule both
    the trace id and the HTTP X-Request-Id echo apply — a raw client
    value is a header-injection vector and must never round-trip
    unfiltered."""
    if request_id is None:
        return None
    return "".join(c for c in str(request_id)[:128]
                   if c.isprintable()) or None


def new_request(request_id=None):
    """Trace identity for one serving request.  A client-supplied
    ``request_id`` (X-Request-Id) BECOMES the trace id (sanitized via
    ``sanitize_request_id``) so a request can be found in a
    flight-record dump by the id the client logged.  Returns None when
    tracing is disabled (requests carry no dead weight)."""
    if not ENABLED:
        return None
    if request_id is not None:
        return new_context(trace_id=sanitize_request_id(request_id))
    return new_context()


class use:
    """Adopt ``ctx`` (a TraceContext or None) as the active context —
    the explicit cross-thread handoff: capture ``current()`` where the
    work is submitted, ``use(ctx)`` where it executes."""

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


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded in-memory ring of trace events (the post-mortem record).

    Appends are a deque.append under one lock; the ring discards the
    oldest event once ``capacity`` is reached, so a process that traces
    forever holds a constant-memory tail of recent activity."""

    def __init__(self, capacity=None):
        if capacity is None:
            capacity = get_env("MXNET_TRACE_RING_EVENTS", int, 8192)
        self._lock = threading.Lock()
        self._ring = deque(maxlen=max(16, int(capacity)))
        self.dropped = 0  # events displaced by the ring bound

    @property
    def capacity(self):
        return self._ring.maxlen

    def __len__(self):
        return len(self._ring)

    def append(self, event):
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(event)

    def events(self):
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def resize(self, capacity):
        """Re-bound the ring, keeping the newest events."""
        with self._lock:
            old = list(self._ring)
            self._ring = deque(old[-int(capacity):],
                               maxlen=max(16, int(capacity)))


RECORDER = FlightRecorder()


def events():
    """Snapshot of the flight-recorder ring (oldest first)."""
    return RECORDER.events()


def clear():
    """Drop every buffered event (tests, between runs)."""
    RECORDER.clear()


def _record(name, cat, start, dur, trace_id, span_id, parent, args=None,
            ph="X"):
    t = threading.current_thread()
    ev = {"name": name, "cat": cat, "ph": ph, "ts": start, "dur": dur,
          "trace": trace_id, "span": span_id, "parent": parent,
          "tid": t.ident, "tname": t.name}
    if args:
        ev["args"] = args
    RECORDER.append(ev)
    # mirror into a live mx.profiler session through telemetry's feed
    telemetry._feed_profiler(name, start, dur, cat=cat,
                             args={"trace": trace_id, "span": span_id,
                                   "parent": parent, **(args or {})})


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class span:
    """Timing context recording into the flight ring (with trace/span/
    parent propagation), the telemetry histogram for its name, and a
    live profiler session.

    Parameters
    ----------
    name : str — span (and default histogram ``<name>_seconds``) name.
    hist : None | False | Metric — telemetry histogram to observe on
        exit.  None (default) get-or-creates ``<name>_seconds`` exactly
        like ``telemetry.span``; False skips the histogram (for sites
        that already meter their latency).
    cat : str — event category (Perfetto track color grouping).
    args : dict — extra event args (kept small: the ring holds refs).
    anomaly : bool — feed this span's duration to the slow-step
        detector (``trace/anomaly.py``) on exit.
    """

    __slots__ = ("name", "cat", "args", "_hist", "_anomaly", "_start",
                 "_ctx", "_parent", "_token")

    def __init__(self, name, hist=None, cat="trace", args=None,
                 anomaly=False):
        self.name = name
        self.cat = cat
        self.args = args
        self._hist = hist
        self._anomaly = anomaly
        self._start = None
        self._ctx = None
        self._parent = None
        self._token = None

    def __enter__(self):
        tr_on = ENABLED
        if not tr_on and (not telemetry.ENABLED
                          or self._hist is False):
            # dead for this span's lifetime: tracing off AND nothing
            # for telemetry to observe (hist=False hot-path spans must
            # cost one boolean, not two clock reads, when the ring is
            # disabled)
            return self
        self._start = time.perf_counter()
        if tr_on:
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
            hist = self._hist
            if hist is None:
                hist = telemetry.histogram(
                    self.name + "_seconds",
                    "duration of %s spans" % self.name)
            hist.observe(dur)
        if self._anomaly:
            from . import anomaly

            anomaly.observe_step(dur)
        self._start = None
        self._ctx = None
        return False


def instant(name, cat="trace", args=None, ctx=None):
    """Record one zero-duration marker event (ph 'i') under ``ctx`` (or
    the active context)."""
    if not ENABLED:
        return
    if ctx is None:
        ctx = _CTX.get()
    _record(name, cat, time.perf_counter(), 0.0,
            ctx.trace_id if ctx else _new_id(),
            _new_id(), ctx.span_id if ctx else None, args, ph="i")


def record_span(name, start, dur, ctx=None, root=False, cat="trace",
                args=None):
    """Record a span with EXPLICIT timing — for phases whose start was
    observed before their identity existed on this thread (e.g. a serve
    request's queue wait, reconstructed at dispatch from its enqueue
    timestamp).

    With ``ctx``: the event joins that trace; ``root=True`` makes the
    event BE the context's own span (ctx.span_id, no parent) — the
    request-level root — while the default records a fresh child span
    under it."""
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
