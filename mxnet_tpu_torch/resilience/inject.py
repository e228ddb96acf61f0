"""Deterministic fault injection: the drill half of ``mx.resilience``.

Counterpart of ``mxnet_tpu/resilience/inject.py``.  A *fault plan* is a
list of ``(site, key)`` entries, armed through the ``MXNET_FAULTS``
environment variable or ``plan()``; code calls ``fire(site, seq=...)`` at
its named injection sites, and a fault fires iff the plan holds a live
entry for that (site, sequence) pair, so every drill replays the same way.
An empty plan costs one attribute read a site.

Plan grammar (comma-separated entries)::

    MXNET_FAULTS="site@key[:kind][*count]"

    checkpoint_commit@0:io      first commit attempt raises OSError
                                (the manager's retry loop recovers)
    checkpoint_marker@0:abort   hard-kill (os._exit) right before the
                                COMMITTED marker -> torn checkpoint
    checkpoint_commit@*:io*2    the first two commit attempts fail
    serve_poison@req-7          request id "req-7" poisons any batch
                                or decode step it rides in

Kinds: ``transient`` (default, ``InjectedFault``), ``io``
(``InjectedIOError``, an ``OSError``, so retry-with-backoff paths engage),
``fatal`` (``InjectedFault`` of kind ``fatal``) and ``abort``
(``os._exit``: cleanup handlers never run, as on a preempted node).

The sites wired in the port: ``trainer_step`` (``gluon.Trainer.step`` and
``parallel.FusedTrainer.step``, keyed by the trainer's step count, before
anything changes), ``step_capture`` (a captured step's build, and its
dispatch before the graph replays), the checkpoint writer's
``checkpoint_commit`` (each commit attempt) and ``checkpoint_marker``
(just before the ``COMMITTED`` marker lands), the streaming reader's
``data_read`` (keyed by batch index, inside its retry loop), and the
serving planes' ``serve_dispatch`` (each micro-batch dispatch and decode
iteration), ``serve_poison`` (request ids, read through ``poisoned``),
``serve_cache`` (a prefix-cache admission, keyed by request id) and
``spec_verify`` (a speculative sequence's verify, keyed by request id).
``collective`` and ``compile_commit`` wait for their modules (the
kvstore, ``ROADMAP.md`` Queue 1 item 7; the compile cache, item 3).
Without an explicit ``*count`` an entry fires once, but a
``serve_poison`` entry stays live: a poisoned request stays poisoned
through every retry of its batch.

Every firing counts in ``resilience_faults_injected_total{site}`` and is
recorded as a trace instant.
"""
from __future__ import annotations

import threading

from .. import telemetry, trace
from ..base import MXNetError, get_env

__all__ = ["InjectedFault", "InjectedIOError", "FaultPlan", "SITES",
           "KINDS", "plan", "clear", "active", "armed", "refresh_env",
           "fire", "poisoned", "record_firing", "state",
           "ABORT_EXIT_CODE"]

# the site names of the JAX package's stack (fire() accepts any name)
SITES = ("trainer_step", "collective", "checkpoint_commit",
         "checkpoint_marker", "compile_commit", "serve_dispatch",
         "serve_poison", "serve_cache", "spec_verify", "data_read")
KINDS = ("transient", "io", "fatal", "abort")

# distinct from any real exit status the drills assert on
ABORT_EXIT_CODE = 77


class InjectedFault(MXNetError):
    """A planned fault.  ``kind`` is ``transient`` or ``fatal``."""

    def __init__(self, msg, kind="transient", site=None, key=None):
        super().__init__(msg)
        self.kind = kind
        self.site = site
        self.key = key


class InjectedIOError(OSError):
    """A planned IO fault: an ``OSError``, so retry-with-backoff paths
    (the checkpoint commit) handle it like a real storage hiccup."""

    def __init__(self, msg, site=None, key=None):
        super().__init__(msg)
        self.site = site
        self.key = key


class _Entry:
    __slots__ = ("site", "key", "kind", "count", "fired")

    def __init__(self, site, key, kind="transient", count=1):
        if kind not in KINDS:
            raise MXNetError("unknown fault kind %r (one of %s)"
                             % (kind, ", ".join(KINDS)))
        self.site = site
        self.key = str(key)
        self.kind = kind
        # None (no explicit *N): once for a fault site, unlimited for
        # serve_poison
        if count is None:
            count = None if site == "serve_poison" else 1
        self.count = None if count is None else int(count)
        self.fired = 0

    def matches(self, site, key):
        if site != self.site:
            return False
        if self.count is not None and self.fired >= self.count:
            return False
        return self.key == "*" or self.key == str(key)

    def describe(self):
        return {"site": self.site, "key": self.key, "kind": self.kind,
                "count": self.count, "fired": self.fired}


class FaultPlan:
    """A parsed, armed set of fault entries (see the module grammar)."""

    def __init__(self, entries=()):
        self.entries = list(entries)

    @classmethod
    def parse(cls, spec):
        """``"site@key[:kind][*count],..."`` -> FaultPlan.  Whitespace
        around entries is ignored; an empty spec is an empty plan.  A
        trailing ``*<digits>`` always parses as the repeat count; the bare
        wildcard key ``site@*`` matches every key."""
        entries = []
        for raw in (spec or "").split(","):
            raw = raw.strip()
            if not raw:
                continue
            if "@" not in raw:
                raise MXNetError(
                    "bad MXNET_FAULTS entry %r: expected "
                    "site@key[:kind][*count]" % raw)
            site, _, rest = raw.partition("@")
            count = None        # no explicit *N: the entry's default
            head, star, tail = rest.rpartition("*")
            if star and head and tail.isdigit():
                rest, count = head, int(tail)
            kind = "transient"
            if ":" in rest:
                rest, _, kind = rest.rpartition(":")
            entries.append(_Entry(site.strip(), rest.strip(), kind,
                                  count))
        return cls(entries)

    def take(self, site, key):
        """Consume and return the first matching entry (or None).  The
        caller holds the module lock."""
        for e in self.entries:
            if e.matches(site, key):
                e.fired += 1
                return e
        return None

    def match(self, site, key):
        """The first matching entry, not consumed (a poison check runs on
        every retry of a bisected batch)."""
        for e in self.entries:
            if e.matches(site, key):
                return e
        return None


_LOCK = threading.Lock()
_PLAN = None          # None = MXNET_FAULTS not read yet
_SEQ = {}             # per-site call counters (for seq=None sites)
# read without the lock by fire(): an unarmed process pays one attribute
# load a site (None = the plan is not loaded yet)
_ARMED = None


def _load_locked():
    global _PLAN, _ARMED
    if _PLAN is None:
        _PLAN = FaultPlan.parse(get_env("MXNET_FAULTS", str, ""))
        _ARMED = bool(_PLAN.entries)
    return _PLAN


def armed():
    """Whether any fault is planned."""
    a = _ARMED
    if a is None:
        with _LOCK:
            a = bool(_load_locked().entries)
    return a


def plan(spec):
    """Arm a fault plan (a grammar string or a FaultPlan), resetting every
    site's sequence counter.  Returns the armed plan."""
    global _PLAN, _ARMED
    p = spec if isinstance(spec, FaultPlan) else FaultPlan.parse(spec)
    with _LOCK:
        _PLAN = p
        _ARMED = bool(p.entries)
        _SEQ.clear()
    return p


def clear():
    """Disarm: no fault fires until ``plan()`` or ``refresh_env()``."""
    global _PLAN, _ARMED
    with _LOCK:
        _PLAN = FaultPlan()
        _ARMED = False
        _SEQ.clear()


def refresh_env():
    """Re-read ``MXNET_FAULTS``."""
    global _PLAN
    with _LOCK:
        _PLAN = None
        _SEQ.clear()
        return _load_locked()


def active():
    return armed()


def record_firing(site, key=None, consume=False):
    """Count one firing (telemetry and a trace instant).  ``fire`` calls it
    after taking its entry; the serving planes call it with ``consume``
    when they isolate a poisoned request, so the entry's ``fired`` count
    agrees with the counter."""
    if consume:
        with _LOCK:
            e = _load_locked().match(site, key)
            if e is not None:
                e.fired += 1
    if telemetry.ENABLED:
        telemetry.RESILIENCE_FAULTS.labels(site=site).inc()
    trace.instant("fault_injected", cat="resilience",
                  args={"site": site,
                        "key": None if key is None else str(key)})


def fire(site, seq=None):
    """Fire the planned fault for ``(site, seq)``: a no-op unless the
    armed plan holds a matching live entry.  With ``seq=None`` the site's
    own call counter is the key (counted only while a plan is armed, so
    sequences start at ``plan()``).  Each firing counts in
    ``resilience_faults_injected_total{site}`` and is a trace instant."""
    if not armed():
        return
    with _LOCK:
        p = _load_locked()
        if seq is None:
            seq = _SEQ.get(site, 0)
            _SEQ[site] = seq + 1
        entry = p.take(site, seq)
    if entry is None:
        return
    record_firing(site, seq)
    msg = ("injected %s fault at site %r (key %s, firing %d/%s)"
           % (entry.kind, site, entry.key, entry.fired,
              entry.count if entry.count is not None else "inf"))
    if entry.kind == "abort":
        import os
        import sys

        sys.stderr.write("mx.resilience: %s -- hard exit %d\n"
                         % (msg, ABORT_EXIT_CODE))
        sys.stderr.flush()
        os._exit(ABORT_EXIT_CODE)
    if entry.kind == "io":
        raise InjectedIOError(msg, site=site, key=entry.key)
    raise InjectedFault(msg, kind=entry.kind, site=site, key=entry.key)


def poisoned(request_id):
    """Whether the plan marks ``request_id`` as a poison request (site
    ``serve_poison``).  Consumes nothing."""
    if request_id is None or not armed():
        return False
    with _LOCK:
        return _load_locked().match("serve_poison", request_id) is not None


def state():
    """The armed plan's entries and the per-site counters."""
    with _LOCK:
        p = _load_locked()
        return {"active": bool(p.entries),
                "entries": [e.describe() for e in p.entries],
                "seq": dict(_SEQ)}
