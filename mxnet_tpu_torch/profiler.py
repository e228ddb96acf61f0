"""Profiler: Chrome-trace dumps of the card's kernels and the user's
Domain/Task/Frame/Event/Counter/Marker events.

Counterpart of ``mxnet_tpu/profiler.py`` (the reference's
``python/mxnet/profiler.py`` surface: ``set_config``, ``set_state``,
``dump``, ``dumps``, the domain objects) on ``torch.profiler`` in place of
the XLA profiler.  ``set_state('run')`` starts a ``torch.profiler``
session tracing the host and, where there is a card, the card (CUPTI);
``set_state('stop')`` ends it and keeps the device events (kernels,
copies, fills) it saw.  ``dump()`` writes one Chrome-trace JSON holding
those device events and the user's events (and the ``mx.telemetry`` /
``mx.trace`` spans that closed while the session ran), each on the thread
that recorded it; ``device_op_stats()`` ranks the device kernels by time.

On a card, ``set_state('run')`` first checks that ``torch.profiler`` can
record device activity in this process, with a short session around one
small kernel: when it records none, it raises ``MXNetError`` instead of
running a session whose dump would hold no kernel.
``MXNET_PROFILER_AUTOSTART=1`` starts a session when the package is
imported.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time

from .base import MXNetError

__all__ = ["set_config", "set_state", "state", "dump", "dumps", "pause",
           "resume", "device_op_stats", "memory_info", "Domain", "Task",
           "Frame", "Event", "Counter", "Marker", "profiler_set_config",
           "profiler_set_state"]

_config = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": True,
    "profile_api": True,
    "aggregate_stats": False,
}
# session: the live torch.profiler.profile; device: the device events of
# the last session, on the perf_counter clock in seconds; t0: perf_counter
# at the session's start marker
_state = {"running": False, "events": [], "session": None, "device": [],
          "t0": 0.0}
# one lock for every _state["events"] append and Counter update: spans
# and counters are hit from loader threads and the serving scheduler
_events_lock = threading.Lock()

# Chrome-trace categories of the card's own activity in torch's export
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_START_MARK = "mx.profiler.session"


def set_config(**kwargs):
    """Reference profiler.py:34 set_config."""
    _config.update(kwargs)


profiler_set_config = set_config


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _export_events(prof):
    """The events of a finished session, through torch's Chrome export."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="mx-profile-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def _device_events(events):
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def _probe_device_events():
    """The device events of a short session around one small kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x.mul_(2.0)
        torch.cuda.synchronize()
    return _device_events(_export_events(prof))


def _check_device_recording():
    """Raise when ``torch.profiler`` records no device activity in this
    process."""
    if not _probe_device_events():
        raise MXNetError(
            "mx.profiler: torch.profiler recorded no device activity in this "
            "process (a session around one kernel saw none), so a profile "
            "would hold no kernel; profile in a fresh process")


def set_state(state_name="stop", profile_process="worker"):
    """Reference profiler.py:92 set_state ('run'/'stop')."""
    import torch

    if state_name == "run" and not _state["running"]:
        from torch.profiler import profile, record_function

        if torch.cuda.is_available():
            _check_device_recording()
        prof = profile(activities=_activities())
        prof.start()
        with record_function(_START_MARK):
            _state["t0"] = time.perf_counter()
        _state["session"] = prof
        _state["device"] = []
        _state["running"] = True
    elif state_name == "stop" and _state["running"]:
        prof = _state["session"]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        with _events_lock:
            _state["running"] = False
        _state["session"] = None
        events = _export_events(prof)
        mark = next((e for e in events if e.get("name") == _START_MARK), None)
        # torch's clock (microseconds) to perf_counter seconds, by the
        # start marker's two readings
        shift = _state["t0"] - mark["ts"] / 1e6 if mark else 0.0
        _state["device"] = [dict(e, ts=e["ts"] / 1e6 + shift,
                                 dur=e.get("dur", 0.0) / 1e6)
                            for e in _device_events(events)]
    elif state_name not in ("run", "stop"):
        raise MXNetError("state must be 'run' or 'stop'")


profiler_set_state = set_state


def state():
    return "run" if _state["running"] else "stop"


def pause(profile_process="worker"):
    if _state["running"]:
        set_state("stop")


def resume(profile_process="worker"):
    set_state("run")


def dump(finished=True, profile_process="worker"):
    """Write the Chrome-trace JSON to ``set_config(filename=...)``
    (reference profiler.py:125): the last session's device events on the
    card's own tracks (pid/tid as torch's export gives them) and the user
    events with the real pid and the thread that recorded them, plus
    ``thread_name`` metadata.  Returns the path."""
    if _state["running"] and finished:
        set_state("stop")
    pid = os.getpid()
    with _events_lock:
        events = list(_state["events"])
    threads = {}
    for ev in events:
        if ev.get("tid") and ev.get("tname"):
            threads.setdefault(ev["tid"], ev["tname"])
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": tname}}
            for tid, tname in sorted(threads.items())]
    device = [dict(ev, ts=ev["ts"] * 1e6, dur=ev["dur"] * 1e6)
              for ev in _state["device"]]
    trace = {"traceEvents": meta + device + [
        {"name": ev["name"], "cat": ev.get("cat", "user"),
         "ph": ev.get("ph", "X"), "ts": ev["ts"] * 1e6,
         "dur": ev.get("dur", 0) * 1e6, "pid": pid,
         "tid": ev.get("tid", 0), "args": ev.get("args", {})}
        for ev in events]}
    with open(_config["filename"], "w") as f:
        json.dump(trace, f)
    return _config["filename"]


def dumps(reset=False, format="table", sort_by="total", ascending=False):
    """Aggregate stats string (reference profiler.py:154): user span
    totals, then, with ``aggregate_stats``, the device kernels by time."""
    by_name = {}
    with _events_lock:
        events = list(_state["events"])
    for ev in events:
        agg = by_name.setdefault(ev["name"], [0, 0.0])
        agg[0] += 1
        agg[1] += ev.get("dur", 0)
    lines = ["%-40s %8s %12s" % ("Name", "Calls", "Total(ms)")]
    for name, (calls, total) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][1]):
        lines.append("%-40s %8d %12.3f" % (name, calls, total * 1e3))
    if _config.get("aggregate_stats"):
        dev = device_op_stats()
        if dev:
            lines.append("")
            lines.append("%-48s %8s %12s" % ("Device op category",
                                             "Count", "Time(ms)"))
            for row in dev:
                lines.append("%-48s %8d %12.3f" % (
                    row["name"][:48], row["occurrences"], row["time_ms"]))
    if reset:
        with _events_lock:
            _state["events"].clear()
    return "\n".join(lines)


def device_op_stats(trace_dir=None, top=25):
    """The device kernels of the last session (or of the Chrome trace at
    ``trace_dir``, a file, or a directory holding ``*.json`` traces, the
    newest read) by time: ``[{name, occurrences, time_ms}]``, the largest
    ``top`` first; [] when no device activity was recorded."""
    if trace_dir is None:
        events = [dict(e, dur=e["dur"] * 1e6) for e in _state["device"]]
    else:
        path = trace_dir
        if os.path.isdir(path):
            files = sorted((os.path.join(path, n) for n in os.listdir(path)
                            if n.endswith(".json")), key=os.path.getmtime)
            if not files:
                return []
            path = files[-1]
        with open(path) as f:
            events = _device_events(json.load(f).get("traceEvents", []))
    rows = {}
    for ev in events:
        row = rows.setdefault(ev["name"], {"name": ev["name"],
                                           "occurrences": 0, "time_ms": 0.0})
        row["occurrences"] += 1
        row["time_ms"] += ev.get("dur", 0.0) / 1e3
    return sorted(rows.values(), key=lambda r: -r["time_ms"])[:top]


def memory_info(device=None):
    """Device memory (reference storage_profiler.cc's GPU stats): per card
    the caching allocator's bytes in use and peak, the card's total bytes,
    and the allocations made.  ``device``: a card's index, a
    ``torch.device`` or a ``Context``; None for every card.  Without a
    card: {}."""
    import torch

    if not torch.cuda.is_available():
        return {}
    if device is None:
        devices = range(torch.cuda.device_count())
    elif isinstance(device, int):
        devices = [device]
    elif hasattr(device, "device_id"):
        devices = [device.device_id]
    else:
        devices = [torch.device(device).index or 0]
    report = {}
    for d in devices:
        st = torch.cuda.memory_stats(d)
        _free, total = torch.cuda.mem_get_info(d)
        report["cuda:%d" % d] = {
            "bytes_in_use": st.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": st.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total,
            "num_allocs": st.get("allocation.all.allocated", 0)}
    return report


class Domain:
    """Reference profiler.py Domain."""

    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(self, name)

    def new_frame(self, name):
        return Frame(self, name)

    def new_event(self, name):
        return Event(name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)


class _Span:
    _kind = "span"

    def __init__(self, domain, name):
        self.name = name if isinstance(domain, Domain) else domain
        self._domain = domain.name if isinstance(domain, Domain) else "user"
        self._start = None
        self._range = None

    def start(self):
        from torch.profiler import record_function

        self._start = time.perf_counter()
        # the span also stands in torch's own trace, over the ops it covers
        self._range = record_function(self.name)
        self._range.__enter__()
        return self

    def stop(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._start is not None:
            # the thread is the one that stops the span, read now: dump()
            # runs on whichever thread asks for the file
            t = threading.current_thread()
            with _events_lock:
                _state["events"].append({
                    "name": self.name, "cat": self._kind,
                    "ts": self._start,
                    "dur": time.perf_counter() - self._start,
                    "tid": t.ident, "tname": t.name})
            self._start = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()


class Task(_Span):
    _kind = "task"


class Frame(_Span):
    _kind = "frame"


class Event(_Span):
    _kind = "event"

    def __init__(self, name):
        super().__init__("user", name)


class Counter:
    def __init__(self, domain, name, value=None):
        self.name = name
        self.value = 0 if value is None else value

    def _record(self, value):
        t = threading.current_thread()
        with _events_lock:
            self.value = value
            _state["events"].append({"name": self.name, "cat": "counter",
                                     "ph": "C", "ts": time.perf_counter(),
                                     "tid": t.ident, "tname": t.name,
                                     "args": {"value": value}})

    def set_value(self, value):
        self._record(value)

    def increment(self, delta=1):
        t = threading.current_thread()
        with _events_lock:
            self.value += delta
            _state["events"].append({"name": self.name, "cat": "counter",
                                     "ph": "C", "ts": time.perf_counter(),
                                     "tid": t.ident, "tname": t.name,
                                     "args": {"value": self.value}})

    def decrement(self, delta=1):
        self.increment(-delta)

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.decrement(delta)
        return self


class Marker:
    def __init__(self, domain, name):
        self.name = name

    def mark(self, scope="process"):
        t = threading.current_thread()
        with _events_lock:
            _state["events"].append({"name": self.name, "cat": "marker",
                                     "ph": "i", "ts": time.perf_counter(),
                                     "tid": t.ident, "tname": t.name})
