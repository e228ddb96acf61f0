"""Telemetry's plane families, the flight recorder, its export, the anomaly
detectors and the hang watchdog of the port against the JAX package's, on
the CPU.

- Every telemetry family of the operational planes has the JAX package's
  name, kind, label names and bucket edges; ``timed``/``span``/
  ``log_line`` give the same output on the same clock readings.
- ``chrome_trace()`` of the same events, recorded with ``record_span`` at
  fixed times, equals the JAX package's but for pid, tid and ids.
- ``SlowStepDetector``, ``DeadlineMissMonitor`` fire at the same indices on
  the same sequences (dumps recorded, not written); ``dump_async``,
  ``dump``'s cap and rate limit, and the crash hooks write real files.
- The watchdog fires on a 0.2 s timeout in both packages and writes a
  stack dump naming the blocked thread.

Every thread a test starts is joined before it ends: none of them is
alive after it.  Clocks are replaced in the modules under test only.
"""
import json
import os
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from mxnet_tpu import telemetry as jtel
from mxnet_tpu import trace as jtrace
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch import trace as ttrace

FAMILIES = ["AUTOTUNE_LOOKUPS", "AUTOTUNE_FALLBACK", "AUTOTUNE_MEASURE",
            "AUTOTUNE_REJECT", "AUTOTUNE_STORE_COMMITS",
            "AUTOTUNE_STORE_QUARANTINE", "AUTOTUNE_TUNE_SECONDS",
            "TRACE_DUMPS", "TRACE_WATCHDOG_FIRES", "MONITOR_DROPS",
            "MONITOR_GRAD_GLOBAL_NORM_HIST", "MONITOR_STAT_BUILDS",
            "DEVICE_MEMORY"]
PACKAGES = {"jax": (jtel, jtrace), "port": (ttel, ttrace)}


@pytest.fixture(autouse=True)
def _threads_joined(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TRACE_DUMP_DIR", str(tmp_path / "dumps"))
    before = set(threading.enumerate())
    yield
    for t in threading.enumerate():
        if t.name == "mx-trace-dump":
            t.join(timeout=30)
    # no thread of the test is left (one of an earlier test may end)
    assert set(threading.enumerate()) <= before


@pytest.mark.parametrize("name", FAMILIES)
def test_plane_families_are_the_jax_packages(name):
    j, t = getattr(jtel, name), getattr(ttel, name)
    assert (t.name, t.kind, tuple(t.labelnames), t.help) == \
        (j.name, j.kind, tuple(j.labelnames), j.help)
    if j.kind == "histogram":
        assert tuple(t.buckets) == tuple(j.buckets)


class _Clock:
    """perf_counter readings 10.0, 10.25, 10.5, ... for both packages."""

    def __init__(self):
        self.t = 10.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _timers(tel, clock):
    tel.reset()

    @tel.timed("mxt_probe_fn")
    def fn(x):
        clock()                      # the call's own work takes a tick
        return x + 1

    assert fn(1) == 2 and fn(2) == 3
    with tel.span("mxt_probe_span"):
        clock()
    line = tel.log_line().split(" ")
    return [w for w in line if w.startswith("mxt_probe")], \
        tel.histogram_quantiles("mxt_probe_fn_seconds")


def test_timers_and_log_line_match(monkeypatch):
    outs = []
    for tel in (jtel, ttel):
        clock = _Clock()
        monkeypatch.setattr(tel, "time", SimpleNamespace(
            perf_counter=clock, time=time.time, sleep=time.sleep))
        was = tel.ENABLED
        tel.enable()
        try:
            outs.append(_timers(tel, clock))
        finally:
            monkeypatch.undo()
            if not was:
                tel.disable()
    assert outs[0] == outs[1]
    assert "mxt_probe_fn_seconds_count=2" in outs[1][0]


def test_telemetry_dump_and_device_memory(tmp_path):
    path = ttel.dump(str(tmp_path / "tel.json"))
    doc = json.load(open(path))
    assert set(doc) == {"time", "enabled", "metrics"}
    assert "autotune_lookup_total" in doc["metrics"]
    assert ttel.sample_device_memory() == {}    # no card: nothing to read
    assert ttel.start_logger(0) is False        # 0: the logger stays off


def _norm(doc):
    """A Chrome-trace doc without pid, tid and ids (the process label
    names the package and its pid)."""
    out = []
    for ev in doc["traceEvents"]:
        ev = {k: v for k, v in ev.items() if k not in ("pid", "tid")}
        args = {k: v for k, v in ev.get("args", {}).items()
                if k not in ("trace", "span", "parent")}
        if ev["name"] == "process_name":
            args = {}
        ev["args"] = args
        out.append(ev)
    return out


def test_chrome_trace_equals_the_jax_packages():
    docs = []
    for _tel, tr in (PACKAGES["jax"], PACKAGES["port"]):
        tr.clear()
        root = tr.new_context("req-1")
        tr.record_span("serve_request", 100.0, 0.5, ctx=root, root=True,
                       cat="serve", args={"result": "ok"})
        tr.record_span("serve_queue_wait", 100.0, 0.1, ctx=root,
                       cat="serve")
        tr.record_span("serve_dispatch", 100.1, 0.3, ctx=root, cat="serve",
                       args={"batch": 4})
        docs.append(tr.chrome_trace())
        tr.clear()
    assert _norm(docs[0]) == _norm(docs[1])
    assert docs[1]["displayTimeUnit"] == "ms"
    assert [e["ph"] for e in docs[1]["traceEvents"]].count("M") == 2


@pytest.mark.parametrize("durs,factor,min_samples", [
    ([1.0] * 40 + [3.5] + [1.0] * 20 + [2.9, 4.0], 3.0, 32),
    ([0.1, 0.12, 0.11, 1.0, 0.1, 0.5, 3.0], 3.0, 2),
    ([1.0] * 5 + [100.0], 0.0, 2)])
def test_slow_step_fires_at_the_same_steps(monkeypatch, durs, factor,
                                           min_samples):
    fired = {}
    for name, (_tel, tr) in PACKAGES.items():
        seen = []
        monkeypatch.setattr(tr.anomaly.export, "dump_async",
                            lambda reason, extra=None, seen=seen:
                            seen.append((reason, extra)) or "path")
        det = tr.anomaly.SlowStepDetector(factor=factor,
                                          min_samples=min_samples)
        hits = [i for i, d in enumerate(durs) if det.observe(d)]
        fired[name] = (hits, seen)
    assert fired["port"] == fired["jax"]
    assert factor == 0.0 or fired["port"][0]


def test_deadline_bursts_fire_at_the_same_misses(monkeypatch):
    times = [0.0, 0.5, 1.0, 1.2, 7.0, 7.1, 7.2, 7.3, 20.0, 20.1, 20.2,
             20.3, 20.4, 20.5]
    fired = {}
    for name, (_tel, tr) in PACKAGES.items():
        seen = []
        monkeypatch.setattr(tr.anomaly.export, "dump_async",
                            lambda reason, extra=None, seen=seen:
                            seen.append((reason, extra)) or "path")
        clock = iter(times)
        monkeypatch.setattr(tr.anomaly, "time", SimpleNamespace(
            monotonic=lambda: next(clock)))
        mon = tr.anomaly.DeadlineMissMonitor(burst=4, window_seconds=5.0)
        fired[name] = ([i for i in range(len(times)) if mon.miss()], seen)
    assert fired["port"] == fired["jax"]
    assert fired["port"][0] == [3, 7, 11]


def test_dump_async_cap_and_rate_limit(monkeypatch, tmp_path):
    tr = ttrace
    tr.clear()
    for i in range(40):
        tr.record_span("step", float(i), 0.5)
    monkeypatch.setenv("MXNET_TRACE_DUMP_MAX_EVENTS", "8")
    monkeypatch.setattr(tr.export, "_LAST_BY_REASON", {})
    before = ttel.value("trace_dumps_total", {"reason": "slow_step"})
    path = tr.export.dump_async("slow_step", extra={"why": "test"})
    assert path is not None
    # a second anomaly of one reason inside the window is rate-limited
    assert tr.export.dump_async("slow_step") is None
    for t in threading.enumerate():
        if t.name == "mx-trace-dump":
            t.join(timeout=30)
    doc = json.load(open(path))
    meta = doc["traceEvents"][0]
    assert meta["name"] == "mx.trace.dump"
    assert meta["args"]["reason"] == "slow_step"
    assert meta["args"]["truncated_events"] == 32
    assert sum(1 for e in doc["traceEvents"] if e["name"] == "step") == 8
    assert ("slow_step", path) in tr.last_dumps()
    assert ttel.value("trace_dumps_total", {"reason": "slow_step"}) == \
        before + 1
    # manual dumps are never rate-limited
    assert tr.dump(str(tmp_path / "a.json")) and \
        tr.dump(str(tmp_path / "b.json"))
    tr.clear()


def test_crash_hooks_chain_and_uninstall(tmp_path):
    export = ttrace.export
    export.uninstall_crash_hooks()
    prev_sys, prev_thread = sys.excepthook, threading.excepthook
    seen = []
    sys.excepthook = lambda *a: seen.append("sys")
    threading.excepthook = lambda a: seen.append("thread")
    try:
        export.install_crash_hooks()
        ttrace.clear()
        ttrace.record_span("before_crash", 1.0, 0.5)
        try:
            raise ValueError("boom")
        except ValueError:
            sys.excepthook(*sys.exc_info())
        t = threading.Thread(target=lambda: 1 / 0, name="crasher")
        t.start()
        t.join(timeout=30)
        assert seen == ["sys", "thread"]       # the old hooks still ran
        crashes = [p for r, p in ttrace.last_dumps() if r == "crash"]
        assert len(crashes) >= 2
        doc = json.load(open(crashes[-1]))
        assert "crasher" in doc["traceEvents"][0]["args"]["exception"]
        export.uninstall_crash_hooks()
        assert sys.excepthook is not None and seen == ["sys", "thread"]
        sys.excepthook(ValueError, ValueError("x"), None)
        assert seen == ["sys", "thread", "sys"]   # ours is gone
    finally:
        export.uninstall_crash_hooks()
        sys.excepthook, threading.excepthook = prev_sys, prev_thread
        export.install_crash_hooks()
        ttrace.clear()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_watchdog_fires_with_stacks_of_the_blocked_thread(pkg):
    tel, tr = PACKAGES[pkg]
    tr.clear()
    tr.record_span("warm", 1.0, 0.1)
    fired = threading.Event()
    wd = tr.watchdog.Watchdog(timeout=0.2, poll=0.05,
                              on_fire=lambda name, age: fired.set())
    release = threading.Event()

    def blocked():
        with wd.watch("blocked_step"):
            release.wait(30)

    t = threading.Thread(target=blocked, name="stuck-worker")
    wd.start()
    t.start()
    try:
        assert fired.wait(10)
    finally:
        release.set()
        t.join(timeout=30)
        wd.stop()
    assert not t.is_alive() and not wd.alive
    scope, stacks, trace_path = wd.last_report
    assert scope == "blocked_step" and wd.fires >= 1
    text = open(stacks).read()
    assert "stuck-worker" in text and "release.wait" in text
    doc = json.load(open(trace_path))
    assert any(e["name"] == "watchdog_hang" for e in doc["traceEvents"])
    assert os.path.dirname(stacks) == os.path.dirname(trace_path)
    assert tel.value("trace_watchdog_fires_total",
                     {"scope": "blocked_step"}) >= 1
    tr.clear()


def test_watch_is_free_without_a_watchdog():
    assert ttrace.watchdog.get() is None
    scope = ttrace.watchdog.watch("trainer_step")
    assert scope is ttrace.watchdog._NULL
    with scope:
        scope.beat()


def test_span_anomaly_feeds_the_step_detector(monkeypatch):
    seen = []
    monkeypatch.setattr(ttrace.anomaly, "observe_step", seen.append)
    with ttrace.span("trainer_step", hist=False, anomaly=True):
        pass
    with ttrace.span("other", hist=False):
        pass
    assert len(seen) == 1 and seen[0] >= 0.0
    assert ttrace.current_trace_id() is None
    ctx = ttrace.new_context("abc")
    assert ctx.trace_id == "abc" and ttrace.new_context().trace_id
