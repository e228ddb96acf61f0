"""``mx.profiler`` of the port (on ``torch.profiler``) against the JAX
package's (on the XLA profiler), on the CPU.

- ``Domain``/``Task``/``Frame``/``Event``/``Counter``/``Marker`` record the
  same events as the JAX package's (names, ``ph``, categories, args).
- ``set_state('run')``/``'stop'``/``dump()`` write a readable Chrome trace
  holding the user events with ``thread_name`` metadata, and the
  ``mx.trace``/``mx.telemetry`` spans that closed while it ran;
  ``dumps()`` aggregates them; ``device_op_stats`` ranks kernels by time
  (from a trace file here: the CPU has no device events).
- A process in which ``torch.profiler`` records no device activity makes
  ``set_state('run')`` raise, and the profiler stays stopped.
- ``MXNET_PROFILER_AUTOSTART=1`` starts a session at import.
"""
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from mxnet_tpu import profiler as jprof
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import trace as ttrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    before = set(threading.enumerate())
    for prof in (jprof, tprof):
        prof.set_config(filename=str(tmp_path / ("%s.json" % prof.__name__)))
        prof._state["events"].clear()
    yield
    for prof in (jprof, tprof):
        prof._state["events"].clear()
        prof.set_config(filename="profile.json")
    assert tprof.state() == "stop"
    # no thread of the test is left (one of an earlier test may end)
    assert set(threading.enumerate()) <= before


def _drive(prof):
    dom = prof.Domain("mxt")
    with dom.new_task("task_a"):
        with dom.new_frame("frame_b"):
            pass
    ev = dom.new_event("event_c")
    ev.start()
    ev.stop()
    with prof.Task(dom, "task_d"):
        pass
    c = dom.new_counter("counter_e", 3)
    c.set_value(5)
    c += 2
    c -= 1
    c.increment(4)
    dom.new_marker("marker_f").mark()
    m = prof.Marker(dom, "marker_g")
    m.mark("thread")
    return c.value


def _records(prof):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur", "tid")}
            for ev in prof._state["events"]]


def test_domain_objects_record_as_the_jax_package():
    assert _drive(jprof) == _drive(tprof) == 10
    want, got = _records(jprof), _records(tprof)
    assert got == want
    # the reference's Event(name) passes "user" where _Span takes the
    # domain, so its records carry the name "user" (ROADMAP.md Queue 3)
    assert [e["name"] for e in got] == [
        "frame_b", "task_a", "user", "task_d", "counter_e", "counter_e",
        "counter_e", "counter_e", "marker_f", "marker_g"]
    assert [e.get("ph", "X") for e in got].count("C") == 4


def test_run_stop_dump_writes_a_readable_trace(tmp_path):
    tprof.set_state("run")
    assert tprof.state() == "run"
    with tprof.Domain("mxt").new_task("step"):
        torch.ones(8) + 1
    with ttrace.span("traced_phase", hist=False):
        pass
    worker = threading.Thread(
        target=lambda: tprof.Marker(None, "from_worker").mark(),
        name="mxt-worker")
    worker.start()
    worker.join(timeout=30)
    tprof.set_state("stop")
    assert tprof.state() == "stop"
    path = tprof.dump()
    doc = json.load(open(path))
    names = [e["name"] for e in doc["traceEvents"]]
    assert {"step", "traced_phase", "from_worker"} <= set(names)
    threads = {e["args"]["name"] for e in doc["traceEvents"]
               if e["name"] == "thread_name"}
    assert {"mxt-worker", threading.current_thread().name} <= threads
    step = next(e for e in doc["traceEvents"] if e["name"] == "step")
    assert step["pid"] == os.getpid() and step["dur"] > 0
    table = tprof.dumps()
    assert "step" in table and "traced_phase" in table
    assert tprof.device_op_stats() == []        # the CPU: no kernels
    assert tprof.memory_info() == {}


def test_dump_while_running_stops_the_session():
    tprof.resume()
    tprof.Domain("mxt").new_marker("m").mark()
    path = tprof.dump()                         # finished=True stops it
    assert tprof.state() == "stop"
    assert json.load(open(path))["traceEvents"]
    tprof.pause()                               # stopped: nothing to do
    with pytest.raises(MXNetError, match="run"):
        tprof.set_state("walk")


def test_device_op_stats_ranks_kernels_of_a_trace(tmp_path):
    events = [{"name": n, "ph": "X", "cat": "kernel", "ts": i, "dur": d}
              for i, (n, d) in enumerate([("mx_flash_fwd", 150.0),
                                          ("mx_flash_bwd_dq", 200.0),
                                          ("mx_flash_fwd", 148.0),
                                          ("mx_flash_bwd_dkv", 300.0)])]
    events.append({"name": "aten::add", "ph": "X", "cat": "cpu_op",
                   "ts": 0, "dur": 1000.0})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    for where in (str(path), str(tmp_path)):
        rows = tprof.device_op_stats(where)
        assert [(r["name"], r["occurrences"]) for r in rows] == [
            ("mx_flash_bwd_dkv", 1), ("mx_flash_fwd", 2),
            ("mx_flash_bwd_dq", 1)]
        assert rows[1]["time_ms"] == pytest.approx(0.298)
    assert tprof.device_op_stats(str(path), top=1)[0]["name"] == \
        "mx_flash_bwd_dkv"


def test_run_raises_where_no_device_activity_is_recorded(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tprof, "_probe_device_events", lambda: [])
    with pytest.raises(MXNetError, match="no device activity"):
        tprof.set_state("run")
    assert tprof.state() == "stop" and tprof._state["session"] is None


def test_autostart_runs_a_session_at_import():
    env = dict(os.environ, MXNET_PROFILER_AUTOSTART="1",
               PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c",
         "import mxnet_tpu_torch as mx; print(mx.profiler.state()); "
         "mx.profiler.set_state('stop')"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "run"
