"""``mx.dist``'s collective deadlines, ``mx.elastic``, the bounded health
check and the data plane's fault handling of the port, against the JAX
package's, on the CPU.

- Deadlines (``tests/python/unittest/test_dist_ft.py:160-221``):
  ``run_with_deadline`` passes results and errors through, times out into
  a transient, state-clean ``DistTimeout`` with one ``dist_timeout`` dump
  and a count by site, and reuses its pooled worker; the same calls give
  the same outcomes in both packages.
- Health: ``health_check`` reports ``{"cpu": "ok"}`` here, a probe that
  blocks as ``"error: timeout"`` within its bound, a probe that raises as
  its error.
- Elastic (``tests/python/unittest/test_elastic.py:31-194``):
  ``FaultTolerantRunner`` warns once a process, resumes after a failure
  and across a fresh trainer, and lands on the uninterrupted weights (the
  port's bit for bit, the JAX package's within 1e-5 relative); the
  ``CheckpointManager`` shim keeps the old positional order.
- Data: a ``data_read@k:io`` fault is retried by the reader and the
  epoch's sample order equals the unfaulted one (and the JAX package's);
  a preempted ``StreamLoader`` quiesces its threads.

Every thread a test starts is stopped: the module's thread check joins
them, but the parked ``mx-dist-deadline`` workers, counted by name.
"""
import threading
import time
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import data as jdata
from mxnet_tpu import elastic as jelastic
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.dist import timeouts as jdt
from mxnet_tpu.resilience import inject as jinject
from mxnet_tpu.resilience import preempt as jpreempt
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import data as tdata
from mxnet_tpu_torch import elastic, telemetry, trace
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.dist import DistTimeout, run_with_deadline
from mxnet_tpu_torch.dist import timeouts as tdt
from mxnet_tpu_torch.resilience import inject, preempt
from mxnet_tpu_torch.resilience.supervisor import classify, health_check

from test_torch_resilience import (_batches, _fused, _params, _same,  # noqa
                                   threads_settle)

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TRACE_DUMP_DIR", str(tmp_path / "dumps"))
    monkeypatch.setenv("MXNET_TRACE_DUMP_MIN_SECONDS", "0")
    for tel in (telemetry, jtel):
        tel.enable()
        tel.reset()
    for inj, pre in ((inject, preempt), (jinject, jpreempt)):
        inj.clear()
        pre.clear()
    yield
    for inj, pre in ((inject, preempt), (jinject, jpreempt)):
        inj.clear()
        pre.clear()


def _deadline_workers():
    return sum(t.name == "mx-dist-deadline" for t in threading.enumerate())


def _dumps(reason):
    for t in threading.enumerate():
        if t.name == "mx-trace-dump":
            t.join(timeout=30)
    return [p for r, p in trace.last_dumps() if r == reason]


def _deadline_script(dt, tel, release):
    """The same calls on either package's ``timeouts``; returns their
    outcomes."""
    out = [dt.run_with_deadline(lambda: 41 + 1, timeout=5.0),
           dt.run_with_deadline(lambda: "inline", timeout=0)]
    try:
        dt.run_with_deadline(lambda: (_ for _ in ()).throw(
            ValueError("inner")), timeout=5.0)
    except ValueError as exc:
        out.append(("ValueError", str(exc)))
    t0 = time.monotonic()
    try:
        dt.run_with_deadline(lambda: release.wait(30), site="pushpull_all",
                             timeout=0.3)
    except dt.DistTimeout as exc:
        out.append((type(exc).__name__, exc.site, exc.timeout,
                    exc.mx_fault_kind, exc.mx_state_clean))
    out.append(time.monotonic() - t0 < 5.0)
    out.append(tel.value("dist_collective_timeouts_total",
                         {"site": "pushpull_all"}))
    out.append(dt.collective_timeout())
    return out


def test_run_with_deadline_matches_jax():
    trace.instant("before_the_deadline")     # a ring to dump
    rel_t, rel_j = threading.Event(), threading.Event()

    try:
        got = _deadline_script(tdt, telemetry, rel_t)
        want = _deadline_script(jdt, jtel, rel_j)
    finally:
        rel_t.set()
        rel_j.set()
    assert got == want
    assert got[3] == ("DistTimeout", "pushpull_all", 0.3, "transient", True)
    assert classify(DistTimeout("x")) == "transient"
    dumps = _dumps("dist_timeout")
    assert len(dumps) == 1


def test_run_with_deadline_reuses_its_worker():
    with tdt._IDLE_LOCK:
        tdt._IDLE.clear()
    assert run_with_deadline(lambda: 1, timeout=5.0) == 1
    with tdt._IDLE_LOCK:
        assert len(tdt._IDLE) == 1
        pooled = tdt._IDLE[0]
    n = _deadline_workers()
    for i in range(5):
        assert run_with_deadline(lambda i=i: i, timeout=5.0) == i
    assert _deadline_workers() == n                  # no thread a call
    with tdt._IDLE_LOCK:
        assert tdt._IDLE == [pooled]
    release = threading.Event()
    try:
        with pytest.raises(DistTimeout):
            run_with_deadline(lambda: release.wait(30), timeout=0.2)
        with tdt._IDLE_LOCK:
            assert pooled not in tdt._IDLE           # abandoned, not pooled
    finally:
        release.set()
    assert _deadline_workers() <= n + 1 <= tdt._IDLE_MAX + 1


def test_health_check_ok_timeout_and_error():
    assert health_check(timeout=30.0) == {"cpu": "ok"}
    assert elastic.device_health_check(timeout=30.0) == {"cpu": "ok"}
    release = threading.Event()
    seen = {}

    def hung(d):
        t = threading.current_thread()
        seen[str(d)] = (t.daemon, t.name)
        release.wait(30)

    t0 = time.perf_counter()
    try:
        report = health_check(timeout=0.2, devices=["dev0", "dev1"],
                              probe=hung)
        jreport = jmx.resilience.health_check(
            timeout=0.2, devices=["dev0", "dev1"], probe=hung)
    finally:
        release.set()
    assert time.perf_counter() - t0 < 5.0
    assert report == jreport
    assert all(v.startswith("error: timeout") for v in report.values())
    assert set(seen.values()) == {(True, "mx-health-probe")}

    def broken(d):
        raise RuntimeError("CUDA error: an illegal memory access")

    assert health_check(timeout=5.0, devices=["cuda:0"], probe=broken) == \
        {"cuda:0": "error: CUDA error: an illegal memory access"}


def test_unhealthy_device_stops_the_supervisor(tmp_path, monkeypatch):
    """A failed probe after a transient failure raises "unhealthy"
    instead of looping on a dead context."""
    from mxnet_tpu_torch.resilience import supervisor as tsup

    tr = _fused(mx, 7)
    inject.plan("trainer_step@2")
    monkeypatch.setattr(tsup, "health_check", lambda timeout=None: {
        "cuda:0": "error: CUDA error: an illegal memory access"})
    sup = tsup.Supervisor(tr, mx.checkpoint.CheckpointManager(
        str(tmp_path)), checkpoint_every=1,
        backoff=tsup.Backoff(base=0.0, jitter=0.0))
    with pytest.raises(mx.MXNetError, match="unhealthy"):
        sup.run(_batches, 5)
    assert telemetry.value("resilience_restarts_total",
                           {"kind": "unhealthy"}) == 1


# ---------------------------------------------------------------------------
# elastic
# ---------------------------------------------------------------------------

def test_fault_tolerant_runner_warns_once(tmp_path):
    for mod in (elastic, jelastic):
        tr = _fused(mx if mod is elastic else jmx, 41)
        mgr = mod.CheckpointManager(str(tmp_path / mod.__name__))
        mod._FTR_WARNED = False
        try:
            with pytest.warns(DeprecationWarning,
                              match="FaultTolerantRunner is deprecated"):
                mod.FaultTolerantRunner(tr, mgr)
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                mod.FaultTolerantRunner(tr, mgr)     # second build: silent
            assert not [w for w in rec
                        if issubclass(w.category, DeprecationWarning)]
        finally:
            mod._FTR_WARNED = True


def test_checkpoint_manager_shim_keeps_the_positional_order(tmp_path):
    mgr = elastic.CheckpointManager(str(tmp_path), 2, "run")
    jmgr = jelastic.CheckpointManager(str(tmp_path / "j"), 2, "run")
    assert (mgr._max_keep, mgr._prefix) == (jmgr._max_keep,
                                            jmgr._prefix) == (2, "run")

    for s in (10, 20, 30):
        mgr.save(s, {"w": np.full(3, s, np.float32)})
    assert mgr.steps() == [20, 30]
    step, tree = mgr.restore(ctx=mx.cpu())
    assert step == 30 and tree["w"].tolist() == [30.0] * 3


def _runner_run(pkg, mod, root, fail_at, n):
    tr = _fused(pkg, 7)
    real = tr.step
    boom = {"armed": True}

    def flaky(x, y):
        if boom["armed"] and tr._step_count == fail_at:
            boom["armed"] = False
            raise RuntimeError("injected device failure")
        return real(x, y)

    tr.step = flaky
    failures = []
    mod._FTR_WARNED = True
    runner = mod.FaultTolerantRunner(
        tr, mod.CheckpointManager(root), checkpoint_every=4,
        max_restarts=2, on_failure=lambda s, e: failures.append(s))
    losses = runner.run(_batches, n)
    return tr, runner, failures, losses


def test_fault_tolerant_runner_resumes_and_matches(tmp_path):
    n = 12
    tr, runner, failures, losses = _runner_run(
        mx, elastic, str(tmp_path / "t"), 8, n)
    jtr, jrunner, jfailures, jlosses = _runner_run(
        jmx, jelastic, str(tmp_path / "j"), 8, n)
    assert failures == jfailures == [8]
    assert runner.restarts == jrunner.restarts == 1
    ref = _fused(mx, 7)
    for s in range(n):
        ref.step(*_batches(s))
    _same(_params(tr), _params(ref))
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    for k, v in _params(jtr).items():
        np.testing.assert_allclose(_params(tr)[k], v, rtol=RTOL, atol=1e-7)


def test_runner_resumes_across_a_fresh_trainer(tmp_path):
    """The restart-the-job path: a fresh trainer (no state yet) picks up
    from the last checkpoint through the structure spec."""
    mgr = elastic.CheckpointManager(str(tmp_path), max_keep=3)
    elastic._FTR_WARNED = True
    elastic.FaultTolerantRunner(_fused(mx, 11), mgr,
                                checkpoint_every=2).run(_batches, 6)
    tr2 = _fused(mx, 11)
    with mx.cpu():
        elastic.FaultTolerantRunner(tr2, mgr, checkpoint_every=2).run(
            _batches, 10)
    ref = _fused(mx, 11)
    for s in range(10):
        ref.step(*_batches(s))
    _same(_params(tr2), _params(ref))


def test_fused_trainer_fault_fires_before_any_state_changes():
    tr = _fused(mx, 7)
    tr.step(*_batches(0))
    before = {k: v.clone() for k, v in tr.params.items()}
    state = tr.state_dict()
    inject.plan("trainer_step@1")
    with pytest.raises(inject.InjectedFault):
        tr.step(*_batches(1))
    assert tr._step_count == 1
    for k, v in tr.params.items():
        assert v.equal(before[k]), k
    for k, v in tr.state_dict()["opt_state"].items():
        assert v.equal(state["opt_state"][k]), k
    tr.step(*_batches(1))                     # the retry goes through
    assert tr._step_count == 2


# ---------------------------------------------------------------------------
# the data plane
# ---------------------------------------------------------------------------

SHARDS, PER_SHARD, B = 3, 8, 4


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    rs = np.random.RandomState(0)
    paths = []
    for s in range(SHARDS):
        idx, rec = str(root / ("s%d.idx" % s)), str(root / ("s%d.rec" % s))
        w = trec.MXIndexedRecordIO(idx, rec, "w")
        for i in range(PER_SHARD):
            img = rs.randint(0, 255, (3, 2, 3)).astype(np.uint8)
            w.write_idx(i, trec.pack_img(
                trec.IRHeader(0, float(s * 100 + i), i, 0), img,
                img_fmt=".npy"))
        w.close()
        paths.append(rec)
    return paths


def _epoch_ids(mod, shards, plan=None):
    import contextlib

    inj = inject if mod is tdata else jinject
    if plan:
        inj.plan(plan)
    loader = mod.StreamLoader(shards, B, seed=3, num_workers=2, prefetch=2)
    ids = []
    try:
        with mx.cpu() if mod is tdata else contextlib.nullcontext():
            for _ in loader:
                ids.append(loader.last_ids.copy())
    finally:
        loader.close()
        inj.clear()
    return np.concatenate(ids)


def test_data_read_io_fault_is_retried(shards):
    clean = _epoch_ids(tdata, shards)
    faulted = _epoch_ids(tdata, shards, "data_read@2:io*2")
    np.testing.assert_array_equal(faulted, clean)
    assert telemetry.value("data_read_retries_total") == 2
    assert telemetry.value("resilience_faults_injected_total",
                           {"site": "data_read"}) == 2
    np.testing.assert_array_equal(
        _epoch_ids(jdata, shards, "data_read@2:io*2"), clean)


def test_preempted_loader_quiesces(shards):
    before = {t.ident for t in threading.enumerate()}
    loader = tdata.StreamLoader(shards, B, seed=3, num_workers=2,
                                prefetch=2)
    hook = loader._preempt_hook
    assert hook in preempt.state()["hooks"]
    with mx.cpu():
        it = iter(loader)
        next(it)
        started = [t for t in threading.enumerate()
                   if t.ident not in before]
        assert started                            # readers and the stager
        preempt.request(grace=30.0)
        res = preempt.graceful_shutdown()
    assert res[hook] == "ok"
    for t in started:
        t.join(timeout=30)
        assert not t.is_alive(), t.name
    assert hook not in preempt.state()["hooks"]
    assert loader.state_dict()["batch"] >= 1      # the cursor survives


# ---------------------------------------------------------------------------
# the supervisor's dist mode, with a stand-in membership
# ---------------------------------------------------------------------------

class _Membership:
    """The membership interface the supervisor calls, recorded: a peer's
    stop flag appears at ``stop_at``."""

    def __init__(self, stop_at=None):
        self.generation = None
        self.calls = []
        self.stop_at = stop_at
        self._step = None

    def join(self):
        self.generation = 1
        self.calls.append(("join",))

    def note_step(self, step):
        self._step = step
        self.calls.append(("note_step", step))

    def poll_stop(self):
        if self.stop_at is not None and self._step == self.stop_at:
            return {"reason": "preempt", "rank": 1, "step": self._step - 1}
        return None

    def signal_stop(self, reason, step, error=None):
        self.calls.append(("signal_stop", reason, step, error is not None))
        return {"reason": reason, "rank": 0, "step": step}

    def leave(self, reason):
        self.calls.append(("leave", reason))


@pytest.mark.parametrize("case", ["peer_stop", "transient", "sigterm"])
def test_dist_mode_with_a_stand_in_membership(tmp_path, case):
    """A peer's stop flag, a local transient and a local preemption each
    stop the world at the step boundary with an emergency checkpoint, as
    the JAX package's supervisor does with the same stand-in."""
    out = {}
    for pkg, inj, pre, sup_mod in (
            (mx, inject, preempt, mx.resilience.supervisor),
            (jmx, jinject, jpreempt, jmx.resilience.supervisor)):
        m = _Membership(stop_at=3 if case == "peer_stop" else None)
        if case == "transient":
            inj.plan("trainer_step@2")

        def batches(step, pre=pre):
            if case == "sigterm" and step == 4 and not pre.requested():
                pre.request(grace=30.0)
            return _batches(step)

        tr = _fused(pkg, 7)
        mgr = pkg.checkpoint.CheckpointManager(
            str(tmp_path / pkg.__name__))
        sup = sup_mod.Supervisor(tr, mgr, checkpoint_every=100,
                                 backoff=sup_mod.Backoff(base=0.0),
                                 membership=m)
        losses = sup.run(batches, 8)
        out[pkg] = (len(losses), sup.preempted, sup.world_stopped,
                    sup.emergency_checkpoint is not None,
                    mgr.latest_step(), m.calls)
        inj.clear()
        pre.clear()
    assert out[mx] == out[jmx]
    assert out[mx][1] is True
