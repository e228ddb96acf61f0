"""``mx.resilience`` of the port against the JAX package's, on the CPU.

- Telemetry: every family the fault-handling and obs planes feed has the
  JAX package's name, kind, label names and bucket edges (exact).
- Taxonomy and policy: ``classify`` gives the JAX package's verdict on one
  table of exceptions; ``Backoff(seed=...)`` the same delays and
  ``RestartBudget`` the same counts (exact).
- Preemption: ``request``/``requested``/``remaining``/``clear`` and the
  shutdown hooks behave as the JAX package's; a child process gets a real
  SIGTERM, exits with ``MXNET_PREEMPT_EXIT_CODE`` and leaves an emergency
  checkpoint, and the resume ends on the port's uninterrupted weights
  exactly and on the JAX package's within 1e-5 relative.
- Supervisor (``tests/python/unittest/test_resilience.py``'s drills on a
  small MLP through ``parallel.FusedTrainer`` and ``GluonStepLoop``):
  resume, a ``trainer_step`` fault, a ``checkpoint_commit`` io fault,
  fatal, the budget, a raising ``on_failure``, divergence restore and a
  preemption during recovery.  Losses against the JAX package's same runs
  within 1e-5 relative; the port's replays against its own uninterrupted
  runs bit for bit.

Weights and batches come from numpy seeds, so both packages start alike.
"""
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.resilience import inject as jinject
from mxnet_tpu.resilience import preempt as jpreempt
from mxnet_tpu.resilience import supervisor as jsup
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, gluon, parallel, telemetry
from mxnet_tpu_torch.dist import DistTimeout
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.resilience import inject, preempt
from mxnet_tpu_torch.resilience.supervisor import (Backoff, GluonStepLoop,
                                                   RestartBudget,
                                                   Supervisor, classify)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5

FAMILIES = ("resilience_faults_injected_total", "resilience_restarts_total",
            "resilience_backoff_seconds", "resilience_preemptions_total",
            "resilience_emergency_saves_total",
            "dist_collective_timeouts_total", "obs_publish_total",
            "obs_publish_failures_total", "obs_slo_state",
            "obs_slo_burn_rate", "obs_step_seconds",
            "obs_attribution_records_total")


def settle_threads(before, timeout=30.0):
    """Join every thread started since ``before`` (a set of idents) but
    the parked ``mx-dist-deadline`` workers; returns the names of those
    still alive after ``timeout``."""
    deadline = time.monotonic() + timeout
    left = []
    for t in threading.enumerate():
        if t.ident in before or t.name == "mx-dist-deadline":
            continue
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            left.append(t.name)
    return left


@pytest.fixture(scope="module", autouse=True)
def threads_settle():
    """No thread a test of this module starts outlives it: the checkpoint
    writers idle out (after a short idle timeout here), every other
    thread is stopped by its test."""
    from mxnet_tpu.checkpoint import writer as jwriter
    from mxnet_tpu_torch.checkpoint import writer as twriter

    mp = pytest.MonkeyPatch()
    for w in (twriter, jwriter):
        mp.setattr(w.AsyncWriter, "_IDLE_TIMEOUT", 0.2)
    before = {t.ident for t in threading.enumerate()}
    yield
    try:
        assert settle_threads(before) == []
    finally:
        mp.undo()


@pytest.fixture(autouse=True)
def _clean():
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


def test_telemetry_families_match_jax():
    for name in FAMILIES:
        t, j = telemetry.get_metric(name), jtel.get_metric(name)
        assert t is not None and j is not None, name
        assert (t.kind, tuple(t.labelnames)) == \
            (j.kind, tuple(j.labelnames)), name
        assert getattr(t, "buckets", None) == getattr(j, "buckets", None), \
            name


# ---------------------------------------------------------------------------
# taxonomy and policy
# ---------------------------------------------------------------------------

def _exceptions(pkg, injmod, distmod):
    class Sub(pkg.MXNetError):
        pass

    marked = ValueError("but retryable")
    marked.mx_fault_kind = "transient"
    fatal_mark = OSError("but fatal")
    fatal_mark.mx_fault_kind = "fatal"
    return [OSError("disk"), TimeoutError(), ConnectionError(),
            RuntimeError("device lost"), Exception("unknown"),
            ValueError("shape"), TypeError(), KeyError("p0"), IndexError(),
            AttributeError(), AssertionError(), ZeroDivisionError(),
            NotImplementedError(), pkg.MXNetError("contract"), Sub("sub"),
            injmod.InjectedFault("x", kind="transient"),
            injmod.InjectedFault("x", kind="fatal"),
            injmod.InjectedIOError("x"),
            distmod.DistTimeout("late", site="s", timeout=1.0),
            marked, fatal_mark, KeyboardInterrupt()]


class _Vendor(Exception):
    pass


class _Shape(RuntimeError):
    pass


def test_classify_matches_jax():
    from mxnet_tpu.dist import timeouts as jdt
    from mxnet_tpu_torch.dist import timeouts as tdt
    from mxnet_tpu_torch.resilience import supervisor as tsup

    got = [classify(e) for e in _exceptions(mx, inject, tdt)]
    want = [jsup.classify(e) for e in _exceptions(jmx, jinject, jdt)]
    assert got == want
    assert got[13:15] == ["fatal", "fatal"]        # MXNetError and a subclass
    assert classify(torch.cuda.OutOfMemoryError("oom")) == "transient"
    for mod in (tsup, jsup):
        mod.register_transient(_Vendor)
        mod.register_fatal(_Shape)
    try:
        assert [classify(_Vendor()), classify(_Shape())] == \
            [jsup.classify(_Vendor()), jsup.classify(_Shape())] == \
            ["transient", "fatal"]
    finally:
        for mod in (tsup, jsup):
            mod._TRANSIENT_EXTRA.remove(_Vendor)
            mod._FATAL_EXTRA.remove(_Shape)


@pytest.mark.parametrize("kw", [dict(base=0.5, factor=2.0, max_delay=4.0,
                                     jitter=0.0),
                                dict(base=1.0, factor=2.0, max_delay=60.0,
                                     jitter=0.25, seed=7),
                                dict(base=0.1, factor=3.0, max_delay=1.0,
                                     jitter=0.5, seed=0)])
def test_backoff_matches_jax(kw):
    t, j = Backoff(**kw), jsup.Backoff(**kw)
    assert [t.delay(i) for i in range(8)] == [j.delay(i) for i in range(8)]


def test_restart_budget_matches_jax():
    for window in (100, None, 3):
        t, j = RestartBudget(2, window), jsup.RestartBudget(2, window)
        got, want = [], []
        for s in (10, 50, 60, 61, 150, 151, 152, 5000):
            got.append((t.record(s), t.exceeded(s), t.count(s + 99)))
            want.append((j.record(s), j.exceeded(s), j.count(s + 99)))
        assert got == want


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def _preempt_script(pre, tel):
    out = []
    out.append(pre.requested())
    out.append(pre.remaining())
    d1 = pre.request(grace=30.0)
    d2 = pre.request(grace=5.0)            # idempotent: the first wins
    out.append(d1 == d2)
    out.append(pre.requested() and pre.preemption_imminent())
    out.append(29.0 < pre.remaining() <= 30.0)
    out.append(tel.value("resilience_preemptions_total"))
    st = pre.state()
    out.append((st["requested"], st["source"], st["exit_code"]))
    ran = []
    pre.add_shutdown_hook("a", lambda: ran.append("a"))
    pre.add_shutdown_hook("b", lambda: ran.append("b"))
    pre.add_shutdown_hook("bad", lambda: 1 / 0)
    pre.add_shutdown_hook("a", lambda: ran.append("a2"))   # replaces "a"
    res = pre.graceful_shutdown()
    out.append((ran, sorted(res), res["bad"].startswith("error:")))
    pre.remove_shutdown_hook("bad")
    pre.remove_shutdown_hook("b")
    pre.remove_shutdown_hook("a")
    out.append(pre.graceful_shutdown())
    pre.clear()
    out.append((pre.requested(), pre.remaining()))
    out.append((pre.exit_code(), pre.grace_seconds()))
    return out


def test_preempt_api_matches_jax():
    assert _preempt_script(preempt, telemetry) == \
        _preempt_script(jpreempt, jtel)


def test_install_chains_and_restores_the_handler():
    prev = signal.getsignal(signal.SIGTERM)
    try:
        assert preempt.install(grace=12.0)
        assert preempt.installed()
        assert signal.getsignal(signal.SIGTERM) is preempt._handler
        preempt.uninstall()
        assert not preempt.installed()
        assert signal.getsignal(signal.SIGTERM) == prev
        # from a worker thread there is no handler to arm
        got = []
        t = threading.Thread(target=lambda: got.append(preempt.install()))
        t.start()
        t.join(timeout=30)
        assert got == [False]
    finally:
        preempt.uninstall()
        preempt._GRACE_OVERRIDE = None
        signal.signal(signal.SIGTERM, prev)


# ---------------------------------------------------------------------------
# the supervisor on a small MLP
# ---------------------------------------------------------------------------

def _weights(seed):
    rs = np.random.RandomState(seed)
    return {"0.weight": (rs.randn(16, 8) * 0.3).astype(np.float32),
            "0.bias": (rs.randn(16) * 0.1).astype(np.float32),
            "1.weight": (rs.randn(4, 16) * 0.3).astype(np.float32),
            "1.bias": (rs.randn(4) * 0.1).astype(np.float32)}


def _batches(step):
    rs = np.random.RandomState(step % 7)
    return (rs.rand(16, 8).astype(np.float32),
            rs.randint(0, 4, 16).astype(np.int32))


def _mlp(pkg, w):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=8),
            pkg.gluon.nn.Dense(4, in_units=16))
    if pkg is mx:
        net.initialize(ctx=mx.cpu())
        mx.convert.load_jax_params(net, w)
    else:
        net.initialize()
        for k, p in net.collect_params().items():
            p.set_data(jmx.nd.array(w[_short(k)]))
    return net


def _short(name):
    return ".".join(name.split(".")[-2:])


def _fused(pkg, seed):
    par = parallel if pkg is mx else jpar
    return par.FusedTrainer(_mlp(pkg, _weights(seed)), loss="softmax_ce",
                            optimizer="sgd",
                            optimizer_params={"learning_rate": 0.1,
                                              "momentum": 0.9})


def _params(tr):
    return {_short(k): np.asarray(v) for k, v in tr.params.items()}


def _uninterrupted(pkg, seed, n):
    tr = _fused(pkg, seed)
    losses = [float(np.asarray(tr.step(*_batches(s)).asnumpy()
                               if pkg is jmx else tr.step(*_batches(s))))
              for s in range(n)]
    return losses, _params(tr)


def _sup(pkg, tr, root, **kw):
    sup = jsup if pkg is jmx else mx.resilience.supervisor
    kw.setdefault("backoff", sup.Backoff(base=0.0, jitter=0.0))
    kw.setdefault("checkpoint_every", 2)
    return sup.Supervisor(tr, pkg.checkpoint.CheckpointManager(root), **kw)


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _close(got, want):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-7,
                                   err_msg=k)


@pytest.fixture(scope="module")
def refs():
    """The uninterrupted 8-step runs of both packages, per seed."""
    return {seed: {pkg: _uninterrupted(pkg, seed, 8) for pkg in (mx, jmx)}
            for seed in (7, 13)}


def test_supervisor_resume_bit_identical(tmp_path, refs):
    """``trainer_step@5``: one restore and replay, the port's weights equal
    its uninterrupted run's exactly, the losses the JAX drill's."""
    out = {}
    for pkg, inj in ((mx, inject), (jmx, jinject)):
        tr = _fused(pkg, 7)
        inj.plan("trainer_step@5")
        sup = _sup(pkg, tr, str(tmp_path / pkg.__name__), max_restarts=2)
        out[pkg] = (sup.run(_batches, 8), _params(tr), sup.restarts)
    losses, params, restarts = out[mx]
    assert restarts == out[jmx][2] == 1 and len(losses) == 8
    _same(params, refs[7][mx][1])
    np.testing.assert_allclose(losses, out[jmx][0], rtol=RTOL)
    _close(params, out[jmx][1])
    assert telemetry.value("resilience_restarts_total",
                           {"kind": "transient"}) == 1
    assert jsup.recent_restarts()[-1]["kind"] == \
        mx.resilience.recent_restarts()[-1]["kind"] == "transient"


def _gluon_loop(pkg, seed):
    net = _mlp(pkg, _weights(seed))
    g = pkg.gluon
    trainer = g.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9})
    sup = jsup if pkg is jmx else mx.resilience.supervisor
    return sup.GluonStepLoop(net, trainer,
                             g.loss.SoftmaxCrossEntropyLoss())


def _batches_for(pkg):
    if pkg is jmx:
        return _batches

    def put(step):
        x, y = _batches(step)
        return torch.from_numpy(x), torch.from_numpy(y)

    return put


def _loop_weights(loop):
    return {_short(k): (p.detach().numpy() if isinstance(p, torch.Tensor)
                        else p.data().asnumpy())
            for k, p in loop.block.collect_params().items()}


@pytest.mark.parametrize("site", ["trainer_step@3", "checkpoint_commit@1:io"])
def test_gluon_loop_fault_is_retried(tmp_path, site):
    """A ``trainer_step`` fault restores and replays; a ``checkpoint_commit``
    io fault is retried by the writer.  Both end on the uninterrupted
    weights (port, bit for bit) and the JAX drill's losses."""
    n = 6
    ref = _gluon_loop(mx, 3)
    ref_losses = [float(ref.step(*_batches_for(mx)(s)).item())
                  for s in range(n)]
    out = {}
    for pkg, inj in ((mx, inject), (jmx, jinject)):
        loop = _gluon_loop(pkg, 3)
        inj.plan(site)
        sup = _sup(pkg, loop, str(tmp_path / pkg.__name__), max_restarts=2)
        out[pkg] = (sup.run(_batches_for(pkg), n), _loop_weights(loop),
                    sup.restarts)
    losses, weights, restarts = out[mx]
    assert restarts == out[jmx][2] == (1 if site.startswith("trainer")
                                       else 0)
    assert losses == ref_losses
    _same(weights, _loop_weights(ref))
    np.testing.assert_allclose(losses, out[jmx][0], rtol=RTOL)
    _close(weights, out[jmx][1])
    if "io" in site:
        assert telemetry.value("checkpoint_retries_total") >= 1


def test_fatal_raises_and_budget_gives_up(tmp_path):
    for pkg in (mx, jmx):
        tr = _fused(pkg, 9)
        real = tr.step

        def bad(x, y, tr=tr, real=real):
            if tr._step_count == 2:
                raise ValueError("shape bug")
            return real(x, y)

        tr.step = bad
        sup = _sup(pkg, tr, str(tmp_path / ("f" + pkg.__name__)),
                   max_restarts=3)
        with pytest.raises(pkg.MXNetError, match="fatal training error"):
            sup.run(_batches, 6)
        assert sup.restarts == 0

        tr = _fused(pkg, 9)
        tr.step = lambda x, y: (_ for _ in ()).throw(
            RuntimeError("permanently broken"))
        sup = _sup(pkg, tr, str(tmp_path / ("b" + pkg.__name__)),
                   max_restarts=2)
        with pytest.raises(pkg.MXNetError, match="after 2 restarts"):
            sup.run(_batches, 5)
    assert telemetry.value("resilience_restarts_total",
                           {"kind": "budget_exhausted"}) == \
        jtel.value("resilience_restarts_total",
                   {"kind": "budget_exhausted"}) == 1


def test_on_failure_exception_does_not_mask_original(tmp_path, refs):
    out = {}
    for pkg in (mx, jmx):
        tr = _fused(pkg, 7)
        boom = {"armed": True}
        real = tr.step

        def flaky(x, y, tr=tr, real=real, boom=boom):
            if boom["armed"] and tr._step_count == 3:
                boom["armed"] = False
                raise RuntimeError("injected device failure")
            return real(x, y)

        tr.step = flaky
        seen = []

        def bad_callback(step, exc, seen=seen):
            seen.append((step, str(exc)))
            raise ValueError("buggy observer")

        sup = _sup(pkg, tr, str(tmp_path / pkg.__name__), max_restarts=2,
                   on_failure=bad_callback)
        out[pkg] = (sup.run(_batches, 8), _params(tr), sup.restarts, seen)
    losses, params, restarts, seen = out[mx]
    assert restarts == 1 and len(losses) == 8
    assert seen == out[jmx][3] and "injected device failure" in seen[0][1]
    _same(params, refs[7][mx][1])
    np.testing.assert_allclose(losses, out[jmx][0], rtol=RTOL)


def test_divergence_restore(tmp_path, refs):
    out = {}
    for pkg in (mx, jmx):
        tr = _fused(pkg, 13)
        fired = {"armed": True}
        anomaly = mx.trace.anomaly if pkg is mx else \
            jmx.trace.anomaly

        def batches(step, fired=fired, anomaly=anomaly):
            if fired["armed"] and step == 5:
                fired["armed"] = False
                anomaly.divergence({"kind": "grad_norm_spike",
                                    "step": step})
            return _batches(step)

        sup = _sup(pkg, tr, str(tmp_path / pkg.__name__), max_restarts=3,
                   restore_on_divergence=True)
        out[pkg] = (sup.run(batches, 8), _params(tr),
                    sup.divergence_restores)
    losses, params, restores = out[mx]
    assert restores == out[jmx][2] == 1 and len(losses) == 8
    _same(params, refs[13][mx][1])
    np.testing.assert_allclose(losses, out[jmx][0], rtol=RTOL)
    _close(params, out[jmx][1])


def test_preempt_during_failure_recovery(tmp_path):
    """A preemption racing a transient failure skips the backoff, still
    restores, then saves; with no checkpoint the suspect state is not
    persisted at all (as in the JAX package)."""
    got = {}
    for pkg, inj, pre in ((mx, inject, preempt), (jmx, jinject, jpreempt)):
        sup_mod = jsup if pkg is jmx else mx.resilience.supervisor
        for every in (2, 100):
            tr = _fused(pkg, 19)
            root = str(tmp_path / ("%s-%d" % (pkg.__name__, every)))
            mgr = pkg.checkpoint.CheckpointManager(root)
            inj.plan("trainer_step@3")
            sup = sup_mod.Supervisor(
                tr, mgr, checkpoint_every=every,
                backoff=sup_mod.Backoff(base=30.0, jitter=0.0),
                on_failure=lambda step, exc, pre=pre:
                pre.request(grace=30.0))
            t0 = time.perf_counter()
            losses = sup.run(_batches, 10)
            assert time.perf_counter() - t0 < 15.0      # never slept 30 s
            got[(pkg, every)] = (len(losses), sup.preempted,
                                 sup._state_suspect,
                                 sup.emergency_checkpoint is None,
                                 mgr.latest_step())
            inj.clear()
            pre.clear()
    for every in (2, 100):
        assert got[(mx, every)] == got[(jmx, every)]
    assert got[(mx, 100)][2:] == (True, True, None)


def test_deadline_timeout_routes_into_a_restart(tmp_path, refs):
    """A ``DistTimeout`` (transient, state clean) is retried like any
    transient: the run ends on the uninterrupted weights."""
    tr = _fused(mx, 7)
    real = tr.step
    fired = {"armed": True}

    def step(x, y):
        if fired["armed"] and tr._step_count == 4:
            fired["armed"] = False
            raise DistTimeout("late", site="pushpull", timeout=1.0)
        return real(x, y)

    tr.step = step
    sup = _sup(mx, tr, str(tmp_path), max_restarts=2)
    assert len(sup.run(_batches, 8)) == 8 and sup.restarts == 1
    _same(_params(tr), refs[7][mx][1])


# ---------------------------------------------------------------------------
# a real SIGTERM
# ---------------------------------------------------------------------------

_SIGTERM_CHILD = r"""
import os, sys, time
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel, resilience

root, ready = sys.argv[1], sys.argv[2]
rs = np.random.RandomState(5)
w = {"weight": (rs.randn(4, 8) * 0.3).astype(np.float32),
     "bias": (rs.randn(4) * 0.1).astype(np.float32)}
net = mx.gluon.nn.Dense(4, in_units=8)
net.initialize(ctx=mx.cpu())
mx.convert.load_jax_params(net, w)
tr = parallel.FusedTrainer(net, loss="softmax_ce", optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})

def batches(step):
    rs = np.random.RandomState(step % 5)
    if step == 3:
        open(ready, "w").write(str(os.getpid()))
    time.sleep(0.05 if step >= 3 else 0.0)
    return (rs.rand(8, 8).astype(np.float32),
            rs.randint(0, 4, 8).astype(np.int32))

assert resilience.install()
mgr = mx.checkpoint.CheckpointManager(root)
sup = resilience.Supervisor(tr, mgr, checkpoint_every=1000,
                            exit_on_preempt=True)
sup.run(batches, 100000)
print("NOT PREEMPTED")
sys.exit(1)
"""
SIGTERM_STEPS = 40


def _dense(pkg):
    rs = np.random.RandomState(5)
    w = {"weight": (rs.randn(4, 8) * 0.3).astype(np.float32),
         "bias": (rs.randn(4) * 0.1).astype(np.float32)}
    net = pkg.gluon.nn.Dense(4, in_units=8)
    if pkg is mx:
        net.initialize(ctx=mx.cpu())
        mx.convert.load_jax_params(net, w)
    else:
        net.initialize()
        for k, p in net.collect_params().items():
            p.set_data(jmx.nd.array(w[k.split(".")[-1]]))
    par = parallel if pkg is mx else jpar
    return par.FusedTrainer(net, loss="softmax_ce", optimizer="sgd",
                            optimizer_params={"learning_rate": 0.1})


def _small_batches(step):
    rs = np.random.RandomState(step % 5)
    return (rs.rand(8, 8).astype(np.float32),
            rs.randint(0, 4, 8).astype(np.int32))


def _tail(name):
    return name.split(".")[-1]


def test_sigterm_drill_subprocess(tmp_path):
    """A real SIGTERM: the child stops at the step boundary, flushes an
    emergency checkpoint and exits with the preemption code; this process
    resumes from it."""
    root = str(tmp_path / "ckpt")
    ready = str(tmp_path / "ready")
    env = dict(os.environ, MXNET_PREEMPT_GRACE_SECONDS="30",
               PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-c", _SIGTERM_CHILD, root,
                             ready], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120
        while not os.path.exists(ready):
            assert proc.poll() is None, proc.stdout.read().decode()
            assert time.time() < deadline, "child never reached step 3"
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
    assert rc == preempt.exit_code() == 85
    mgr = mx.checkpoint.CheckpointManager(root)
    saved = mgr.latest_step()
    assert saved is not None and 3 <= saved < SIGTERM_STEPS - 1

    tr = _dense(mx)
    sup = Supervisor(tr, mgr, checkpoint_every=1000)
    with mx.cpu():   # a fresh trainer has no state to restore onto yet
        losses = sup.run(_small_batches, SIGTERM_STEPS)

    assert len(losses) == SIGTERM_STEPS - saved - 1 and not sup.preempted
    ref = _dense(mx)
    jref = _dense(jmx)
    for s in range(SIGTERM_STEPS):
        ref.step(*_small_batches(s))
        jref.step(*_small_batches(s))
    got = {_tail(k): v.numpy() for k, v in tr.params.items()}
    _same(got, {_tail(k): v.numpy() for k, v in ref.params.items()})
    _close(got, {_tail(k): np.asarray(v) for k, v in jref.params.items()})
