"""``mx.obs`` of the port against the JAX package's, on the CPU.

- Cadence: ``note_step``/``step_stats``/``reset_steps`` give the JAX
  package's numbers; disabled, ``note_step`` does nothing.
- Attribution: ``observe_step`` gives the JAX package's record for the same
  inputs and the same loader wait, but ``time`` (exact), and the stream
  holds the same lines; ``peak_flops`` honours ``MXNET_OBS_PEAK_TFLOPS``
  and is None on the CPU.
- SLOs: ``SLObjective`` states and burn rates over the same observations
  and the same ``now`` sequence are the JAX package's (exact), latency and
  counter forms; ``evaluate`` refreshes the gauges and ``log_line``
  carries them.
- Publisher: with a stand-in membership it writes the same payload keys
  under the same key; a dead KV counts a failure and never raises.
- Server: with a registered objective, ``/statz``'s ``slo`` block and
  ``/healthz``'s status and ``slo`` map are the JAX server's for the same
  observations; the server's preemption drain hook answers what was
  queued and removes itself.
"""
import json
import urllib.error
import urllib.request


import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import obs as jobs
from mxnet_tpu import serve as jserve
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.resilience import preempt as jpreempt
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import obs, serve, telemetry
from mxnet_tpu_torch.obs import attribution, core, slo_engine
from mxnet_tpu_torch.resilience import preempt

from test_torch_resilience import threads_settle  # noqa: F401

PAIRS = ((obs, telemetry), (jobs, jtel))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MXNET_OBS_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("MXNET_OBS_ATTRIBUTION", raising=False)
    for o, tel in PAIRS:
        tel.enable()
        tel.reset()
        o.core.enable()
        o.core.reset_steps()
        o.core.detach()
        o.slo_engine.clear()
        o.attribution.reset()
    yield
    for o, tel in PAIRS:
        o.core.detach()
        o.core.disable()
        o.core.reset_steps()
        o.slo_engine.clear()
        o.attribution.reset()
        tel.reset()
    preempt.clear()
    jpreempt.clear()


def test_module_surface_and_enabled_flag():
    for name in ("enable", "disable", "is_enabled", "attach", "detach",
                 "publisher", "note_step", "local_payload", "slo"):
        assert callable(getattr(obs, name)) and callable(getattr(jobs, name))
    obs.disable()
    assert obs.ENABLED is False and not obs.is_enabled()
    obs.enable()
    assert obs.ENABLED is True
    assert attribution.SCHEMA_KEYS == jobs.attribution.SCHEMA_KEYS
    assert slo_engine.STATE_LEVELS == jobs.slo_engine.STATE_LEVELS


def test_note_step_matches_jax():
    out = []
    for o, tel in PAIRS:
        got = [o.core.step_stats()]
        for d in (0.1, 0.3, 0.2, 0.05, 0.4):
            o.core.note_step(d)
            got.append(o.core.step_stats())
        got.append(tel.value("obs_step_seconds"))
        o.core.reset_steps()
        got.append(o.core.step_stats())
        o.core.disable()
        o.core.note_step(1.0)
        got.append(o.core.step_stats())
        out.append(got)
    assert out[0] == out[1]
    assert out[0][5]["step_p50_s"] == 0.2 and out[0][6] == 5


def _records(o, tel, stream):
    """The same observe_step calls on either package; loader waits in
    between, as a loader's iterator feeds them."""
    wait = tel.get_metric("dataloader_batch_wait_seconds")
    recs = []
    recs.append(o.attribution.observe_step(
        5, 0.1, parts={"dispatch": 0.06, "writeback": 0.02,
                       "negative": -1.0}, flops=2.0e6, path="captured"))
    wait.observe(0.01)
    recs.append(o.attribution.observe_step(
        6, 0.2, parts={"forward": 0.05, "backward": 0.1, "update": 0.03},
        path="stitched"))
    wait.observe(0.02)
    wait.observe(0.03)
    recs.append(o.attribution.observe_step(7, 0.1, parts={"a": 0.3,
                                                           "b": 0.2},
                                           flops=1.0e9))
    recs.append(o.attribution.observe_step(8, 0.0))
    o.core.disable()
    recs.append(o.attribution.observe_step(9, 0.1))
    o.core.enable()
    summary = o.attribution.summary()
    o.attribution.reset()
    with open(stream) as f:
        lines = [json.loads(x) for x in f]
    strip = [None if r is None else {k: v for k, v in r.items()
                                     if k != "time"} for r in recs]
    return (strip, summary["records"],
            [{k: v for k, v in x.items() if k != "time"} for x in lines],
            tel.value("obs_attribution_records_total"))


@pytest.mark.parametrize("peak", [None, "0.001"])
def test_observe_step_matches_jax(tmp_path, monkeypatch, peak):
    if peak is not None:
        monkeypatch.setenv("MXNET_OBS_PEAK_TFLOPS", peak)
    out = []
    for o, tel in PAIRS:
        stream = str(tmp_path / ("%s.jsonl" % o.__name__))
        monkeypatch.setenv("MXNET_OBS_ATTRIBUTION", stream)
        out.append(_records(o, tel, stream))
    assert out[0] == out[1]
    recs = out[0][0]
    assert set(attribution.SCHEMA_KEYS) <= set(recs[0]) | {"time"}
    assert recs[1]["parts_s"]["data_wait"] == pytest.approx(0.01)
    assert recs[3] is None and recs[4] is None and out[0][1] == 3
    if peak is None:
        assert recs[0]["mfu"] is None
    else:
        assert recs[0]["mfu"] == pytest.approx(2.0e6 / 0.1 / 1.0e9)


def test_peak_flops(monkeypatch):
    assert attribution.peak_flops() is None            # the CPU
    monkeypatch.setenv("MXNET_OBS_PEAK_TFLOPS", "2.5")
    assert attribution.peak_flops() == jobs.attribution.peak_flops() \
        == 2.5e12
    monkeypatch.delenv("MXNET_OBS_PEAK_TFLOPS")
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert attribution.peak_flops() == 989e12
    monkeypatch.setattr("torch.cuda.get_device_name",
                        lambda *a: "Some Other Card")
    assert attribution.peak_flops() is None


_HIST = {}


def _slo_hist(tel):
    if tel not in _HIST:
        _HIST[tel] = (tel.histogram("t_obs_slo_seconds", "lat",
                                    buckets=(0.1, 1.0)),
                      tel.counter("t_obs_req_total", "req", ("result",)))
    return _HIST[tel]


def _slo_script(o, tel, monkeypatch):
    monkeypatch.setenv("MXNET_OBS_SLO_FAST_SECONDS", "300")
    monkeypatch.setenv("MXNET_OBS_SLO_SLOW_SECONDS", "3600")
    h, c = _slo_hist(tel)
    lat = o.slo("t_p99", histogram="t_obs_slo_seconds", q=0.99,
                target=0.1)
    errs = o.slo("t_errs", counter="t_obs_req_total",
                 bad={"result": "error"}, objective=0.9)
    tight = o.slo("t_tight", counter="t_obs_req_total",
                  bad={"result": "error"}, objective=0.999)
    out = [sorted(o.slo_engine.registered())]
    rng = np.random.RandomState(0)
    for now, (good, bad, ok, err) in zip(
            (0.0, 10.0, 200.0, 400.0, 5000.0, 10000.0),
            ((10, 0, 1, 0), (5, 40, 1, 9), (20, 3, 5, 1), (50, 0, 9, 0),
             (100, 0, 10, 0), (0, 0, 0, 0))):
        for v in rng.uniform(0.0, 0.099, good):
            h.observe(float(v))
        for v in rng.uniform(0.11, 2.0, bad):
            h.observe(float(v))
        c.labels(result="ok").inc(ok)
        c.labels(result="error").inc(err)
        out.append(o.slo_engine.evaluate(now=now))
        out.append((o.slo_engine.states(now=now),
                    o.slo_engine.worst(now=now)))
        out.append([tel.value("obs_slo_state", {"slo": n})
                    for n in ("t_p99", "t_errs", "t_tight")])
    out.append((lat.state, errs.state, tight.state))
    o.slo_engine.remove("t_tight")
    out.append(o.slo_engine.registered())
    return out


def test_slo_states_and_burn_rates_match_jax(monkeypatch):
    got = _slo_script(obs, telemetry, monkeypatch)
    want = _slo_script(jobs, jtel, monkeypatch)
    assert got == want
    states = [s for s, _ in got[2::3][:6]]
    assert states[1]["t_p99"] == "PAGE" and states[1]["t_errs"] == "WARN"
    assert "PAGE" not in states[-1].values()


def test_slo_requires_one_source_and_log_line_carries_the_gauges():
    for bad in (dict(histogram="h", counter="c"), {}, dict(histogram="h")):
        with pytest.raises(ValueError):
            obs.slo("bad", **bad)
    h, _ = _slo_hist(telemetry)
    obs.slo("t_line", histogram="t_obs_slo_seconds", target=0.1)
    assert "obs_slo_state" not in telemetry.log_line()   # the baseline
    for _ in range(5):
        h.observe(5.0)
    line = telemetry.log_line()           # evaluates before it reads
    assert "obs_slo_state=2" in line and "obs_slo_burn_rate=" in line
    assert telemetry.value("obs_slo_state", {"slo": "t_line"}) == 2


class _DictKV:
    def __init__(self):
        self.data = {}

    def set(self, key, value):
        self.data[key] = value

    def get(self, key):
        return self.data.get(key)


class _DeadKV:
    def set(self, key, value):
        raise OSError("the shared filesystem is gone")


class _Membership:
    def __init__(self, kv, generation=7, rank=0):
        self.kv = kv
        self.generation = generation
        self.rank = rank


def test_publisher_matches_jax_and_degrades():
    out = []
    for o, tel in PAIRS:
        kv = _DictKV()
        o.core.note_step(0.25)
        pub = o.attach(_Membership(kv, rank=3), interval=0.0)
        assert o.core.publisher() is pub
        payload = kv.get(o.core.obs_key(7, 3))
        assert payload is not None                 # attach publishes
        out.append((sorted(payload), payload["rank"], payload["step_p50_s"],
                    o.core.obs_key(7, 3), pub.publishes))
        o.core.note_step(0.5)                      # a step publishes too
        assert pub.publishes == 2
        dead = o.attach(_Membership(_DeadKV()), interval=0.0)
        assert dead.failures == 1 and not dead.publish()
        assert tel.value("obs_publish_failures_total") == 2
        o.core.note_step(0.1)                      # never raises
        o.detach()
        assert o.core.publisher() is None
    assert out[0] == out[1]


def _server(pkg, srv_mod):
    rs = np.random.RandomState(3)
    w = {"weight": (rs.randn(4, 8) * 0.3).astype(np.float32),
         "bias": np.zeros(4, np.float32)}
    blk = pkg.gluon.nn.Dense(4, in_units=8)
    if pkg is mx:
        blk.initialize(ctx=mx.cpu())
        mx.convert.load_jax_params(blk, w)
        return srv_mod.Server(blk, ctx=mx.cpu(), config=srv_mod.ServeConfig(
            max_batch_size=4, sample_shapes=[(8,)]))
    blk.initialize()
    for k, p in blk.collect_params().items():
        p.set_data(jmx.nd.array(w[k.split(".")[-1]]))
    return srv_mod.Server(blk, config=srv_mod.ServeConfig(
        max_batch_size=4, sample_shapes=[(8,)]))


def _get(addr, path):
    try:
        with urllib.request.urlopen("http://%s:%d%s" % (addr + (path,)),
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_server_slo_block_and_healthz_match_jax(monkeypatch):
    monkeypatch.setenv("MXNET_OBS_SLO_FAST_SECONDS", "300")
    monkeypatch.setenv("MXNET_OBS_SLO_SLOW_SECONDS", "3600")
    out = []
    for (o, tel), (pkg, smod) in zip(PAIRS, ((mx, serve), (jmx, jserve))):
        srv = _server(pkg, smod)
        try:
            addr = srv.start_http()
            assert _get(addr, "/healthz")[1].get("slo") is None
            o.slo("serve_fast", histogram="serve_request_seconds", q=0.99,
                  target=1e-6)
            o.slo("serve_slow", histogram="serve_request_seconds", q=0.99,
                  target=10.0)
            o.slo_engine.evaluate()               # the baseline sample
            hist = tel.get_metric("serve_request_seconds")
            for v in (0.002, 0.02, 0.2, 0.004) * 5:
                hist.observe(v)                  # the same observations
            code, health = _get(addr, "/healthz")
            code2, statz = _get(addr, "/statz")
            slo = {k: {kk: vv for kk, vv in v.items()}
                   for k, v in statz["slo"].items()}
            out.append((code, health["status"], health["slo"], code2, slo))
        finally:
            assert srv.shutdown()
    assert out[0] == out[1]
    code, status, states, _, slo = out[0]
    assert (code, status) == (200, "degraded")
    assert states == {"serve_fast": "PAGE", "serve_slow": "OK"}
    assert slo["serve_fast"]["burn_fast"] > 14.4


def test_server_drains_on_preemption():
    srv = _server(mx, serve)
    hook = srv._preempt_hook
    assert hook in preempt.state()["hooks"]
    futs = [srv.submit_async(np.full(8, i, np.float32)) for i in range(6)]
    preempt.request(grace=30.0)
    res = preempt.graceful_shutdown()
    assert res[hook] == "ok"
    assert all(f.result(timeout=30).shape == (4,) for f in futs)
    assert not srv.healthy()
    assert hook not in preempt.state()["hooks"]
    with pytest.raises(serve.ServerClosed):
        srv.submit(np.zeros(8, np.float32))
