"""The serving front of the PyTorch port: ``Server``'s decode plane, its
HTTP endpoint, and the telemetry and fault-plan pieces they use, on the
CPU (``tests/python/unittest/test_serve_decode.py``'s server cases and
``test_serve.py``'s HTTP and drill cases, ported).

1. A decode-only ``Server``: ``POST /predict`` with ``tokens`` collected
   and ``?stream=1`` streamed (the same tokens, ``X-Request-Id`` echoed),
   ``POST /decode``, 400 for a static limit, ``/statz``'s decode block,
   ``/healthz``, ``/readyz``, ``/metrics``, ``/drainz``.
2. Both planes in one ``Server``; ``decode=`` a raw block built on
   ``ctx`` with ``decode_config``; a pre-built runner with
   ``decode_config`` refused; the drain finishes a stream in flight.
3. Overload: 503 with ``Retry-After`` from ``ServeConfig(retry_after_s=)``.
4. The micro-batch plane's fault sites: ``serve_dispatch`` fails a batch
   (breaker strike), ``serve_poison@<id>`` fails its request alone.
5. ``telemetry``: ``histogram_quantiles``, ``totals(nonzero, quantiles)``,
   ``snapshot`` and ``prometheus`` give the JAX package's values on the
   same observations; the decode families are exported.  ``inject``:
   ``poisoned``, ``record_firing`` and ``state`` as in the JAX package.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.resilience import inject as jinject
from mxnet_tpu_torch import convert, serve, telemetry
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.resilience import inject
from mxnet_tpu_torch.resilience.inject import InjectedFault
from test_torch_decode import config, decoder, reference_decode


@pytest.fixture(autouse=True)
def _clean():
    telemetry.enable()
    telemetry.reset()
    inject.clear()
    yield
    inject.clear()
    telemetry.reset()


def _post(base, path, body, headers=None):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.headers, r.read()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return r.status, r.read()


def _dense_factory():
    def make():
        blk = nn.Dense(4, flatten=False, in_units=16)
        rs = np.random.RandomState(0)
        convert.load_jax_params(blk, {
            "weight": rs.randn(4, 16).astype(np.float32),
            "bias": rs.randn(4).astype(np.float32)})
        return blk
    return make


def test_decode_server_http_collect_stream_and_statz():
    blk = decoder()
    r = serve.DecodeRunner(blk, ctx=mx.cpu(), config=config())
    srv = serve.Server(decode=r)
    try:
        assert srv.ready() and srv.healthy()
        host, port = srv.start_http()
        base = "http://%s:%d" % (host, port)
        assert json.loads(_get(base, "/readyz")[1])["ready"]
        assert json.loads(_get(base, "/healthz")[1])["status"] == "ok"
        hdr, raw = _post(base, "/predict",
                         {"tokens": [1, 2, 3], "max_new_tokens": 5},
                         {"X-Request-Id": "http-1"})
        collected = json.loads(raw)
        assert hdr.get("X-Request-Id") == "http-1"
        assert collected["tokens"] == reference_decode(blk, [1, 2, 3], 5)
        assert collected["finish_reason"] == "length"
        hdr, raw = _post(base, "/predict?stream=1",
                         {"tokens": [1, 2, 3], "max_new_tokens": 5},
                         {"X-Request-Id": "http-2"})
        assert hdr.get("X-Request-Id") == "http-2"
        events = [json.loads(line) for line in raw.splitlines()]
        tokens = [e["token"] for e in events if "token" in e]
        assert [e["index"] for e in events if "token" in e] == \
            list(range(5))
        done = events[-1]
        assert done["done"] and done["finish_reason"] == "length"
        assert tokens == done["tokens"] == collected["tokens"]
        # the decode route alone, collected and streamed
        _, raw = _post(base, "/decode", {"tokens": [1, 2, 3],
                                         "max_new_tokens": 5})
        assert json.loads(raw)["tokens"] == collected["tokens"]
        _, raw = _post(base, "/decode", {"tokens": [1, 2, 3],
                                         "max_new_tokens": 5,
                                         "stream": True})
        assert json.loads(raw.splitlines()[-1])["tokens"] == tokens
        # static limits are 400s, overload is not one of them
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, "/predict", {"tokens": [1] * 50})
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, "/predict", {"tokens": [1], "tenant": "acme"})
        assert err.value.code == 400
        stats = json.loads(_get(base, "/statz")[1])
        dec = stats["decode"]
        assert dec["runner"]["pool"]["in_use_pages"] == 0
        assert dec["runner"]["pool"]["high_water_pages"] > 0
        assert set(dec["runner"]["buckets"]) == {
            "decode:b1", "decode:b2", "prefill:t8"}
        assert stats["runner"] is None       # decode-only server
        assert stats["schema_version"] == 2
        assert stats["cache"] == stats["spec"] == {"enabled": False}
        assert stats["totals"]["serve_decode_tokens_total"] == 20
        _, prom = _get(base, "/metrics")
        assert b"# TYPE serve_decode_ttft_seconds histogram" in prom
        _, raw = _post(base, "/drainz", {})
        assert json.loads(raw) == {"draining": True} and srv.draining
        assert srv.queue_age_s() == 0.0
    finally:
        srv.shutdown()
    assert r.pool.in_use == 0


def test_server_with_both_planes(tmp_path):
    make = _dense_factory()
    vb = make()
    vb.save_checkpoint(str(tmp_path), step=1)
    cfg = serve.ServeConfig(max_batch_size=4, batch_sizes=(4,),
                            sample_shapes=[(8, 16)])
    blk = decoder(seed=2)
    r = serve.DecodeRunner(blk, ctx=mx.cpu(), config=config())
    srv = serve.Server(make, str(tmp_path), ctx=mx.cpu(), config=cfg,
                       decode=r)
    try:
        assert srv.ready() and srv.step == 1
        x = np.random.RandomState(0).rand(3, 16).astype("float32")
        with torch.no_grad():
            want = vb(torch.from_numpy(x[None])).numpy()[0]
        np.testing.assert_allclose(srv.submit(x), want, rtol=2e-5,
                                   atol=1e-6)
        got = srv.submit_decode([1, 2], max_new_tokens=4).result(60)
        assert got["tokens"] == reference_decode(blk, [1, 2], 4)
        stats = srv.stats()
        assert stats["runner"] is not None and stats["decode"] is not None
    finally:
        srv.shutdown()
    assert r.pool.in_use == 0
    # decode= a raw block: built into a runner on ctx with decode_config
    srv = serve.Server(decode=blk, ctx=mx.cpu(),
                       decode_config=config(max_new_tokens=3))
    try:
        assert srv.decode.runner.device.type == "cpu"
        got = srv.submit_decode([1, 2], max_new_tokens=9).result(60)
        assert got["tokens"] == reference_decode(blk, [1, 2], 3)
    finally:
        srv.shutdown()


def test_decode_server_argument_guards():
    r = serve.DecodeRunner(decoder(), ctx=mx.cpu(), config=config())
    with pytest.raises(ValueError, match="decode_config"):
        serve.Server(decode=r, decode_config=config())
    with pytest.raises(ValueError, match="decode= plane"):
        serve.Server()
    srv = serve.Server(runner=serve.ModelRunner(
        _dense_factory(), ctx=mx.cpu(), batch_sizes=(1,),
        sample_shapes=[(8, 16)]))
    try:
        with pytest.raises(serve.ServeError, match="no decode plane"):
            srv.submit_decode([1])
        with pytest.raises(serve.ServeError, match="no decode plane"):
            srv.swap_decode(r)
    finally:
        srv.shutdown()


def test_shutdown_drain_finishes_inflight_stream():
    r = serve.DecodeRunner(decoder(), ctx=mx.cpu(),
                           config=config(max_new_tokens=8, max_context=24))
    slow = r.decode_step

    def _slow(seqs):
        time.sleep(0.05)
        return slow(seqs)

    r.decode_step = _slow
    srv = serve.Server(decode=r)
    ref = srv.submit_decode([1, 2, 3], max_new_tokens=8).result(60)
    host, port = srv.start_http()
    got = {}

    def client():
        _, raw = _post("http://%s:%d" % (host, port), "/predict?stream=1",
                       {"tokens": [1, 2, 3], "max_new_tokens": 8})
        got["events"] = [json.loads(line) for line in raw.splitlines()]

    t = threading.Thread(target=client)
    t.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not srv._streams:
        time.sleep(0.01)
    assert srv._streams, "stream never started"
    srv.shutdown(drain=True)
    t.join(timeout=60)
    assert not t.is_alive(), "client still blocked after drain"
    events = got.get("events")
    assert events, "client saw no events (socket closed under it)"
    assert events[-1].get("done"), events[-1]
    assert [e["token"] for e in events if "token" in e] == ref["tokens"]
    assert srv._streams == 0


def test_overload_is_503_with_the_configured_retry_after():
    r = serve.DecodeRunner(decoder(), ctx=mx.cpu(),
                           config=config(max_live=1, queue_depth=1,
                                         batch_sizes=(1,),
                                         max_new_tokens=40,
                                         max_context=48))
    gate = threading.Event()
    step = r.decode_step

    def held(seqs):
        gate.wait(30)
        return step(seqs)

    r.decode_step = held
    srv = serve.Server(decode=r, config=serve.ServeConfig(retry_after_s=7))
    try:
        host, port = srv.start_http()
        base = "http://%s:%d" % (host, port)
        a = srv.submit_decode([1, 2], max_new_tokens=4)      # runs
        for _ in range(400):
            if srv.decode.stats()["live"]:
                break
            time.sleep(0.005)
        b = srv.submit_decode([1, 2], max_new_tokens=4)      # waits
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, "/predict", {"tokens": [3]})
        assert err.value.code == 503
        assert err.value.headers["Retry-After"] == "7"
        assert srv.queue_age_s() > 0.0
        gate.set()
        assert len(a.result(60)["tokens"]) == len(b.result(60)["tokens"])
    finally:
        gate.set()
        srv.shutdown()
    assert serve.ServeConfig().retry_after_s == 1.0
    assert srv.config.as_dict()["retry_after_s"] == 7.0


def _micro_server(max_wait_us=10 ** 6):
    cfg = serve.ServeConfig(max_batch_size=4, batch_sizes=(4,),
                            sample_shapes=[(8, 16)], max_wait_us=max_wait_us,
                            breaker_threshold=5)
    return serve.Server(_dense_factory(), ctx=mx.cpu(), config=cfg)


def test_micro_batch_dispatch_fault_fails_the_batch():
    inject.plan("serve_dispatch@0")
    srv = _micro_server(max_wait_us=1000)
    try:
        x = np.ones((3, 16), np.float32)
        with pytest.raises(InjectedFault):
            srv.submit(x)
        assert srv.submit(x).shape == (3, 4)   # one-shot: the next runs
    finally:
        srv.shutdown()
    assert telemetry.value("resilience_faults_injected_total",
                           labels={"site": "serve_dispatch"}) == 1


def test_micro_batch_poison_request_fails_alone():
    inject.plan("serve_poison@bad")
    srv = _micro_server()
    try:
        xs = [np.full((3 + i, 16), i, np.float32) for i in range(4)]
        futs = [srv.submit_async(x, request_id="bad" if i == 2 else None)
                for i, x in enumerate(xs)]
        for i, f in enumerate(futs):
            if i == 2:
                with pytest.raises(InjectedFault):
                    f.result(timeout=30)
            else:
                assert f.result(timeout=30).shape == (3 + i, 4)
    finally:
        srv.shutdown()
    assert telemetry.value("serve_poison_requests_total") == 1
    assert telemetry.value("serve_requests_total",
                           {"result": "poisoned"}) == 1
    assert inject.state()["entries"][0]["fired"] == 1


# ---------------------------------------------------------------------------
# telemetry and the fault plan against the JAX package
# ---------------------------------------------------------------------------

def test_telemetry_readers_and_exporters_match_jax():
    vals = [0.0003, 0.004, 0.004, 0.02, 0.3, 0.3, 0.7, 3.0, 20.0]
    out = []
    for tel in (telemetry, jtelemetry):
        tel.enable()
        h = tel.histogram("parity_probe_seconds", "a probe", ("k",))
        c = tel.counter("parity_probe_total", "a probe counter")
        for i, v in enumerate(vals):
            h.labels(k="a" if i % 2 else "b").observe(v)
        c.inc(3)
        tot = {k: v for k, v in tel.totals(quantiles=True).items()
               if k.startswith("parity_probe")}
        nz = tel.totals(nonzero=True)
        prom = [ln for ln in tel.prometheus().splitlines()
                if "parity_probe" in ln]
        snap = {k: v for k, v in tel.snapshot().items()
                if k.startswith("parity_probe")}
        out.append((tel.histogram_quantiles("parity_probe_seconds"), tot,
                    prom, snap, "parity_probe_total" in nz,
                    tel.histogram_quantiles("no_such_metric")))
        h._reset()
        c._reset()
    assert out[0] == out[1]
    q = out[0][0]
    assert set(q) == {0.5, 0.95, 0.99} and 0.25 <= q[0.5] <= 0.5


def test_decode_families_in_the_prometheus_export():
    sched = serve.DecodeScheduler(serve.DecodeRunner(
        decoder(), ctx=mx.cpu(), config=config()))
    try:
        sched.submit([1, 2], max_new_tokens=4).result(timeout=60)
    finally:
        sched.stop()
    prom = telemetry.prometheus()
    for fam in ("serve_decode_tokens_total", "serve_decode_steps_total",
                "serve_decode_batch_size", "serve_decode_ttft_seconds",
                "serve_decode_token_seconds", "serve_decode_compile_total",
                "serve_decode_evictions_total", "serve_kv_pages_in_use",
                "serve_kv_pages_high_water", "serve_prefix_lookups_total",
                "serve_spec_rounds_total"):
        assert "# TYPE %s" % fam in prom, fam
    assert telemetry.value("serve_decode_tokens_total") == 4
    assert telemetry.value("serve_decode_prefills_total") == 1
    assert telemetry.value("serve_decode_steps_total") == 3
    tot = telemetry.totals(nonzero=True, quantiles=True)
    assert tot["serve_decode_token_seconds_count"] == 3
    assert "serve_decode_ttft_seconds_p99" in tot
    assert telemetry.histogram_quantiles("serve_decode_ttft_seconds")


def test_fault_plan_probes_match_jax():
    spec = "serve_poison@r-1,serve_dispatch@*:io*2,spec_verify@x:fatal"
    got = []
    for inj in (inject, jinject):
        inj.plan(spec)
        assert inj.active() and inj.poisoned("r-1")
        assert not inj.poisoned("r-2") and not inj.poisoned(None)
        inj.record_firing("serve_poison", "r-1", consume=True)
        assert inj.poisoned("r-1")      # serve_poison stays live
        for _ in range(3):
            try:
                inj.fire("serve_dispatch")
            except OSError:
                pass
        got.append(inj.state())
        inj.clear()
        assert not inj.active()
    assert got[0] == got[1]
    assert got[0]["entries"][0]["count"] is None
    assert got[0]["entries"][1]["fired"] == 2
