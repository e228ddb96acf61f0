"""The monitor's publisher and divergence detector of the port against the
JAX package's, on the CPU, and the slice as a whole.

- ``DivergenceDetector`` fires at the same observations as the JAX
  package's on the same grad norms (spikes, nonfinite) and losses
  (nonfinite, plateaus), with the same dump payloads (dumps recorded).
- The publisher: an async observation reaches the gauges, the summary and
  a JSONL stream line equal to the JAX package's for the same stats; a
  nonfinite gradient fires one divergence dump naming the group; a full
  ring displaces its oldest entry, counted in ``monitor_dropped_total``;
  ``shutdown`` joins the thread.
- The slice: a 2-layer BERT (width 64, T=256, so ``use_flash`` admits it)
  trains 2 SGD steps with the monitor publishing to a stream, the flight
  recorder, a watchdog and ``mx.profiler`` on, and ``MXNET_AUTOTUNE=1``
  on a store holding a flash winner: loss and weights equal the run with
  every plane off bit for bit, and the JAX package's run within 1e-4.
"""
import json
import math
import threading

import numpy as np
import pytest
import torch

from mxnet_tpu.monitor import core as jcore
from mxnet_tpu.monitor import divergence as jdiv
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autotune, convert, gluon, monitor
from mxnet_tpu_torch import profiler, telemetry, trace
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.monitor import core as tcore
from mxnet_tpu_torch.monitor import divergence as tdiv

# jit_pallas: the fixture the slice test takes by name
from test_torch_train import (CFG, _batch, _init_params, _jax_step,  # noqa
                              _port_step, jit_pallas)


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TRACE_DUMP_DIR", str(tmp_path / "dumps"))
    monkeypatch.setenv("MXNET_TRACE_DUMP_MIN_SECONDS", "0")
    monkeypatch.delenv("MXNET_MONITOR_STREAM", raising=False)
    before = set(threading.enumerate())
    monitor.reset()
    yield
    monitor.disable()
    assert monitor.shutdown(timeout=30)
    monitor.reset()
    autotune.disable()
    for t in threading.enumerate():
        if t.name == "mx-trace-dump":
            t.join(timeout=30)
    # no thread of the test is left (one of an earlier test may end)
    assert set(threading.enumerate()) <= before


def _record(monkeypatch, mod):
    seen = []
    monkeypatch.setattr(mod, "_dump", lambda extra: seen.append(extra)
                        or "path")
    return seen


NORMS = [1.0, 1.1, 0.9, 1.2, 1.0, 1.05, 0.95, 1.1, 1.0, 15.0, 1.0,
         float("nan"), 1.0, 200.0, 1.0, float("inf"), 2.0]
LOSSES = [3.0, 2.5, 2.6, 2.55, 2.7, 2.8, 2.4, 2.45, 2.5, 2.6, 2.7,
          float("nan"), 2.3, 2.4, 2.5, 2.6]


@pytest.mark.parametrize("spike,window,plateau", [
    (10.0, 64, 0), (10.0, 4, 3), (0.0, 64, 4), (5.0, 2, 2)])
def test_divergence_fires_at_the_same_observations(monkeypatch, spike,
                                                   window, plateau):
    got = {}
    for name, mod in (("jax", jdiv), ("port", tdiv)):
        seen = _record(monkeypatch, mod)
        det = mod.DivergenceDetector(spike_factor=spike, window=window,
                                     plateau_window=plateau)
        hits = [i for i, n in enumerate(NORMS)
                if det.observe_grad_norm(n, step=i)]
        hits += [100 + i for i, v in enumerate(LOSSES)
                 if det.observe_loss(v, step=i)]
        det.nonfinite("SGD:0.weight+3", {"g_nonfinite": 2.0,
                                          "w_nonfinite": 0.0,
                                          "g_max_abs": 1.5}, step=7,
                      policy="warn")
        got[name] = (hits, seen, det.state())
    assert got["port"] == got["jax"]
    assert got["port"][1][-1]["group"] == "SGD:0.weight+3"


def _stats(g_sq, g_nonfinite=0.0):
    st = {"w_sq_sum": 4.0, "w_max_abs": 1.5, "w_nonfinite": 0.0,
          "g_sq_sum": g_sq, "g_max_abs": 0.5, "g_nonfinite": g_nonfinite}
    st["w_norm"], st["g_norm"] = 2.0, math.sqrt(g_sq)
    return st


def test_publisher_stream_and_divergence(monkeypatch, tmp_path):
    stream = tmp_path / "port.jsonl"
    monkeypatch.setenv("MXNET_MONITOR_STREAM", str(stream))
    monitor.enable()
    seen = _record(monkeypatch, tdiv)
    entries = [("SGD:0.weight+1", _stats(0.25)), ("SGD:2.bias", _stats(1.0))]
    assert tcore.gate_and_publish(3, entries, "warn") == "ok"
    bad = [("SGD:0.weight+1", _stats(0.25)),
           ("SGD:2.bias", _stats(1.0, g_nonfinite=3.0))]
    assert tcore.gate_and_publish(4, bad, "warn") == "ok"
    assert monitor.flush(30)
    s = monitor.summary()
    assert s["steps"] == 2 and s["nonfinite_steps"] == 1
    assert s["grad_global_norm_last"] == pytest.approx(math.sqrt(1.25))
    assert [e["kind"] for e in seen] == ["nonfinite_grads"]
    assert seen[0]["group"] == "SGD:2.bias"
    assert telemetry.value("monitor_grad_global_norm_hist") >= 2
    lines = [json.loads(l) for l in stream.read_text().splitlines()]
    assert [l["step"] for l in lines] == [3, 4]
    # the JAX package's line for the first entry
    jpath = tmp_path / "jax.jsonl"
    monkeypatch.setenv("MXNET_MONITOR_STREAM", str(jpath))
    host = dict(entries)
    jcore._stream_write({"seq": lines[0]["seq"], "step": 3, "time": 0.0,
                         "skipped": False, "policy": "warn"}, host,
                        math.sqrt(1.25))
    jcore._STREAM[1].close()
    jcore._STREAM[0] = jcore._STREAM[1] = None
    want = json.loads(jpath.read_text().splitlines()[0])
    assert {k: v for k, v in lines[0].items() if k != "time"} == \
        {k: v for k, v in want.items() if k != "time"}


def test_full_ring_displaces_and_counts(monkeypatch):
    monkeypatch.setenv("MXNET_MONITOR_RING", "2")
    monitor.enable()
    gate = threading.Event()
    started = threading.Event()
    publish = tcore._publish

    def slow(entry):
        started.set()
        gate.wait(30)
        publish(entry)

    monkeypatch.setattr(tcore, "_publish", slow)
    drops = telemetry.value("monitor_dropped_total")
    one = [("SGD:0.weight", _stats(1.0))]
    tcore.gate_and_publish(0, one, "off")
    assert started.wait(30)              # the publisher holds entry 0
    for step in (1, 2, 3):               # 1 is displaced by 3
        tcore.gate_and_publish(step, one, "off")
    gate.set()
    assert monitor.flush(30)
    assert telemetry.value("monitor_dropped_total") == drops + 1
    s = monitor.summary()
    assert s["dropped"] == 1 and s["steps"] == 4
    assert monitor.shutdown(timeout=30)
    assert tcore._THREAD[0] is None


# ---- the slice ------------------------------------------------------------------

def _train(init, batch):
    net = tbert.BERTForPretraining(dropout=0.0, **CFG)
    net.initialize(ctx=mx.cpu())
    convert.load_jax_params(net, init)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 1e-2, "momentum": 0.9})
    losses = []
    for _ in range(2):
        losses.append(_port_step(net, batch)[2].detach().clone())
        trainer.step(1)
    return losses, {k: p.detach().clone()
                    for k, p in net.collect_params().items()}


def test_slice_with_every_plane_on(jit_pallas, monkeypatch, tmp_path):
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu.gluon.model_zoo import bert as jbert

    names = [(k, p.shape) for k, p in tbert.BERTForPretraining(
        dropout=0.0, **CFG).collect_params().items()]
    init, batch = _init_params(names), _batch()
    # every plane off
    trace.disable()
    try:
        off_losses, off_params = _train(init, batch)
    finally:
        trace.enable()
    # every plane on
    stream = tmp_path / "stream.jsonl"
    monkeypatch.setenv("MXNET_MONITOR_STREAM", str(stream))
    monitor.enable()
    store = tmp_path / "store"
    autotune.enable("on", root=str(store))
    B, T = batch["ids"].shape
    H, D = CFG["num_heads"], CFG["units"] // CFG["num_heads"]
    autotune.get_store().put("flash_attention",
                             [B, H, T, T, D, "float32", False],
                             {"config": [64, 64]})
    tuned = telemetry.value("autotune_lookup_total",
                            {"site": "flash_attention", "result": "tuned"})
    trace.clear()
    wd = trace.watchdog.install(timeout=600)
    profiler.set_config(filename=str(tmp_path / "profile.json"))
    profiler.set_state("run")
    try:
        on_losses, on_params = _train(init, batch)
    finally:
        profiler.set_state("stop")
        trace.watchdog.uninstall()
    assert not wd.alive and wd.fires == 0
    assert monitor.flush(30)
    for a, b in zip(on_losses, off_losses):
        assert torch.equal(a, b)
    for k in off_params:
        assert torch.equal(on_params[k], off_params[k]), k
    # the planes saw the run
    assert monitor.summary()["steps"] == 2
    assert len(stream.read_text().splitlines()) == 2
    assert telemetry.value("autotune_lookup_total",
                           {"site": "flash_attention",
                            "result": "tuned"}) - tuned == \
        2 * CFG["num_layers"]
    assert sum(e["name"] == "trainer_step" for e in trace.events()) == 2
    doc = json.load(open(profiler.dump()))
    assert sum(e["name"] == "trainer_step" for e in doc["traceEvents"]) == 2
    # the JAX package's run, every plane off
    jnet = jbert.BERTForPretraining(dropout=0.0, **CFG)
    jnet.initialize()
    params = jnet.collect_params()
    for name, p in params.items():
        p.set_data(jmx.nd.array(init[name]))
    jtr = jgluon.Trainer(params, "sgd", {"learning_rate": 1e-2,
                                         "momentum": 0.9})
    for step in range(2):
        loss = _jax_step(jnet, batch)[2]
        assert abs(float(loss.asnumpy()) - on_losses[step].item()) <= 1e-4
        jtr.step(1)
    for name, p in params.items():
        np.testing.assert_allclose(on_params[name].numpy(),
                                   p.data().asnumpy(), rtol=0, atol=1e-4,
                                   err_msg=name)
