"""The port's serving plane (``mxnet_tpu_torch.serve``) on the CPU.

1. Parity: a port ``Server(ctx=cpu())`` against the JAX package's
   ``serve.ModelRunner`` on the same 2-layer BERT weights and the same
   requests of mixed lengths (the flash path: bucket T=256), per request
   within atol 1e-4.
2. The micro-batch cases of ``tests/python/unittest/test_serve.py``
   (bucketing, queue policy, backpressure, deadlines, drain), ported, plus
   a poisoned request that fails alone through ``Scheduler._run_split``.
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import serve as jserve
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.serve.batching import Request as JRequest
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert, serve, telemetry
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.serve.batching import BatchQueue, Request

CFG = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=256)
T = 256


@pytest.fixture(autouse=True)
def _clean_registry():
    telemetry.enable()
    telemetry.reset()
    yield
    telemetry.reset()


def test_server_matches_jax_runner():
    jnet = jbert.BERTModel(**CFG)
    jnet.initialize()
    rs = np.random.RandomState(0)
    for name, p in jnet.collect_params().items():
        val = rs.randn(*p.shape).astype(np.float32) * 0.1
        p.set_data(jmx.nd.array(val + (name.endswith(".gamma"))))
    tnet = tbert.BERTModel(**CFG)
    convert.load_jax_params(
        tnet, {k: v.data().asnumpy() for k, v in
               jnet.collect_params().items()})

    reqs = []
    for L in (5, 64, 130, 256, 17, 200):
        ids = rs.randint(0, CFG["vocab_size"], L).astype(np.int32)
        types = (np.arange(L) >= L // 2).astype(np.int32)
        reqs.append((ids, types))
    jrunner = jserve.ModelRunner(jnet, batch_sizes=(4,),
                                 sample_shapes=[((T,), (T,))],
                                 dtype="int32")
    want = jrunner.run_batch([
        JRequest(r, jrunner.bucket_for(tuple(a.shape for a in r)))
        for r in reqs])

    cfg = serve.ServeConfig(max_batch_size=4, batch_sizes=(4,),
                            sample_shapes=[((T,), (T,))], dtype="int32")
    with serve.Server(tnet, ctx=mx.cpu(), config=cfg) as srv:
        assert srv.ready()
        futs = [srv.submit_async(r) for r in reqs]
        got = [f.result(timeout=120) for f in futs]
    for (ids, _), (g_seq, g_pooled), (w_seq, w_pooled) in zip(reqs, got,
                                                             want):
        assert g_seq.shape == w_seq.shape == (len(ids), CFG["units"])
        np.testing.assert_allclose(g_seq, w_seq, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g_pooled, w_pooled, rtol=0, atol=1e-4)
    assert telemetry.value("serve_requests_total", {"result": "ok"}) == 6


# ---------------------------------------------------------------------------
# micro-batch cases (ported from tests/python/unittest/test_serve.py)
# ---------------------------------------------------------------------------

def _make(in_units=16, units=4):
    # Dense over the last dim: row-independent, so padding then slicing
    # is exact
    def make():
        blk = nn.Dense(units, flatten=False, in_units=in_units)
        rs = np.random.RandomState(0)
        convert.load_jax_params(blk, {
            "weight": rs.randn(units, in_units).astype(np.float32),
            "bias": rs.randn(units).astype(np.float32)})
        return blk
    return make


class _GatedRunner(serve.ModelRunner):
    """Real runner whose dispatch can be stalled deterministically."""

    def __init__(self, *a, **k):
        self.gate = threading.Event()
        self.gate.set()
        self.served = []          # every Request that reached the model
        super().__init__(*a, **k)

    def run_batch(self, requests):
        self.gate.wait()
        self.served.extend(requests)
        return super().run_batch(requests)


def _gated_server(max_batch_size=4, queue_depth=64):
    cfg = serve.ServeConfig(max_batch_size=max_batch_size,
                            batch_sizes=(max_batch_size,),
                            sample_shapes=[(8, 16)],
                            queue_depth=queue_depth)
    runner = _GatedRunner(_make(), ctx=mx.cpu(), batch_sizes=cfg.batch_sizes,
                          sample_shapes=cfg.sample_shapes)
    return serve.Server(runner=runner, config=cfg), runner


def _want(x):
    blk = _make()()
    with torch.inference_mode():
        return blk(torch.from_numpy(x[None])).numpy()[0]


def test_bucket_for_picks_smallest_cover():
    runner = serve.ModelRunner(_make(), ctx=mx.cpu(), batch_sizes=(4,),
                               sample_shapes=[(16, 16), (8, 16)], warm=False)
    # table is sorted by volume, so (8,16) is bucket 0
    assert runner.bucket_for(((5, 16),)) == 0
    assert runner.bucket_for(((8, 16),)) == 0
    assert runner.bucket_for(((9, 16),)) == 1
    for shape in ((17, 16), (8, 32), (8,)):   # taller, wider, rank
        with pytest.raises(serve.NoBucketError):
            runner.bucket_for((shape,))


def test_batchqueue_collects_same_class_only():
    q = BatchQueue(depth=16)
    for cls in (0, 0, 1, 0, 1):
        q.put(Request((np.zeros(1),), cls))
    assert [r.bucket_class for r in q.collect(8, 0.0)] == [0, 0, 0]
    assert [r.bucket_class for r in q.collect(8, 0.0)] == [1, 1]


def test_batchqueue_max_batch_dispatches_immediately():
    q = BatchQueue(depth=16)
    for _ in range(6):
        q.put(Request((np.zeros(1),), 0))
    t0 = time.perf_counter()
    assert len(q.collect(max_batch=4, max_wait=10.0)) == 4    # capped
    assert time.perf_counter() - t0 < 1.0       # no max_wait stall
    assert len(q.collect(max_batch=4, max_wait=0.0)) == 2


def test_backpressure_rejects_fast_and_meters():
    srv, runner = _gated_server(queue_depth=3)
    try:
        runner.gate.clear()
        x = np.ones((4, 16), dtype="float32")
        futs = [srv.submit_async(x) for _ in range(3)]
        t0 = time.perf_counter()
        with pytest.raises(serve.ServerOverloaded):
            for _ in range(3):  # the scheduler may hold one batch
                futs.append(srv.submit_async(x))
        assert time.perf_counter() - t0 < 1.0   # reject, don't block
        assert telemetry.value("serve_requests_total",
                               {"result": "rejected"}) == 1
        runner.gate.set()
        for f in futs:
            np.testing.assert_allclose(f.result(timeout=30), _want(x),
                                       rtol=1e-6, atol=1e-6)
    finally:
        runner.gate.set()
        srv.shutdown()


def test_deadline_expiry_never_dispatches():
    srv, runner = _gated_server()
    try:
        runner.gate.clear()
        x = np.ones((4, 16), dtype="float32")
        blocker = srv.submit_async(x)   # dispatched, stalls in run_batch
        for _ in range(500):            # wait until the scheduler took it
            if srv.queue_depth() == 0:
                break
            time.sleep(0.01)
        assert srv.queue_depth() == 0
        # this one waits IN THE QUEUE behind the stalled batch until its
        # deadline passes, so expiry must fail it before dispatch
        fut = srv.submit_async(x, timeout_ms=30)
        time.sleep(0.1)
        runner.gate.set()
        with pytest.raises(serve.RequestTimeout):
            fut.result(timeout=30)
        blocker.result(timeout=30)
        assert telemetry.value("serve_requests_total",
                               {"result": "timeout"}) == 1
        assert telemetry.value("serve_requests_total",
                               {"result": "ok"}) == 1
        assert all(r.future is not fut for r in runner.served)
    finally:
        runner.gate.set()
        srv.shutdown()


def test_graceful_drain_serves_queued_requests():
    srv, runner = _gated_server(max_batch_size=2)
    runner.gate.clear()
    x = np.ones((4, 16), dtype="float32")
    futs = [srv.submit_async(x) for _ in range(5)]
    runner.gate.set()
    assert srv.shutdown(drain=True, timeout=60)
    for f in futs:
        np.testing.assert_allclose(f.result(timeout=1), _want(x),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(serve.ServerClosed):
        srv.submit(x)


def test_shutdown_without_drain_fails_pending():
    srv, runner = _gated_server(max_batch_size=2)
    runner.gate.clear()
    futs = [srv.submit_async(np.ones((4, 16), dtype="float32"))
            for _ in range(4)]
    runner.gate.set()
    srv.shutdown(drain=False, timeout=60)
    failed = 0
    for f in futs:
        try:
            f.result(timeout=5)
        except serve.ServeError:
            failed += 1
    assert failed >= 1


class _PoisonRunner(_GatedRunner):
    def run_batch(self, requests):
        if any(r.request_id == "poison" for r in requests):
            raise ValueError("poisoned input")
        return super().run_batch(requests)


def test_poisoned_request_fails_alone():
    cfg = serve.ServeConfig(max_batch_size=4, batch_sizes=(4,),
                            sample_shapes=[(8, 16)], max_wait_us=10 ** 6)
    runner = _PoisonRunner(_make(), ctx=mx.cpu(), batch_sizes=(4,),
                           sample_shapes=[(8, 16)])
    srv = serve.Server(runner=runner, config=cfg)
    try:
        xs = [np.full((3 + i, 16), i, dtype="float32") for i in range(4)]
        # four requests in one bucket fill one batch; the second is bad
        futs = [srv.submit_async(x, request_id="poison" if i == 1 else None)
                for i, x in enumerate(xs)]
        for i, (f, x) in enumerate(zip(futs, xs)):
            if i == 1:
                with pytest.raises(ValueError, match="poisoned"):
                    f.result(timeout=30)
            else:
                np.testing.assert_allclose(f.result(timeout=30), _want(x),
                                           rtol=1e-6, atol=1e-6)
        assert telemetry.value("serve_poison_requests_total") == 1
        assert telemetry.value("serve_bisect_splits_total") >= 1
        assert telemetry.value("serve_requests_total",
                               {"result": "poisoned"}) == 1
        assert telemetry.value("serve_requests_total",
                               {"result": "ok"}) == 3
    finally:
        srv.shutdown()
