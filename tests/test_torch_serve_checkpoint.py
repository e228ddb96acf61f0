"""Serving from a checkpoint in the PyTorch port, against the JAX package, on
the CPU.

1. The JAX package writes a checkpoint of the 2-layer BERT encoder (width
   64); the port's ``ModelRunner(factory, root=)`` and ``Server(factory,
   root)`` (the root passed positionally, in the JAX order) serve it, and
   every request's outputs agree with the JAX ``ModelRunner(root=)`` of the
   same checkpoint within 1e-5.  ``stats()`` carries the root and step.
2. ``tests/python/unittest/test_serve.py``'s ``test_hot_swap_is_atomic``,
   ported: while a client hammers the server, ``swap()`` moves it to the
   latest step; every answer comes whole from one model or the other, and
   the first request after the swap sees the new one.  A server built
   from a block instance (no factory) refuses to swap.
3. The positional-order guard: every shared callable's positional
   parameters come in the JAX package's order (``tests/
   test_torch_package.py``).
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import serve as jserve
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.serve.batching import Request as JRequest
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serve, telemetry
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

CFG = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=64)
T = 64


@pytest.fixture(autouse=True)
def _clean_registry():
    telemetry.enable()
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve_ckpt"))
    jnet = jbert.BERTModel(**CFG)
    jnet.initialize()
    rs = np.random.RandomState(0)
    for name, p in jnet.collect_params().items():
        val = rs.randn(*p.shape).astype(np.float32) * 0.1
        p.set_data(jmx.nd.array(val + (name.endswith(".gamma"))))
    jnet.save_checkpoint(root, step=5)
    reqs = []
    for L in (5, 64, 33, 17, 60, 1):
        ids = rs.randint(0, CFG["vocab_size"], L).astype(np.int32)
        types = (np.arange(L) >= L // 2).astype(np.int32)
        reqs.append((ids, types))
    jrunner = jserve.ModelRunner(lambda: jbert.BERTModel(**CFG), root=root,
                                 batch_sizes=(2,),
                                 sample_shapes=[((T,), (T,))],
                                 dtype="int32")
    assert jrunner.step == 5
    want = []
    for i in range(0, len(reqs), 2):
        part = reqs[i:i + 2]
        want += jrunner.run_batch([
            JRequest(r, jrunner.bucket_for(tuple(a.shape for a in r)))
            for r in part])
    return root, reqs, want


def _factory():
    return tbert.BERTModel(**CFG)


def _check(got, want, reqs):
    for (ids, _), (g_seq, g_pooled), (w_seq, w_pooled) in zip(reqs, got,
                                                             want):
        assert g_seq.shape == w_seq.shape == (len(ids), CFG["units"])
        np.testing.assert_allclose(g_seq, w_seq, rtol=0, atol=1e-5)
        np.testing.assert_allclose(g_pooled, w_pooled, rtol=0, atol=1e-5)


def test_model_runner_restores_a_jax_checkpoint(jax_checkpoint):
    root, reqs, want = jax_checkpoint
    runner = serve.ModelRunner(_factory, root=root, ctx=mx.cpu(),
                               batch_sizes=(2,),
                               sample_shapes=[((T,), (T,))], dtype="int32")
    assert runner.step == 5 and runner.warmed
    stats = runner.stats()
    assert stats["root"] == root and stats["step"] == 5
    got = []
    for i in range(0, len(reqs), 2):
        part = reqs[i:i + 2]
        got += runner.run_batch([
            serve.Request(r, runner.bucket_for(tuple(a.shape for a in r)))
            for r in part])
    _check(got, want, reqs)


def test_server_factory_root_positional_serves_the_checkpoint(
        jax_checkpoint):
    root, reqs, want = jax_checkpoint
    cfg = serve.ServeConfig(max_batch_size=2, batch_sizes=(2,),
                            sample_shapes=[((T,), (T,))], dtype="int32")
    with serve.Server(_factory, root, None, mx.cpu(), cfg) as srv:
        assert srv.ready() and srv.step == 5
        assert srv.runner.device.type == "cpu"
        futs = [srv.submit_async(r) for r in reqs]
        got = [f.result(timeout=120) for f in futs]
    _check(got, want, reqs)


def test_restore_without_ctx_wants_the_card(jax_checkpoint, monkeypatch):
    root, _, _ = jax_checkpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(mx.MXNetError, match=r"ctx=mx\.cpu\(\)"):
        serve.ModelRunner(_factory, root=root, warm=False)


# ---------------------------------------------------------------------------
# hot swap (ported from tests/python/unittest/test_serve.py)
# ---------------------------------------------------------------------------

def _dense_factory(in_units=8, units=4):
    # Dense over the last dim: row-independent, so padding then slicing
    # is exact
    def make():
        return nn.Dense(units, flatten=False, in_units=in_units)
    return make


def _two_steps(tmp_path):
    make = _dense_factory()
    blk = make()
    blk.initialize(ctx=mx.cpu())
    root = str(tmp_path / "ckpt")
    for step, val in ((1, 1.0), (2, 2.0)):
        for p in blk.collect_params().values():
            p.set_data(torch.full(tuple(p.shape), val))
        blk.save_checkpoint(root, step=step)
    return make, root


def test_hot_swap_is_atomic(tmp_path):
    make, root = _two_steps(tmp_path)
    cfg = serve.ServeConfig(max_batch_size=2, batch_sizes=(2,),
                            sample_shapes=[(4, 8)], max_wait_us=200,
                            queue_depth=64)
    srv = serve.Server(make, root=root, step=1, ctx=mx.cpu(), config=cfg)
    try:
        x = np.ones((4, 8), dtype="float32")
        assert float(srv.submit(x)[0, 0]) == 9.0     # w=1, b=1: 8 + 1
        seen, stop = [], threading.Event()

        def hammer():
            while not stop.is_set():
                seen.append(srv.submit(x))

        t = threading.Thread(target=hammer)
        t.start()
        try:
            assert srv.swap() == 2                  # default: the latest
        finally:
            stop.set()
            t.join()
        assert float(srv.submit(x)[0, 0]) == 18.0
        # every answer came whole from model 1 or model 2
        for out in seen:
            assert np.all(out == 9.0) or np.all(out == 18.0)
        assert telemetry.value("serve_model_swaps_total") == 1
        assert srv.step == 2 and srv.runner.stats()["step"] == 2
        assert srv.swap(step=1) == 1                 # and back
        assert float(srv.submit(x)[0, 0]) == 9.0
    finally:
        srv.shutdown()


def test_swap_without_factory_fails_loudly(tmp_path):
    make, root = _two_steps(tmp_path)
    cfg = serve.ServeConfig(max_batch_size=2, batch_sizes=(2,),
                            sample_shapes=[(4, 8)])
    blk = make()
    srv = serve.Server(blk, root, ctx=mx.cpu(), config=cfg)
    try:
        assert srv.step == 2
        with pytest.raises(serve.ServeError, match="FACTORY"):
            srv.swap()
    finally:
        srv.shutdown()


def test_positional_parameters_follow_the_jax_order():
    """The guard itself lives in ``tests/test_torch_package.py``; here,
    the case that it was written for: ``Server``'s first three positional
    parameters are the JAX package's."""
    import inspect

    from mxnet_tpu.serve.server import Server as JServer

    def positional(f):
        return [n for n, p in inspect.signature(f).parameters.items()
                if p.kind == p.POSITIONAL_OR_KEYWORD][:6]

    assert positional(serve.Server) == positional(JServer)
