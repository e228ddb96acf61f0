"""The decode plane of the PyTorch port (``serve.DecodeRunner``,
``serve.DecodeScheduler``, ``serve.TinyDecoder``) against the JAX package,
on the CPU.

1. Teacher-forced steps: ``TinyDecoder`` with the same weights (carried by
   name) gives the prefill and decode logits, ``k_new`` and ``v_new`` of
   the JAX block within 1e-5 on the same inputs, and the runners' prefill
   and decode steps leave both pools within 1e-5 after every step.
2. Collected streams: four prompts served concurrently by each package's
   scheduler give identical token streams; every emitted token's top-2
   logit gap (a dense recomputation) exceeds 1e-3 of max|logit|, so a
   near-tie cannot pass for a fault.
3. ``tests/python/unittest/test_serve_decode.py``'s behaviour cases,
   ported: paged equal to unpaged, independence in a batch, EOS,
   validation, backpressure, one build per bucket, join and leave, streams,
   deadline, drain, abort, poison and nonfinite alone, the transient
   dispatch fault, bisection, breakers, the quarantined bucket's rotation,
   the dropped scheduler, hot swap; and the port's own: ``tenant=`` and
   ``mesh=`` refused, the card as the default device.
"""
import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import serve as jserve
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serve, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.resilience import inject
from mxnet_tpu_torch.resilience.inject import InjectedFault


@pytest.fixture(autouse=True)
def _clean():
    telemetry.enable()
    telemetry.reset()
    inject.clear()
    yield
    inject.clear()
    telemetry.reset()


def weights(vocab=32, layers=2, heads=2, dim=4, seed=0, scale=0.5):
    """{name: array} for a TinyDecoder: N(0, 1) embeddings, dense weights
    N(0, scale^2 / fan_in), small biases (varied greedy streams)."""
    rs = np.random.RandomState(seed)
    units = heads * dim
    shapes = {"embed.weight": (vocab, units),
              "unembed.weight": (vocab, units), "unembed.bias": (vocab,)}
    for i in range(layers):
        for n in "qkvo":
            shapes["%s%d.weight" % (n, i)] = (units, units)
            shapes["%s%d.bias" % (n, i)] = (units,)
        shapes["up%d.weight" % i] = (2 * units, units)
        shapes["up%d.bias" % i] = (2 * units,)
        shapes["down%d.weight" % i] = (units, 2 * units)
        shapes["down%d.bias" % i] = (units,)
    out = {}
    for name in sorted(shapes):
        shp = shapes[name]
        if name.startswith("embed"):
            v = rs.randn(*shp)
        elif name.endswith("bias"):
            v = rs.randn(*shp) * 0.1
        else:
            v = rs.randn(*shp) * scale / np.sqrt(shp[1])
        out[name] = v.astype(np.float32)
    return out


def decoder(vocab=32, layers=2, heads=2, dim=4, seed=0, eos_id=None,
            params=None):
    blk = serve.TinyDecoder(vocab_size=vocab, num_layers=layers,
                            num_heads=heads, head_dim=dim, eos_id=eos_id)
    blk.initialize(ctx=mx.cpu())
    load_jax_params(blk, params or weights(vocab, layers, heads, dim, seed))
    return blk


def jax_decoder(params, vocab=32, layers=2, heads=2, dim=4):
    blk = jserve.TinyDecoder(vocab_size=vocab, num_layers=layers,
                             num_heads=heads, head_dim=dim)
    blk.initialize()
    for name, p in blk.collect_params().items():
        p.set_data(jmx.nd.array(params[name]))
    return blk


def config(module=serve, **kw):
    kw.setdefault("page_size", 4)
    kw.setdefault("pool_pages", 32)
    kw.setdefault("max_live", 2)
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("max_context", 16)
    kw.setdefault("prefill_lengths", (8,))
    kw.setdefault("batch_sizes", (1, 2))
    return module.DecodeConfig(**kw)


def runner(blk=None, cls=serve.DecodeRunner, **kw):
    return cls(blk if blk is not None else decoder(), ctx=mx.cpu(),
               config=config(**kw))


class _Gated(serve.DecodeRunner):
    """Real decode runner with deterministic failure/latency knobs."""

    def __init__(self, *a, **k):
        self.step_delay = 0.0
        self.fail_decode = 0
        self.fail_prefill = 0
        super().__init__(*a, **k)

    def decode_step(self, seqs):
        if self.step_delay:
            time.sleep(self.step_delay)
        if self.fail_decode > 0:
            self.fail_decode -= 1
            raise RuntimeError("injected decode failure")
        return super().decode_step(seqs)

    def prefill(self, seq):
        if self.fail_prefill > 0:
            self.fail_prefill -= 1
            raise RuntimeError("injected prefill failure")
        return super().prefill(seq)


def dense_logits(blk, tokens):
    """Every position's logits of ``tokens`` by one prefill-shaped (S=0)
    pass, no pages: [len(tokens), vocab]."""
    L, H, D = blk.num_layers, blk.num_kv_heads, blk.head_dim
    zero = torch.zeros(1, L, 0, H, D)
    with torch.no_grad():
        x, _, _ = blk.trunk(torch.tensor([tokens], dtype=torch.int32), zero,
                            zero, torch.zeros(1, dtype=torch.int32))
        return blk.unembed(x)[0].numpy()


def reference_decode(blk, prompt, n):
    """Greedy decode WITHOUT paging: a contiguous cache, one block call
    a token."""
    L, H, D = blk.num_layers, blk.num_kv_heads, blk.head_dim
    i32 = torch.int32
    with torch.no_grad():
        zero = torch.zeros(1, L, 0, H, D)
        logits, ks, vs = blk(torch.tensor([prompt], dtype=i32), zero, zero,
                             torch.tensor([0], dtype=i32),
                             torch.tensor([len(prompt)], dtype=i32))
        out = [int(torch.argmax(logits[0]))]
        for _ in range(n - 1):
            logits, kn, vn = blk(
                torch.tensor([[out[-1]]], dtype=i32),
                ks.transpose(1, 2), vs.transpose(1, 2),
                torch.tensor([ks.shape[1]], dtype=i32),
                torch.tensor([1], dtype=i32))
            ks = torch.cat([ks, kn], dim=1)
            vs = torch.cat([vs, vn], dim=1)
            out.append(int(torch.argmax(logits[0])))
    return out


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

PCFG = dict(vocab=64, layers=2, heads=2, dim=8)
PROMPTS = ([1, 2, 3], [5, 9, 11, 2, 7, 7, 1], [60],
           [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13])


@pytest.fixture(scope="module")
def pair():
    params = weights(seed=4, **PCFG)
    kw = dict(page_size=4, pool_pages=24, max_live=4, max_new_tokens=8,
              max_context=24, prefill_lengths=(8, 16),
              batch_sizes=(1, 2, 4))
    jr = jserve.DecodeRunner(jax_decoder(params, **PCFG),
                             config=config(jserve, **kw))
    tr = serve.DecodeRunner(decoder(params=params, **PCFG), ctx=mx.cpu(),
                            config=config(**kw))
    return jr, tr


class _Stand:
    """A sequence as the runners see it."""

    class _Req:
        def __init__(self, prompt):
            self.prompt = prompt

    def __init__(self, prompt, pages):
        self.req = self._Req(prompt)
        self.pages = pages
        self.length = 0
        self.last_token = 0
        self.prefix_len = 0


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                               err_msg=what)


def _pools_close(jr, tr, what):
    for jp, tp in ((jr.pool.k, tr.pool.k), (jr.pool.v, tr.pool.v)):
        _close(tp.numpy(), np.asarray(jp), what)


def test_teacher_forced_steps_match_jax(pair):
    jr, tr = pair
    jblk, tblk = jr.block, tr.block
    nd = jmx.nd
    prompts = (PROMPTS[1], PROMPTS[3])
    seqs = []
    for i, p in enumerate(prompts):
        pages = tr.pool.alloc("tf%d" % i, 6)
        assert jr.pool.alloc("tf%d" % i, 6) == pages
        seqs.append((_Stand(p, pages), _Stand(p, pages)))
    try:
        L, H, D = 2, 2, 8
        for js, ts in seqs:
            # the block alone: prefill logits and cache rows
            T = 16
            tok = np.zeros((1, T), np.int32)
            tok[0, :len(js.req.prompt)] = js.req.prompt
            zero = np.zeros((1, L, 0, H, D), np.float32)
            lens = (np.zeros(1, np.int32),
                    np.array([len(js.req.prompt)], np.int32))
            want = jblk(nd.array(tok, dtype="int32"), nd.array(zero),
                        nd.array(zero), nd.array(lens[0], dtype="int32"),
                        nd.array(lens[1], dtype="int32"))
            with torch.no_grad():
                got = tblk(*[torch.from_numpy(a) for a in
                             (tok, zero, zero) + lens])
            for g, w, n in zip(got, want, ("logits", "k_new", "v_new")):
                _close(g.numpy(), w.asnumpy(), "prefill " + n)
            # the runners' prefill steps
            assert jr.prefill(js) == tr.prefill(ts)
            js.length = ts.length = len(js.req.prompt)
        _pools_close(jr, tr, "pools after the prefills")
        rng = np.random.RandomState(1)
        for step in range(4):
            forced = rng.randint(0, 64, len(seqs))
            for (js, ts), t in zip(seqs, forced):
                js.last_token = ts.last_token = int(t)
            # the block alone on the gathered, scrubbed context
            tables = tr._table(2, [ts.pages for _, ts in seqs])
            k_ctx = np.asarray(jserve.kvcache.gather_pages(
                jr.pool.k, tables))
            v_ctx = np.asarray(jserve.kvcache.gather_pages(
                jr.pool.v, tables))
            ctx = np.array([s.length for s, _ in seqs], np.int32)
            live = np.arange(k_ctx.shape[2])[None, None, :, None, None] \
                < ctx[:, None, None, None, None]
            k_ctx, v_ctx = np.where(live, k_ctx, 0), np.where(live, v_ctx, 0)
            tok = forced.astype(np.int32)[:, None]
            ones = np.ones(2, np.int32)
            want = jblk(nd.array(tok, dtype="int32"), nd.array(k_ctx),
                        nd.array(v_ctx), nd.array(ctx, dtype="int32"),
                        nd.array(ones, dtype="int32"))
            with torch.no_grad():
                got = tblk(*[torch.from_numpy(a) for a in
                             (tok, k_ctx, v_ctx, ctx, ones)])
            for g, w, n in zip(got, want, ("logits", "k_new", "v_new")):
                _close(g.numpy(), w.asnumpy(), "decode %d %s" % (step, n))
            jt, jb = jr.decode_step([js for js, _ in seqs])
            tt, tb = tr.decode_step([ts for _, ts in seqs])
            assert list(jt) == list(tt) and list(jb) == list(tb) == [0, 0]
            for js, ts in seqs:
                js.length += 1
                ts.length += 1
            _pools_close(jr, tr, "pools after decode step %d" % step)
    finally:
        for i in range(len(prompts)):
            jr.pool.release("tf%d" % i)
            tr.pool.release("tf%d" % i)


def test_collected_streams_equal_jax(pair):
    jr, tr = pair
    js, ts = jserve.DecodeScheduler(jr), serve.DecodeScheduler(tr)
    try:
        jf = [js.submit(p, max_new_tokens=8) for p in PROMPTS]
        tf = [ts.submit(p, max_new_tokens=8) for p in PROMPTS]
        want = [f.result(60)["tokens"] for f in jf]
        got = [f.result(60)["tokens"] for f in tf]
    finally:
        js.stop()
        ts.stop()
    assert got == want
    assert len({tuple(g) for g in got}) > 1
    for p, toks in zip(PROMPTS, got):
        logits = dense_logits(tr.block, p + toks[:-1])[len(p) - 1:]
        for row, t in zip(logits, toks):
            top2 = np.sort(row)[-2:]
            assert int(np.argmax(row)) == t
            assert top2[1] - top2[0] > 1e-3 * np.abs(row).max()
    assert tr.pool.in_use == 0 and tr.pool.check()


# ---------------------------------------------------------------------------
# test_serve_decode.py's behaviour cases
# ---------------------------------------------------------------------------

def test_paged_decode_matches_unpaged_reference():
    blk = decoder()
    r = runner(blk)
    sched = serve.DecodeScheduler(r)
    try:
        for prompt in ([1, 2, 3], [5], [7, 8, 9, 10, 11]):
            got = sched.submit(prompt, max_new_tokens=6).result(timeout=60)
            assert got["tokens"] == reference_decode(blk, prompt, 6)
            assert got["finish_reason"] == "length"
    finally:
        sched.stop()
    assert r.pool.in_use == 0
    r.pool.check()


def test_concurrent_sequences_are_independent():
    blk = decoder(seed=3)
    sched = serve.DecodeScheduler(runner(blk))
    try:
        f1 = sched.submit([1, 2, 3], max_new_tokens=6)
        f2 = sched.submit([9, 4], max_new_tokens=6)
        got1 = f1.result(timeout=60)["tokens"]
        got2 = f2.result(timeout=60)["tokens"]
    finally:
        sched.stop()
    assert got1 == reference_decode(blk, [1, 2, 3], 6)
    assert got2 == reference_decode(blk, [9, 4], 6)


def test_eos_stops_generation():
    sched = serve.DecodeScheduler(runner())
    try:
        ref = sched.submit([1, 2, 3], max_new_tokens=6).result(60)
        eos = ref["tokens"][2]
        got = sched.submit([1, 2, 3], max_new_tokens=6,
                           eos_id=eos).result(60)
        assert got["finish_reason"] == "eos"
        assert got["tokens"] == ref["tokens"][:ref["tokens"].index(eos) + 1]
    finally:
        sched.stop()


def test_submit_validation():
    sched = serve.DecodeScheduler(runner())
    try:
        with pytest.raises(serve.DecodeError):
            sched.submit([])                           # empty prompt
        with pytest.raises(serve.DecodeError):
            sched.submit([99])                         # out of vocab
        with pytest.raises(serve.DecodeError):
            sched.submit([1], max_new_tokens=0)
        with pytest.raises(serve.DecodeError):
            sched.submit([1] * 9)          # beyond largest prefill bucket
        with pytest.raises(serve.DecodeError):
            sched.submit([1] * 12, max_new_tokens=6)   # > max_context
        with pytest.raises(serve.DecodeError, match="item 9"):
            sched.submit([1], tenant="acme")
    finally:
        sched.stop()


def test_admission_queue_backpressure():
    r = runner(cls=_Gated, max_live=1, queue_depth=1, batch_sizes=(1,))
    r.step_delay = 0.02
    sched = serve.DecodeScheduler(r)
    try:
        a = sched.submit([1, 2], max_new_tokens=6)
        for _ in range(200):           # A admitted: the only slot held
            if sched.stats()["live"]:
                break
            time.sleep(0.005)
        b = sched.submit([1, 2], max_new_tokens=6)     # waits (depth 1)
        with pytest.raises(serve.ServerOverloaded):
            sched.submit([1, 2], max_new_tokens=6)
        assert a.result(60) and b.result(60)
    finally:
        sched.stop()
    assert r.pool.in_use == 0


def test_at_most_one_build_per_bucket_and_none_on_the_hot_path():
    r = runner()
    labels = list(r.provenance())
    assert sorted(labels) == ["decode:b1", "decode:b2", "prefill:t8"]
    assert set(r.provenance().values()) == {"not ported"}
    for label in labels:
        assert telemetry.value("serve_decode_compile_total",
                               labels={"bucket": label}) == 1
    before = telemetry.value("serve_decode_compile_total")
    sched = serve.DecodeScheduler(r)
    try:
        futs = [sched.submit([1 + i, 2], max_new_tokens=6)
                for i in range(4)]
        for f in futs:
            f.result(timeout=60)
    finally:
        sched.stop()
    assert telemetry.value("serve_decode_compile_total") == before


def test_sequences_join_and_leave_the_running_batch():
    r = runner(cls=_Gated, max_new_tokens=40, max_context=48)
    r.step_delay = 0.005
    sched = serve.DecodeScheduler(r)
    try:
        a = sched.submit([1, 2, 3], max_new_tokens=30, request_id="A")
        for _ in range(400):                 # A mid-generation
            live = sched.stats()["live"]
            if live and live[0]["generated"] >= 3:
                break
            time.sleep(0.005)
        else:
            raise AssertionError("A never started generating")
        b = sched.submit([4, 5], max_new_tokens=3, request_id="B")
        a.result(timeout=60)
        b.result(timeout=60)
    finally:
        sched.stop()
    rec = {x["request_id"]: x for x in sched.recent()}
    ra, rb = rec["A"], rec["B"]
    # B joined the RUNNING batch between A's join and leave, and left
    # while A was still decoding
    assert ra["joined_step"] < rb["joined_step"] < ra["left_step"]
    assert rb["left_step"] < ra["left_step"]
    assert r.pool.in_use == 0
    r.pool.check()


def test_streamed_tokens_identical_to_collected():
    sched = serve.DecodeScheduler(runner())
    try:
        collected = sched.submit([1, 2, 3],
                                 max_new_tokens=6).result(60)["tokens"]
        streamed = []
        fut = sched.submit([1, 2, 3], max_new_tokens=6,
                           on_token=lambda t, i: streamed.append((i, t)))
        final = fut.result(timeout=60)["tokens"]
    finally:
        sched.stop()
    assert [t for _i, t in streamed] == final == collected
    assert [i for i, _t in streamed] == list(range(len(final)))


def test_sick_stream_consumer_does_not_stall_decode():
    sched = serve.DecodeScheduler(runner())
    try:
        def bad_cb(tok, i):
            raise RuntimeError("consumer died")

        got = sched.submit([1, 2, 3], max_new_tokens=6,
                           on_token=bad_cb).result(timeout=60)
        assert len(got["tokens"]) == 6
    finally:
        sched.stop()


def test_deadline_expires_mid_generation_pages_reclaimed():
    r = runner(cls=_Gated, max_new_tokens=60, max_context=64)
    r.step_delay = 0.05
    sched = serve.DecodeScheduler(r)
    try:
        fut = sched.submit([1, 2, 3], max_new_tokens=50, timeout_ms=150)
        with pytest.raises(serve.RequestTimeout):
            fut.result(timeout=60)
    finally:
        sched.stop()
    assert r.pool.in_use == 0, "expired sequence leaked pages"
    r.pool.check()
    assert sched.evictions.get("timeout") == 1
    assert telemetry.value("serve_requests_total",
                           labels={"result": "timeout"}) == 1


def test_drain_serves_queued_then_stops_and_rejects_after_close():
    r = runner()
    sched = serve.DecodeScheduler(r)
    futs = [sched.submit([1 + i], max_new_tokens=4) for i in range(4)]
    assert sched.stop(drain=True, timeout=60)
    for f in futs:
        assert len(f.result(timeout=1)["tokens"]) == 4
    with pytest.raises(serve.ServerClosed):
        sched.submit([1])
    assert r.pool.in_use == 0


def test_abort_shutdown_cancels_and_reclaims():
    r = runner(cls=_Gated, max_new_tokens=60, max_context=64)
    r.step_delay = 0.02
    sched = serve.DecodeScheduler(r)
    fut = sched.submit([1, 2], max_new_tokens=50)
    for _ in range(200):
        if sched.stats()["live"]:
            break
        time.sleep(0.005)
    assert sched.stop(drain=False, timeout=60)
    with pytest.raises(serve.ServerClosed):
        fut.result(timeout=1)
    assert r.pool.in_use == 0, "cancelled sequence leaked pages"
    r.pool.check()


def test_injected_poison_sequence_fails_alone_pages_reclaimed():
    inject.plan("serve_poison@poison-x")
    r = runner()
    sched = serve.DecodeScheduler(r)
    try:
        good1 = sched.submit([1, 2], max_new_tokens=6, request_id="ok-1")
        bad = sched.submit([3, 4], max_new_tokens=6, request_id="poison-x")
        good2 = sched.submit([5, 6], max_new_tokens=6, request_id="ok-2")
        with pytest.raises(InjectedFault):
            bad.result(timeout=60)
        assert len(good1.result(timeout=60)["tokens"]) == 6
        assert len(good2.result(timeout=60)["tokens"]) == 6
    finally:
        sched.stop()
    assert telemetry.value("serve_poison_requests_total") >= 1
    assert telemetry.value("serve_requests_total",
                           labels={"result": "poisoned"}) == 1
    assert telemetry.value("resilience_faults_injected_total",
                           labels={"site": "serve_poison"}) == 1
    assert inject.state()["entries"][0]["fired"] == 1
    assert r.pool.in_use == 0, "poisoned sequence leaked pages"
    r.pool.check()


def test_nonfinite_sequence_evicted_alone_batchmates_complete():
    blk = decoder(seed=1)
    # poison ONE embedding row: any prompt holding token 9 goes NaN
    data = blk.embed.weight.detach().clone()
    data[9] = float("nan")
    blk.embed.weight.set_data(data)
    r = runner(blk)
    sched = serve.DecodeScheduler(r)
    try:
        bad = sched.submit([9, 1], max_new_tokens=6, request_id="nan-1")
        good = sched.submit([1, 2], max_new_tokens=6, request_id="ok-1")
        with pytest.raises(serve.DecodeError, match="nonfinite"):
            bad.result(timeout=60)
        got = good.result(timeout=60)
        assert got["tokens"] == reference_decode(blk, [1, 2], 6)
        # the poisoned pages go back to the free list unzeroed: a later
        # sequence on them decodes clean (the scrub)
        again = sched.submit([1, 2], max_new_tokens=6).result(timeout=60)
        assert again["tokens"] == got["tokens"]
    finally:
        sched.stop()
    assert telemetry.value("serve_nonfinite_outputs_total") > 0
    assert telemetry.value("serve_poison_requests_total") >= 1
    assert r.pool.in_use == 0
    r.pool.check()


def test_injected_dispatch_fault_is_transient_nobody_evicted():
    inject.plan("serve_dispatch@*:transient")
    sched = serve.DecodeScheduler(runner())
    try:
        got = sched.submit([1, 2], max_new_tokens=6).result(timeout=60)
        assert len(got["tokens"]) == 6      # retried next iteration
    finally:
        sched.stop()
    assert telemetry.value("resilience_faults_injected_total",
                           labels={"site": "serve_dispatch"}) == 1


def test_real_decode_failure_bisects_to_the_failing_half():
    r = runner(cls=_Gated)
    sched = serve.DecodeScheduler(r, start=False)
    f = []
    orig = serve.DecodeRunner.decode_step

    def flaky(self, seqs):
        if len(seqs) > 1 and not f:
            f.append(1)
            raise RuntimeError("batch-level glitch")
        return orig(self, seqs)

    r.decode_step = flaky.__get__(r)
    sched.start()
    try:
        a = sched.submit([1, 2], max_new_tokens=6)
        b = sched.submit([3, 4], max_new_tokens=6)
        assert len(a.result(60)["tokens"]) == 6
        assert len(b.result(60)["tokens"]) == 6
    finally:
        sched.stop()
    assert telemetry.value("serve_bisect_splits_total") >= 1
    assert r.pool.in_use == 0


def test_prefill_breaker_quarantines_after_repeated_failures():
    r = runner(cls=_Gated)
    r.fail_prefill = 99
    board = serve.BreakerBoard(threshold=2, cooldown=60.0)
    sched = serve.DecodeScheduler(r, breakers=board)
    try:
        for _ in range(2):
            with pytest.raises(RuntimeError):
                sched.submit([1, 2], max_new_tokens=4).result(timeout=60)
        assert board.snapshot()["('prefill', 8)"]["state"] == "open"
        with pytest.raises(serve.BucketQuarantined):
            sched.submit([1, 2], max_new_tokens=4)
    finally:
        sched.stop()
    assert r.pool.in_use == 0, "failed prefills leaked pages"


def test_decode_bucket_breaker_trips_and_bisect_isolates_one():
    r = runner(cls=_Gated, max_new_tokens=20, max_context=32)
    r.step_delay = 0.02          # keep the batch alive while arming
    board = serve.BreakerBoard(threshold=1, cooldown=0.05)
    sched = serve.DecodeScheduler(r, breakers=board)
    try:
        a = sched.submit([1, 2], max_new_tokens=12, request_id="A")
        b = sched.submit([3, 4], max_new_tokens=12, request_id="B")
        for _ in range(400):     # arm once both run, so a 2-batch fails
            if len(sched.stats()["live"]) == 2:
                break
            time.sleep(0.005)
        r.fail_decode = 2
        results = []
        for fut in (a, b):
            try:
                results.append(fut.result(timeout=60)["tokens"])
            except RuntimeError:
                results.append(None)
        assert sorted(x is None for x in results) == [False, True], \
            "exactly one sequence must fail, its mate completes"
        assert len(next(x for x in results if x is not None)) == 12
        assert sched.stats()["breakers"]["('decode', 2)"]["trips"] >= 1
    finally:
        sched.stop()
    assert telemetry.value("serve_poison_requests_total") >= 1
    assert r.pool.in_use == 0
    r.pool.check()


def test_quarantined_largest_bucket_chunks_with_rotation():
    r = runner(max_live=3, batch_sizes=(1, 2, 4))
    board = serve.BreakerBoard(threshold=1, cooldown=300.0)
    board.failure(("decode", 4))          # the largest bucket: open
    sched = serve.DecodeScheduler(r, breakers=board)
    try:
        futs = [sched.submit([1 + i, 2], max_new_tokens=6)
                for i in range(3)]
        for f in futs:
            assert len(f.result(timeout=60)["tokens"]) == 6, \
                "a sequence starved behind the quarantined bucket"
    finally:
        sched.stop()
    assert r.pool.in_use == 0


def test_dropped_scheduler_thread_winds_down():
    r = runner()
    sched = serve.DecodeScheduler(r)
    assert len(sched.submit([1, 2], max_new_tokens=4)
               .result(timeout=60)["tokens"]) == 4
    t = sched._thread
    wr = weakref.ref(sched)
    del sched, r
    gc.collect()
    t.join(timeout=5.0)
    assert not t.is_alive(), "decode loop thread pinned a dead scheduler"
    gc.collect()
    assert wr() is None, "scheduler (and its KV pool) leaked"


def test_hot_swap_finishes_live_on_old_runner_no_leaks():
    blk_a, blk_b = decoder(seed=0), decoder(seed=7)
    ra = runner(blk_a, cls=_Gated, max_new_tokens=20, max_context=32)
    ra.step_delay = 0.01
    rb = runner(blk_b)
    sched = serve.DecodeScheduler(ra)
    try:
        a = sched.submit([1, 2], max_new_tokens=15)
        for _ in range(400):
            if sched.stats()["live"]:
                break
            time.sleep(0.005)
        sched.swap(rb)
        b = sched.submit([1, 2], max_new_tokens=6)   # admitted on B
        got_a = a.result(timeout=60)["tokens"]
        got_b = b.result(timeout=60)["tokens"]
    finally:
        sched.stop()
    assert got_a == reference_decode(blk_a, [1, 2], 15), \
        "live sequence must finish on the OLD model"
    assert got_b == reference_decode(blk_b, [1, 2], 6), \
        "post-swap admission must run on the NEW model"
    assert ra.pool.in_use == 0 and rb.pool.in_use == 0
    ra.pool.check()
    rb.pool.check()
    assert sched.runner is rb
    assert telemetry.value("serve_model_swaps_total") == 1


def test_shared_config_not_mutated_by_runner_eos():
    cfg = config()
    r = serve.DecodeRunner(decoder(eos_id=2), ctx=mx.cpu(), config=cfg)
    assert r.eos_id == 2          # the model's default adopted
    assert cfg.eos_id is None, \
        "runner absorbed its model's eos_id into the SHARED config"
    other = serve.DecodeRunner(decoder(), ctx=mx.cpu(), config=cfg)
    assert other.eos_id is None


def test_tenancy_mesh_and_the_default_device():
    with pytest.raises(MXNetError, match="item 9"):
        serve.DecodeRunner(decoder(), ctx=mx.cpu(), config=config(),
                           tenant=object())
    with pytest.raises(MXNetError, match="item 7"):
        serve.DecodeRunner(decoder(), ctx=mx.cpu(), config=config(),
                           mesh=object())
    with pytest.raises(MXNetError, match="item 9"):
        serve.DecodeScheduler(runner(), start=False, tenant=object())
    with pytest.raises(serve.DecodeError, match="item 9"):
        serve.DecodeRequest([1], 2, export_only=True)
    if not torch.cuda.is_available():
        # the card is the default: without one the runner raises
        with pytest.raises(MXNetError, match="ctx=mx.cpu"):
            serve.DecodeRunner(decoder(), config=config())
    r = runner()
    assert r.device.type == "cpu" and r.pool.k.device.type == "cpu"
    st = r.stats()
    assert st["bank"] == {"enabled": False} and st["device"] == "cpu"
    assert set(st) >= {"pool", "buckets", "config", "cache", "spec"}


def test_concurrent_submitters_all_served():
    """Admission runs on submitter threads: sixteen threads (more than the
    cores) submitting at once with a short switch interval are all served
    their own streams, and every page comes home."""
    import sys

    blk = decoder(seed=5)
    r = runner(blk, max_live=4, batch_sizes=(1, 2, 4))
    sched = serve.DecodeScheduler(r)
    out = {}

    def client(i):
        out[i] = sched.submit([1 + i, 3], max_new_tokens=5).result(60)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
        sched.stop()
    assert not any(t.is_alive() for t in threads)
    for i in range(16):
        assert out[i]["tokens"] == reference_decode(blk, [1 + i, 3], 5)
    assert sched.admitted_total == 16
    assert r.pool.in_use == 0 and r.pool.check()
