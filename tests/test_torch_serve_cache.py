"""The prefix cache and speculative decoding of the PyTorch port
(``serve.PrefixCache``, ``serve.SpecPlane``) against the JAX package, on
the CPU.

1. ``PrefixCache``: the same random insert / acquire / release / evict /
   invalidate churn on both packages' caches over both packages' pools
   gives the same pages, matches, classes, refcounts and ``stats()`` after
   every operation.
2. Cached-prefix streams: the port serving a shared prefix with the cache
   on gives the JAX scheduler's (cache off) tokens.
3. ``tests/python/unittest/test_serve_cache.py``, ported: exact refcounts,
   the copy-on-write fork, LRU eviction that skips live readers,
   invalidation, the double-free guard, property churn, digests, cached
   and forked decode identical to cold, the ``serve_cache`` drill,
   speculative decode identical to single-step, self-speculation
   accepting more than one token a step, the ``spec_verify`` drill, and
   the stats surface.
"""
import random

import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu import serve as jserve
from mxnet_tpu.serve.cache import PrefixCache as JPrefixCache
from mxnet_tpu.serve.kvcache import PageConfig as JPageConfig
from mxnet_tpu.serve.kvcache import PagePool as JPagePool
from mxnet_tpu_torch import serve, telemetry
from mxnet_tpu_torch.resilience import inject
from mxnet_tpu_torch.serve.batching import ServeError
from mxnet_tpu_torch.serve.cache import PrefixCache, prefix_digest
from test_torch_decode import config, decoder, jax_decoder, weights


@pytest.fixture(autouse=True)
def _clean():
    telemetry.enable()
    telemetry.reset()
    inject.clear()
    yield
    inject.clear()
    telemetry.reset()


def _config(**kw):
    kw.setdefault("max_context", 24)
    kw.setdefault("prefill_lengths", (8, 20))
    return config(**kw)


def _runner(seed=0, draft=None, **kw):
    return serve.DecodeRunner(decoder(seed=seed), ctx=mx.cpu(),
                              config=_config(**kw), draft=draft)


def _pool(pages=16, page_size=4, max_context=64):
    return serve.PagePool(serve.PageConfig(page_size, pages, 2, 2, 4,
                                           max_context), device=mx.cpu())


def _run(runner, prompt, mnt=6, request_id=None):
    sched = serve.DecodeScheduler(runner)
    try:
        return sched.submit(list(prompt), max_new_tokens=mnt,
                            request_id=request_id).result(timeout=60)
    finally:
        sched.stop()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_prefix_cache_accounting_matches_jax_operation_for_operation():
    rng = random.Random(11)
    pool, jpool = _pool(pages=48), JPagePool(JPageConfig(4, 48, 2, 2, 4, 64))
    cache, jcache = PrefixCache(pool), JPrefixCache(jpool)
    readers, nid = [], 0
    for step in range(200):
        op = rng.random()
        if op < 0.5:
            n = rng.randrange(5, 20)
            prompt = [rng.randrange(3) for _ in range(n)]
            assert cache.match(prompt) == jcache.match(prompt)
            got, want = cache.acquire(prompt), jcache.acquire(prompt)
            assert got == want, step
            shared, hit, _ = got
            own = max(0, (n - 1) // 4) - len(shared) + 2
            if not pool.can_alloc(own):
                assert not jpool.can_alloc(own)
                cache.release(shared)
                jcache.release(shared)
                assert cache.evict(own) == jcache.evict(own)
                continue
            oid = "s%d" % nid
            nid += 1
            table = list(shared) + pool.alloc(oid, own)
            assert list(shared) + jpool.alloc(oid, own) == table
            adopted = cache.insert(prompt, oid, table, hit)
            assert jcache.insert(prompt, oid, table, hit) == adopted
            readers.append((oid, table[:len(shared) + adopted], prompt))
        elif readers and op < 0.8:
            oid, shared, _ = readers.pop(rng.randrange(len(readers)))
            if shared:
                assert cache.release(shared) == jcache.release(shared)
            assert pool.release(oid) == jpool.release(oid)
        elif readers and op < 0.85:
            prompt = readers[rng.randrange(len(readers))][2]
            assert cache.invalidate(prompt) == jcache.invalidate(prompt)
        else:
            k = rng.randrange(1, 4)
            assert cache.evict(k) == jcache.evict(k)
        assert cache.stats() == jcache.stats()
        assert pool.shared_refs() == jpool.shared_refs()
        assert pool.owners() == jpool.owners()
        cache.check()
        jcache.check()
    for oid, shared, _ in readers:
        if shared:
            cache.release(shared)
        pool.release(oid)
    cache.clear()
    assert pool.in_use == 0 and pool.check()


def test_cached_prefix_streams_equal_jax():
    params = weights(seed=2)
    system = [(i * 7 + 3) % 31 for i in range(13)]
    prompts = [system + [i + 1, 2 * i + 3] for i in range(3)]
    jr = jserve.DecodeRunner(jax_decoder(params),
                             config=config(jserve, max_context=24,
                                           prefill_lengths=(8, 20)))
    js = jserve.DecodeScheduler(jr)
    try:
        want = [js.submit(p, max_new_tokens=6).result(60)["tokens"]
                for p in prompts]
    finally:
        js.stop()
    r = serve.DecodeRunner(decoder(params=params), ctx=mx.cpu(),
                           config=_config(prefix_cache=True))
    sched = serve.DecodeScheduler(r)
    try:
        got = [sched.submit(p, max_new_tokens=6).result(60)["tokens"]
               for p in prompts]
    finally:
        sched.stop()
    assert got == want
    st = r.cache.stats()
    assert st["misses"] == 1 and st["hits"] == 2
    assert st["hit_tokens_total"] == 24
    r.cache.clear()
    assert r.pool.available == r.pool.capacity and r.pool.check()


# ---------------------------------------------------------------------------
# test_serve_cache.py: trie mechanics on a raw pool
# ---------------------------------------------------------------------------

def test_trie_insert_match_acquire_release_exact_refcounts():
    pool = _pool()
    cache = PrefixCache(pool)
    prompt = list(range(9))              # 2 cacheable blocks + 1 tail
    assert cache.match(prompt) == ([], 0)
    own = pool.alloc("s1", 3)            # 2 prefix pages + 1 private
    assert cache.insert(prompt, "s1", list(own), 0) == 2
    assert cache.stats()["nodes"] == 2
    assert pool.owners()["s1"] == [own[2]]
    assert pool.shared_refs() == {own[0]: 2, own[1]: 2}
    cache.check()
    shared, hit, cls = cache.acquire(prompt)
    assert (shared, hit, cls) == ([own[0], own[1]], 8, "hit")
    assert pool.shared_refs() == {own[0]: 3, own[1]: 3}
    cache.release(shared)
    cache.release([own[0], own[1]])      # the inserting reader's refs
    assert pool.shared_refs() == {own[0]: 1, own[1]: 1}
    pool.release("s1")
    cache.check()
    assert cache.evict(2) == 2
    assert pool.shared_pages == 0 and pool.available == pool.capacity
    pool.check()


def test_trie_cow_fork_on_mid_prefix_divergence():
    pool = _pool()
    cache = PrefixCache(pool)
    a = [1, 2, 3, 4, 5, 6, 7, 8, 9]      # blocks (1..4), (5..8)
    b = [1, 2, 3, 4, 9, 9, 9, 9, 9]      # shares block 0, diverges
    pa = pool.alloc("a", 3)
    assert cache.insert(a, "a", list(pa), 0) == 2
    sh, hit, cls = cache.acquire(b)
    assert hit == 4 and cls == "partial" and sh == [pa[0]]
    pb = pool.alloc("b", 2)              # divergent block + tail
    assert cache.insert(b, "b", [sh[0]] + list(pb), hit) == 1
    assert cache.stats()["nodes"] == 3
    refs = pool.shared_refs()
    assert refs[pa[0]] == 3              # trie + a-reader + b-reader
    assert refs[pa[1]] == 2 and refs[pb[0]] == 2
    cache.check()
    assert pool.owners() == {"a": [pa[2]], "b": [pb[1]]}
    cache.release([pa[0], pa[1]])
    cache.release([sh[0], pb[0]])
    pool.release("a")
    pool.release("b")
    cache.clear()
    assert pool.available == pool.capacity
    pool.check()


def test_evict_lru_skips_pages_with_live_readers():
    pool = _pool()
    cache = PrefixCache(pool)
    ph = pool.alloc("h", 3)
    cache.insert([1] * 9, "h", list(ph), 0)
    pc = pool.alloc("c", 3)
    cache.insert([2] * 9, "c", list(pc), 0)
    cache.release([pc[0], pc[1]])        # cold's reader leaves
    pool.release("c")
    assert cache.evict(100) == 2         # hot keeps its live reader
    st = cache.stats()
    assert st["nodes"] == 2 and st["evictions"] == 2
    assert set(pool.shared_refs()) == {ph[0], ph[1]}
    cache.check()
    cache.release([ph[0], ph[1]])
    pool.release("h")
    cache.clear()
    pool.check()


def test_invalidate_drops_subtree_but_live_readers_keep_storage():
    pool = _pool()
    cache = PrefixCache(pool)
    prompt = list(range(9))
    pp = pool.alloc("s", 3)
    cache.insert(prompt, "s", list(pp), 0)
    assert cache.invalidate(prompt) == 2
    assert cache.stats()["nodes"] == 0
    assert cache.match(prompt) == ([], 0)
    assert pool.shared_refs() == {pp[0]: 1, pp[1]: 1}
    assert cache.release([pp[0], pp[1]]) == 2
    pool.release("s")
    assert pool.available == pool.capacity
    pool.check()


def test_shared_segment_double_free_raises():
    pool = _pool()
    cache = PrefixCache(pool)
    pp = pool.alloc("s", 2)
    cache.insert([7] * 5, "s", list(pp), 0)     # one block adopted
    cache.release([pp[0]])               # the inserting reader's ref
    assert cache.evict(1) == 1           # the trie's ref: page freed
    with pytest.raises(ServeError, match="double-free"):
        pool.shared_unref([pp[0]])
    pool.release("s")
    pool.check()


def test_prefix_digest_stability_and_block_sensitivity():
    assert prefix_digest([1, 2, 3]) == prefix_digest((1, 2, 3))
    assert prefix_digest([1, 2, 3]) != prefix_digest([1, 2, 4])
    assert len(prefix_digest(range(64))) == 12
    from mxnet_tpu.serve.cache import prefix_digest as jdigest

    assert prefix_digest(range(16)) == jdigest(range(16))


# ---------------------------------------------------------------------------
# cached-prefix decode: identical to cold, accounting end to end
# ---------------------------------------------------------------------------

def test_cached_prefix_decode_identical_to_cold():
    prompt = [(i * 7 + 3) % 31 for i in range(17)]   # 4 cacheable blocks
    ref = _run(_runner(), prompt)["tokens"]
    r = _runner(prefix_cache=True)
    sched = serve.DecodeScheduler(r)
    try:
        first = sched.submit(list(prompt), max_new_tokens=6).result(60)
        second = sched.submit(list(prompt), max_new_tokens=6).result(60)
    finally:
        sched.stop()
    assert first["tokens"] == ref        # cold populate: full prefill
    assert second["tokens"] == ref       # hit: suffix-only prefill
    st = r.cache.stats()
    assert st["misses"] == 1 and st["hits"] == 1
    assert st["inserted_pages"] == 4 and st["hit_tokens_total"] == 16
    # the hit prefilled only the suffix: 17 + 17 + 1
    assert telemetry.value("serve_decode_prefill_tokens_total") == 35
    prom = telemetry.prometheus()
    assert 'serve_decode_ttft_seconds_count{cache="miss"}' in prom
    assert 'serve_decode_ttft_seconds_count{cache="hit"}' in prom
    assert r.pool.owners() == {}
    assert r.pool.shared_pages == 4
    assert all(n == 1 for n in r.pool.shared_refs().values())
    assert sorted(r.provenance()) == ["chunk:t20", "chunk:t8", "decode:b1",
                                      "decode:b2", "prefill:t20",
                                      "prefill:t8"]
    r.cache.check()
    r.cache.clear()
    assert r.pool.available == r.pool.capacity
    r.pool.check()


def test_partial_hit_forks_cow_and_stays_correct():
    base = [(i * 5 + 1) % 29 for i in range(17)]
    fork = list(base[:8]) + [(i * 11 + 2) % 29 for i in range(9)]
    ref = _run(_runner(), fork)["tokens"]
    r = _runner(prefix_cache=True)
    sched = serve.DecodeScheduler(r)
    try:
        sched.submit(list(base), max_new_tokens=6).result(timeout=60)
        out = sched.submit(list(fork), max_new_tokens=6).result(timeout=60)
    finally:
        sched.stop()
    assert out["tokens"] == ref
    st = r.cache.stats()
    assert st["partials"] == 1           # 2 of 4 blocks matched
    assert st["nodes"] == 6              # 4 base + 2 divergent-tail
    r.cache.check()


def test_serve_cache_drill_invalidates_and_reprefills_cold():
    prompt = [(i * 3 + 2) % 31 for i in range(17)]
    r = _runner(prefix_cache=True)
    sched = serve.DecodeScheduler(r)
    try:
        warm = sched.submit(list(prompt), max_new_tokens=6).result(60)
        inject.plan("serve_cache@drill-1")
        out = sched.submit(list(prompt), max_new_tokens=6,
                           request_id="drill-1").result(timeout=60)
    finally:
        sched.stop()
    assert out["tokens"] == warm["tokens"]
    st = r.cache.stats()
    assert st["evictions"] >= 4 and st["misses"] == 2
    assert st["nodes"] == 4              # repopulated by the re-prefill
    assert telemetry.value("resilience_faults_injected_total",
                           labels={"site": "serve_cache"}) == 1
    r.cache.check()
    r.cache.clear()
    r.pool.check()


# ---------------------------------------------------------------------------
# speculative decoding: identical streams + containment
# ---------------------------------------------------------------------------

def test_speculative_decode_identical_to_single_step():
    prompt = [3, 1, 4, 1, 5]
    ref = _run(_runner(), prompt)["tokens"]
    spec = _runner(draft=decoder(seed=1))
    out = _run(spec, prompt)
    assert out["tokens"] == ref
    st = spec.spec.stats()
    assert st["enabled"] and st["verify_steps"] >= 1
    assert spec.spec.draft.pool.in_use == 0      # draft pages reclaimed
    assert spec.spec.draft.device == spec.device


def test_self_speculation_accepts_more_than_one_token_per_step():
    spec = _runner(draft=decoder(seed=0))
    prompt = [7, 2, 9]
    assert _run(spec, prompt)["tokens"] == _run(_runner(), prompt)["tokens"]
    st = spec.spec.stats()
    assert st["acceptance_rate"] == 1.0
    assert st["accepted_per_step"] > 1.0
    assert st["verify_steps"] < 6        # 6 tokens in < 6 target steps
    assert "verify:b2k4" in spec.provenance()


def test_spec_verify_drill_degrades_one_sequence_alone():
    inject.plan("spec_verify@bad-seq")
    vanilla = _runner()
    ref_bad = _run(vanilla, [5, 6, 7])["tokens"]
    ref_good = _run(vanilla, [8, 9, 10, 11])["tokens"]
    spec = _runner(draft=decoder(seed=0))
    sched = serve.DecodeScheduler(spec)
    try:
        fb = sched.submit([5, 6, 7], max_new_tokens=6, request_id="bad-seq")
        fg = sched.submit([8, 9, 10, 11], max_new_tokens=6,
                          request_id="good-seq")
        bad = fb.result(timeout=60)
        good = fg.result(timeout=60)
    finally:
        sched.stop()
    assert bad["tokens"] == ref_bad
    assert good["tokens"] == ref_good
    st = spec.spec.stats()
    assert st["fallbacks"].get("injected") == 1
    assert st["accepted"] > 0            # good-seq still speculated
    assert spec.spec.draft.pool.in_use == 0
    spec.pool.check()


def test_spec_stats_surface_in_runner_stats():
    spec = _runner(draft=decoder(seed=1))
    doc = spec.stats()
    assert doc["spec"]["enabled"] and doc["spec"]["k"] >= 1
    assert doc["cache"] == {"enabled": False}
    doc = _runner(prefix_cache=True).stats()
    assert doc["cache"]["enabled"] and doc["spec"] == {"enabled": False}
    assert serve.spec.resolve_k(None, 8) == 4
    assert serve.spec.resolve_k(99, 8) == 16
