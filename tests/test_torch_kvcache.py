"""The paged KV cache of the PyTorch port against the JAX package, on the
CPU.

1. ``gather_pages`` and ``scatter_pages`` on the same numpy pool, tables,
   positions and rows give the JAX functions' values bit for bit, with
   table entries past the pool clamped and invalid rows (padding, the null
   page) dropped: the port sends them to the storage's drop page, which
   the compared pages never include.
2. ``PagePool``: the same sequence of operations (alloc, release, shared
   adoption, references, OOM rejects, double frees) on both packages gives
   the same page ids, errors, accounting and ``stats()``.
3. ``tests/python/unittest/test_serve_decode.py``'s pool cases, ported:
   exact accounting, the all-or-nothing OOM reject, double-free and
   unknown-owner raises, ``PageConfig`` limits; and the port's own: the
   pool's tensors and drop page, ``mesh=`` refused.
"""
import random

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.serve import kvcache as jkv
from mxnet_tpu_torch import serve
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import kvcache as tkv

L, N, PAGE, H, D = 2, 6, 4, 2, 3


def _case(seed, B=3, T=5, P=3):
    rs = np.random.RandomState(seed)
    pool = rs.randn(L, N, PAGE, H, D).astype(np.float32)
    # null pages (N) and entries past it (clamped by the gather)
    tables = rs.randint(0, N + 3, (B, P)).astype(np.int32)
    tables[0, -1] = N
    positions = rs.randint(0, P * PAGE + 3, (B, T)).astype(np.int32)
    valid = rs.rand(B, T) < 0.6
    valid[-1] = False                         # a padded batch row
    tables[0, 0], positions[0, 0], valid[0, 0] = 1, 1, True   # one lands
    new = rs.randn(B, T, L, H, D).astype(np.float32)
    return pool, tables, positions, valid, new


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_pages_matches_jax_bitwise(seed):
    import jax.numpy as jnp

    pool, tables, _, _, _ = _case(seed)
    want = np.asarray(jkv.gather_pages(jnp.asarray(pool),
                                       jnp.asarray(tables)))
    got = tkv.gather_pages(torch.from_numpy(pool),
                           torch.from_numpy(tables)).numpy()
    assert got.shape == want.shape == (3, L, 3 * PAGE, H, D)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_pages_matches_jax_bitwise(seed):
    import jax.numpy as jnp

    pool, tables, positions, valid, new = _case(seed)
    # distinct (page, slot) addresses for the valid rows that land: a
    # duplicate address has no defined winner in either package
    seen = set()
    for b, t in np.ndindex(valid.shape):
        lg = min(positions[b, t] // PAGE, tables.shape[1] - 1)
        addr = (tables[b, lg], positions[b, t] % PAGE)
        if valid[b, t] and tables[b, lg] < N:
            valid[b, t] = addr not in seen
            seen.add(addr)
    want = np.asarray(jkv.scatter_pages(
        jnp.asarray(pool), jnp.asarray(tables), jnp.asarray(positions),
        jnp.asarray(valid), jnp.asarray(new)))
    store = torch.from_numpy(np.concatenate(
        [pool, np.zeros((L, 1, PAGE, H, D), np.float32)], axis=1))
    out = tkv.scatter_pages(store, torch.from_numpy(tables),
                            torch.from_numpy(positions),
                            torch.from_numpy(valid), torch.from_numpy(new))
    assert out is store
    np.testing.assert_array_equal(store[:, :N].numpy(), want)
    assert not np.array_equal(want, pool)     # something was written


def _ops(pool, jpool, rng, steps=120):
    """Drive both pools with one random operation sequence; every result
    and raise must agree."""
    owners = []
    for i in range(steps):
        op = rng.random()
        if op < 0.45:
            o, n = "s%d" % i, rng.randrange(1, 4)
            res = []
            for p in (pool, jpool):
                try:
                    res.append(p.alloc(o, n))
                except serve.ServeError as exc:
                    res.append(type(exc).__name__)
                except Exception as exc:  # the JAX package's errors
                    res.append(type(exc).__name__)
            assert res[0] == res[1], (i, res)
            if isinstance(res[0], list):
                owners.append((o, res[0]))
        elif op < 0.65 and owners:
            o, pages = owners.pop(rng.randrange(len(owners)))
            k = rng.randrange(0, len(pages))
            if k:
                adopt = pages[:k]
                for p in (pool, jpool):
                    p.adopt_shared(o, adopt, readers=1)
                    p.shared_ref(adopt)
                assert pool.shared_refs() == jpool.shared_refs()
                for p in (pool, jpool):
                    p.shared_unref(adopt)
                    p.shared_unref(adopt)
            assert pool.release(o) == jpool.release(o)
        elif op < 0.75:
            bad = "nobody-%d" % i
            for p in (pool, jpool):
                with pytest.raises(Exception, match="unknown page owner"):
                    p.release(bad)
        assert pool.owners() == jpool.owners()
        assert (pool.in_use, pool.available, pool.high_water,
                pool.oom_rejects) == (jpool.in_use, jpool.available,
                                      jpool.high_water, jpool.oom_rejects)
        assert pool.check() and jpool.check()
    return owners


def test_page_pool_accounting_matches_jax_operation_for_operation():
    cfg = (PAGE, 12, L, H, D, 16)
    pool = tkv.PagePool(tkv.PageConfig(*cfg), device=mx.cpu())
    jpool = jkv.PagePool(jkv.PageConfig(*cfg))
    owners = _ops(pool, jpool, random.Random(3))
    want = jpool.stats()
    got = pool.stats()
    assert got == want
    for o, _ in owners:
        assert pool.release(o) == jpool.release(o)
    pool.reset()
    jpool.reset()
    assert pool.stats() == jpool.stats()
    assert pool.available == pool.capacity == 12


def test_shared_segment_guards_match_jax():
    cfg = (PAGE, 8, L, H, D, 16)
    for kv in (tkv, jkv):
        kw = {"device": mx.cpu()} if kv is tkv else {}
        pool = kv.PagePool(kv.PageConfig(*cfg), **kw)
        pages = pool.alloc("a", 3)
        with pytest.raises(Exception, match="not owned"):
            pool.adopt_shared("a", [7 if 7 not in pages else 6])
        pool.adopt_shared("a", pages[:2], readers=0)
        with pytest.raises(Exception, match="not owned"):
            pool.adopt_shared("a", pages[:1])   # adoption moved it
        with pytest.raises(Exception, match="non-shared"):
            pool.shared_ref([pages[2]])
        assert pool.shared_unref(pages[:2]) == 2
        with pytest.raises(Exception, match="double-free"):
            pool.shared_unref(pages[:1])
        pool.release("a")
        assert pool.check() and pool.available == 8


# -- test_serve_decode.py's pool cases -------------------------------------

def _pool(pages=8, page_size=4, max_context=16):
    return serve.PagePool(serve.PageConfig(page_size, pages, 2, 2, 4,
                                           max_context), device=mx.cpu())


def test_page_pool_exact_accounting():
    pool = _pool()
    assert pool.capacity == 8 and pool.available == 8 and pool.in_use == 0
    a = pool.alloc("a", 3)
    b = pool.alloc("b", 2)
    assert len(a) == 3 and len(b) == 2
    assert not set(a) & set(b), "pages double-assigned"
    assert pool.in_use == 5 and pool.available == 3
    assert pool.high_water == 5
    assert pool.release("a") == 3
    assert pool.in_use == 2 and pool.available == 6
    assert pool.high_water == 5            # high water sticks
    pool.check()
    pool.release("b")
    assert pool.in_use == 0
    pool.check()


def test_page_pool_oom_fast_reject_is_all_or_nothing():
    pool = _pool(pages=4)
    pool.alloc("a", 3)
    with pytest.raises(serve.PagePoolExhausted):
        pool.alloc("b", 2)                 # only 1 free
    assert pool.in_use == 3 and pool.available == 1
    assert pool.oom_rejects == 1
    assert "b" not in pool.owners()        # nothing partially reserved
    pool.check()


def test_page_pool_double_free_and_unknown_owner_raise():
    pool = _pool()
    pool.alloc("a", 2)
    pool.release("a")
    with pytest.raises(serve.ServeError):
        pool.release("a")
    with pytest.raises(serve.ServeError):
        pool.release("never-allocated")
    with pytest.raises(serve.ServeError):
        pool.alloc("b", 2) and pool.alloc("b", 1)   # duplicate owner


def test_page_config_limits():
    cfg = serve.PageConfig(4, 8, 2, 2, 4, 16)
    assert cfg.pages_per_seq == 4
    assert cfg.pages_for(1) == 1 and cfg.pages_for(4) == 1
    assert cfg.pages_for(5) == 2 and cfg.pages_for(16) == 4
    with pytest.raises(ValueError):
        serve.PageConfig(4, 2, 2, 2, 4, 16)      # max_context > pool
    jcfg = jkv.PageConfig(4, 8, 2, 2, 4, 16)
    assert cfg.as_dict() == jcfg.as_dict()
    assert cfg.page_bytes == jcfg.page_bytes


def test_pool_tensors_carry_a_drop_page_no_owner_holds():
    pool = _pool(pages=5)
    assert tuple(pool.k.shape) == (2, 5, 4, 2, 4)
    assert tuple(pool.k_store.shape) == (2, 6, 4, 2, 4)
    assert pool.k.data_ptr() == pool.k_store.data_ptr()   # a view
    assert pool.null_page == 5 and pool.k.device.type == "cpu"
    got = sorted(pool.alloc("a", 5))
    assert got == [0, 1, 2, 3, 4]          # never the drop page
    with pytest.raises(MXNetError, match="item 7"):
        serve.PagePool(serve.PageConfig(4, 5, 2, 2, 4, 16), mesh=object())
