"""``mx.data`` (the streaming input pipeline) of the PyTorch port against
the JAX package, on the CPU.

The epoch order and the shard striping are pure numpy
(``default_rng(SeedSequence((seed, epoch)))``) in both packages, so they
must be identical; a ``StreamLoader`` epoch over four shards yields the
same batches and sample ids as the JAX package's, sees every record of
its slice once, and resumes from ``state_dict()`` exactly.  The world is
one host unless the launcher's environment or an initialized
``torch.distributed`` says otherwise.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu import data as jdata
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import data as tdata
from mxnet_tpu_torch import recordio as trec

SHARDS, PER_SHARD, B = 4, 9, 4


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    rs = np.random.RandomState(0)
    paths = []
    for s in range(SHARDS):
        idx, rec = str(root / ("s%d.idx" % s)), str(root / ("s%d.rec" % s))
        w = trec.MXIndexedRecordIO(idx, rec, "w")
        for i in range(PER_SHARD - (s == 3)):
            img = rs.randint(0, 255, (5, 4, 3)).astype(np.uint8)
            w.write_idx(i, trec.pack_img(
                trec.IRHeader(0, float(s * 100 + i), i, 0), img,
                img_fmt=".npy"))
        w.close()
        paths.append(rec)
    return paths


def test_shard_set_math_matches_jax(shards):
    js, ts = jdata.ShardSet(shards), tdata.ShardSet(shards)
    assert ts.total_records == js.total_records == SHARDS * PER_SHARD - 1
    assert ts.describe()["per_shard"] == js.describe()["per_shard"]
    for hosts in (1, 2, 3, 4, 5, 8):
        for host in range(hosts):
            assert ts.assignment(hosts, host) == js.assignment(hosts, host)
            assert ts.host_record_count(hosts, host) \
                == js.host_record_count(hosts, host)
        assert ts.batches_per_epoch(hosts, 2) == js.batches_per_epoch(hosts, 2)
    entries, _ = ts.assignment(1, 0)
    for seed in (0, 7):
        for epoch in (0, 1, 5):
            assert list(map(int, ts.epoch_order(entries, seed, epoch))) \
                == list(map(int, js.epoch_order(entries, seed, epoch)))
    assert ts.epoch_order(entries, 0, 0, shuffle=False) \
        == list(range(len(entries)))
    one = tdata.ShardSet.from_pattern(
        os.path.join(os.path.dirname(shards[0]), "s*.rec"))
    assert len(one) == SHARDS


def _epoch(mod, shards, ctx=None, **kw):
    import contextlib

    loader = mod.StreamLoader(shards, B, seed=3, num_workers=2, prefetch=2,
                              **kw)
    out = []
    with ctx if ctx is not None else contextlib.nullcontext():
        for batch in loader:
            out.append(([a.asnumpy() for a in batch],
                        loader.last_ids.copy()))
    return loader, out


@pytest.mark.parametrize("hosts,host", [(1, 0), (2, 1), (4, 3)])
def test_stream_loader_epoch_matches_jax(shards, hosts, host):
    jl, want = _epoch(jdata, shards, num_hosts=hosts, host=host)
    tl, got = _epoch(tdata, shards, mt.cpu(), num_hosts=hosts, host=host)
    assert tl.assignment_mode == jl.assignment_mode
    assert len(got) == len(want) == tl.batches_per_epoch
    for (ga, gi), (wa, wi) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        for g, w in zip(ga, wa):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    ids = np.concatenate([i for _, i in got])
    assert len(set(ids.tolist())) == len(ids)     # each record once
    if hosts == 1:
        assert len(ids) == (SHARDS * PER_SHARD - 1) // B * B
    assert tl.epoch == jl.epoch == 1
    tl.close()
    jl.close()


def test_resume_from_a_cursor_is_exact(shards):
    _, full = _epoch(tdata, shards, mt.cpu())
    first = tdata.StreamLoader(shards, B, seed=3)
    with mt.cpu():
        it = iter(first)
        next(it)
        next(it)
        it.close()
        cursor = first.state_dict()
        assert cursor["batch"] == 2 and cursor["epoch"] == 0
        second = tdata.StreamLoader(shards, B, seed=3)
        second.load_state_dict(cursor)
        rest = [(b[1].asnumpy(), second.last_ids.copy()) for b in second]
    assert len(rest) == len(full) - 2
    for (lab, ids), (arrs, want_ids) in zip(rest, full[2:]):
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(lab, arrs[1])
    with pytest.raises(MXNetError, match="seed"):
        tdata.StreamLoader(shards, B, seed=4).load_state_dict(cursor)


def test_world_coords_and_the_sharding_guard(monkeypatch, tmp_path):
    assert tdata.world_coords() == jdata.world_coords() == (1, 0)
    assert tdata.world_coords(3, 2) == (3, 2)
    monkeypatch.setenv("MXNET_DIST_NUM_WORKERS", "2")
    monkeypatch.setenv("MXNET_DIST_RANK", "1")
    assert tdata.world_coords() == (2, 1)
    monkeypatch.delenv("MXNET_DIST_NUM_WORKERS")
    monkeypatch.delenv("MXNET_DIST_RANK")
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    assert tdata.world_coords() == (4, 2)
    with pytest.raises(MXNetError, match="4-host"):
        mt.io.ImageRecordIter(str(tmp_path / "x.rec"), (3, 8, 8))
    with pytest.raises(MXNetError, match="outside world"):
        tdata.world_coords(2, 5)


def test_mesh_is_not_ported(shards):
    with pytest.raises(MXNetError, match="not ported"):
        tdata.StreamLoader(shards, B, mesh=object())
    with pytest.raises(MXNetError, match="not ported"):
        tdata.make_placer(mesh=object())


def test_prefetch_ring_orders_counts_and_surfaces_errors():
    items = [(i, (np.full((2,), i, np.float32),), None) for i in range(5)]
    src = iter(items + [None])
    ring = tdata.PrefetchRing(lambda: next(src),
                              tdata.make_placer(ctx=mt.cpu()), depth=2)
    got = []
    while True:
        item = ring.next(timeout=10)
        if item is None:
            break
        idx, staged, _ = item
        assert isinstance(staged, tdata.StagedBatch)
        assert staged[0].context == mt.cpu()
        got.append((idx, float(staged[0].asnumpy()[0])))
    assert got == [(i, float(i)) for i in range(5)] and ring.staged == 5
    ring.stop()

    def broken():
        raise OSError("disk gone")

    bad = tdata.PrefetchRing(broken, tdata.make_placer(ctx=mt.cpu()))
    with pytest.raises(OSError, match="disk gone"):
        bad.next(timeout=10)
    bad.stop()


def test_placer_wants_the_card_without_a_cpu_scope(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(MXNetError, match=r"ctx=mx\.cpu\(\)"):
        tdata.make_placer()
