"""``gluon.data`` of the PyTorch port against the JAX package, on the CPU:
datasets, samplers, batchify functions, ``DataLoader`` on its three routes
and the vision datasets.

Under the same ``np.random.seed`` both packages must yield the same
batches in the same order (exactly): at ``num_workers=0``, with the thread
pool, and with 2 worker processes (over shared memory; the JAX side runs
inline, which gives the same batches by construction).  Batches land on
the current context (the CPU inside ``with mt.cpu():``); without that
scope they want the card, which this host lacks.
"""
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jT
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as tT


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _arrays(n=23, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 4, 3).astype(np.float32),
            rs.randint(0, 5, n).astype(np.int32))


def test_datasets_match_jax():
    x, y = _arrays()
    dj, dt = jdata.ArrayDataset(x, y), tdata.ArrayDataset(x, y)
    assert len(dt) == len(dj) == 23
    _same(dt[3], dj[3])
    for fn in (lambda d: d.transform(lambda s: (s[0] * 2, s[1] + 1)),
               lambda d: d.transform_first(lambda a: a.sum()),
               lambda d: d.filter(lambda s: s[1] > 2),
               lambda d: d.shard(4, 1), lambda d: d.shard(4, 3),
               lambda d: d.take(5),
               lambda d: d.sample([4, 0, 9])):
        tj, tt = fn(dj), fn(dt)
        assert len(tt) == len(tj)
        for i in range(len(tt)):
            _same(tt[i], tj[i])
    s = tdata.SimpleDataset(list(range(7)))
    assert [s[i] for i in range(len(s))] == list(range(7))


@pytest.mark.parametrize("make", [
    lambda d: d.SequentialSampler(7, start=2),
    lambda d: d.RandomSampler(11),
    lambda d: d.FilterSampler(lambda v: v % 3 == 0, list(range(10))),
    lambda d: d.IntervalSampler(10, 3),
    lambda d: d.IntervalSampler(10, 3, rollover=False),
    lambda d: d.BatchSampler(d.SequentialSampler(10), 3, "keep"),
    lambda d: d.BatchSampler(d.RandomSampler(10), 3, "discard"),
], ids=["sequential", "random", "filter", "interval", "interval_once",
        "batch_keep", "batch_discard"])
def test_samplers_match_jax(make):
    np.random.seed(3)
    want = list(make(jdata))
    np.random.seed(3)
    sampler = make(tdata)
    assert list(sampler) == want and len(sampler) == len(make(jdata))


def test_rollover_batch_sampler_matches_jax():
    bj = jdata.BatchSampler(jdata.SequentialSampler(10), 4, "rollover")
    bt = tdata.BatchSampler(tdata.SequentialSampler(10), 4, "rollover")
    for _ in range(3):
        assert list(bt) == list(bj) and len(bt) == len(bj)


def test_batchify_matches_jax():
    rs = np.random.RandomState(1)
    seqs = [rs.rand(n, 2).astype(np.float32) for n in (3, 5, 2)]
    labels = [1, 0, 2]
    with mt.cpu():
        _same(tdata.batchify.Pad(axis=0, val=-1)(seqs),
              jdata.batchify.Pad(axis=0, val=-1)(seqs))
        _same(tdata.batchify.Stack()([s[:2] for s in seqs]),
              jdata.batchify.Stack()([s[:2] for s in seqs]))
        grp = [(s, l) for s, l in zip(seqs, labels)]
        _same(tdata.batchify.Group(tdata.batchify.Pad(),
                                   tdata.batchify.Stack())(grp),
              jdata.batchify.Group(jdata.batchify.Pad(),
                                   jdata.batchify.Stack())(grp))


def _mnist_loader(pkg, T, root, **kw):
    ds = pkg.vision.MNIST(root=root, train=False).transform_first(
        T.ToTensor())
    return pkg.DataLoader(ds, batch_size=100, shuffle=True,
                          last_batch="keep", **kw)


@pytest.mark.parametrize("route", ["inline", "threads"])
def test_dataloader_matches_jax(tmp_path, route):
    kw = {} if route == "inline" else {"num_workers": 2,
                                       "thread_pool": True}
    root = str(tmp_path / "mnist")
    np.random.seed(5)
    want = [(x.asnumpy(), y.asnumpy())
            for x, y in _mnist_loader(jdata, jT, root, **kw)]
    np.random.seed(5)
    loader = _mnist_loader(tdata, tT, root, **kw)
    with mt.cpu():
        got = list(loader)
    assert loader.route == route
    assert len(got) == len(want) == 11
    for (xt, yt), (xj, yj) in zip(got, want):
        assert xt.context == mt.cpu() and xt.shape[1:] == (1, 28, 28)
        _same(xt, xj)
        _same(yt, yj)


class _Squares(tdata.Dataset):
    """A picklable dataset for the worker processes."""

    def __init__(self, n):
        self._n = n

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        rs = np.random.RandomState(i)
        return rs.rand(3, 2).astype(np.float32) * i, np.int32(i * i)


def test_process_workers_match_jax_over_shared_memory():
    x = np.stack([_Squares(40)[i][0] for i in range(40)])
    y = np.array([_Squares(40)[i][1] for i in range(40)], np.int32)
    np.random.seed(8)
    want = [(a.asnumpy(), b.asnumpy()) for a, b in jdata.DataLoader(
        jdata.ArrayDataset(x, y), batch_size=6, shuffle=True)]
    np.random.seed(8)
    loader = tdata.DataLoader(_Squares(40), batch_size=6, shuffle=True,
                              num_workers=2, timeout=60)
    with mt.cpu():
        got = list(loader)
    assert loader.route == "processes"
    assert len(got) == len(want) == 7
    for (xt, yt), (xj, yj) in zip(got, want):
        assert xt.context == mt.cpu()
        _same(xt, xj)
        _same(yt, yj)


def test_unpicklable_dataset_takes_the_thread_route_and_says_so():
    ds = tdata.ArrayDataset(*_arrays()).transform(lambda s: s)
    with pytest.raises(Exception):
        pickle.dumps(ds)
    loader = tdata.DataLoader(ds, batch_size=5, num_workers=2)
    with warnings.catch_warnings(record=True) as caught, mt.cpu():
        warnings.simplefilter("always")
        n = sum(1 for _ in loader)
    assert n == 5 and loader.route == "threads"
    assert any("thread" in str(w.message) for w in caught)


def test_batches_want_the_card_without_a_cpu_scope(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    loader = tdata.DataLoader(tdata.ArrayDataset(*_arrays()), batch_size=4)
    with pytest.raises(MXNetError, match=r"ctx=mx\.cpu\(\)"):
        next(iter(loader))


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "CIFAR10",
                                  "CIFAR100"])
def test_synthetic_vision_sets_match_jax(tmp_path, name):
    root = str(tmp_path / name)
    dj = getattr(jdata.vision, name)(root=root, train=False)
    dt = getattr(tdata.vision, name)(root=root, train=False)
    assert len(dt) == len(dj) == 1024
    assert dt._data.context == mt.cpu()
    _same(dt._data, dj._data)
    np.testing.assert_array_equal(dt._label, dj._label)
    _same(dt[17], dj[17])


def test_image_datasets_match_jax(tmp_path):
    from mxnet_tpu_torch import recordio

    rs = np.random.RandomState(2)
    imgs = [rs.randint(0, 255, (10 + i, 12, 3)).astype(np.uint8)
            for i in range(5)]
    w = recordio.MXIndexedRecordIO(str(tmp_path / "d.idx"),
                                   str(tmp_path / "d.rec"), "w")
    for i, img in enumerate(imgs):
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(i), i, 0),
                                         img, img_fmt=".npy"))
    w.close()
    rec = str(tmp_path / "d.rec")
    dj, dt = jdata.vision.ImageRecordDataset(rec), \
        tdata.vision.ImageRecordDataset(rec)
    raw = tdata.RecordFileDataset(rec)
    assert len(dt) == len(dj) == len(raw) == 5
    for i in range(5):
        _same(dt[i][0], dj[i][0])
        assert dt[i][1] == dj[i][1] and dt[i][0].context == mt.cpu()
        assert recordio.unpack(raw[i])[0].id == i
    for c, name in enumerate(("cat", "dog")):
        os.makedirs(tmp_path / "folder" / name)
        for i in range(2):
            np.save(tmp_path / "folder" / name / ("%d.npy" % i), imgs[c + i])
    fj = jdata.vision.ImageFolderDataset(str(tmp_path / "folder"))
    ft = tdata.vision.ImageFolderDataset(str(tmp_path / "folder"))
    assert ft.synsets == fj.synsets == ["cat", "dog"]
    assert ft.items == fj.items
    for i in range(len(ft)):
        _same(ft[i][0], fj[i][0])
    lst = tmp_path / "list.lst"
    lst.write_text("".join("%d\t%d\t1.5\tfolder/%s/%d.npy\n"
                           % (i, i % 2, ("cat", "dog")[i // 2], i % 2)
                           for i in range(4)))
    lj = jdata.vision.ImageListDataset(str(tmp_path), "list.lst")
    lt = tdata.vision.ImageListDataset(str(tmp_path), "list.lst")
    assert len(lt) == len(lj) == 4
    for i in range(4):
        _same(list(lt[i]), list(lj[i]))
