"""``mx.io`` and ``context.cpu_pinned`` of the PyTorch port against the JAX
package, on the CPU.

Every iterator yields the same batches as the JAX package's (exactly):
``NDArrayIter`` in its three last-batch modes with and without shuffle
(the same ``np.random.seed``), ``ResizeIter``, ``PrefetchingIter``,
``CSVIter``, ``MNISTIter``, ``LibSVMIter`` (dense here, CSR there) and
``ImageRecordIter``.  ``ImageRecordIter`` runs the host library's loader
in both packages (``route == 'native'``); with one preprocessing thread
its random crops and mirrors are the same draws, and with several threads
and no augmentation the batches still come in epoch order.  Where the JAX
package drops to a Python route when its loader cannot start, the port
raises.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trec


def _batches(it, n=None):
    """Each batch's arrays, copied as they arrive: the JAX package's
    ``ImageRecordIter`` batches can alias the loader's reused buffer (XLA's
    CPU client aliases a page-aligned host array), so a batch it returned
    may change at the next ``next()``."""
    out = []
    for b in it:
        data = [d.tostype("default") if hasattr(d, "tostype")
                and d.stype != "default" else d for d in b.data]
        out.append(([np.array(d.asnumpy()) for d in data],
                    [np.array(l.asnumpy()) for l in (b.label or [])],
                    b.pad))
        if n is not None and len(out) == n:
            break
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _arrays(n=10):
    rs = np.random.RandomState(0)
    return rs.rand(n, 3, 2).astype(np.float32), \
        rs.randint(0, 4, n).astype(np.float32)


@pytest.mark.parametrize("mode", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_jax(mode, shuffle):
    x, y = _arrays()
    np.random.seed(2)
    jit = jio.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                          last_batch_handle=mode)
    want = _batches(jit)
    np.random.seed(2)
    tit = tio.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                          last_batch_handle=mode)
    with mt.cpu():
        got = _batches(tit)
        assert tit.provide_data == jit.provide_data
        assert [d.dtype for d in tit.provide_label] \
            == [d.dtype for d in jit.provide_label]
        tit.reset()
        jit.reset()
        assert len(_batches(tit)) == len(_batches(jit))
    _same(got, want)


def test_dict_inputs_resize_and_prefetching_match_jax():
    x, y = _arrays(9)
    kw = dict(batch_size=3)
    with mt.cpu():
        got = _batches(tio.ResizeIter(tio.NDArrayIter({"a": x, "b": x * 2},
                                                      y, **kw), 5))
        pre = _batches(tio.PrefetchingIter([tio.NDArrayIter(x, y, **kw),
                                            tio.NDArrayIter(x + 1, y, **kw)]))
    _same(got, _batches(jio.ResizeIter(jio.NDArrayIter(
        {"a": x, "b": x * 2}, y, **kw), 5)))
    _same(pre, _batches(jio.PrefetchingIter([jio.NDArrayIter(x, y, **kw),
                                             jio.NDArrayIter(x + 1, y,
                                                             **kw)])))


def test_csv_and_libsvm_iters_match_jax(tmp_path):
    x, y = _arrays(7)
    np.savetxt(tmp_path / "d.csv", x.reshape(7, -1), delimiter=",")
    np.savetxt(tmp_path / "l.csv", y, delimiter=",")
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(3, 2),
              label_csv=str(tmp_path / "l.csv"), batch_size=3)
    with mt.cpu():
        got = _batches(tio.CSVIter(**kw))
    _same(got, _batches(jio.CSVIter(**kw)))
    (tmp_path / "s.svm").write_text(
        "1 0:1.5 3:2.0\n0 2:-1.0\n1 1:0.5 4:4.0 0:3.0\n0\n1 3:1.0\n")
    kw = dict(data_libsvm=str(tmp_path / "s.svm"), data_shape=(5,),
              batch_size=2)
    with mt.cpu():
        got = _batches(tio.LibSVMIter(**kw))
    _same(got, _batches(jio.LibSVMIter(**kw)))


def test_mnist_iter_matches_jax():
    np.random.seed(4)
    want = _batches(jio.MNISTIter(batch_size=128, flat=True), 3)
    np.random.seed(4)
    with mt.cpu():
        got = _batches(tio.MNISTIter(batch_size=128, flat=True), 3)
    assert got[0][0][0].shape == (128, 784)
    _same(got, want)


def _image_pack(path, n=11, size=(30, 34)):
    rs = np.random.RandomState(1)
    w = trec.MXIndexedRecordIO(str(path) + ".idx", str(path) + ".rec", "w")
    for i in range(n):
        img = rs.randint(0, 255, size + (3,)).astype(np.uint8)
        label = float(i % 5) if i % 3 else [float(i), 1.0]
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, label, i, 0), img))
    w.close()
    return str(path) + ".rec"


@pytest.mark.parametrize("threads,aug", [(1, True), (3, False)],
                         ids=["one_thread_augmented", "three_threads"])
def test_image_record_iter_matches_jax(tmp_path, threads, aug):
    rec = _image_pack(tmp_path / "p")
    kw = dict(path_imgrec=rec, data_shape=(3, 24, 24), batch_size=4,
              shuffle=True, label_width=2, mean_r=120.0, mean_g=110.0,
              mean_b=100.0, scale=1 / 64.0, rand_crop=aug, rand_mirror=aug,
              preprocess_threads=threads, seed=3)
    jit = jio.ImageRecordIter(**kw)
    assert jit._native is not None
    tit = tio.ImageRecordIter(**kw)
    assert tit.route == "native"
    with mt.cpu():
        for _ in range(2):      # two epochs through reset
            got = _batches(tit)
            _same(got, _batches(jit))
            tit.reset()
            jit.reset()
    assert [p for *_, p in got] == [0, 0, 1]
    assert got[0][0][0].dtype == np.float32
    # the port's batches are its own: one held across the epoch stays put
    with mt.cpu():
        held = tit.next()
        kept = held.data[0].asnumpy().copy()
        for _ in tit:
            pass
    np.testing.assert_array_equal(held.data[0].asnumpy(), kept)


def test_image_record_iter_raises_where_jax_falls_back(tmp_path):
    empty = tmp_path / "empty.rec"
    empty.write_bytes(b"")
    jit = jio.ImageRecordIter(str(empty), (3, 8, 8), batch_size=2)
    assert jit._native is None          # the JAX package's Python route
    with pytest.raises(IOError, match="cannot open the image records"):
        tio.ImageRecordIter(str(empty), (3, 8, 8), batch_size=2)


def test_cpu_pinned_needs_the_card(monkeypatch):
    assert repr(mt.cpu_pinned()) == repr(mj.cpu_pinned()) == "cpu_pinned(0)"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(MXNetError, match="pin memory"):
        mt.nd.array(np.ones(3), ctx=mt.cpu_pinned())
    with pytest.raises(MXNetError, match="pin memory"):
        mt.nd.zeros((2,), ctx=mt.cpu_pinned())
    with pytest.raises(MXNetError, match="pin memory"):
        mt.nd.ones((2,), ctx=mt.cpu()).copyto(mt.cpu_pinned())


def test_fused_trainer_takes_the_iterators_ndarrays():
    """A batch of ``mx.io`` goes into ``FusedTrainer.step`` as it comes:
    the NDArrays' tensors, not a host round trip."""
    x, y = _arrays(8)
    losses = []
    for wrap in (lambda a: mt.nd.array(a, ctx=mt.cpu()), torch.from_numpy):
        net = mt.gluon.nn.Dense(4, in_units=6)
        net.initialize(ctx=mt.cpu())
        mt.convert.load_jax_params(net, {
            "weight": np.linspace(-1, 1, 24, dtype=np.float32).reshape(4, 6),
            "bias": np.zeros(4, np.float32)})
        tr = mt.parallel.FusedTrainer(net, loss="softmax_ce",
                                      optimizer="sgd")
        losses.append([float(tr.step(wrap(x.reshape(8, 6)), wrap(y)))
                       for _ in range(2)])
    assert losses[0] == losses[1]
