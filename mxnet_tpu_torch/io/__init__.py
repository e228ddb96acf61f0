"""The DataIter API: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter``, ``CSVIter``,
``MNISTIter``, ``LibSVMIter`` and ``ImageRecordIter``.

Counterpart of ``mxnet_tpu/io/__init__.py``.  Batches land on the current
context when they are made (the card unless a ``with mx.cpu():`` scope is
open), as the JAX package's land on its default device; the arrays an
``NDArrayIter`` iterates stay on the host.

``ImageRecordIter`` runs the host library's threaded loader
(``native.ImageRecordLoader``: record reads, decode, crop, mirror and
normalize on ``preprocess_threads`` host threads); its ``route`` is
``'native'``.  Where the JAX package drops to a Python ``DataLoader`` route
without a word when its loader cannot start (a route that ignores
``rand_crop``, ``rand_mirror`` and ``label_width``), the port raises.  On
the card the loader writes each batch into one of two page-locked slots of
a ``data.ring.Placer``, which copies it on a side stream; the caller's
stream waits for the copy, and a slot is refilled only after the event of
its last copy has passed.

``LibSVMIter`` yields CSR batches (``nd.sparse.CSRNDArray``) on the
current context, as the JAX package's do.
"""
from __future__ import annotations

import threading
from collections import namedtuple

import numpy as _np
import torch

from .. import ndarray as nd
from ..base import MXNetError
from ..context import cpu, current_context
from ..ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "ImageRecordIter",
           "LibSVMIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self.idx = _np.arange(self.num_data)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype) for k, v in self.label]

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self.idx)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "roll_over":
            return self.cursor + self.batch_size <= self.num_data
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrays):
        end = self.cursor + self.batch_size
        sel = self.idx[self.cursor:min(end, self.num_data)]
        if end > self.num_data and self.last_batch_handle == "pad":
            pad = end - self.num_data
            sel = _np.concatenate([sel, self.idx[:pad]])
        return [nd.array(_np.asarray(v.asnumpy() if isinstance(v, NDArray)
                                     else v)[sel]) for _, v in arrays]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        end = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and end > self.num_data:
            return end - self.num_data
        return 0


def _init_data(data, allow_empty, default_name):
    if data is None:
        if not allow_empty:
            raise MXNetError("data is required")
        return []
    if isinstance(data, (NDArray, _np.ndarray)):
        data = [(default_name, data)]
    elif isinstance(data, dict):
        data = sorted(data.items())
    elif isinstance(data, (list, tuple)):
        data = [("%s_%d" % (default_name, i), d)
                for i, d in enumerate(data)]
    out = []
    for k, v in data:
        if isinstance(v, _np.ndarray):   # held on the host
            v = nd.array(v.astype(_np.float32) if v.dtype == _np.float64
                         else v, ctx=cpu())
        out.append((k, v))
    return out


class ResizeIter(DataIter):
    """Resize an iterator's epoch length."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Iterate several iterators together, their batches concatenated."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        iters = iters if isinstance(iters, list) else [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self._queue = []
        self._lock = threading.Lock()
        self.current_batch = None

    def reset(self):
        for it in self.iters:
            it.reset()

    def iter_next(self):
        try:
            batches = [it.next() for it in self.iters]
        except StopIteration:
            return False
        b = batches[0]
        if len(batches) > 1:
            data = sum((bb.data for bb in batches), [])
            label = sum((bb.label for bb in batches), [])
            b = DataBatch(data, label, pad=b.pad)
        self.current_batch = b
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad


class CSVIter(NDArrayIter):
    """CSV reader."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, **kwargs):
        data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=_np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        super().__init__(data, label, batch_size=batch_size, **kwargs)


class MNISTIter(NDArrayIter):
    """MNIST iterator over ``vision.MNIST`` (the idx-ubyte files when
    present, else the synthetic set)."""

    def __init__(self, image=None, label=None, batch_size=128, shuffle=True,
                 flat=False, **kwargs):
        from ..gluon.data.vision import MNIST

        train = image is None or "train" in str(image)
        ds = MNIST(train=train)
        data = ds._data.asnumpy().astype(_np.float32) / 255.0
        data = data.transpose(0, 3, 1, 2)
        if flat:
            data = data.reshape(len(data), -1)
        super().__init__(data, ds._label.astype(_np.float32),
                         batch_size=batch_size, shuffle=shuffle)


class LibSVMIter(DataIter):
    """LibSVM-format iterator yielding CSR batches: ``batch.data[0]`` is
    an ``nd.sparse.CSRNDArray`` of (batch_size, num_features), a short
    last batch padded with empty rows (``pad``)."""

    def __init__(self, data_libsvm, data_shape, batch_size=1,
                 label_libsvm=None, round_batch=True, **kwargs):
        super().__init__(batch_size)
        self._num_features = int(data_shape[0] if isinstance(
            data_shape, (tuple, list)) else data_shape)
        self._rows = []   # (label, {col: val})
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                label = float(parts[0])
                feats = {}
                for tok in parts[1:]:
                    c, v = tok.split(":")
                    feats[int(c)] = float(v)
                self._rows.append((label, feats))
        self._cursor = 0

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._num_features))]

    def reset(self):
        self._cursor = 0

    def next(self):
        if self._cursor >= len(self._rows):
            raise StopIteration
        from ..ndarray import sparse as sp

        rows = self._rows[self._cursor:self._cursor + self.batch_size]
        pad = self.batch_size - len(rows)
        self._cursor += self.batch_size
        data, indices, indptr, labels = [], [], [0], []
        for label, feats in rows:
            for c in sorted(feats):
                indices.append(c)
                data.append(feats[c])
            indptr.append(len(indices))
            labels.append(label)
        for _ in range(pad):
            indptr.append(len(indices))
            labels.append(0.0)
        csr = sp.csr_matrix(
            (_np.asarray(data, _np.float32),
             _np.asarray(indices, _np.int64),
             _np.asarray(indptr, _np.int64)),
            shape=(self.batch_size, self._num_features))
        return DataBatch([csr], [nd.array(_np.asarray(labels, _np.float32))],
                         pad=pad)


class ImageRecordIter(DataIter):
    """The RecordIO image pipeline on the host library's threaded loader
    (see the module docstring); ``route`` is ``'native'``."""

    def __init__(self, path_imgrec, data_shape, batch_size=1, shuffle=False,
                 label_width=1, mean_r=0, mean_g=0, mean_b=0, scale=1.0,
                 rand_crop=False, rand_mirror=False, preprocess_threads=4,
                 seed=0, **kwargs):
        from .. import native
        from ..data import require_sharded

        # this iterator reads the whole pack on every host; in a world of
        # several the sharded streaming path is mx.data.StreamLoader
        require_sharded("io.ImageRecordIter over %r" % (path_imgrec,))
        super().__init__(batch_size)
        self._shape = tuple(data_shape)
        self._native = native.ImageRecordLoader(
            path_imgrec, batch_size=batch_size, data_shape=self._shape,
            label_width=label_width, num_workers=preprocess_threads,
            shuffle=shuffle, seed=seed, rand_mirror=rand_mirror,
            rand_crop=rand_crop, mean=(mean_r, mean_g, mean_b), scale=scale)
        self.route = "native"
        self._placer = None

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self._shape)]

    def reset(self):
        self._native.reset()

    def next(self):
        ctx = current_context()
        if ctx.device_type == "gpu":
            if self._placer is None:
                from ..data.ring import Placer

                self._placer = Placer(ctx.torch_device, slots=2)
            specs = [((self.batch_size,) + self._shape, torch.float32),
                     ((self.batch_size, self._native.label_width),
                      torch.float32)]
            out = self._placer.stage(specs, lambda bufs: self._native.next(
                bufs[0].numpy(), bufs[1].numpy()))
            if out is None:
                raise StopIteration
            staged, (_, _, n) = out
            staged.wait()
            data, label = staged
        else:
            out = self._native.next()
            if out is None:
                raise StopIteration
            data, label, n = out
            data, label = nd.array(data, ctx=ctx), nd.array(label, ctx=ctx)
        if label.shape[1] == 1:
            label = label.reshape((-1,))
        return DataBatch([data], [label], pad=self.batch_size - n)
