"""Datasets: ``Dataset`` (with ``transform``, ``transform_first``,
``filter``, ``shard``, ``take``, ``sample``), ``SimpleDataset``,
``ArrayDataset`` and ``RecordFileDataset``.

Counterpart of ``mxnet_tpu/gluon/data/dataset.py``, a copy;
``RecordFileDataset`` (the raw records of a RecordIO pack, by index) is
upstream MXNet's, which the JAX package leaves out.
"""
from __future__ import annotations

import os

from ...base import MXNetError

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def shard(self, num_shards, index):
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return SimpleDataset([self[i] for i in range(start, end)])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def sample(self, sampler):
        return _SampledDataset(self, sampler)

    def transform(self, fn, lazy=True):
        return _LazyTransformDataset(self, fn)

    def transform_first(self, fn, lazy=True):
        def first(*item):
            if len(item) == 1:
                return fn(item[0])
            return (fn(item[0]),) + item[1:]

        return _LazyTransformDataset(self, first, unpack=True)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn, unpack=False):
        self._data = data
        self._fn = fn
        self._unpack = unpack

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if self._unpack and isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _SampledDataset(Dataset):
    def __init__(self, data, sampler):
        self._data = data
        self._indices = list(sampler)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._data[self._indices[idx]]


class ArrayDataset(Dataset):
    """Zip of arrays/lists."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for arr in args:
            if len(arr) != self._length:
                raise MXNetError("all arrays must have the same length")
            self._data.append(arr)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """The records of a RecordIO pack (``filename`` and its ``.idx``
    beside it), each the raw bytes of one record."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO

        self._filename = filename
        self._record = MXIndexedRecordIO(
            os.path.splitext(filename)[0] + ".idx", filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
