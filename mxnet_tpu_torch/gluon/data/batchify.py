"""Batchify functions: ``Stack``, ``Pad`` and ``Group``.

Counterpart of ``mxnet_tpu/gluon/data/batchify.py``.  A batch is made on
the host and lands on the current context (the card unless a ``with
mx.cpu():`` scope is open) in one copy.
"""
from __future__ import annotations

import numpy as _np

from ... import ndarray as nd
from ...ndarray.ndarray import NDArray

__all__ = ["Stack", "Pad", "Group"]


class Stack:
    def __call__(self, data):
        from .dataloader import default_batchify_fn

        return default_batchify_fn(data)


class Pad:
    def __init__(self, axis=0, val=0, dtype=None):
        self._axis = axis
        self._val = val
        self._dtype = dtype

    def __call__(self, data):
        arrs = [x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)
                for x in data]
        max_len = max(a.shape[self._axis] for a in arrs)
        padded = []
        for a in arrs:
            pad_width = [(0, 0)] * a.ndim
            pad_width[self._axis] = (0, max_len - a.shape[self._axis])
            padded.append(_np.pad(a, pad_width, constant_values=self._val))
        out = _np.stack(padded)
        if self._dtype:
            out = out.astype(self._dtype)
        return nd.array(out)


class Group:
    def __init__(self, *fns):
        self._fns = fns

    def __call__(self, data):
        return tuple(fn(list(x)) for fn, x in zip(self._fns, zip(*data)))
