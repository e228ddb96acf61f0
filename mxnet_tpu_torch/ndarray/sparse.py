"""``mx.nd.sparse``: row_sparse and CSR storage.

Counterpart of ``mxnet_tpu/ndarray/sparse.py``, in its layout: a sparse
array is a format held as dense tensors on the array's device -- a
``RowSparseNDArray`` is ``data`` (K, ...) with ``indices`` (K,) int32, the
K stored rows of a larger array; a ``CSRNDArray`` is ``data`` (nnz,),
``indices`` (nnz,) and ``indptr`` (rows + 1,), the last two int32.  They
are not ``torch.sparse`` tensors: ``dot`` alone builds one, a
``torch.sparse_csr_tensor`` over the same three tensors, so that a CSR
product runs cuSPARSE's kernel on the card.

Where an op has no sparse route, the array is densified, as the JAX
package does; ``MXNET_STORAGE_FALLBACK_LOG_VERBOSE=1`` logs each such
densification.  ``row_sparse_from_dense`` and ``sparse_embedding_grad``
read their row indices on the host (one sync each), as the JAX ones do.
"""
from __future__ import annotations

import logging

import numpy as _np
import torch

from ..base import MXNetError, _as_torch_dtype, _canonical, get_env
from ..context import current_context
from .ndarray import NDArray

__all__ = ["RowSparseNDArray", "CSRNDArray", "row_sparse_array",
           "csr_matrix", "row_sparse_from_dense", "zeros", "dot", "add",
           "retain", "cast_storage", "where_nonzero",
           "sparse_embedding_grad"]

_i32 = torch.int32


def _log_storage_fallback(stype, shape):
    """``MXNET_STORAGE_FALLBACK_LOG_VERBOSE``: say when a sparse array is
    densified, so that a silent densification can be found."""
    if get_env("MXNET_STORAGE_FALLBACK_LOG_VERBOSE", bool, False):
        logging.getLogger("mxnet_tpu_torch").warning(
            "storage fallback: densifying %s array of shape %s", stype,
            shape)


def _tensor(x):
    return x._data if isinstance(x, NDArray) else x


class BaseSparseNDArray(NDArray):
    # _unique_rows: the indices are known unique and increasing, so a lazy
    # update need not sum repeats (no host sync for it)
    __slots__ = ("indices_", "indptr_", "_shape", "_unique_rows")

    @property
    def shape(self):
        return self._shape

    @property
    def size(self):
        return int(_np.prod(self._shape))

    @property
    def ndim(self):
        return len(self._shape)

    def asnumpy(self):
        return self.tostype("default").asnumpy()


class RowSparseNDArray(BaseSparseNDArray):
    """(data[K, ...], indices[K]): K stored rows of a larger array."""

    def __init__(self, data, indices, shape):
        super().__init__(data)
        self.indices_ = indices
        self.indptr_ = None
        self._shape = tuple(shape)
        self._unique_rows = False

    @property
    def stype(self):
        return "row_sparse"

    @property
    def data(self):
        return NDArray(self._data)

    @property
    def indices(self):
        return NDArray(self.indices_)

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype != "default":
            raise MXNetError("cast_storage row_sparse->%s unsupported" % stype)
        _log_storage_fallback("row_sparse", self._shape)
        dense = torch.zeros(self._shape, dtype=self._data.dtype,
                            device=self._data.device)
        # duplicate indices add up, as the JAX .at[].add does
        return NDArray(dense.index_add(0, self.indices_.long(), self._data))

    def retain(self, indices):
        """Keep only the given rows (the reference's sparse retain op)."""
        keep = _tensor(indices)
        keep = torch.as_tensor(keep, device=self.indices_.device).to(_i32)
        mask = (self.indices_[:, None] == keep[None, :]).any(dim=1)
        sel = torch.nonzero(mask).reshape(-1)
        return RowSparseNDArray(self._data[sel], self.indices_[sel],
                                self._shape)

    def __add__(self, other):
        if isinstance(other, RowSparseNDArray):
            return RowSparseNDArray(
                torch.cat([self._data, other._data]),
                torch.cat([self.indices_, other.indices_]), self._shape)
        return self.tostype("default") + other

    def __repr__(self):
        return "<RowSparseNDArray %s>" % (self._shape,)


class CSRNDArray(BaseSparseNDArray):
    """(data[nnz], indices[nnz], indptr[rows + 1]) of a 2-D array."""

    def __init__(self, data, indices, indptr, shape):
        super().__init__(data)
        self.indices_ = indices
        self.indptr_ = indptr
        self._shape = tuple(shape)
        self._unique_rows = False

    @property
    def stype(self):
        return "csr"

    @property
    def data(self):
        return NDArray(self._data)

    @property
    def indices(self):
        return NDArray(self.indices_)

    @property
    def indptr(self):
        return NDArray(self.indptr_)

    def _rows(self):
        m = self._shape[0]
        counts = (self.indptr_[1:] - self.indptr_[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(m, device=self._data.device), counts,
            output_size=self._data.shape[0])

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype != "default":
            raise MXNetError("cast_storage csr->%s unsupported" % stype)
        _log_storage_fallback("csr", self._shape)
        dense = torch.zeros(self._shape, dtype=self._data.dtype,
                            device=self._data.device)
        return NDArray(dense.index_put(
            (self._rows(), self.indices_.long()), self._data,
            accumulate=True))

    def check_format(self, full_check=True):
        """Validate the CSR invariants: indptr non-decreasing from 0 to
        nnz, column indices in range."""
        indptr = self.indptr_.cpu().numpy()
        indices = self.indices_.cpu().numpy()
        if indptr.ndim != 1 or len(indptr) != self._shape[0] + 1:
            raise MXNetError("csr indptr length %d != rows+1 (%d)"
                             % (len(indptr), self._shape[0] + 1))
        if int(indptr[0]) != 0 or _np.any(_np.diff(indptr) < 0):
            raise MXNetError("csr indptr must be non-decreasing from 0")
        if int(indptr[-1]) != len(indices):
            raise MXNetError("csr indptr[-1] (%d) != nnz (%d)"
                             % (int(indptr[-1]), len(indices)))
        if full_check and len(indices) and (
                int(indices.min()) < 0
                or int(indices.max()) >= self._shape[1]):
            raise MXNetError("csr column index out of range")

    def asscipy(self):
        import scipy.sparse as _sp

        return _sp.csr_matrix(
            (self._data.cpu().numpy(), self.indices_.cpu().numpy(),
             self.indptr_.cpu().numpy()), shape=self._shape)

    def astype(self, dtype):
        return CSRNDArray(self._data.to(_as_torch_dtype(dtype)),
                          self.indices_, self.indptr_, self._shape)

    def __repr__(self):
        return "<CSRNDArray %s>" % (self._shape,)


def _device(ctx):
    return (ctx if ctx is not None else current_context()).torch_device


def _on(arr, dev, dtype=None):
    t = torch.from_numpy(_np.ascontiguousarray(arr))
    t = _canonical(t) if dtype is None else t.to(dtype)
    return t.to(dev)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A ``RowSparseNDArray`` from ``(data, indices)`` (data float32 unless
    ``dtype``) or from a dense array (its rows with a nonzero)."""
    dev = _device(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        data = _np.asarray(data.asnumpy() if isinstance(data, NDArray)
                           else data, dtype=_np.dtype(dtype) if dtype
                           else _np.float32)
        indices = _np.asarray(indices.asnumpy() if isinstance(
            indices, NDArray) else indices, dtype=_np.int32)
        return RowSparseNDArray(_on(data, dev), _on(indices, dev), shape)
    arr = _np.asarray(arg1.asnumpy() if isinstance(arg1, NDArray) else arg1)
    nz = _np.where(_np.any(arr.reshape(arr.shape[0], -1) != 0, axis=1))[0]
    return RowSparseNDArray(_on(arr[nz], dev),
                            _on(nz.astype(_np.int32), dev),
                            shape or arr.shape)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A ``CSRNDArray`` from ``(data, indices, indptr)`` or from a dense
    2-D array."""
    dev = _device(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = (
            _np.asarray(a.asnumpy() if isinstance(a, NDArray) else a)
            for a in arg1)
        return CSRNDArray(_on(data, dev),
                          _on(indices.astype(_np.int32), dev),
                          _on(indptr.astype(_np.int32), dev), shape)
    arr = _np.asarray(arg1.asnumpy() if isinstance(arg1, NDArray) else arg1)
    m = arr.shape[0]
    rows, cols = _np.nonzero(arr)          # row-major: the CSR order
    indptr = _np.zeros(m + 1, _np.int32)
    _np.cumsum(_np.bincount(rows, minlength=m), out=indptr[1:])
    return CSRNDArray(_on(arr[rows, cols], dev),
                      _on(cols.astype(_np.int32), dev), _on(indptr, dev),
                      shape or arr.shape)


def _csr_tensor(csr):
    """The ``torch.sparse_csr_tensor`` over a CSRNDArray's three tensors
    (int32 indices: cuSPARSE's 32-bit route)."""
    return torch.sparse_csr_tensor(csr.indptr_, csr.indices_, csr._data,
                                   size=csr._shape, check_invariants=False)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot:

    - CSR x dense -> dense (``torch.sparse.mm``: cuSPARSE's SpMM on the
      card), CSR.T x dense likewise;
    - row_sparse.T x dense -> dense over the stored rows alone (the
      embedding-gradient pattern); row_sparse x dense densifies;
    - dense operands go to the dense ``dot`` op.
    """
    if isinstance(lhs, CSRNDArray):
        r = _tensor(rhs)
        if transpose_b:
            r = r.t()
        a = _csr_tensor(lhs)
        if transpose_a:
            a = a.t()
        r = r.to(torch.promote_types(lhs._data.dtype, r.dtype))
        return NDArray(torch.sparse.mm(a.to(r.dtype), r))
    if isinstance(lhs, RowSparseNDArray):
        r = _tensor(rhs)
        if not transpose_a:
            return NDArray(lhs.tostype("default")._data @ (
                r.t() if transpose_b else r))
        sel = r[lhs.indices_.long()]
        return NDArray(torch.einsum("kr,kc->rc", lhs._data, sel))
    from ..ops.registry import get_op

    return get_op("dot")(lhs, rhs, transpose_a=transpose_a,
                         transpose_b=transpose_b)


def add(lhs, rhs):
    """Sparse-aware add: two row_sparse arrays stay sparse, else dense."""
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                        RowSparseNDArray):
        return lhs + rhs
    a = lhs.tostype("default") if isinstance(lhs, BaseSparseNDArray) else lhs
    b = rhs.tostype("default") if isinstance(rhs, BaseSparseNDArray) else rhs
    return a + b


def retain(data, indices):
    """The rows of a row_sparse ``data`` whose index is in ``indices``."""
    if not isinstance(data, RowSparseNDArray):
        raise MXNetError("retain: expected a RowSparseNDArray, got %r"
                         % (type(data),))
    return data.retain(indices)


def cast_storage(arr, stype):
    """The reference's cast_storage op."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    if stype == "default":
        return arr
    ctx = arr.context if isinstance(arr, NDArray) else None
    if stype == "row_sparse":
        return row_sparse_from_dense(arr) if isinstance(arr, NDArray) \
            else row_sparse_array(arr, ctx=ctx)
    if stype == "csr":
        return csr_matrix(arr, ctx=ctx)
    raise MXNetError("unknown stype %r" % stype)


def where_nonzero(arr):
    """Row indices with any nonzero (helper for building row_sparse)."""
    a = arr.asnumpy()
    return _np.where(_np.any(a.reshape(a.shape[0], -1) != 0, axis=1))[0]


def row_sparse_from_dense(arr):
    """Dense array or tensor -> RowSparseNDArray, the mask and the gather
    on its device: only the row indices reach the host (one sync).  A row
    whose entries are all zero is not stored, whether a gradient touched it
    or not (the JAX mask ``any(flat != 0)``)."""
    data = _tensor(arr)
    flat = data.reshape(data.shape[0], -1)
    idx = torch.nonzero((flat != 0).any(dim=1)).reshape(-1)
    out = RowSparseNDArray(data[idx], idx.to(_i32), tuple(data.shape))
    out._unique_rows = True
    return out


def sparse_embedding_grad(grad_out, token_ids, vocab_size):
    """The row_sparse gradient of an embedding lookup: one stored row per
    unique token id (in increasing order), the gradients of its repeats
    summed.  ``grad_out`` (..., dim), ``token_ids`` (...)."""
    g = _tensor(grad_out)
    ids = _tensor(token_ids)
    flat_g = g.reshape(-1, g.shape[-1])
    uniq, inverse = torch.unique(ids.reshape(-1).long(), sorted=True,
                                 return_inverse=True)
    summed = torch.zeros((uniq.numel(), g.shape[-1]), dtype=g.dtype,
                         device=g.device).index_add(0, inverse, flat_g)
    out = RowSparseNDArray(summed, uniq.to(_i32), (vocab_size, g.shape[-1]))
    out._unique_rows = True
    return out


def zeros(stype, shape, ctx=None, dtype="float32"):
    dev = _device(ctx)
    dt = _as_torch_dtype(dtype)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + tuple(shape[1:]), dtype=dt, device=dev),
            torch.zeros((0,), dtype=_i32, device=dev), shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=_i32, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=_i32,
                                      device=dev), shape)
    from . import zeros as dense_zeros

    return dense_zeros(shape, ctx=ctx, dtype=dtype)
