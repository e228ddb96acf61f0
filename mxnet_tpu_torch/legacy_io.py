"""Reference (incumbent MXNet) binary serialization interop.

Counterpart of ``mxnet_tpu/legacy_io.py``: a byte-level reader and writer
of the reference's NDArray list format, so ``.params`` files of either
package (and of the incumbent) load in the port.  Host-only: arrays come
back as numpy, bf16 ones (dtype flag 12) as ``torch.bfloat16`` tensors
read through a 16-bit integer view (``ml_dtypes`` is not used).

- file header: uint64 magic 0x112 (kMXAPINDArrayListMagic,
  src/ndarray/ndarray.cc:1930) + uint64 reserved
- vector<NDArray>: uint64 count, then per-array NDArray::Save
  (ndarray.cc:1697) — uint32 version magic (V2 0xF993fac9 dense/sparse,
  V3 0xF993faca np-semantics, V1 0xF993fac8 legacy), int32 stype,
  [storage shape if sparse], shape (int32 ndim + int64[ndim],
  include/mxnet/tuple.h:731), int32 dev_type + int32 dev_id
  (include/mxnet/base.h:145), int32 dtype flag (mshadow/base.h:327),
  [aux dtypes+shapes if sparse], raw data, [aux data]
- vector<string> keys: uint64 count, then per-key uint64 len + bytes

Sparse payloads (kCSRStorage=2: aux [indptr, indices];
kRowSparseStorage=1: aux [indices]) load into ``nd.sparse``'s
``CSRNDArray`` and ``RowSparseNDArray``.
"""
from __future__ import annotations

import struct

import numpy as _np
import torch

from .base import MXNetError

MAGIC_LIST = 0x112
V1 = 0xF993FAC8
V2 = 0xF993FAC9
V3 = 0xF993FACA

# mshadow/base.h:327 TypeFlag
_FLAG2DT = {0: _np.float32, 1: _np.float64, 2: _np.float16, 3: _np.uint8,
            4: _np.int32, 5: _np.int8, 6: _np.int64, 7: _np.bool_,
            8: _np.int16, 9: _np.uint16, 10: _np.uint32, 11: _np.uint64}
_DT2FLAG = {_np.dtype(v): k for k, v in _FLAG2DT.items()}
_BFLOAT16_FLAG = 12

_STYPE_DEFAULT, _STYPE_ROW_SPARSE, _STYPE_CSR = 0, 1, 2
_NUM_AUX = {_STYPE_DEFAULT: 0, _STYPE_ROW_SPARSE: 1, _STYPE_CSR: 2}


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, n):
        if self.pos + n > len(self.buf):
            raise MXNetError("reference params: truncated stream at byte "
                             "%d (+%d wanted)" % (self.pos, n))
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def i32(self):
        return struct.unpack("<i", self.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.read(8))[0]


def _read_shape(r):
    ndim = r.i32()
    if ndim < 0:  # np-semantics unknown shape
        return None
    return tuple(struct.unpack("<%dq" % ndim, r.read(8 * ndim)))


def _read_tensor_data(r, flag, shape):
    if flag == _BFLOAT16_FLAG:
        dt = _np.dtype(_np.int16)
    else:
        try:
            dt = _np.dtype(_FLAG2DT[flag])
        except KeyError:
            raise MXNetError("reference params: unknown dtype flag %d"
                             % flag) from None
    n = 1
    for s in shape:
        n *= s
    raw = r.read(dt.itemsize * n)
    arr = _np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    if flag == _BFLOAT16_FLAG:
        return torch.from_numpy(arr).view(torch.bfloat16)
    return arr


def _read_one(r):
    magic = r.u32()
    if magic in (V2, V3):
        stype = r.i32()
        nad = _NUM_AUX.get(stype)
        if nad is None:
            raise MXNetError("reference params: unknown storage type %d"
                             % stype)
        storage_shape = _read_shape(r) if nad else None
        shape = _read_shape(r)
        if shape is None or (magic == V2 and len(shape) == 0):
            # "is_none" save path: shape ndim 0 in legacy semantics means
            # an empty NDArray; nothing else was written
            return None
        r.i32(), r.i32()  # dev_type, dev_id — always loaded to our context
        flag = r.i32()
        if nad:
            aux_meta = []
            for _ in range(nad):
                aux_flag = r.i32()
                aux_shape = _read_shape(r)
                aux_meta.append((aux_flag, aux_shape))
            data = _read_tensor_data(r, flag, storage_shape)
            aux = [_read_tensor_data(r, aux_flag, aux_shape)
                   for aux_flag, aux_shape in aux_meta]
            return _Sparse(stype, shape, data, aux)
        return _read_tensor_data(r, flag, shape)
    # V1 / raw-ndim legacy header
    if magic == V1:
        shape = _read_shape(r)
    else:
        ndim = magic  # ancient format: the magic IS the ndim (uint32 dims)
        if ndim > 32:
            raise MXNetError("reference params: bad magic 0x%x" % magic)
        shape = tuple(struct.unpack("<%dI" % ndim, r.read(4 * ndim)))
    if len(shape) == 0:
        return None
    r.i32(), r.i32()
    flag = r.i32()
    return _read_tensor_data(r, flag, shape)


class _Sparse:
    """A sparse record as read: ``stype`` (1 row_sparse, 2 CSR), the dense
    shape, the stored data and the aux arrays (row_sparse: indices; CSR:
    indptr, indices)."""

    def __init__(self, stype, shape, data, aux):
        self.stype, self.shape, self.data, self.aux = stype, shape, data, aux

    def to_ndarray(self, ctx=None):
        from .ndarray import sparse as _sp

        if self.stype == _STYPE_CSR:
            indptr, indices = self.aux
            return _sp.csr_matrix((self.data, indices, indptr),
                                  shape=self.shape, ctx=ctx)
        return _sp.row_sparse_array((self.data, self.aux[0]),
                                    shape=self.shape, ctx=ctx,
                                    dtype=self.data.dtype)


def is_reference_format(head8):
    return len(head8) >= 8 and \
        struct.unpack("<Q", head8[:8])[0] == MAGIC_LIST


def load_buffer(buf):
    """Parse a reference .params byte buffer -> (list_of_arrays, keys).

    Arrays come back as numpy (bf16 ones as ``torch.bfloat16`` tensors);
    the caller wraps them into NDArrays (keeps this module host-only)."""
    r = _Reader(buf)
    if r.u64() != MAGIC_LIST:
        raise MXNetError("not a reference NDArray file (magic mismatch)")
    r.u64()  # reserved
    n = r.u64()
    arrays = [_read_one(r) for _ in range(n)]
    n_keys = r.u64()
    keys = []
    for _ in range(n_keys):
        ln = r.u64()
        keys.append(r.read(ln).decode())
    return arrays, keys


def load(fname, ctx=None):
    """Load a reference-format .params file the way mx.nd.load returns:
    dict when keys were saved, else a list, of NDArrays on ``ctx``."""
    from .ndarray import array

    with open(fname, "rb") as f:
        buf = f.read()
    arrays, keys = load_buffer(buf)

    def wrap(a):
        if isinstance(a, _Sparse):
            return a.to_ndarray(ctx)
        return None if a is None else array(a, ctx=ctx)

    arrays = [wrap(a) for a in arrays]
    if keys:
        return dict(zip(keys, arrays))
    return arrays


def _write_shape(out, shape):
    out.append(struct.pack("<i", len(shape)))
    out.append(struct.pack("<%dq" % len(shape), *shape))


def _host(a):
    """numpy of an NDArray, tensor or array; a bf16 one as its int16
    bits, flagged."""
    t = getattr(a, "_data", a)
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), True
        return t.numpy(), False
    return _np.asarray(a), False


def _dump_one(out, a):
    arr, bf16 = _host(a)
    arr = _np.require(arr, requirements="C")
    if bf16:
        flag = _BFLOAT16_FLAG
    else:
        try:
            flag = _DT2FLAG[arr.dtype]
        except KeyError:
            raise MXNetError("reference format cannot hold dtype %s"
                             % arr.dtype) from None
    out.append(struct.pack("<I", V2))
    out.append(struct.pack("<i", _STYPE_DEFAULT))
    _write_shape(out, arr.shape)
    out.append(struct.pack("<ii", 1, 0))      # cpu(0)
    out.append(struct.pack("<i", flag))
    out.append(arr.tobytes())


def save(fname, data):
    """Write a reference-compatible dense .params file (V2 records),
    atomically (``checkpoint.layout.atomic_file``)."""
    from .checkpoint.layout import atomic_file
    from .ndarray.ndarray import NDArray

    if isinstance(data, NDArray):
        arrays, keys = [data], []
    elif isinstance(data, dict):
        keys = list(data)
        arrays = [data[k] for k in keys]
    elif isinstance(data, (list, tuple)):
        arrays, keys = list(data), []
    else:
        raise MXNetError("save: unsupported data type %r" % type(data))
    out = [struct.pack("<QQ", MAGIC_LIST, 0),
           struct.pack("<Q", len(arrays))]
    for a in arrays:
        _dump_one(out, a)
    out.append(struct.pack("<Q", len(keys)))
    for k in keys:
        kb = k.encode()
        out.append(struct.pack("<Q", len(kb)))
        out.append(kb)
    atomic_file(fname, b"".join(out))
