"""RecordIO: ``MXRecordIO``, ``MXIndexedRecordIO``, ``IRHeader``, ``pack``,
``unpack``, ``pack_img`` and ``unpack_img``.

Counterpart of ``mxnet_tpu/recordio.py``, a copy: the same container
(magic-delimited, length-prefixed, 4-byte padded records; a ``.idx``
sidecar of ``key\toffset`` lines), so a file written by either package
reads in the other byte for byte.  Image payloads are JPEG (the host
library's libjpeg, ``native.encode_jpeg``) or raw npy bytes.

Where the JAX package drops from JPEG to npy without a word when its
library is missing, ``pack_img`` here raises: a JPEG payload is asked for
with ``img_fmt='.jpg'`` (the default) and given, and a host library built
without libjpeg (``native.route() == 'raw'``) refuses it; pass
``img_fmt='.npy'`` for a raw payload.  A payload that is no uint8 image of
1 or 3 channels is npy in both packages.  ``unpack_img`` decodes JPEG with
the host library only.
"""
from __future__ import annotations

import collections
import io as _io
import os
import struct

import numpy as _np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a


class MXRecordIO:
    """Sequential record file."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError("invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if self.is_open:
            self.handle.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def tell(self):
        return self.handle.tell()

    def write(self, buf):
        assert self.writable
        self.handle.write(struct.pack("<II", _MAGIC, len(buf)))
        self.handle.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        head = self.handle.read(8)
        if len(head) < 8:
            return None
        magic, length = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise MXNetError("invalid record magic")
        buf = self.handle.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.read(pad)
        return buf


class MXIndexedRecordIO(MXRecordIO):
    """Random-access record file with a ``.idx`` sidecar."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) == 2:
                        key = key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)

    def close(self):
        if getattr(self, "is_open", False) and self.writable:
            with open(self.idx_path, "w") as f:
                for key in self.keys:
                    f.write("%s\t%d\n" % (key, self.idx[key]))
        super().close()

    def seek(self, idx):
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = collections.namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack an ``IRHeader`` and a payload into one record."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                          header.id2)
        return hdr + s
    label = _np.asarray(header.label, dtype=_np.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s):
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = _np.frombuffer(s[:flag * 4], dtype=_np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array: JPEG through the host library's libjpeg
    encoder for a uint8 image of 1 or 3 channels with ``img_fmt`` '.jpg'
    (raises where the library has no libjpeg), else raw npy bytes."""
    from . import native

    arr = _np.asarray(img)
    jpeg_able = (arr.dtype == _np.uint8
                 and (arr.ndim == 2 or (arr.ndim == 3
                                        and arr.shape[2] in (1, 3))))
    if img_fmt.lower() in (".jpg", ".jpeg") and jpeg_able:
        return pack(header, native.encode_jpeg(arr, quality=quality))
    buf = _io.BytesIO()
    _np.save(buf, arr)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1):
    header, payload = unpack(s)
    if payload[:2] == b"\xff\xd8":  # JPEG magic
        from . import native

        return header, native.decode_jpeg(payload)
    img = _np.load(_io.BytesIO(payload), allow_pickle=False)
    return header, img
