"""ctypes bindings for the repo's host library (``src/native/*.cc``): the
RecordIO reader and writer, JPEG decode and encode, the bilinear resize
and the threaded ImageRecord loader.

Counterpart of ``mxnet_tpu/native/__init__.py``, cut to what the input
pipeline needs (the dependency engine and the memory pool are not
ported).  The sources are the repo's own and are only read.  At first use
``g++`` compiles them with the JAX package's command into the port's own
library under ``build/torch_ext/`` (``libmxnet_tpu_torch_native.so``, or
``libmxnet_tpu_torch_native_raw.so`` for the raw build), rebuilt when a
source is newer or when the file there does not load on this host; the
build goes to a temporary name that is moved into place, so processes
that build at once never load a half-written file.

Two builds, and ``route()`` says which one loaded:

- ``"jpeg"``: every ``src/native/*.cc`` with ``-ljpeg -lz``, where the
  host has ``<jpeglib.h>``.  JPEG decode and encode work.
- ``"raw"``: on a host without ``<jpeglib.h>``, ``image.cc`` is replaced
  by ``mxnet_tpu_torch/csrc/host/image_nojpeg.cc`` (the same resize, no
  JPEG).  The loader reads raw u8 npy payloads; ``decode_jpeg``,
  ``encode_jpeg`` and a loader over a JPEG pack raise.

Where the JAX package falls back to Python without a word when its
library is missing, the port does not: a build that fails raises
``MXNetError`` with ``g++``'s message.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from .base import MXNetError

__all__ = ["lib", "route", "jpeg_headers", "build", "RecordWriter",
           "RecordReader", "decode_jpeg", "encode_jpeg", "resize_bilinear",
           "ImageRecordLoader"]

_PKG = Path(__file__).resolve().parent
_REPO = _PKG.parent
SRC_DIR = _REPO / "src" / "native"
SHIM = _PKG / "csrc" / "host" / "image_nojpeg.cc"
LIBRARY = _REPO / "build" / "torch_ext" / "libmxnet_tpu_torch_native.so"
LIBRARY_RAW = LIBRARY.with_name("libmxnet_tpu_torch_native_raw.so")
CXX_FLAGS = ["-std=c++17", "-O2", "-fPIC", "-shared", "-pthread", "-Wall"]

_LOCK = threading.Lock()
_LIB = None


def jpeg_headers():
    """Whether ``g++`` finds ``<jpeglib.h>`` on this host."""
    proc = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                          input="#include <jpeglib.h>\n", text=True,
                          capture_output=True)
    return proc.returncode == 0


def _sources(jpeg):
    srcs = sorted(SRC_DIR.glob("*.cc"))
    if jpeg:
        return srcs
    return [s for s in srcs if s.name != "image.cc"] + [SHIM]


def _stale(path, jpeg):
    if not path.exists():
        return True
    built = path.stat().st_mtime
    deps = _sources(jpeg) + sorted(SRC_DIR.glob("*.h"))
    return any(d.stat().st_mtime > built for d in deps)


def build(path=None, jpeg=None, force=False):
    """Compile the host library to ``path`` (default ``LIBRARY`` or
    ``LIBRARY_RAW``) if it is missing or older than its sources (``jpeg``:
    the build; default what the host's headers allow); returns ``path``.
    Raises ``MXNetError`` with g++'s output."""
    if jpeg is None:
        jpeg = jpeg_headers()
    path = Path(path if path is not None
                else (LIBRARY if jpeg else LIBRARY_RAW))
    if not force and not _stale(path, jpeg):
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".so.tmp")
    os.close(fd)
    cmd = (["g++"] + CXX_FLAGS + ["-I", str(SRC_DIR)]
           + [str(s) for s in _sources(jpeg)] + ["-o", tmp]
           + (["-ljpeg", "-lz"] if jpeg else ["-lz"]))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise MXNetError("the host library did not build (%s):\n%s"
                             % (" ".join(cmd), proc.stderr[-4000:]))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _declare(lib):
    c = ctypes
    lib.MXTGetLastError.restype = c.c_char_p
    lib.MXTRecordWriterCreate.restype = c.c_void_p
    lib.MXTRecordWriterCreate.argtypes = [c.c_char_p]
    lib.MXTRecordWriterWrite.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
    lib.MXTRecordWriterTell.restype = c.c_int64
    lib.MXTRecordWriterTell.argtypes = [c.c_void_p]
    lib.MXTRecordWriterClose.argtypes = [c.c_void_p]
    lib.MXTRecordReaderCreate.restype = c.c_void_p
    lib.MXTRecordReaderCreate.argtypes = [c.c_char_p]
    lib.MXTRecordReaderNext.restype = c.c_int64
    lib.MXTRecordReaderNext.argtypes = [c.c_void_p,
                                        c.POINTER(c.POINTER(c.c_uint8))]
    lib.MXTRecordReaderSeek.argtypes = [c.c_void_p, c.c_int64]
    lib.MXTRecordReaderTell.restype = c.c_int64
    lib.MXTRecordReaderTell.argtypes = [c.c_void_p]
    lib.MXTRecordReaderReadAt.restype = c.c_int64
    lib.MXTRecordReaderReadAt.argtypes = [c.c_void_p, c.c_int64,
                                          c.POINTER(c.c_uint8), c.c_uint64]
    lib.MXTRecordReaderClose.argtypes = [c.c_void_p]
    lib.MXTDecodeJPEG.restype = c.c_int
    lib.MXTDecodeJPEG.argtypes = [
        c.POINTER(c.c_uint8), c.c_uint64, c.POINTER(c.c_void_p),
        c.POINTER(c.c_int), c.POINTER(c.c_int), c.POINTER(c.c_int)]
    if hasattr(lib, "MXTEncodeJPEG"):
        lib.MXTEncodeJPEG.restype = c.c_int
        lib.MXTEncodeJPEG.argtypes = [
            c.POINTER(c.c_uint8), c.c_int, c.c_int, c.c_int, c.c_int,
            c.POINTER(c.c_void_p), c.POINTER(c.c_uint64)]
    lib.MXTImageResizeBilinear.argtypes = [
        c.POINTER(c.c_uint8), c.c_int, c.c_int, c.c_int,
        c.POINTER(c.c_uint8), c.c_int, c.c_int]
    lib.MXTBufFree.argtypes = [c.c_void_p]
    lib.MXTLoaderCreate.restype = c.c_void_p
    lib.MXTLoaderCreate.argtypes = [
        c.c_char_p, c.c_char_p, c.c_int, c.c_int, c.c_int, c.c_int,
        c.c_int, c.c_int, c.c_uint64, c.c_int, c.c_int,
        c.POINTER(c.c_float), c.c_float]
    lib.MXTLoaderNext.restype = c.c_int
    lib.MXTLoaderNext.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                  c.POINTER(c.c_float)]
    lib.MXTLoaderReset.argtypes = [c.c_void_p]
    lib.MXTLoaderDestroy.argtypes = [c.c_void_p]


def lib():
    """The loaded host library, built at first use; raises where it
    cannot be built."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = build()
            try:
                handle = ctypes.CDLL(str(path))
            except OSError:     # built on another host: build it here
                handle = ctypes.CDLL(str(build(path, force=True)))
            _declare(handle)
            _LIB = handle
        return _LIB


def route():
    """``"jpeg"`` or ``"raw"``: the build that loaded (see the module
    docstring)."""
    return "jpeg" if hasattr(lib(), "MXTEncodeJPEG") else "raw"


def _err():
    return lib().MXTGetLastError().decode()


def _need_jpeg(what):
    if route() != "jpeg":
        raise MXNetError(
            "%s needs JPEG, but the host library was built without libjpeg "
            "(no <jpeglib.h> on this host); pack raw payloads "
            "(recordio.pack_img(..., img_fmt='.npy'))" % what)


class RecordWriter:
    """Native sequential record writer (the framing of ``recordio``)."""

    def __init__(self, path):
        self._lib = lib()
        self._h = self._lib.MXTRecordWriterCreate(os.fspath(path).encode())
        if not self._h:
            raise IOError(_err())

    def write(self, buf):
        if self._lib.MXTRecordWriterWrite(self._h, bytes(buf),
                                          len(buf)) != 0:
            raise IOError("record write failed")

    def tell(self):
        return self._lib.MXTRecordWriterTell(self._h)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.MXTRecordWriterClose(self._h)
            self._h = None

    __del__ = close


class RecordReader:
    """Native sequential and random-access record reader."""

    def __init__(self, path):
        self._lib = lib()
        self._h = self._lib.MXTRecordReaderCreate(os.fspath(path).encode())
        if not self._h:
            raise IOError(_err())

    def read(self):
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.MXTRecordReaderNext(self._h, ctypes.byref(out))
        if n == 0:
            return None
        if n < 0:
            raise IOError(_err())
        return ctypes.string_at(out, n)

    def read_at(self, offset):
        cap = 1 << 16
        while True:
            buf = (ctypes.c_uint8 * cap)()
            n = self._lib.MXTRecordReaderReadAt(self._h, offset, buf, cap)
            if n < 0:
                raise IOError(_err())
            if n == 0:
                return None
            if n <= cap:
                return bytes(bytearray(buf[:n]))
            cap = int(n)

    def seek(self, offset):
        self._lib.MXTRecordReaderSeek(self._h, offset)

    def tell(self):
        return self._lib.MXTRecordReaderTell(self._h)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.MXTRecordReaderClose(self._h)
            self._h = None

    __del__ = close


def decode_jpeg(buf):
    """Decode JPEG bytes to an RGB uint8 HWC array (libjpeg)."""
    _need_jpeg("decode_jpeg")
    l = lib()
    data = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)
    out = ctypes.c_void_p()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if l.MXTDecodeJPEG(data, len(buf), ctypes.byref(out), ctypes.byref(h),
                       ctypes.byref(w), ctypes.byref(c)) != 0:
        raise ValueError(_err())
    n = h.value * w.value * c.value
    arr = np.ctypeslib.as_array(
        ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), (n,)).copy()
    l.MXTBufFree(out)
    return arr.reshape(h.value, w.value, c.value)


def encode_jpeg(img, quality=95):
    """Encode an HWC uint8 array (1 or 3 channels) to JPEG bytes."""
    _need_jpeg("encode_jpeg")
    l = lib()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    src = img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    out = ctypes.c_void_p()
    out_len = ctypes.c_uint64()
    if l.MXTEncodeJPEG(src, h, w, c, quality, ctypes.byref(out),
                       ctypes.byref(out_len)) != 0:
        raise ValueError(_err())
    buf = ctypes.string_at(out, out_len.value)
    l.MXTBufFree(out)
    return buf


def resize_bilinear(img, dh, dw):
    """Bilinear-resize an HWC uint8 array natively."""
    l = lib()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    dst = np.empty((dh, dw, c), np.uint8)
    l.MXTImageResizeBilinear(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dh, dw)
    return dst


def _first_payload_is_jpeg(rec_path):
    from .recordio import MXRecordIO, unpack

    rec = MXRecordIO(rec_path, "r")
    try:
        raw = rec.read()
    finally:
        rec.close()
    return raw is not None and unpack(raw)[1][:2] == b"\xff\xd8"


class ImageRecordLoader:
    """The threaded native ImageRecord pipeline (decode, augment, batch
    and prefetch on host threads): ``next()`` copies the next float32
    NCHW batch into ``out`` arrays (default its own)."""

    def __init__(self, rec_path, batch_size, data_shape, label_width=1,
                 num_workers=2, shuffle=False, seed=0, rand_mirror=False,
                 rand_crop=False, mean=(0.0, 0.0, 0.0), scale=1.0):
        self._lib = lib()
        if route() != "jpeg" and _first_payload_is_jpeg(rec_path):
            _need_jpeg("ImageRecordLoader over the JPEG pack %s" % rec_path)
        c, h, w = data_shape
        flags = (1 if rand_mirror else 0) | (2 if rand_crop else 0)
        mean_arr = (ctypes.c_float * 3)(*[float(m) for m in mean])
        self._h = self._lib.MXTLoaderCreate(
            os.fspath(rec_path).encode(), b"", batch_size, c, h, w,
            label_width, num_workers, seed, int(shuffle), flags, mean_arr,
            float(scale))
        if not self._h:
            raise IOError("cannot open the image records %s: %s"
                          % (rec_path, _err()))
        self.batch_size = batch_size
        self.data_shape = (c, h, w)
        self.label_width = label_width
        self._data_buf = np.empty((batch_size, c, h, w), np.float32)
        self._label_buf = np.empty((batch_size, label_width), np.float32)

    def next(self, out_data=None, out_label=None):
        """``(data, label, count)``, or None at the epoch's end: the next
        batch written into ``out_data`` (float32, (N, C, H, W)) and
        ``out_label`` (float32, (N, label_width)), contiguous host
        arrays, by default the loader's own buffers."""
        data = self._data_buf if out_data is None else out_data
        label = self._label_buf if out_label is None else out_label
        for arr, like in ((data, self._data_buf), (label, self._label_buf)):
            if arr.shape != like.shape or arr.dtype != np.float32 \
                    or not arr.flags.c_contiguous or not arr.flags.writeable:
                raise MXNetError(
                    "ImageRecordLoader.next: an output must be a writable "
                    "C-contiguous float32 array of shape %s, got %s %s"
                    % (like.shape, arr.dtype, arr.shape))
        n = self._lib.MXTLoaderNext(
            self._h,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            label.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n == 0:
            return None
        return data, label, n

    def reset(self):
        self._lib.MXTLoaderReset(self._h)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.MXTLoaderDestroy(self._h)
            self._h = None

    __del__ = close
