"""Sharded streaming RecordIO readers: the host half of ``mx.data``.

Counterpart of ``mxnet_tpu/data/reader.py``.  A :class:`ShardSet` is a
dataset stored as N RecordIO shard files.  Shard assignment comes from the
host coordinates of the training world (``world_coords``), so each host
reads only its slice: whole shards round-robin when there are at least as
many shards as hosts, else record-level striping (``entries[host::
num_hosts]``).

The per-epoch sample order is a pure function of ``(seed, epoch)``: a
``numpy.random.default_rng(SeedSequence((seed, epoch)))`` permutation of
the host's entries, the same numbers the JAX package draws.  A cursor is
``(epoch, batches consumed)`` plus the seed, and resuming from it replays
the rest of the stream exactly.

The :class:`ReaderPool` runs ``num_workers`` threads; batch ``b`` is built
by worker ``b % W`` (each with its own file handles), completions reorder
by batch index, and read-ahead is bounded by what the prefetch ring
downstream holds.  A read that fails with ``OSError`` reopens its handles
and retries with backoff; the ``data_read`` fault site (``mx.resilience``)
fires inside that loop, keyed by batch index, so an ``io`` fault is
retried like a real storage hiccup.
"""
from __future__ import annotations

import glob as _glob
import io as _bio
import os
import struct
import threading
import time as _time

import numpy as _np

from .. import telemetry as _tel
from .. import trace as _trace
from ..base import MXNetError, get_env
from ..resilience import inject as _inject


__all__ = ["ShardSet", "ReaderPool", "default_decode", "world_coords",
           "read_record_at"]

_MAGIC = 0xced7230a          # recordio.py framing (same container)
_READ_RETRIES = 3
_RETRY_SLEEP = 0.05


def world_coords(num_hosts=None, host=None):
    """The ``(num_hosts, host)`` data-plane coordinates of this process.

    Order of truth: explicit arguments, then the launcher's environment
    (``MXNET_DIST_NUM_WORKERS``/``MXNET_DIST_RANK``), then an initialized
    ``torch.distributed`` world (its size and rank), else a world of
    one."""
    dist = None
    try:
        import torch.distributed as dist_mod

        if dist_mod.is_available() and dist_mod.is_initialized():
            dist = dist_mod
    except ImportError:
        dist = None
    if num_hosts is None:
        num_hosts = get_env("MXNET_DIST_NUM_WORKERS", int, 0) or 0
        if num_hosts <= 0:
            num_hosts = dist.get_world_size() if dist is not None else 1
    if host is None:
        host = get_env("MXNET_DIST_RANK", int, 0) or 0
        if num_hosts > 1 and host == 0 and dist is not None:
            host = dist.get_rank()
    num_hosts = max(1, int(num_hosts))
    host = int(host)
    if not 0 <= host < num_hosts:
        raise MXNetError("data host %d outside world of %d"
                         % (host, num_hosts))
    return num_hosts, host


def _scan_offsets(path):
    """Record byte offsets of a RecordIO file without an .idx sidecar
    (one sequential pass of the framing headers; payloads skipped)."""
    offsets = []
    with open(path, "rb") as f:
        pos = 0
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            magic, length = struct.unpack("<II", head)
            if magic != _MAGIC:
                raise MXNetError("invalid record magic in %s at byte %d"
                                 % (path, pos))
            offsets.append(pos)
            pad = (4 - length % 4) % 4
            f.seek(length + pad, os.SEEK_CUR)
            pos += 8 + length + pad
    return offsets


def _load_idx(idx_path):
    offsets = []
    with open(idx_path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) == 2:
                offsets.append(int(parts[1]))
    return offsets


def read_record_at(handle, offset):
    """Read ONE framed record payload at ``offset`` from an open
    binary handle (the random-access primitive under every worker)."""
    handle.seek(offset)
    head = handle.read(8)
    if len(head) < 8:
        raise MXNetError("truncated record at byte %d" % offset)
    magic, length = struct.unpack("<II", head)
    if magic != _MAGIC:
        raise MXNetError("invalid record magic at byte %d" % offset)
    buf = handle.read(length)
    if len(buf) < length:
        raise MXNetError("truncated record payload at byte %d" % offset)
    return buf


def default_decode(raw):
    """Default record decoder: ``recordio.pack``-framed IRHeader +
    payload -> ``(data, label)`` numpy arrays.  npy payloads load
    directly; JPEG payloads go through ``unpack_img``'s decoders."""
    from ..recordio import unpack, unpack_img

    header, payload = unpack(raw)
    if payload[:2] == b"\xff\xd8":                    # JPEG magic
        header, img = unpack_img(raw)
        data = _np.asarray(img)
    else:
        data = _np.load(_bio.BytesIO(payload), allow_pickle=False)
    label = _np.asarray(header.label, dtype=_np.float32)
    return data, label


class _Shard:
    __slots__ = ("path", "idx_path", "offsets")

    def __init__(self, path, idx_path=None):
        self.path = os.fspath(path)
        if idx_path is None:
            cand = os.path.splitext(self.path)[0] + ".idx"
            idx_path = cand if os.path.exists(cand) else None
        self.idx_path = idx_path
        self.offsets = (_load_idx(idx_path) if idx_path
                        else _scan_offsets(self.path))

    def __len__(self):
        return len(self.offsets)


class ShardSet:
    """An ordered set of RecordIO shards + the deterministic
    host-assignment and epoch-order math of the streaming loader."""

    def __init__(self, paths):
        paths = [os.fspath(p) for p in paths]
        if not paths:
            raise MXNetError("ShardSet needs at least one shard file")
        self.shards = [_Shard(p) for p in sorted(paths)]
        # global id base per shard: sample id = base[si] + record pos —
        # stable across any assignment mode, the drill's audit key
        self._base = []
        total = 0
        for s in self.shards:
            self._base.append(total)
            total += len(s)
        self.total_records = total

    @classmethod
    def from_pattern(cls, pattern):
        """Glob a shard pattern (``train-*.rec``); a single concrete
        file is a one-shard set."""
        paths = sorted(_glob.glob(os.fspath(pattern)))
        if not paths:
            if os.path.exists(pattern):
                paths = [pattern]
            else:
                raise MXNetError("no shard files match %r" % (pattern,))
        return cls(paths)

    def __len__(self):
        return len(self.shards)

    def global_id(self, shard_index, pos):
        return self._base[shard_index] + int(pos)

    # -- assignment ----------------------------------------------------------
    def assignment(self, num_hosts, host):
        """This host's entry list ``[(shard_index, record_pos), ...]``
        in canonical (pre-shuffle) order, plus the assignment mode.
        Whole shards round-robin when there are enough of them; else
        record-level striping keeps every host fed."""
        num_hosts = max(1, int(num_hosts))
        host = int(host)
        if len(self.shards) >= num_hosts:
            mine = range(host, len(self.shards), num_hosts)
            entries = [(si, pos) for si in mine
                       for pos in range(len(self.shards[si]))]
            return entries, "shard"
        entries = [(si, pos) for si in range(len(self.shards))
                   for pos in range(len(self.shards[si]))]
        return entries[host::num_hosts], "record"

    def host_record_count(self, num_hosts, host):
        """O(shards) count of ``assignment(num_hosts, host)`` —
        every host can compute every peer's slice size, which is how
        the epoch length becomes a world-wide constant."""
        num_hosts = max(1, int(num_hosts))
        if len(self.shards) >= num_hosts:
            return sum(len(self.shards[si])
                       for si in range(int(host), len(self.shards),
                                       num_hosts))
        # record striping: ceil((total - host) / num_hosts)
        return max(0, (self.total_records - int(host) + num_hosts - 1)
                   // num_hosts)

    def batches_per_epoch(self, num_hosts, local_batch):
        """Epoch length every host agrees on: the MIN host slice,
        whole batches only (the distributed drop-last rule — a global
        batch must have every host's contribution)."""
        counts = [self.host_record_count(num_hosts, h)
                  for h in range(max(1, int(num_hosts)))]
        return min(counts) // max(1, int(local_batch))

    # -- epoch order -----------------------------------------------------------
    @staticmethod
    def epoch_order(entries, seed, epoch, shuffle=True):
        """The epoch's sample order over ``entries`` — a pure function
        of ``(seed, epoch)`` (numpy ``SeedSequence`` keyed on both), so
        any position in it can be re-derived after a restart without
        replaying reads."""
        n = len(entries)
        if not shuffle:
            return list(range(n))
        rng = _np.random.default_rng(
            _np.random.SeedSequence((int(seed), int(epoch))))
        return list(rng.permutation(n))

    def describe(self):
        return {"shards": [s.path for s in self.shards],
                "records": self.total_records,
                "per_shard": [len(s) for s in self.shards]}


def _batchify(samples):
    """Stack decoded samples ((a, b, ...) tuples of numpy arrays) into
    a tuple of batch arrays; f64 narrows to f32 like the gluon
    default_batchify_fn."""
    first = samples[0]
    if not isinstance(first, (tuple, list)):
        samples = [(s,) for s in samples]
        first = samples[0]
    out = []
    for col in range(len(first)):
        arr = _np.stack([_np.asarray(s[col]) for s in samples], axis=0)
        if arr.dtype == _np.float64:
            arr = arr.astype(_np.float32)
        out.append(arr)
    return tuple(out)


class ReaderPool:
    """Ordered multi-threaded batch reader over one host's shard
    slice.  ``next_batch()`` returns ``(batch_index, np_batch_tuple,
    sample_ids)`` strictly in order; ``start_batch`` fast-forwards an
    epoch resume without reading a single skipped record."""

    def __init__(self, shard_set, entries, order, local_batch,
                 num_workers, decode_fn=None, start_batch=0,
                 max_batches=None, readahead=4, epoch=0):
        self._set = shard_set
        self._entries = entries
        self._order = order
        self._batch = int(local_batch)
        self._decode = decode_fn or default_decode
        self._epoch = int(epoch)
        n_batches = len(order) // self._batch
        if max_batches is not None:
            n_batches = min(n_batches, int(max_batches))
        self._n_batches = n_batches
        self._next_emit = int(start_batch)
        self._readahead = max(1, int(readahead))
        self._done = {}                       # batch idx -> (payload, ids, err)
        self._cond = threading.Condition()
        self._stop = False
        self._workers = []
        self._read_counts = {}                # worker id -> records read
        nw = max(1, int(num_workers))
        for w in range(nw):
            t = threading.Thread(
                target=self._worker_loop,
                args=(w, nw, int(start_batch)),
                name="mx-data-reader-%d" % w, daemon=True)
            t.start()
            self._workers.append(t)

    # -- worker side -----------------------------------------------------------
    def _batch_entries(self, b):
        lo = b * self._batch
        return [self._entries[self._order[i]]
                for i in range(lo, lo + self._batch)]

    def _read_one(self, handles, si, pos):
        shard = self._set.shards[si]
        h = handles.get(si)
        if h is None:
            h = handles[si] = open(shard.path, "rb")
        return read_record_at(h, shard.offsets[pos])

    def _build_batch(self, handles, b):
        """Read, decode and batchify batch ``b``, with the bounded IO
        retry loop around the read phase (the ``data_read`` fault site
        fires there, keyed by batch index)."""
        entries = self._batch_entries(b)
        ids = _np.asarray([self._set.global_id(si, pos)
                           for si, pos in entries], dtype=_np.int64)
        delay = _RETRY_SLEEP
        for attempt in range(_READ_RETRIES):
            t0 = _time.perf_counter()
            try:
                _inject.fire("data_read", seq=b)
                raws = [self._read_one(handles, si, pos)
                        for si, pos in entries]
                break

            except OSError:
                # a storage hiccup: reopen the handles and retry with
                # backoff
                for h in handles.values():
                    try:
                        h.close()
                    except OSError:
                        pass
                handles.clear()
                if _tel.ENABLED:
                    _tel.DATA_READ_RETRIES.inc()
                if attempt == _READ_RETRIES - 1:
                    raise
                _time.sleep(delay)
                delay *= 2
        if _tel.ENABLED:
            _tel.DATA_READ_SECONDS.observe(_time.perf_counter() - t0)
        t1 = _time.perf_counter()
        samples = [self._decode(raw) for raw in raws]
        batch = _batchify(samples)
        if _tel.ENABLED:
            _tel.DATA_DECODE_SECONDS.observe(_time.perf_counter() - t1)
            _tel.DATA_RECORDS.inc(len(raws))
        return batch, ids

    def _worker_loop(self, w, nw, start_batch):
        handles = {}
        # worker w owns batch indices congruent to (start + w) mod nw
        b = start_batch + w
        try:
            while True:
                if b >= self._n_batches:
                    return
                with self._cond:
                    # backpressure: never run further than `readahead`
                    # batches past the consumer (the prefetch ring
                    # downstream bounds device residency the same way)
                    while not self._stop and \
                            b >= self._next_emit + self._readahead:
                        self._cond.wait(0.2)
                    if self._stop:
                        return
                err = payload = ids = None
                try:
                    with _trace.span("data_read_batch", hist=False,
                                     cat="data", args={"batch": b}):
                        payload, ids = self._build_batch(handles, b)
                except Exception as exc:  # noqa: BLE001 — surfaced at next()
                    err = exc
                with self._cond:
                    if self._stop:
                        return
                    self._done[b] = (payload, ids, err)
                    self._read_counts[w] = \
                        self._read_counts.get(w, 0) + self._batch
                    self._cond.notify_all()
                b += nw
        finally:
            for h in handles.values():
                try:
                    h.close()
                except OSError:
                    pass

    # -- consumer side -----------------------------------------------------------
    @property
    def n_batches(self):
        return self._n_batches

    def next_batch(self, timeout=120.0):
        """The next in-order ``(index, batch, ids)``, or None at epoch
        end.  Worker exceptions re-raise here."""
        with self._cond:
            b = self._next_emit
            if b >= self._n_batches:
                return None
            deadline = _time.monotonic() + timeout
            while b not in self._done:
                if self._stop:
                    return None
                if not self._cond.wait(0.2):
                    if _time.monotonic() > deadline:
                        raise MXNetError(
                            "data reader timed out after %.0fs waiting "
                            "for batch %d (workers alive: %d)"
                            % (timeout, b,
                               sum(t.is_alive() for t in self._workers)))
            payload, ids, err = self._done.pop(b)
            self._next_emit = b + 1
            self._cond.notify_all()
        if err is not None:
            raise err
        return b, payload, ids

    def stop(self):
        with self._cond:
            self._stop = True
            self._done.clear()
            self._cond.notify_all()
        for t in self._workers:
            t.join(timeout=2.0)

    def read_counts(self):
        with self._cond:
            return dict(self._read_counts)
