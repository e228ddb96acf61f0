"""StreamLoader: the streaming input pipeline's front end.

Counterpart of ``mxnet_tpu/data/loader.py``.  It ties together a
:class:`~.reader.ShardSet` sliced by this host's coordinates
(``world_coords``), a :class:`~.reader.ReaderPool` of reader threads and a
:class:`~.ring.PrefetchRing` staging the next K batches onto the current
context (the card, through page-locked slots and a side stream) while the
current step runs.  Iterating yields staged batches (tuples of NDArrays)
for the rest of the current epoch; the epoch counter then advances and the
next ``iter()`` starts the next epoch's differently shuffled stream.

``state_dict()`` is the reader cursor: seed, epoch and batches consumed
(batches still staged in the ring are read again after a restore, never
skipped).  The epoch order is a pure function of ``(seed, epoch)``, so a
restart resumes the exact remaining sample order.

The ring depth and reader count left unset come from the ``data_prefetch``
autotune site (a structural site: they change overlap, never the sample
stream) when autotune is on, else from ``MXNET_DATA_PREFETCH`` and
``MXNET_DATA_WORKERS`` (2 and 2 by default).

A preemption (``resilience.preempt.graceful_shutdown``) quiesces the
loader's reader and stager threads through a drain hook held weakly; the
cursor survives.  Not ported: a ``mesh`` (sharded placement,
``ROADMAP.md`` Queue 1 item 7) raises.
"""
from __future__ import annotations

import os
import threading
import weakref

import numpy as _np

from .. import autotune
from .. import telemetry as _tel
from ..base import MXNetError, get_env
from ..context import current_context
from .reader import ReaderPool, ShardSet, world_coords
from .ring import PrefetchRing, default_depth, make_placer

__all__ = ["StreamLoader", "live_loaders", "default_workers"]

CURSOR_VERSION = 1

# live loaders (``data.state()``)
_LIVE = weakref.WeakSet()
_LIVE_LOCK = threading.Lock()


def live_loaders():
    with _LIVE_LOCK:
        return list(_LIVE)


def default_workers():
    """``MXNET_DATA_WORKERS`` reader threads per host."""
    return max(1, get_env("MXNET_DATA_WORKERS", int, 2))


def _tuned_prefetch(local_batch, sample_nbytes):
    """(depth, workers) from the ``data_prefetch`` autotune site, else the
    env defaults."""
    from .. import autotune

    default = {"depth": default_depth(), "workers": default_workers()}
    key = (int(local_batch), int(sample_nbytes))
    cfg = autotune.lookup("data_prefetch", key, default)
    try:
        return max(1, int(cfg["depth"])), max(1, int(cfg["workers"]))
    except (TypeError, KeyError, ValueError):
        autotune.fallback("invalid_config")
        return default["depth"], default["workers"]


class StreamLoader:
    """Sharded streaming loader with a prefetch ring on the card.

    Parameters
    ----------
    source : ShardSet, shard-glob pattern, path, or list of paths.
    batch_size : GLOBAL batch size (all hosts together); must divide
        by the host count.  Each host reads and stages only its
        ``batch_size / num_hosts`` slice.
    decode_fn : record bytes -> tuple of numpy arrays (default:
        ``reader.default_decode`` — IRHeader + npy/JPEG payload).
    shuffle / seed : per-epoch order (pure function of (seed, epoch)).
    mesh : must be None (sharded placement is not ported); staged
        batches land on the current context when iteration starts.
    num_workers / prefetch : reader threads and ring depth (default:
        ``MXNET_DATA_WORKERS`` and ``MXNET_DATA_PREFETCH``).
    num_hosts / host : world coordinates override (drills).
    """

    def __init__(self, source, batch_size, decode_fn=None, shuffle=True,
                 seed=0, mesh=None, num_workers=None, prefetch=None,
                 num_hosts=None, host=None, timeout=120.0):
        if isinstance(source, ShardSet):
            self._set = source
        elif isinstance(source, (list, tuple)):
            self._set = ShardSet(source)
        else:
            self._set = ShardSet.from_pattern(source)
        self.num_hosts, self.host = world_coords(num_hosts, host)
        if mesh is not None:
            raise MXNetError("StreamLoader(mesh=...): sharded placement is "
                             "not ported")
        self._mesh = None
        if int(batch_size) % self.num_hosts:
            raise MXNetError(
                "global batch_size %d does not divide across %d hosts"
                % (batch_size, self.num_hosts))
        self.batch_size = int(batch_size)
        self.local_batch = self.batch_size // self.num_hosts
        self._decode = decode_fn
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self._timeout = float(timeout)
        self._entries, self.assignment_mode = \
            self._set.assignment(self.num_hosts, self.host)
        self.batches_per_epoch = self._set.batches_per_epoch(
            self.num_hosts, self.local_batch)
        if self.batches_per_epoch < 1:
            raise MXNetError(
                "shard slice of host %d/%d holds %d records — not one "
                "local batch of %d" % (self.host, self.num_hosts,
                                       len(self._entries),
                                       self.local_batch))
        depth, workers = default_depth(), default_workers()
        if (num_workers is None or prefetch is None) and \
                autotune.is_enabled():
            depth, workers = _tuned_prefetch(
                self.local_batch,
                max(1, self._probe_sample_bytes()) if self._entries else 1)
        self.num_workers = workers if num_workers is None \
            else int(num_workers)
        self.prefetch = depth if prefetch is None else int(prefetch)
        if self.num_workers < 1 or self.prefetch < 1:
            raise MXNetError(
                "StreamLoader needs num_workers >= 1 and prefetch >= 1 "
                "(got %d/%d); the ring cannot be disabled, only "
                "shallowed" % (self.num_workers, self.prefetch))
        # cursor: next batch to CONSUME of the current epoch
        self.epoch = 0
        self.batch = 0
        self.samples_seen = 0
        self._pool = None
        self._ring = None
        self._lock = threading.Lock()
        self._stalls_total = 0      # accumulated across epoch rings
        self._staged_total = 0
        self._worker_records = {}
        self._order_cache = None    # (epoch, order) — one shuffle/epoch
        self.last_ids = None
        self._preempt_hook = "data_loader-%d" % id(self)
        self._install_preempt_hook()
        with _LIVE_LOCK:
            _LIVE.add(self)

    # -- resilience ------------------------------------------------------------
    def _install_preempt_hook(self):
        """SIGTERM mid-epoch must not leak reader/stager threads: the
        loader quiesces under ``resilience.preempt.graceful_shutdown``
        as ``serve.Server`` drains.  Held weakly: the hook must not keep
        a dropped loader alive."""
        from ..resilience import preempt as _preempt

        ref = weakref.ref(self)

        def _drain():
            ldr = ref()
            if ldr is not None:
                ldr.close()

        _preempt.add_shutdown_hook(self._preempt_hook, _drain)

    # -- lifecycle ------------------------------------------------------------
    def _probe_sample_bytes(self):
        """A shard's bytes over its records: the mean framed record size,
        the ``data_prefetch`` key's second number."""
        shard = self._set.shards[self._entries[0][0]]
        try:
            return os.path.getsize(shard.path) // max(1, len(shard))
        except OSError:
            return 1

    def _teardown(self):
        ring, pool = self._ring, self._pool
        self._ring = None
        self._pool = None
        if ring is not None:
            self._stalls_total += ring.stalls
            self._staged_total += ring.staged
            ring.stop()
        if pool is not None:
            for w, n in pool.read_counts().items():
                self._worker_records[w] = \
                    self._worker_records.get(w, 0) + n
            pool.stop()

    def close(self):
        """Stop workers and the stager; the cursor survives (a closed
        loader can be state_dict'ed and resumed)."""
        with self._lock:
            self._teardown()
        from ..resilience import preempt as _preempt

        _preempt.remove_shutdown_hook(self._preempt_hook)

    def __del__(self):
        try:
            self.close()   # threads and the preempt hook: no leaks
        except Exception:
            pass

    # -- iteration ------------------------------------------------------------
    def _epoch_order(self):
        """The current epoch's order, computed ONCE per epoch and
        reused by _spin_up and the cursor's derived shard/offset —
        state_dict() on a large slice must not pay an O(n log n)
        shuffle per checkpoint.  Caller holds the lock."""
        cache = self._order_cache
        if cache is None or cache[0] != self.epoch:
            cache = (self.epoch,
                     ShardSet.epoch_order(self._entries, self.seed,
                                          self.epoch, self.shuffle))
            self._order_cache = cache
        return cache[1]

    def _spin_up(self):
        order = self._epoch_order()
        pool = ReaderPool(
            self._set, self._entries, order, self.local_batch,
            self.num_workers, decode_fn=self._decode,
            start_batch=self.batch, max_batches=self.batches_per_epoch,
            readahead=self.prefetch + self.num_workers,
            epoch=self.epoch)
        ring = PrefetchRing(
            lambda: pool.next_batch(self._timeout),
            make_placer(ctx=current_context(), slots=self.prefetch + 1),
            depth=self.prefetch,
            name="epoch-%d" % self.epoch)
        self._pool, self._ring = pool, ring
        if _tel.ENABLED:
            _tel.DATA_RING_DEPTH.set(self.prefetch)

    def __iter__(self):
        """Yield the REMAINING device batches of the current epoch,
        then advance the epoch.  Each yielded item is the tuple of
        staged arrays (``last_ids`` holds the batch's sample ids)."""
        with self._lock:
            self._teardown()
            if self.batch >= self.batches_per_epoch:
                self.epoch += 1
                self.batch = 0
            self._spin_up()
            ring = self._ring
        try:
            while True:
                item = ring.next(self._timeout)
                if item is None:
                    break
                idx, staged, ids = item
                with self._lock:
                    # consumed == handed to the training loop; the
                    # cursor moves HERE, so batches still staged in
                    # the ring are re-read after a restore, never
                    # skipped
                    self.batch = idx + 1
                    self.samples_seen += self.local_batch
                    self.last_ids = ids
                yield staged
        finally:
            # also runs on GeneratorExit (consumer broke out early):
            # readers/stager must not keep streaming — the cursor
            # stays wherever consumption stopped, so a later iter()
            # or a checkpoint resume continues exactly there
            with self._lock:
                self._teardown()
                if self.batch >= self.batches_per_epoch:
                    self.epoch += 1
                    self.batch = 0

    def __len__(self):
        return self.batches_per_epoch

    # -- checkpointable cursor ----------------------------------------------
    def state_dict(self):
        """The reader cursor as a flat int tree (checkpoint leaves).
        ``shard_index``/``record_offset`` are the DERIVED coordinates
        of the next sample — operator-facing (diagnose), not needed to
        resume (epoch order is re-derived from seed+epoch)."""
        with self._lock:
            si, pos = self._next_entry()
            return {
                "version": CURSOR_VERSION,
                "seed": self.seed,
                "epoch": self.epoch,
                "batch": self.batch,
                "samples_seen": self.samples_seen,
                "shuffle": int(self.shuffle),
                "num_hosts": self.num_hosts,
                "host": self.host,
                "shard_index": si,
                "record_offset": pos,
            }

    def _next_entry(self):
        if not self._entries:
            return -1, -1
        order = self._epoch_order()
        i = self.batch * self.local_batch
        if i >= len(order):
            return -1, -1
        si, pos = self._entries[order[i]]
        return int(si), int(pos)

    def load_state_dict(self, tree):
        """Restore a cursor (values may be numpy scalars or 0-dim tensors
        from a checkpoint restore).  The world geometry must match — a
        resumed stream on different host coordinates would be a
        DIFFERENT stream, silently."""
        def _i(k, default=None):
            v = tree.get(k, default)
            if v is None:
                raise MXNetError("data cursor is missing %r" % k)
            return int(_np.asarray(v))

        if _i("version") != CURSOR_VERSION:
            raise MXNetError("data cursor version %d unsupported"
                             % _i("version"))
        if _i("num_hosts") != self.num_hosts or _i("host") != self.host:
            raise MXNetError(
                "data cursor was taken at host %d/%d, this loader is "
                "host %d/%d — shard slices differ, the stream cannot "
                "resume" % (_i("host"), _i("num_hosts"),
                            self.host, self.num_hosts))
        if bool(_i("shuffle")) != self.shuffle or _i("seed") != self.seed:
            raise MXNetError(
                "data cursor seed/shuffle (%d/%s) do not match this "
                "loader (%d/%s)" % (_i("seed"), bool(_i("shuffle")),
                                    self.seed, self.shuffle))
        with self._lock:
            self._teardown()
            self.epoch = _i("epoch")
            self.batch = _i("batch")
            self.samples_seen = _i("samples_seen", 0)
        if _tel.ENABLED:
            _tel.DATA_RESUMES.inc()

    def _merged_worker_records(self, pool):
        out = dict(self._worker_records)
        if pool is not None:
            for w, n in pool.read_counts().items():
                out[w] = out.get(w, 0) + n
        return out

    # -- introspection -----------------------------------------------------
    def stats(self):
        """A snapshot of the loader's state for diagnosis."""
        with self._lock:
            ring = self._ring
            pool = self._pool
            si, pos = self._next_entry()
            return {
                "shards": len(self._set),
                "records_total": self._set.total_records,
                "records_local": len(self._entries),
                "assignment": self.assignment_mode,
                "host": "%d/%d" % (self.host, self.num_hosts),
                "global_batch": self.batch_size,
                "local_batch": self.local_batch,
                "batches_per_epoch": self.batches_per_epoch,
                "workers": self.num_workers,
                "ring_depth": self.prefetch,
                "ring_occupancy": ring.occupancy() if ring else 0,
                "ring_staged": self._staged_total
                + (ring.staged if ring else 0),
                "ring_stalls": self._stalls_total
                + (ring.stalls if ring else 0),
                "worker_records": self._merged_worker_records(pool),
                "cursor": {"epoch": self.epoch, "batch": self.batch,
                           "shard_index": si, "record_offset": pos,
                           "samples_seen": self.samples_seen},
                "mesh": None,
            }
