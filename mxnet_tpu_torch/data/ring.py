"""The prefetch ring: batches staged onto the card ahead of the step.

Counterpart of ``mxnet_tpu/data/ring.py``.  A stager thread pulls host
batches from a source (``ReaderPool.next_batch``) and stages the next K
of them into the card's memory while the current step runs, so the step
never waits on a host-to-device copy.

The placer (``make_placer``, a ``Placer`` on the card) writes each host
batch into page-locked staging buffers and copies them to the card with
``non_blocking`` copies on a side stream; ``Placer.stage`` lets a producer
write into the slot itself (``io.ImageRecordIter``'s loader does).  Three
rules keep that correct:

- each staging slot carries the event of its last copy, and the stager
  waits on it before refilling the slot, so a copy still in flight never
  sees a later batch's bytes;
- the consumer's stream waits on the copy's event before it uses a
  staged batch (``StagedBatch.wait``, which ``PrefetchRing.next`` calls
  in the consumer's thread);
- each staged tensor, allocated on the side stream, is marked used on the
  consumer's stream (``record_stream``), so the caching allocator does not
  hand its memory out again before the consumer's work on it is done.

Occupancy and stall counts show whether the ring keeps ahead: a steady
occupancy near the depth and a flat stall count mean the step never
waited; stalls mean reads or decode are the bottleneck, not the copy.
With ``mesh`` given, ``make_placer`` raises: sharded placement waits in
``ROADMAP.md`` Queue 1 item 7.
"""
from __future__ import annotations

import collections
import threading
import time as _time

import numpy as _np
import torch

from .. import telemetry as _tel
from .. import trace as _trace
from ..base import MXNetError, get_env
from ..context import current_context

__all__ = ["PrefetchRing", "StagedBatch", "Placer", "default_depth",
           "make_placer"]


def default_depth():
    """``MXNET_DATA_PREFETCH`` ring depth (batches staged ahead)."""
    return max(1, get_env("MXNET_DATA_PREFETCH", int, 2))


class StagedBatch(tuple):
    """A staged batch: a tuple of NDArrays, and on the card the event of
    their copy (``event``) and the tensors to mark used (``tensors``)."""

    event = None
    tensors = ()

    def wait(self):
        """Make the calling thread's current stream wait for the copy,
        and mark the tensors used on it."""
        if self.event is None:
            return
        stream = torch.cuda.current_stream(self.tensors[0].device)
        stream.wait_event(self.event)
        for t in self.tensors:
            t.record_stream(stream)


class _Slot:
    __slots__ = ("bufs", "done")

    def __init__(self):
        self.bufs = None
        self.done = None


class Placer:
    """Stages host batches onto ``device`` through ``slots`` page-locked
    buffer sets and a side stream; ``timing`` keeps an event pair around
    each copy (``copy_ms``)."""

    def __init__(self, device, slots=3, timing=False):
        self.device = device
        self._slots = [_Slot() for _ in range(max(1, int(slots)))]
        self._next = 0
        self._stream = torch.cuda.Stream(device)
        self._timing = timing
        self._events = []

    def stage(self, specs, fill):
        """Stage one batch through the next slot: wait until the slot's
        last copy has left it, give it page-locked buffers of ``specs``
        (``[(shape, dtype), ...]``), let ``fill(buffers)`` write the host
        values into them, and copy them to the card on the side stream.
        Returns ``(StagedBatch, fill's result)``, or None where ``fill``
        returns None (nothing to stage: the slot is left as it was)."""
        from ..ndarray.ndarray import NDArray

        slot = self._slots[self._next]
        if slot.done is not None:
            slot.done.synchronize()    # the slot's last copy has left it
        specs = [(tuple(shape), dtype) for shape, dtype in specs]
        if slot.bufs is None or [(tuple(b.shape), b.dtype)
                                 for b in slot.bufs] != specs:
            slot.bufs = [torch.empty(shape, dtype=dtype, pin_memory=True)
                         for shape, dtype in specs]
        info = fill(slot.bufs)
        if info is None:
            return None
        self._next = (self._next + 1) % len(self._slots)
        with torch.cuda.stream(self._stream):
            start = None
            if self._timing:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            out = [buf.to(self.device, non_blocking=True)
                   for buf in slot.bufs]
            done = torch.cuda.Event(enable_timing=self._timing)
            done.record()
        slot.done = done
        if start is not None:
            self._events.append((start, done))
        if _tel.ENABLED:
            _tel.TRANSFER_H2D.inc(sum(b.nbytes for b in slot.bufs))
        staged = StagedBatch(NDArray(t) for t in out)
        staged.event = done
        staged.tensors = tuple(out)
        return staged, info

    def __call__(self, host_batch):
        arrays = [torch.from_numpy(_np.ascontiguousarray(a))
                  if not isinstance(a, torch.Tensor) else a
                  for a in host_batch]

        def fill(bufs):
            for buf, a in zip(bufs, arrays):
                buf.copy_(a)
            return True

        return self.stage([(a.shape, a.dtype) for a in arrays], fill)[0]

    def copy_ms(self):
        """The device time of each timed copy so far (waits for them)."""
        out = []
        for start, done in self._events:
            done.synchronize()
            out.append(start.elapsed_time(done))
        return out


def make_placer(mesh=None, ctx=None, slots=3, timing=False):
    """The stage function host-batch-tuple -> ``StagedBatch`` of NDArrays
    on ``ctx`` (default the current context): on the card through
    page-locked slots and a side stream (see the module docstring), on
    the CPU a copy of each array."""
    if mesh is not None:
        raise MXNetError("make_placer(mesh=...): sharded placement is not "
                         "ported")
    ctx = ctx if ctx is not None else current_context()
    if ctx.device_type == "gpu":
        return Placer(ctx.torch_device, slots=slots, timing=timing)

    def place(host_batch):
        from .. import ndarray as nd

        nbytes = sum(_np.asarray(a).nbytes for a in host_batch)
        if _tel.ENABLED and nbytes:
            _tel.TRANSFER_H2D.inc(nbytes)
        return StagedBatch(nd.array(_np.asarray(a), ctx=ctx)
                           for a in host_batch)

    return place


class PrefetchRing:
    """Bounded ring of device-staged batches ahead of the consumer.

    ``source`` is a zero-arg callable returning ``(index, host_batch,
    ids)`` or None at the end of the stream (``ReaderPool.next_batch``);
    ``placer`` stages one host batch.  ``next()`` pops in order and makes
    the consumer's stream wait for the batch's copy; the time the
    consumer waited on an empty ring is a stall."""

    def __init__(self, source, placer, depth=None, name="ring"):
        self._source = source
        self._placer = placer
        self._depth = int(depth) if depth else default_depth()
        if self._depth < 1:
            raise MXNetError("prefetch ring depth must be >= 1")
        self._name = name
        self._buf = collections.deque()
        self._cond = threading.Condition()
        self._stop = False
        self._exhausted = False
        self._error = None
        self._ctx = None          # consumer trace ctx for stage spans
        self.staged = 0
        self.stalls = 0
        self._thread = threading.Thread(
            target=self._stage_loop, name="mx-data-stager", daemon=True)
        self._thread.start()

    # -- stager thread -----------------------------------------------------
    def _stage_loop(self):
        try:
            while True:
                with self._cond:
                    while not self._stop and len(self._buf) >= self._depth:
                        self._cond.wait(0.2)
                    if self._stop:
                        return
                    ctx = self._ctx
                item = self._source()
                if item is None:
                    break
                idx, host_batch, ids = item
                t0 = _time.perf_counter()
                # stage spans land under the consumer's trace
                with _trace.use(ctx):
                    with _trace.span("data_stage", hist=False, cat="data",
                                     args={"batch": int(idx)}):
                        staged = self._placer(host_batch)
                if _tel.ENABLED:
                    _tel.DATA_STAGE_SECONDS.observe(
                        _time.perf_counter() - t0)
                with self._cond:
                    if self._stop:
                        return
                    self._buf.append((idx, staged, ids))
                    self.staged += 1
                    if _tel.ENABLED:
                        _tel.DATA_RING_OCCUPANCY.set(len(self._buf))
                        _tel.DATA_BATCHES.inc()
                    self._cond.notify_all()
        except Exception as exc:  # noqa: BLE001 — surfaced at next()
            with self._cond:
                self._error = exc
                self._cond.notify_all()
        finally:
            with self._cond:
                self._exhausted = True
                self._cond.notify_all()

    # -- consumer -----------------------------------------------------------
    def next(self, timeout=120.0):
        """Pop the next staged ``(index, batch, ids)`` or None at the end
        of the stream.  Blocks (counted as a stall) when the ring is empty
        but the stream is not done."""
        tel_on = _tel.ENABLED
        t0 = _time.perf_counter()
        with self._cond:
            self._ctx = _trace.current()
            stalled = not self._buf and not self._exhausted \
                and self._error is None
            deadline = _time.monotonic() + timeout
            while not self._buf and not self._exhausted \
                    and self._error is None:
                if not self._cond.wait(0.2) and \
                        _time.monotonic() > deadline:
                    raise MXNetError(
                        "prefetch ring %r starved for %.0fs (readers "
                        "wedged?)" % (self._name, timeout))
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            if stalled:
                self.stalls += 1
                if tel_on:
                    _tel.DATA_RING_STALLS.inc()
            if not self._buf:
                if tel_on:
                    _tel.DATALOADER_WAIT_SECONDS.observe(
                        _time.perf_counter() - t0)
                return None
            item = self._buf.popleft()
            if tel_on:
                _tel.DATA_RING_OCCUPANCY.set(len(self._buf))
            self._cond.notify_all()
        wait = getattr(item[1], "wait", None)
        if wait is not None:
            wait()
        if tel_on:
            _tel.DATALOADER_WAIT_SECONDS.observe(
                _time.perf_counter() - t0)
        return item

    def occupancy(self):
        with self._cond:
            return len(self._buf)

    @property
    def depth(self):
        return self._depth

    def stop(self):
        with self._cond:
            self._stop = True
            self._buf.clear()
            self._cond.notify_all()
        self._thread.join(timeout=2.0)
        if _tel.ENABLED:
            _tel.DATA_RING_OCCUPANCY.set(0)
