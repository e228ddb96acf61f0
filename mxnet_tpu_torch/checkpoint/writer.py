"""Background commit thread for async checkpoint saves.

Counterpart of ``mxnet_tpu/checkpoint/writer.py`` (no backend in it).

One daemon worker drains a FIFO queue, so commits (and the retention
GC that follows each) are strictly serialized even when the training
loop fires saves faster than storage drains them.  ``max_inflight``
bounds the queue: ``submit`` blocks once that many saves are pending —
deliberate backpressure instead of unbounded host-memory growth, since
every queued save pins a full host snapshot of the tree.
"""
from __future__ import annotations

import queue
import threading

from .. import telemetry

__all__ = ["SaveFuture", "AsyncWriter"]


class SaveFuture:
    """Handle to one async save.  ``result()`` blocks until the commit
    lands and returns the final checkpoint path (re-raising any commit
    failure); ``done()``/``exception()`` poll without blocking."""

    __slots__ = ("step", "_event", "_path", "_exc", "_observed")

    def __init__(self, step):
        self.step = step
        self._event = threading.Event()
        self._path = None
        self._exc = None
        self._observed = False

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                "checkpoint save for step %d still committing" % self.step)
        self._observed = True
        if self._exc is not None:
            raise self._exc
        return self._path

    def exception(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                "checkpoint save for step %d still committing" % self.step)
        self._observed = True
        return self._exc

    def _finish(self, path=None, exc=None):
        self._path, self._exc = path, exc
        self._event.set()


class AsyncWriter:
    """Single background thread running ``commit_fn(step, payload)`` per
    submitted save, FIFO, with at most ``max_inflight`` pending.  The
    worker exits after ``idle_timeout`` seconds without work (and is
    respawned on the next submit), so short-lived managers — one per
    ``Trainer.save_checkpoint`` call — don't each leak a parked
    thread."""

    _IDLE_TIMEOUT = 5.0
    # done-but-never-collected failures kept for a later wait() to
    # re-raise; older ones beyond this are dropped (oldest first)
    _MAX_UNOBSERVED_FAILURES = 16

    def __init__(self, commit_fn, max_inflight=2):
        self._commit_fn = commit_fn
        self._slots = threading.BoundedSemaphore(max(1, int(max_inflight)))
        self._queue = queue.Queue()
        self._lock = threading.Lock()
        self._thread = None
        self._pending = []
        self._last_path = None

    def submit(self, step, payload):
        self._slots.acquire()  # backpressure: bounded in-flight saves
        fut = SaveFuture(step)
        # latch the flag so a telemetry enable/disable between submit
        # and completion can't skew the gauge (inc and dec must pair)
        counted = telemetry.ENABLED
        if counted:
            telemetry.CHECKPOINT_QUEUE_DEPTH.inc()
        # enqueue + thread liveness check under one lock so the idle
        # worker can't exit between seeing an empty queue and this put
        with self._lock:
            # prune failures the caller already collected via result()/
            # exception() — without this a loop that handles its own
            # errors but never calls wait() grows _pending unboundedly —
            # and cap unobserved failures so fire-and-forget callers
            # that never look at any future stay bounded too
            pending = [f for f in self._pending
                       if not (f.done() and f._observed)]
            failed = [f for f in pending if f.done()]
            for f in failed[:-self._MAX_UNOBSERVED_FAILURES]:
                pending.remove(f)
            self._pending = pending
            self._pending.append(fut)
            self._queue.put((fut, step, payload, counted))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="mx-checkpoint-writer")
                self._thread.start()
        return fut

    def _loop(self):
        while True:
            try:
                fut, step, payload, counted = self._queue.get(
                    timeout=self._IDLE_TIMEOUT)
            except queue.Empty:
                with self._lock:
                    if self._queue.empty():
                        self._thread = None
                        return
                continue
            try:
                path = self._commit_fn(step, payload)
                with self._lock:
                    self._last_path = path
                fut._finish(path=path)
                # successful saves need no later acknowledgement
                with self._lock:
                    try:
                        self._pending.remove(fut)
                    except ValueError:
                        pass
            except BaseException as exc:  # delivered via fut.result()
                fut._finish(exc=exc)
            finally:
                if counted:
                    telemetry.CHECKPOINT_QUEUE_DEPTH.dec()
                self._slots.release()
                self._queue.task_done()

    def wait(self):
        """Drain the queue; re-raise the first failure nobody collected
        via ``result()``/``exception()`` yet.  Returns the most recently
        committed path (None when nothing ever committed)."""
        with self._lock:
            pending = list(self._pending)
        first_exc = None
        for fut in pending:
            observed = fut._observed
            exc = fut.exception()
            if exc is not None:
                if not observed and first_exc is None:
                    first_exc = exc
                with self._lock:
                    try:
                        self._pending.remove(fut)
                    except ValueError:
                        pass
        if first_exc is not None:
            raise first_exc
        self._queue.join()
        with self._lock:
            return self._last_path
