"""DataLoader: batches of a Dataset, inline, from a thread pool, or from
worker processes over shared memory.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py``.  Where the batches
land: on the current context when iteration starts (the card, or the CPU
inside ``with mx.cpu():``), as the JAX package's land on its default
device, so a training loop never moves them.  Per-sample work stays on
the host (datasets and transforms yield host arrays) and a batch crosses
to the card in one copy.

- ``num_workers=0``: the inline path.
- ``thread_pool=True``: a thread pipeline; each batch is made inside a
  scope of the iteration's context.
- ``num_workers>0``: worker processes run decode, augment and batchify
  into numpy and publish each batch array in POSIX shared memory; only
  ``(name, shape, dtype)`` descriptors cross the result queue, and the
  parent copies each array out once and places it.  Workers start with
  ``forkserver`` by default: a forked child would inherit the parent's
  CUDA context, so they fork from a clean helper and hide the card
  (``CUDA_VISIBLE_DEVICES=''``) before the dataset is unpickled.  The
  dataset and a custom ``batchify_fn`` must then be picklable; where they
  are not, the loader warns and takes the thread pipeline, as the JAX
  package does, and ``route`` says so.

``route`` is ``'inline'``, ``'threads'`` or ``'processes'``: the path the
last ``iter()`` took.  A process iterator registers a preemption drain
hook (``resilience.preempt``), held weakly, that shuts its workers down.
"""
from __future__ import annotations

import multiprocessing as _mp
import pickle as _pickle
import queue as _queue
import threading
import time as _time
import warnings as _warnings

import numpy as _np

from ... import ndarray as nd
from ... import telemetry as _tel
from ...context import current_context
from ...ndarray.ndarray import NDArray
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch on the current context: NDArrays are
    stacked where they lie and the stack moved, anything else goes
    through numpy (float64 narrowed to float32)."""
    if isinstance(data[0], NDArray):
        return nd.stack(*data, axis=0).as_in_context(current_context())
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn(list(x)) for x in zip(*data))
    arr = _np.asarray(data)
    if arr.dtype == _np.float64:
        arr = arr.astype(_np.float32)
    return nd.array(arr)


def default_mp_batchify_fn(data):
    """Worker-side batchify: stack into numpy (the shared-memory publish
    is the transport's; the worker never touches the card)."""
    if isinstance(data[0], tuple):
        return tuple(default_mp_batchify_fn(list(x)) for x in zip(*data))
    if isinstance(data[0], NDArray):  # defensive: datasets should yield numpy
        data = [x.asnumpy() for x in data]
    arr = _np.asarray(data)
    if arr.dtype == _np.float64:
        arr = arr.astype(_np.float32)
    return arr


# ---------------------------------------------------------------------------
# shared-memory transport
# ---------------------------------------------------------------------------

def _shm_encode(obj, segments):
    """Recursively replace numpy arrays with shared-memory descriptors.

    Each array becomes one POSIX shm segment written exactly once in the
    worker; the descriptor (name, shape, dtype) is all that crosses the
    queue.  ``segments`` collects the open handles so the worker can
    close them after the parent acks implicitly (unlink is parent-side).
    """
    from multiprocessing import shared_memory

    if isinstance(obj, NDArray):
        # custom batchify_fns written for the inline path may return
        # device arrays; pull them host-side so they still ride shm
        obj = obj.asnumpy()
    if isinstance(obj, _np.ndarray):
        # dtype crosses as its own pickle: dtype.str does NOT round-trip
        # extension dtypes (bfloat16/float8 stringify as raw-void '<V2')
        dt = _pickle.dumps(obj.dtype)
        if obj.nbytes == 0:
            return ("npz", obj.shape, dt)
        seg = shared_memory.SharedMemory(create=True, size=obj.nbytes)
        dst = _np.ndarray(obj.shape, dtype=obj.dtype, buffer=seg.buf)
        dst[...] = obj
        segments.append(seg)
        return ("shm", seg.name, obj.shape, dt)
    if isinstance(obj, (list, tuple)):
        items = [_shm_encode(x, segments) for x in obj]
        if hasattr(obj, "_fields"):          # namedtuple
            return type(obj)(*items)
        return type(obj)(items)
    if isinstance(obj, dict):
        return {k: _shm_encode(v, segments) for k, v in obj.items()}
    return ("raw", _pickle.dumps(obj))


def _release_segment(seg):
    seg.close()
    try:
        seg.unlink()
    except FileNotFoundError:
        pass


def _shm_decode(obj, to_device):
    """Parent-side inverse: map each segment, copy it out to a heap numpy
    array, unlink, then hand the copy to ``to_device``.  The copy ends
    the array's tie to the segment, which is unmapped and unlinked at
    once: a CPU tensor made from the array (``torch.from_numpy`` shares
    its memory) must not outlive the mapping."""
    from multiprocessing import shared_memory

    if isinstance(obj, tuple) and obj and obj[0] == "shm":
        _, name, shape, dtype = obj
        seg = shared_memory.SharedMemory(name=name)
        if to_device is None:               # discard path: unlink only
            _release_segment(seg)
            return None
        try:
            arr = _np.ndarray(shape, dtype=_pickle.loads(dtype),
                              buffer=seg.buf).copy()
        finally:
            _release_segment(seg)
        return to_device(arr)
    if isinstance(obj, tuple) and obj and obj[0] == "npz":
        if to_device is None:
            return None
        return to_device(_np.empty(obj[1], dtype=_pickle.loads(obj[2])))
    if isinstance(obj, tuple) and obj and obj[0] == "raw":
        return _pickle.loads(obj[1])
    if isinstance(obj, (list, tuple)):
        items = [_shm_decode(x, to_device) for x in obj]
        if hasattr(obj, "_fields"):          # namedtuple
            return type(obj)(*items)
        return type(obj)(items)
    if isinstance(obj, dict):
        return {k: _shm_decode(v, to_device) for k, v in obj.items()}
    return obj


def _worker_loop(state_bytes, key_queue, data_queue):
    """Worker process body: pulls ``(batch_idx, indices)``, loads and
    batchifies to numpy, publishes through shared memory.  The card is
    hidden before the dataset is unpickled (it arrives as our own pickle,
    ``state_bytes``), so neither it nor a custom batchify can open a
    CUDA context in the worker; the worker's arrays are host arrays."""
    import os

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    dataset, batchify_fn = _pickle.loads(state_bytes)
    from ...context import cpu

    cpu().__enter__()   # NDArrays a custom batchify makes stay on the host
    while True:
        item = key_queue.get()
        if item is None:
            break
        idx, indices = item
        segments = []
        try:
            batch = batchify_fn([dataset[i] for i in indices])
            payload = _shm_encode(batch, segments)
            data_queue.put((idx, payload, None))
            for seg in segments:
                seg.close()
        except Exception as exc:  # noqa: BLE001 - surfaced in parent
            import traceback

            for seg in segments:  # partial-batch segments must not leak
                _release_segment(seg)
            data_queue.put((idx, None, "".join(
                traceback.format_exception(type(exc), exc,
                                           exc.__traceback__))))


class _MultiWorkerIter:
    """Ordered multi-process iterator: issue up to ``prefetch`` batches
    ahead, reorder completions by batch index, re-issue as batches
    drain."""

    def __init__(self, state_bytes, batch_sampler, num_workers,
                 prefetch, timeout, mp_ctx, to_device):
        self._shutdown = False  # first: __del__ runs even if init fails
        self._workers = []
        self._batches = iter(batch_sampler)
        self._timeout = timeout
        self._to_device = to_device
        ctx = _mp.get_context(mp_ctx)
        self._key_queue = ctx.Queue()
        self._data_queue = ctx.Queue()
        for _ in range(num_workers):
            w = ctx.Process(target=_worker_loop,
                            args=(state_bytes, self._key_queue,
                                  self._data_queue),
                            daemon=True)
            w.start()
            self._workers.append(w)
        self._sent = 0
        self._rcvd = 0
        self._reorder = {}
        # SIGTERM mid-epoch (resilience.preempt) must not leak worker
        # processes: a drain hook as serve.Server's, held weakly so that
        # it does not keep a finished iterator (and its workers) alive
        import weakref

        from ...resilience import preempt as _preempt

        self._hook_name = "gluon_dataloader-%d" % id(self)
        ref = weakref.ref(self)

        def _drain():
            it = ref()
            if it is not None:
                it.shutdown()

        _preempt.add_shutdown_hook(self._hook_name, _drain)
        for _ in range(prefetch):
            self._issue()

    def _issue(self):
        indices = next(self._batches, None)
        if indices is None:
            return False
        self._key_queue.put((self._sent, indices))
        self._sent += 1
        return True

    def __iter__(self):
        return self

    def __next__(self):
        if self._rcvd >= self._sent:
            self.shutdown()
            raise StopIteration
        # latch the flag: enabling telemetry mid-fetch must not observe
        # perf_counter() against a 0.0 sentinel (~process uptime)
        tel_on = _tel.ENABLED
        t0 = _time.perf_counter() if tel_on else 0.0
        while self._rcvd not in self._reorder:
            try:
                idx, payload, err = self._data_queue.get(
                    timeout=min(2.0, self._timeout))
            except _queue.Empty:
                dead = [w for w in self._workers if not w.is_alive()]
                if dead:
                    codes = [w.exitcode for w in dead]
                    self.shutdown()
                    raise RuntimeError(
                        f"DataLoader worker(s) died with exit codes "
                        f"{codes} (OOM-killed workers exit -9; unpicklable "
                        "datasets fail at startup)") from None
                self._waited = getattr(self, "_waited", 0.0) + 2.0
                if self._waited < self._timeout:
                    continue
                self.shutdown()
                raise RuntimeError(
                    f"DataLoader worker timed out after {self._timeout}s "
                    "(raise `timeout` for slow transforms)") from None
            self._waited = 0.0
            self._reorder[idx] = (payload, err)
        payload, err = self._reorder.pop(self._rcvd)
        self._rcvd += 1
        self._issue()
        if err is not None:
            self.shutdown()
            raise RuntimeError(f"DataLoader worker failed:\n{err}")
        if tel_on:
            # time the consumer spent blocked on workers = loader stall
            _tel.DATALOADER_WAIT_SECONDS.observe(_time.perf_counter() - t0)
        return _shm_decode(payload, self._to_device)

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        if getattr(self, "_hook_name", None) is not None:
            from ...resilience import preempt as _preempt

            _preempt.remove_shutdown_hook(self._hook_name)
            self._hook_name = None
        try:

            # release segments of batches already reordered but unconsumed
            for payload, _err in self._reorder.values():
                if payload is not None:
                    _shm_decode(payload, None)
            self._reorder = {}
            for _ in self._workers:
                self._key_queue.put(None)
            # drain stragglers so their shm segments get unlinked; keep
            # draining while any worker is still finishing a batch
            deadline = _time.monotonic() + 5.0
            while True:
                try:
                    _, payload, _ = self._data_queue.get(timeout=0.2)
                    if payload is not None:
                        _shm_decode(payload, None)
                except (OSError, ValueError):
                    break
                except _queue.Empty:
                    busy = any(w.is_alive() for w in self._workers)
                    if not busy or _time.monotonic() > deadline:
                        break
            for w in self._workers:
                w.join(timeout=2.0)
                if w.is_alive():
                    w.terminate()
            # final non-blocking sweep: a batch published between the
            # last drain check and terminate() must still be unlinked
            while True:
                try:
                    _, payload, _ = self._data_queue.get_nowait()
                    if payload is not None:
                        _shm_decode(payload, None)
                except (_queue.Empty, OSError, ValueError):
                    break
        finally:
            self._workers = []

    def __del__(self):
        self.shutdown()


class DataLoader:
    """Batched loader over a Dataset (see the module docstring).

    ``mp_context`` picks the start method of the worker processes;
    'forkserver' by default, as ``mp_context='fork'`` is safe only
    before the card has been touched.
    """

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120, mp_context="forkserver"):
        self._dataset = dataset
        self._timeout = timeout
        self._thread_pool = thread_pool
        self._mp_context = mp_context
        self._state_bytes = None  # cached worker pickle (epochs 2+)
        self.route = None
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler "
                                 "is not given")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with sampler given")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._prefetch = max(1, prefetch if prefetch is not None
                             else 2 * max(1, self._num_workers))
        if batchify_fn is None:
            self._batchify_fn = default_batchify_fn
            self._mp_batchify_fn = default_mp_batchify_fn
        else:
            self._batchify_fn = batchify_fn
            self._mp_batchify_fn = batchify_fn

    def __len__(self):
        return len(self._batch_sampler)

    def _load_batch(self, indices, ctx):
        with ctx:
            return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        ctx = current_context()
        if self._num_workers == 0:
            self.route = "inline"
            for indices in self._batch_sampler:
                if _tel.ENABLED:
                    t0 = _time.perf_counter()
                    batch = self._load_batch(indices, ctx)
                    _tel.DATALOADER_WAIT_SECONDS.observe(
                        _time.perf_counter() - t0)
                    yield batch
                else:
                    yield self._load_batch(indices, ctx)
            return
        if not self._thread_pool:
            try:
                # pickle dataset+batchify OURSELVES: (a) unpicklability
                # surfaces here, narrowly, instead of as arbitrary worker
                # startup exceptions; (b) the worker unpickles after its
                # env pin (see _worker_loop); cached — epochs 2+ reuse it
                if self._state_bytes is None:
                    self._state_bytes = _pickle.dumps(
                        (self._dataset, self._mp_batchify_fn))
                state_bytes = self._state_bytes
            except Exception as exc:  # noqa: BLE001 - any pickling failure
                # unpicklable dataset/transform (closures, open file
                # handles): process workers need picklable state under
                # forkserver; the thread pipeline takes over (``route``)
                _warnings.warn(
                    "DataLoader: dataset/batchify_fn is not picklable "
                    f"({exc!r}); falling back to thread workers. Move "
                    "transforms to module level (or pass thread_pool=True "
                    "to silence this).", RuntimeWarning, stacklevel=2)
            else:
                self.route = "processes"
                yield from _MultiWorkerIter(
                    state_bytes, self._batch_sampler, self._num_workers,
                    self._prefetch, self._timeout, self._mp_context,
                    lambda a: nd.array(a, ctx=ctx))
                return
        # threaded prefetch pipeline (double buffering)
        self.route = "threads"
        q = _queue.Queue(maxsize=self._prefetch)
        sentinel = object()

        def producer():
            try:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(self._num_workers) as pool:
                    futures = []
                    for indices in self._batch_sampler:
                        futures.append(pool.submit(self._load_batch,
                                                   indices, ctx))
                        while len(futures) >= self._prefetch:
                            q.put(futures.pop(0).result())
                    for fut in futures:
                        q.put(fut.result())
            except Exception as exc:  # surface in consumer
                q.put(exc)
            q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            tel_on = _tel.ENABLED
            t0 = _time.perf_counter() if tel_on else 0.0
            item = q.get(timeout=self._timeout)
            if tel_on and item is not sentinel:
                _tel.DATALOADER_WAIT_SECONDS.observe(
                    _time.perf_counter() - t0)
            if item is sentinel:
                break
            if isinstance(item, Exception):
                raise item
            yield item
        thread.join()
