"""Server: the mx.serve front-end.

Counterpart of ``mxnet_tpu/serve/server.py``: thread-safe ``submit()`` /
``submit_async()`` (futures) over one ``BatchQueue`` + ``Scheduler`` and one
``ModelRunner``, with graceful drain on ``shutdown()``, per-bucket circuit
breakers, ``stats()`` and ``swap()``, the hot swap to another checkpoint
step: a new runner is built from a fresh block of the factory, restored and
warmed, then published with one reference assignment; the scheduler reads
the runner once a batch, so batches in flight finish on the old model and
every batch dispatched after the swap runs on the new one.

Not ported yet (each is queued in ROADMAP.md): the decode plane
(``decode=``) and tenancy (``tenant=``), fleet registration, the HTTP
endpoint (``start_http``) and the preemption drain hook.
"""
from __future__ import annotations

import threading
import time
import weakref

import numpy as _np

from .. import telemetry
from ..base import get_env
from ..gluon.block import Block
from .batching import BatchQueue, Request, Scheduler, ServeError, ServerClosed
from .breaker import BreakerBoard
from .runner import DEFAULT_BATCH_SIZES, ModelRunner

__all__ = ["ServeConfig", "Server"]


class ServeConfig:
    """Batching-policy + bucket-spec knobs.

    max_batch_size : dispatch as soon as this many same-bucket requests
        are queued (clamped to the largest batch bucket).
    max_wait_us : how long an incomplete batch waits for stragglers.
    queue_depth : bound on queued requests; beyond it submissions are
        rejected with ``ServerOverloaded``.
    timeout_ms : default per-request deadline (None = no deadline).
    batch_sizes : batch-dim padding targets (default: powers of two up to
        ``max_batch_size``).
    sample_shapes : per-request shape buckets -- shape tuples
        (single-input) or tuples of per-input shapes.  None = exact shapes.
    dtype : request arrays are cast to this dtype.
    breaker_threshold : consecutive failed dispatches that open a bucket's
        circuit breaker (``MXNET_SERVE_BREAKER_THRESHOLD``, default 5;
        <= 0 disables breakers).
    breaker_cooldown_s : quarantine seconds before the half-open trial
        (``MXNET_SERVE_BREAKER_COOLDOWN``, default 30).
    """

    def __init__(self, max_batch_size=8, max_wait_us=2000, queue_depth=64,
                 timeout_ms=None, batch_sizes=None, sample_shapes=None,
                 dtype="float32", breaker_threshold=None,
                 breaker_cooldown_s=None):
        self.max_batch_size = int(max_batch_size)
        self.max_wait_us = int(max_wait_us)
        self.queue_depth = int(queue_depth)
        self.timeout_ms = timeout_ms
        self.breaker_threshold = get_env(
            "MXNET_SERVE_BREAKER_THRESHOLD", int, 5) \
            if breaker_threshold is None else int(breaker_threshold)
        self.breaker_cooldown_s = get_env(
            "MXNET_SERVE_BREAKER_COOLDOWN", float, 30.0) \
            if breaker_cooldown_s is None else float(breaker_cooldown_s)
        if batch_sizes is None:
            batch_sizes = [b for b in DEFAULT_BATCH_SIZES
                           if b <= self.max_batch_size]
            while batch_sizes and batch_sizes[-1] < self.max_batch_size:
                batch_sizes.append(min(batch_sizes[-1] * 2,
                                       self.max_batch_size))
            batch_sizes = batch_sizes or [self.max_batch_size]
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        self.sample_shapes = sample_shapes
        self.dtype = dtype
        self.max_batch_size = min(self.max_batch_size, self.batch_sizes[-1])

    def as_dict(self):
        return {
            "max_batch_size": self.max_batch_size,
            "max_wait_us": self.max_wait_us,
            "queue_depth": self.queue_depth,
            "timeout_ms": self.timeout_ms,
            "batch_sizes": list(self.batch_sizes),
            "sample_shapes": self.sample_shapes,
            "dtype": self.dtype,
            "breaker_threshold": self.breaker_threshold,
            "breaker_cooldown_s": self.breaker_cooldown_s,
        }


class Server:
    """Dynamic-batching inference server over one ModelRunner.

    ``Server(block, root=None, step=None, ctx=None, config=None)`` (the
    JAX package's order) builds the runner on ``ctx`` (default ``gpu(0)``,
    which raises where there is no card: pass ``ctx=mx.cpu()`` to serve on
    the CPU), restores checkpoint ``step`` of ``root`` when given, and
    warms every bucket; ``runner=`` takes a pre-built runner instead.
    ``block`` may be a zero-argument factory, which ``swap()`` needs."""

    def __init__(self, block=None, root=None, step=None, ctx=None,
                 config=None, runner=None):
        self._config = config or ServeConfig()
        self._ctx = ctx
        # the factory, not just the instance: swap() builds a fresh block,
        # since loading new weights into the live one would be seen
        # mid-load
        self._block_factory = block if block is not None and \
            not isinstance(block, Block) and callable(block) else None
        if runner is None:
            if block is None:
                raise ValueError("Server needs a block (or factory) or a "
                                 "pre-built runner")
            runner = ModelRunner(
                block, root=root, step=step, ctx=ctx,
                batch_sizes=self._config.batch_sizes,
                sample_shapes=self._config.sample_shapes,
                dtype=self._config.dtype)
        self._runner = runner
        self._root = root if root is not None \
            else getattr(runner, "root", None)
        self._swap_lock = threading.Lock()
        self._breakers = BreakerBoard(
            self._config.breaker_threshold,
            self._config.breaker_cooldown_s) \
            if self._config.breaker_threshold > 0 else None
        self._queue = BatchQueue(self._config.queue_depth)
        # the scheduler thread holds the server WEAKLY: a Server dropped
        # without shutdown() stays collectable, and its loop winds down
        ref = weakref.ref(self)

        def _current_runner():
            srv = ref()
            return None if srv is None else srv._runner

        self._scheduler = Scheduler(
            self._queue, _current_runner,
            max_batch_size=self._config.max_batch_size,
            max_wait_us=self._config.max_wait_us, breakers=self._breakers)
        self._scheduler.start()
        self._closed = False

    @property
    def config(self):
        return self._config

    @property
    def runner(self):
        return self._runner

    @property
    def step(self):
        """The checkpoint step being served (None without a root)."""
        return getattr(self._runner, "step", None)

    def healthy(self):
        """Liveness: the dispatch loop is running."""
        return not self._closed and self._scheduler.alive

    def ready(self):
        """Readiness: healthy AND every bucket warmed."""
        return self.healthy() and self._runner.warmed

    def breakers(self):
        """{bucket_label: breaker state}."""
        return self._breakers.snapshot() \
            if self._breakers is not None else {}

    def queue_depth(self):
        return len(self._queue)

    def stats(self):
        by_result = {}
        req = telemetry.get_metric("serve_requests_total")
        for values, child in req._samples():
            if values:
                by_result[values[0]] = child.value
        return {
            "ready": self.ready(),
            "healthy": self.healthy(),
            "queue_depth": self.queue_depth(),
            "config": self._config.as_dict(),
            "runner": self._runner.stats(),
            "requests": by_result,
            "totals": {k: v for k, v in telemetry.totals().items()
                       if k.startswith("serve_")},
            "breakers": self.breakers(),
        }

    def _normalize(self, inputs):
        """-> (tuple of numpy arrays, single_flag).  A tuple means
        multi-input; anything else is one input."""
        single = not isinstance(inputs, tuple)
        seq = (inputs,) if single else inputs
        return tuple(_np.asarray(x, dtype=self._config.dtype)
                     for x in seq), single

    def submit_async(self, inputs, timeout_ms=None, request_id=None):
        """Enqueue one request; returns a ``concurrent.futures.Future``
        resolving to the (unpadded) model output.  Raises
        ``ServerOverloaded`` when the queue is full, ``NoBucketError`` when
        no shape bucket covers the input, ``ServerClosed`` after
        shutdown."""
        if self._closed:
            raise ServerClosed("server is shut down")
        arrays, single = self._normalize(inputs)
        cls = self._runner.bucket_for(tuple(a.shape for a in arrays))
        if self._breakers is not None and self._breakers.blocked(cls):
            if telemetry.ENABLED:
                telemetry.SERVE_REQUESTS.labels(result="quarantined").inc()
            raise self._breakers.quarantine_error(cls)
        timeout_ms = self._config.timeout_ms if timeout_ms is None \
            else timeout_ms
        deadline = None if timeout_ms is None \
            else time.perf_counter() + float(timeout_ms) / 1e3
        req = Request(arrays, cls, deadline=deadline, single=single,
                      request_id=request_id)
        self._queue.put(req)
        return req.future

    def submit(self, inputs, timeout_ms=None, request_id=None):
        """Synchronous ``submit_async``: blocks for the result."""
        return self.submit_async(inputs, timeout_ms=timeout_ms,
                                 request_id=request_id).result()

    def swap(self, root=None, step=None, block=None):
        """Repoint serving at checkpoint ``step`` (default the latest
        committed) of ``root`` (default the serving root), atomically.

        Builds a new runner from a fresh block (``block``, or the factory
        the server was built with), restores the step, warms every
        bucket, then replaces the runner reference under the swap lock.
        Batches in flight finish on the old model; batches dispatched
        after the swap run on the new one.  Returns the restored step."""
        with self._swap_lock:
            factory = block if block is not None else self._block_factory
            if factory is None:
                raise ServeError(
                    "hot swap needs a fresh block: construct the Server "
                    "with a block FACTORY (callable), or pass block= "
                    "here -- reloading params into the live block would "
                    "not be atomic")
            root = self._root if root is None else root
            if root is None:
                raise ServeError("hot swap needs a checkpoint root")
            new_runner = ModelRunner(
                factory, root=root, step=step, ctx=self._ctx,
                batch_sizes=self._config.batch_sizes,
                sample_shapes=self._config.sample_shapes,
                dtype=self._config.dtype)
            self._runner = new_runner  # the atomic publication point
            self._root = root
            if telemetry.ENABLED:
                telemetry.SERVE_SWAPS.inc()
            return new_runner.step

    def shutdown(self, drain=True, timeout=None):
        """Stop intake and join the scheduler.  With ``drain`` (default)
        queued requests are served first; ``drain=False`` fails them with
        ``ServerClosed``.  Returns True when the loop has stopped."""
        self._closed = True
        return self._scheduler.stop(drain=drain, timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

