"""Request queue + micro-batching scheduler for mx.serve.

Counterpart of ``mxnet_tpu/serve/batching.py``.  The serving hot path is a
single bounded FIFO (``BatchQueue``) drained by one ``Scheduler`` thread,
which coalesces concurrent single-sample requests into micro-batches: a
batch is dispatched as soon as ``max_batch_size`` requests of the SAME
bucket class are queued, or when the oldest of them has waited
``max_wait_us``.

Overload policy is explicit backpressure: a full queue REJECTS with
``ServerOverloaded`` immediately.  Each request carries an optional
deadline; expired requests fail with ``RequestTimeout`` before dispatch
and never reach the model.  Each dispatch is the ``serve_dispatch`` fault
site, and a request id the fault plan marks ``serve_poison`` fails its
batch until bisection pins it alone (``resilience/inject.py``).  Each
dispatch is a ``serve_dispatch`` scope of the hang watchdog
(``trace/watchdog.py``), and each request that fails its deadline feeds
the deadline-miss burst detector (``trace.anomaly.deadline_miss``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

from .. import telemetry, trace
from ..base import MXNetError
from ..resilience import inject as _inject
from ..resilience.inject import InjectedFault

__all__ = ["ServeError", "ServerOverloaded", "ServerClosed", "fail_request",
           "RequestTimeout", "NoBucketError", "BucketQuarantined",
           "Request", "BatchQueue", "Scheduler"]


class ServeError(MXNetError):
    """Root of mx.serve errors."""


class ServerOverloaded(ServeError):
    """The batch queue is full: the request was rejected, not queued."""


class ServerClosed(ServeError):
    """The server is shut down (or shutting down without drain)."""


class RequestTimeout(ServeError, TimeoutError):
    """The request's deadline expired before it was dispatched."""


class NoBucketError(ServeError, ValueError):
    """No configured shape bucket can hold the request's input shapes."""


class BucketQuarantined(ServeError):
    """The request's shape bucket is quarantined by an open circuit
    breaker; retry after ``retry_after`` seconds."""

    def __init__(self, msg, retry_after=None):
        super().__init__(msg)
        self.retry_after = retry_after


def fail_request(req, exc, result):
    """Resolve a request exceptionally (idempotent) + count the outcome."""
    try:
        req.future.set_exception(exc)
    except InvalidStateError:
        return
    if telemetry.ENABLED:
        telemetry.SERVE_REQUESTS.labels(result=result).inc()
    if trace.ENABLED and req.trace is not None:
        trace.record_span(
            "serve_request", req.enqueued,
            time.perf_counter() - req.enqueued, ctx=req.trace, root=True,
            cat="serve", args={"result": result,
                               "request_id": req.request_id})
    if result == "timeout":
        # deadline misses that cluster are the stalled backend's signature:
        # the burst detector dumps the flight record
        trace.anomaly.deadline_miss()


class Request:
    """One queued inference request.

    ``inputs`` is a tuple of numpy arrays (one per model input);
    ``bucket_class`` is the hashable bucket the runner assigned (only
    same-class requests are batched together); ``deadline`` is a
    ``time.perf_counter`` timestamp or None."""

    __slots__ = ("inputs", "single", "bucket_class", "future",
                 "enqueued", "deadline", "request_id", "trace")

    def __init__(self, inputs, bucket_class, deadline=None, single=True,
                 request_id=None):
        self.inputs = tuple(inputs)
        self.single = single
        self.bucket_class = bucket_class
        self.future = Future()
        self.enqueued = time.perf_counter()
        self.deadline = deadline
        self.request_id = request_id
        self.trace = trace.new_request(request_id)  # None when disabled
        if self.trace is not None:
            trace.instant("serve_enqueue", cat="serve", ctx=self.trace,
                          args={"request_id": request_id})

    def expired(self, now=None):
        return self.deadline is not None and \
            (time.perf_counter() if now is None else now) >= self.deadline


class BatchQueue:
    """Bounded FIFO with class-grouped batch collection.

    ``put`` never blocks: it raises ``ServerOverloaded`` when ``depth``
    requests are already queued and ``ServerClosed`` after ``close()``.
    ``collect`` blocks for the next micro-batch, expiring dead requests
    along the way, and returns None once the queue is closed AND
    drained."""

    def __init__(self, depth):
        self._depth = int(depth)
        self._items = deque()
        self._cond = threading.Condition()
        self._closed = False

    def __len__(self):
        return len(self._items)

    def put(self, req):
        with self._cond:
            if self._closed:
                raise ServerClosed("server is shut down")
            if len(self._items) >= self._depth:
                if telemetry.ENABLED:
                    telemetry.SERVE_REQUESTS.labels(result="rejected").inc()
                raise ServerOverloaded(
                    "batch queue full (%d queued, depth=%d): retry with "
                    "backoff" % (len(self._items), self._depth))
            self._items.append(req)
            if telemetry.ENABLED:
                telemetry.SERVE_QUEUE_DEPTH.set(len(self._items))
            self._cond.notify_all()

    def oldest_age(self):
        """Seconds the head-of-line request has waited (0.0 when empty)."""
        with self._cond:
            if not self._items:
                return 0.0
            return max(0.0, time.perf_counter() - self._items[0].enqueued)

    def close(self):
        """Stop accepting requests; ``collect`` drains what is queued."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def cancel_pending(self):
        """Fail every queued request with ServerClosed (abort path)."""
        with self._cond:
            items, self._items = list(self._items), deque()
            if telemetry.ENABLED:
                telemetry.SERVE_QUEUE_DEPTH.set(0)
            self._cond.notify_all()
        for req in items:
            fail_request(req, ServerClosed("server shut down before "
                                           "dispatch"), "cancelled")

    def _expire_locked(self):
        if not self._items:
            return
        now = time.perf_counter()
        dead = [r for r in self._items if r.expired(now)]
        if dead:
            self._items = deque(r for r in self._items if not r.expired(now))
            if telemetry.ENABLED:
                telemetry.SERVE_QUEUE_DEPTH.set(len(self._items))
            for req in dead:
                fail_request(req, RequestTimeout(
                    "deadline expired after %.1f ms in queue"
                    % ((now - req.enqueued) * 1e3)), "timeout")

    def collect(self, max_batch, max_wait):
        """Block for the next micro-batch: up to ``max_batch`` queued
        requests of the head request's bucket class, waiting at most
        ``max_wait`` seconds from the head's ENQUEUE for stragglers.
        Returns None when closed and drained."""
        max_batch = max(1, int(max_batch))
        with self._cond:
            while True:
                self._expire_locked()
                if not self._items:
                    if self._closed:
                        return None
                    self._cond.wait(timeout=0.5)
                    continue
                cls = self._items[0].bucket_class
                t_end = self._items[0].enqueued + max_wait
                while not self._closed:
                    n = sum(1 for r in self._items if r.bucket_class == cls)
                    if n >= max_batch:
                        break
                    remaining = t_end - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                    self._expire_locked()
                    if not self._items:
                        break
                    if not any(r.bucket_class == cls for r in self._items):
                        cls = self._items[0].bucket_class
                        t_end = self._items[0].enqueued + max_wait
                batch, rest = [], deque()
                for r in self._items:
                    if r.bucket_class == cls and len(batch) < max_batch:
                        batch.append(r)
                    else:
                        rest.append(r)
                self._items = rest
                if telemetry.ENABLED:
                    telemetry.SERVE_QUEUE_DEPTH.set(len(self._items))
                if batch:
                    return batch


class Scheduler:
    """The single dispatch loop: collect a micro-batch, hand it to the
    current model runner, resolve futures.

    A batch whose execution raises is retried **bisected** down to
    singles, so a poisoned request fails alone and its batch-mates still
    get answers (``serve_poison_requests_total``); repeated failed
    dispatches of one bucket open that bucket's circuit breaker.  Every
    path resolves every future, and the scheduler thread never dies to a
    model error."""

    def __init__(self, queue, runner_fn, max_batch_size=8, max_wait_us=2000,
                 breakers=None):
        self._queue = queue
        self._runner_fn = runner_fn
        self._max_batch = int(max_batch_size)
        self._max_wait = float(max_wait_us) / 1e6
        self._breakers = breakers
        self._thread = None

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="mx-serve-scheduler")
        self._thread.start()

    @property
    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def _loop(self):
        while True:
            batch = self._queue.collect(self._max_batch, self._max_wait)
            if batch is None:
                return
            self._dispatch(batch)

    def _dispatch(self, batch):
        now = time.perf_counter()
        live = []
        for req in batch:
            if req.expired(now):
                fail_request(req, RequestTimeout(
                    "deadline expired before dispatch"), "timeout")
            elif not req.future.cancelled():
                live.append(req)
        if not live:
            return
        if telemetry.ENABLED:
            telemetry.SERVE_BATCHES.inc()
            telemetry.SERVE_BATCH_SIZE.observe(len(live))
            for req in live:
                telemetry.SERVE_QUEUE_WAIT_SECONDS.observe(
                    now - req.enqueued)
        head = live[0]
        if trace.ENABLED:
            for req in live:
                if req.trace is not None:
                    trace.record_span("serve_queue_wait", req.enqueued,
                                      now - req.enqueued, ctx=req.trace,
                                      cat="serve")
        cls = head.bucket_class
        if self._breakers is not None and not self._breakers.allow(cls):
            exc = self._breakers.quarantine_error(cls)
            for req in live:
                fail_request(req, exc, "quarantined")
            return
        runner = self._runner_fn()
        if runner is None:
            # the owning Server was garbage-collected without shutdown
            exc = ServerClosed("server was dropped without shutdown")
            for req in live:
                fail_request(req, exc, "cancelled")
            self._queue.close()
            self._queue.cancel_pending()
            return
        try:
            with trace.use(head.trace), \
                    trace.span("serve_dispatch", hist=False, cat="serve",
                               args={"batch": len(live)}), \
                    trace.watchdog.watch("serve_dispatch"):
                _inject.fire("serve_dispatch")
                pairs = self._run_split(runner, live)
        except BaseException as exc:  # noqa: BLE001 - surfaced per request
            for req in live:
                fail_request(req, exc, "error")
            if self._breakers is not None:
                self._breakers.failure(cls)
            return
        failed = any(p[2] is not None for p in pairs)
        if self._breakers is not None:
            # one strike per DISPATCH: the bisect already confined the
            # damage; the breaker watches for the whole bucket going bad
            if failed:
                self._breakers.failure(cls)
            else:
                self._breakers.success(cls)
        # "poisoned": failed ALONE while at least one batch-mate was served
        any_ok = any(p[2] is None for p in pairs)
        with trace.use(head.trace), \
                trace.span("serve_respond", hist=False, cat="serve"):
            done_t = time.perf_counter()
            for req, res, exc, isolated in pairs:
                if exc is not None:
                    poisoned = isolated and any_ok
                    if poisoned and telemetry.ENABLED:
                        telemetry.SERVE_POISON.inc()
                    fail_request(req, exc,
                                 "poisoned" if poisoned else "error")
                    continue
                try:
                    req.future.set_result(res)
                except InvalidStateError:
                    continue
                if telemetry.ENABLED:
                    telemetry.SERVE_REQUESTS.labels(result="ok").inc()
                    telemetry.SERVE_REQUEST_SECONDS.observe(
                        done_t - req.enqueued)
                if trace.ENABLED and req.trace is not None:
                    trace.record_span(
                        "serve_request", req.enqueued,
                        done_t - req.enqueued, ctx=req.trace, root=True,
                        cat="serve", args={"result": "ok",
                                           "request_id": req.request_id})

    def _run_split(self, runner, reqs, depth=0):
        """Run ``reqs``; on failure retry bisected until single requests,
        so one poisoned request cannot fail its batch-mates.  Returns
        ``[(req, result, exc, isolated)]`` aligned with ``reqs``;
        ``isolated`` is True when bisection pinned the failure to one
        request.  At most ``2n - 1`` executions for a batch of n."""
        try:
            bad = [r for r in reqs if _inject.poisoned(r.request_id)]
            if bad:
                if len(reqs) == 1:
                    _inject.record_firing("serve_poison", bad[0].request_id,
                                          consume=True)
                raise InjectedFault(
                    "injected poison request %s"
                    % [r.request_id for r in bad], site="serve_poison")
            results = runner.run_batch(reqs)
        except Exception as exc:  # noqa: BLE001 - contained per request
            if len(reqs) == 1:
                isolated = depth > 0 or \
                    getattr(exc, "site", None) == "serve_poison"
                return [(reqs[0], None, exc, isolated)]
            if telemetry.ENABLED:
                telemetry.SERVE_BISECT_SPLITS.inc()
            trace.instant("serve_bisect", cat="serve",
                          args={"requests": len(reqs), "depth": depth,
                                "error": type(exc).__name__})
            mid = len(reqs) // 2
            return self._run_split(runner, reqs[:mid], depth + 1) + \
                self._run_split(runner, reqs[mid:], depth + 1)
        return [(req, res, None, False) for req, res in zip(reqs, results)]

    def stop(self, drain=True, timeout=None):
        """Close the queue and join the loop.  With ``drain`` (default)
        queued requests are served first; otherwise they fail with
        ServerClosed immediately."""
        self._queue.close()
        if not drain:
            self._queue.cancel_pending()
        if self._thread is not None:
            self._thread.join(timeout)
        return not self.alive
