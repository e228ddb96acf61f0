"""Server: the mx.serve front-end.

Counterpart of ``mxnet_tpu/serve/server.py``: thread-safe ``submit()`` /
``submit_async()`` (futures) over one ``BatchQueue`` + ``Scheduler`` and one
``ModelRunner``, and/or an autoregressive **decode plane**, with:

- **graceful drain** on ``shutdown()``: intake stops, everything queued is
  served (and every in-flight token stream finishes) before the loops and
  the listener stop; ``drain=False`` fails what is queued instead;
- **per-bucket circuit breakers** shared by both planes, ``stats()``;
- **hot swap**: ``swap()`` builds a new runner from a fresh block of the
  factory, restores and warms it, then publishes it with one reference
  assignment (the scheduler reads the runner once a batch, so batches in
  flight finish on the old model); ``swap_decode()`` repoints the decode
  plane (live sequences finish on the old runner's pool);
- **decode plane** (``decode=`` a ``DecodeRunner`` or a decoder block
  following the ``serve/decode.py`` contract, built with
  ``decode_config``): ``submit_decode()`` futures over the paged-KV
  continuous-batching loop;
- **preemption drain**: ``resilience.preempt.graceful_shutdown`` drains
  the server (a hook held weakly, removed at shutdown), so a SIGTERM'd
  process answers what it accepted before it exits;
- **SLOs**: with objectives registered through ``mx.obs.slo``,
  ``stats()["slo"]`` holds each one's evaluated state and burn rates;
- **HTTP endpoint** (``start_http``, stdlib ``http.server``, threading):
  ``GET /healthz`` (process up; open breakers, or an SLO past OK, make it
  "degraded", with the objectives' states under ``slo``),
  ``/readyz`` (every plane warmed -> 200, else 503), ``/metrics``
  (Prometheus text), ``/statz`` (JSON); ``POST /predict`` (``inputs`` to
  the micro-batch plane, ``tokens`` to the decode plane, collected or,
  with ``?stream=1``, streamed as chunked NDJSON token events),
  ``/decode`` (the decode plane's route alone) and ``/drainz`` (the
  rollout drain flag).  ``X-Request-Id`` is echoed on every response.

Not ported yet (each is queued in ``ROADMAP.md``): tenancy (``tenant=``,
item 9), fleet registration, ``load_digest``, ``/fleetz`` and the handoff
routes (item 9).
"""
from __future__ import annotations

import json
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as _np

from .. import telemetry, trace
from ..base import get_env
from ..gluon.block import Block
from ..resilience import preempt as _preempt
from .batching import (BatchQueue, BucketQuarantined, NoBucketError,
                       Request, RequestTimeout, Scheduler, ServeError,
                       ServerClosed, ServerOverloaded)
from .breaker import BreakerBoard
from .decode import DecodeError, DecodeRunner, DecodeScheduler
from .kvcache import PagePoolExhausted
from .runner import DEFAULT_BATCH_SIZES, ModelRunner

__all__ = ["ServeConfig", "Server", "SERVE_STATZ_SCHEMA_VERSION"]

# /statz top-level schema version: within a version keys may be ADDED but
# never renamed, removed or retyped (the JAX package's v2 added "cache"
# and "spec")
SERVE_STATZ_SCHEMA_VERSION = 2


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
    retry_after_s : the ``Retry-After`` the HTTP front-end advertises on
        overload 503s (``MXNET_SERVE_RETRY_AFTER``, default 1).
    """

    def __init__(self, max_batch_size=8, max_wait_us=2000, queue_depth=64,
                 timeout_ms=None, batch_sizes=None, sample_shapes=None,
                 dtype="float32", breaker_threshold=None,
                 breaker_cooldown_s=None, retry_after_s=None):
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
        self.retry_after_s = get_env(
            "MXNET_SERVE_RETRY_AFTER", float, 1.0) \
            if retry_after_s is None else float(retry_after_s)
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
            "sample_shapes": None if self.sample_shapes is None else [
                [list(s) for s in (sig if not all(
                    isinstance(d, int) for d in sig) else [sig])]
                for sig in self.sample_shapes],
            "dtype": self.dtype,
            "breaker_threshold": self.breaker_threshold,
            "breaker_cooldown_s": self.breaker_cooldown_s,
            "retry_after_s": self.retry_after_s,
        }


class Server:
    """Dynamic-batching inference server over one ModelRunner and/or a
    continuous-batching decode plane.

    ``Server(block, root=None, step=None, ctx=None, config=None)`` (the
    JAX package's order) builds the runner on ``ctx`` (default ``gpu(0)``,
    which raises where there is no card: pass ``ctx=mx.cpu()`` to serve on
    the CPU), restores checkpoint ``step`` of ``root`` when given, and
    warms every bucket; ``runner=`` takes a pre-built runner instead.
    ``block`` may be a zero-argument factory, which ``swap()`` needs.
    ``decode=`` (a ``DecodeRunner``, or a decoder block built into one on
    ``ctx`` with ``decode_config``, ``root`` and ``step``) adds the decode
    plane; a server may carry either plane or both."""

    def __init__(self, block=None, root=None, step=None, ctx=None,
                 config=None, runner=None, decode=None,
                 decode_config=None):
        self._config = config or ServeConfig()
        self._ctx = ctx
        # the factory, not just the instance: swap() builds a fresh block,
        # since loading new weights into the live one would be seen
        # mid-load
        self._block_factory = block if block is not None and \
            not isinstance(block, Block) and callable(block) else None
        if runner is None and block is not None:
            runner = ModelRunner(
                block, root=root, step=step, ctx=ctx,
                batch_sizes=self._config.batch_sizes,
                sample_shapes=self._config.sample_shapes,
                dtype=self._config.dtype)
        if runner is None and decode is None:
            raise ValueError("Server needs a block (or factory), a "
                             "pre-built runner, or a decode= plane")
        self._runner = runner
        self._root = root if root is not None else \
            (runner.root if runner is not None else None)
        self._breakers = BreakerBoard(
            self._config.breaker_threshold,
            self._config.breaker_cooldown_s) \
            if self._config.breaker_threshold > 0 else None
        # -- decode plane (serve/decode.py) ---------------------------------
        if decode is not None and not isinstance(decode, DecodeRunner):
            decode = DecodeRunner(decode, root=root, step=step, ctx=ctx,
                                  config=decode_config)
        elif decode_config is not None and decode is not None:
            raise ValueError(
                "decode_config= only applies when decode= is a raw "
                "decoder block; a pre-built DecodeRunner already carries "
                "its own config -- pass it there instead of having this "
                "one silently ignored")
        self._decode = DecodeScheduler(decode, breakers=self._breakers) \
            if decode is not None else None
        # -- micro-batch plane ----------------------------------------------
        self._queue = None
        self._scheduler = None
        if runner is not None:
            self._queue = BatchQueue(self._config.queue_depth)
            # the scheduler thread holds the server WEAKLY: a Server
            # dropped without shutdown() stays collectable, and its loop
            # winds down
            ref = weakref.ref(self)

            def _current_runner():
                srv = ref()
                return None if srv is None else srv._runner

            self._scheduler = Scheduler(
                self._queue, _current_runner,
                max_batch_size=self._config.max_batch_size,
                max_wait_us=self._config.max_wait_us,
                breakers=self._breakers)
            self._scheduler.start()
        self._swap_lock = threading.Lock()
        self._httpd = None
        self._closed = False
        # the rollout drain flag, and the live-stream count a graceful
        # drain waits on (the handler threads are daemons: without it a
        # drain could close the listener under a half-written stream)
        self._draining = False
        self._streams = 0
        self._stream_cv = threading.Condition()
        # preemption (mx.resilience): SIGTERM drains this server's queue
        # before the process exits.  Weak for the scheduler's reason: the
        # module-global hook list must not pin dead servers (a zombie
        # drain would eat grace budget); stale hooks remove themselves.
        self._preempt_hook = "serve-drain-%d" % id(self)
        ref = weakref.ref(self)

        def _drain(hook=self._preempt_hook):
            srv = ref()
            if srv is None or srv._closed:
                _preempt.remove_shutdown_hook(hook)
                return
            srv.shutdown(drain=True, timeout=10.0)

        _preempt.add_shutdown_hook(self._preempt_hook, _drain)

    # -- introspection ------------------------------------------------------
    @property
    def config(self):
        return self._config

    @property
    def runner(self):
        return self._runner

    @property
    def decode(self):
        """The decode plane's ``DecodeScheduler`` (None without one)."""
        return self._decode

    @property
    def step(self):
        """The checkpoint step being served (None without a root)."""
        if self._runner is not None:
            return self._runner.step
        return self._decode.runner.step if self._decode is not None \
            else None

    def healthy(self):
        """Liveness: every configured dispatch loop is running (an open
        breaker does not make the process unhealthy)."""
        if self._closed:
            return False
        if self._scheduler is not None and not self._scheduler.alive:
            return False
        if self._decode is not None and not self._decode.alive:
            return False
        return True

    def breakers(self):
        """{bucket_label: breaker state}."""
        return self._breakers.snapshot() \
            if self._breakers is not None else {}

    def ready(self):
        """Readiness: healthy AND every configured plane warmed."""
        if not self.healthy():
            return False
        if self._runner is not None and not self._runner.warmed:
            return False
        if self._decode is not None and not self._decode.runner.warmed:
            return False
        return True

    def queue_depth(self):
        return len(self._queue) if self._queue is not None else 0

    def queue_age_s(self):
        """Seconds the oldest queued request (either plane) has waited."""
        age = 0.0
        if self._queue is not None:
            age = self._queue.oldest_age()
        if self._decode is not None:
            age = max(age, self._decode.oldest_waiting_age())
        return age

    @property
    def draining(self):
        """True while a rollout drains this replica: routers stop new
        dispatches; work in flight finishes."""
        return self._draining

    def set_draining(self, flag=True):
        """Set the rollout drain flag (``POST /drainz``)."""
        self._draining = bool(flag)
        return self._draining

    def stats(self):
        by_result = {}
        req = telemetry.get_metric("serve_requests_total")
        for values, child in req._samples():
            if values:
                by_result[values[0]] = child.value
        from .. import monitor as _monitor

        return {
            "schema_version": SERVE_STATZ_SCHEMA_VERSION,
            "ready": self.ready(),
            "healthy": self.healthy(),
            "draining": self.draining,
            "queue_depth": self.queue_depth(),
            "queue_age_s": round(self.queue_age_s(), 4),
            "config": self._config.as_dict(),
            "runner": self._runner.stats()
            if self._runner is not None else None,
            # live sequences, page-pool occupancy and high water,
            # per-bucket program provenance, evictions
            "decode": self._decode.stats()
            if self._decode is not None else None,
            "requests": by_result,
            "totals": {k: v for k, v in telemetry.totals().items()
                       if k.startswith("serve_")},
            "breakers": self.breakers(),
            "health": {
                "monitor": _monitor.ENABLED,
                "nonfinite_output_elems": telemetry.value(
                    "serve_nonfinite_outputs_total"),
                "nonfinite_batches": telemetry.value(
                    "serve_nonfinite_batches_total"),
            },
            # mx.obs SLO engine: per-objective OK/WARN/PAGE + burn rates
            # (None when no objective is registered)
            "slo": self._slo_states(),
            "cache": self._plane_stats("cache"),
            "spec": self._plane_stats("spec"),
            "tenants": {"enabled": False},
        }

    @staticmethod
    def _slo_states():
        """Evaluated SLO results for /statz and /healthz, or None when
        nothing is registered.  Fail-soft: a sick SLO engine must not
        take the stats endpoint down."""
        try:
            from ..obs import slo_engine

            if not slo_engine.registered():
                return None
            return slo_engine.evaluate()
        except Exception:  # noqa: BLE001
            return None

    def _plane_stats(self, name):
        plane = getattr(self._decode.runner, name) \
            if self._decode is not None else None
        return plane.stats() if plane is not None else {"enabled": False}

    # -- submission ---------------------------------------------------------
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
        if self._scheduler is None:
            raise ServeError("this server has no micro-batch plane "
                             "(decode-only); use submit_decode()")
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

    # -- decode plane -------------------------------------------------------
    def submit_decode(self, tokens, max_new_tokens=None, eos_id=None,
                      timeout_ms=None, request_id=None, on_token=None,
                      tenant=None):
        """Enqueue one generation request on the decode plane; returns a
        future resolving to ``{"tokens": [...], "finish_reason": ...}``.
        ``on_token(token_id, index)`` streams each token as it is emitted.
        Raises ``ServeError`` without a decode plane (``tenant`` raises:
        ``ROADMAP.md`` Queue 1 item 9)."""
        if self._closed:
            raise ServerClosed("server is shut down")
        if self._decode is None:
            raise ServeError("this server has no decode plane "
                             "(construct with decode=DecodeRunner(...))")
        return self._decode.submit(
            tokens, max_new_tokens=max_new_tokens, eos_id=eos_id,
            timeout_ms=timeout_ms, request_id=request_id,
            on_token=on_token, tenant=tenant)

    def swap_decode(self, new_runner):
        """Repoint the decode plane at a new ``DecodeRunner``: live
        sequences finish on the old runner's pool, new admissions start on
        the new one once the running batch drains."""
        if self._decode is None:
            raise ServeError("this server has no decode plane")
        self._decode.swap(new_runner)

    # -- hot swap -----------------------------------------------------------
    def swap(self, root=None, step=None, block=None):
        """Repoint serving at checkpoint ``step`` (default the latest
        committed) of ``root`` (default the serving root), atomically.

        Builds a new runner from a fresh block (``block``, or the factory
        the server was built with), restores the step, warms every bucket,
        then replaces the runner reference under the swap lock.  Batches
        in flight finish on the old model; batches dispatched after the
        swap run on the new one.  Returns the restored step."""
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

    # -- lifecycle ----------------------------------------------------------
    def _stream_begin(self):
        with self._stream_cv:
            self._streams += 1

    def _stream_end(self):
        with self._stream_cv:
            self._streams -= 1
            self._stream_cv.notify_all()

    def _wait_streams(self, timeout):
        """Block until every in-flight streaming response has written its
        terminator (bounded).  Returns True when none remain."""
        deadline = time.monotonic() + (30.0 if timeout is None
                                       else float(timeout))
        with self._stream_cv:
            while self._streams > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._stream_cv.wait(left)
        return True

    def shutdown(self, drain=True, timeout=None):
        """Stop intake and join the loops.  With ``drain`` (default)
        queued requests are served first AND in-flight streaming responses
        finish before the listener closes; ``drain=False`` fails queued
        requests with ``ServerClosed`` and closes the listener at once.
        Returns True when every loop has stopped."""
        self._closed = True
        _preempt.remove_shutdown_hook(self._preempt_hook)
        if not drain and self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        ok = True
        if self._decode is not None:
            ok = self._decode.stop(drain=drain, timeout=timeout) and ok
        if self._scheduler is not None:
            ok = self._scheduler.stop(drain=drain, timeout=timeout) and ok
        if drain:
            ok = self._wait_streams(timeout) and ok
            if self._httpd is not None:
                self._httpd.shutdown()
                self._httpd.server_close()
                self._httpd = None
        return ok

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- HTTP surface -------------------------------------------------------
    def start_http(self, host="127.0.0.1", port=0):
        """Start the stdlib HTTP endpoint on a daemon thread; returns
        ``(host, port)`` (port 0 picks a free one)."""
        if self._httpd is not None:
            return self._httpd.server_address[:2]
        httpd = ThreadingHTTPServer((host, port), _Handler)
        httpd.daemon_threads = True
        httpd.mx_server = self
        self._httpd = httpd
        threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="mx-serve-http").start()
        return httpd.server_address[:2]


class _Handler(BaseHTTPRequestHandler):
    server_version = "mx-serve/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route access logs to logging
        import logging

        logging.getLogger("mxnet_tpu_torch.serve.http").debug(fmt, *args)

    def _send(self, code, body, content_type="application/json",
              headers=()):
        data = body if isinstance(body, bytes) else \
            json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        srv = self.server.mx_server
        if self.path == "/healthz":
            # an open breaker shows here ("degraded") but the process is
            # alive: only a dead loop is a 503
            breakers = srv.breakers()
            if srv.healthy():
                degraded = any(b["state"] != "closed"
                               for b in breakers.values())
                body = {"status": "degraded" if degraded else "ok",
                        "breakers": breakers}
                # an SLO past OK degrades liveness as an open breaker
                # does: alive, but tell the router
                slo = srv._slo_states()
                if slo is not None:
                    worst = max((s.get("state", "OK")
                                 for s in slo.values()),
                                key=lambda st: {"OK": 0, "WARN": 1,
                                                "PAGE": 2}.get(st, 0))
                    body["slo"] = {k: s.get("state", "OK")
                                   for k, s in slo.items()}
                    if worst != "OK":
                        body["status"] = "degraded"
                self._send(200, body)
            else:

                self._send(503, {"status": "down", "breakers": breakers})
        elif self.path == "/readyz":
            ready = srv.ready()
            self._send(200 if ready else 503,
                       {"ready": ready, "step": srv.step})
        elif self.path == "/metrics":
            self._send(200, telemetry.prometheus().encode(),
                       content_type="text/plain; version=0.0.4")
        elif self.path == "/statz":
            self._send(200, srv.stats())
        else:
            self._send(404, {"error": "unknown path %s" % self.path})

    def do_POST(self):  # noqa: N802
        import urllib.parse

        srv = self.server.mx_server
        parts = urllib.parse.urlsplit(self.path)
        if parts.path not in ("/predict", "/decode", "/drainz"):
            self._send(404, {"error": "unknown path %s" % self.path})
            return
        query = urllib.parse.parse_qs(parts.query)
        # X-Request-Id: sanitized (raw client bytes in a header would be a
        # response-splitting vector), used as the request's trace id and
        # echoed on every response
        rid = trace.sanitize_request_id(self.headers.get("X-Request-Id"))
        echo = (("X-Request-Id", rid),) if rid else ()

        def send(code, body, extra=()):
            self._send(code, body, headers=echo + tuple(extra))

        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            if parts.path == "/drainz":
                send(200, {"draining": srv.set_draining(
                    payload.get("draining", True))})
                return
            if parts.path == "/decode" or "tokens" in payload:
                self._do_decode(srv, payload, query, rid, echo, send)
                return
            inputs = payload["inputs"]
            if payload.get("multi"):
                inputs = tuple(inputs)
            out = srv.submit(inputs, timeout_ms=payload.get("timeout_ms"),
                             request_id=rid)
            if isinstance(out, tuple):
                body = {"outputs": [o.tolist() for o in out]}
            else:
                body = {"outputs": out.tolist()}
            body["step"] = srv.step
            send(200, body)
        except BucketQuarantined as exc:
            send(503, {"error": str(exc)},
                 extra=(("Retry-After", "%d" % max(
                     1, round(exc.retry_after or 1))),))
        except ServerOverloaded as exc:
            # a server state, not a client error: back off and retry
            send(503, {"error": str(exc)},
                 extra=(("Retry-After", "%d" % max(
                     1, round(srv.config.retry_after_s))),))
        except RequestTimeout as exc:
            send(504, {"error": str(exc)})
        except ServerClosed as exc:
            send(503, {"error": str(exc)})
        except (DecodeError, PagePoolExhausted, KeyError, ValueError,
                NoBucketError) as exc:
            # static limits (context, prompt, vocab bounds, a reservation
            # that can never fit): retrying the same input cannot win
            send(400, {"error": str(exc)})
        except Exception as exc:  # noqa: BLE001 - surfaced to the client
            send(500, {"error": str(exc)})

    def _do_decode(self, srv, payload, query, rid, echo, send):
        """A ``tokens`` payload: the decode plane.  ``?stream=1`` (or
        ``"stream": true``) streams each token as a chunked NDJSON event
        (the same engine, so the streamed ids are the collected ones),
        ending with a ``done`` summary or an ``error`` event.  Errors
        before admission raise into ``do_POST``'s status mapping before
        any response bytes go out."""
        if srv.decode is None:
            send(400, {"error": "this server has no decode plane"})
            return
        stream = payload.get("stream")
        if stream is None:
            stream = query.get("stream", ["0"])[0] \
                not in ("", "0", "false")
        kwargs = dict(max_new_tokens=payload.get("max_new_tokens"),
                      eos_id=payload.get("eos_id"),
                      timeout_ms=payload.get("timeout_ms"),
                      request_id=rid, tenant=payload.get("tenant"))
        # the DECODE runner's checkpoint step (a two-plane server's
        # micro-batch runner may sit at another)
        dstep = srv.decode.runner.step
        if not stream or not srv.decode.config.stream:
            res = srv.submit_decode(payload["tokens"], **kwargs).result()
            send(200, {"tokens": res["tokens"],
                       "finish_reason": res["finish_reason"],
                       "step": dstep})
            return
        import queue as _queue

        events = _queue.Queue()
        # count the stream BEFORE submitting: a drain racing this request
        # either sees the stream (and waits for its terminator) or rejects
        # the submit
        srv._stream_begin()
        try:
            fut = srv.submit_decode(
                payload["tokens"],
                on_token=lambda tok, i: events.put((tok, i)), **kwargs)
        except BaseException:
            srv._stream_end()
            raise
        fut.add_done_callback(lambda _f: events.put(None))
        try:
            self._stream_events(fut, events, dstep, echo)
        finally:
            srv._stream_end()

    def _stream_events(self, fut, events, dstep, echo):
        """Write one chunked NDJSON token stream: per-token events (None =
        the future resolved), then the ``done`` summary (or an in-stream
        ``error``), then the chunked terminator."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in echo:
            self.send_header(k, v)
        try:
            self.end_headers()

            def chunk(obj):
                data = json.dumps(obj).encode() + b"\n"
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")

            while True:
                item = events.get()
                if item is None:
                    break
                chunk({"token": item[0], "index": item[1]})
            try:
                res = fut.result()
                chunk({"done": True, "tokens": res["tokens"],
                       "finish_reason": res["finish_reason"],
                       "step": dstep})
            except Exception as exc:  # noqa: BLE001 - surfaced in-stream
                chunk({"error": str(exc), "type": type(exc).__name__})
            self.wfile.write(b"0\r\n\r\n")
        except Exception:  # noqa: BLE001 - client gone mid-stream
            # the 200 and chunked headers are on the wire: a second status
            # line would corrupt the stream, so drop the connection; the
            # engine finishes the sequence regardless
            self.close_connection = True
