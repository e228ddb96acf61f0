"""Runtime telemetry: the ``serve_*`` counters, gauges and histograms.

A cut copy of ``mxnet_tpu/telemetry.py``: the registry and metric kinds,
the ``totals``/``value``/``histogram_quantiles`` readers, the
``snapshot`` (JSON) and ``prometheus`` (text exposition) exporters, and
only the metrics the port feeds: those of
``serve/{batching,runner,server,breaker}.py``, of the decode plane
(``serve/{decode,kvcache,cache,spec}.py``), of the imperative
``gluon.Trainer``'s grouped apply (``optimizer/multi_tensor.py``), of the
bucket planner (``kvstore/collective.py``), of ``monitor/``, of the
whole-step capture (``step/capture.py``), of the input pipeline
(``gluon/data/dataloader.py``, ``io``, ``data/``), of ``checkpoint/``, of
the serving hot swap and of the fault plan (``resilience/inject.py``),
under the JAX package's names, and the families of the operational
planes: ``autotune/``, the flight recorder's dumps and watchdog
(``trace/``), the monitor's publisher and ``device_memory_bytes``, the
restart supervisor and preemption (``resilience/``), the collective
deadlines (``dist/timeouts.py``) and ``obs/``'s publisher, SLOs, step
cadence and attribution; ``log_line`` evaluates the registered SLOs
first, so their gauges are fresh in the line.  The
timers ``span``/``timed`` feed a live ``mx.profiler`` session; ``dump``,
``log_line`` and ``start_logger`` (``MXNET_TELEMETRY_LOG_INTERVAL``) are
the JAX package's.  Disabled cost is one
boolean check per hook (``if telemetry.ENABLED:``);
``MXNET_TELEMETRY_DISABLE=1`` flips it at import.
"""
from __future__ import annotations

import json
import logging
import threading
import time

from .base import get_env

__all__ = ["ENABLED", "enable", "disable", "counter", "gauge", "histogram",
           "get_metric", "reset", "span", "timed", "totals", "value",
           "snapshot", "dump", "histogram_quantiles", "prometheus",
           "sample_device_memory", "log_line", "start_logger",
           "DEFAULT_BUCKETS"]

_LOGGER = logging.getLogger("mxnet_tpu_torch.telemetry")

_LOCK = threading.Lock()
_REGISTRY = {}  # name -> Metric, insertion-ordered

ENABLED = not get_env("MXNET_TELEMETRY_DISABLE", bool, False)

DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def enable():
    global ENABLED
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


class _CounterChild:
    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters can only increase (got %r)" % amount)
        with _LOCK:
            self._value += amount

    @property
    def value(self):
        return self._value


class _GaugeChild:
    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def set(self, v):
        with _LOCK:
            self._value = float(v)

    def inc(self, amount=1.0):
        with _LOCK:
            self._value += amount

    def dec(self, amount=1.0):
        with _LOCK:
            self._value -= amount

    @property
    def value(self):
        return self._value


class _HistogramChild:
    __slots__ = ("_buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets):
        self._buckets = buckets
        self._counts = [0] * (len(buckets) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, v):
        v = float(v)
        i = len(self._buckets)
        for j, ub in enumerate(self._buckets):
            if v <= ub:
                i = j
                break
        with _LOCK:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def read(self):
        """Locked consistent view: (count, sum, cumulative buckets)."""
        with _LOCK:
            count, total = self._count, self._sum
            counts = list(self._counts)
        out, acc = [], 0
        for ub, c in zip(self._buckets, counts):
            acc += c
            out.append((ub, acc))
        out.append((float("inf"), acc + counts[-1]))
        return count, total, out


_CHILD_FACTORY = {
    "counter": lambda m: _CounterChild(),
    "gauge": lambda m: _GaugeChild(),
    "histogram": lambda m: _HistogramChild(m.buckets),
}


class Metric:
    """A named metric family; label children are created on demand."""

    def __init__(self, kind, name, help="", labelnames=(), buckets=None):
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS)) \
            if kind == "histogram" else None
        self._children = {}
        self._default = None if self.labelnames \
            else _CHILD_FACTORY[kind](self)

    def labels(self, *values, **kwargs):
        """The child of these label values, by position or by name."""
        if values:
            if kwargs or len(values) != len(self.labelnames):
                raise ValueError("%s takes labels %s, got %s"
                                 % (self.name, self.labelnames, values))
            kwargs = dict(zip(self.labelnames, values))
        if set(kwargs) != set(self.labelnames):
            raise ValueError("%s takes labels %s, got %s"
                             % (self.name, self.labelnames, sorted(kwargs)))
        values = tuple(str(kwargs[k]) for k in self.labelnames)
        child = self._children.get(values)
        if child is None:
            with _LOCK:
                child = self._children.setdefault(
                    values, _CHILD_FACTORY[self.kind](self))
        return child

    def _delegate(self):
        if self._default is None:
            raise ValueError("%s has labels %s: call .labels(...) first"
                             % (self.name, self.labelnames))
        return self._default

    def inc(self, amount=1.0):
        self._delegate().inc(amount)

    def dec(self, amount=1.0):
        self._delegate().dec(amount)

    def set(self, v):
        self._delegate().set(v)

    def observe(self, v):
        self._delegate().observe(v)

    def _samples(self):
        """[(labelvalues tuple, child), ...] including the default child."""
        with _LOCK:
            items = list(self._children.items())
        out = [((), self._default)] if self._default is not None else []
        out.extend(sorted(items, key=lambda kv: kv[0]))
        return out

    def _reset(self):
        # zero IN PLACE: call sites may hold child references
        with _LOCK:
            children = list(self._children.values())
            if self._default is not None:
                children.append(self._default)
            for child in children:
                if self.kind == "histogram":
                    child._counts = [0] * (len(self.buckets) + 1)
                    child._sum = 0.0
                    child._count = 0
                else:
                    child._value = 0.0


def _register(kind, name, help, labelnames, buckets=None):
    with _LOCK:
        m = _REGISTRY.get(name)
        if m is not None:
            if m.kind != kind or m.labelnames != tuple(labelnames):
                raise ValueError("metric %r already registered as %s%s"
                                 % (name, m.kind, m.labelnames))
            return m
        m = _REGISTRY[name] = Metric(kind, name, help, labelnames, buckets)
    return m


def counter(name, help="", labelnames=()):
    return _register("counter", name, help, labelnames)


def gauge(name, help="", labelnames=()):
    return _register("gauge", name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None):
    return _register("histogram", name, help, labelnames, buckets)


def get_metric(name):
    return _REGISTRY.get(name)


def reset():
    """Zero every registered metric (registrations are kept)."""
    for m in list(_REGISTRY.values()):
        m._reset()


def _labels_dict(metric, values):
    return dict(zip(metric.labelnames, values))


def _bucket_quantile(cum, count, q):
    """The q-quantile estimated from cumulative bucket counts (linear
    within the covering bucket, as Prometheus' ``histogram_quantile``);
    observations in the +Inf bucket clamp to the last finite bound."""
    if count <= 0:
        return 0.0
    target = q * count
    lo, prev_c, last_finite = 0.0, 0, 0.0
    for ub, c in cum:
        if ub != float("inf"):
            last_finite = ub
        if c >= target:
            if ub == float("inf"):
                return last_finite
            width = c - prev_c
            if width <= 0:
                return ub
            return lo + (target - prev_c) / width * (ub - lo)
        prev_c = c
        if ub != float("inf"):
            lo = ub
    return last_finite


def _merged_read(metric, match=None):
    """(count, sum, merged cumulative buckets) over a histogram family's
    label children (they share the family's bucket edges); ``match``
    keeps the children whose labels contain it (a per-tenant SLO reads
    one tenant's samples out of a shared histogram)."""
    want = {k: str(v) for k, v in (match or {}).items()}
    reads = [c.read() for values, c in metric._samples()
             if all(_labels_dict(metric, values).get(k) == v
                    for k, v in want.items())]
    count = sum(r[0] for r in reads)
    total = sum(r[1] for r in reads)
    cum = [(ub, sum(r[2][i][1] for r in reads))
           for i, (ub, _) in enumerate(reads[0][2])] if reads else []
    return count, total, cum


def histogram_quantiles(name, qs=(0.5, 0.95, 0.99)):
    """Bucket-estimated quantiles of a histogram family, merged over its
    label children: {q: value}; {} for an unknown, empty or
    non-histogram name."""
    m = _REGISTRY.get(name)
    if m is None or m.kind != "histogram":
        return {}
    count, _, cum = _merged_read(m)
    if not count:
        return {}
    return {q: _bucket_quantile(cum, count, q) for q in qs}


def totals(nonzero=False, quantiles=False):
    """Flat {name: summed value}; histograms give ``_count``/``_sum``, and
    with ``quantiles`` the bucket-estimated ``_p50``/``_p95``/``_p99``;
    ``nonzero`` drops the zero entries."""
    out = {}
    for name, m in list(_REGISTRY.items()):
        if m.kind == "histogram":
            count, total, cum = _merged_read(m)
            out[name + "_count"] = count
            out[name + "_sum"] = round(total, 6)
            if quantiles and count:
                for q, label in ((0.5, "_p50"), (0.95, "_p95"),
                                 (0.99, "_p99")):
                    out[name + label] = round(
                        _bucket_quantile(cum, count, q), 6)
        else:
            out[name] = sum(c.value for _, c in m._samples())
    if nonzero:
        out = {k: v for k, v in out.items() if v}
    return out


def snapshot():
    """JSON-ready view: {name: {type, help, samples}}; a counter or gauge
    sample is {"labels", "value"}, a histogram's {"labels", "count",
    "sum", "buckets": {le: cumulative count}} ("+Inf" last)."""
    out = {}
    for name, m in list(_REGISTRY.items()):
        samples = []
        for values, child in m._samples():
            labels = _labels_dict(m, values)
            if m.kind == "histogram":
                count, total, cum = child.read()
                samples.append({
                    "labels": labels, "count": count, "sum": total,
                    "buckets": {_fmt_le(ub): c for ub, c in cum}})
            else:
                samples.append({"labels": labels, "value": child.value})
        out[name] = {"type": m.kind, "help": m.help, "samples": samples}
    return out


def _fmt_le(ub):
    return "+Inf" if ub == float("inf") else repr(float(ub))


def _esc(v):
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _esc_help(v):
    # HELP text escapes only backslash and newline; quotes stay literal
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def _labelstr(metric, values, extra=()):
    pairs = list(zip(metric.labelnames, values)) + list(extra)
    if not pairs:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, _esc(v)) for k, v in pairs)


def prometheus():
    """Prometheus text exposition format: a # HELP / # TYPE pair and the
    sample lines of every registered metric."""
    lines = []
    for name, m in list(_REGISTRY.items()):
        lines.append("# HELP %s %s" % (name, _esc_help(m.help or name)))
        lines.append("# TYPE %s %s" % (name, m.kind))
        for values, child in m._samples():
            if m.kind == "histogram":
                count, total, cum = child.read()
                for ub, c in cum:
                    lines.append("%s_bucket%s %d" % (
                        name, _labelstr(m, values, [("le", _fmt_le(ub))]),
                        c))
                lines.append("%s_sum%s %s"
                             % (name, _labelstr(m, values), repr(total)))
                lines.append("%s_count%s %d"
                             % (name, _labelstr(m, values), count))
            else:
                lines.append("%s%s %s" % (name, _labelstr(m, values),
                                          repr(float(child.value))))
    return "\n".join(lines) + "\n"


def value(name, labels=None):
    """Sum of a metric's samples whose labels contain ``labels``
    (a histogram counts observations)."""
    m = _REGISTRY.get(name)
    if m is None:
        return 0.0
    want = {k: str(v) for k, v in (labels or {}).items()}
    tot = 0.0
    for values, child in m._samples():
        have = dict(zip(m.labelnames, values))
        if all(have.get(k) == v for k, v in want.items()):
            tot += child.count if m.kind == "histogram" else child.value
    return tot


def dump(path):
    """Write the JSON snapshot to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump({"time": time.time(), "enabled": ENABLED,
                   "metrics": snapshot()}, f, indent=2, sort_keys=True)
    return path


# ---------------------------------------------------------------------------
# timers
# ---------------------------------------------------------------------------

def _feed_profiler(name, start, dur, cat="telemetry", args=None):
    """Land a span in a live ``mx.profiler`` session's user events, with
    the thread that recorded it.  With no session live this is one
    boolean read; the flag is read again under the profiler's lock, so a
    concurrent ``set_state('stop')`` cannot interleave with the append."""
    from . import profiler

    if not profiler._state["running"]:
        return
    with profiler._events_lock:
        if profiler._state["running"]:
            t = threading.current_thread()
            ev = {"name": name, "cat": cat, "ts": start, "dur": dur,
                  "tid": t.ident, "tname": t.name}
            if args:
                ev["args"] = args
            profiler._state["events"].append(ev)


class span:
    """Monotonic-clock timing context: observes ``<name>_seconds`` (or the
    given histogram) and feeds a profiler event when a session is live.
    A span entered while telemetry is off observes nothing."""

    __slots__ = ("name", "_hist", "_start")

    def __init__(self, name, hist=None):
        self.name = name
        self._hist = hist
        self._start = None

    def __enter__(self):
        self._start = time.perf_counter() if ENABLED else None
        return self

    def __exit__(self, *exc):
        if self._start is None or not ENABLED:
            return False
        dur = time.perf_counter() - self._start
        hist = self._hist
        if hist is None:
            hist = histogram(self.name + "_seconds",
                             "duration of %s spans" % self.name)
        hist.observe(dur)
        _feed_profiler(self.name, self._start, dur)
        return False


def timed(name, hist=None):
    """Decorator form of ``span``: time every call of fn."""
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not ENABLED:
                return fn(*args, **kwargs)
            with span(name, hist):
                return fn(*args, **kwargs)
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# device memory and the periodic log line
# ---------------------------------------------------------------------------

def sample_device_memory(device=None):
    """Refresh the ``device_memory_bytes`` gauges from
    ``profiler.memory_info()`` (the caching allocator's
    ``torch.cuda.memory_stats`` and ``mem_get_info``; the CPU reports
    nothing).  Returns the report."""
    if not ENABLED:
        return {}
    from . import profiler

    try:
        report = profiler.memory_info(device)
    except Exception:  # noqa: BLE001 - telemetry must never raise
        return {}
    for dev, stats in report.items():
        for stat, v in stats.items():
            DEVICE_MEMORY.labels(device=dev, stat=stat).set(v)
    return report


_logger_started = False


def log_line():
    """One compact 'telemetry k=v ...' line over the nonzero totals
    (histograms with their bucket-estimated p50/p95/p99).  Registered
    SLOs are evaluated first, so their state and burn gauges are fresh in
    the same line."""
    try:
        from .obs import slo_engine as _slo

        if _slo.registered():
            _slo.evaluate()
    except Exception:  # noqa: BLE001 - the log line must never fail
        pass
    tot = totals(nonzero=True, quantiles=True)
    body = " ".join(
        "%s=%s" % (k, ("%d" % v) if float(v).is_integer() else
                   ("%.6g" % v))
        for k, v in sorted(tot.items()))
    return "telemetry " + (body or "(all zero)")


def _log_loop(interval):
    while True:
        time.sleep(interval)
        try:
            if ENABLED:
                sample_device_memory()
                _LOGGER.info(log_line())
        except Exception:  # noqa: BLE001 - the log thread must survive
            _LOGGER.exception("telemetry log tick failed")


def start_logger(interval=None):
    """Start the periodic telemetry log thread (once a process).  With no
    argument, reads MXNET_TELEMETRY_LOG_INTERVAL (seconds; 0 = off)."""
    global _logger_started
    if interval is None:
        interval = get_env("MXNET_TELEMETRY_LOG_INTERVAL", float, 0.0)
    if not interval or interval <= 0 or _logger_started:
        return False
    t = threading.Thread(target=_log_loop, args=(float(interval),),
                         daemon=True, name="mxnet-telemetry-log")
    t.start()
    _logger_started = True
    return True


# mx.serve: queue wait is the time a request sat in the BatchQueue before
# its micro-batch was dispatched; pad waste is the zero-fill the bucket
# table forced.
SERVE_REQUESTS = counter(
    "serve_requests_total", "serving requests by outcome "
    "(ok/rejected/timeout/error/cancelled/quarantined/poisoned)",
    ("result",))
SERVE_REQUEST_SECONDS = histogram(
    "serve_request_seconds",
    "end-to-end request latency (enqueue -> result set)")
SERVE_QUEUE_WAIT_SECONDS = histogram(
    "serve_queue_wait_seconds",
    "time a request waited in the batch queue before dispatch")
SERVE_QUEUE_DEPTH = gauge(
    "serve_queue_depth", "requests currently waiting in the batch queue")
SERVE_BATCHES = counter(
    "serve_batches_total", "micro-batches dispatched to the model runner")
SERVE_BATCH_SIZE = histogram(
    "serve_batch_size", "requests coalesced per dispatched micro-batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
SERVE_PAD_ELEMENTS = counter(
    "serve_pad_elements_total",
    "zero elements added by bucket padding (batch + shape fill)")
SERVE_PAD_FRACTION = histogram(
    "serve_pad_fraction",
    "padded/total element fraction per dispatched micro-batch",
    buckets=(0.01, 0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9))
SERVE_NONFINITE_OUTPUTS = counter(
    "serve_nonfinite_outputs_total",
    "nonfinite (NaN/Inf) elements in served model outputs")
SERVE_NONFINITE_BATCHES = counter(
    "serve_nonfinite_batches_total",
    "dispatched micro-batches containing at least one nonfinite "
    "output element")
SERVE_POISON = counter(
    "serve_poison_requests_total",
    "requests whose failure was isolated by bisect retry while their "
    "batch-mates were served independently")
SERVE_BISECT_SPLITS = counter(
    "serve_bisect_splits_total",
    "failed micro-batches split in half for retry (poison isolation)")
SERVE_BREAKER_STATE = gauge(
    "serve_breaker_state",
    "per-bucket circuit breaker state (0=closed 1=half-open 2=open)",
    ("bucket",))
SERVE_BREAKER_TRIPS = counter(
    "serve_breaker_trips_total",
    "circuit breaker openings (bucket quarantined after repeated "
    "dispatch failures)", ("bucket",))
SERVE_SWAPS = counter(
    "serve_model_swaps_total", "hot model swaps (atomic runner "
    "replacement pointing at a new checkpoint step)")
# mx.serve.decode (serve/decode.py + kvcache.py): paged KV cache and
# continuous batching.  One step program per decode batch bucket and per
# prefill length bucket runs every iteration over the live sequences.
SERVE_DECODE_TOKENS = counter(
    "serve_decode_tokens_total", "tokens generated by the decode loop")
SERVE_DECODE_STEPS = counter(
    "serve_decode_steps_total",
    "continuous-batching decode iterations dispatched")
SERVE_DECODE_PREFILLS = counter(
    "serve_decode_prefills_total",
    "sequences prefilled through the prompt bucket path")
SERVE_DECODE_BATCH = histogram(
    "serve_decode_batch_size",
    "live sequences per decode iteration (varies step to step as "
    "sequences join and leave the running batch)",
    buckets=(1, 2, 4, 8, 16, 32, 64))
SERVE_DECODE_LIVE = gauge(
    "serve_decode_live_sequences",
    "sequences currently decoding in the running batch")
SERVE_DECODE_WAITING = gauge(
    "serve_decode_waiting_sequences",
    "sequences queued for admission (slots or KV pages exhausted)")
SERVE_DECODE_TTFT_SECONDS = histogram(
    "serve_decode_ttft_seconds",
    "time to first token: submit -> the prefill-produced token, by "
    "prefix-cache outcome (hit / partial / miss)",
    ("cache",))
SERVE_DECODE_TOKEN_SECONDS = histogram(
    "serve_decode_token_seconds",
    "per-token decode latency (one continuous-batching iteration)")
SERVE_DECODE_COMPILES = counter(
    "serve_decode_compile_total",
    "decode/prefill program builds by bucket (steady state: at most "
    "one per bucket, all during warm-up)",
    ("bucket",))
SERVE_DECODE_EVICTIONS = counter(
    "serve_decode_evictions_total",
    "sequences evicted from the running batch, by reason (finished / "
    "timeout / poisoned / error / quarantined / cancelled)",
    ("reason",))
SERVE_KV_PAGES_IN_USE = gauge(
    "serve_kv_pages_in_use",
    "KV-cache pool pages currently reserved by live sequences")
SERVE_KV_PAGES_HIGH_WATER = gauge(
    "serve_kv_pages_high_water",
    "high-water mark of reserved KV-cache pool pages")
# mx.serve.cache (serve/cache.py): the radix prefix cache
SERVE_PREFIX_LOOKUPS = counter(
    "serve_prefix_lookups_total",
    "prefix-cache admissions by outcome (hit = every cacheable prompt "
    "block matched, partial = some, miss = none)",
    ("result",))
SERVE_PREFIX_HIT_TOKENS = counter(
    "serve_prefix_hit_tokens_total",
    "prompt tokens served from cached prefix pages (prefill work "
    "avoided)")
SERVE_PREFIX_SHARED_PAGES = gauge(
    "serve_prefix_shared_pages",
    "KV pool pages in the shared refcounted segment (prefix trie + "
    "live readers)")
SERVE_PREFIX_EVICTIONS = counter(
    "serve_prefix_evictions_total",
    "prefix trie nodes dropped (LRU pool pressure, corrupt-drill "
    "invalidation, or clear)")
SERVE_DECODE_PREFILL_TOKENS = counter(
    "serve_decode_prefill_tokens_total",
    "prompt tokens actually run through a prefill/chunk program (the "
    "uncached suffix only)")
# mx.serve.spec (serve/spec.py): speculative decoding
SERVE_SPEC_ROUNDS = counter(
    "serve_spec_rounds_total",
    "speculative rounds reaching the verify dispatch")
SERVE_SPEC_PROPOSED = counter(
    "serve_spec_proposed_total",
    "draft tokens proposed to the target verifier")
SERVE_SPEC_ACCEPTED = counter(
    "serve_spec_accepted_total",
    "draft tokens accepted by greedy verification (accepted/proposed "
    "is the acceptance rate)")
SERVE_SPEC_FALLBACKS = counter(
    "serve_spec_fallbacks_total",
    "sequences degraded to non-speculative decode, by reason "
    "(draft_pool / draft_prefill / draft_nonfinite / draft_error / "
    "injected)",
    ("reason",))

# collectives: the bucket plan a captured step feeds in a world of more
# than one (``kvstore/collective.py:observe_bucket_fill``)
COLLECTIVE_CALLS = counter(
    "collective_calls_total", "collective programs dispatched", ("op",))
COLLECTIVE_BYTES = counter(
    "collective_bytes_total", "bytes moved by collectives", ("op",))
ALLREDUCE_BUCKET_FILL = histogram(
    "allreduce_bucket_fill",
    "fill fraction of each fused all-reduce bucket relative to "
    "MXNET_KVSTORE_BUCKET_BYTES (>1 = one oversized array)",
    buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0, 1.5, 2.0))
# the imperative Trainer's grouped apply (optimizer/multi_tensor.py): one
# multi-tensor rule per parameter group a step; per-parameter eager
# updates are counted by reason
TRAINER_FUSED_GROUPS = gauge(
    "trainer_fused_groups",
    "multi-tensor update groups in the last imperative Trainer step")
TRAINER_FUSED_APPLY = counter(
    "trainer_fused_apply_total",
    "grouped multi-tensor updates run", ("optimizer",))
TRAINER_FUSED_BUILDS = counter(
    "trainer_fused_builds_total",
    "multi-tensor group builds (slot buffer and member signature)",
    ("optimizer",))
TRAINER_EAGER_UPDATES = counter(
    "trainer_eager_updates_total",
    "per-parameter eager optimizer updates (multi-tensor fallback)",
    ("reason",))
TRAINER_UPDATE_SECONDS = histogram(
    "trainer_update_seconds",
    "imperative Trainer optimizer-apply host latency per step")
# mx.monitor (monitor/): per-group health numerics, published on the
# training thread (the publisher thread is not ported)


MONITOR_STAT_PROGRAMS = counter(
    "monitor_stat_programs_total",
    "stat reductions dispatched (groups x observed steps)")
MONITOR_GRAD_NORM = gauge(
    "monitor_grad_norm", "last observed per-group gradient L2 norm",
    ("group",))
MONITOR_WEIGHT_NORM = gauge(
    "monitor_weight_norm", "last observed per-group weight L2 norm",
    ("group",))
MONITOR_GRAD_MAX = gauge(
    "monitor_grad_max_abs", "last observed per-group max |grad|",
    ("group",))
MONITOR_WEIGHT_MAX = gauge(
    "monitor_weight_max_abs", "last observed per-group max |weight|",
    ("group",))
MONITOR_GRAD_GLOBAL_NORM = gauge(
    "monitor_grad_global_norm",
    "last observed global gradient L2 norm (sqrt of the per-group "
    "squared-norm sum)")
MONITOR_NONFINITE = counter(
    "monitor_nonfinite_total",
    "nonfinite (NaN/Inf) elements observed", ("kind", "group"))
MONITOR_NONFINITE_STEPS = counter(
    "monitor_nonfinite_steps_total",
    "observed steps with at least one nonfinite gradient element")
MONITOR_SKIPPED_STEPS = counter(
    "monitor_skipped_steps_total",
    "trainer steps skipped whole by the nonfinite sentinel "
    "(policy=skip_step; params/optimizer state untouched)")
MONITOR_SENTINEL_TRIPS = counter(
    "monitor_sentinel_trips_total",
    "nonfinite sentinel trips by the policy in force", ("policy",))
MONITOR_FETCH_SECONDS = histogram(
    "monitor_fetch_seconds",
    "device->host stat vector fetch latency")
# mx.step (step/): the whole training step as one CUDA graph on the card
# (eager on the CPU); the stitched imperative path stays the fallback,
# counted by reason
STEP_CAPTURE_BUILDS = counter(
    "step_capture_builds_total",
    "whole-step program builds (one per input signature, optimizer "
    "hyper-parameters, monitor mode and remat policy)")
STEP_CAPTURE_STEPS = counter(
    "step_capture_steps_total",
    "training steps executed through mx.step, by path (captured = the "
    "whole-step program; stitched = the imperative forward/backward/"
    "Trainer.step sequence)", ("path",))
STEP_CAPTURE_FALLBACKS = counter(
    "step_capture_fallback_total",
    "captured-step degradations to the stitched path, by reason (the "
    "step is still applied)", ("reason",))
STEP_PROGRAM_SECONDS = histogram(
    "step_program_seconds",
    "captured whole-step host latency per step (slots, input copies, "
    "replay and bookkeeping; the card runs asynchronously)")

# ---- the input pipeline: gluon.data.DataLoader, io, data.{reader,ring} ---
TRANSFER_BYTES = counter(
    "transfer_bytes_total", "host<->device transfer volume",
    ("direction",))
TRANSFER_D2H = TRANSFER_BYTES.labels(direction="d2h")
TRANSFER_H2D = TRANSFER_BYTES.labels(direction="h2d")
DATALOADER_WAIT_SECONDS = histogram(
    "dataloader_batch_wait_seconds",
    "time the training loop blocked waiting for the next batch")
# mx.data: the ring gauges are the pipeline's health signal; steady
# state is occupancy ~ depth and a flat stall counter, and a climbing
# stall count means reads or decode (not H2D) bound the pipeline
DATA_RING_DEPTH = gauge(
    "data_ring_depth",
    "configured prefetch ring depth (batches staged ahead; "
    "MXNET_DATA_PREFETCH)")
DATA_RING_OCCUPANCY = gauge(
    "data_ring_occupancy",
    "device-staged batches currently waiting in the prefetch ring")
DATA_RING_STALLS = counter(
    "data_ring_stalls_total",
    "times the training loop arrived at an EMPTY prefetch ring "
    "(the reader/decode stage fell behind the step)")
DATA_READ_SECONDS = histogram(
    "data_read_seconds",
    "shard record-read time per batch (worker-side, after retries)")
DATA_DECODE_SECONDS = histogram(
    "data_decode_seconds",
    "decode + batchify time per batch (worker-side)")
DATA_STAGE_SECONDS = histogram(
    "data_stage_seconds",
    "host batch -> device staging time (the copy itself runs "
    "asynchronously on a side stream)")
DATA_BATCHES = counter(
    "data_batches_total", "batches staged through the prefetch ring")
DATA_RECORDS = counter(
    "data_records_total", "records read + decoded by reader workers")
DATA_READ_RETRIES = counter(
    "data_read_retries_total",
    "reader IO attempts retried after an OSError")
DATA_RESUMES = counter(
    "data_resumes_total",
    "mid-epoch cursor restores (checkpoint resume of the stream)")

# mx.checkpoint (checkpoint/manager.py + writer.py): snapshot is the only
# critical-path phase of an async save; serialize/commit run on the
# background writer
CHECKPOINT_SNAPSHOT_SECONDS = histogram(
    "checkpoint_snapshot_seconds",
    "device->host snapshot time (critical path of an async save)")
CHECKPOINT_SERIALIZE_SECONDS = histogram(
    "checkpoint_serialize_seconds",
    "background shard serialize+durable-write (streamed) time")
CHECKPOINT_COMMIT_SECONDS = histogram(
    "checkpoint_commit_seconds",
    "background manifest/marker write + atomic-publish time")
CHECKPOINT_BYTES = counter(
    "checkpoint_bytes_total", "checkpoint shard bytes moved",
    ("direction",))
CHECKPOINT_QUEUE_DEPTH = gauge(
    "checkpoint_async_queue_depth",
    "async saves snapshotted but not yet committed")
CHECKPOINT_RETRIES = counter(
    "checkpoint_retries_total",
    "commit attempts retried after a transient I/O error")
CHECKPOINT_SAVES = counter(
    "checkpoint_saves_total", "checkpoint commits by outcome",
    ("result",))
CHECKPOINT_RESTORES = counter(
    "checkpoint_restores_total", "checkpoint restore calls")

# mx.resilience: planned faults fired (resilience/inject.py), the
# restart supervisor's recoveries and backoff, preemptions and their
# emergency checkpoints (resilience/{supervisor,preempt}.py)
RESILIENCE_FAULTS = counter(
    "resilience_faults_injected_total",
    "planned faults fired, by injection site (MXNET_FAULTS / "
    "resilience.plan())", ("site",))
RESILIENCE_RESTARTS = counter(
    "resilience_restarts_total",
    "supervisor recovery events by kind (transient / divergence / "
    "fatal / budget_exhausted / unhealthy)", ("kind",))
RESILIENCE_BACKOFF_SECONDS = histogram(
    "resilience_backoff_seconds",
    "jittered exponential backoff slept between restarts")
RESILIENCE_PREEMPTIONS = counter(
    "resilience_preemptions_total",
    "preemption requests observed (SIGTERM or resilience.request())")
RESILIENCE_EMERGENCY_SAVES = counter(
    "resilience_emergency_saves_total",
    "emergency checkpoints flushed during preemption shutdown")

# mx.dist: collectives that missed their deadline (dist/timeouts.py)
DIST_COLLECTIVE_TIMEOUTS = counter(
    "dist_collective_timeouts_total",
    "collectives that missed MXNET_DIST_COLLECTIVE_TIMEOUT (a peer "
    "rank unreachable), by site", ("site",))

# mx.obs (obs/): payload publishes into the membership KV, SLO states and
# burn rates, the step cadence and the attribution records
OBS_PUBLISHES = counter(
    "obs_publish_total",
    "per-rank obs payloads published into the membership KV")
OBS_PUBLISH_FAILURES = counter(
    "obs_publish_failures_total",
    "obs payload publishes that failed (dead/partitioned KV; the "
    "fleet view degrades to local-only until it recovers)")
OBS_SLO_STATE = gauge(
    "obs_slo_state",
    "per-objective SLO state (0=OK 1=WARN 2=PAGE, multi-window "
    "burn-rate evaluation)", ("slo",))
OBS_SLO_BURN = gauge(
    "obs_slo_burn_rate",
    "error-budget burn rate per objective and window (1.0 = burning "
    "exactly the budget)", ("slo", "window"))
OBS_STEP_SECONDS = histogram(
    "obs_step_seconds",
    "training-step wall time as seen by the obs cadence hook",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0, 60.0))
OBS_ATTRIB_RECORDS = counter(
    "obs_attribution_records_total",
    "per-step attribution records written (JSONL stream when "
    "MXNET_OBS_ATTRIBUTION is set)")


# mx.trace: flight-recorder dumps by trigger reason (manual / crash / exit
# / slow_step / deadline_burst / divergence / hang / dry_run) and
# watchdog fires by the watch scope that stalled
TRACE_DUMPS = counter(
    "trace_dumps_total",
    "flight-recorder dumps written, by trigger reason", ("reason",))
TRACE_WATCHDOG_FIRES = counter(
    "trace_watchdog_fires_total",
    "hang-watchdog reports (no progress past the scope timeout)",
    ("scope",))

# mx.monitor's publisher (monitor/core.py): stat programs built, the
# global norm's distribution, entries the bounded ring displaced
MONITOR_STAT_BUILDS = counter(
    "monitor_stat_builds_total",
    "stat reduction program builds (trace + compile; steady state: "
    "one per parameter group, zero per-step retraces)")
MONITOR_GRAD_GLOBAL_NORM_HIST = histogram(
    "monitor_grad_global_norm_hist",
    "distribution of the global gradient L2 norm over observed steps",
    buckets=(0.001, 0.01, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 50.0, 100.0,
             1000.0))
MONITOR_DROPS = counter(
    "monitor_dropped_total",
    "stat entries displaced from the bounded host-fetch ring before "
    "the publisher drained them")

# device memory (sample_device_memory): the caching allocator's stats
DEVICE_MEMORY = gauge(
    "device_memory_bytes", "PJRT device memory stats "
    "(sample_device_memory refreshes)", ("device", "stat"))

# mx.autotune (autotune/): every degrade to the hand-set default is
# counted, so a process that silently fell back is visible
AUTOTUNE_LOOKUPS = counter(
    "autotune_lookup_total",
    "build-time tuned-config lookups by site and result (tuned = a "
    "stored winner was served; default = hand-set literal)",
    ("site", "result"))
AUTOTUNE_MEASURE = counter(
    "autotune_measure_total",
    "candidate configs measured by the search harness / idle tuners "
    "(a warm store means a fresh process re-measures NOTHING)",
    ("site",))
AUTOTUNE_REJECT = counter(
    "autotune_reject_total",
    "candidates rejected by the measure guards (numerics = output "
    "not bit-identical to the default config's; shape; nonfinite; "
    "error)", ("site", "reason"))
AUTOTUNE_FALLBACK = counter(
    "autotune_fallback_total",
    "degrades to the hand-set default by reason (store_unavailable / "
    "store_corrupt / store_error / store_write / invalid_config / "
    "measure_error / serve_idle / ...)", ("reason",))
AUTOTUNE_STORE_COMMITS = counter(
    "autotune_store_commits_total",
    "tuning records durably committed to the TuningStore")
AUTOTUNE_STORE_QUARANTINE = counter(
    "autotune_store_quarantine_total",
    "corrupt/torn tuning records parked at *.corrupt (never trusted "
    "again; lookups degraded to defaults)")
AUTOTUNE_TUNE_SECONDS = histogram(
    "autotune_tune_seconds",
    "wall time of one tune() search (default + all candidates)",
    buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0))
