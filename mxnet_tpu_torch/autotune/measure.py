"""Measured search: timed micro-benchmarks with a numerics guard.

Counterpart of ``mxnet_tpu/autotune/measure.py``.  ``tune(site, key)``
runs every candidate config of a site's grid as a micro-benchmark (seeded
inputs, warm-up runs discarded, the trimmed mean of timed repeats; each
measured run sits in an ``autotune_measure`` trace span), holds every
candidate to the guards

- **shape**: outputs shaped as the default config's;
- **nonfinite**: any NaN/Inf in a candidate's outputs rejects it;
- **bitwise**: outputs bit-identical to the default config's (a tuned
  config can change speed, never numerics: a candidate that differs is
  rejected, not ranked slower);

and commits the surviving winner to the ``TuningStore``.  A bench's
``run()`` ends in a synchronize on the card.  A bench on the card carries
the device time of its last run (``run.device_ms``, two CUDA events on
its stream), and candidates are ranked by the trimmed mean of those: a
run of a few sub-millisecond launches is bound by the host, whose clock
would rank the launch overhead.  A CPU bench, and the serving idle
tuners (whole batches of several ms), keep the host clock.  Every stored
record says which clock it holds (``"clock": "cuda_events"`` or
``"host"``).  The cost model may prune the grid first
(``MXNET_AUTOTUNE_PRUNE``); a cold model measures everything.  Every
failure gives the hand-set default with a counted
``autotune_fallback_total{reason}``.

The serving idle tuners (``serve_idle_tune``, ``decode_idle_tune``) run
during warm-up under ``MXNET_AUTOTUNE=search`` within the budget
(``MXNET_AUTOTUNE_BUDGET_MS``): they time programs already warm and
commit bucket records that the next process looks up.
"""
from __future__ import annotations

import time as _time

from .. import telemetry as _tel
from .. import trace as _trace
from ..base import MXNetError, get_env
from . import space as _space

__all__ = ["TuneResult", "tune", "measure_candidate", "serve_idle_tune",
           "decode_idle_tune"]

def _budget_ms():
    return get_env("MXNET_AUTOTUNE_BUDGET_MS", float, 2000.0)


def _repeats():
    return get_env("MXNET_AUTOTUNE_REPEATS", int, 5)


def _warmup():
    return get_env("MXNET_AUTOTUNE_WARMUP", int, 2)


def _prune_k():
    return get_env("MXNET_AUTOTUNE_PRUNE", int, 0)


class TuneResult:
    """Outcome of one ``tune`` call: the winner plus a full audit trail
    (per-candidate status/ms, prune decisions, budget accounting)."""

    def __init__(self, site, key):
        self.site = site
        self.key = key
        self.winner = None
        self.winner_ms = None
        self.default_config = None
        self.default_ms = None
        self.candidates = []       # [{config, status, ms}]
        self.pruned = 0
        self.budget_exhausted = False
        self.committed = False
        self.clock = None          # "cuda_events" or "host"

    @property
    def improved(self):
        return (self.winner_ms is not None and self.default_ms is not None
                and self.winner != self.default_config
                and self.winner_ms < self.default_ms)

    def record(self):
        """The JSON-able store payload for this result."""
        return {
            "config": self.winner,
            "ms": self.winner_ms,
            "default_config": self.default_config,
            "default_ms": self.default_ms,
            "candidates": list(self.candidates),
            "pruned": self.pruned,
            "budget_exhausted": self.budget_exhausted,
            "clock": self.clock,
        }

    def as_dict(self):
        d = self.record()
        d.update({"site": self.site, "key": list(self.key)
                  if isinstance(self.key, (tuple, list)) else self.key,
                  "committed": self.committed,
                  "improved": self.improved})
        return d


def _trimmed_mean(samples):
    s = sorted(samples)
    if len(s) >= 4:
        s = s[1:-1]
    return sum(s) / len(s)


def _host(outs):
    """A bench's outputs as host tensors (numpy arrays are taken as
    they are)."""
    import torch

    return [torch.as_tensor(a).detach().cpu() for a in outs]


def _nonfinite(outs):
    import torch

    return any((a.is_floating_point() or a.is_complex())
               and not bool(torch.isfinite(a).all()) for a in outs)


_BITS = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def _bits(a):
    """The tensor's bytes as integers, so -0.0 and NaN payloads count."""
    import torch

    a = a.contiguous().reshape(-1)
    if a.is_complex():
        a = torch.view_as_real(a).reshape(-1)
    return a.view(getattr(torch, _BITS[a.element_size()]))


def _bit_identical(a_list, b_list):
    import torch

    if len(a_list) != len(b_list):
        return False
    for a, b in zip(a_list, b_list):
        if a.shape != b.shape or a.dtype != b.dtype or \
                not torch.equal(_bits(a), _bits(b)):
            return False
    return True


def measure_candidate(site, key, config, repeats=None, warmup=None,
                      audit=None):
    """``(host outputs, ms)`` for one config: build the bench, take the
    first run's outputs (kernel build and first-call costs excluded from
    the timing), discard ``warmup`` runs, trimmed-mean the rest.  A bench
    that carries ``device_ms`` after each run (the card's CUDA events) is
    timed by it, else by the host clock; ``audit['clock']`` says which.
    Raises whatever the bench raises: ``tune`` classifies."""
    repeats = _repeats() if repeats is None else int(repeats)
    warmup = _warmup() if warmup is None else int(warmup)
    fn = site.make_bench(key, config)
    with _trace.span("autotune_measure", hist=False, cat="autotune",
                     args={"site": site.name, "config": str(config)}):
        outs = _host(fn())  # first call: build + correctness sample
        for _ in range(max(0, warmup)):
            fn()
        host, device = [], []
        for _ in range(max(1, repeats)):
            t0 = _time.perf_counter()
            fn()
            host.append((_time.perf_counter() - t0) * 1000.0)
            dms = getattr(fn, "device_ms", None)
            if dms is not None:
                device.append(float(dms))
    if _tel.ENABLED:
        _tel.AUTOTUNE_MEASURE.labels(site=site.name).inc()
    clock = "cuda_events" if len(device) == len(host) else "host"
    if audit is not None:
        audit["clock"] = clock
    return outs, _trimmed_mean(device if clock == "cuda_events" else host)


def _reject(site_name, reason):
    if _tel.ENABLED:
        _tel.AUTOTUNE_REJECT.labels(site=site_name, reason=reason).inc()


def tune(site, key, budget_ms=None, repeats=None, warmup=None,
         store=None, commit=True, use_model=None):
    """Search a site's grid at ``key`` and persist the winner.

    The default config is ALWAYS measured first (it is the reference
    for the numerics guard and the incumbent to beat).  Candidates run
    until the wall-clock budget is exhausted; unmeasured candidates are
    recorded as ``skipped``.  Returns a ``TuneResult`` — the winner is
    the fastest config whose outputs are bit-identical to the
    default's, which is the default itself when nothing beats it."""
    from . import _resolve_store, fallback

    key = tuple(key)
    sp = site if isinstance(site, _space.TuningSite) \
        else _space.get_site(site)
    if sp.parity == "structural":
        raise MXNetError(
            "site %r is structural — it is tuned by its own idle tuner, "
            "not measure.tune()" % sp.name)
    budget_ms = _budget_ms() if budget_ms is None else float(budget_ms)
    res = TuneResult(sp.name, key)
    res.default_config = sp.default_config(key)
    t_start = _time.perf_counter()

    audit = {}
    try:
        ref_outs, res.default_ms = measure_candidate(
            sp, key, res.default_config, repeats, warmup, audit=audit)
    except Exception as exc:
        # the DEFAULT config failed to run: nothing to tune against —
        # degrade without touching the store
        fallback("measure_error")
        raise MXNetError(
            "autotune %s: default config %r failed to measure: %r"
            % (sp.name, res.default_config, exc)) from exc
    res.clock = audit["clock"]
    if _nonfinite(ref_outs):
        fallback("nonfinite_reference")
        raise MXNetError(
            "autotune %s: default config produced nonfinite outputs — "
            "refusing to tune against a sick reference" % sp.name)

    cands = [c for c in sp.candidates(key) if c != res.default_config]
    if use_model is None:
        use_model = _prune_k() > 0
    if use_model and len(cands) > 1:
        from .model import CostModel

        st = store if store is not None else _resolve_store()
        if st is not None:
            kept = CostModel(st, clock=res.clock).prune(sp, key, cands,
                                       keep=max(1, _prune_k()))
            res.pruned = len(cands) - len(kept)
            cands = kept

    best_cfg, best_ms = res.default_config, res.default_ms
    for cfg in cands:
        if (_time.perf_counter() - t_start) * 1000.0 >= budget_ms:
            res.budget_exhausted = True
            res.candidates.append(
                {"config": cfg, "status": "skipped", "ms": None})
            continue
        try:
            outs, ms = measure_candidate(sp, key, cfg, repeats, warmup,
                                         audit=audit)
        except Exception:
            _reject(sp.name, "error")
            res.candidates.append(
                {"config": cfg, "status": "rejected_error", "ms": None})
            continue
        if len(outs) != len(ref_outs) or any(
                a.shape != b.shape for a, b in zip(outs, ref_outs)):
            _reject(sp.name, "shape")
            res.candidates.append(
                {"config": cfg, "status": "rejected_shape", "ms": ms})
            continue
        if _nonfinite(outs):
            _reject(sp.name, "nonfinite")
            res.candidates.append(
                {"config": cfg, "status": "rejected_nonfinite", "ms": ms})
            continue
        if not _bit_identical(outs, ref_outs):
            _reject(sp.name, "numerics")
            res.candidates.append(
                {"config": cfg, "status": "rejected_numerics", "ms": ms})
            continue
        res.candidates.append({"config": cfg, "status": "ok", "ms": ms,
                               "clock": audit["clock"]})
        if ms < best_ms:
            best_cfg, best_ms = cfg, ms

    res.winner, res.winner_ms = best_cfg, best_ms
    if _tel.ENABLED:
        _tel.AUTOTUNE_TUNE_SECONDS.observe(
            _time.perf_counter() - t_start)
    if commit:
        st = store if store is not None else _resolve_store()
        if st is not None and st.put(sp.name, list(key),
                                     res.record()) is not None:
            res.committed = True
            from . import invalidate_cache

            invalidate_cache(sp.name, key)
        elif st is not None:
            fallback("store_write")
    return res


# ---------------------------------------------------------------------------
# serve idle-time tuners (bounded, warm-up only, nothing user-visible
# can fail — the breaker/deadline envelope around live dispatch is
# untouched because these only ever run against idle warm programs)
# ---------------------------------------------------------------------------

def _idle_deadline():
    return _time.perf_counter() + _budget_ms() / 1000.0


def serve_idle_tune(runner, store=None):
    """Time each warm ModelRunner bucket's forward (zero inputs; every
    run reads its outputs back to the host) and record the table under
    the ``serve_bucket`` site: data for the cost model.  Budget-bounded;
    returns the bucket -> ms table (possibly partial), or None when
    nothing was measured."""
    import numpy as _np

    from ..serve.runner import _bucket_label
    from . import _resolve_store

    if not runner.warmed:
        return None
    deadline = _idle_deadline()
    table = {}
    for b, sig in runner.bucket_table():
        if not sig or _time.perf_counter() >= deadline:
            break
        label = _bucket_label(b, sig)
        bufs = [_np.zeros((b,) + tuple(s), dtype=runner._dtype)
                for s in sig]
        with _trace.span("autotune_measure", hist=False, cat="autotune",
                         args={"site": "serve_bucket", "config": label}):
            runner._forward(bufs)  # warm
            samples = []
            for _ in range(max(1, _repeats())):
                if _time.perf_counter() >= deadline:
                    break
                t0 = _time.perf_counter()
                runner._forward(bufs)
                samples.append((_time.perf_counter() - t0) * 1000.0)
        if samples:
            table[label] = _trimmed_mean(samples)
            if _tel.ENABLED:
                _tel.AUTOTUNE_MEASURE.labels(site="serve_bucket").inc()
    if not table:
        return None
    st = store if store is not None else _resolve_store()
    if st is None:
        return table
    key = [type(runner.block).__name__, str(runner._dtype),
           sorted(table.keys())]
    st.put("serve_bucket", key, {"config": None, "buckets": table})
    return table


def decode_idle_tune(runner, store=None):
    """Tune the ``decode_bucket`` site during decode warm-up: time each
    decode batch bucket of every candidate set against null inputs (page
    tables of the drop page only, so the pool is untouched), score each
    candidate set under a uniform live count, and commit the cheapest.
    The next process's ``DecodeConfig`` looks the winner up."""
    from . import _resolve_store, invalidate_cache

    cfg = runner.config
    max_live = int(cfg.max_live)
    deadline = _idle_deadline()
    sp0 = _space.get_site("decode_bucket")
    # measure the UNION of every candidate set's buckets, not just the
    # current table: a previously-committed narrow winner must not
    # ratchet — scoring the full grid each pass lets the table widen
    # again when the measurements say so.  Buckets outside the current
    # table get their program built here (idle time, budget-bounded).
    to_measure = sorted(set(int(b) for b in cfg.batch_sizes)
                        | {int(b) for cand in sp0.candidates((max_live,))
                           for b in cand})
    per_bucket = {}
    for b in to_measure:
        if _time.perf_counter() >= deadline:
            break
        key = ("decode", b)
        inputs = runner._null_inputs(b, 1)
        try:
            with _trace.span("autotune_measure", hist=False,
                             cat="autotune",
                             args={"site": "decode_bucket", "config": b}):
                runner._run(key, inputs)  # builds where needed, warms
                samples = []
                for _ in range(max(1, _repeats())):
                    if _time.perf_counter() >= deadline:
                        break
                    t0 = _time.perf_counter()
                    runner._run(key, inputs)
                    samples.append((_time.perf_counter() - t0) * 1000.0)
        except Exception:  # noqa: BLE001 - an unbuildable bucket's sets
            continue       # stay unscored
        if samples:
            per_bucket[int(b)] = _trimmed_mean(samples)
            if _tel.ENABLED:
                _tel.AUTOTUNE_MEASURE.labels(site="decode_bucket").inc()
    if not per_bucket:
        return None

    sp = _space.get_site("decode_bucket")
    key = (max_live,)

    def expected_ms(bucket_set):
        buckets = sorted(bucket_set)
        total = 0.0
        for n in range(1, max_live + 1):
            covering = next((b for b in buckets if b >= n), buckets[-1])
            if covering not in per_bucket:
                return None  # unmeasured member: can't score this set
            total += per_bucket[covering]
        return total / max_live

    scored = []
    for cand in sp.candidates(key):
        ms = expected_ms(cand)
        if ms is not None:
            scored.append((ms, sorted(int(b) for b in cand)))
    if not scored:
        return None
    scored.sort(key=lambda t: (t[0], len(t[1])))
    winner_ms, winner = scored[0]
    default = sp.default_config(key)
    rec = {"config": winner, "ms": winner_ms,
           "default_config": default,
           "default_ms": expected_ms(default),
           "per_bucket_ms": {str(k): v for k, v in per_bucket.items()},
           "candidates": [{"config": c, "ms": m, "status": "ok"}
                          for m, c in scored]}
    st = store if store is not None else _resolve_store()
    if st is not None and st.put("decode_bucket", list(key),
                                 rec) is not None:
        invalidate_cache("decode_bucket", key)
    return rec
