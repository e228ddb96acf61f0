"""mx.monitor core: the training-health stat plane.

Counterpart of ``mxnet_tpu/monitor/core.py``.  ``observe_update`` sits in
``optimizer/multi_tensor.apply_updates``: it sees the groups the grouped
apply built, reduces each to a stat vector on the device
(``stats.group_stats``) before any update runs, and hands the vectors to
``gate_and_publish``.  A captured step (``step/capture.py``) computes the
same vectors inside its graph and hands them over through
``observe_captured``, so both paths trip, count and publish alike.

- Sync policies (``skip_step``/``raise``) read the vectors at once and
  may veto the step or raise.
- Async policies (``warn``/``off``) keep the device vectors pending and
  publish them at the next observation, or when ``flush``, ``summary``,
  ``group_values`` or ``health`` is called: the step does not wait on its
  own stats.  The JAX package's publisher thread, its bounded ring and
  the JSONL stream (``MXNET_MONITOR_STREAM``) are not ported, nor is the
  divergence detector.

Off by default: ``MXNET_MONITOR=1`` or ``enable()``.  Off, the trainer
hook costs one boolean check.
"""
from __future__ import annotations

import logging
import math
import threading
import time

from .. import telemetry as _tel
from .. import trace as _trace
from ..base import MXNetError, get_env
from . import sentinel, stats

__all__ = ["ENABLED", "enable", "disable", "is_enabled",
           "observe_update", "observe_captured", "gate_and_publish",
           "flush", "summary", "health", "reset", "group_values"]

_LOGGER = logging.getLogger("mxnet_tpu_torch.monitor")

ENABLED = get_env("MXNET_MONITOR", bool, False)

_LOCK = threading.Lock()
_PENDING = []        # entries whose device vectors are not published yet


def _new_summary():
    return {"steps": 0, "grad_global_norm_last": 0.0,
            "grad_global_norm_max": 0.0, "nonfinite_steps": 0,
            "skipped_steps": 0, "dropped": 0}


_SUMMARY = _new_summary()
_LAST_GROUPS = {}    # label -> last published host stats


def enable():
    """Turn the monitor on (module-wide)."""
    global ENABLED
    ENABLED = True


def disable():
    """Turn the monitor off; the summary keeps its values."""
    global ENABLED
    ENABLED = False


def is_enabled():
    return ENABLED


# ---------------------------------------------------------------------------
# the trainer hook
# ---------------------------------------------------------------------------

def _group_label(trainer, key, members):
    """Optimizer class + the first member's parameter name (+ how many
    more): members are in ascending index order, so the label names the
    earliest layer of the group."""
    i0 = members[0][0]
    names = trainer._param_names
    name = str(names[i0]) if 0 <= i0 < len(names) else str(i0)
    label = "%s:%s" % (key[0] if isinstance(key, tuple) and key
                       else type(trainer._optimizer).__name__, name)
    if len(members) > 1:
        label += "+%d" % (len(members) - 1)
    return label


def _dense_eager(eager):
    return [(i, p, g) for i, p, g, reason in eager
            if reason not in ("row_sparse", "stype")]


def observe_update(trainer, groups, eager):
    """Monitor one optimizer apply.  Returns ``"skip"`` when the sentinel
    vetoed the step, else ``"ok"``; raises ``MXNetError`` under
    policy=raise.  A failed reduction leaves the step unmonitored."""
    if not ENABLED:
        return "ok"
    step = trainer._step_count
    interval = get_env("MXNET_MONITOR_INTERVAL", int, 1)
    if interval > 1 and step % interval:
        return "ok"
    pol = sentinel.policy()
    entries = []
    try:
        for key, members in groups.items():
            entries.append((_group_label(trainer, key, members),
                            stats.group_stats([p for _, p, _ in members],
                                              [g for _, _, g in members])))
        dense = _dense_eager(eager)
        if dense:
            entries.append(("%s:eager" % type(trainer._optimizer).__name__,
                            stats.group_stats([p for _, p, _ in dense],
                                              [g for _, _, g in dense])))
    except Exception:
        _LOGGER.warning("mx.monitor: stat reduction failed; step %d runs "
                        "unmonitored", step, exc_info=True)
        return "ok"
    if not entries:
        return "ok"
    return gate_and_publish(step, entries, pol)


def gate_and_publish(step, entries, pol):
    """The sentinel gate and the publication of one observed step.
    ``entries`` is ``[(label, stat vector)]`` in ascending-index group
    order.  Sync policies read the vectors here and may return
    ``"skip"`` or raise; async ones leave them pending."""
    _drain()
    if pol not in sentinel.SYNC_POLICIES:
        with _LOCK:
            _PENDING.append((step, entries, pol))
        return "ok"
    t0 = time.perf_counter()
    host = {label: stats.unpack(vec.cpu()) for label, vec in entries}
    if _tel.ENABLED:
        _tel.MONITOR_FETCH_SECONDS.observe(time.perf_counter() - t0)
    label, st = sentinel.first_offender(host)
    if label is None:
        _publish(step, host, pol, skipped=False, tripped=False)
        return "ok"
    if _tel.ENABLED:
        _tel.MONITOR_SENTINEL_TRIPS.labels(policy=pol).inc()
        _tel.MONITOR_NONFINITE_STEPS.inc()
    _trace.instant("monitor_sentinel_trip", cat="monitor",
                   args={"group": label, "policy": pol, "step": step,
                         "grad_nonfinite": int(st["g_nonfinite"])})
    skipped = pol == "skip_step"
    if skipped and _tel.ENABLED:
        _tel.MONITOR_SKIPPED_STEPS.inc()
    _publish(step, host, pol, skipped=skipped, tripped=True)
    if skipped:
        _LOGGER.warning(
            "mx.monitor: step %d SKIPPED -- nonfinite gradients in group "
            "%s (%d elements); parameters and optimizer state untouched",
            step, label, int(st["g_nonfinite"]))
        return "skip"
    raise MXNetError(
        "mx.monitor sentinel: nonfinite gradients in group %s at step %d "
        "(%d elements, policy=raise)" % (label, step, int(st["g_nonfinite"])))


def observe_captured(trainer, step, entries):
    """Publish the stat vectors a captured step computed inside its
    graph.  Returns ``"skip"`` when the sentinel vetoes the step (the
    graph already selected the old values on the device; the caller
    rewinds its host counts), else ``"ok"``; raises under policy=raise.
    Stats arrive every captured step, whatever
    ``MXNET_MONITOR_INTERVAL`` says."""
    if not ENABLED or not entries:
        return "ok"
    return gate_and_publish(step, entries, sentinel.policy())


# ---------------------------------------------------------------------------
# publication
# ---------------------------------------------------------------------------

def _drain():
    """Publish every pending (async-policy) entry."""
    with _LOCK:
        pending = _PENDING[:]
        del _PENDING[:]
    for step, entries, pol in pending:
        host = {label: stats.unpack(vec.cpu()) for label, vec in entries}
        label, st = sentinel.first_offender(host)
        if label is not None:
            if _tel.ENABLED:
                _tel.MONITOR_NONFINITE_STEPS.inc()
            if pol == "warn":
                if _tel.ENABLED:
                    _tel.MONITOR_SENTINEL_TRIPS.labels(policy="warn").inc()
                sentinel.warn_trip(label, st, step)
        _publish(step, host, pol, skipped=False, tripped=label is not None)


def _publish(step, host, pol, skipped, tripped):
    gnorm = math.sqrt(max(sum(st["g_sq_sum"] for st in host.values()),
                          0.0))
    nonfinite_g = sum(st["g_nonfinite"] for st in host.values())
    if _tel.ENABLED:
        for label, st in host.items():
            _tel.MONITOR_GRAD_NORM.labels(group=label).set(st["g_norm"])
            _tel.MONITOR_WEIGHT_NORM.labels(group=label).set(st["w_norm"])
            _tel.MONITOR_GRAD_MAX.labels(group=label).set(st["g_max_abs"])
            _tel.MONITOR_WEIGHT_MAX.labels(group=label).set(
                st["w_max_abs"])
            if st["g_nonfinite"]:
                _tel.MONITOR_NONFINITE.labels(
                    kind="grad", group=label).inc(st["g_nonfinite"])
            if st["w_nonfinite"]:
                _tel.MONITOR_NONFINITE.labels(
                    kind="weight", group=label).inc(st["w_nonfinite"])
        _tel.MONITOR_GRAD_GLOBAL_NORM.set(gnorm)
    with _LOCK:
        _SUMMARY["steps"] += 1
        _SUMMARY["grad_global_norm_last"] = gnorm
        _SUMMARY["grad_global_norm_max"] = max(
            _SUMMARY["grad_global_norm_max"], gnorm)
        if nonfinite_g:
            _SUMMARY["nonfinite_steps"] += 1
        if skipped:
            _SUMMARY["skipped_steps"] += 1
        _LAST_GROUPS.clear()
        _LAST_GROUPS.update(host)


# ---------------------------------------------------------------------------
# introspection / lifecycle
# ---------------------------------------------------------------------------

def flush(timeout=None):
    """Publish every pending entry; returns True (publication runs on
    the calling thread, so there is nothing to wait for)."""
    _drain()
    return True


def summary(reset_peak=False):
    """Run-level health summary: observed steps, last/max global gradient
    norm, nonfinite and skipped step counts.  ``reset_peak`` restarts
    the max from zero."""
    _drain()
    with _LOCK:
        out = dict(_SUMMARY)
        if reset_peak:
            _SUMMARY["grad_global_norm_max"] = 0.0
    return out


def group_values():
    """Last published per-group stats ``{label: stats}``."""
    _drain()
    with _LOCK:
        return {k: dict(v) for k, v in _LAST_GROUPS.items()}


def health():
    """Compact health dict: the summary fields that matter across runs,
    plus whether the monitor is on."""
    s = summary()
    return {"enabled": ENABLED, "steps": s["steps"],
            "nonfinite_steps": s["nonfinite_steps"],
            "skipped_steps": s["skipped_steps"],
            "grad_global_norm_last": s["grad_global_norm_last"]}


def reset(clear_programs=False):
    """Zero the summary and drop pending entries (tests, between runs)."""
    global _SUMMARY
    with _LOCK:
        del _PENDING[:]
        _SUMMARY = _new_summary()
        _LAST_GROUPS.clear()
