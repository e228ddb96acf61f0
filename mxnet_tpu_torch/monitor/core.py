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
- Async policies (``warn``/``off``) never read them on the step's thread:
  each observation goes, as a device copy of its vectors and an event
  after it, into a bounded ring (``MXNET_MONITOR_RING`` entries, 256)
  that a publisher thread drains.  A full ring displaces its oldest entry
  without trip evidence, counted in ``monitor_dropped_total``.

The publisher turns each entry into the ``monitor_*`` gauges and
counters, a line of the JSONL stream (``MXNET_MONITOR_STREAM=<path>``),
the divergence detector's feed (``divergence.py``: nonfinite gradients
naming the group, grad-norm spikes) and the run summary.  ``flush``
waits until the ring is drained; ``shutdown`` stops the thread.

Off by default: ``MXNET_MONITOR=1`` or ``enable()``.  Off, the trainer
hook costs one boolean check.
"""
from __future__ import annotations

import json
import logging
import math
import threading
import time

from .. import telemetry as _tel
from .. import trace as _trace
from ..base import MXNetError, get_env
from . import divergence, sentinel, stats

__all__ = ["ENABLED", "enable", "disable", "is_enabled",
           "observe_update", "observe_captured", "gate_and_publish",
           "flush", "summary", "health", "reset", "stream_path",
           "group_values", "shutdown"]

_LOGGER = logging.getLogger("mxnet_tpu_torch.monitor")

ENABLED = get_env("MXNET_MONITOR", bool, False)

_COND = threading.Condition()
_QUEUE = []          # pending entries, oldest first
_BUSY = [False]      # publisher mid-publish (flush must wait it out)
_THREAD = [None]
_STOP = [False]      # asks the publisher to exit once the ring is empty
_STREAM = [None, None]  # (path, file handle)

_SUM_LOCK = threading.Lock()


def _new_summary():
    return {"steps": 0, "grad_global_norm_last": 0.0,
            "grad_global_norm_max": 0.0, "nonfinite_steps": 0,
            "skipped_steps": 0, "dropped": 0}


_SUMMARY = _new_summary()
_LAST_GROUPS = {}    # label -> last published host stats


def enable():
    """Turn the monitor on (module-wide).  Re-reads the divergence
    detector's env knobs, so enabling at run time after setting
    MXNET_MONITOR_SPIKE_*/_PLATEAU_WINDOW acts as enabling at import."""
    global ENABLED
    divergence.DETECTOR.refresh_env()
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


def _host(vec):
    """One entry's stats as a named dict: a device copy is read once the
    event recorded after it has passed, on the thread that asks."""
    if isinstance(vec, dict):
        return vec
    if isinstance(vec, tuple):
        vec, ready = vec
        ready.synchronize()
    return stats.unpack(vec.cpu())


def _snapshot(vec):
    """A copy of a stat vector that later steps cannot overwrite (a
    captured step's outputs are its graph's buffers), with an event on the
    current stream after the copy when it lies on the card."""
    import torch

    if isinstance(vec, dict):
        return vec
    copy = vec.detach().clone()
    if not copy.is_cuda:
        return copy
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(copy.device))
    return copy, ready


def gate_and_publish(step, entries, pol):
    """The sentinel gate and the publication of one observed step.
    ``entries`` is ``[(label, stat vector)]`` in ascending-index group
    order.  Sync policies read the vectors here (``monitor_fetch_seconds``
    meters the wait) and may return ``"skip"`` or raise (policy=raise);
    async ones hand copies to the publisher without reading them."""
    if pol not in sentinel.SYNC_POLICIES:
        _enqueue(step, [(label, _snapshot(vec)) for label, vec in entries],
                 pol, skipped=False, tripped=False)
        return "ok"
    t0 = time.perf_counter()
    host = {label: _host(vec) for label, vec in entries}
    if _tel.ENABLED:
        _tel.MONITOR_FETCH_SECONDS.observe(time.perf_counter() - t0)
    label, st = sentinel.first_offender(host)
    if label is None:
        _enqueue(step, list(host.items()), pol, skipped=False,
                 tripped=False)
        return "ok"
    if _tel.ENABLED:
        _tel.MONITOR_SENTINEL_TRIPS.labels(policy=pol).inc()
        _tel.MONITOR_NONFINITE_STEPS.inc()
    divergence.DETECTOR.nonfinite(label, st, step=step, policy=pol)
    _trace.instant("monitor_sentinel_trip", cat="monitor",
                   args={"group": label, "policy": pol, "step": step,
                         "grad_nonfinite": int(st["g_nonfinite"])})
    skipped = pol == "skip_step"
    if skipped and _tel.ENABLED:
        _tel.MONITOR_SKIPPED_STEPS.inc()
    _enqueue(step, list(host.items()), pol, skipped=skipped, tripped=True)
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
# bounded ring + publisher thread
# ---------------------------------------------------------------------------

_SEQ = [0]  # observation counter: a skipped step and its retry share a
# trainer step id, so stream readers need seq for an unambiguous x-axis


def _enqueue(step, entry_stats, pol, skipped, tripped):
    cap = max(1, get_env("MXNET_MONITOR_RING", int, 256))
    with _SUM_LOCK:
        _SEQ[0] += 1
        seq = _SEQ[0]
    entry = {"seq": seq, "step": step, "stats": entry_stats,
             "policy": pol, "skipped": skipped, "tripped": tripped,
             "time": time.time()}
    with _COND:
        if len(_QUEUE) >= cap:
            # displace an entry without trip evidence where there is one;
            # its step-level flags still reach the summary
            victim_idx = next((j for j, e in enumerate(_QUEUE)
                               if not e["tripped"]), 0)
            victim = _QUEUE.pop(victim_idx)
            with _SUM_LOCK:
                _SUMMARY["dropped"] += 1
                _SUMMARY["steps"] += 1
                if victim["tripped"]:
                    _SUMMARY["nonfinite_steps"] += 1
                if victim["skipped"]:
                    _SUMMARY["skipped_steps"] += 1
            if _tel.ENABLED:
                _tel.MONITOR_DROPS.inc()
        _QUEUE.append(entry)
        _STOP[0] = False
        t = _THREAD[0]
        if t is None or not t.is_alive():
            t = threading.Thread(target=_publisher_loop, daemon=True,
                                 name="mx-monitor-publish")
            _THREAD[0] = t
            t.start()
        _COND.notify_all()


def _publisher_loop():
    while True:
        with _COND:
            while not _QUEUE:
                _COND.notify_all()  # wake any flush() waiter
                if _STOP[0]:
                    # under the lock: the next _enqueue starts a thread
                    # of its own rather than hand entries to this one
                    if _THREAD[0] is threading.current_thread():
                        _THREAD[0] = None
                    return
                _COND.wait()
            entry = _QUEUE.pop(0)
            _BUSY[0] = True
        try:
            _publish(entry)
        except Exception:  # noqa: BLE001 - the publisher must survive
            _LOGGER.exception("mx.monitor: publish failed")
        finally:
            with _COND:
                _BUSY[0] = False
                _COND.notify_all()


def _publish(entry):
    host = {label: _host(vec) for label, vec in entry["stats"]}
    step = entry["step"]
    gnorm = math.sqrt(max(sum(st["g_sq_sum"] for st in host.values()),
                          0.0))
    nonfinite_g = int(sum(st["g_nonfinite"] for st in host.values()))
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
        _tel.MONITOR_GRAD_GLOBAL_NORM_HIST.observe(gnorm)
    if nonfinite_g and not entry["tripped"]:
        # async policies (warn/off) account their trips here, a step or
        # two after the fact: the price of never blocking step()
        if _tel.ENABLED:
            _tel.MONITOR_NONFINITE_STEPS.inc()
        label, st = sentinel.first_offender(host)
        if entry["policy"] == "warn":
            if _tel.ENABLED:
                _tel.MONITOR_SENTINEL_TRIPS.labels(policy="warn").inc()
            sentinel.warn_trip(label, st, step)
        divergence.DETECTOR.nonfinite(label, st, step=step,
                                      policy=entry["policy"])
    if not nonfinite_g:
        # a nonfinite step stays out of the spike window (its cleaned
        # norm under-reports), and its dump already fired
        divergence.DETECTOR.observe_grad_norm(gnorm, step=step)
    with _SUM_LOCK:
        _SUMMARY["steps"] += 1
        _SUMMARY["grad_global_norm_last"] = gnorm
        _SUMMARY["grad_global_norm_max"] = max(
            _SUMMARY["grad_global_norm_max"], gnorm)
        if nonfinite_g:
            _SUMMARY["nonfinite_steps"] += 1
        if entry["skipped"]:
            _SUMMARY["skipped_steps"] += 1
        _LAST_GROUPS.clear()
        _LAST_GROUPS.update(host)
    _stream_write(entry, host, gnorm)


# ---------------------------------------------------------------------------
# JSONL stream
# ---------------------------------------------------------------------------

def stream_path():
    """The per-step JSONL stream destination (``MXNET_MONITOR_STREAM``;
    None = off)."""
    return get_env("MXNET_MONITOR_STREAM", str, None)


def _stream_write(entry, host, gnorm):
    path = stream_path()
    if not path:
        return
    try:
        if _STREAM[0] != path:
            if _STREAM[1] is not None:
                _STREAM[1].close()
            _STREAM[0], _STREAM[1] = path, open(path, "a")
        line = {"seq": entry["seq"], "step": entry["step"],
                "time": round(entry["time"], 3),
                "skipped": entry["skipped"],
                "policy": entry["policy"],
                "grad_global_norm": round(gnorm, 8),
                "groups": {
                    label: {"grad_norm": round(st["g_norm"], 8),
                            "grad_max_abs": round(st["g_max_abs"], 8),
                            "weight_norm": round(st["w_norm"], 8),
                            "weight_max_abs": round(st["w_max_abs"], 8),
                            "nonfinite_grad": int(st["g_nonfinite"]),
                            "nonfinite_weight": int(st["w_nonfinite"])}
                    for label, st in host.items()}}
        _STREAM[1].write(json.dumps(line) + "\n")
        _STREAM[1].flush()
    except OSError:
        _LOGGER.warning("mx.monitor: stream write to %s failed", path,
                        exc_info=True)


# ---------------------------------------------------------------------------
# introspection / lifecycle
# ---------------------------------------------------------------------------

def flush(timeout=None):
    """Block until the publisher has drained every queued entry; True
    when drained, False on timeout."""
    with _COND:
        _COND.notify_all()
        return _COND.wait_for(lambda: not _QUEUE and not _BUSY[0],
                              timeout)


def shutdown(timeout=None):
    """Drain the ring, stop the publisher thread and join it; True when
    it has ended (the next observation starts a new one)."""
    with _COND:
        _STOP[0] = True
        _COND.notify_all()
        t = _THREAD[0]
    if t is not None:
        t.join(timeout)
        if t.is_alive():
            return False
    return True


def _drained():
    """Wait for the publisher, unless this is the publisher itself (a
    divergence listener reading the summary)."""
    if threading.current_thread() is not _THREAD[0]:
        flush()


def summary(reset_peak=False):
    """Run-level health summary: observed steps, last/max global gradient
    norm, nonfinite and skipped step counts, ring drops, once the
    publisher has drained the ring.  ``reset_peak`` restarts the max from
    zero."""
    _drained()
    with _SUM_LOCK:
        out = dict(_SUMMARY)
        if reset_peak:
            _SUMMARY["grad_global_norm_max"] = 0.0
    return out


def group_values():
    """Last published per-group stats ``{label: stats}``, once the
    publisher has drained the ring."""
    _drained()
    with _SUM_LOCK:
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
    """Zero the summary, the ring and the detector's state (tests, between
    runs)."""
    global _SUMMARY
    with _COND:
        del _QUEUE[:]
    with _SUM_LOCK:
        _SUMMARY = _new_summary()
        _LAST_GROUPS.clear()
        _SEQ[0] = 0
    divergence.DETECTOR.reset()
    if _STREAM[1] is not None:
        try:
            _STREAM[1].close()
        except OSError:
            pass
        _STREAM[0] = _STREAM[1] = None
