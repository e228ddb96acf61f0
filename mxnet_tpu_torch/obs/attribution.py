"""Step-time attribution: where did each training step's wall time go?

Counterpart of ``mxnet_tpu/obs/attribution.py``.  ``observe_step`` is
called once per step by the step engines with the phase durations they
already bracket — the captured path passes slots / stage / dispatch
(and host_publish under the monitor), the stitched path passes forward
/ backward / update (both stitched engines bracket them with
``StepParts``).  These are host times: no synchronize is added for
them, so a captured step's dispatch is the host's share and the device
work lands in later steps' parts.  Attribution adds the **data-wait**
share itself from the ``dataloader_batch_wait_seconds`` histogram delta
between steps (loader wait happens *outside* the step span, so no engine
can measure it), normalizes everything into shares of the step total,
and estimates **MFU** from the captured program's FLOP count
(``step/capture.py`` counts it once with
``torch.utils.flop_counter.FlopCounterMode`` over the program's eager
recording pass; ``StepProgram.report()`` surfaces it — the flash
kernels are ctypes launches it does not see, as XLA's cost analysis
does not see the Pallas calls) against the card's peak
(``MXNET_OBS_PEAK_TFLOPS`` override, else a table of NVIDIA cards by
``torch.cuda.get_device_name()``, dense bf16; unknown cards and the CPU
report ``mfu: null`` rather than an invented peak).

Each record is one compact JSON line appended to
``MXNET_OBS_ATTRIBUTION`` (schema below) — the per-step feature
stream for a learned performance model over real traces:

    {"ver": 1, "time": ..., "step": n, "path": "captured",
     "total_s": ..., "parts_s": {...}, "shares": {..., "other": r},
     "flops": ..., "mfu": ...}

``shares`` always sums to <= 1 (+eps): parts are clamped to the step
total and the residual lands in ``other``.  Fail-soft like every obs
hook: a full disk or bad path counts nothing and never raises into
the step."""
from __future__ import annotations

import json
import threading
import time

from .. import telemetry as _tel
from ..base import get_env
from . import core

__all__ = ["observe_step", "summary", "reset", "peak_flops",
           "stream_path", "SCHEMA_KEYS"]

SCHEMA_KEYS = ("ver", "time", "step", "path", "total_s", "parts_s",
               "shares", "flops", "mfu")

_LOCK = threading.Lock()
_STREAM = [None, None]   # (path, handle)
_COUNT = [0]
_LAST = [None]
_WAIT_SUM = [None]       # last seen dataloader wait-histogram sum


def stream_path():
    """JSONL destination (``MXNET_OBS_ATTRIBUTION``), or None."""
    return get_env("MXNET_OBS_ATTRIBUTION", str, None)


# dense bf16 peak TFLOP/s by a substring of torch.cuda.get_device_name()
# (lower case), first match wins: the SXM H100's 989 is the figure the
# port's MFU numbers use
PEAK_TFLOPS = (("h100 80gb hbm3", 989.0), ("h100 sxm", 989.0))


def peak_flops():
    """Per-card peak FLOP/s for the MFU estimate:
    ``MXNET_OBS_PEAK_TFLOPS`` when set, else the dense bf16 figure of
    the card ``torch.cuda.get_device_name()`` names (``PEAK_TFLOPS``);
    None for unknown cards and the CPU — an MFU against an invented
    peak would be worse than no MFU."""
    override = get_env("MXNET_OBS_PEAK_TFLOPS", float, None)
    if override:
        return float(override) * 1e12
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        kind = torch.cuda.get_device_name().lower()
    except Exception:  # noqa: BLE001 - backend down
        return None
    for pat, tflops in PEAK_TFLOPS:
        if pat in kind:
            return tflops * 1e12
    return None


def _data_wait_delta():
    """Loader wait accumulated since the previous step (seconds),
    from the dataloader_batch_wait_seconds histogram sum."""
    m = _tel.get_metric("dataloader_batch_wait_seconds")
    if m is None or m.kind != "histogram":
        return 0.0
    _count, total, _cum = _tel._merged_read(m)
    prev, _WAIT_SUM[0] = _WAIT_SUM[0], total
    if prev is None:
        return 0.0
    return max(0.0, total - prev)


def _stream_write(rec):
    path = stream_path()
    if not path:
        return
    if _STREAM[0] != path:
        if _STREAM[1] is not None:
            _STREAM[1].close()
        _STREAM[0], _STREAM[1] = path, open(path, "a")
    _STREAM[1].write(json.dumps(rec) + "\n")
    _STREAM[1].flush()


def observe_step(step, total_s, parts=None, flops=None,
                 path="captured"):
    """Record one step's attribution.  ``parts`` maps phase name ->
    seconds (the engine's span-bracketed durations); data-wait is
    added here; the un-attributed residual lands in ``other``.
    Returns the record, or None when obs is off / the step total is
    unusable.  Never raises."""
    if not core.ENABLED:
        return None
    try:
        total_s = float(total_s)
        if total_s <= 0:
            return None
        parts_s = {k: max(0.0, float(v))
                   for k, v in (parts or {}).items()}
        wait = _data_wait_delta()
        if wait > 0:
            parts_s["data_wait"] = wait
        shares, used = {}, 0.0
        for k, v in parts_s.items():
            s = min(1.0, v / total_s)
            shares[k] = round(s, 6)
            used += s
        shares["other"] = round(max(0.0, 1.0 - used), 6)
        flops = None if flops is None else float(flops)
        peak = peak_flops() if flops else None
        mfu = None if not flops or not peak \
            else round(flops / total_s / peak, 6)
        rec = {"ver": 1, "time": time.time(), "step": int(step),
               "path": str(path), "total_s": round(total_s, 6),
               "parts_s": {k: round(v, 6) for k, v in parts_s.items()},
               "shares": shares, "flops": flops, "mfu": mfu}
        with _LOCK:
            _COUNT[0] += 1
            _LAST[0] = rec
            _stream_write(rec)
        if _tel.ENABLED:
            _tel.OBS_ATTRIB_RECORDS.inc()
        return rec
    except Exception:  # noqa: BLE001 - never raise into the step
        return None


class StepParts:
    """One stitched step's parts, timed on the host for ``observe_step``:
    ``mark(name)`` closes the part begun at the previous mark (or at
    construction), ``observe()`` records the step.  Inert while obs is
    off, so the engines bracket their parts with it unconditionally."""

    def __init__(self, step, path="stitched"):
        self._step, self._path = step, path
        self._names = []
        self._marks = [time.perf_counter()] if core.ENABLED else None

    def mark(self, name):
        if self._marks is not None:
            self._names.append(name)
            self._marks.append(time.perf_counter())

    def observe(self):
        """The step's record (``observe_step``), or None while obs is
        off.  Never raises."""
        m = self._marks
        if m is None:
            return None
        return observe_step(
            self._step, m[-1] - m[0],
            parts={n: m[i + 1] - m[i] for i, n in enumerate(self._names)},
            path=self._path)


def summary():
    """{records, last} for diagnose and bench rows."""
    with _LOCK:
        return {"records": _COUNT[0], "last": _LAST[0]}


def reset():
    """Tests / between bench rows: close the stream, zero the state."""
    with _LOCK:
        if _STREAM[1] is not None:
            try:
                _STREAM[1].close()
            except OSError:
                pass
        _STREAM[0] = _STREAM[1] = None
        _COUNT[0] = 0
        _LAST[0] = None
        _WAIT_SUM[0] = None
