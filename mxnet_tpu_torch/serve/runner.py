"""ModelRunner: shape-bucketed model execution on one device.

Counterpart of ``mxnet_tpu/serve/runner.py``.  The runner owns everything
shape-related on the serving path:

- **device**: the block is moved onto ``ctx`` (default ``gpu(0)``; pass
  ``ctx=mx.cpu()`` for the CPU).  Without a card and without a CPU ctx it
  raises.
- **weights**: with ``root``, the block's parameters are restored from an
  ``mx.checkpoint`` root of either package (``step``, default the latest
  committed) through ``block.load_checkpoint`` onto that device.  A runner
  never changes its model after construction: ``Server.swap`` builds a new
  runner and publishes it.
- **bucket table**: the cross product of ``batch_sizes`` and
  ``sample_shapes``.  ``warm_up()`` runs every bucket once before
  readiness, so the first live request pays no first-call cost (kernel
  build and load, allocator growth).  There is no compile cache: the port
  runs eagerly.
- **pad / unpad**: samples are zero-padded up to the smallest covering
  sample bucket, stacked, and the batch is zero-padded up to the smallest
  covering batch size; outputs are sliced back to each request's extent.

Unpadding rule: output axis ``a`` (sample axis ``a-1``) is sliced back to
the request's extent when its size equals the padded size of the FIRST
input's corresponding sample axis.
"""
from __future__ import annotations

import time
from threading import RLock

import numpy as _np
import torch

from .. import telemetry, trace
from ..context import Context, device_of
from ..gluon.block import Block
from .batching import NoBucketError

__all__ = ["ModelRunner", "DEFAULT_BATCH_SIZES", "count_nonfinite"]

DEFAULT_BATCH_SIZES = (1, 2, 4, 8)


def count_nonfinite(arrays):
    """NaN/Inf elements across host float arrays."""
    bad = 0
    for a in arrays:
        if getattr(a.dtype, "kind", "") == "f":
            bad += int(a.size) - int(_np.isfinite(a).sum())
    return bad


def _normalize_sample_shapes(sample_shapes):
    """-> list of per-input shape tuples, sorted by padded volume (the
    bucket chooser scans in order, so the smallest covering bucket wins).
    Accepts bare shape tuples for single-input models."""
    out = []
    for sig in sample_shapes or ():
        if isinstance(sig, (tuple, list)) and \
                all(isinstance(d, int) for d in sig):
            sig = (tuple(sig),)
        out.append(tuple(tuple(s) for s in sig))
    out.sort(key=lambda sig: sum(int(_np.prod(s)) for s in sig))
    return out


def _bucket_label(batch, sig):
    return "%dx%s" % (batch, "|".join(
        ",".join(str(d) for d in s) for s in sig))


class ModelRunner:
    """Load-once, pad-and-run model executor.

    Parameters
    ----------
    block : Block or callable -- the model, or a zero-arg factory.
    root : str or None -- ``mx.checkpoint`` root to restore from.
    step : int or None -- checkpoint step (default: latest committed).
    ctx : Context or None -- serving device (default ``gpu(0)``).
    batch_sizes : batch buckets (batch dim padding targets).
    sample_shapes : per-request shape buckets; None makes each distinct
        request shape its own exact bucket.
    dtype : input dtype requests are cast to.
    warm : run the whole bucket table once at construction.
    unpad : slice outputs back to each request's real extent.
    """

    def __init__(self, block, root=None, step=None, ctx=None,
                 batch_sizes=DEFAULT_BATCH_SIZES, sample_shapes=None,
                 dtype="float32", warm=True, unpad=True):
        if not isinstance(block, Block) and callable(block):
            block = block()
        if not isinstance(block, Block):
            raise ValueError("ModelRunner needs a Block or a zero-arg "
                             "factory returning one, got %r" % (block,))
        self._device = device_of(ctx)
        self._block = block.to(self._device)
        self.root = root
        self.step = None
        self.timings = {"restore_s": 0.0, "warm_s": 0.0}
        if root is not None:
            t0 = time.perf_counter()
            self.step = block.load_checkpoint(
                root, step=step, ctx=Context.from_device(self._device))
            self.timings["restore_s"] = time.perf_counter() - t0
        self._dtype = dtype
        self._unpad = bool(unpad)
        self._batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        if not self._batch_sizes:
            raise ValueError("batch_sizes must be non-empty")
        self._sample_buckets = _normalize_sample_shapes(sample_shapes)
        self._warmed = False
        self._run_lock = RLock()  # one forward at a time
        if warm:
            t0 = time.perf_counter()
            self.warm_up()
            self.timings["warm_s"] = time.perf_counter() - t0

    @property
    def block(self):
        return self._block

    @property
    def device(self):
        return self._device

    @property
    def warmed(self):
        return self._warmed

    @property
    def max_batch_size(self):
        return self._batch_sizes[-1]

    def bucket_table(self):
        """[(batch, sample_sig), ...] -- every signature warm_up runs."""
        return [(b, sig) for sig in (self._sample_buckets or [()])
                for b in self._batch_sizes]

    def stats(self):
        return {
            "step": self.step,
            "root": self.root,
            "timings": dict(self.timings),
            "warmed": self._warmed,
            "device": str(self._device),
            "dtype": self._dtype,
            "batch_sizes": list(self._batch_sizes),
            "sample_shapes": [[list(s) for s in sig]
                              for sig in self._sample_buckets],
            "buckets": [_bucket_label(b, sig)
                        for b, sig in self.bucket_table() if sig],
        }

    def warm_up(self):
        """Run every (batch_size x sample_shape) bucket once on zeros.
        Returns the number of buckets run."""
        n = 0
        for b, sig in self.bucket_table():
            if not sig:
                continue  # no sample buckets configured: nothing to warm
            self._forward([_np.zeros((b,) + s, dtype=self._dtype)
                           for s in sig])
            n += 1
        self._warmed = True
        # autotune's idle tuner (MXNET_AUTOTUNE=search): no traffic has
        # arrived yet, so time each bucket's forward into the store
        # (serve_bucket records, the cost model's data); within
        # MXNET_AUTOTUNE_BUDGET_MS, and a failure never fails the warm-up
        from .. import autotune as _autotune

        if _autotune.search_enabled():
            try:
                _autotune.measure.serve_idle_tune(self)
            except Exception:  # noqa: BLE001 - warm-up must not fail
                _autotune.fallback("serve_idle")
        return n

    def _forward(self, bufs):
        """Host buffers in -> host numpy outputs (the device sync)."""
        with self._run_lock, torch.inference_mode():
            # inference mode is thread-local: entered here, on the
            # scheduler's own thread
            out = self._block(*[torch.from_numpy(b).to(self._device)
                                for b in bufs])
            outs = out if isinstance(out, tuple) else (out,)
            return [o.cpu().numpy() for o in outs]

    def bucket_for(self, sample_shapes):
        """Map a request's per-input sample shapes to its bucket class:
        the index of the smallest covering sample bucket (same rank per
        input, every dim >=), or the exact shape tuple without a table.
        Raises ``NoBucketError`` when nothing covers the request."""
        sample_shapes = tuple(tuple(s) for s in sample_shapes)
        if not self._sample_buckets:
            return sample_shapes
        for i, sig in enumerate(self._sample_buckets):
            if len(sig) != len(sample_shapes):
                continue
            if all(len(b) == len(s) and
                   all(bd >= sd for bd, sd in zip(b, s))
                   for b, s in zip(sig, sample_shapes)):
                return i
        raise NoBucketError(
            "no shape bucket covers request input shapes %s (buckets: %s)"
            % (list(sample_shapes),
               [list(map(list, s)) for s in self._sample_buckets]))

    def _batch_bucket(self, n):
        for b in self._batch_sizes:
            if b >= n:
                return b
        return self._batch_sizes[-1]

    def _target_sig(self, requests):
        cls = requests[0].bucket_class
        if isinstance(cls, int):
            return self._sample_buckets[cls]
        return cls  # exact-shape class: no sample padding

    def run_batch(self, requests):
        """Pad, stack, run, unpad.  ``requests`` are same-class
        ``batching.Request`` objects; returns one result per request (a
        bare array for single-output models, else a tuple).  Batches
        larger than the biggest batch bucket are chunked."""
        results = []
        cap = self.max_batch_size
        for i in range(0, len(requests), cap):
            results.extend(self._run_chunk(requests[i:i + cap]))
        return results

    def _run_chunk(self, requests):
        sig = self._target_sig(requests)
        n = len(requests)
        B = self._batch_bucket(n)
        with trace.span("serve_pad", hist=False, cat="serve",
                        args={"batch": B, "requests": n}):
            bufs, real = [], 0
            for j, bucket_shape in enumerate(sig):
                buf = _np.zeros((B,) + bucket_shape, dtype=self._dtype)
                for i, req in enumerate(requests):
                    a = req.inputs[j]
                    real += a.size
                    buf[(i,) + tuple(slice(0, d) for d in a.shape)] = a
                bufs.append(buf)
            total = sum(b.size for b in bufs)
            if telemetry.ENABLED and total:
                telemetry.SERVE_PAD_ELEMENTS.inc(total - real)
                telemetry.SERVE_PAD_FRACTION.observe((total - real) / total)

        with trace.span("serve_execute", hist=False, cat="serve",
                        args={"bucket": _bucket_label(B, sig)}):
            outs_np = self._forward(bufs)

        with trace.span("serve_unpad", hist=False, cat="serve"):
            lead = sig[0] if sig else requests[0].inputs[0].shape
            results = []
            for i, req in enumerate(requests):
                orig = req.inputs[0].shape
                per_req = []
                for o in outs_np:
                    row = o[i]
                    if self._unpad:
                        row = row[tuple(
                            slice(0, orig[a]) if a < len(lead)
                            and a < len(orig) and row.shape[a] == lead[a]
                            else slice(None) for a in range(row.ndim))]
                    per_req.append(row)
                results.append(per_req[0] if len(per_req) == 1
                               else tuple(per_req))
        # count AFTER unpad: only values returned to clients count
        bad = count_nonfinite(a for r in results
                              for a in (r if isinstance(r, tuple) else (r,)))
        if bad and telemetry.ENABLED:
            telemetry.SERVE_NONFINITE_OUTPUTS.inc(bad)
            telemetry.SERVE_NONFINITE_BATCHES.inc()
        return results
