"""Tuning spaces: one ``TuningSite`` per tunable knob.

Counterpart of ``mxnet_tpu/autotune/space.py``.  A site names a hand-set
knob of the port, enumerates its candidate configs for a workload key
and, where it can be measured alone, builds the micro-benchmark
``measure.tune`` runs each candidate through.  The consumer is a lookup
(``autotune.lookup(site, key, default)``) where the knob is read, and the
registered default is always the port's own hand-set choice, so
``MXNET_AUTOTUNE=0`` leaves every path as it is without autotune.

Sites (the sites whose consumers the port has):

- ``flash_attention``     -- the forward kernel's (block_q, block_k)
                             tile among the instances ``csrc/flash_fwd.cu``
                             compiles (``ops.flash_attention.
                             compiled_tiles``); default the hand-set tile
- ``blockwise_attention`` -- the plain online-softmax scan's block_k
- ``conv_layout``         -- cuDNN's conv memory format on the card:
                             channels-last ("NHWC", the port's default)
                             or contiguous NCHW
- ``bn_stat_dtype``       -- BatchNorm's batch-statistics dtype
- ``decode_bucket``       -- the decode plane's batch-bucket set
                             (structural: measured by the decode
                             runner's idle tuner)
- ``spec_k``              -- speculative decoding's draft count
                             (structural)
- ``data_prefetch``       -- the streaming loader's ring depth and
                             reader threads (structural)
- ``serve_bucket``        -- the serving runner's bucket latency table
                             (structural: recorded by its idle tuner)

A measurable site's bench runs on seeded inputs, on the card where there
is one, and returns its outputs, so the harness can hold every candidate
to the default's bits: a candidate whose outputs differ in one bit is
rejected, not ranked.  Its ``run()`` ends in a synchronize, so a timing
is the work's and not its launch's.  Structural sites
(``parity="structural"``) choose among configurations that cannot change
outputs by construction and are measured by their own tuners.  Workload
keys spell dtypes the numpy way ("float32"), so ``key_hash`` of a key is
the JAX package's.
"""
from __future__ import annotations

import time

__all__ = ["TuningSite", "register_site", "get_site", "sites"]

_REGISTRY = {}


def register_site(site):
    """Register a ``TuningSite`` (an instance, or a class, made here, so
    the decorator form reads declaratively)."""
    inst = site() if isinstance(site, type) else site
    _REGISTRY[inst.name] = inst
    return site


def get_site(name):
    if name not in _REGISTRY:
        from ..base import MXNetError

        raise MXNetError("unknown autotune site %r (registered: %s)"
                         % (name, sorted(_REGISTRY)))
    return _REGISTRY[name]


def sites():
    """{name: site} of every registered tuning site."""
    return dict(_REGISTRY)


def _device():
    """Where a bench runs: the card when there is one."""
    import torch

    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seeded(shape, dtype="float32", seed=0, device=None):
    """Seeded standard normal values (numpy's generator) as a tensor of
    ``dtype`` on ``device``."""
    import numpy as _np
    import torch

    from ..base import _as_torch_dtype

    rng = _np.random.default_rng(seed)
    t = torch.from_numpy(rng.standard_normal(shape).astype(_np.float32))
    return t.to(device=device or "cpu", dtype=_as_torch_dtype(dtype))


class TuningSite:
    """One tunable site: its candidates and its micro-benchmark.

    Subclasses define ``name``, ``doc``, ``parity`` ("bitwise": the
    harness holds outputs to the default config's bits; or
    "structural"), ``default_config(key)``, ``candidates(key)`` and, for
    measurable sites, ``make_bench(key, config)`` returning a zero-arg
    callable that runs one iteration to completion (a synchronize on the
    card) and returns its outputs as tensors.  ``features(key)`` feeds
    the cost model."""

    name = None
    doc = ""
    parity = "bitwise"

    def default_config(self, key):
        raise NotImplementedError

    def candidates(self, key):
        raise NotImplementedError

    def make_bench(self, key, config):
        raise NotImplementedError

    def validate(self, key, config):
        """True when a stored config is shaped right for this site: the
        lookup's guard against a hand-edited or stale record."""
        return config is not None

    def features(self, key):
        """Numeric workload descriptors for the cost model."""
        return [float(v) for v in key if isinstance(v, (int, float))]

    def describe(self):
        return {"name": self.name, "parity": self.parity, "doc": self.doc}


def _structural(name, by):
    from ..base import MXNetError

    raise MXNetError("%s is a structural site: it is measured by %s, not by "
                     "measure.tune()" % (name, by))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@register_site
class _FlashAttention(TuningSite):
    """(block_q, block_k) of the forward flash kernel.

    key = (B, H, Tq, Tk, D, dtype, causal).  The candidates are the tiles
    ``csrc/flash_fwd.cu`` compiles without dropout: the hand-set one and
    the other row count (64 <-> 128 rows a block) at the same key tile.
    Each warp's 16 rows run the same K/V tiles in the same order whatever
    the block's height, so the row candidates are expected to pass the
    bitwise guard; another key tile would change the online softmax's
    partition, so none is compiled.  Dropout pins the default.  A bench
    run is ``LAUNCHES`` launches and one synchronize; on the card it
    records a CUDA event on the current stream before and after the
    launches and carries the time between them (``run.device_ms``), by
    which ``measure.tune`` ranks the tiles.  A ``torch.cuda._sleep``
    enqueued ahead of the first event holds the card while the host
    enqueues the launches, so the events time them back to back: a
    kernel of 0.06-0.09 ms launches faster on the card than the host
    issues it, and the host's clock, or events with the host's gaps
    between them, ranked the tiles by the launch overhead."""

    name = "flash_attention"
    doc = "flash forward kernel (block_q, block_k) tile"
    LAUNCHES = 10
    # above the H100's 1.98 GHz boost clock, so a sleep of this many
    # cycles a second lasts at least as long as asked
    SLEEP_CYCLES_PER_S = 2.0e9

    def default_config(self, key):
        from ..ops import flash_attention as fa

        return list(fa.default_tiles(key[5], int(key[4])))

    def candidates(self, key):
        from ..ops import flash_attention as fa

        return [list(t) for t in fa.compiled_tiles(key[5], int(key[4]))]

    def validate(self, key, config):
        from ..ops import flash_attention as fa

        try:
            bq, bk = config
            return (int(bq), int(bk)) in fa.compiled_tiles(key[5],
                                                           int(key[4]))
        except (TypeError, ValueError):
            return False

    def make_bench(self, key, config):
        import torch

        from ..ops import flash_attention as fa

        b, h, tq, tk, d, dtype, causal = key
        dev = _device()
        q = _seeded((b, h, tq, d), dtype, 1, dev)
        k = _seeded((b, h, tk, d), dtype, 2, dev)
        v = _seeded((b, h, tk, d), dtype, 3, dev)
        bq, bk = int(config[0]), int(config[1])
        # the sleep ahead of the launches: twice the host's last enqueue
        hold_ms = [2.0]

        def run():
            cuda = dev.type == "cuda"
            if cuda:
                stream = torch.cuda.current_stream(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with torch.cuda.device(dev):
                    torch.cuda._sleep(int(hold_ms[0] * 1e-3
                                          * self.SLEEP_CYCLES_PER_S))
                start.record(stream)
            t0 = time.perf_counter()
            with torch.no_grad():
                for _ in range(self.LAUNCHES):
                    out = fa.flash_attention(q, k, v, bool(causal),
                                             block_q=bq, block_k=bk)
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            if cuda:
                end.record(stream)
            _sync(dev)
            if cuda:
                run.device_ms = start.elapsed_time(end)
                hold_ms[0] = max(hold_ms[0], 2.0 * enqueue_ms + 1.0)
            return [out]

        run.device_ms = None
        return run


@register_site
class _BlockwiseAttention(TuningSite):
    """block_k of the plain online-softmax scan (``impl='flash'``).

    key = (B, H, Tq, Tk, D, dtype, causal).  Another block_k changes the
    softmax accumulation's partition, so past the one-block case the
    candidates usually fail the bitwise guard: the counted rejection says
    this knob cannot be retuned without changing numerics."""

    name = "blockwise_attention"
    doc = "blockwise_attention block_k"
    _GRID = (128, 256, 512, 1024)

    def default_config(self, key):
        from ..ops.flash_attention import DEFAULT_BLOCKWISE_K

        return DEFAULT_BLOCKWISE_K

    def candidates(self, key):
        _B, _H, _tq, tk, _d, _dt, _causal = key
        seen, out = set(), []
        for bk in self._GRID:
            eff = min(bk, tk)
            if eff in seen:
                continue
            seen.add(eff)
            out.append(bk)
        return out

    def validate(self, key, config):
        try:
            return int(config) > 0
        except (TypeError, ValueError):
            return False

    def make_bench(self, key, config):
        import torch

        from ..ops import flash_attention as fa

        b, h, tq, tk, d, dtype, causal = key
        dev = _device()
        q = _seeded((b, h, tq, d), dtype, 1, dev)
        k = _seeded((b, h, tk, d), dtype, 2, dev)
        v = _seeded((b, h, tk, d), dtype, 3, dev)

        def run():
            with torch.no_grad():
                out = fa.blockwise_attention(q, k, v, bool(causal),
                                             block_k=int(config))
            _sync(dev)
            return [out]

        return run


# ---------------------------------------------------------------------------
# conv memory format and BatchNorm statistics
# ---------------------------------------------------------------------------

@register_site
class _ConvLayout(TuningSite):
    """cuDNN's memory format for a 2-D convolution on the card: "NHWC"
    (channels-last, the port's hand-set choice, ``ops/nn.py``) or "NCHW"
    (contiguous).  Models stay NCHW outside either way.

    key = (N, C, H, W, O, kh, kw, stride, dtype)."""

    name = "conv_layout"
    doc = "conv memory format on the card: channels-last vs NCHW"

    def default_config(self, key):
        return "NHWC"

    def candidates(self, key):
        return ["NHWC", "NCHW"]

    def validate(self, key, config):
        return config in ("NCHW", "NHWC")

    def make_bench(self, key, config):
        import torch
        import torch.nn.functional as F

        n, c, h, w, o, kh, kw, stride, dtype = key
        dev = _device()
        x = _seeded((n, c, h, w), dtype, 1, dev)
        wgt = _seeded((o, c, kh, kw), dtype, 2, dev)
        fmt = torch.channels_last if config == "NHWC" \
            else torch.contiguous_format
        x = x.contiguous(memory_format=fmt)

        def run():
            with torch.no_grad():
                y = F.conv2d(x, wgt, stride=int(stride),
                             padding=(kh // 2, kw // 2))
            _sync(dev)
            return [y.contiguous()]

        return run


@register_site
class _BNStatDtype(TuningSite):
    """BatchNorm's batch-statistics dtype: float32 or bfloat16.  The
    bf16 candidate changes the mean and variance's rounding by
    construction, so under the bitwise guard it wins only where the
    reduction happens to round alike; elsewhere the counted rejection is
    the verdict.

    key = (N, C, H, W, axis, dtype): bit-identity shown for one reduction
    geometry says nothing of another."""

    name = "bn_stat_dtype"
    doc = "BatchNorm statistics dtype f32 vs bf16"

    def default_config(self, key):
        return "float32"

    def candidates(self, key):
        return ["float32", "bfloat16"]

    def validate(self, key, config):
        return config in ("float32", "bfloat16")

    def make_bench(self, key, config):
        import torch

        from ..ops import nn as _nn

        n, c, h, w, axis, dtype = key
        dev = _device()
        shape = (n, c, h, w)
        x = _seeded(shape, dtype, 1, dev)
        nchan = shape[int(axis)]
        gamma = _seeded((nchan,), "float32", 2, dev)
        beta = _seeded((nchan,), "float32", 3, dev)
        mean = torch.zeros(nchan, device=dev)
        var = torch.ones(nchan, device=dev)

        def run():
            with torch.no_grad():
                outs = _nn.batch_norm(x, gamma, beta, mean, var,
                                      training=True, axis=int(axis),
                                      stat_dtype=config)
            _sync(dev)
            return list(outs)

        return run


# ---------------------------------------------------------------------------
# serving buckets and the input pipeline (structural sites)
# ---------------------------------------------------------------------------

@register_site
class _DecodeBucket(TuningSite):
    """The decode plane's batch-bucket set.  key = (max_live,).
    Candidates are subsets of the power-of-two table that still cover
    ``max_live``; the decode padding cannot change tokens, so parity is
    structural and the winner comes from ``measure.decode_idle_tune``
    during warm-up under ``MXNET_AUTOTUNE=search``."""

    name = "decode_bucket"
    doc = "serve decode batch-bucket set (idle-time tuned)"
    parity = "structural"

    @staticmethod
    def _pow2(max_live):
        out, b = [], 1
        while b < max_live:
            out.append(b)
            b *= 2
        out.append(int(max_live))
        return sorted(set(out))

    def default_config(self, key):
        return self._pow2(int(key[0]))

    def candidates(self, key):
        max_live = int(key[0])
        full = self._pow2(max_live)
        cands = [full, [max_live]]
        if len(full) > 2:
            cands.append(full[1:])          # drop the B=1 bucket
            cands.append(full[-2:])         # coarse top-of-table pair
        uniq, out = set(), []
        for c in cands:
            t = tuple(c)
            if t not in uniq:
                uniq.add(t)
                out.append(list(c))
        return out

    def validate(self, key, config):
        try:
            buckets = sorted(int(b) for b in config)
        except (TypeError, ValueError):
            return False
        return bool(buckets) and buckets[0] >= 1 and \
            buckets[-1] >= int(key[0])

    def make_bench(self, key, config):
        _structural(self.name, "the decode runner's idle tuner (warm_up "
                    "under MXNET_AUTOTUNE=search)")


@register_site
class _SpecK(TuningSite):
    """Speculative decoding's draft proposal count K.  key = (max_live,).
    Greedy acceptance emits the tokens of single-step decode for every K
    (``serve/spec.py``), so parity is structural: K trades draft work
    against accepted tokens a target step.  ``SpecPlane`` takes a stored
    winner whenever ``spec_k`` is left unset."""

    name = "spec_k"
    doc = "speculative draft proposal count per round (structural)"
    parity = "structural"

    def default_config(self, key):
        return 4

    def candidates(self, key):
        return [2, 3, 4, 6, 8]

    def validate(self, key, config):
        try:
            k = int(config)
        except (TypeError, ValueError):
            return False
        return 1 <= k <= 16

    def make_bench(self, key, config):
        _structural(self.name, "an acceptance sweep of the serving plane")


@register_site
class _DataPrefetch(TuningSite):
    """The streaming loader's ring depth and reader threads.
    key = (local_batch, approx_record_bytes).  Order-preserving by
    construction (the epoch order is a function of (seed, epoch)), so
    parity is structural; ``StreamLoader`` takes a stored winner whenever
    ``num_workers``/``prefetch`` are left unset."""

    name = "data_prefetch"
    doc = "streaming loader ring depth + reader workers (structural)"
    parity = "structural"

    def default_config(self, key):
        from ..data.loader import default_workers
        from ..data.ring import default_depth

        return {"depth": default_depth(), "workers": default_workers()}

    def candidates(self, key):
        return [{"depth": depth, "workers": workers}
                for depth in (2, 3, 4, 8) for workers in (1, 2, 4)]

    def validate(self, key, config):
        try:
            return int(config["depth"]) >= 1 and \
                int(config["workers"]) >= 1
        except (TypeError, KeyError, ValueError):
            return False

    def features(self, key):
        import math

        return [math.log2(max(1, int(key[0]))),
                math.log2(max(1, int(key[1])))]

    def make_bench(self, key, config):
        _structural(self.name, "a loader epoch end to end")


@register_site
class _ServeBucket(TuningSite):
    """The serving runner's per-bucket latency table, recorded by its
    idle tuner: data for the cost model, not a knob.
    key = (block class, dtype, bucket labels)."""

    name = "serve_bucket"
    doc = "serve bucket latency table (idle-time measured)"
    parity = "structural"

    def default_config(self, key):
        return None

    def candidates(self, key):
        return []

    def make_bench(self, key, config):
        _structural(self.name, "ModelRunner.warm_up under "
                    "MXNET_AUTOTUNE=search")
