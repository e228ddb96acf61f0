"""mx.serve.decode: continuous batching over a paged KV cache.

Counterpart of ``mxnet_tpu/serve/decode.py``.  Orca-style
**iteration-level scheduling**: one decode step runs every iteration over
whichever sequences are live *right now*; new sequences are admitted into
freed slots mid-flight, and finished, expired or poisoned ones are evicted
and their KV pages reclaimed the same step.

Layers:

- ``DecodeRunner`` owns the model (a decoder block following the contract
  below), the ``kvcache.PagePool`` and the program table: one step program
  per decode batch bucket and one per prefill length bucket (and, opt-in,
  per cached-suffix bucket and per speculative verify bucket), each built
  once and metered per bucket (``serve_decode_compile_total``: a steady
  state adds nothing).  A program here is a step closure over
  preallocated buffers: the inputs of a step cross to the device in one
  copy, the step runs eagerly (gather, scrub, the model, scatter, argmax
  sampling and the nonfinite count), and the host reads ``B`` ints back.
- ``DecodeScheduler`` is the admission queue and the continuous-batching
  loop: a bounded waiting queue with deadline expiry, worst-case page
  reservation at admission, prefill through the bucket path, then the
  decode loop.  A failing step is retried **bisected** down to single
  sequences so a poisoned sequence fails alone with its pages reclaimed
  (``serve_poison@<request-id>`` drills it), and decode buckets carry
  their own circuit breakers.
- ``TinyDecoder`` is a small but real transformer decoder implementing the
  contract: the reference model for the tests and the card's smoke run.

**Decoder model contract.**  Any ``Block`` with integer attributes
``num_layers`` / ``num_kv_heads`` / ``head_dim`` / ``vocab_size``
(optional ``eos_id``) and the forward signature::

    forward(tokens,        # [B, T]            int32 token ids
            k_ctx, v_ctx,  # [B, L, S, H, D]   gathered paged context
            ctx_lengths,   # [B]               int32 cached positions
            chunk_lengths) # [B]               int32 valid chunk length
        -> (last_logits,   # [B, vocab]        logits at the last
                           #                   valid chunk position
            k_new, v_new)  # [B, T, L, H, D]   cache rows for the chunk

Prefill is the ``S == 0`` call (``T`` = the prompt bucket); decode is
``T == 1`` with the full paged context.  The forward attends causally
within the chunk and masks context positions ``>= ctx_length``; the
step around it does everything page-shaped, so the model stays
paging-agnostic.

Not ported yet (each raises or is absent, and is queued in
``ROADMAP.md``): tenancy (``tenant=``, item 9), a runner over a mesh
(``mesh=``, item 7), fleet export and handoff
(item 9), and persisted programs (``compile/``, item 3:
``provenance()`` reports ``"not ported"``).  Steps run eagerly; a CUDA
graph per decode bucket is queued too.
"""
from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as _np
import torch

from .. import telemetry, trace
from ..base import MXNetError, get_env
from ..context import Context, device_of
from ..gluon.block import Block, HybridBlock
from ..resilience import inject as _inject
from ..resilience.inject import InjectedFault, InjectedIOError
from .batching import (RequestTimeout, ServeError, ServerClosed,
                       ServerOverloaded, fail_request)
from .kvcache import (PageConfig, PagePool, PagePoolExhausted,
                      gather_pages, scatter_pages)

__all__ = ["DecodeError", "DecodeConfig", "DecodeRequest",
           "DecodeRunner", "DecodeScheduler", "TinyDecoder"]

_TENANCY = "decode tenancy (tenant=) is not ported yet: ROADMAP.md " \
    "Queue 1 item 9"
_FLEET = "fleet export and handoff are not ported yet: ROADMAP.md " \
    "Queue 1 item 9"


class DecodeError(ServeError):
    """Decode-path request validation / execution error."""


def _pow2_up_to(lo, hi):
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(sorted(set(out)))


class DecodeConfig:
    """Knobs of the decode path.

    page_size / pool_pages : KV page geometry
        (``MXNET_SERVE_DECODE_PAGE_SIZE`` / ``_POOL_PAGES``).
    max_live : concurrent sequences in the running batch
        (``MXNET_SERVE_DECODE_MAX_LIVE``); also caps the decode batch
        bucket table.
    max_new_tokens : default + hard per-request generation cap
        (``MXNET_SERVE_DECODE_MAX_NEW``).
    max_context : bound on prompt + generated tokens per sequence; fixes
        the paged-attention context extent every decode step gathers.
    prefill_lengths : prompt padding buckets (default: powers of two up
        to ``max_context``).
    batch_sizes : decode batch buckets (default: powers of two up to
        ``max_live``).
    queue_depth : bound on ADMISSION-waiting sequences; beyond it
        submissions are rejected with ``ServerOverloaded``.
    timeout_ms : default per-request deadline (expires a sequence
        mid-generation too).
    stream : whether the HTTP front-end serves chunked token streaming
        (``MXNET_SERVE_DECODE_STREAM``).
    eos_id : default stop token (None = length-only stopping).
    dtype : the KV pool's dtype.
    prefix_cache : enable the radix prefix cache (``serve/cache.py``;
        ``MXNET_SERVE_PREFIX_CACHE``, default off).
    spec_k : speculative draft proposal count when a draft model is given
        (``MXNET_SERVE_SPEC_K``; 0 = the built-in default).
    """

    def __init__(self, page_size=None, pool_pages=None, max_live=None,
                 max_new_tokens=None, max_context=128,
                 prefill_lengths=None, batch_sizes=None, queue_depth=64,
                 timeout_ms=None, stream=None, eos_id=None,
                 dtype="float32", prefix_cache=None, spec_k=None):
        self.page_size = get_env("MXNET_SERVE_DECODE_PAGE_SIZE", int, 16) \
            if page_size is None else int(page_size)
        self.pool_pages = get_env("MXNET_SERVE_DECODE_POOL_PAGES", int,
                                  256) \
            if pool_pages is None else int(pool_pages)
        self.max_live = get_env("MXNET_SERVE_DECODE_MAX_LIVE", int, 8) \
            if max_live is None else int(max_live)
        self.max_new_tokens = get_env("MXNET_SERVE_DECODE_MAX_NEW", int,
                                      64) \
            if max_new_tokens is None else int(max_new_tokens)
        self.stream = get_env("MXNET_SERVE_DECODE_STREAM", bool, True) \
            if stream is None else bool(stream)
        self.max_context = int(max_context)
        if prefill_lengths is None:
            prefill_lengths = _pow2_up_to(
                min(8, self.max_context), self.max_context)
        self.prefill_lengths = tuple(sorted(set(
            int(t) for t in prefill_lengths if int(t) <= self.max_context)))
        if not self.prefill_lengths:
            raise ValueError("no prefill bucket <= max_context=%d"
                             % self.max_context)
        if batch_sizes is None:
            default_set = _pow2_up_to(1, max(1, self.max_live))
            batch_sizes = self._tuned_batch_sizes(default_set)
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        if self.batch_sizes[-1] < self.max_live:
            raise ValueError(
                "largest decode batch bucket %d < max_live=%d: live "
                "sequences could never all step"
                % (self.batch_sizes[-1], self.max_live))
        self.queue_depth = int(queue_depth)
        self.timeout_ms = timeout_ms
        self.eos_id = eos_id
        self.dtype = dtype
        self.prefix_cache = get_env("MXNET_SERVE_PREFIX_CACHE", bool,
                                    False) \
            if prefix_cache is None else bool(prefix_cache)
        self.spec_k = get_env("MXNET_SERVE_SPEC_K", int, 0) \
            if spec_k is None else int(spec_k)

    def _tuned_batch_sizes(self, default_set):
        """The ``decode_bucket`` autotune winner for this ``max_live``
        (committed by a decode runner's idle tuner), when it still covers
        ``max_live``; else the power-of-two default.  Decode outputs do
        not depend on the bucket table (the padding design), so a tuned
        table changes builds and step latency, never tokens."""
        from .. import autotune as _at

        if not _at.is_enabled():
            return default_set
        cfg, prov = _at.lookup_info("decode_bucket", (self.max_live,),
                                    list(default_set))
        if prov != "tuned":
            return default_set
        try:
            buckets = sorted(set(int(b) for b in cfg))
        except (TypeError, ValueError):
            buckets = []
        if not buckets or buckets[0] < 1 or buckets[-1] < self.max_live:
            _at.fallback("invalid_config")
            return default_set
        return buckets

    def as_dict(self):
        return {
            "page_size": self.page_size, "pool_pages": self.pool_pages,
            "max_live": self.max_live,
            "max_new_tokens": self.max_new_tokens,
            "max_context": self.max_context,
            "prefill_lengths": list(self.prefill_lengths),
            "batch_sizes": list(self.batch_sizes),
            "queue_depth": self.queue_depth,
            "timeout_ms": self.timeout_ms, "stream": self.stream,
            "eos_id": self.eos_id, "dtype": self.dtype,
            "prefix_cache": self.prefix_cache, "spec_k": self.spec_k,
        }


class DecodeRequest:
    """One autoregressive generation request.

    Carries the resolution surface of ``batching.Request`` (``future`` /
    ``enqueued`` / ``deadline`` / ``request_id`` / ``trace``) so the shared
    failure and telemetry plumbing applies; the future resolves to
    ``{"tokens": [ids...], "finish_reason": ...}``.  ``on_token(token_id,
    index)``, when given, is called once per emitted token from the decode
    loop (it must be cheap and non-blocking); the streamed sequence is the
    future's ``tokens``.  ``export_only``, ``handoff`` (fleet) and
    ``tenant`` wait in ``ROADMAP.md`` Queue 1 item 9 and raise."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "on_token",
                 "future", "enqueued", "deadline", "request_id", "trace")

    def __init__(self, prompt, max_new_tokens, eos_id=None, deadline=None,
                 request_id=None, on_token=None, export_only=False,
                 handoff=None, tenant=None):
        if export_only or handoff is not None:
            raise DecodeError(_FLEET)
        if tenant is not None:
            raise DecodeError(_TENANCY)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.on_token = on_token
        self.future = Future()
        self.enqueued = time.perf_counter()
        self.deadline = deadline
        self.request_id = request_id
        self.trace = trace.new_request(request_id)
        if self.trace is not None:
            trace.instant("serve_decode_enqueue", cat="serve",
                          ctx=self.trace,
                          args={"request_id": request_id,
                                "prompt_tokens": len(self.prompt)})

    def expired(self, now=None):
        return self.deadline is not None and \
            (time.perf_counter() if now is None else now) >= self.deadline


class _Seq:
    """Decode-loop bookkeeping for one live sequence."""

    __slots__ = ("req", "sid", "tokens", "length", "pages", "joined_step",
                 "t_prefill", "first_token_t", "last_token",
                 "cache_class", "prefix_len", "shared",
                 "spec", "dlen", "dpages")

    def __init__(self, req, sid):
        self.req = req
        self.sid = sid
        self.tokens = []          # generated token ids
        self.length = 0           # positions resident in the KV pages
        self.pages = None
        self.joined_step = None
        self.t_prefill = None
        self.first_token_t = None
        self.last_token = None    # next decode-step input token
        # serve/cache.py: TTFT class, the shared-prefix floor (no write
        # lands below it) and the shared pages this sequence holds
        # references on (a prefix of ``pages``)
        self.cache_class = None
        self.prefix_len = 0
        self.shared = []
        # serve/spec.py: None = not offered to the plane yet, True =
        # speculating, False = detached/ineligible; dlen is the draft
        # cache cursor, dpages the draft pool reservation
        self.spec = None
        self.dlen = 0
        self.dpages = None

    @property
    def done_reason(self):
        if self.req.eos_id is not None and self.tokens and \
                self.tokens[-1] == self.req.eos_id:
            return "eos"
        if len(self.tokens) >= self.req.max_new_tokens:
            return "length"
        return None


class _Program:
    __slots__ = ("fn", "label", "provenance")

    def __init__(self, fn, label):
        self.fn = fn
        self.label = label
        # the JAX package persists its programs through compile/
        # (ROADMAP.md Queue 1 item 3)
        self.provenance = "not ported"


class _Inputs:
    """Preallocated int32 buffers a program's inputs cross through: one
    host buffer (page-locked for a card) and one on the device, so a step
    makes a single host-to-device copy.  ``put`` returns the device views,
    one per input, in the shapes given."""

    def __init__(self, shapes, device):
        sizes = [int(_np.prod(s)) for s in shapes]
        total = sum(sizes)
        on_card = device.type == "cuda"
        self._host = torch.zeros(total, dtype=torch.int32,
                                 pin_memory=on_card)
        self._host_np = self._host.numpy()
        self._dev = torch.zeros(total, dtype=torch.int32, device=device) \
            if on_card else self._host
        self._spans, self._views, off = [], [], 0
        for shape, n in zip(shapes, sizes):
            self._spans.append((off, off + n))
            self._views.append(self._dev[off:off + n].view(shape))
            off += n

    def put(self, arrays):
        for (lo, hi), a in zip(self._spans, arrays):
            self._host_np[lo:hi] = _np.asarray(a).ravel()
        if self._dev is not self._host:
            self._dev.copy_(self._host, non_blocking=True)
        return self._views


def _scrubbed_context(pool, tables, ctx_lens, span):
    """The gathered ``[B, L, S, H, D]`` K and V contexts of ``pool``, every
    position at or past a sequence's length scrubbed to 0: freed pages are
    reused without zeroing, so a previous owner's values (NaN, when that is
    how it died) sit in the tail, and an additive mask cannot discard NaN
    (NaN - 1e9 is NaN, and 0 x NaN is NaN)."""
    dead = (span[None, :] >= ctx_lens[:, None].long())[:, None, :, None,
                                                         None]
    return (gather_pages(pool.k, tables).masked_fill_(dead, 0),
            gather_pages(pool.v, tables).masked_fill_(dead, 0))


def _resolve_block(block):
    """Unwrap a zero-arg block factory and type-check the result."""
    if not isinstance(block, Block) and callable(block):
        block = block()
    if not isinstance(block, Block):
        raise ValueError("DecodeRunner needs a Block or a zero-arg "
                         "factory returning one, got %r" % (block,))
    return block


class DecodeRunner:
    """Model + paged KV pool + the step program table.

    ``block`` is a decoder block following the module-doc contract (or a
    zero-arg factory); it is moved onto ``ctx`` (default ``gpu(0)``, which
    raises where there is no card: pass ``ctx=mx.cpu()``), and with
    ``root`` its parameters are restored from checkpoint ``step`` (default
    the latest committed) of an ``mx.checkpoint`` root of either package.
    ``warm_up()`` builds every bucket's program and runs each once, so a
    steady state builds nothing.  ``draft`` (a decoder block) arms
    speculative decoding (``serve/spec.py``)."""

    def __init__(self, block, root=None, step=None, ctx=None, config=None,
                 warm=True, draft=None, tenant=None, mesh=None):
        if tenant is not None:
            raise MXNetError(_TENANCY)
        if mesh is not None:
            raise MXNetError(
                "DecodeRunner(mesh=...) is not ported yet: ROADMAP.md "
                "Queue 1 item 7")
        block = _resolve_block(block)
        for attr in ("num_layers", "num_kv_heads", "head_dim",
                     "vocab_size"):
            if not isinstance(getattr(block, attr, None), int):
                raise ValueError(
                    "decoder contract: block must carry int attribute "
                    "%r (see serve/decode.py module doc)" % attr)
        self._ctx = ctx
        self._device = device_of(ctx)
        self._block = block.to(self._device)
        self.config = config or DecodeConfig()
        # the stop token lives on the runner: a DecodeConfig may be shared
        # across runners and must not absorb one model's eos_id
        self.eos_id = self.config.eos_id \
            if self.config.eos_id is not None \
            else getattr(block, "eos_id", None)
        self.root = root
        self.step = None
        if root is not None:
            self.step = block.load_checkpoint(
                root, step=step, ctx=Context.from_device(self._device))
        self._resolve_params()
        c = self.config
        self.page_config = PageConfig(
            c.page_size, c.pool_pages, block.num_layers,
            block.num_kv_heads, block.head_dim, c.max_context,
            dtype=c.dtype)
        self.pool = PagePool(self.page_config, device=self._device)
        self._programs = {}
        self._run_lock = threading.RLock()
        self._warmed = False
        self.cache = None
        if self.config.prefix_cache:
            from .cache import PrefixCache

            self.cache = PrefixCache(self.pool)
        self.spec = None
        if warm:
            self.warm_up()
        if draft is not None:
            from .spec import SpecPlane

            self.spec = SpecPlane(self, draft,
                                  k=self.config.spec_k or None,
                                  warm=self._warmed)

    # -- setup --------------------------------------------------------------
    def _resolve_params(self):
        """One tiny forward (the contract's S=0, T=1 call) resolves
        deferred parameter shapes."""
        b, dev = self._block, self._device
        zero_ctx = torch.zeros((1, b.num_layers, 0, b.num_kv_heads,
                                b.head_dim),
                               dtype=getattr(torch, str(self.config.dtype)),
                               device=dev)
        i32 = torch.int32
        with torch.no_grad():
            self._block(torch.zeros((1, 1), dtype=i32, device=dev),
                        zero_ctx, zero_ctx,
                        torch.zeros((1,), dtype=i32, device=dev),
                        torch.ones((1,), dtype=i32, device=dev))

    @property
    def block(self):
        return self._block

    @property
    def device(self):
        return self._device

    @property
    def warmed(self):
        return self._warmed

    # -- bucket choice ------------------------------------------------------
    def prefill_bucket(self, n):
        for t in self.config.prefill_lengths:
            if t >= n:
                return t
        raise DecodeError(
            "prompt of %d token(s) exceeds the largest prefill bucket "
            "(%d); buckets: %s" % (n, self.config.prefill_lengths[-1],
                                   list(self.config.prefill_lengths)))

    def decode_bucket(self, n):
        for b in self.config.batch_sizes:
            if b >= n:
                return b
        return self.config.batch_sizes[-1]

    # -- program build ------------------------------------------------------
    @staticmethod
    def bucket_key_label(key):
        kind, n = key
        if kind == "verify":
            return "verify:b%dk%d" % n
        return "%s%d" % ({"decode": "decode:b", "prefill": "prefill:t",
                          "chunk": "chunk:t"}[kind], n)

    def _make_step_fn(self, batch, chunk, with_ctx, with_floors=False):
        """The step of one (bucket, page config): (tokens, tables,
        ctx_lens, chunk_lens[, floors]) host arrays -> (next_tokens,
        nonfinite) host arrays of ``batch`` ints.  Sampling (greedy
        argmax) and the per-token output guard run on the device."""
        c, dev = self.page_config, self._device
        blk, pool = self._block, self.pool
        shapes = [(batch, chunk), (batch, c.pages_per_seq), (batch,),
                  (batch,)] + ([(batch,)] if with_floors else [])
        inputs = _Inputs(shapes, dev)
        steps = torch.arange(chunk, dtype=torch.int32, device=dev)
        span = torch.arange(c.pages_per_seq * c.page_size, device=dev)
        empty = torch.zeros((batch, c.num_layers, 0, c.num_kv_heads,
                             c.head_dim), dtype=pool.k.dtype, device=dev)

        def step(*arrays):
            ins = inputs.put(arrays)
            tokens, tables, ctx_lens, chunk_lens = ins[:4]
            with torch.no_grad():
                if with_ctx:
                    k_ctx, v_ctx = _scrubbed_context(pool, tables,
                                                     ctx_lens, span)
                else:
                    k_ctx = v_ctx = empty
                logits, k_new, v_new = blk(tokens, k_ctx, v_ctx, ctx_lens,
                                           chunk_lens)
                pos = ctx_lens[:, None] + steps[None, :]
                valid = steps[None, :] < chunk_lens[:, None]
                if with_floors:
                    # copy-on-write guard (serve/cache.py): a shared
                    # prefix page is never written
                    valid = valid & (pos >= ins[4][:, None])
                scatter_pages(pool.k_store, tables, pos, valid, k_new)
                scatter_pages(pool.v_store, tables, pos, valid, v_new)
                next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
                bad = torch.sum(~torch.isfinite(logits), dim=-1,
                                dtype=torch.int32)
                out = torch.stack([next_tok, bad]).cpu().numpy()
            return out[0], out[1]

        return step

    def _make_verify_fn(self, batch, k):
        """The speculative verify step (``serve/spec.py``): judge a K-token
        draft chunk with one model call.  The contract only exposes the
        LAST valid chunk logit, so each sequence is replicated K+1 times
        with chunk lengths ``1..K+1``: row j of a group yields the
        target's argmax after the chunk's first j+1 tokens.  K/V is
        scattered once per sequence from the full-chunk replica (causal
        attention makes the rows of every replica the same); positions
        past the acceptance point hold draft-conditioned values that the
        scrub hides until they are overwritten in place.  Returns
        (``[batch, K+1]`` argmaxes, nonfinite counts over the valid
        rows)."""
        c, dev = self.page_config, self._device
        blk, pool = self._block, self.pool
        T = k + 1
        inputs = _Inputs([(batch, T), (batch, c.pages_per_seq), (batch,),
                          (batch,), (batch,)], dev)
        steps = torch.arange(T, dtype=torch.int32, device=dev)
        rj = steps.add(1).repeat(batch)
        span = torch.arange(c.pages_per_seq * c.page_size, device=dev)

        def step(*arrays):
            tokens, tables, ctx_lens, chunk_lens, floors = inputs.put(arrays)
            with torch.no_grad():
                k_ctx, v_ctx = _scrubbed_context(pool, tables, ctx_lens,
                                                 span)

                def rep(a):
                    return torch.repeat_interleave(a, T, dim=0)

                # replicas past a sequence's real chunk length would read
                # padding; clamp them to the full chunk (never read)
                rep_chunk = torch.minimum(rj, rep(chunk_lens.clamp(min=1)))
                logits, k_new, v_new = blk(rep(tokens), rep(k_ctx),
                                           rep(v_ctx), rep(ctx_lens),
                                           rep_chunk)
                y = torch.argmax(logits, dim=-1).to(torch.int32) \
                    .reshape(batch, T)
                mask = steps[None, :] < chunk_lens[:, None]
                badrow = torch.sum(~torch.isfinite(logits), dim=-1,
                                   dtype=torch.int32).reshape(batch, T)
                bad = torch.sum(torch.where(mask, badrow, 0), dim=1,
                                dtype=torch.int32)
                k_full = k_new.reshape((batch, T) + k_new.shape[1:])[:, -1]
                v_full = v_new.reshape((batch, T) + v_new.shape[1:])[:, -1]
                pos = ctx_lens[:, None] + steps[None, :]
                valid = mask & (pos >= floors[:, None])
                scatter_pages(pool.k_store, tables, pos, valid, k_full)
                scatter_pages(pool.v_store, tables, pos, valid, v_full)
                out = torch.cat([y.reshape(-1), bad]).cpu().numpy()
            return out[:batch * T].reshape(batch, T), out[batch * T:]

        return step

    def _build(self, key):
        """Build the program for ``key`` = ("decode", B) | ("prefill", T) |
        ("chunk", T) cached-suffix prefill | ("verify", (B, K))."""
        kind, n = key
        if kind == "verify":
            fn = self._make_verify_fn(*n)
        else:
            batch = n if kind == "decode" else 1
            chunk = 1 if kind == "decode" else n
            fn = self._make_step_fn(
                batch, chunk, with_ctx=kind in ("decode", "chunk"),
                with_floors=kind == "chunk")
        prog = _Program(fn, self.bucket_key_label(key))
        self._programs[key] = prog
        if telemetry.ENABLED:
            telemetry.SERVE_DECODE_COMPILES.labels(bucket=prog.label).inc()
        return prog

    def warm_up(self):
        """Build every decode batch bucket and prefill length bucket
        program and run each once (all-null page tables: every write goes
        to the drop page), so the first live sequence pays no first-call
        cost.  Returns the number of builds."""
        fresh = 0
        keys = [("decode", b) for b in self.config.batch_sizes] + \
            [("prefill", t) for t in self.config.prefill_lengths]
        if self.config.prefix_cache:
            # cached-suffix prefill programs (serve/cache.py), opt-in
            keys += [("chunk", t) for t in self.config.prefill_lengths]
        for key in keys:
            if key in self._programs:
                continue
            with trace.span("serve_decode_warmup", hist=False,
                            cat="serve",
                            args={"bucket": self.bucket_key_label(key)}):
                with self._run_lock:
                    prog = self._build(key)
                    fresh += 1
                    kind, n = key
                    batch = n if kind == "decode" else 1
                    chunk = 1 if kind == "decode" else n
                    prog.fn(*self._null_inputs(batch, chunk,
                                               floors=(kind == "chunk")))
        self._warmed = True
        # autotune's idle tuner (MXNET_AUTOTUNE=search): every decode
        # bucket program is warm and harmless on null inputs (page tables
        # of the drop page), so time each and commit the cheapest bucket
        # set for the next process's DecodeConfig; a failure leaves the
        # table untuned
        from .. import autotune as _autotune

        if _autotune.search_enabled():
            try:
                _autotune.measure.decode_idle_tune(self)
            except Exception:  # noqa: BLE001 - warm-up must not fail
                _autotune.fallback("serve_idle")
        spec = getattr(self, "spec", None)
        if spec is not None and not spec.warmed:
            fresh += spec.warm_up()
        return fresh

    def _null_inputs(self, batch, chunk, floors=False):
        c = self.page_config
        inputs = (_np.zeros((batch, chunk), dtype=_np.int32),
                  _np.full((batch, c.pages_per_seq), self.pool.null_page,
                           dtype=_np.int32),
                  _np.zeros((batch,), dtype=_np.int32),
                  _np.ones((batch,), dtype=_np.int32))
        if floors:
            inputs += (_np.zeros((batch,), dtype=_np.int32),)
        return inputs

    def provenance(self):
        return {p.label: p.provenance for p in self._programs.values()}

    def _run(self, key, inputs):
        with self._run_lock:
            prog = self._programs.get(key) or self._build(key)
            return prog.fn(*inputs)

    def _table(self, rows, seqs_pages):
        tables = _np.full((rows, self.page_config.pages_per_seq),
                          self.pool.null_page, dtype=_np.int32)
        for i, pages in enumerate(seqs_pages):
            tables[i, :len(pages)] = pages
        return tables

    def prefill(self, seq):
        """Run one sequence's prompt through its prefill bucket; writes the
        prompt's K/V into the sequence's reserved pages and returns
        ``(first_token, nonfinite_count)``."""
        prompt = seq.req.prompt
        t_bucket = self.prefill_bucket(len(prompt))
        tokens = _np.zeros((1, t_bucket), dtype=_np.int32)
        tokens[0, :len(prompt)] = prompt
        next_tok, bad = self._run(("prefill", t_bucket), (
            tokens, self._table(1, [seq.pages]),
            _np.zeros((1,), dtype=_np.int32),
            _np.array([len(prompt)], dtype=_np.int32)))
        return int(next_tok[0]), int(bad[0])

    def prefill_cached(self, seq, hit_tokens):
        """Cached-suffix prefill (``serve/cache.py``): the first
        ``hit_tokens`` positions of the prompt are already resident in
        shared pages, so only the suffix runs, through the ``("chunk",
        T)`` program, which attends over the shared context and writes
        strictly above the ``hit_tokens`` floor."""
        suffix = seq.req.prompt[hit_tokens:]
        t_bucket = self.prefill_bucket(len(suffix))
        tokens = _np.zeros((1, t_bucket), dtype=_np.int32)
        tokens[0, :len(suffix)] = suffix
        next_tok, bad = self._run(("chunk", t_bucket), (
            tokens, self._table(1, [seq.pages]),
            _np.array([hit_tokens], dtype=_np.int32),
            _np.array([len(suffix)], dtype=_np.int32),
            _np.array([hit_tokens], dtype=_np.int32)))
        return int(next_tok[0]), int(bad[0])

    def verify_step(self, seqs, chunks, k):
        """One speculative verify (``serve/spec.py``): judge each
        sequence's draft chunk (``chunks[i]``, 1..K+1 tokens starting at
        its last committed token) in one step.  Returns ``(y, bad)``:
        ``y[i][j]`` is the target's argmax after ``chunks[i][:j+1]``."""
        bucket = self.decode_bucket(len(seqs))
        T = k + 1
        tokens = _np.zeros((bucket, T), dtype=_np.int32)
        ctx_lens = _np.zeros((bucket,), dtype=_np.int32)
        chunk_lens = _np.zeros((bucket,), dtype=_np.int32)
        floors = _np.zeros((bucket,), dtype=_np.int32)
        for i, (seq, ch) in enumerate(zip(seqs, chunks)):
            tokens[i, :len(ch)] = ch
            ctx_lens[i] = seq.length
            chunk_lens[i] = len(ch)
            floors[i] = seq.prefix_len
        y, bad = self._run(("verify", (bucket, k)), (
            tokens, self._table(bucket, [s.pages for s in seqs]), ctx_lens,
            chunk_lens, floors))
        return y[:len(seqs)], bad[:len(seqs)]

    def decode_step(self, seqs):
        """One iteration over ``seqs`` (the live set or a bisected
        subset): each sequence's pending token is written at its next
        position and its next token sampled.  Returns aligned
        ``(next_tokens, nonfinite_counts)`` numpy arrays."""
        bucket = self.decode_bucket(len(seqs))
        tokens = _np.zeros((bucket, 1), dtype=_np.int32)
        ctx_lens = _np.zeros((bucket,), dtype=_np.int32)
        for i, seq in enumerate(seqs):
            tokens[i, 0] = seq.last_token
            ctx_lens[i] = seq.length
        next_tok, bad = self._run(("decode", bucket), (
            tokens, self._table(bucket, [s.pages for s in seqs]), ctx_lens,
            _np.ones((bucket,), dtype=_np.int32)))
        return next_tok[:len(seqs)], bad[:len(seqs)]

    def stats(self):
        return {
            "step": self.step, "root": self.root, "warmed": self._warmed,
            "device": str(self._device),
            "model": type(self._block).__name__,
            "geometry": {"num_layers": self._block.num_layers,
                         "num_kv_heads": self._block.num_kv_heads,
                         "head_dim": self._block.head_dim,
                         "vocab_size": self._block.vocab_size},
            "pool": self.pool.stats(),
            "buckets": self.provenance(),
            "config": self.config.as_dict(),
            "cache": self.cache.stats() if self.cache is not None
            else {"enabled": False},
            "spec": self.spec.stats() if self.spec is not None
            else {"enabled": False},
            "bank": {"enabled": False},
        }


class DecodeScheduler:
    """The continuous-batching loop (module doc).

    One daemon thread owns the model, the pool and every live sequence;
    admission (``submit``) only validates, reserves nothing, and enqueues:
    page reservation, prefill, decode, eviction and reclamation all happen
    on the loop, so there is exactly one writer of serving state and all
    device work of a running scheduler goes through its thread.
    ``breakers`` (a ``breaker.BreakerBoard``, shared with the owning
    Server) quarantines repeatedly-failing decode / prefill buckets."""

    def __init__(self, runner, breakers=None, start=True, tenant=None):
        if tenant is not None:
            raise MXNetError(_TENANCY)
        self._runner = runner
        self.config = runner.config
        self._breakers = breakers
        self._cond = threading.Condition()
        self._waiting = deque()
        self._live = {}               # sid -> _Seq, insertion-ordered
        self._next_sid = 0
        self._closed = False
        self._drain = True
        self._pending_runner = None
        self.steps = 0
        self.admitted_total = 0
        self.evictions = {}
        self._recent = deque(maxlen=64)
        self._thread = None
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, args=(weakref.ref(self),), daemon=True,
            name="mx-serve-decode")
        self._thread.start()

    @property
    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    @property
    def runner(self):
        return self._runner

    def stop(self, drain=True, timeout=None):
        """Stop intake; with ``drain`` (default) live sequences finish
        their generation and waiting ones are admitted and served first,
        otherwise everything fails fast with ``ServerClosed``."""
        with self._cond:
            self._closed = True
            self._drain = bool(drain)
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        return not self.alive

    def swap(self, new_runner):
        """Repoint decoding at a new runner.  Live sequences FINISH on the
        old runner (their KV state is its pool); new admissions wait and
        start on the new one once the old batch drains."""
        if not isinstance(new_runner, DecodeRunner):
            raise ValueError("swap needs a DecodeRunner")
        with self._cond:
            if self._closed:
                raise ServerClosed("decode scheduler is shut down")
            self._pending_runner = new_runner
            self._cond.notify_all()

    # -- admission ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               timeout_ms=None, request_id=None, on_token=None,
               tenant=None):
        """Enqueue one generation request; returns its
        ``concurrent.futures.Future``.  Validation is all up front: static
        shape limits raise ``DecodeError``, an impossible page reservation
        raises ``PagePoolExhausted``, a full waiting queue rejects with
        ``ServerOverloaded``, a quarantined prefill bucket with
        ``BucketQuarantined``, so a request that enqueues can always be
        admitted once capacity frees."""
        if tenant is not None:
            raise DecodeError(_TENANCY)
        cfg = self.config
        prompt = [int(t) for t in (prompt or ())]
        if not prompt:
            raise DecodeError("decode needs a non-empty prompt "
                              "(list of int token ids)")
        vocab = self._runner.block.vocab_size
        if min(prompt) < 0 or max(prompt) >= vocab:
            raise DecodeError("prompt token ids must be in [0, %d)"
                              % vocab)
        mnt = cfg.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        if mnt < 1:
            raise DecodeError("max_new_tokens must be >= 1")
        mnt = min(mnt, cfg.max_new_tokens)
        total = len(prompt) + mnt
        if total > cfg.max_context:
            raise DecodeError(
                "prompt (%d) + max_new_tokens (%d) exceeds "
                "max_context=%d" % (len(prompt), mnt, cfg.max_context))
        t_bucket = self._runner.prefill_bucket(len(prompt))
        need = self._runner.page_config.pages_for(total)
        if need > self._runner.pool.capacity:
            raise PagePoolExhausted(
                "request needs %d KV pages but the pool only has %d"
                % (need, self._runner.pool.capacity))
        if self._breakers is not None and \
                self._breakers.blocked(("prefill", t_bucket)):
            if telemetry.ENABLED:
                telemetry.SERVE_REQUESTS.labels(
                    result="quarantined").inc()
            raise self._breakers.quarantine_error(("prefill", t_bucket))
        timeout_ms = cfg.timeout_ms if timeout_ms is None else timeout_ms
        deadline = None if timeout_ms is None \
            else time.perf_counter() + float(timeout_ms) / 1e3
        req = DecodeRequest(
            prompt, mnt,
            eos_id=self._runner.eos_id if eos_id is None else eos_id,
            deadline=deadline, request_id=request_id, on_token=on_token)
        with self._cond:
            if self._closed:
                raise ServerClosed("decode scheduler is shut down")
            if len(self._waiting) >= cfg.queue_depth:
                if telemetry.ENABLED:
                    telemetry.SERVE_REQUESTS.labels(
                        result="rejected").inc()
                raise ServerOverloaded(
                    "decode admission queue full (%d waiting, depth=%d)"
                    % (len(self._waiting), cfg.queue_depth))
            self._waiting.append(req)
            if telemetry.ENABLED:
                telemetry.SERVE_DECODE_WAITING.set(len(self._waiting))
            self._cond.notify_all()
        return req.future

    # -- introspection ------------------------------------------------------
    def stats(self):
        with self._cond:
            waiting = len(self._waiting)
            live = [{"request_id": s.req.request_id,
                     "prompt_tokens": len(s.req.prompt),
                     "generated": len(s.tokens),
                     "max_new_tokens": s.req.max_new_tokens,
                     "length": s.length,
                     "pages": len(s.pages or ()),
                     "joined_step": s.joined_step}
                    for s in self._live.values()]
        board = {}
        if self._breakers is not None:
            board = {k: v for k, v in self._breakers.snapshot().items()
                     if k.startswith(("('decode'", "('prefill'",
                                      "('spec'", "('draft'"))}
        return {
            "alive": self.alive,
            "waiting": waiting,
            "live": live,
            "steps": self.steps,
            "admitted": self.admitted_total,
            "evictions": dict(self.evictions),
            "runner": self._runner.stats(),
            "breakers": board,
            "recent": list(self._recent)[-16:],
        }

    def recent(self):
        return list(self._recent)

    def oldest_waiting_age(self):
        """Seconds the head-of-line waiting request has queued (0.0 when
        empty)."""
        with self._cond:
            if not self._waiting:
                return 0.0
            return max(0.0,
                       time.perf_counter() - self._waiting[0].enqueued)

    # -- the loop -----------------------------------------------------------
    @staticmethod
    def _run(ref):
        """Thread body.  Holds the scheduler (and through it the runner
        and the device-resident pool) only WEAKLY between iterations: a
        scheduler dropped without ``stop()`` becomes collectable, and the
        loop winds down."""
        while True:
            sched = ref()
            if sched is None:
                return
            try:
                more = sched._loop_once()
            finally:
                del sched
            if not more:
                return

    def _loop_once(self):
        """One scheduling iteration; False means the loop must exit."""
        with self._cond:
            if self._closed:
                if not self._drain:
                    self._abort_locked()
                    return False
                if not self._waiting and not self._live:
                    return False
            if not self._waiting and not self._live:
                self._cond.wait(0.25)
                return True
        try:
            self._expire()
            self._maybe_install_runner()
            self._admit()
            if self._live:
                self._step()
            elif self._waiting:
                # waiting but nothing admissible yet (a draining swap, or
                # breakers cooling): don't spin
                time.sleep(0.005)
        except Exception:  # noqa: BLE001 - the loop must survive
            trace.instant("serve_decode_loop_error", cat="serve")
            time.sleep(0.01)
        return True

    def _abort_locked(self):
        items, self._waiting = list(self._waiting), deque()
        live, self._live = list(self._live.values()), {}
        for req in items:
            fail_request(req, ServerClosed(
                "server shut down before admission"), "cancelled")
            self._bump("cancelled")
        for seq in live:
            self._release(seq)
            fail_request(seq.req, ServerClosed(
                "server shut down mid-generation after %d token(s)"
                % len(seq.tokens)), "cancelled")
            self._bump("cancelled")
            self._record(seq, "cancelled")
        self._gauges()

    def _bump(self, reason):
        self.evictions[reason] = self.evictions.get(reason, 0) + 1
        if telemetry.ENABLED:
            telemetry.SERVE_DECODE_EVICTIONS.labels(reason=reason).inc()

    def _release(self, seq):
        runner = self._runner
        if seq.shared:
            # drop this sequence's references on its shared prefix pages
            # first: they live in the pool's shared segment, not under
            # the sequence's id
            if runner.cache is not None:
                runner.cache.release(seq.shared)
            else:
                runner.pool.shared_unref(seq.shared)
            seq.shared = []
        if seq.pages is not None:
            runner.pool.release(seq.sid)
            seq.pages = None
        if runner.spec is not None and seq.dpages is not None:
            runner.spec.release(seq)

    def _record(self, seq, reason):
        self._recent.append({
            "request_id": seq.req.request_id,
            "joined_step": seq.joined_step,
            "left_step": self.steps,
            "prompt_tokens": len(seq.req.prompt),
            "generated": len(seq.tokens),
            "reason": reason,
        })

    def _gauges(self):
        if telemetry.ENABLED:
            telemetry.SERVE_DECODE_LIVE.set(len(self._live))
            with self._cond:    # an RLock: _abort_locked holds it
                telemetry.SERVE_DECODE_WAITING.set(len(self._waiting))
            pool = self._runner.pool
            telemetry.SERVE_KV_PAGES_IN_USE.set(pool.in_use)
            telemetry.SERVE_KV_PAGES_HIGH_WATER.set(pool.high_water)

    def _expire(self):
        now = time.perf_counter()
        with self._cond:
            keep = deque()
            for req in self._waiting:
                if req.expired(now):
                    fail_request(req, RequestTimeout(
                        "deadline expired after %.1f ms waiting for "
                        "admission" % ((now - req.enqueued) * 1e3)),
                        "timeout")
                    self._bump("timeout")
                else:
                    keep.append(req)
            self._waiting = keep
            dead = [s for s, q in self._live.items()
                    if q.req.expired(now)]
        for sid in dead:
            with self._cond:
                seq = self._live.pop(sid)
            self._release(seq)
            fail_request(seq.req, RequestTimeout(
                "deadline expired mid-generation after %d token(s)"
                % len(seq.tokens)), "timeout")
            self._bump("timeout")
            self._record(seq, "timeout")
        self._gauges()

    def _maybe_install_runner(self):
        with self._cond:
            if self._pending_runner is None or self._live:
                return
            old, self._runner = self._runner, self._pending_runner
            self._pending_runner = None
            self.config = self._runner.config
        if old.cache is not None:
            old.cache.clear()     # trie refs were the last holders
        old.pool.check()          # every page must have come home
        if telemetry.ENABLED:
            telemetry.SERVE_SWAPS.inc()
        trace.instant("serve_decode_swap", cat="serve",
                      args={"step": self._runner.step})

    def _evict_poisoned(self, seqs):
        """Sequences whose request id the armed fault plan marks
        (``serve_poison@<rid>``) are evicted ALONE: pages reclaimed,
        batch-mates untouched."""
        out = []
        for seq in seqs:
            if _inject.poisoned(seq.req.request_id):
                _inject.record_firing("serve_poison",
                                      seq.req.request_id, consume=True)
                with self._cond:
                    self._live.pop(seq.sid, None)
                self._release(seq)
                exc = InjectedFault(
                    "injected poison request %s" % seq.req.request_id,
                    site="serve_poison")
                if telemetry.ENABLED:
                    telemetry.SERVE_POISON.inc()
                fail_request(seq.req, exc, "poisoned")
                self._bump("poisoned")
                self._record(seq, "poisoned")
            else:
                out.append(seq)
        return out

    def _pages_needed(self, req):
        """The worst-case reservation one request admits with."""
        return self._runner.page_config.pages_for(
            len(req.prompt) + req.max_new_tokens)

    def _admit(self):
        """Fill free slots from the waiting queue in arrival order: reserve
        the worst-case page count, prefill through the bucket path, emit
        the first token.  Stops at the first request the pool cannot hold
        yet."""
        while len(self._live) < self.config.max_live:
            with self._cond:
                if not self._waiting or self._pending_runner is not None:
                    return
                req = self._waiting[0]
                pool = self._runner.pool
                cache = self._runner.cache
                need = self._pages_needed(req)
                if cache is not None:
                    # admission charges only the UNCACHED suffix
                    _, hit_tok = cache.match(req.prompt)
                    need -= hit_tok // self.config.page_size
                if need > pool.capacity:
                    # a hot swap may have shrunk the pool since submit()
                    # validated: fail rather than block the queue
                    self._waiting.popleft()
                    fail_request(req, PagePoolExhausted(
                        "request needs %d KV pages but the (swapped) "
                        "pool only has %d" % (need, pool.capacity)),
                        "error")
                    self._bump("error")
                    continue
                if not pool.can_alloc(need):
                    # pool pressure: reclaim cold (LRU) cached prefixes
                    # before giving up on this iteration
                    if cache is None or cache.evict(need) == 0 or \
                            not pool.can_alloc(need):
                        return
                self._waiting.popleft()
                if telemetry.ENABLED:
                    telemetry.SERVE_DECODE_WAITING.set(len(self._waiting))
                sid = self._next_sid
                self._next_sid += 1
            seq = _Seq(req, sid)
            if _inject.poisoned(req.request_id):
                self._evict_poisoned([seq])
                continue
            hit_tok = 0
            if cache is not None:
                try:
                    _inject.fire("serve_cache", seq=req.request_id)
                except (InjectedFault, InjectedIOError):
                    # the corrupt-prefix drill: drop the matched subtree
                    # (live readers keep their refs) and prefill cold
                    cache.invalidate(req.prompt)
                shared, hit_tok, cls = cache.acquire(req.prompt)
                seq.cache_class = cls
                seq.prefix_len = hit_tok
                seq.shared = list(shared)
            try:
                t_bucket = self._runner.prefill_bucket(
                    len(req.prompt) - hit_tok)
            except DecodeError as exc:
                # a swapped runner's bucket table may not cover a prompt
                # the old one admitted: resolve the future anyway
                self._release(seq)
                fail_request(req, exc, "error")
                self._bump("error")
                continue
            bclass = ("prefill", t_bucket)
            if self._breakers is not None and \
                    not self._breakers.allow(bclass):
                self._release(seq)
                fail_request(req, self._breakers.quarantine_error(bclass),
                             "quarantined")
                self._bump("quarantined")
                continue
            try:
                own = self._pages_needed(req) - len(seq.shared)
                seq.pages = list(seq.shared) + \
                    list(self._runner.pool.alloc(sid, own))
            except PagePoolExhausted as exc:
                # only reachable when the serve_cache drill invalidated a
                # prefix between the reservation check and the allocation
                self._release(seq)
                fail_request(req, exc, "error")
                self._bump("error")
                continue
            t0 = time.perf_counter()
            blabel = ("chunk:t%d" if hit_tok else "prefill:t%d") % t_bucket
            try:
                with trace.use(req.trace), \
                        trace.span("serve_decode_prefill", hist=False,
                                   cat="serve",
                                   args={"bucket": blabel,
                                         "request_id": req.request_id}):
                    if hit_tok:
                        tok, bad = self._runner.prefill_cached(seq, hit_tok)
                    else:
                        tok, bad = self._runner.prefill(seq)
            except Exception as exc:  # noqa: BLE001 - per request
                self._release(seq)
                if self._breakers is not None:
                    self._breakers.failure(bclass)
                fail_request(req, exc, "error")
                self._bump("error")
                continue
            if self._breakers is not None:
                self._breakers.success(bclass)
            seq.length = len(req.prompt)
            seq.joined_step = self.steps
            seq.t_prefill = time.perf_counter() - t0
            if telemetry.ENABLED:
                telemetry.SERVE_DECODE_PREFILLS.inc()
                telemetry.SERVE_DECODE_PREFILL_TOKENS.inc(
                    len(req.prompt) - hit_tok)
            with self._cond:
                self._live[sid] = seq
            self.admitted_total += 1
            if bad:
                self._evict_nonfinite(seq, bad)
                continue
            if cache is not None:
                # only a healthy prefill populates the trie; the newly
                # adopted prompt pages move to the shared segment with
                # refcount 2 (trie + this reader)
                adopted = cache.insert(req.prompt, sid, seq.pages, hit_tok)
                if adopted:
                    seq.shared = list(
                        seq.pages[:len(seq.shared) + adopted])
            self._emit(seq, int(tok), t0)
            self._finish_if_done(seq)
            self._gauges()

    def _evict_nonfinite(self, seq, bad):
        """The per-token output guard tripped: this sequence's logits went
        NaN/Inf, so it fails alone instead of streaming garbage."""
        with self._cond:
            self._live.pop(seq.sid, None)
        self._release(seq)
        if telemetry.ENABLED:
            telemetry.SERVE_NONFINITE_OUTPUTS.inc(int(bad))
            telemetry.SERVE_NONFINITE_BATCHES.inc()
            telemetry.SERVE_POISON.inc()
        trace.instant("serve_decode_nonfinite", cat="serve",
                      ctx=seq.req.trace,
                      args={"request_id": seq.req.request_id,
                            "elements": int(bad)})
        fail_request(seq.req, DecodeError(
            "sequence evicted: %d nonfinite logit element(s) at token "
            "%d (output guard)" % (int(bad), len(seq.tokens))),
            "poisoned")
        self._bump("poisoned")
        self._record(seq, "nonfinite")

    def _emit(self, seq, token, t_start):
        """One generated token: bookkeeping, telemetry, the per-token trace
        span on the request's own trace, and the streaming callback."""
        now = time.perf_counter()
        seq.tokens.append(token)
        seq.last_token = token
        if seq.first_token_t is None:
            seq.first_token_t = now
            if telemetry.ENABLED:
                telemetry.SERVE_DECODE_TTFT_SECONDS.labels(
                    cache=seq.cache_class or "miss").observe(
                    now - seq.req.enqueued)
        if telemetry.ENABLED:
            telemetry.SERVE_DECODE_TOKENS.inc()
        if trace.ENABLED and seq.req.trace is not None:
            trace.record_span(
                "serve_decode_token", t_start, now - t_start,
                ctx=seq.req.trace, cat="serve",
                args={"index": len(seq.tokens) - 1, "token": token,
                      "request_id": seq.req.request_id})
        cb = seq.req.on_token
        if cb is not None:
            try:
                cb(token, len(seq.tokens) - 1)
            except Exception:     # a sick consumer must not stall decode
                seq.req.on_token = None

    def _finish_if_done(self, seq):
        reason = seq.done_reason
        if reason is None:
            return False
        with self._cond:
            self._live.pop(seq.sid, None)
        self._release(seq)
        self._bump("finished")
        self._record(seq, reason)
        done_t = time.perf_counter()
        try:
            seq.req.future.set_result(
                {"tokens": list(seq.tokens), "finish_reason": reason})
        except InvalidStateError:
            return True
        if telemetry.ENABLED:
            telemetry.SERVE_REQUESTS.labels(result="ok").inc()
            telemetry.SERVE_REQUEST_SECONDS.observe(
                done_t - seq.req.enqueued)
        if trace.ENABLED and seq.req.trace is not None:
            trace.record_span(
                "serve_request", seq.req.enqueued,
                done_t - seq.req.enqueued, ctx=seq.req.trace, root=True,
                cat="serve",
                args={"result": "ok", "request_id": seq.req.request_id,
                      "tokens": len(seq.tokens),
                      "finish_reason": reason})
        return True

    def _pick_bucket(self, n):
        """Smallest non-quarantined decode bucket covering ``n`` live
        sequences, else the largest non-blocked smaller bucket (the live
        set steps in chunks while a bucket cools down); None when every
        bucket is quarantined."""
        def blocked(b):
            return self._breakers is not None and \
                self._breakers.blocked(("decode", b))

        for b in self.config.batch_sizes:
            if b >= n and not blocked(b):
                return b
        for b in reversed(self.config.batch_sizes):
            if b <= n and not blocked(b):
                return b
        return None

    def _step(self):
        """One continuous-batching iteration over the live set:
        speculative sequences advance K at a time through the spec plane,
        everything else (and every fallback) one token."""
        live = self._evict_poisoned(list(self._live.values()))
        if not live:
            self._gauges()
            return
        spec = self._runner.spec
        if spec is not None:
            live = self._spec_round(live, spec)
        if live:
            self._step_normal(live)
        else:
            self._gauges()

    def _spec_round(self, live, spec):
        """Drive one plane round over the speculative slice of the live
        set; emits accepted tokens and returns the slice to step normally
        this iteration."""
        for seq in live:
            if seq.spec is None:
                spec.attach(seq)    # failure leaves it decoding normally
        normal = [s for s in live if not s.spec]
        cand = [s for s in live if s.spec]
        if not cand:
            return normal
        t0 = time.perf_counter()
        try:
            results, fallen = spec.round(cand, self._breakers)
        except Exception:  # noqa: BLE001 - step them normally
            trace.instant("serve_spec_round_error", cat="serve")
            return normal + cand
        if results:
            self.steps += 1
            if telemetry.ENABLED:
                telemetry.SERVE_DECODE_STEPS.inc()
        for seq, emitted, bad in results:
            if bad:
                self._evict_nonfinite(seq, bad)
                continue
            for tok in emitted:
                seq.length += 1
                self._emit(seq, int(tok), t0)
                if self._finish_if_done(seq):
                    break
        self._gauges()
        return normal + fallen

    def _step_normal(self, live):
        bucket = self._pick_bucket(len(live))
        if bucket is None:
            time.sleep(0.005)     # every decode bucket cooling down
            return
        seqs = live[:bucket]
        bclass = ("decode", bucket)
        if self._breakers is not None and not self._breakers.allow(bclass):
            time.sleep(0.005)
            return
        t0 = time.perf_counter()
        try:
            _inject.fire("serve_dispatch")
        except (InjectedFault, InjectedIOError):
            # a transient injected dispatch fault: one breaker strike,
            # nobody evicted; the sequences retry next iteration
            if self._breakers is not None:
                self._breakers.failure(bclass)
            return
        with trace.use(seqs[0].req.trace), \
                trace.span("serve_decode_step", hist=False, cat="serve",
                           args={"bucket": "decode:b%d" % bucket,
                                 "live": len(seqs)}), \
                trace.watchdog.watch("serve_dispatch"):
            pairs = self._step_split(seqs)
        self.steps += 1
        dt = time.perf_counter() - t0
        if telemetry.ENABLED:
            telemetry.SERVE_DECODE_STEPS.inc()
            telemetry.SERVE_DECODE_BATCH.observe(len(seqs))
            telemetry.SERVE_DECODE_TOKEN_SECONDS.observe(dt)
        failed = [p for p in pairs if p[3] is not None]
        if self._breakers is not None:
            (self._breakers.failure if failed
             else self._breakers.success)(bclass)
        any_ok = any(p[3] is None for p in pairs)
        for seq, tok, bad, exc, isolated in pairs:
            if exc is not None:
                poisoned = isolated and any_ok
                with self._cond:
                    self._live.pop(seq.sid, None)
                self._release(seq)
                if poisoned and telemetry.ENABLED:
                    telemetry.SERVE_POISON.inc()
                fail_request(seq.req, exc,
                             "poisoned" if poisoned else "error")
                self._bump("poisoned" if poisoned else "error")
                self._record(seq, "poisoned" if poisoned else "error")
                continue
            if bad:
                self._evict_nonfinite(seq, bad)
                continue
            seq.length += 1
            self._emit(seq, int(tok), t0)
            self._finish_if_done(seq)
        if len(seqs) < len(self._live):
            # chunked iteration (a larger bucket is cooling down): rotate
            # the stepped sequences behind the tail so every live
            # sequence keeps making progress
            with self._cond:
                for seq in seqs:
                    if seq.sid in self._live:
                        self._live[seq.sid] = self._live.pop(seq.sid)
        self._gauges()

    def _step_split(self, seqs, depth=0):
        """Run one decode iteration for ``seqs``; on failure retry
        bisected down to single sequences so a poisoned sequence fails
        alone.  Returns ``[(seq, token, bad, exc, isolated)]``.  A retry
        is safe: a step writes each sequence's K/V at the same (page,
        slot) it would have the first time, in place, and sampling is
        greedy."""
        try:
            toks, bads = self._runner.decode_step(seqs)
        except Exception as exc:  # noqa: BLE001 - contained
            if len(seqs) == 1:
                isolated = depth > 0 or \
                    getattr(exc, "site", None) == "serve_poison"
                return [(seqs[0], None, None, exc, isolated)]
            if telemetry.ENABLED:
                telemetry.SERVE_BISECT_SPLITS.inc()
            trace.instant("serve_decode_bisect", cat="serve",
                          args={"sequences": len(seqs), "depth": depth,
                                "error": type(exc).__name__})
            mid = len(seqs) // 2
            return self._step_split(seqs[:mid], depth + 1) + \
                self._step_split(seqs[mid:], depth + 1)
        return [(s, int(toks[i]), int(bads[i]), None, False)
                for i, s in enumerate(seqs)]


# ---------------------------------------------------------------------------
# TinyDecoder: the reference decoder model (contract documentation)
# ---------------------------------------------------------------------------

from ..gluon import nn as _nn  # noqa: E402
from ..ops import core as _core  # noqa: E402
from ..ops import nn as _ops_nn  # noqa: E402


class TinyDecoder(HybridBlock):
    """A small, real transformer decoder implementing the decode-path model
    contract (module doc): norm-free MHA + ReLU MLP layers, sinusoidal
    absolute positions, causal chunk attention over a gathered paged
    context.  Its widths are arguments; parameter names are the JAX
    package's (``embed.weight``, ``q0.weight``, ..., ``unembed.bias``)."""

    def __init__(self, vocab_size=64, num_layers=2, num_heads=2,
                 head_dim=8, hidden=None, eos_id=None, **kwargs):
        super().__init__(**kwargs)
        self.vocab_size = int(vocab_size)
        self.num_layers = int(num_layers)
        self.num_kv_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.eos_id = eos_id
        units = self.num_kv_heads * self.head_dim
        self.units = units
        hidden = hidden or units * 2
        self.embed = _nn.Embedding(self.vocab_size, units)
        for layer in range(self.num_layers):
            for name in ("q", "k", "v", "o"):
                setattr(self, "%s%d" % (name, layer),
                        _nn.Dense(units, flatten=False, in_units=units))
            setattr(self, "up%d" % layer,
                    _nn.Dense(hidden, flatten=False, in_units=units))
            setattr(self, "down%d" % layer,
                    _nn.Dense(units, flatten=False, in_units=hidden))
        self.unembed = _nn.Dense(self.vocab_size, flatten=False,
                                 in_units=units)
        # the JAX forward builds these frequencies from numpy at every
        # call; here they are a device buffer, so a step copies nothing
        half = units // 2
        inv = _np.asarray(1.0 / (10000.0 ** (_np.arange(half)
                                             / max(1, half))),
                          dtype="float32")
        self.register_buffer("_inv_freq", torch.from_numpy(inv),
                             persistent=False)

    def _positional(self, positions):
        """Sinusoidal encoding of absolute positions [B, T] ->
        [B, T, units] (the first half sin, the second cos)."""
        ang = positions[:, :, None] * self._inv_freq[None, None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=2)

    def trunk(self, tokens, k_ctx, v_ctx, ctx_lengths):
        """The layers of ``forward``: (hidden ``[B, T, units]``, k_new,
        v_new) for every chunk position.  ``unembed(hidden)`` is the
        logits of every position (``forward`` keeps the last valid one)."""
        B, T = tokens.shape
        S = k_ctx.shape[2]
        H, Dh, C = self.num_kv_heads, self.head_dim, self.units
        dev = tokens.device
        f32 = torch.float32
        ctx_f = ctx_lengths.to(f32)[:, None]                     # [B,1]
        steps = torch.arange(T, dtype=f32, device=dev)[None, :]  # [1,T]
        q_pos = ctx_f + steps                                    # [B,T]
        x = self.embed(tokens) + self._positional(q_pos)

        # one [B, T, S+T] additive attention bias shared by all layers:
        # context keys are valid while their position < ctx_length; chunk
        # keys are causal (queries past chunk_length produce values that
        # are never read).  Invalid context keys take position +1e9 so
        # they FAIL the causal test (key_pos <= q_pos); a negative
        # sentinel would pass it and let the scrubbed zero tail in.
        if S:
            key_ctx_pos = torch.arange(S, dtype=f32, device=dev)[None, :]
            ctx_valid = (key_ctx_pos < ctx_f).to(f32)            # [B,S]
            key_pos = torch.cat(
                [ctx_valid * key_ctx_pos + (1.0 - ctx_valid) * 1e9,
                 ctx_f + steps], dim=1)                           # [B,S+T]
        else:
            key_pos = ctx_f + steps
        causal = (key_pos[:, None, :] <= q_pos[:, :, None]).to(f32)
        bias = (1.0 - causal) * -1e9                             # [B,T,S+T]
        scale = float(_np.sqrt(Dh))

        k_chunks, v_chunks = [], []
        for layer in range(self.num_layers):
            q = getattr(self, "q%d" % layer)(x).reshape(B, T, H, Dh)
            k = getattr(self, "k%d" % layer)(x).reshape(B, T, H, Dh)
            v = getattr(self, "v%d" % layer)(x).reshape(B, T, H, Dh)
            k_chunks.append(k)
            v_chunks.append(v)
            k_all = torch.cat([k_ctx[:, layer], k], dim=1) if S else k
            v_all = torch.cat([v_ctx[:, layer], v], dim=1) if S else v
            q2 = q.transpose(1, 2).reshape(B * H, T, Dh)
            k2 = k_all.transpose(1, 2).reshape(B * H, S + T, Dh)
            v2 = v_all.transpose(1, 2).reshape(B * H, S + T, Dh)
            scores = _core.batch_dot(q2, k2, transpose_b=True) / scale
            scores = (scores.reshape(B, H, T, S + T)
                      + bias[:, None]).reshape(B * H, T, S + T)
            probs = _ops_nn.softmax(scores, axis=-1)
            att = _core.batch_dot(probs, v2).reshape(B, H, T, Dh) \
                .transpose(1, 2).reshape(B, T, C)
            x = x + getattr(self, "o%d" % layer)(att)
            x = x + getattr(self, "down%d" % layer)(
                _ops_nn.relu(getattr(self, "up%d" % layer)(x)))
        return x, torch.stack(k_chunks, dim=2), torch.stack(v_chunks, dim=2)

    def forward(self, tokens, k_ctx, v_ctx, ctx_lengths, chunk_lengths):
        x, k_new, v_new = self.trunk(tokens, k_ctx, v_ctx, ctx_lengths)
        logits = self.unembed(x)                              # [B, T, V]
        # the logit row of the last valid position, as the JAX forward
        # takes it: a one-hot weighted sum over T
        T = tokens.shape[1]
        sel = (torch.arange(T, device=tokens.device)[None, :]
               == (chunk_lengths.long() - 1)[:, None]).to(logits.dtype)
        last = torch.sum(logits * sel[:, :, None], dim=1)     # [B, V]
        return last, k_new, v_new
