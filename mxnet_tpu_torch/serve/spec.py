"""mx.serve.spec: speculative decoding, draft-propose and target-verify.

Counterpart of ``mxnet_tpu/serve/spec.py``.  A small **draft** decoder
proposes K tokens a round with K cheap steps, then the **target** model
judges all K in ONE step: the ``("verify", (B, K))`` program replicates
every sequence K+1 times with chunk lengths ``1..K+1``, so one forward
yields the target's argmax after every prefix of the proposed chunk.
Greedy acceptance is *exact*: token j+1 of the chunk is kept iff the
draft's proposal equals the target's argmax after token j, so the emitted
stream is the single-step greedy stream; speculation changes the time a
token costs, never the tokens.

Mechanics:

- **The draft is a full ``DecodeRunner``** on the target's device, with
  the same bucket and warm-up machinery and its own ``PagePool``
  (``max_context`` stretched by K+1 for speculative overshoot).  Draft
  programs and the target's verify programs are all built at warm-up.
- **Catch-up, not rewind.**  The draft cache is never rewritten after a
  rejected round; each round first *feeds the committed stream* (prompt +
  accepted tokens) from the draft's cursor ``dlen`` forward, and a step's
  output counts as a proposal only once that queue is empty.  Rejected
  speculative K/V beyond ``dlen`` is hidden by the draft's own scrub and
  overwritten in place by later rounds.
- **Failure containment.**  Draft trouble never costs correctness: pool
  pressure, a nonfinite draft row, a draft step failure or an injected
  ``spec_verify@<rid>`` fault detaches the affected sequence alone back to
  non-speculative decode (a breaker strike on the ``("draft", bucket)``
  class; batch-mates keep speculating).

K comes from the argument, then ``MXNET_SERVE_SPEC_K``, then the
``spec_k`` autotune winner (a structural site: K cannot change tokens),
then 4.
"""
from __future__ import annotations

from types import SimpleNamespace

from .. import telemetry
from ..base import get_env
from ..context import Context
from ..resilience import inject as _inject
from ..resilience.inject import InjectedFault, InjectedIOError

__all__ = ["SpecPlane", "resolve_k"]

_K_DEFAULT = 4
_K_MAX = 16


def resolve_k(k, max_live):
    """The per-round proposal count: explicit argument >
    ``MXNET_SERVE_SPEC_K`` > the committed ``spec_k`` autotune winner
    for this ``max_live`` > 4.  Clamped to [1, 16]."""
    if k is None:
        env = get_env("MXNET_SERVE_SPEC_K", int, 0)
        if env > 0:
            k = env
    if k is None:
        from .. import autotune as _at

        if _at.is_enabled():
            cfg, prov = _at.lookup_info("spec_k", (int(max_live),),
                                        _K_DEFAULT)
            if prov == "tuned":
                try:
                    k = int(cfg)
                except (TypeError, ValueError):
                    _at.fallback("invalid_config")
    if k is None:
        k = _K_DEFAULT
    return max(1, min(_K_MAX, int(k)))


class SpecPlane:
    """Draft runner + verify programs + the accept/detach round loop.

    Owned by the target ``DecodeRunner`` (``DecodeRunner(...,
    draft=block)``); driven by the scheduler once an iteration with the
    speculative slice of the live set."""

    def __init__(self, target, draft, k=None, warm=True):
        from .decode import DecodeConfig, DecodeRunner

        cfg = target.config
        self.target = target
        self.k = resolve_k(k, cfg.max_live)
        draft_cfg = DecodeConfig(
            page_size=cfg.page_size, pool_pages=cfg.pool_pages,
            max_live=cfg.max_live, max_new_tokens=cfg.max_new_tokens,
            max_context=cfg.max_context + self.k + 1,
            prefill_lengths=cfg.prefill_lengths,
            batch_sizes=cfg.batch_sizes, queue_depth=cfg.queue_depth,
            eos_id=cfg.eos_id, dtype=cfg.dtype,
            prefix_cache=False, spec_k=0)
        self.draft = DecodeRunner(
            draft, ctx=Context.from_device(target.device),
            config=draft_cfg, warm=False)
        self.rounds = 0
        self.verify_steps = 0
        self.proposed = 0
        self.accepted = 0
        self.emitted = 0
        self.fallbacks = {}
        self._warmed = False
        if warm:
            self.warm_up()

    @property
    def warmed(self):
        return self._warmed

    def warm_up(self):
        """Warm the draft's own program table and build ONE target verify
        program per decode batch bucket at this K, so a speculative steady
        state builds nothing.  Returns the build count."""
        fresh = self.draft.warm_up()
        tgt = self.target
        for b in tgt.config.batch_sizes:
            key = ("verify", (b, self.k))
            with tgt._run_lock:
                if key in tgt._programs:
                    continue
                prog = tgt._build(key)
                fresh += 1
                prog.fn(*tgt._null_inputs(b, self.k + 1, floors=True))
        self._warmed = True
        return fresh

    # -- per-sequence lifecycle ---------------------------------------------
    def attach(self, seq):
        """Adopt one admitted sequence onto the draft plane: reserve draft
        pages for its worst case (+K+1 speculative overshoot) and prefill
        the draft cache with its prompt.  Any failure leaves the sequence
        decoding normally (a counted fallback)."""
        req = seq.req
        need = self.draft.page_config.pages_for(
            len(req.prompt) + req.max_new_tokens + self.k + 1)
        if need > self.draft.pool.capacity or \
                not self.draft.pool.can_alloc(need):
            self._fallback(seq, "draft_pool")
            return False
        seq.dpages = self.draft.pool.alloc(seq.sid, need)
        stand = SimpleNamespace(req=req, pages=seq.dpages)
        try:
            _tok, bad = self.draft.prefill(stand)
        except Exception:  # noqa: BLE001 - the draft is never fatal
            self._release_draft(seq)
            self._fallback(seq, "draft_prefill")
            return False
        if bad:
            self._release_draft(seq)
            self._fallback(seq, "draft_nonfinite")
            return False
        seq.spec = True
        seq.dlen = len(req.prompt)
        return True

    def detach(self, seq, reason):
        """Degrade one sequence to non-speculative decode (reclaims its
        draft pages, counts the fallback)."""
        self._release_draft(seq)
        self._fallback(seq, reason)

    def release(self, seq):
        """Scheduler eviction path: reclaim draft pages silently (the
        sequence is leaving, not degrading)."""
        self._release_draft(seq)
        seq.spec = False

    def _release_draft(self, seq):
        if seq.dpages is not None:
            self.draft.pool.release(seq.sid)
            seq.dpages = None

    def _fallback(self, seq, reason):
        seq.spec = False
        self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1
        if telemetry.ENABLED:
            telemetry.SERVE_SPEC_FALLBACKS.labels(reason=reason).inc()

    # -- the round ----------------------------------------------------------
    def round(self, seqs, breakers=None):
        """One speculative round over the attached live slice: K draft
        steps propose, ONE target verify judges, greedy acceptance emits.
        Returns ``(results, fallen)``: ``results`` is ``[(seq,
        emitted_tokens, nonfinite)]`` and ``fallen`` lists sequences the
        caller must step normally this iteration (detached or cooling)."""
        results, fallen = [], []
        active = list(seqs)
        dbucket = self.draft.decode_bucket(len(active))
        if breakers is not None and breakers.blocked(("draft", dbucket)):
            return results, fallen + active
        self.rounds += 1
        # -- propose: K draft decode steps; catch the draft cache up to
        # the committed stream first, and count a step's output as a
        # proposal only once the catch-up queue is empty
        queues, proposals, stands, last_out = {}, {}, {}, {}
        for seq in active:
            committed = seq.req.prompt + seq.tokens
            seq.dlen = min(seq.dlen, len(committed) - 1)
            queues[seq.sid] = committed[seq.dlen:]
            proposals[seq.sid] = []
            stands[seq.sid] = SimpleNamespace(pages=seq.dpages,
                                              last_token=0, length=0)
        for _ in range(self.k):
            batch = []
            for seq in active:
                q = queues[seq.sid]
                tok = q.pop(0) if q else last_out[seq.sid]
                st = stands[seq.sid]
                st.last_token = int(tok)
                st.length = seq.dlen
                batch.append(st)
            try:
                toks, bads = self.draft.decode_step(batch)
            except Exception:  # noqa: BLE001 - the draft is never fatal
                if breakers is not None:
                    breakers.failure(("draft", dbucket))
                for seq in active:
                    self.detach(seq, "draft_error")
                return results, fallen + active
            drop = []
            for i, seq in enumerate(active):
                seq.dlen += 1
                if int(bads[i]):
                    if breakers is not None:
                        breakers.failure(("draft", dbucket))
                    self.detach(seq, "draft_nonfinite")
                    fallen.append(seq)
                    drop.append(seq)
                    continue
                out = int(toks[i])
                last_out[seq.sid] = out
                if not queues[seq.sid]:
                    proposals[seq.sid].append(out)
            for seq in drop:
                active.remove(seq)
            if not active:
                return results, fallen
        # -- spec_verify drill: a poisoned draft degrades that sequence
        # ALONE to non-speculative decode (a breaker strike on the draft
        # bucket; batch-mates verify normally)
        drop = []
        for seq in active:
            try:
                _inject.fire("spec_verify", seq=seq.req.request_id)
            except (InjectedFault, InjectedIOError):
                if breakers is not None:
                    breakers.failure(("draft", dbucket))
                self.detach(seq, "injected")
                fallen.append(seq)
                drop.append(seq)
        for seq in drop:
            active.remove(seq)
        if not active:
            return results, fallen
        # -- verify: chunk = [last committed token, proposals...],
        # truncated so no write passes the page reservation
        chunks = []
        for seq in active:
            remaining = (len(seq.req.prompt) + seq.req.max_new_tokens
                         - seq.length)
            ch = [seq.last_token] + proposals[seq.sid]
            chunks.append([int(t) for t in ch[:max(1, remaining)]])
        vbucket = self.target.decode_bucket(len(active))
        try:
            y, bad = self.target.verify_step(active, chunks, self.k)
        except Exception:  # noqa: BLE001 - step them normally
            if breakers is not None:
                breakers.failure(("spec", vbucket))
            return results, fallen + active
        if breakers is not None:
            breakers.success(("spec", vbucket))
        self.verify_steps += 1
        # -- greedy acceptance: keep proposal j while it equals the
        # target's argmax after position j-1; always emit y[0] (the token
        # single-step decode would have produced)
        prop_n = acc_n = 0
        for i, seq in enumerate(active):
            if int(bad[i]):
                results.append((seq, [], int(bad[i])))
                continue
            ch = chunks[i]
            emitted = [int(y[i][0])]
            for j in range(1, len(ch)):
                if int(ch[j]) != emitted[-1]:
                    break
                emitted.append(int(y[i][j]))
            prop_n += len(ch) - 1
            acc_n += len(emitted) - 1
            self.emitted += len(emitted)
            results.append((seq, emitted, 0))
        self.proposed += prop_n
        self.accepted += acc_n
        if telemetry.ENABLED:
            telemetry.SERVE_SPEC_ROUNDS.inc()
            if prop_n:
                telemetry.SERVE_SPEC_PROPOSED.inc(prop_n)
            if acc_n:
                telemetry.SERVE_SPEC_ACCEPTED.inc(acc_n)
        return results, fallen

    # -- introspection ------------------------------------------------------
    def stats(self):
        vs = max(1, self.verify_steps)
        return {
            "enabled": True,
            "k": self.k,
            "draft_model": type(self.draft.block).__name__,
            "rounds": self.rounds,
            "verify_steps": self.verify_steps,
            "proposed": self.proposed,
            "accepted": self.accepted,
            "acceptance_rate": (float(self.accepted) / self.proposed)
            if self.proposed else 0.0,
            "accepted_per_step": float(self.emitted) / vs,
            "fallbacks": dict(self.fallbacks),
            "draft_pool": self.draft.pool.stats(),
        }
