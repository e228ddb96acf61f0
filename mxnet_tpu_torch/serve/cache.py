"""mx.serve.cache: radix prefix cache over PagePool pages.

Counterpart of ``mxnet_tpu/serve/cache.py``.  Shared system prompts,
multi-turn sessions and agent loops replay the same prompt prefix many
times; this module makes identical prefixes prefill ONCE per replica: a
radix trie keyed by **page-aligned token blocks** (exactly ``page_size``
tokens per edge) whose nodes hold immutable ``PagePool`` pages in the
pool's shared refcounted segment.

Design invariants:

- **Page-granular sharing.**  Only whole pages of prompt are cached, so a
  hit's suffix begins on a page boundary and the hitting sequence's writes
  (suffix prefill and every decode step) land in its own private pages.
  The chunk and verify steps also drop every write below the sequence's
  ``prefix_len`` floor.
- **Copy-on-write fork.**  Two sessions diverging mid-prefix match fewer
  blocks; the divergent tail is prefilled into private pages.  No shared
  page is ever written.
- **Exact accounting.**  Pages enter the trie by *adoption* (moved out of
  the prefilling sequence's ledger into the shared segment with refcount
  ``trie + readers``) and leave by LRU eviction (``shared_unref``).  A
  page returns to the free list only at refcount 0, so an evicted prefix
  never pulls storage from under a live reader, and ``PagePool.check()``
  still audits ``free + owned + shared == capacity``.
- **Admission charges the suffix.**  The scheduler reserves
  ``pages_for(total) - matched_pages``; under pool pressure ``evict()``
  reclaims cold (least recently hit) leaf prefixes.

The cache is single-writer (the decode loop thread); the lock serves
cross-thread readers (``stats()``).  The fleet's load-digest view
(``summary()``) waits in ``ROADMAP.md`` Queue 1 item 9.
"""
from __future__ import annotations

import hashlib
import threading

from .. import telemetry

__all__ = ["PrefixCache", "prefix_digest"]


def prefix_digest(tokens):
    """Stable short digest of a token block — the currency of fleet
    prefix affinity: replicas publish the digests of their trie root
    blocks in the load digest, and the Router hashes an incoming
    prompt's first block with the same function to find a replica
    already holding the prefix."""
    raw = ",".join(str(int(t)) for t in tokens).encode("ascii")
    return hashlib.sha1(raw).hexdigest()[:12]


class _Node:
    __slots__ = ("block", "page", "children", "last_hit")

    def __init__(self, block, page, clock):
        self.block = block          # tuple of page_size token ids
        self.page = int(page)       # shared PagePool page id
        self.children = {}          # block -> _Node
        self.last_hit = clock


class PrefixCache:
    """Radix trie of page-aligned prompt blocks (module doc)."""

    def __init__(self, pool):
        self.pool = pool
        self.page_size = pool.config.page_size
        self._root = {}             # block -> _Node
        self._lock = threading.Lock()
        self._clock = 0             # logical LRU clock (bumped per hit)
        self.hits = 0
        self.partials = 0
        self.misses = 0
        self.hit_tokens_total = 0
        self.evictions = 0
        self.inserted_pages = 0

    # -- internals ----------------------------------------------------------
    def _blocks(self, prompt):
        """The cacheable blocks of ``prompt``: whole pages only, and
        never the page containing the FINAL prompt token — the suffix
        prefill needs at least one token to produce the first output
        logit, and capping at ``len(prompt) - 1`` also keeps every
        write a hitting sequence performs off the shared pages."""
        ps = self.page_size
        n = max(0, (len(prompt) - 1) // ps)
        return [tuple(prompt[i * ps:(i + 1) * ps]) for i in range(n)]

    def _walk(self, blocks):
        """Longest matched node chain for ``blocks``."""
        chain, level = [], self._root
        for b in blocks:
            node = level.get(b)
            if node is None:
                break
            chain.append(node)
            level = node.children
        return chain

    def _count_nodes(self, level=None):
        level = self._root if level is None else level
        n = 0
        for node in level.values():
            n += 1 + self._count_nodes(node.children)
        return n

    # -- lookup / attach ----------------------------------------------------
    def match(self, prompt):
        """Peek: ``(pages, matched_tokens)`` for the longest cached
        prefix of ``prompt``.  Takes no references — admission calls
        this to size the reservation, then ``acquire`` to commit."""
        with self._lock:
            chain = self._walk(self._blocks(prompt))
            return ([n.page for n in chain],
                    len(chain) * self.page_size)

    def classify(self, prompt, matched_tokens):
        """The TTFT label class of one admission: ``hit`` when every
        cacheable block matched, ``partial`` for a shorter match,
        ``miss`` otherwise."""
        cacheable = max(0, (len(prompt) - 1) // self.page_size)
        if matched_tokens and \
                matched_tokens == cacheable * self.page_size:
            return "hit"
        return "partial" if matched_tokens else "miss"

    def acquire(self, prompt):
        """Commit a lookup: reference every matched page for the
        reading sequence and bump the chain's LRU clock.  Returns
        ``(pages, matched_tokens, cls)`` and counts the lookup."""
        with self._lock:
            chain = self._walk(self._blocks(prompt))
            self._clock += 1
            for node in chain:
                node.last_hit = self._clock
            pages = [n.page for n in chain]
            matched = len(chain) * self.page_size
            cls = self.classify(prompt, matched)
            if cls == "hit":
                self.hits += 1
            elif cls == "partial":
                self.partials += 1
            else:
                self.misses += 1
            self.hit_tokens_total += matched
        if pages:
            self.pool.shared_ref(pages)
        if telemetry.ENABLED:
            telemetry.SERVE_PREFIX_LOOKUPS.labels(result=cls).inc()
            if matched:
                telemetry.SERVE_PREFIX_HIT_TOKENS.inc(matched)
            telemetry.SERVE_PREFIX_SHARED_PAGES.set(
                self.pool.shared_pages)
        return pages, matched, cls

    def release(self, pages):
        """A reader (sequence) lets go of its shared prefix pages."""
        freed = self.pool.shared_unref(pages)
        if telemetry.ENABLED:
            telemetry.SERVE_PREFIX_SHARED_PAGES.set(
                self.pool.shared_pages)
        return freed

    # -- population ---------------------------------------------------------
    def insert(self, prompt, owner, table_pages, matched_tokens):
        """Adopt a freshly-prefilled sequence's full prompt pages into
        the trie.  ``table_pages`` is the sequence's combined page
        table (shared prefix first, then private pages) and
        ``matched_tokens`` how much of it was already cached at
        admission; blocks past the match are moved from ``owner``'s
        ledger into the shared segment with refcount 2 (trie + this
        reader).  Returns the number of pages adopted — the caller
        extends its shared-page list by exactly that many table
        slots."""
        blocks = self._blocks(prompt)
        start = matched_tokens // self.page_size
        adopted = 0
        with self._lock:
            level, chain = self._root, []
            for b in blocks[:start]:
                node = level.get(b)
                if node is None:    # matched chain evicted mid-flight
                    return adopted
                chain.append(node)
                level = node.children
            self._clock += 1
            for j in range(start, len(blocks)):
                b = blocks[j]
                if b in level:      # raced population: keep the first
                    break
                page = table_pages[j]
                self.pool.adopt_shared(owner, [page], readers=1)
                node = _Node(b, page, self._clock)
                level[b] = node
                level = node.children
                adopted += 1
                self.inserted_pages += 1
        if telemetry.ENABLED and adopted:
            telemetry.SERVE_PREFIX_SHARED_PAGES.set(
                self.pool.shared_pages)
        return adopted

    # -- eviction -----------------------------------------------------------
    def _leaves(self, level, parent):
        out = []
        for b, node in level.items():
            if node.children:
                out.extend(self._leaves(node.children, node.children))
            else:
                out.append((node, level, b))
        return out

    def evict(self, goal_pages):
        """LRU-by-last-hit eviction: drop cold leaf prefixes until
        ``goal_pages`` pages have actually returned to the free list
        (or nothing cold remains).  Only leaves whose page has no live
        reader (refcount 1 — the trie's own reference) are candidates,
        so eviction always frees real capacity and never strands a
        reader."""
        freed = 0
        while freed < goal_pages:
            with self._lock:
                refs = self.pool.shared_refs()
                leaves = [(node, level, b) for node, level, b
                          in self._leaves(self._root, self._root)
                          if refs.get(node.page) == 1]
                if not leaves:
                    break
                node, level, b = min(leaves,
                                     key=lambda t: t[0].last_hit)
                del level[b]
                self.evictions += 1
            freed += self.pool.shared_unref([node.page])
            if telemetry.ENABLED:
                telemetry.SERVE_PREFIX_EVICTIONS.inc()
        if telemetry.ENABLED:
            telemetry.SERVE_PREFIX_SHARED_PAGES.set(
                self.pool.shared_pages)
        return freed

    def _drop_subtree(self, node):
        for child in list(node.children.values()):
            self._drop_subtree(child)
        node.children.clear()
        self.pool.shared_unref([node.page])
        self.evictions += 1
        if telemetry.ENABLED:
            telemetry.SERVE_PREFIX_EVICTIONS.inc()

    def invalidate(self, prompt):
        """Drop the whole cached chain matching ``prompt`` (and every
        descendant) — the ``serve_cache`` corrupt-drill path: a prefix
        declared poisoned is re-prefilled from scratch by everyone.
        Live readers keep their references; storage follows the
        refcounts home.  Returns the number of nodes dropped."""
        with self._lock:
            blocks = self._blocks(prompt)
            if not blocks:
                return 0
            chain = self._walk(blocks)
            if not chain:
                return 0
            top = chain[0]
            before = self.evictions
            self._drop_subtree(top)
            del self._root[top.block]
            dropped = self.evictions - before
        if telemetry.ENABLED:
            telemetry.SERVE_PREFIX_SHARED_PAGES.set(
                self.pool.shared_pages)
        return dropped

    def clear(self):
        """Drop every node (pool storage lost or scheduler teardown)."""
        with self._lock:
            for node in list(self._root.values()):
                self._drop_subtree(node)
            self._root.clear()
        if telemetry.ENABLED:
            telemetry.SERVE_PREFIX_SHARED_PAGES.set(
                self.pool.shared_pages)

    # -- introspection ------------------------------------------------------
    def check(self):
        """Trie-side invariant audit: every trie page is in the pool's
        shared segment with refcount >= 1, no page appears twice, and
        the pool's own invariants hold."""
        from .batching import ServeError

        with self._lock:
            refs = self.pool.shared_refs()
            pages, stack = [], list(self._root.values())
            while stack:
                node = stack.pop()
                pages.append(node.page)
                stack.extend(node.children.values())
            if len(set(pages)) != len(pages):
                raise ServeError("prefix trie holds a duplicate page")
            for p in pages:
                if refs.get(p, 0) < 1:
                    raise ServeError(
                        "prefix trie page %d missing from the shared "
                        "segment" % p)
        return self.pool.check()

    def stats(self):
        with self._lock:
            nodes = self._count_nodes()
            return {
                "enabled": True,
                "block_tokens": self.page_size,
                "nodes": nodes,
                "shared_pages": self.pool.shared_pages,
                "hits": self.hits,
                "partials": self.partials,
                "misses": self.misses,
                "hit_tokens_total": self.hit_tokens_total,
                "inserted_pages": self.inserted_pages,
                "evictions": self.evictions,
            }
