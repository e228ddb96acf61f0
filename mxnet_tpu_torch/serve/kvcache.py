"""Paged KV-cache storage for mx.serve.decode.

Counterpart of ``mxnet_tpu/serve/kvcache.py``.  The cache is a pool of
fixed-size **pages** (``page_size`` token slots each), and each sequence
owns a *page table*: an ordered list of physical page ids its logical
positions map onto (vLLM's PagedAttention).  Admission reserves a
sequence's whole worst case (``ceil((prompt + max_new_tokens) /
page_size)`` pages) up front, so a running sequence never hits an
allocation failure mid-decode: out of memory is a fast reject at the
admission door.

``PagePool`` owns:

- the device-resident cache tensors, one K and one V shaped ``[layers,
  num_pages, page_size, kv_heads, head_dim]`` (``k`` / ``v``), which the
  decode step updates in place (the counterpart of the JAX program's
  buffer donation).  Each lives in a storage of ``num_pages + 1`` pages
  (``k_store`` / ``v_store``): the extra page is the *drop page*, which no
  owner ever holds.  ``null_page`` (``num_pages``) names it, so a write
  addressed to a padded table slot, a padded prompt position or a padded
  batch row lands there and is never read, as the JAX scatter's
  ``mode="drop"`` writes nowhere;
- exact occupancy accounting: ``alloc`` / ``release`` / ``reset`` with a
  free list, a per-owner page ledger, in-use and high-water counters,
  and hard invariants (double-free and unknown-owner release raise);
- the **shared segment** behind the radix prefix cache (``serve/cache.py``):
  ``adopt_shared`` moves immutable prefix pages out of one owner's ledger
  into a refcounted shared pool (``shared_ref`` / ``shared_unref``); a
  shared page returns to the free list only when its last reference
  drops, and ``check()`` audits ``free + owned + shared == capacity``.

``gather_pages`` and ``scatter_pages`` are the page-table address
arithmetic of the step, so the step and the pool agree on the layout by
construction.  ``PagePool(mesh=...)`` (a head-sharded pool) waits for the
mesh work of ``ROADMAP.md`` Queue 1 item 7.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

from ..base import MXNetError
from ..context import device_of
from .batching import ServeError

__all__ = ["PageConfig", "PagePool", "PagePoolExhausted",
           "gather_pages", "scatter_pages"]


class PagePoolExhausted(ServeError):
    """Not enough free pages for the requested reservation.  Raised at
    ADMISSION time (fast reject), never mid-decode, because admission
    reserves a sequence's whole worst case up front."""


class PageConfig:
    """Geometry of one paged KV pool: ``page_size`` token slots per page x
    ``num_pages`` pages, and the per-token cache shape of the model it
    serves (``num_layers`` x ``num_kv_heads`` x ``head_dim``, ``dtype``).
    ``max_context`` bounds any single sequence (prompt + generated); it
    must fit the pool."""

    def __init__(self, page_size, num_pages, num_layers, num_kv_heads,
                 head_dim, max_context, dtype="float32"):
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.num_layers = int(num_layers)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.max_context = int(max_context)
        self.dtype = dtype
        if self.page_size < 1 or self.num_pages < 1:
            raise ValueError("page_size and num_pages must be >= 1, got "
                             "%d / %d" % (self.page_size, self.num_pages))
        if self.max_context < 1:
            raise ValueError("max_context must be >= 1")
        if self.pages_per_seq > self.num_pages:
            raise ValueError(
                "max_context=%d needs %d pages/sequence but the pool "
                "only has %d pages total" % (
                    self.max_context, self.pages_per_seq, self.num_pages))

    @property
    def pages_per_seq(self):
        """Page-table width: the worst-case pages one sequence can own."""
        return -(-self.max_context // self.page_size)

    def pages_for(self, total_tokens):
        """Pages a sequence of ``total_tokens`` (prompt + max new) must
        reserve at admission."""
        return max(1, -(-int(total_tokens) // self.page_size))

    @property
    def page_bytes(self):
        return (self.num_layers * self.page_size * self.num_kv_heads *
                self.head_dim * _np.dtype(self.dtype).itemsize * 2)

    def as_dict(self):
        return {"page_size": self.page_size, "num_pages": self.num_pages,
                "num_layers": self.num_layers,
                "num_kv_heads": self.num_kv_heads,
                "head_dim": self.head_dim,
                "max_context": self.max_context,
                "pages_per_seq": self.pages_per_seq,
                "dtype": str(self.dtype),
                "pool_bytes": self.num_pages * self.page_bytes}


class PagePool:
    """Blocked KV-cache storage + exact page accounting (module doc).

    The tensors live on ``device`` (default the card); accounting is
    host-side and lock-protected (admission runs on submitter threads,
    release on the decode loop)."""

    def __init__(self, config, mesh=None, device=None):
        if mesh is not None:
            raise MXNetError(
                "PagePool(mesh=...) (a KV pool sharded over a mesh) is not "
                "ported yet: ROADMAP.md Queue 1 item 7")
        self.config = c = config
        self.device = device if isinstance(device, torch.device) \
            else device_of(device)
        shape = (c.num_layers, c.num_pages + 1, c.page_size,
                 c.num_kv_heads, c.head_dim)
        dtype = getattr(torch, str(c.dtype))
        self.k_store = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_store = torch.zeros(shape, dtype=dtype, device=self.device)
        self.k = self.k_store[:, :c.num_pages]
        self.v = self.v_store[:, :c.num_pages]
        self._lock = threading.Lock()
        self._free = list(range(c.num_pages - 1, -1, -1))  # pop() -> 0,1,2..
        self._owned = {}                 # owner -> [page ids]
        self._shared = {}                # page id -> refcount (>= 1)
        self.high_water = 0
        self.alloc_total = 0
        self.oom_rejects = 0

    # -- accounting ---------------------------------------------------------
    @property
    def capacity(self):
        return self.config.num_pages

    @property
    def available(self):
        with self._lock:
            return len(self._free)

    @property
    def in_use(self):
        with self._lock:
            return self.config.num_pages - len(self._free)

    @property
    def null_page(self):
        """The page id padded table slots carry: the drop page."""
        return self.config.num_pages

    def can_alloc(self, n):
        with self._lock:
            return n <= len(self._free)

    def alloc(self, owner, n):
        """Reserve ``n`` pages for ``owner`` (all-or-nothing).  Raises
        ``PagePoolExhausted`` without touching anything when fewer than
        ``n`` pages are free."""
        n = int(n)
        if n < 1:
            raise ValueError("alloc needs n >= 1, got %d" % n)
        with self._lock:
            if owner in self._owned:
                raise ServeError("owner %r already holds pages" % (owner,))
            if n > len(self._free):
                self.oom_rejects += 1
                raise PagePoolExhausted(
                    "KV page pool exhausted: %d page(s) requested, %d free "
                    "of %d (page_size=%d); admission must wait for "
                    "evictions" % (n, len(self._free),
                                   self.config.num_pages,
                                   self.config.page_size))
            pages = [self._free.pop() for _ in range(n)]
            self._owned[owner] = pages
            self.alloc_total += n
            used = self.config.num_pages - len(self._free)
            if used > self.high_water:
                self.high_water = used
            return list(pages)

    def release(self, owner):
        """Return every page ``owner`` holds.  Unknown owners raise: a
        silent no-op would hide double-free and leak bugs."""
        with self._lock:
            pages = self._owned.pop(owner, None)
            if pages is None:
                raise ServeError("release of unknown page owner %r"
                                 % (owner,))
            for p in pages:
                self._free.append(p)
            return len(pages)

    def owners(self):
        with self._lock:
            return {o: list(p) for o, p in self._owned.items()}

    # -- shared segment (serve/cache.py radix prefix cache) -----------------
    def adopt_shared(self, owner, pages, readers=1):
        """Move ``pages`` (a subset of ``owner``'s ledger) into the shared
        segment as immutable prefix storage, each at refcount ``1 +
        readers`` (the adopting cache plus the live readers that already
        hold it).  A ledger move, never an allocation."""
        pages = [int(p) for p in pages]
        with self._lock:
            owned = self._owned.get(owner)
            if owned is None:
                raise ServeError(
                    "adopt_shared from unknown page owner %r" % (owner,))
            for p in pages:
                if p not in owned:
                    raise ServeError(
                        "adopt_shared: page %d is not owned by %r"
                        % (p, owner))
                if p in self._shared:
                    raise ServeError(
                        "adopt_shared: page %d is already shared" % p)
            for p in pages:
                owned.remove(p)
                self._shared[p] = 1 + int(readers)

    def shared_ref(self, pages):
        """Take one reference per page (a cache hit attaching a reader).
        A page outside the shared segment raises."""
        pages = [int(p) for p in pages]
        with self._lock:
            for p in pages:
                if p not in self._shared:
                    raise ServeError(
                        "shared_ref of non-shared page %d" % p)
            for p in pages:
                self._shared[p] += 1

    def shared_unref(self, pages):
        """Drop one reference per page; pages reaching refcount 0 return to
        the free list.  Over-release raises.  Returns the pages freed."""
        freed = 0
        with self._lock:
            for p in [int(p) for p in pages]:
                n = self._shared.get(p)
                if not n:
                    raise ServeError(
                        "shared double-free of page %d" % p)
                n -= 1
                if n == 0:
                    del self._shared[p]
                    self._free.append(p)
                    freed += 1
                else:
                    self._shared[p] = n
        return freed

    @property
    def shared_pages(self):
        with self._lock:
            return len(self._shared)

    def shared_refs(self):
        with self._lock:
            return dict(self._shared)

    def reset(self):
        """Free everything (scheduler teardown); storage is reused."""
        with self._lock:
            self._owned.clear()
            self._shared.clear()
            self._free = list(range(self.config.num_pages - 1, -1, -1))

    def check(self):
        """Invariant audit: free + owned + shared == capacity, no
        duplicates, every shared refcount >= 1.  Raises ``ServeError`` on
        violation; returns True."""
        with self._lock:
            owned = [p for pages in self._owned.values() for p in pages]
            shared = list(self._shared)
            seen = self._free + owned + shared
            if len(seen) != self.config.num_pages or \
                    len(set(seen)) != len(seen):
                raise ServeError(
                    "page accounting corrupt: %d free + %d owned + %d "
                    "shared != %d capacity (or duplicate ids)" % (
                        len(self._free), len(owned), len(shared),
                        self.config.num_pages))
            if any(n < 1 for n in self._shared.values()):
                raise ServeError("shared page with refcount < 1")
        return True

    def stats(self):
        with self._lock:
            free = len(self._free)
            owners = len(self._owned)
            shared = len(self._shared)
        cap = self.config.num_pages
        return {
            "kv_sharding": None,
            "kv_device_bytes": None,
            "capacity_pages": cap,
            "in_use_pages": cap - free,
            "free_pages": free,
            "shared_pages": shared,
            "high_water_pages": self.high_water,
            "occupancy": round((cap - free) / cap, 4),
            "owners": owners,
            "alloc_total": self.alloc_total,
            "oom_rejects": self.oom_rejects,
            "config": self.config.as_dict(),
        }


# ---------------------------------------------------------------------------
# page address arithmetic (run by the decode step on the device)
# ---------------------------------------------------------------------------

def gather_pages(pool, tables):
    """Materialize each sequence's paged cache as a contiguous context.

    ``pool`` is ``[L, N, page, H, D]``; ``tables`` is ``[B, P]`` integer
    physical page ids.  Returns a new ``[B, L, P * page, H, D]`` tensor.
    Table entries are clamped into ``[0, N - 1]``, as the JAX gather
    clamps: slots past a sequence's allocation read pages that the
    attention length mask (and the step's scrub) discards."""
    lyr, n = pool.shape[0], pool.shape[1]
    b, p = tables.shape
    idx = tables.long().clamp(0, n - 1)
    layers = torch.arange(lyr, device=pool.device)
    g = pool[layers[None, :, None], idx[:, None, :]]    # [B, L, P, page..]
    return g.reshape(b, lyr, p * pool.shape[2], pool.shape[3],
                     pool.shape[4])


def scatter_pages(pool, tables, positions, valid, new):
    """Write one chunk's fresh K or V rows into their pages, in place.

    ``pool`` is a pool's storage ``[L, N + 1, page, H, D]`` whose last
    page is the drop page; ``new`` is ``[B, T, L, H, D]`` (the model's
    per-position cache rows), ``positions`` ``[B, T]`` absolute token
    positions and ``valid`` ``[B, T]`` bool.  Invalid positions (prompt
    padding, padded batch rows) are sent to the drop page, so the pages
    are only ever written at addresses the owning sequence reserved, as
    the JAX scatter drops them.  Returns ``pool``."""
    page_size = pool.shape[2]
    drop = pool.shape[1] - 1
    logical = torch.clamp(positions.long() // page_size, 0,
                          tables.shape[1] - 1)
    phys = torch.gather(tables.long(), 1, logical)            # [B, T]
    # invalid rows, and table entries past the pool (the null page), go
    # to the drop page
    phys = torch.where(valid, phys.clamp(max=drop),
                       torch.full_like(phys, drop))
    slot = positions.long() % page_size                       # [B, T]
    pool[:, phys, slot] = new.permute(2, 0, 1, 3, 4).to(pool.dtype)
    return pool
