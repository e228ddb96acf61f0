"""mx.autotune: tuned kernel tiles, buckets and flags.

Counterpart of ``mxnet_tpu/autotune/``.  A hand-set knob of the port (the
flash forward kernel's tile, ``blockwise_attention``'s block_k, the conv
memory format, BatchNorm's statistics dtype, the serving and decode
bucket tables, the draft count, the loader's prefetch) is a **site**
(``space.py``) with a measured search (``measure.py``), a table cost
model that may prune the grid (``model.py``) and a durable store of
winners keyed by the environment's fingerprint (``store.py``), so a later
process, trainer or server, gets the tuned configs at build time.

Off by default:

- ``MXNET_AUTOTUNE=0`` (default): every consumer takes the port's
  hand-set choice; a lookup costs one cached string compare and touches
  no store.
- ``MXNET_AUTOTUNE=1``: lookups read the store (``MXNET_AUTOTUNE_DIR``);
  a miss, or any store failure (counted in ``autotune_fallback_total``),
  is the default.  Nothing measures on a hot path.
- ``MXNET_AUTOTUNE=search``: also the idle tuners run (serving and
  decode warm-up), and ``tune()`` calls are expected to search and
  commit winners.

The numerics contract: a winner's outputs are bit-identical to the
default config's (the harness rejects a candidate that differs), so
turning autotune on can change speed, never results.
"""
from __future__ import annotations

import threading

from .. import telemetry as _tel
from ..base import get_env
from . import measure, model, space, store
from .measure import tune
from .space import get_site, sites
from .store import TuningStore, default_store_dir, key_hash

__all__ = ["mode", "is_enabled", "search_enabled", "enable", "disable",
           "lookup", "lookup_info", "tune", "get_store", "fallback",
           "invalidate_cache", "winners", "sites", "get_site",
           "TuningStore", "default_store_dir", "key_hash",
           "space", "measure", "model", "store"]

_LOCK = threading.Lock()
_MODE = None          # resolved lazily from MXNET_AUTOTUNE
_STORE = None
_STORE_FAILED = False
_CACHE = {}           # (site, keyhash) -> (provenance, value)


def _resolve_mode():
    global _MODE
    if _MODE is None:
        raw = str(get_env("MXNET_AUTOTUNE", str, "0") or "0").lower()
        if raw in ("search",):
            _MODE = "search"
        elif raw in ("1", "on", "true", "yes"):
            _MODE = "on"
        else:
            _MODE = "off"
    return _MODE


def mode():
    """Effective mode: ``off`` / ``on`` / ``search``."""
    return _resolve_mode()


def is_enabled():
    return _resolve_mode() != "off"


def search_enabled():
    return _resolve_mode() == "search"


def enable(new_mode="on", root=None):
    """Programmatically switch autotune on (``on`` or ``search``),
    optionally pointing the store at ``root``.  The env-var spelling
    (``MXNET_AUTOTUNE`` / ``MXNET_AUTOTUNE_DIR``) is equivalent."""
    global _MODE, _STORE, _STORE_FAILED
    if new_mode not in ("on", "search", "off"):
        from ..base import MXNetError

        raise MXNetError("autotune mode must be 'on', 'search' or "
                         "'off', got %r" % (new_mode,))
    with _LOCK:
        _MODE = new_mode
        _STORE_FAILED = False
        if root is not None:
            _STORE = TuningStore(root=root)
        else:
            _STORE = None  # re-resolve from env on next use
        _CACHE.clear()


def disable():
    enable("off")


def _resolve_store():
    """The process TuningStore singleton, or None when unavailable
    (counted once; lookups then serve defaults for process lifetime
    until ``enable()`` resets)."""
    global _STORE, _STORE_FAILED
    if _STORE is not None:
        return _STORE
    if _STORE_FAILED:
        return None
    with _LOCK:
        if _STORE is not None or _STORE_FAILED:
            return _STORE
        try:
            _STORE = TuningStore()
        except Exception:
            _STORE_FAILED = True
            fallback("store_unavailable")
            return None
    return _STORE


def get_store():
    """Public accessor for the active store (None when unavailable)."""
    return _resolve_store()


def fallback(reason):
    """Count one degrade-to-default event."""
    if _tel.ENABLED:
        _tel.AUTOTUNE_FALLBACK.labels(reason=reason).inc()


def invalidate_cache(site=None, key=None):
    """Drop memoized lookups (all, per site, or one (site, key)) so a
    freshly committed winner is visible in THIS process too."""
    with _LOCK:
        if site is None:
            _CACHE.clear()
            return
        if key is not None:
            _CACHE.pop((site, key_hash(list(key))), None)
            return
        for k in [k for k in _CACHE if k[0] == site]:
            _CACHE.pop(k, None)


def _count_lookup(site, result):
    if _tel.ENABLED:
        _tel.AUTOTUNE_LOOKUPS.labels(site=site, result=result).inc()


def lookup_info(site, key, default=None):
    """``(value, provenance)`` with provenance ``tuned`` or
    ``default``.  Never raises, never measures: off-mode returns the
    default immediately; on/search-mode consults the in-memory memo
    then the store, and EVERY failure (store unavailable, record
    corrupt, config invalid for the site) degrades to the default with
    a counted ``autotune_fallback_total{reason}``."""
    if _resolve_mode() == "off":
        return default, "default"
    key = list(key) if isinstance(key, (tuple, list)) else [key]
    ck = (site, key_hash(key))
    hit = _CACHE.get(ck)
    if hit is not None:
        prov, value = hit
        _count_lookup(site, prov)
        return (value if prov == "tuned" else default), prov
    st = _resolve_store()
    if st is None:
        _count_lookup(site, "default")
        with _LOCK:
            _CACHE[ck] = ("default", None)
        return default, "default"
    try:
        rec, status = st.get_status(site, key)
    except Exception:
        rec, status = None, "error"
    prov, value = "default", None
    if status in ("corrupt", "error"):
        fallback("store_" + status)
    elif rec is not None:
        cfg = rec.get("config")
        try:
            valid = cfg is not None and \
                space.get_site(site).validate(tuple(key), cfg)
        except Exception:
            valid = cfg is not None
        if valid:
            prov, value = "tuned", cfg
        else:
            fallback("invalid_config")
    with _LOCK:
        _CACHE[ck] = (prov, value)
    _count_lookup(site, prov)
    return (value if prov == "tuned" else default), prov


def lookup(site, key, default=None):
    """The build-time consumer hook: the tuned config for (site, key)
    or ``default`` — see ``lookup_info``."""
    return lookup_info(site, key, default)[0]


def winners():
    """Per-site winner table: one row per stored record of this
    environment, plus one per quarantined record dir."""
    rows = []
    st = _resolve_store()
    if st is None:
        return rows
    for site_name, kh, rec in st.records():
        rows.append({
            "site": site_name,
            "key": rec.get("key"),
            "keyhash": kh,
            "provenance": "tuned",
            "config": rec.get("config"),
            "ms": rec.get("ms"),
            "default_config": rec.get("default_config"),
            "default_ms": rec.get("default_ms"),
            "candidates": len(rec.get("candidates", []) or []),
        })
    for q in st.quarantined():
        rows.append({"site": q.split("/")[-2] if "/" in q else "?",
                     "key": None, "keyhash": q,
                     "provenance": "quarantined", "config": None,
                     "ms": None, "default_config": None,
                     "default_ms": None, "candidates": 0})
    return rows
