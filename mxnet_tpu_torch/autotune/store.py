"""TuningStore: the durable record store behind mx.autotune.

Counterpart of ``mxnet_tpu/autotune/store.py``.  One record per
(environment fingerprint, site, key): the measured winner config of one
site at one workload key, written with the checkpoint layer's
durability (write to a temp dir, fsync, a COMMITTED marker written last,
an atomic rename; a CRC manifest; a corrupt or torn record is
quarantined to ``*.corrupt``; concurrent commits race benignly, the last
rename wins).

Record layout (``<root>/<envfp[:16]>/<site>/<keyhash>/``)::

    RECORD.json    # the winner: config, timings, candidate audit trail
    COMMITTED      # two-phase marker, written last: {crc32, nbytes}

The JAX store keys on its compile cache's environment fingerprint.  The
port has no compile cache, so its fingerprint is its own: the torch and
CUDA versions, the card's name and compute capability, and a hash of the
kernel sources ``ops/_ext.py`` builds (``csrc/``).  Any drift, a rebuilt
kernel library included, is a clean miss back to the hand-set defaults:
a winner measured for one build on one card is never served to another.

Every method is exception-safe: a store I/O failure is a miss (or a
no-op), never an error on a lookup path.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
import zlib

from .. import telemetry
from ..base import get_env
from ..checkpoint import layout as _layout

__all__ = ["TuningStore", "default_store_dir", "key_hash", "env_fingerprint",
           "FORMAT"]

FORMAT = "mx-autotune-store-v1"
RECORD = "RECORD.json"
COMMITTED = "COMMITTED"

_LOGGER = logging.getLogger("mxnet_tpu_torch.autotune")

# hex chars of the env fingerprint used as the store partition dir
_ENV_PREFIX = 16


def default_store_dir():
    """MXNET_AUTOTUNE_DIR, else ``<MXNET_HOME>/autotune`` (MXNET_HOME
    defaults to ``~/.mxnet``)."""
    d = get_env("MXNET_AUTOTUNE_DIR", str, None)
    if not d:
        home = get_env("MXNET_HOME", str, "~/.mxnet")
        d = os.path.join(home, "autotune")
    return os.path.expanduser(d)


def key_hash(key):
    """Stable hex identity of a site key (any JSON-able structure); the
    JAX package's, so one key names one record in both."""
    blob = json.dumps(key, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def env_fingerprint():
    """sha256 over what a tuned winner depends on: the torch and CUDA
    versions, the card's name and compute capability ("cpu" without a
    card), and the bytes of the kernel sources under ``csrc/``."""
    import torch

    from ..ops import _ext

    if torch.cuda.is_available():
        device = [torch.cuda.get_device_name(0),
                  list(torch.cuda.get_device_capability(0))]
    else:
        device = ["cpu"]
    kernels = hashlib.sha256()
    for path in list(_ext.SOURCES) + list(_ext.HEADERS):
        kernels.update(path.name.encode())
        kernels.update(path.read_bytes())
    parts = {"format": FORMAT, "torch": torch.__version__,
             "cuda": torch.version.cuda, "device": device,
             "kernels": kernels.hexdigest()}
    return hashlib.sha256(json.dumps(parts, sort_keys=True).encode()
                          ).hexdigest()


class TuningStore:
    """Persistent winner store (see module docstring)."""

    def __init__(self, root=None, env_fingerprint=None):
        self._root = os.path.abspath(root or default_store_dir())
        self._env_fp = env_fingerprint  # lazy: asks the card

    # -- identity -----------------------------------------------------------
    @property
    def root(self):
        return self._root

    def env_fingerprint(self):
        """The environment's fingerprint (``env_fingerprint()``), computed
        at first use because it asks the card."""
        if self._env_fp is None:
            self._env_fp = env_fingerprint()
        return self._env_fp

    def _env_dir(self):
        return os.path.join(self._root, self.env_fingerprint()[:_ENV_PREFIX])

    def _record_dir(self, site, kh):
        return os.path.join(self._env_dir(), site, kh)

    # -- read ---------------------------------------------------------------
    def get(self, site, key):
        """The committed record for (env, site, key), else None."""
        rec, _status = self.get_status(site, key)
        return rec

    def get_status(self, site, key):
        """``(record, status)`` with status in ``hit`` / ``miss`` /
        ``corrupt`` (record quarantined) / ``error`` (store I/O failed;
        may succeed next time).  Never raises."""
        try:
            d = self._record_dir(site, key_hash(key))
        except Exception:
            # fingerprinting itself failed: a lookup must still degrade
            # to the default
            return None, "error"
        try:
            marker = os.path.join(d, COMMITTED)
            if not os.path.isfile(marker):
                if os.path.isdir(d):
                    # marker-less dir = torn remains of an interrupted
                    # commit: park it so a future commit can land
                    self._quarantine(d, reason="torn record (no marker)")
                    return None, "corrupt"
                return None, "miss"
            with open(marker) as f:
                manifest = json.load(f)
            with open(os.path.join(d, RECORD), "rb") as f:
                raw = f.read()
            if len(raw) != manifest.get("nbytes") or \
                    (zlib.crc32(raw) & 0xFFFFFFFF) != manifest.get("crc32"):
                self._quarantine(d, reason="checksum mismatch")
                return None, "corrupt"
            rec = json.loads(raw.decode())
        except (ValueError, KeyError):
            self._quarantine(d, reason="record undecodable")
            return None, "corrupt"
        except FileNotFoundError:
            # marker present but RECORD gone: genuinely torn
            self._quarantine(d, reason="record incomplete")
            return None, "corrupt"
        except OSError:
            # transient I/O (EACCES, EIO, fd exhaustion): a plain miss,
            # never a quarantine of a possibly-healthy record
            return None, "error"
        if not isinstance(rec, dict):
            self._quarantine(d, reason="record not a mapping")
            return None, "corrupt"
        return rec, "hit"

    # -- write --------------------------------------------------------------
    def put(self, site, key, record):
        """Durably publish one record; concurrent writers race benignly,
        the last rename owning the slot, and readers only ever see a
        complete committed dir.  Returns the record dir, or None on
        any I/O failure (counted; tuning degrades to in-memory)."""
        import tempfile

        try:
            kh = key_hash(key)
            final = self._record_dir(site, kh)
            parent = os.path.dirname(final)
            os.makedirs(parent, exist_ok=True)
            tmp = tempfile.mkdtemp(dir=parent, prefix=".committing-")
        except Exception:
            return None
        try:
            rec = dict(record)
            rec.setdefault("format", FORMAT)
            rec.setdefault("site", site)
            rec.setdefault("key", key)
            rec.setdefault("created", time.time())
            raw = json.dumps(rec, sort_keys=True, default=str).encode()
            crc, n = _layout.write_file_durable(
                os.path.join(tmp, RECORD), raw)
            _layout.write_file_durable(
                os.path.join(tmp, COMMITTED),
                json.dumps({"format": FORMAT, "crc32": crc,
                            "nbytes": n}).encode())
            _layout.fsync_dir(tmp)
            # slot occupied (racing writer or a stale record): last
            # wins — park the incumbent, take the slot, drop the
            # parked dir.  Concurrent parkers race benignly (a failed
            # park means someone else moved the incumbent; just retry
            # the publish); readers never see a torn state because
            # every dir involved is complete at every instant.
            published = False
            for attempt in range(16):
                try:
                    os.rename(tmp, final)
                    published = True
                    break
                except OSError:
                    park = "%s.prev-%d-%d-%d" % (
                        final, os.getpid(), threading.get_ident(),
                        attempt)
                    try:
                        os.rename(final, park)
                    except OSError:
                        continue  # another parker got there first
                    shutil.rmtree(park, ignore_errors=True)
            if not published:
                shutil.rmtree(tmp, ignore_errors=True)
                return None
            _layout.fsync_dir(parent)
        except (OSError, TypeError, ValueError):
            shutil.rmtree(tmp, ignore_errors=True)
            return None
        if telemetry.ENABLED:
            telemetry.AUTOTUNE_STORE_COMMITS.inc()
        return final

    # -- quarantine ---------------------------------------------------------
    def _quarantine(self, d, reason=""):
        q = d + ".corrupt"
        n = 0
        while os.path.exists(q):
            n += 1
            q = "%s.corrupt.%d" % (d, n)
        try:
            os.rename(d, q)
        except OSError:
            return None
        _LOGGER.warning("autotune record %s quarantined (%s)",
                        os.path.basename(d), reason or "corrupt")
        if telemetry.ENABLED:
            telemetry.AUTOTUNE_STORE_QUARANTINE.inc()
        return q

    # -- enumeration --------------------------------------------------------
    def records(self):
        """[(site, keyhash, record)] committed under this environment's
        fingerprint (other environments' partitions are invisible)."""
        out = []
        try:
            env_dir = self._env_dir()
            sites = os.listdir(env_dir)
        except Exception:
            return out
        for site in sorted(sites):
            sd = os.path.join(env_dir, site)
            if not os.path.isdir(sd):
                continue
            try:
                names = os.listdir(sd)
            except OSError:
                continue
            for kh in sorted(names):
                d = os.path.join(sd, kh)
                if ".corrupt" in kh or ".prev-" in kh or \
                        kh.startswith(".committing-") or \
                        not os.path.isdir(d):
                    continue
                try:
                    if not os.path.isfile(os.path.join(d, COMMITTED)):
                        continue
                    with open(os.path.join(d, RECORD)) as f:
                        rec = json.load(f)
                except (OSError, ValueError):
                    continue
                out.append((site, kh, rec))
        return out

    def quarantined(self):
        """Paths of quarantined (``*.corrupt``) record dirs across ALL
        environment partitions (a corrupt record from an old env still
        deserves an audit line)."""
        out = []
        try:
            envs = os.listdir(self._root)
        except OSError:
            return out
        for env in envs:
            ed = os.path.join(self._root, env)
            if not os.path.isdir(ed):
                continue
            for dirpath, dirnames, _files in os.walk(ed):
                for name in list(dirnames):
                    if ".corrupt" in name:
                        out.append(os.path.join(dirpath, name))
                        dirnames.remove(name)
        return sorted(out)

    def stats(self):
        recs = self.records()
        return {"dir": self._root,
                "env_fingerprint": self._safe_env_fp(),
                "records": len(recs),
                "sites": sorted({s for s, _k, _r in recs}),
                "quarantined": self.quarantined()}

    def _safe_env_fp(self):
        try:
            return self.env_fingerprint()[:_ENV_PREFIX]
        except Exception:
            return None

    def clear(self):
        """Remove every record (all environments + quarantined remains)."""
        try:
            for name in os.listdir(self._root):
                shutil.rmtree(os.path.join(self._root, name),
                              ignore_errors=True)
        except OSError:
            pass
