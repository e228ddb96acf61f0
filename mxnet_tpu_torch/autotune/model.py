"""Table cost model: predict a candidate's cost from stored measurements.

Counterpart of ``mxnet_tpu/autotune/model.py``: the search harness
measures, the model generalises.  A table model over the
``TuningStore``'s own audit trails (every committed record carries each
candidate's measured milliseconds), so it needs no training artifact and
is as fresh as the store:

- **features**: the site's numeric key descriptors in log space
  (``TuningSite.features``);
- **predict(site, key, config)**: the nearest stored key of the same site
  (L2 in log-feature space) that measured this config, its ms scaled by
  the workload-size ratio; None when cold;
- **prune(site, key, candidates, keep)**: the ``keep`` candidates
  predicted cheapest; any unpredictable candidate makes it refuse to
  prune (a cold model means measuring everything).

The model only orders measurement: a candidate it keeps must still pass
the measure harness's bitwise guard to win.  A record's ``clock``
(``cuda_events`` or ``host``; a record without one is ``host``) keeps
the two clocks apart: the model reads the rows of one clock, the
``clock`` it is built with (default ``host``).
"""
from __future__ import annotations

import json
import math

__all__ = ["CostModel"]


def _log_features(feats):
    return [math.log(max(1e-9, float(v))) for v in feats]


def _cfg_key(config):
    return json.dumps(config, sort_keys=True, default=str)


class CostModel:
    """Nearest-neighbor table model over a ``TuningStore``'s records."""

    def __init__(self, store, clock=None):
        self._store = store
        self.clock = clock or "host"
        self._table = None  # site -> [(log_feats, {cfg_key: ms})]

    def _load(self):
        if self._table is not None:
            return self._table
        from . import space as _space

        table = {}
        for site_name, _kh, rec in self._store.records():
            try:
                sp = _space.get_site(site_name)
            except Exception:
                continue
            key = rec.get("key")
            if not isinstance(key, (list, tuple)) or \
                    (rec.get("clock") or "host") != self.clock:
                continue
            try:
                feats = _log_features(sp.features(tuple(key)))
            except Exception:
                continue
            by_cfg = {}
            for cand in rec.get("candidates", []):
                if cand.get("ms") is not None:
                    by_cfg[_cfg_key(cand["config"])] = float(cand["ms"])
            if rec.get("default_ms") is not None and \
                    rec.get("default_config") is not None:
                by_cfg.setdefault(_cfg_key(rec["default_config"]),
                                  float(rec["default_ms"]))
            if rec.get("ms") is not None and rec.get("config") is not None:
                by_cfg.setdefault(_cfg_key(rec["config"]),
                                  float(rec["ms"]))
            if by_cfg:
                table.setdefault(site_name, []).append((feats, by_cfg))
        self._table = table
        return table

    def records_for(self, site_name):
        """How many stored measurement rows back this site's model."""
        return len(self._load().get(site_name, []))

    def predict(self, site, key, config):
        """Predicted ms for ``config`` at ``key``, or None when cold
        (no stored measurement of this config for this site)."""
        table = self._load().get(site.name)
        if not table:
            return None
        try:
            feats = _log_features(site.features(tuple(key)))
        except Exception:
            return None
        ck = _cfg_key(config)
        best = None
        for row_feats, by_cfg in table:
            if ck not in by_cfg or len(row_feats) != len(feats):
                continue
            d2 = sum((a - b) ** 2 for a, b in zip(row_feats, feats))
            if best is None or d2 < best[0]:
                best = (d2, row_feats, by_cfg[ck])
        if best is None:
            return None
        _d2, row_feats, ms = best
        # first-order size scaling: workloads differ mostly by volume,
        # and volume is the sum of the log features
        scale = math.exp(sum(feats) - sum(row_feats)) \
            if row_feats else 1.0
        return ms * min(max(scale, 1e-3), 1e3)

    def prune(self, site, key, candidates, keep=3):
        """Top-``keep`` candidates by predicted cost — or ALL of them
        when any candidate is unpredictable (a cold model must widen
        to exhaustive measurement, never narrow blindly)."""
        if len(candidates) <= keep:
            return list(candidates)
        scored = []
        for cfg in candidates:
            ms = self.predict(site, key, cfg)
            if ms is None:
                return list(candidates)
            scored.append((ms, cfg))
        scored.sort(key=lambda t: t[0])
        return [cfg for _ms, cfg in scored[:keep]]
