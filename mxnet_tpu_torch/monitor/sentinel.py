"""Nonfinite sentinel: the policy that gates a trainer step on the health
of its gradients.

Counterpart of ``mxnet_tpu/monitor/sentinel.py``.  Policies
(``MXNET_MONITOR_SENTINEL``):

- ``off``       -- stats are published, nothing trips.
- ``warn``      -- default: a step with nonfinite gradients is logged and
  counted when its stats are published; the update was applied.
- ``skip_step`` -- the stats are read before any update; a step with a
  nonfinite gradient element is skipped whole (no parameter, optimizer
  state or update count changes).  Inside a captured step the skip is a
  ``torch.where`` select on a device flag.
- ``raise``     -- the same check, raising ``MXNetError`` that names the
  first sick group.
"""
from __future__ import annotations

import logging

from ..base import MXNetError, get_env

__all__ = ["POLICIES", "SYNC_POLICIES", "policy", "first_offender",
           "warn_trip"]

_LOGGER = logging.getLogger("mxnet_tpu_torch.monitor")

POLICIES = ("off", "warn", "skip_step", "raise")
# policies that need the nonfinite count before the update may apply
SYNC_POLICIES = ("skip_step", "raise")


def policy():
    """The sentinel policy in force (a typo fails loud)."""
    p = get_env("MXNET_MONITOR_SENTINEL", str, "warn")
    if p not in POLICIES:
        raise MXNetError(
            "MXNET_MONITOR_SENTINEL=%r is not a sentinel policy "
            "(choose from %s)" % (p, "|".join(POLICIES)))
    return p


def first_offender(host_stats):
    """First group (ascending parameter index) whose gradients hold
    nonfinite elements: ``(label, stats)`` or ``(None, None)``."""
    for label, st in host_stats.items():
        if st["g_nonfinite"] > 0:
            return label, st
    return None, None


def warn_trip(label, st, step):
    """The policy=warn trip report."""
    _LOGGER.warning(
        "mx.monitor: nonfinite gradients at step %s in group %s "
        "(%d nonfinite elements, grad_norm=%g) -- policy=warn, update "
        "was applied; set MXNET_MONITOR_SENTINEL=skip_step to drop "
        "such steps", step, label, int(st["g_nonfinite"]), st["g_norm"])
