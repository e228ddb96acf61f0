"""mx.resilience of the port: deterministic fault injection.

Counterpart of ``mxnet_tpu/resilience/``.  Only ``inject`` is ported: the
fault plan and its checkpoint and serving sites, which the checkpoint
crash drills and the serving poison, dispatch, prefix-cache and
speculative drills use.  ``preempt`` (SIGTERM with a grace budget) and
``supervisor`` (restart supervision) wait in ``ROADMAP.md`` Queue 1 item
8.
"""
from __future__ import annotations

from . import inject
from .inject import (FaultPlan, InjectedFault, InjectedIOError, clear,
                     fire, plan, refresh_env)

__all__ = ["inject", "FaultPlan", "InjectedFault", "InjectedIOError",
           "plan", "clear", "fire", "refresh_env"]
