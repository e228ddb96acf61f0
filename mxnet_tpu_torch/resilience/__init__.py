"""mx.resilience of the port: deterministic fault injection,
preemption-aware shutdown, hardened restart supervision.

Counterpart of ``mxnet_tpu/resilience/``:

- ``resilience.inject`` — a step/site-keyed fault plan
  (``MXNET_FAULTS`` or ``resilience.plan()``) with named injection
  sites at the trainer step (``gluon.Trainer.step``,
  ``parallel.FusedTrainer.step``), the captured step's build and
  dispatch (``step/capture.py``), the checkpoint writer's commit and
  marker, the streaming reader's IO and the serving planes.  Faults
  fire deterministically by (site, sequence), so every recovery drill
  replays identically on the CPU.
- ``resilience.preempt`` — SIGTERM handling with a grace budget
  (``MXNET_PREEMPT_GRACE_SECONDS``): the supervisor stops at the next
  step boundary, flushes an emergency checkpoint, drains serve and the
  loaders, and exits with the distinct ``MXNET_PREEMPT_EXIT_CODE``.
- ``resilience.supervisor`` — transient-vs-fatal exception taxonomy,
  exponential backoff with jitter, a restart budget over a sliding
  step window, wall-clock-bounded device health checks, and
  restore-on-divergence wired to the mx.monitor feed.  It absorbs
  (and deprecates) ``elastic.FaultTolerantRunner``.

``MXNET_PREEMPT_INSTALL=1`` arms the SIGTERM handler at import.
"""
from __future__ import annotations

from ..base import get_env
from . import inject, preempt, supervisor
from .inject import (FaultPlan, InjectedFault, InjectedIOError, clear,
                     fire, plan, poisoned, refresh_env)
from .preempt import (graceful_shutdown, install, preemption_imminent,
                      request, requested)
from .supervisor import (Backoff, GluonStepLoop, RestartBudget,
                         Supervisor, classify, health_check,
                         recent_restarts, register_fatal,
                         register_transient)

__all__ = [
    "inject", "preempt", "supervisor",
    "FaultPlan", "InjectedFault", "InjectedIOError",
    "plan", "clear", "fire", "poisoned", "refresh_env",
    "install", "request", "requested", "preemption_imminent",
    "graceful_shutdown",
    "Supervisor", "GluonStepLoop", "Backoff", "RestartBudget",
    "classify", "health_check", "recent_restarts",
    "register_transient", "register_fatal",
]

# arm the SIGTERM handler at import when asked, so a preempted job leaves
# an emergency checkpoint instead of a dead run
if get_env("MXNET_PREEMPT_INSTALL", bool, False):  # pragma: no cover
    install()
