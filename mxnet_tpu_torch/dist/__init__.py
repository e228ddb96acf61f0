"""mx.dist of the port: collective deadlines.

Counterpart of ``mxnet_tpu/dist/``.  Ported: :mod:`~.timeouts` —
``MXNET_DIST_COLLECTIVE_TIMEOUT`` deadlines around a collective
(``run_with_deadline``): a dead peer turns the forever-hang of an
all-reduce into a classified :class:`DistTimeout` the supervisor's
taxonomy retries, with the trace watchdog armed around every deadline.

Not ported yet, with multi-GPU (``ROADMAP.md`` Queue 1 item 7):
``membership`` (``Membership``, the ``FileKV``/``MemKV``/``CoordKV``
backends, heartbeats and the world-stop flag), ``podckpt``
(``PodCheckpointManager``, ``pod_latest_step``) and the process-global
``join``/``current``.  The supervisor's dist mode
(``Supervisor(membership=...)``) takes any object with that interface.
"""
from __future__ import annotations

from . import timeouts
from .timeouts import DistTimeout, collective_timeout, run_with_deadline

__all__ = ["DistTimeout", "collective_timeout", "run_with_deadline",
           "timeouts", "state"]


def state():
    """Snapshot of the dist plane (diagnostics): the armed collective
    deadline; no membership is ported yet."""
    return {
        "member_dir": None,
        "collective_timeout": collective_timeout(),
        "membership": None,
    }
