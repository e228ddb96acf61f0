"""Failure detection + checkpoint auto-resume (compat surface).

Counterpart of ``mxnet_tpu/elastic.py``: the thin compatibility face
over two real subsystems:

- ``mx.checkpoint`` owns persistence (the ``CheckpointManager`` here
  is a positional-arg-compatible shim over it);
- ``mx.resilience`` owns detection and recovery: the exception
  taxonomy, backoff/budget policy, preemption handling, bounded
  health probes, and the ``Supervisor`` loop.

``FaultTolerantRunner`` is kept for existing callers but is now a
deprecated alias configured for the OLD semantics (lifetime restart
budget, no backoff sleep) — new code should use
``mx.resilience.Supervisor`` directly, which adds exponential backoff
with jitter, a sliding restart window, preemption-aware shutdown, and
restore-on-divergence.
"""
from __future__ import annotations

from .checkpoint import CheckpointManager as _CheckpointManager
from .checkpoint.layout import tree_from_spec, tree_spec
from .resilience.supervisor import Backoff, Supervisor
from .resilience.supervisor import health_check as _health_check

__all__ = ["device_health_check", "CheckpointManager",
           "FaultTolerantRunner"]


def device_health_check(timeout_ok=True, timeout=None):
    """Probe every local device (each CUDA device, else the CPU) with a
    trivial program + host transfer.

    Returns ``{device_str: "ok" | "error: ..."}``.  With ``timeout``
    (seconds) each device is probed in a worker thread under a shared
    wall-clock bound, and a hung transfer reports ``"error: timeout"``
    instead of blocking the caller forever.  ``timeout=None`` keeps the
    old unbounded behavior.  ``timeout_ok`` is accepted for signature
    compatibility."""
    return _health_check(timeout=timeout)


# compat aliases: the pytree structure codec moved to mx.checkpoint
_tree_spec = tree_spec
_tree_from_spec = tree_from_spec


class CheckpointManager(_CheckpointManager):
    """Compat shim over ``mx.checkpoint.CheckpointManager`` (the old
    elastic manager's API, the new subsystem's machinery).

    Inherits the two-phase COMMITTED commit (the old implementation's
    rmtree-before-rename crash window is closed: an overwrite parks the
    previous copy at ``*.prev`` until the new one is published),
    sharded manifests with per-file checksums, async ``save_async``/
    ``wait``, ``validate``/quarantine, and torn-directory-aware
    ``steps()``/``latest_step()``.  Checkpoints written by the old
    manager (``leaves.npz`` + ``meta.json``) still restore.  New code
    should use ``mx.checkpoint`` directly.
    """

    # the override exists to keep the OLD positional order
    # (root, max_keep, prefix) — the parent inserts keep_every between
    # them; new kwargs still pass through
    def __init__(self, root, max_keep=3, prefix="ckpt", **kwargs):
        super().__init__(root, max_keep=max_keep, prefix=prefix, **kwargs)


# one DeprecationWarning per process (not per construction: a restart
# loop re-building its runner must not spam the log; tests reset this)
_FTR_WARNED = False


class FaultTolerantRunner(Supervisor):
    """DEPRECATED alias of ``mx.resilience.Supervisor`` keeping the old
    constructor and semantics: a LIFETIME restart budget and no
    backoff sleep between restarts.  It still gains the new hardening
    for free — exception taxonomy (fatal shape/user errors raise
    immediately instead of burning restarts), bounded health probes,
    contained ``on_failure`` callbacks (a raising callback no longer
    masks the original training error), preemption polling, and a
    flight-record dump per restart.  Emits ``DeprecationWarning`` once
    per process."""

    def __init__(self, trainer, manager, checkpoint_every=50,
                 max_restarts=3, on_failure=None):
        global _FTR_WARNED
        if not _FTR_WARNED:
            _FTR_WARNED = True
            import warnings

            warnings.warn(
                "elastic.FaultTolerantRunner is deprecated; use "
                "mxnet_tpu_torch.resilience.Supervisor (adds backoff with "

                "jitter, sliding restart windows, preemption handling, "
                "and restore-on-divergence)",
                DeprecationWarning, stacklevel=2)
        super().__init__(
            trainer, manager, checkpoint_every=checkpoint_every,
            max_restarts=max_restarts, restart_window=0,
            backoff=Backoff(base=0.0, jitter=0.0),
            on_failure=on_failure)
