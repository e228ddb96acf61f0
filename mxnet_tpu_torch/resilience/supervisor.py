"""Hardened restart supervisor (absorbs ``elastic.FaultTolerantRunner``).

Counterpart of ``mxnet_tpu/resilience/supervisor.py``.  A restart loop
needs backoff (a crash-looping job must not hammer the checkpoint
store), a transient-vs-fatal classification (a shape bug must not burn
restarts before surfacing) and a device health check that cannot hang
on a dead device.  This module gives all three and adds the preemption
and divergence hooks:

- **exception taxonomy** (``classify``): transient device/collective/
  IO errors (``OSError``, ``TimeoutError``, ``ConnectionError``, torch's
  CUDA errors, which surface as ``RuntimeError`` —
  ``torch.cuda.OutOfMemoryError`` is one —, injected transients) are
  retried; fatal shape/user errors (``ValueError``/``TypeError``/
  ``KeyError``/ framework ``MXNetError`` contract violations) raise
  immediately — restarting cannot fix a wrong model.
- **exponential backoff with jitter** (``Backoff``) between restarts,
  and a **restart budget over a sliding step window**
  (``RestartBudget``) instead of a lifetime cap: a job that hits one
  flaky hour after a week of progress should not burn budget it
  "spent" days ago.
- **bounded health probes** (``health_check(timeout=...)``): each
  device probed in its own worker thread (``2.0 * 2`` on the device,
  read back to the host under ``torch.cuda.device(d)``; ``cpu`` where
  there is no card); a hung transfer reports ``"error: timeout"``
  instead of blocking the supervisor forever, and a context left broken
  by a sticky CUDA error (an illegal address) reports its error, so the
  supervisor raises "unhealthy" rather than loop on a dead context.
- **preemption**: ``preempt.requested()`` is polled at every step
  boundary; when set the supervisor takes an emergency checkpoint
  (through the manager's async writer, then ``wait()``), runs the
  registered shutdown hooks (serve drain), and exits with the
  distinct preemption code.
- **divergence restore**: with ``restore_on_divergence=True`` the
  supervisor subscribes to the mx.monitor divergence feed and rolls
  back to the latest checkpoint at the next step boundary when
  training health goes bad — the automated version of "the loss went
  to NaN an hour ago, reload and lower the LR".
- a **flight-record dump** (reason ``restart``) on every restart, so
  each recovery leaves the trace of what preceded the failure.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque

from .. import telemetry, trace
from ..base import MXNetError, get_env
from . import preempt
from .inject import InjectedFault

__all__ = ["classify", "register_transient", "register_fatal",
           "Backoff", "RestartBudget", "health_check", "Supervisor",
           "GluonStepLoop", "RECENT_RESTARTS", "recent_restarts"]

_LOG = logging.getLogger("mxnet_tpu_torch.resilience")

# ---------------------------------------------------------------------------
# exception taxonomy
# ---------------------------------------------------------------------------

_TRANSIENT_EXTRA = []
_FATAL_EXTRA = []

# user/shape/programming errors: a restart replays the same code on
# the same shapes and fails the same way — surface immediately
_FATAL_BUILTIN = (ValueError, TypeError, KeyError, IndexError,
                  AttributeError, AssertionError, ZeroDivisionError,
                  NotImplementedError)
# infrastructure errors: storage hiccups, dead/hung devices, lost
# connections — the restart-from-checkpoint loop exists for these
_TRANSIENT_BUILTIN = (OSError, TimeoutError, ConnectionError)


def register_transient(*exc_types):
    """Teach the taxonomy extra retryable types (a custom data-loader
    error, a vendor RPC exception, ...)."""
    _TRANSIENT_EXTRA.extend(exc_types)


def register_fatal(*exc_types):
    _FATAL_EXTRA.extend(exc_types)


def classify(exc):
    """``"transient"`` (retry from checkpoint) or ``"fatal"`` (raise).

    Order matters: explicit marks beat registrations beat built-ins,
    and ``MXNetError`` — this framework's contract-violation type — is
    fatal even though it subclasses ``RuntimeError``, while a plain
    ``RuntimeError`` is transient: torch surfaces CUDA failures that
    way (a launch or illegal-address error is a ``RuntimeError``, and
    ``torch.cuda.OutOfMemoryError`` subclasses it), so they are retried
    as their base class is.
    Unknown exception types default to transient: on a pod, retrying
    an unknown error and hitting the restart budget beats killing a
    week-long job on the first novel hiccup.
    """
    kind = getattr(exc, "mx_fault_kind", None)
    if kind in ("transient", "fatal"):
        return kind
    if isinstance(exc, InjectedFault):
        return "fatal" if exc.kind == "fatal" else "transient"
    for t in _FATAL_EXTRA:
        if isinstance(exc, t):
            return "fatal"
    for t in _TRANSIENT_EXTRA:
        if isinstance(exc, t):
            return "transient"
    if isinstance(exc, _TRANSIENT_BUILTIN):
        return "transient"
    if isinstance(exc, MXNetError):
        return "fatal"
    if isinstance(exc, _FATAL_BUILTIN):
        return "fatal"
    return "transient"


# ---------------------------------------------------------------------------
# backoff + budget
# ---------------------------------------------------------------------------

class Backoff:
    """``base * factor**attempt`` capped at ``max_delay``, stretched by
    up to ``jitter`` fraction (decorrelates a pod's workers so N
    restarting processes don't stampede the checkpoint store in
    lockstep).  ``seed`` pins the jitter stream for deterministic
    drills."""

    def __init__(self, base=None, factor=2.0, max_delay=None,
                 jitter=0.1, seed=None):
        self.base = get_env("MXNET_RESTART_BACKOFF_BASE", float, 1.0) \
            if base is None else float(base)
        self.factor = float(factor)
        self.max_delay = get_env("MXNET_RESTART_BACKOFF_MAX", float,
                                 60.0) if max_delay is None \
            else float(max_delay)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)

    def delay(self, attempt):
        d = min(self.base * self.factor ** max(0, int(attempt)),
                self.max_delay)
        if self.jitter > 0 and d > 0:
            d *= 1.0 + self._rng.random() * self.jitter
        return d


class RestartBudget:
    """At most ``max_restarts`` restarts within the trailing
    ``window_steps`` training steps (``None`` = over the whole run,
    the old lifetime semantics)."""

    def __init__(self, max_restarts, window_steps=None):
        self.max_restarts = int(max_restarts)
        self.window_steps = None if window_steps is None \
            else int(window_steps)
        self._steps = deque()

    def record(self, step):
        """Count a restart at ``step``; returns restarts currently in
        the window (including this one)."""
        self._steps.append(int(step))
        return self.count(step)

    def count(self, step):
        if self.window_steps is not None:
            while self._steps and \
                    step - self._steps[0] >= self.window_steps:
                self._steps.popleft()
        return len(self._steps)

    def exceeded(self, step):
        return self.count(step) > self.max_restarts


# ---------------------------------------------------------------------------
# bounded device health check
# ---------------------------------------------------------------------------

def _default_probe(device):
    """``2.0 * 2`` on ``device``, read back to the host (on a card, under
    ``torch.cuda.device(device)``, so a sticky error of that context
    raises here)."""
    import contextlib

    import torch

    device = torch.device(device)
    scope = torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()
    with scope:
        val = (torch.full((), 2.0, dtype=torch.float32,
                          device=device) * 2).item()
    if float(val) != 4.0:
        raise MXNetError("bad arithmetic: %r" % (val,))


def _local_devices():
    """Every CUDA device of this process, else the CPU."""
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def health_check(timeout=None, devices=None, probe=None):
    """Probe every local device (each CUDA device, else the CPU) with a
    trivial program + host transfer; returns ``{device_str: "ok" |
    "error: ..."}`` (``"cuda:0"``, ``"cpu"``).

    Each probe runs in its own worker thread and the whole check is
    bounded by ``timeout`` seconds (shared wall-clock, not per
    device): a hung transfer is reported as ``"error: timeout"``
    instead of hanging the caller.
    ``timeout=None`` preserves the old unbounded behavior."""
    if devices is None:
        devices = _local_devices()
    probe = probe or _default_probe
    report, threads = {}, []
    lock = threading.Lock()

    def run(d):
        try:
            probe(d)
            out = "ok"
        except Exception as exc:  # pragma: no cover - real device loss
            out = "error: %s" % (exc,)
        with lock:
            report[str(d)] = out

    for d in devices:
        t = threading.Thread(target=run, args=(d,), daemon=True,
                             name="mx-health-probe")
        t.start()
        threads.append((d, t))
    deadline = None if timeout is None else \
        time.monotonic() + float(timeout)
    for d, t in threads:
        t.join(None if deadline is None
               else max(0.0, deadline - time.monotonic()))
        with lock:
            if str(d) not in report:
                report[str(d)] = "error: timeout" + (
                    "" if timeout is None
                    else " (probe still running after %.1fs)"
                         % float(timeout))
    return report


# ---------------------------------------------------------------------------
# restart records (diagnose surface)
# ---------------------------------------------------------------------------

RECENT_RESTARTS = deque(maxlen=32)  # newest-last dicts


def recent_restarts():
    return list(RECENT_RESTARTS)


def _record_restart(kind, step, error, backoff_s=None,
                    restored_step=None):
    rec = {"kind": kind, "step": int(step), "wall_time": time.time(),
           "error": None if error is None else
           "%s: %s" % (type(error).__name__, error),
           "backoff_seconds": backoff_s, "restored_step": restored_step}
    RECENT_RESTARTS.append(rec)
    if telemetry.ENABLED:
        telemetry.RESILIENCE_RESTARTS.labels(kind=kind).inc()
    return rec


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

def _tree_device(tree):
    """The device of the first tensor in a state tree, or None."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            dev = _tree_device(v)
            if dev is not None:
                return dev
    return None


def _scalar(loss):
    """A step's loss (an NDArray or a tensor) as a Python float."""
    if hasattr(loss, "asscalar"):
        return float(loss.asscalar())
    return float(loss.item())


def _safe_on_failure(cb, step, exc):
    """Run the user's on_failure callback WITHOUT letting its own bugs
    mask the original training error: a raising callback is logged
    (with the original attached as context) and recovery proceeds on
    the original exception."""
    if cb is None:
        return
    try:
        cb(step, exc)
    except Exception as cb_exc:  # noqa: BLE001 - must not mask `exc`
        cb_exc.__context__ = exc
        _LOG.warning(
            "on_failure callback raised %s: %s — original training "
            "error %s: %s is preserved and still drives recovery",
            type(cb_exc).__name__, cb_exc, type(exc).__name__, exc)


class Supervisor:
    """Resumable, preemption-aware training loop with failure taxonomy.

    ``trainer`` needs ``step(x, y) -> loss``, ``state_dict()`` and
    ``load_state_dict(state)`` (FusedTrainer and the ``GluonStepLoop``
    adapter below qualify).  ``batches`` is
    ``fn(step_index) -> (x, y)`` — the data position is a pure
    function of the step index, so a resume lands on the right batch.

    Parameters
    ----------
    trainer, manager : the step engine and its ``mx.checkpoint``
        manager (``elastic.CheckpointManager`` works).
    checkpoint_every : save cadence in steps.
    max_restarts : restart budget (default ``MXNET_RESTART_BUDGET``).
    restart_window : sliding step window the budget applies over
        (default ``MXNET_RESTART_WINDOW_STEPS``; 0/None = lifetime).
    backoff : a ``Backoff`` (default: env-tuned, jittered).
    on_failure : ``fn(step, exc)`` observer; its own exceptions are
        contained (they never mask the training error).
    health_timeout : wall-clock bound on the post-failure device probe
        (default ``MXNET_HEALTH_TIMEOUT``).
    exit_on_preempt : ``sys.exit(preempt.exit_code())`` after the
        emergency checkpoint instead of returning (what a pod
        entrypoint wants; library callers inspect ``.preempted``).
    restore_on_divergence : roll back to the latest checkpoint when
        mx.monitor reports divergence (grad spike / nonfinite / loss
        NaN); counts against the same restart budget.
    membership : an ``mx.dist.Membership`` arms **dist mode**: the
        supervisor heartbeats its step, polls the world-stop flag at
        every step boundary, and turns any rank's transient failure or
        SIGTERM into a COORDINATED stop — post the flag, stop at the
        boundary, emergency-checkpoint through the (pod) manager, and
        exit with the preempt code so the launcher relaunches the
        whole world.  Local restore-and-retry is disabled (peers
        cannot rejoin a collective this rank replays alone); the
        restart loop moves up to the launcher.  The supervisor only
        calls ``join``, ``note_step``, ``poll_stop``, ``signal_stop``,
        ``leave`` and ``generation`` on it (``mx.dist.Membership``
        itself is ported with multi-GPU, ``ROADMAP.md`` Queue 1 item 7).
    """

    def __init__(self, trainer, manager, checkpoint_every=50,
                 max_restarts=None, restart_window=None, backoff=None,
                 on_failure=None, health_timeout=None,
                 exit_on_preempt=False, restore_on_divergence=False,
                 membership=None):
        self._trainer = trainer
        self._manager = manager
        self._every = max(1, int(checkpoint_every))
        self._max_restarts = get_env("MXNET_RESTART_BUDGET", int, 3) \
            if max_restarts is None else int(max_restarts)
        if restart_window is None:
            restart_window = get_env("MXNET_RESTART_WINDOW_STEPS",
                                     int, 0)
        self._window = int(restart_window) or None
        self._backoff = backoff if backoff is not None else Backoff()
        self._on_failure = on_failure
        self._health_timeout = get_env("MXNET_HEALTH_TIMEOUT", float,
                                       60.0) \
            if health_timeout is None else health_timeout
        self._exit_on_preempt = bool(exit_on_preempt)
        self._restore_on_divergence = bool(restore_on_divergence)
        self._membership = membership
        self._divergence_pending = None
        self._state_suspect = False  # failed mid-step, no ckpt to trust
        self.restarts = 0            # transient-failure restarts
        self.divergence_restores = 0
        self.preempted = False
        self.world_stopped = None    # dist mode: the stop flag we obeyed
        self.emergency_checkpoint = None

    # -- resume -------------------------------------------------------------
    def _resume(self):
        """Restore the latest checkpoint into the trainer; returns the
        restored step.  The trainer's live state is the restore
        template (dtype adoption); when its structure diverges from the
        saved tree — a fresh process whose optimizer state is not
        materialized yet — the spec-based restore carries it.  The
        trainer's ``load_state_dict`` copies into its live tensors, so a
        captured step's CUDA graph reads the restored values."""
        template = self._trainer.state_dict()
        try:
            saved_step, state = self._manager.restore(template)
        except MXNetError:
            if template is None:
                raise
            # the spec restore lands where the trainer's tensors live
            saved_step, state = self._manager.restore(
                None, ctx=_tree_device(template))
        self._trainer.load_state_dict(state)
        self._state_suspect = False  # fully replaced from durable state
        return saved_step

    def _save(self, step):
        self._manager.save(step, self._trainer.state_dict())

    def _emergency(self, last_done):
        """The preemption endgame: flush an emergency checkpoint
        through the async writer (snapshot + commit + ``wait()``),
        then run the registered shutdown hooks inside whatever grace
        budget remains.  ``last_done`` is the last COMPLETED step —
        the checkpoint tag a resume continues from (+1), exactly like
        the periodic saves.  State marked suspect (a step failed
        mid-mutation with nothing durable to roll back to) is NOT
        saved — persisting corruption as truth is worse than losing
        the partial progress."""
        state = None if self._state_suspect or last_done < 0 \
            else self._trainer.state_dict()
        step = max(0, last_done)
        if state is not None:
            with trace.span("emergency_checkpoint", hist=False,
                            cat="resilience", args={"step": int(step)}):
                self._manager.save_async(step, state)
                self.emergency_checkpoint = self._manager.wait()
            if telemetry.ENABLED:
                telemetry.RESILIENCE_EMERGENCY_SAVES.inc()
        rem = preempt.remaining()
        if rem is not None and rem <= 0:
            _LOG.warning(
                "preemption grace budget exhausted (%.1fs over); "
                "skipping shutdown hooks — the emergency checkpoint "
                "is committed", -rem)
        else:
            preempt.graceful_shutdown()
        _LOG.warning(
            "preemption: emergency checkpoint %s at step %d, exiting "
            "with code %d", self.emergency_checkpoint, step,
            preempt.exit_code())

    # -- divergence hook ----------------------------------------------------
    def _on_divergence(self, extra):
        self._divergence_pending = dict(extra or {})

    # -- the loop -----------------------------------------------------------
    def run(self, batches, num_steps, start_step=0):
        """Drive ``trainer.step`` from ``start_step`` to ``num_steps``;
        returns the per-step loss list for steps executed by THIS
        process.  Transient failures restore-and-resume under the
        budget/backoff policy; fatal ones raise immediately; a pending
        preemption stops the loop at the step boundary."""
        losses = []
        step = start_step
        budget = RestartBudget(self._max_restarts, self._window)
        listener = None
        if self._restore_on_divergence:
            from ..trace import anomaly

            listener = anomaly.on_divergence(self._on_divergence)
        if self._membership is not None \
                and self._membership.generation is None:
            self._membership.join()
        try:
            latest = self._manager.latest_step()
            if latest is not None and latest >= step:
                step = self._resume() + 1
            while step < num_steps:
                if preempt.requested():
                    # dist mode: SIGTERM on THIS host preempts the
                    # whole world — post the flag before saving so
                    # peers reach their own step boundary (or their
                    # collective deadline) and flush the SAME step
                    if self._membership is not None:
                        self.world_stopped = \
                            self._membership.signal_stop(
                                "preempt", step - 1)
                    self.preempted = True
                    self._emergency(step - 1)
                    if self._membership is not None:
                        self._membership.leave("preempt")
                    if self._exit_on_preempt:
                        import sys

                        sys.exit(preempt.exit_code())
                    return losses
                if self._membership is not None:
                    self._membership.note_step(step)
                    stop = self._membership.poll_stop()
                    if stop is not None:
                        return self._obey_world_stop(stop, step - 1,
                                                     losses)
                if self._divergence_pending is not None:
                    info, self._divergence_pending = \
                        self._divergence_pending, None
                    step, losses = self._handle_divergence(
                        info, step, start_step, losses, budget)
                    continue
                try:
                    x, y = batches(step)
                    loss = self._trainer.step(x, y)
                    losses.append(_scalar(loss))
                    # a cleanly completed step leaves consistent state:
                    # safe to checkpoint (periodic or emergency) again
                    self._state_suspect = False
                    if (step + 1) % self._every == 0 \
                            or step == num_steps - 1:
                        self._save(step)
                    step += 1
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as exc:
                    step, losses = self._handle_failure(
                        exc, step, start_step, losses, budget)
                    if step is None:   # dist mode: world stopping
                        return losses
            return losses
        finally:
            if listener is not None:
                from ..trace import anomaly

                anomaly.remove_divergence_listener(listener)

    def _obey_world_stop(self, info, last_done, losses):
        """Dist mode: a peer (or this rank, below) posted the world-
        stop flag.  Stop at the boundary, emergency-checkpoint through
        the pod manager (every obeying rank saves its last completed
        step; the pod marker only lands for a step ALL ranks flushed,
        so restore is consistent by construction), leave membership,
        and exit with the preempt code for the launcher to relaunch."""
        self.preempted = True
        self.world_stopped = dict(info or {})
        _record_restart("world_stop", max(0, last_done), None)
        _LOG.warning(
            "world stop (reason=%s from rank %s at step %s): stopping "
            "at step boundary %d, flushing emergency checkpoint",
            self.world_stopped.get("reason"),
            self.world_stopped.get("rank"),
            self.world_stopped.get("step"), last_done)
        self._emergency(last_done)
        if self._membership is not None:
            self._membership.leave("world_stop")
        if self._exit_on_preempt:
            import sys

            sys.exit(preempt.exit_code())
        return losses

    def _world_failure(self, exc, step, losses):
        """Dist mode transient failure on THIS rank: propagate through
        the stop flag and join the coordinated shutdown.  A failure
        marked state-clean (``DistTimeout``: the collective deadline
        fires before any optimizer state mutates) may still emergency-
        checkpoint the last completed step; anything else is suspect
        and saves nothing — peers' shards plus the pod max-common rule
        keep the restore consistent either way."""
        self.restarts += 1
        if not getattr(exc, "mx_state_clean", False):
            self._state_suspect = True
        info = None
        if self._membership is not None:
            info = self._membership.signal_stop(
                "failure", step - 1,
                error="%s: %s" % (type(exc).__name__, exc))
        return None, self._obey_world_stop(
            info or {"reason": "failure", "rank": None, "step": step - 1},
            step - 1, losses)

    def _handle_failure(self, exc, step, start_step, losses, budget):
        kind = classify(exc)
        _safe_on_failure(self._on_failure, step, exc)
        trace.dump_async("restart", extra={
            "step": int(step), "classified": kind,
            "error": "%s: %s" % (type(exc).__name__, exc)})
        if kind == "transient" and self._membership is not None:
            return self._world_failure(exc, step, losses)
        if kind == "fatal":
            if self._membership is not None:
                # peers must not wait out their collective deadline to
                # learn the world is dead — flag it before raising
                self._membership.signal_stop(
                    "failure", step - 1,
                    error="%s: %s" % (type(exc).__name__, exc))
            _record_restart("fatal", step, exc)
            raise MXNetError(
                "fatal training error at step %d (%s — not retried: "
                "a restart replays the same failure): %s"
                % (step, type(exc).__name__, exc)) from exc
        n = budget.record(step)
        self.restarts += 1
        if budget.exceeded(step):
            _record_restart("budget_exhausted", step, exc)
            raise MXNetError(
                "training failed at step %d after %d restarts%s: %s"
                % (step, n - 1,
                   " within the trailing %d-step window" % self._window
                   if self._window else "", exc)) from exc
        # a pending preemption outranks the SLOW parts of recovery —
        # health probe (up to MXNET_HEALTH_TIMEOUT) and backoff sleep
        # (ceiling 60s, twice the default grace budget) are skipped —
        # but NEVER the restore: a real transient error may have fired
        # mid-update, so the in-memory state is suspect and must not
        # become the emergency checkpoint
        delay = 0.0
        if not preempt.requested():
            health = health_check(timeout=self._health_timeout)
            bad = {k: v for k, v in health.items() if v != "ok"}
            if bad:  # pragma: no cover - real chip loss
                _record_restart("unhealthy", step, exc)
                raise MXNetError(
                    "device(s) unhealthy after failure at step %d: %s"
                    % (step, bad)) from exc
            delay = self._backoff.delay(n - 1)
            if delay > 0:
                if telemetry.ENABLED:
                    telemetry.RESILIENCE_BACKOFF_SECONDS.observe(delay)
                # sleep in slices so a SIGTERM mid-backoff doesn't burn
                # the grace window checkpoint-less
                end = time.monotonic() + delay
                while time.monotonic() < end \
                        and not preempt.requested():
                    time.sleep(min(0.25,
                                   max(0.0, end - time.monotonic())))
        restored = None
        failed_step = step          # the record keeps WHERE it failed
        if self._manager.latest_step() is not None:
            restored = self._resume()
            step = restored + 1
            # drop losses from steps that will be replayed so the
            # returned series has exactly one entry per step
            losses = losses[:max(0, step - start_step)]
        else:
            # retrying from in-memory state: the failed step may have
            # half-mutated it, so it is suspect until the next step
            # completes cleanly — an emergency save in that window
            # would persist corruption as truth.  Marked
            # unconditionally (not only when preemption is already
            # pending): a SIGTERM can land between this poll and the
            # loop-top one.
            self._state_suspect = True
        _record_restart("transient", failed_step, exc, backoff_s=delay,
                        restored_step=restored)
        return step, losses

    def _handle_divergence(self, info, step, start_step, losses,
                           budget):
        if self._manager.latest_step() is None:
            _LOG.warning(
                "divergence reported (%s) but no checkpoint exists "
                "yet; continuing", info.get("kind"))
            return step, losses
        n = budget.record(step)
        if budget.exceeded(step):
            raise MXNetError(
                "training diverged at step %d after %d restore(s)%s "
                "(%s) — rollback alone is not fixing this run"
                % (step, n - 1,
                   " within the trailing %d-step window" % self._window
                   if self._window else "", info.get("kind")))
        restored = self._resume()
        self.divergence_restores += 1
        _record_restart("divergence", step, None,
                        restored_step=restored)
        _LOG.warning(
            "divergence (%s) at step %s: restored checkpoint step %d, "
            "resuming from step %d", info.get("kind"),
            info.get("step", step), restored, restored + 1)
        step = restored + 1
        return step, losses[:max(0, step - start_step)]


# ---------------------------------------------------------------------------
# imperative-trainer adapter
# ---------------------------------------------------------------------------

class GluonStepLoop:
    """Adapt a Gluon ``(block, gluon.Trainer, loss_fn)`` triple to the
    supervisor's trainer protocol — the imperative counterpart of
    FusedTrainer for fault drills: its step path goes through the real
    ``Trainer.step`` (the ``trainer_step`` injection site) and the real
    multi-tensor update engine.  ``x``/``y`` may each be a tuple, splat
    into the block and the loss as ``mx.step.capture`` splats them; a
    tensor or NDArray is used as it is, anything else becomes an NDArray
    on the current context.  With ``mx.obs`` on, the stitched step hands
    ``obs.attribution`` its forward / backward / update host times
    through ``StepParts``, as a ``StepProgram``'s stitched path does (the
    captured path records its own)."""

    def __init__(self, block, trainer, loss_fn, step_program=None):
        self._block = block
        self._trainer = trainer
        self._loss_fn = loss_fn
        # optional mx.step whole-step captured program: the supervisor
        # then drills the ONE-program path (fused fwd/bwd/allreduce/
        # apply) — a transient at the step_capture site must rewind
        # update counts exactly once before the restore-and-retry
        self._step_program = step_program

    @property
    def block(self):
        return self._block

    @property
    def trainer(self):
        return self._trainer

    def step(self, x, y):
        from .. import autograd
        from .. import obs as _obs

        xs, ys = _inputs(x), _inputs(y)
        x = xs if isinstance(x, (tuple, list)) else xs[0]
        y = ys if isinstance(y, (tuple, list)) else ys[0]
        if self._step_program is not None:
            return self._step_program(x, y).mean()
        parts = _obs.attribution.StepParts(self._trainer.step_count)
        with autograd.record():
            loss = self._loss_fn(self._block(*xs), *ys)
        parts.mark("forward")
        autograd.backward(loss)
        parts.mark("backward")
        self._trainer.step(xs[0].shape[0])
        parts.mark("update")
        parts.observe()
        return loss.mean()

    def state_dict(self):
        return self._trainer.state_dict()

    def load_state_dict(self, state):
        self._trainer.load_state_dict(state)


def _inputs(v):
    """``v`` (one value or a tuple) as a tuple of tensors or NDArrays."""
    import torch

    from .. import ndarray as nd

    vals = tuple(v) if isinstance(v, (tuple, list)) else (v,)
    return tuple(a if isinstance(a, (torch.Tensor, nd.NDArray))
                 else nd.array(a) for a in vals)

