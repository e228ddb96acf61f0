"""``mx.config``: the registry of the ``MXNET_*`` environment variables the
port reads.

Counterpart of ``mxnet_tpu/config.py``.  Each variable here is one that
some module of the port reads through ``base.get_env`` (a test holds the
sources to this table both ways), with the type and default that module
passes and what it changes in the port.  ``describe()`` prints the table
(the reference's env_var.md), ``current()`` gives each variable's
effective value, and ``check_unknown()`` lists the ``MXNET_*`` variables
set in the environment that the port does not read: a typo, or a knob of
the reference or of the JAX package that does nothing here.
"""
from __future__ import annotations

import os

from .base import get_env

__all__ = ["ENV_VARS", "describe", "current", "check_unknown"]

# name -> (type, default, doc)
ENV_VARS = {
    "MXNET_MULTI_TENSOR": (
        bool, True,
        "Grouped optimizer apply in gluon.Trainer (optimizer/"
        "multi_tensor.py): one torch._foreach_* rule per parameter group "
        "a step.  0 forces the per-parameter updates (row_sparse "
        "gradients take them regardless)."),
    "MXNET_KVSTORE_BUCKET_BYTES": (
        int, 4 << 20,
        "Gradient-fusion bucket size in bytes of the collective bucket "
        "planner (kvstore/collective.py)."),
    "MXNET_STEP_CAPTURE": (
        bool, True,
        "Kill switch of mx.step: 0 makes every StepProgram run the "
        "stitched record/backward/step sequence instead of a CUDA graph "
        "(step/capture.py)."),
    "MXNET_STEP_REMAT": (
        str, "off",
        "Recompute policy inside a captured step: off, all (one "
        "torch.utils.checkpoint around forward + loss) or blocks (one "
        "per direct child block) (step/capture.py)."),
    "MXNET_DATA_WORKERS": (
        int, 2,
        "Reader threads of mx.data.StreamLoader (data/loader.py)."),
    "MXNET_DATA_PREFETCH": (
        int, 2,
        "Depth of mx.data's staging ring: batches copied onto the card "
        "ahead of the loop (data/ring.py)."),
    "MXNET_DATA_ALLOW_UNSHARDED": (
        bool, False,
        "Allow a whole-dataset iterator where the launcher's environment "
        "names several hosts (data/__init__.py)."),
    "MXNET_DIST_NUM_WORKERS": (
        int, 0,
        "Number of hosts, read by mx.data's readers to shard a dataset "
        "(data/reader.py); 0 or unset is one host."),
    "MXNET_DIST_RANK": (
        int, 0,
        "This host's rank among MXNET_DIST_NUM_WORKERS (data/reader.py)."),
    "MXNET_FAULTS": (
        str, "",
        "Fault plan of mx.resilience drills: comma-separated "
        "site@key[:kind][*count] entries (resilience/inject.py)."),
    "MXNET_MONITOR": (
        bool, False,
        "Arm mx.monitor: per-group gradient and weight statistics and "
        "the nonfinite sentinel at each trainer step (monitor/core.py)."),
    "MXNET_MONITOR_INTERVAL": (
        int, 1,
        "Observe every Nth trainer step (monitor/core.py)."),
    "MXNET_MONITOR_SENTINEL": (
        str, "warn",
        "Nonfinite-gradient policy: warn, skip_step (drop the step before "
        "anything changes) or raise (monitor/sentinel.py)."),
    "MXNET_TELEMETRY_DISABLE": (
        bool, False,
        "Disable mx.telemetry's counters and histograms (telemetry.py)."),
    "MXNET_TRACE_DISABLE": (
        bool, False,
        "Disable mx.trace's span recording (trace/__init__.py)."),
    "MXNET_TRACE_RING_EVENTS": (
        int, 8192,
        "Capacity of mx.trace's in-memory ring of recent events "
        "(trace/__init__.py)."),
    "MXNET_NP_FALLBACK_LOG_VERBOSE": (
        bool, True,
        "Warn once per name when mx.np resolves a function to host numpy "
        "(off the card and off the tape; numpy/__init__.py)."),
    "MXNET_STORAGE_FALLBACK_LOG_VERBOSE": (
        bool, False,
        "Log each sparse array densified on the storage-fallback path "
        "(ndarray/sparse.py)."),
    "MXNET_SERVE_BREAKER_THRESHOLD": (
        int, 5,
        "Consecutive failed dispatches that open a serving bucket's "
        "circuit breaker (serve/server.py; <= 0 disables breakers)."),
    "MXNET_SERVE_BREAKER_COOLDOWN": (
        float, 30.0,
        "Seconds an open breaker waits before a half-open probe "
        "(serve/server.py)."),
    "MXNET_SERVE_RETRY_AFTER": (
        float, 1.0,
        "Retry-After seconds the HTTP front sends with a 503 "
        "(serve/server.py)."),
    "MXNET_SERVE_DECODE_PAGE_SIZE": (
        int, 16,
        "Tokens a page of the paged KV cache holds (serve/decode.py)."),
    "MXNET_SERVE_DECODE_POOL_PAGES": (
        int, 256,
        "Pages in the KV cache's pool on the card (serve/decode.py)."),
    "MXNET_SERVE_DECODE_MAX_LIVE": (
        int, 8,
        "Sequences decoding at once in the running batch "
        "(serve/decode.py)."),
    "MXNET_SERVE_DECODE_MAX_NEW": (
        int, 64,
        "Default max_new_tokens of a decode request (serve/decode.py)."),
    "MXNET_SERVE_DECODE_STREAM": (
        bool, True,
        "Stream decoded tokens as they come (serve/decode.py)."),
    "MXNET_SERVE_PREFIX_CACHE": (
        bool, False,
        "The radix prefix cache: shared prompt prefixes prefill once "
        "(serve/decode.py, serve/cache.py)."),
    "MXNET_SERVE_SPEC_K": (
        int, 0,
        "Draft tokens a round of speculative decoding proposes; 0 takes "
        "the built-in default (serve/decode.py, serve/spec.py)."),
    # the operational planes: autotune, the flight recorder's
    # dumps and detectors, the monitor's publisher, the profiler, the
    # telemetry log line
    "MXNET_AUTOTUNE": (
        str, "0",
        "mx.autotune mode: 0 (default) the hand-set choice everywhere and "
        "no store I/O; 1 lookups read the TuningStore; search also runs "
        "the serving and decode idle tuners."),
    "MXNET_AUTOTUNE_DIR": (
        str, None,
        "TuningStore directory (default <MXNET_HOME>/autotune); records "
        "are keyed by the torch and CUDA versions, the card and a hash of "
        "the kernel sources (autotune/store.py)."),
    "MXNET_HOME": (
        str, "~/.mxnet",
        "Root of the default autotune store (autotune/store.py)."),
    "MXNET_AUTOTUNE_BUDGET_MS": (
        float, 2000.0,
        "Wall-clock budget of one tune() search and of an idle-tuning "
        "pass; candidates past it are recorded as skipped."),
    "MXNET_AUTOTUNE_REPEATS": (
        int, 5,
        "Timed runs a measured candidate (trimmed mean: min and max "
        "dropped at 4 or more)."),
    "MXNET_AUTOTUNE_WARMUP": (
        int, 2,
        "Discarded warm-up runs a measured candidate, after its first "
        "(build and correctness) run."),
    "MXNET_AUTOTUNE_PRUNE": (
        int, 0,
        "When > 0, the table cost model keeps the N candidates predicted "
        "cheapest before measuring; a cold model measures every one."),
    "MXNET_TRACE_DUMP_DIR": (
        str, None,
        "Where flight-record dumps (mxtrace-<pid>-<reason>-*.json) and "
        "watchdog stack reports land (default <tempdir>/mxnet_trace)."),
    "MXNET_TRACE_DUMP_ON_CRASH": (
        bool, True,
        "Dump the flight record from sys/threading excepthook on an "
        "uncaught exception (trace/export.py)."),
    "MXNET_TRACE_DUMP_AT_EXIT": (
        bool, False,
        "Also dump the flight record at normal interpreter exit."),
    "MXNET_TRACE_DUMP_MIN_SECONDS": (
        float, 30.0,
        "Seconds between two anomaly dumps of one reason (slow_step, "
        "deadline_burst, divergence, hang)."),
    "MXNET_TRACE_DUMP_MAX_EVENTS": (
        int, 0,
        "Keep only the newest N ring events in a dump (0: the whole "
        "ring); a clipped dump says so in its metadata."),
    "MXNET_TRACE_SLOW_STEP_FACTOR": (
        float, 3.0,
        "Dump the flight record when a step takes more than this factor "
        "x the trailing p99 (0 disables)."),
    "MXNET_TRACE_DEADLINE_BURST": (
        int, 8,
        "Serve deadline misses within MXNET_TRACE_DEADLINE_WINDOW that "
        "trigger a flight-record dump (0 disables)."),
    "MXNET_TRACE_DEADLINE_WINDOW": (
        float, 5.0,
        "Sliding window (seconds) of the deadline-miss burst detector."),
    "MXNET_TRACE_WATCHDOG": (
        bool, False,
        "Arm the hang watchdog at the first watched scope (trainer step, "
        "captured step, serve dispatch, checkpoint commit)."),
    "MXNET_TRACE_WATCHDOG_SECONDS": (
        float, 120.0,
        "Default no-progress timeout of a watched scope."),
    "MXNET_MONITOR_RING": (
        int, 256,
        "Stat entries the monitor's ring holds for its publisher; a full "
        "ring displaces its oldest entry (monitor_dropped_total)."),
    "MXNET_MONITOR_STREAM": (
        str, None,
        "Append one JSON line of per-group health stats an observed step "
        "to this path."),
    "MXNET_MONITOR_SPIKE_FACTOR": (
        float, 10.0,
        "Divergence detector: dump when the global grad norm exceeds this "
        "factor x the trailing window's max (0 disables)."),
    "MXNET_MONITOR_SPIKE_WINDOW": (
        int, 64,
        "Observed steps in the grad-norm spike detector's window."),
    "MXNET_MONITOR_PLATEAU_WINDOW": (
        int, 0,
        "Loss observations without a new best before a loss_plateau "
        "divergence dump (0 disables; fed by monitor.observe_loss)."),
    "MXNET_PROFILER_AUTOSTART": (
        bool, False,
        "Start an mx.profiler session when the package is imported."),
    "MXNET_TELEMETRY_LOG_INTERVAL": (
        float, 0.0,
        "Seconds between periodic 'telemetry k=v ...' log lines "
        "(telemetry.start_logger; 0 disables)."),
    # fault handling: preemption, the restart supervisor, the collective
    # deadline; and the obs plane
    "MXNET_PREEMPT_INSTALL": (
        bool, False,
        "Arm the SIGTERM preemption handler at import: the supervisor "
        "stops at the next step boundary, flushes an emergency "
        "checkpoint, drains serve and the loaders, and exits with "
        "MXNET_PREEMPT_EXIT_CODE (resilience/preempt.py)."),
    "MXNET_PREEMPT_GRACE_SECONDS": (
        float, 30.0,
        "Grace budget after SIGTERM: shutdown hooks are skipped (the "
        "emergency checkpoint is not) once it is exhausted; a second "
        "SIGTERM exits immediately."),
    "MXNET_PREEMPT_EXIT_CODE": (
        int, 85,
        "Exit status of a clean preemption shutdown, distinct from "
        "crash codes so the scheduler knows to resume the job."),
    "MXNET_RESTART_BUDGET": (
        int, 3,
        "Supervisor restart budget: max transient-failure restarts "
        "within MXNET_RESTART_WINDOW_STEPS (resilience/supervisor.py)."),
    "MXNET_RESTART_WINDOW_STEPS": (
        int, 0,
        "Sliding step window the restart budget applies over (0 = the "
        "whole run, the old FaultTolerantRunner semantics)."),
    "MXNET_RESTART_BACKOFF_BASE": (
        float, 1.0,
        "First-restart backoff delay in seconds (doubles per restart, "
        "jittered, capped at MXNET_RESTART_BACKOFF_MAX)."),
    "MXNET_RESTART_BACKOFF_MAX": (
        float, 60.0,
        "Backoff delay ceiling between supervisor restarts."),
    "MXNET_HEALTH_TIMEOUT": (
        float, 60.0,
        "Wall-clock bound on the post-failure device health probe (2 x 2 "
        "on each CUDA device, read back); a hung probe reports 'error: "
        "timeout' instead of blocking the supervisor."),
    "MXNET_DIST_COLLECTIVE_TIMEOUT": (
        float, 0.0,
        "Deadline (seconds) of dist.run_with_deadline: a collective past "
        "it raises a transient-classified DistTimeout into the "
        "supervisor instead of hanging this rank (dist/timeouts.py; 0 = "
        "no deadline)."),
    "MXNET_OBS": (
        bool, False,
        "Arm mx.obs: the step cadence (obs_step_seconds), per-step "
        "attribution, SLO gauges and payload publishing (obs/).  Off = "
        "one flag check per hook."),
    "MXNET_OBS_PUBLISH_SECONDS": (
        float, 5.0,
        "Minimum interval between obs payload publishes into the "
        "membership KV (obs/core.py)."),
    "MXNET_OBS_SLO_FAST_SECONDS": (
        float, 300.0,
        "Fast burn-rate window of SLO evaluation (PAGE/WARN need both "
        "windows over threshold; obs/slo_engine.py)."),
    "MXNET_OBS_SLO_SLOW_SECONDS": (
        float, 3600.0,
        "Slow burn-rate window of SLO evaluation."),
    "MXNET_OBS_ATTRIBUTION": (
        str, None,
        "Append one JSON line of per-step time attribution (phase "
        "shares, data wait, MFU estimate) to this path."),
    "MXNET_OBS_PEAK_TFLOPS": (
        float, None,
        "Per-card peak TFLOP/s of the attribution MFU, overriding the "
        "table of NVIDIA cards (obs/attribution.py; an unknown card "
        "reports mfu null)."),
}


def describe():
    """Human-readable table of every variable the port reads (the
    env_var.md equivalent)."""
    lines = ["%-38s %-8s %-22s %s" % ("Variable", "Type", "Default", "Doc")]
    for name, (typ, default, doc) in sorted(ENV_VARS.items()):
        lines.append("%-38s %-8s %-22s %s"
                     % (name, typ.__name__, repr(default), doc))
    return "\n".join(lines)


def current():
    """{name: effective value} for every registered variable."""
    return {name: get_env(name, typ, default)
            for name, (typ, default, _doc) in ENV_VARS.items()}


def check_unknown(warn=True):
    """The ``MXNET_*`` variables set in the environment that the port does
    not read: typos, or knobs of the reference or the JAX package that do
    nothing here."""
    unknown = sorted(k for k in os.environ
                     if k.startswith("MXNET_") and k not in ENV_VARS)
    if unknown and warn:
        import warnings

        warnings.warn(
            "unrecognized MXNET_* environment variables (no effect in "
            "mxnet_tpu_torch): %s; see mxnet_tpu_torch.config.describe()"
            % unknown, stacklevel=2)
    return unknown
