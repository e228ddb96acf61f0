"""CheckpointManager -- the mx.checkpoint front-end.

Counterpart of ``mxnet_tpu/checkpoint/manager.py``, over torch tensors.
Restored leaves are tensors on the caller's device: ``ctx`` (an mx
Context or a ``torch.device``), else a template leaf's own device, else
the current context (the card, which raises where there is none; pass
``ctx=mx.cpu()``).  Resharding a restore over a device mesh is not
ported (``ROADMAP.md`` Queue 1 item 7).

Crash-consistency protocol (two-phase commit):

1. serialize every shard into a hidden ``.saving-*`` temp dir, fsync
   each file;
2. write ``MANIFEST.json`` (fsync), then the ``COMMITTED`` marker
   (fsync) — the marker is the phase boundary: a directory without it
   is torn by definition;
3. fsync the temp dir, then atomically rename it into place.  When the
   step already exists (overwrite-in-place), the old dir is first
   renamed to ``<dir>.prev`` — never deleted before the new data is in
   place — and ``_recover()`` resolves either rename order after a
   crash, so the latest restorable checkpoint is never lost (the
   ``shutil.rmtree``-then-``rename`` crash window of the old
   ``elastic.CheckpointManager`` is closed).

Transient ``OSError`` during commit is retried with exponential
backoff (``io_retries`` / ``retry_backoff``).  ``validate()`` re-reads
every shard and compares sizes + CRC32 against the manifest,
optionally quarantining corrupt directories (renamed to ``*.corrupt``
so ``steps()``/``latest_step()`` can never hand them to a restore).

Async saves: ``save_async(step, tree)`` does ONLY the device->host
snapshot on the calling thread, then hands serialize+commit to a
background writer with bounded in-flight saves; it returns a
``SaveFuture`` (``result()``/``done()``), and ``wait()`` blocks until
the queue drains, returning the last committed path.  ``save()`` is
the synchronous form (same code path, immediately awaited).

Every phase is measured through ``mx.telemetry``: snapshot vs.
serialize vs. commit latency histograms, bytes written/read counters,
async queue depth, retry and outcome counters.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as _np

import torch

from ..base import MXNetError
from .. import telemetry, trace
from ..resilience import inject as _inject
from . import layout
from .writer import AsyncWriter

__all__ = ["CheckpointManager", "cached_manager", "latest_step"]


def _scan_steps(root, prefix):
    """Sorted [(step, dirname)] for every directory under ``root`` named
    like a step (``<prefix>-<digits>``), committed or not — the ONE
    place the on-disk naming scheme is parsed."""
    out = []
    for name in os.listdir(root):
        if not name.startswith(prefix + "-"):
            continue
        tail = name[len(prefix) + 1:]
        if not tail.isdigit():
            continue
        d = os.path.join(root, name)
        if os.path.isdir(d):
            out.append((int(tail), d))
    return sorted(out)


def latest_step(root, prefix="ckpt"):
    """Latest COMMITTED step under ``root``, or None.

    Read-only probe: no manager construction, no crash recovery, no
    directory creation — safe to call against a root another process
    is actively writing.  This is what ``mx.serve`` hot-swap polling
    and ``tools/diagnose.py`` use to peek at a serving root."""
    root = os.fspath(root)
    if not os.path.isdir(root):
        return None
    committed = [s for s, d in _scan_steps(root, prefix)
                 if _is_committed(d)]
    return committed[-1] if committed else None


def cached_manager(owner, root, **manager_kwargs):
    """Get-or-create a CheckpointManager cached on ``owner`` (in its
    ``_ckpt_managers`` dict, created on demand), keyed by the root's
    absolute path.  The shared per-trainer/-block cache policy:
    repeated saves reuse one background writer (and one bounded
    in-flight queue) instead of re-running crash recovery per call.

    A manager cached by a kwargs-less call (e.g. ``load_checkpoint``)
    is REPLACED when a later call passes explicit kwargs — a restore
    must not pin default retention against a save that asked for
    ``max_keep=None``.  Two explicit-but-conflicting calls keep the
    first manager and log a warning once."""
    import logging

    cache = getattr(owner, "_ckpt_managers", None)
    if cache is None:
        cache = owner._ckpt_managers = {}
    key = os.path.abspath(os.fspath(root))
    mgr = cache.get(key)
    if mgr is None or (manager_kwargs
                       and not getattr(mgr, "_cache_kwargs", None)):
        if mgr is not None:
            mgr.wait()  # don't orphan in-flight saves of the old manager
        mgr = CheckpointManager(root, **manager_kwargs)
        mgr._cache_kwargs = dict(manager_kwargs)
        cache[key] = mgr
    elif manager_kwargs and manager_kwargs != mgr._cache_kwargs:
        if not getattr(mgr, "_cache_kwargs_warned", False):
            mgr._cache_kwargs_warned = True
            logging.getLogger("mxnet_tpu.checkpoint").warning(
                "checkpoint manager for %s was created with %r; "
                "ignoring conflicting kwargs %r on a later call",
                key, mgr._cache_kwargs, manager_kwargs)
    return mgr


def _is_committed(d):
    """True when ``d`` is a trustworthy checkpoint dir: v1 (COMMITTED
    marker) or the legacy elastic layout (meta.json + leaves.npz)."""
    if os.path.isfile(os.path.join(d, layout.COMMITTED)):
        return True
    return (os.path.isfile(os.path.join(d, "meta.json"))
            and os.path.isfile(os.path.join(d, "leaves.npz")))


class CheckpointManager:
    """Async, sharded, crash-consistent checkpoints of a tree of tensors.

    Parameters
    ----------
    root : str — checkpoint directory (created if absent).
    max_keep : int or None — rolling retention; None keeps everything.
    keep_every : int or None — steps divisible by this survive the
        rolling GC (sparse long-horizon history).
    prefix : str — directory name prefix (``<prefix>-<step:08d>``).
    group_bytes : int — leaves smaller than this share a .npz shard.
    io_retries / retry_backoff : transient-OSError retry policy.
    max_inflight : int — bound on queued async saves (backpressure).
    recover : bool — resolve interrupted commits at construction
        (promote/discard ``*.prev``, sweep stale temp dirs).  Pass
        False for read-only auditing of a root another process may be
        writing.
    """

    def __init__(self, root, max_keep=3, keep_every=None, prefix="ckpt",
                 group_bytes=layout.DEFAULT_GROUP_BYTES, io_retries=3,
                 retry_backoff=0.1, max_inflight=2, recover=True):
        # max_keep<=0 means "keep everything", matching the old elastic
        # manager (steps[:-0] deleted nothing)
        self._max_keep = int(max_keep) \
            if max_keep is not None and int(max_keep) > 0 else None
        self._root = os.fspath(root)
        self._keep_every = None if keep_every is None else int(keep_every)
        self._prefix = prefix
        self._group_bytes = int(group_bytes)
        self._io_retries = max(1, int(io_retries))
        self._retry_backoff = float(retry_backoff)
        os.makedirs(self._root, exist_ok=True)
        self._writer = AsyncWriter(self._commit, max_inflight=max_inflight)
        if recover:
            self._recover()

    # -- paths / discovery --------------------------------------------------
    @property
    def root(self):
        return self._root

    def _dir_for(self, step):
        return os.path.join(self._root, "%s-%08d" % (self._prefix, step))

    def _scan(self):
        """[(step, dirname)] for every directory named like a step,
        committed or not."""
        return _scan_steps(self._root, self._prefix)

    def steps(self):
        """Sorted steps with a COMMITTED (or legacy) checkpoint; torn or
        quarantined directories are never listed."""
        return [s for s, d in self._scan() if _is_committed(d)]

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def latest_path(self):
        s = self.latest_step()
        return None if s is None else self._dir_for(s)

    # -- crash recovery -----------------------------------------------------
    # temp dirs younger than this survive _recover: they may belong to
    # another manager's writer actively committing into the same root
    _STALE_TMP_SECONDS = 3600.0

    def _recover(self):
        """Resolve interrupted commits: STALE orphan temp dirs are swept
        (fresh ones may be another live writer's in-flight commit), and
        a ``<dir>.prev`` left by a crash mid-overwrite is promoted back
        when the new dir never landed (else discarded)."""
        now = time.time()
        for name in sorted(os.listdir(self._root)):
            p = os.path.join(self._root, name)
            if not os.path.isdir(p):
                continue
            if name.startswith(".saving-"):
                # liveness = newest mtime INSIDE the dir: a commit
                # streaming one big shard for an hour never refreshes
                # the directory's own mtime
                try:
                    newest = os.path.getmtime(p)
                    for child in os.listdir(p):
                        newest = max(newest, os.path.getmtime(
                            os.path.join(p, child)))
                except OSError:
                    continue
                if now - newest > self._STALE_TMP_SECONDS:
                    shutil.rmtree(p, ignore_errors=True)
            elif name.endswith(".prev"):
                final = p[:-len(".prev")]
                if _is_committed(final) or not _is_committed(p):
                    shutil.rmtree(p, ignore_errors=True)
                else:
                    os.rename(p, final)

    # -- save ---------------------------------------------------------------
    def _snapshot(self, tree):
        """Critical-path phase: structure + device->host copies only."""
        with trace.span("checkpoint_snapshot", hist=False,
                        cat="checkpoint"):
            t0 = time.perf_counter()
            spec = layout.tree_spec(tree)
            leaves = layout.tree_leaves(tree)
            dtypes = [layout.dtype_name(v) for v in leaves]
            host = layout.snapshot_leaves(leaves)
            if telemetry.ENABLED:
                telemetry.CHECKPOINT_SNAPSHOT_SECONDS.observe(
                    time.perf_counter() - t0)
        return spec, host, dtypes

    def save(self, step, tree):
        """Synchronous save: snapshot + commit, returns the final dir."""
        return self.save_async(step, tree).result()

    def save_async(self, step, tree):
        """Snapshot on the calling thread, serialize+commit in the
        background.  Returns a ``SaveFuture``; blocks only when
        ``max_inflight`` saves are already queued.  The caller's trace
        context travels with the payload, so the background serialize/
        commit spans join the step that triggered the save."""
        spec, host, dtypes = self._snapshot(tree)
        return self._writer.submit(int(step),
                                   (spec, host, dtypes, trace.current()))

    def wait(self):
        """Block until every queued async save commits; re-raises the
        first failure.  Returns the last committed path (None if no
        save ever committed)."""
        return self._writer.wait()

    def _commit(self, step, payload):
        """Background phase: serialize, durably write, atomically
        publish.  Retries transient OSErrors with backoff.  Runs under
        the submitting step's trace context (carried in the payload),
        so the writer thread's spans share the step's trace id."""
        spec, host, dtypes, tctx = payload
        with trace.use(tctx):
            return self._commit_traced(step, spec, host, dtypes)

    def _commit_traced(self, step, spec, host, dtypes):
        delay = self._retry_backoff
        for attempt in range(self._io_retries):
            try:
                with trace.span("checkpoint_save", hist=False,
                                cat="checkpoint",
                                args={"step": int(step),
                                      "attempt": attempt}), \
                        trace.watchdog.watch("checkpoint_commit"):
                    path = self._commit_once(step, spec, host, dtypes)
                if telemetry.ENABLED:
                    telemetry.CHECKPOINT_SAVES.labels(result="ok").inc()
                # the commit is durable; GC is best-effort and must not
                # push an already-published save back into the retry loop
                try:
                    self._gc()
                except OSError:
                    pass
                return path
            except OSError:
                if attempt + 1 >= self._io_retries:
                    if telemetry.ENABLED:
                        telemetry.CHECKPOINT_SAVES.labels(
                            result="error").inc()
                    raise
                if telemetry.ENABLED:
                    telemetry.CHECKPOINT_RETRIES.inc()
                time.sleep(delay)
                delay *= 2
            except BaseException:
                if telemetry.ENABLED:
                    telemetry.CHECKPOINT_SAVES.labels(result="error").inc()
                raise

    def _commit_once(self, step, spec, host, dtypes=None):
        from .. import __version__

        # mx.resilience drill site (checkpoint writer IO): an :io fault
        # here exercises the retry-with-backoff loop above; nothing is
        # on disk yet, so the previous checkpoint is untouched
        _inject.fire("checkpoint_commit")
        t_ser = time.perf_counter()
        entries, writers = layout.plan_shards(host, self._group_bytes,
                                              dtypes)
        tmp = tempfile.mkdtemp(dir=self._root, prefix=".saving-")
        final = self._dir_for(step)
        prev = final + ".prev"
        parked = False
        try:
            with trace.span("checkpoint_serialize", hist=False,
                            cat="checkpoint"):
                file_meta, total = {}, 0
                # shards stream straight into the temp dir (the CRC
                # re-reads what landed on disk) — serialization never
                # doubles the host snapshot in memory
                for fname, writer in writers:
                    crc, n = layout.write_stream_durable(
                        os.path.join(tmp, fname), writer)
                    file_meta[fname] = {"crc32": crc, "nbytes": n}
                    total += n
                if telemetry.ENABLED:
                    telemetry.CHECKPOINT_SERIALIZE_SECONDS.observe(
                        time.perf_counter() - t_ser)
            t_commit = time.perf_counter()
            with trace.span("checkpoint_commit", hist=False,
                            cat="checkpoint", args={"step": int(step)}):
                manifest = layout.build_manifest(
                    step, spec, host, entries, file_meta, __version__,
                    dtypes=dtypes)
                mbytes = json.dumps(manifest, sort_keys=True).encode()
                layout.write_file_durable(
                    os.path.join(tmp, layout.MANIFEST), mbytes)
                # mx.resilience drill site: an :abort fault here is the
                # "writer killed mid-commit" drill — shards + manifest
                # durable, marker never lands, the dir is torn by
                # definition and discovery must skip it
                _inject.fire("checkpoint_marker")
                # phase 2: the marker makes the dir trustworthy;
                # everything above is already durable when this lands
                marker = json.dumps(
                    {"step": int(step),
                     "n_files": len(file_meta) + 1}).encode()
                layout.write_file_durable(
                    os.path.join(tmp, layout.COMMITTED), marker)
                layout.fsync_dir(tmp)

                if os.path.exists(final):
                    if os.path.exists(prev):
                        shutil.rmtree(prev)
                    os.rename(final, prev)  # old copy survives until ...
                    parked = True
                    os.rename(tmp, final)   # ... the new one publishes
                else:
                    os.rename(tmp, final)
                layout.fsync_dir(self._root)
                # also sweeps a .prev parked by an earlier attempt of
                # THIS commit that failed between its two renames and
                # retried
                shutil.rmtree(prev, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            # a failed publish must not leave the step parked at .prev
            # (invisible to steps()/restore() until a future _recover);
            # put the old copy back where discovery can see it
            if parked and not os.path.exists(final) \
                    and os.path.exists(prev):
                try:
                    os.rename(prev, final)
                except OSError:
                    pass
            raise
        if telemetry.ENABLED:
            telemetry.CHECKPOINT_COMMIT_SECONDS.observe(
                time.perf_counter() - t_commit)
            telemetry.CHECKPOINT_BYTES.labels(direction="write").inc(
                total + len(mbytes))
        return final

    # -- retention ----------------------------------------------------------
    def _gc(self):
        if self._max_keep is None:
            return
        steps = self.steps()
        keep = set(steps[max(0, len(steps) - self._max_keep):])
        for s in steps:
            if s in keep:
                continue
            if self._keep_every and s % self._keep_every == 0:
                continue
            shutil.rmtree(self._dir_for(s), ignore_errors=True)

    # -- validation / quarantine --------------------------------------------
    def validate(self, step=None, quarantine=False):
        """Integrity-check checkpoint(s): manifest parses, every shard
        exists with the manifest's size and CRC32.  Returns
        {step: {"ok", "errors", "nbytes", "legacy"}}.  With
        ``quarantine=True`` bad dirs are renamed to ``*.corrupt`` so
        discovery and restore never see them again."""
        targets = self._scan() if step is None else \
            [(int(step), self._dir_for(step))]
        report = {}
        for s, d in targets:
            info = self._validate_dir(d)
            report[s] = info
            if quarantine and not info["ok"] and os.path.isdir(d):
                q = d + ".corrupt"
                n = 0
                while os.path.exists(q):
                    n += 1
                    q = "%s.corrupt.%d" % (d, n)
                os.rename(d, q)
                info["quarantined"] = q
        return report

    def _validate_dir(self, d):
        errors, total = [], 0
        if not os.path.isdir(d):
            return {"ok": False, "errors": ["missing directory"],
                    "nbytes": 0, "legacy": False}
        legacy = not os.path.isfile(os.path.join(d, layout.MANIFEST))
        if legacy:
            legacy_files = [os.path.join(d, f)
                            for f in ("meta.json", "leaves.npz")]
            if all(os.path.isfile(f) for f in legacy_files):
                for f in legacy_files:
                    total += os.path.getsize(f)
                return {"ok": True, "errors": [], "nbytes": total,
                        "legacy": True}
            if os.path.isfile(os.path.join(d, layout.COMMITTED)):
                return {"ok": False,
                        "errors": ["COMMITTED marker without "
                                   "MANIFEST.json (corrupt)"],
                        "nbytes": 0, "legacy": False}
            return {"ok": False, "errors": ["no COMMITTED marker (torn "
                                            "or foreign directory)"],
                    "nbytes": 0, "legacy": False}
        if not os.path.isfile(os.path.join(d, layout.COMMITTED)):
            errors.append("no COMMITTED marker (torn save)")
        try:
            with open(os.path.join(d, layout.MANIFEST)) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as exc:
            errors.append("manifest unreadable: %s" % exc)
            return {"ok": False, "errors": errors, "nbytes": 0,
                    "legacy": False}
        for fname, meta in sorted(manifest.get("files", {}).items()):
            p = os.path.join(d, fname)
            if not os.path.isfile(p):
                errors.append("%s: missing shard" % fname)
                continue
            size = os.path.getsize(p)
            total += size
            if size != meta["nbytes"]:
                errors.append("%s: size %d != manifest %d"
                              % (fname, size, meta["nbytes"]))
                continue
            if layout.file_crc32(p) != meta["crc32"]:
                errors.append("%s: checksum mismatch (corrupt shard)"
                              % fname)
        return {"ok": not errors, "errors": errors, "nbytes": total,
                "legacy": False}

    # -- restore ------------------------------------------------------------
    def manifest(self, step=None):
        """Parsed MANIFEST.json of ``step`` (default latest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise MXNetError("no checkpoints in %s" % self._root)
        path = os.path.join(self._dir_for(step), layout.MANIFEST)
        if not os.path.isfile(path):
            raise MXNetError(
                "step %d uses the legacy single-blob layout (no "
                "MANIFEST.json); restore() handles it, manifest-based "
                "APIs do not" % step)
        with open(path) as f:
            return json.load(f)

    def _read_step(self, step):
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise MXNetError("no checkpoints in %s" % self._root)
        d = self._dir_for(step)
        if not os.path.isdir(d):
            raise MXNetError("no checkpoint for step %d in %s"
                             % (step, self._root))
        if not _is_committed(d):
            raise MXNetError(
                "checkpoint for step %d is torn (no COMMITTED marker) — "
                "run validate(quarantine=True) and restore an earlier "
                "step" % step)
        return step, d

    def _load_leaves_v1(self, d, manifest, select=None):
        """Read leaves as numpy (bf16 ones as their uint16 bits), touching
        only the shard files the selection needs (partial restore)."""
        wanted = []
        for i, e in enumerate(manifest["leaves"]):
            if select is None or select(e["name"]):
                wanted.append((i, e))
        by_file = {}
        for i, e in wanted:
            by_file.setdefault(e["file"], []).append((i, e))
        out, total = {}, 0
        for fname, group in sorted(by_file.items()):
            p = os.path.join(d, fname)
            if fname.endswith(".npy"):
                (i, e), = group
                out[i] = layout.host_array(_np.load(p, allow_pickle=False),
                                           e["dtype"])
                total += out[i].nbytes
            else:
                with _np.load(p, allow_pickle=False) as npz:
                    for i, e in group:
                        out[i] = layout.host_array(npz[e["key"]],
                                                   e["dtype"])
                        total += out[i].nbytes
        if telemetry.ENABLED and total:
            telemetry.CHECKPOINT_BYTES.labels(direction="read").inc(total)
        return [(i, out[i]) for i, _ in wanted]

    def load_leaves(self, step=None, select=None):
        """Partial restore: {leaf_name: numpy array} for leaves whose
        '/'-joined name passes ``select`` (a predicate; None = all); a
        bf16 leaf comes as its uint16 bits (the manifest names its
        dtype).  Only the shard files backing the selection are read."""
        step, d = self._read_step(step)
        if not os.path.isfile(os.path.join(d, layout.MANIFEST)):
            raise MXNetError("step %d uses the legacy single-blob layout; "
                             "partial reads need a v1 checkpoint" % step)
        manifest = self.manifest(step)
        pairs = self._load_leaves_v1(d, manifest, select)
        names = [e["name"] for e in manifest["leaves"]]
        return {names[i]: v for i, v in pairs}

    def restore(self, template_tree=None, step=None, ctx=None):
        """Load checkpoint ``step`` (default latest); returns
        ``(step, tree)`` with torch tensors for leaves.

        With a ``template_tree``, leaves adopt the template's dtype and,
        where no ``ctx`` is given, the device of its tensor leaves.
        Without a template the structure is rebuilt from the manifest's
        spec (fresh-process resume) and every leaf keeps the dtype it was
        saved with.  ``ctx`` (an mx Context or a
        ``torch.device``) pins the leaves to one device; the default is
        the current context."""
        from ..context import Context, device_of

        step, d = self._read_step(step)
        legacy = not os.path.isfile(os.path.join(d, layout.MANIFEST))
        if legacy:
            with _np.load(os.path.join(d, "leaves.npz")) as npz:
                leaves = [npz["leaf_%d" % i] for i in range(len(npz.files))]
            dtypes = [str(v.dtype) for v in leaves]
            with open(os.path.join(d, "meta.json")) as f:
                spec = json.load(f).get("spec")
        else:
            manifest = self.manifest(step)
            leaves = [v for _, v in
                      self._load_leaves_v1(d, manifest, None)]
            dtypes = [e["dtype"] for e in manifest["leaves"]]
            spec = manifest["spec"]

        if telemetry.ENABLED:
            telemetry.CHECKPOINT_RESTORES.inc()

        if ctx is None or isinstance(ctx, Context):
            device = None if ctx is None else device_of(ctx)
        else:
            device = torch.device(ctx)

        def _default_device():
            return device if device is not None else device_of(None)

        if template_tree is None:
            if spec is None:
                raise MXNetError(
                    "checkpoint at step %d predates structure specs; "
                    "pass a template_tree" % step)
            dev = _default_device()
            it = iter(layout.to_tensor(v, dt, dev)
                      for v, dt in zip(leaves, dtypes))
            return step, layout.tree_from_spec(spec, it)

        tmpl_spec = layout.tree_spec(template_tree)
        tmpl_leaves = layout.tree_leaves(template_tree)
        if len(tmpl_leaves) != len(leaves):
            raise MXNetError(
                "checkpoint at step %d has %d leaves, template has %d -- "
                "the model/optimizer structure changed"
                % (step, len(leaves), len(tmpl_leaves)))
        if device is None:
            # a template leaf that is no tensor follows the tensor leaves
            device = next((layout._tensor_of(t).device for t in tmpl_leaves
                           if isinstance(layout._tensor_of(t),
                                         torch.Tensor)), None)
        new_leaves = []
        for v, dt, t in zip(leaves, dtypes, tmpl_leaves):
            if hasattr(t, "placements"):
                raise MXNetError(
                    "CheckpointManager.restore onto a sharded (mesh) "
                    "tensor is not ported (ROADMAP.md Queue 1 item 7)")
            t = layout._tensor_of(t)
            if isinstance(t, torch.Tensor):
                dev = t.device if ctx is None else device
                new_leaves.append(
                    layout.to_tensor(v, dt, dev).to(t.dtype))
            else:
                leaf = layout.to_tensor(v, dt, _default_device())
                if hasattr(t, "dtype"):
                    leaf = leaf.to(torch.from_numpy(
                        _np.zeros(0, _np.dtype(t.dtype))).dtype)
                new_leaves.append(leaf)
        return step, layout.tree_from_spec(tmpl_spec, iter(new_leaves))
