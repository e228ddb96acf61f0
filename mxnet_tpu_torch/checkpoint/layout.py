"""On-disk layout of ``mx.checkpoint``: sharded leaves and a JSON manifest.

Counterpart of ``mxnet_tpu/checkpoint/layout.py``; the format is the same
``mx-checkpoint-v1``, so a step written by either package restores in the
other.  A committed checkpoint directory looks like::

    ckpt-00000042/
        MANIFEST.json     # tree spec, per-leaf + per-file metadata
        COMMITTED         # two-phase marker, written LAST (fsync'd)
        leaf_00000.npy    # one file per large leaf ...
        group_0000.npz    # ... small leaves bundled per shard-group

The manifest carries what a restore needs without a live template (tree
spec, dtypes, shapes), what ``validate`` checks (per-file CRC32 and byte
sizes) and the provenance (step, wall time, framework version).  A
directory without the ``COMMITTED`` marker is torn by definition.

The tree spec follows the JAX flatten order, so either package's leaves
re-enter the other's trees unchanged: dicts in sorted key order, tuples
and lists by position (a tuple stays a tuple), ``None`` is structure with
no leaf.  Leaves are torch tensors, ``mx.nd`` NDArrays, numpy arrays or
Python scalars.

bfloat16 has no numpy type here (``ml_dtypes`` is not used): a bf16 leaf
is written as the JAX package writes an ``ml_dtypes.bfloat16`` array --
raw 2-byte ``<V2`` records, ``"dtype": "bfloat16"`` in the manifest -- and
read back through a 16-bit integer view.
"""
from __future__ import annotations

import os
import zlib

import numpy as _np
import torch

MANIFEST = "MANIFEST.json"
COMMITTED = "COMMITTED"
FORMAT = "mx-checkpoint-v1"
BFLOAT16 = "bfloat16"

# probed ONCE at import (single-threaded under the import lock): the
# os.umask(0)/restore dance is a process-global race if done per call
_UMASK = os.umask(0)
os.umask(_UMASK)

# leaves smaller than this are bundled into a shard-group .npz so a
# million tiny biases don't become a million files; larger leaves get a
# private .npy so partial restore never reads more than it needs
DEFAULT_GROUP_BYTES = 1 << 20

# the npy header ``ml_dtypes.bfloat16`` arrays carry
_BF16_DESCR = "<V2"


# ---------------------------------------------------------------------------
# tree spec (structure without code objects -- JSON-serializable)
# ---------------------------------------------------------------------------

def tree_spec(tree):
    """JSON-serializable structure of a tree of dict/list/tuple/None/
    leaves.  Dict keys are recorded in sorted order (JAX's flatten
    order); ``None`` is structure (no leaf)."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, dict):
        keys = sorted(tree.keys())
        return {"t": "dict", "k": keys,
                "v": [tree_spec(tree[k]) for k in keys]}
    if isinstance(tree, tuple):
        return {"t": "tuple", "v": [tree_spec(v) for v in tree]}
    if isinstance(tree, list):
        return {"t": "list", "v": [tree_spec(v) for v in tree]}
    return {"t": "leaf"}


def tree_leaves(tree):
    """The leaves of ``tree`` in the spec's (JAX's) flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree.keys())
                for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_from_spec(spec, leaves_iter):
    """Rebuild a tree from its spec, drawing leaves in flatten order."""
    t = spec["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: tree_from_spec(v, leaves_iter)
                for k, v in zip(spec["k"], spec["v"])}
    if t == "tuple":
        return tuple(tree_from_spec(v, leaves_iter) for v in spec["v"])
    if t == "list":
        return [tree_from_spec(v, leaves_iter) for v in spec["v"]]
    return next(leaves_iter)


def leaf_paths(spec, prefix=""):
    """Human-readable '/'-joined path per leaf, in flatten order --
    these name the leaves in the manifest and drive partial restore."""
    t = spec["t"]
    if t == "leaf":
        return [prefix or "."]
    if t == "none":
        return []
    out = []
    if t == "dict":
        for k, sub in zip(spec["k"], spec["v"]):
            # escape separator chars so a flat key containing '/' can't
            # collide with a genuinely nested path in the manifest
            k = str(k).replace("\\", "\\\\").replace("/", "\\/")
            p = "%s/%s" % (prefix, k) if prefix else k
            out.extend(leaf_paths(sub, p))
    else:  # tuple / list
        for i, sub in enumerate(spec["v"]):
            p = "%s/%d" % (prefix, i) if prefix else str(i)
            out.extend(leaf_paths(sub, p))
    return out


# ---------------------------------------------------------------------------
# snapshot: device -> host copies that never alias live memory
# ---------------------------------------------------------------------------

def snapshot_leaf(leaf):
    """Host copy of one leaf (``snapshot_leaves`` of one)."""
    return snapshot_leaves([leaf])[0]


def _tensor_of(leaf):
    data = getattr(leaf, "_data", None)       # an mx.nd NDArray
    return data if isinstance(data, torch.Tensor) else leaf


def dtype_name(leaf):
    """The manifest's dtype name of ``leaf`` (numpy's, or ``bfloat16``)."""
    leaf = _tensor_of(leaf)
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return BFLOAT16
        return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(_np.asarray(leaf).dtype)


def snapshot_leaves(leaves):
    """Host copies of ``leaves`` as numpy arrays (a bf16 tensor as its
    uint16 bits) -- the only work an async save does on the caller's
    thread.

    A result never aliases memory the caller can still change: a CPU
    tensor's ``numpy()`` and ``np.asarray`` of an array are views, so both
    are copied.  Tensors on the card are copied into page-locked host
    memory on the current stream, and the function returns only once that
    stream has passed the copies: an update enqueued after the snapshot
    (the foreach and grouped updates write parameters in place) cannot
    reach the copied bytes, and a snapshot never blends two steps."""
    host, pending = [], False
    for leaf in leaves:
        t = _tensor_of(leaf)
        if isinstance(t, torch.Tensor):
            t = t.detach()
            bf16 = t.dtype == torch.bfloat16
            if bf16:
                t = t.view(torch.int16)
            if t.device.type == "cpu":
                h = t.clone()
            else:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                pending = True
            arr = h.numpy()
            host.append(arr.view(_np.uint16) if bf16 else arr)
        else:
            host.append(_np.array(leaf, copy=True))
    if pending:
        torch.cuda.current_stream().synchronize()
    return host


# ---------------------------------------------------------------------------
# durable file primitives
# ---------------------------------------------------------------------------

def fsync_dir(path):
    """fsync a directory so renames/creates inside it are durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_file_durable(path, data):
    """Write bytes + fsync; returns (crc32, nbytes)."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    return zlib.crc32(data) & 0xFFFFFFFF, len(data)


def write_stream_durable(path, writer):
    """Stream ``writer(fileobj)`` into ``path`` + fsync, then CRC what
    actually landed on disk.  Returns (crc32, nbytes)."""
    with open(path, "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())
    return file_crc32(path), os.path.getsize(path)


def atomic_file(path, data):
    """Crash-consistent single-file write: temp + fsync + atomic rename,
    behind ``nd.save`` and ``Block.save_parameters``: a crash mid-write
    never truncates an existing file at ``path``.

    ``data`` is bytes or a callable ``writer(fileobj)`` streaming into the
    temp file.  The temp name comes from ``mkstemp``, so concurrent saves
    to one path never share a temp file.  A symlink destination is
    resolved first, so the target is replaced."""
    import tempfile

    path = os.path.realpath(os.fspath(path))
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(
        dir=d, prefix=".%s.tmp-" % os.path.basename(path))
    try:
        # mkstemp creates 0600; restore the umask-honoring mode a plain
        # open() would have produced so shared readers keep working
        os.fchmod(fd, 0o666 & ~_UMASK)
        with os.fdopen(fd, "wb") as f:
            if callable(data):
                data(f)
            else:
                f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
        fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _sweep_stale_tmp(d, os.path.basename(path))
    return path


def _sweep_stale_tmp(d, basename, max_age=3600.0):
    """Best-effort removal of orphan ``.{basename}.tmp-*`` files a crashed
    earlier save left behind (fresh temps may belong to a live writer)."""
    import time

    prefix = ".%s.tmp-" % basename
    try:
        now = time.time()
        for name in os.listdir(d):
            if not name.startswith(prefix):
                continue
            p = os.path.join(d, name)
            try:
                if now - os.path.getmtime(p) > max_age:
                    os.unlink(p)
            except OSError:
                pass
    except OSError:
        pass


def file_crc32(path, chunk=1 << 20):
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            crc = zlib.crc32(b, crc)
    return crc & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# npy / npz codec (numpy's, with the bf16 header)
# ---------------------------------------------------------------------------

def write_npy(f, arr, dtype=None):
    """``np.save(f, arr)``; with ``dtype == 'bfloat16'`` the uint16
    ``arr`` is written as ``ml_dtypes.bfloat16`` writes (``<V2``)."""
    from numpy.lib import format as npf

    if dtype != BFLOAT16:
        _np.save(f, arr, allow_pickle=False)
        return
    arr = _np.ascontiguousarray(arr)
    npf.write_array_header_1_0(f, {"descr": _BF16_DESCR,
                                   "fortran_order": False,
                                   "shape": arr.shape})
    f.write(arr.tobytes())


def write_npz(f, named, dtypes=None):
    """``np.savez(f, **named)`` (stored, zip64), bf16 members by
    ``write_npy``'s rule (``dtypes``: {key: name})."""
    import zipfile

    dtypes = dtypes or {}
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in named.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                write_npy(fid, arr, dtypes.get(key))


def host_array(arr, dtype):
    """A loaded leaf as numpy, bf16 ones as their uint16 bits."""
    if dtype == BFLOAT16:
        return arr.view(_np.uint16)
    return arr


def to_tensor(arr, dtype, device):
    """A loaded leaf (``host_array`` form) as a tensor of its saved dtype
    on ``device``."""
    arr = _np.require(arr, requirements="C")   # keeps a 0-d shape
    if dtype == BFLOAT16:
        t = torch.from_numpy(arr.view(_np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


# ---------------------------------------------------------------------------
# manifest build / plan
# ---------------------------------------------------------------------------

def plan_shards(host_leaves, group_bytes=DEFAULT_GROUP_BYTES, dtypes=None):
    """Assign each leaf to a file: big leaves get a private .npy,
    consecutive small leaves share a group .npz capped at roughly
    ``group_bytes`` each.  Returns (leaf_entries, shard_writers) where
    leaf_entries[i] = {file, key?} and shard_writers = [(fname, writer)]
    with ``writer(fileobj)`` streaming the shard.  ``dtypes`` gives each
    leaf's manifest dtype name (bf16 leaves take the ``<V2`` header)."""
    dtypes = dtypes or [str(a.dtype) for a in host_leaves]
    entries = [None] * len(host_leaves)
    writers = []
    group, group_dt, group_idx = {}, {}, []
    group_size = 0
    n_groups = 0

    def _npy_writer(arr, dtype):
        return lambda f: write_npy(f, arr, dtype)

    def _npz_writer(named, named_dt):
        return lambda f: write_npz(f, named, named_dt)

    def flush_group():
        nonlocal group, group_dt, group_idx, group_size, n_groups
        if not group:
            return
        fname = "group_%04d.npz" % n_groups
        n_groups += 1
        writers.append((fname, _npz_writer(group, group_dt)))
        for i in group_idx:
            entries[i]["file"] = fname
        group, group_dt, group_idx = {}, {}, []
        group_size = 0

    for i, arr in enumerate(host_leaves):
        if arr.nbytes >= group_bytes:
            fname = "leaf_%05d.npy" % i
            writers.append((fname, _npy_writer(arr, dtypes[i])))
            entries[i] = {"file": fname}
        else:
            if group and group_size + arr.nbytes > group_bytes:
                flush_group()
            entries[i] = {"key": "l%d" % i}  # file filled at flush
            group["l%d" % i] = arr
            group_dt["l%d" % i] = dtypes[i]
            group_idx.append(i)
            group_size += arr.nbytes
    flush_group()
    return entries, writers


def build_manifest(step, spec, host_leaves, shard_entries, file_meta,
                   version, extra=None, dtypes=None):
    import time

    dtypes = dtypes or [str(a.dtype) for a in host_leaves]
    names = leaf_paths(spec)
    leaves = []
    for i, arr in enumerate(host_leaves):
        e = dict(shard_entries[i])
        e.update({"name": names[i] if i < len(names) else "leaf_%d" % i,
                  "shape": list(arr.shape), "dtype": dtypes[i],
                  "nbytes": int(arr.nbytes)})
        leaves.append(e)
    m = {"format": FORMAT, "framework_version": version,
         "step": int(step), "time": time.time(),
         "n_leaves": len(host_leaves), "spec": spec,
         "leaves": leaves, "files": file_meta}
    if extra:
        m.update(extra)
    return m
