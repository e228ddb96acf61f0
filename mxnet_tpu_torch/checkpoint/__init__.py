"""mx.checkpoint of the port: async, sharded, crash-consistent checkpoints.

Counterpart of ``mxnet_tpu/checkpoint/``, writing and reading the same
``mx-checkpoint-v1`` directories, so a step saved by either package
restores in the other.  One ``CheckpointManager`` gives:

- **async saves**: ``save_async(step, tree)`` pays only the device->host
  snapshot on the training thread; serialize, fsync and the atomic publish
  run on a background writer with bounded in-flight saves.
  ``SaveFuture.result()`` / ``manager.wait()`` join.
- **sharded layout**: one ``.npy`` per large leaf, small leaves bundled
  into shard-group ``.npz`` files, all described by a JSON manifest (tree
  spec, shapes, dtypes, per-file CRC32, step, framework version), so a
  restore can read a subset (``load_leaves``).
- **crash consistency**: write-to-temp, per-file fsync, a ``COMMITTED``
  marker and an atomic rename; an overwrite parks the old directory at
  ``*.prev`` until the new one is published; transient I/O errors are
  retried with backoff; ``validate()`` checksums every shard and can
  quarantine torn or corrupt directories.
- **retention**: ``max_keep`` rolling GC with ``keep_every`` pinning,
  ``latest_step()``, and ``restore()`` onto the caller's device.

Entry points elsewhere route here: ``gluon.Block.save_checkpoint``,
``gluon.Trainer.save_checkpoint``/``load_checkpoint`` (params, optimizer
state and step in one atomic unit), ``parallel.FusedTrainer
.save_checkpoint``, ``callback.do_checkpoint`` and ``serve.ModelRunner(
root=)``.  Every save and restore feeds the ``checkpoint_*`` telemetry.
"""
from __future__ import annotations

from .layout import (COMMITTED, DEFAULT_GROUP_BYTES, FORMAT, MANIFEST,
                     atomic_file, leaf_paths, tree_from_spec, tree_spec)
from .manager import CheckpointManager, cached_manager, latest_step
from .writer import AsyncWriter, SaveFuture

__all__ = [
    "CheckpointManager", "SaveFuture", "AsyncWriter", "cached_manager",
    "latest_step",
    "tree_spec", "tree_from_spec", "leaf_paths", "atomic_file",
    "FORMAT", "MANIFEST", "COMMITTED", "DEFAULT_GROUP_BYTES",
]
