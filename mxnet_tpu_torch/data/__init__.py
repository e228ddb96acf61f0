"""``mx.data``: the sharded streaming input pipeline.

Counterpart of ``mxnet_tpu/data/``: :class:`ShardSet` and
:class:`ReaderPool` (``reader.py``) read this host's slice of sharded
RecordIO files on reader threads; :class:`PrefetchRing` (``ring.py``)
stages the next batches onto the card from page-locked buffers on a side
stream while the current step runs; :class:`StreamLoader` (``loader.py``)
ties them together with a deterministic mid-epoch cursor.  The world is
one host unless ``torch.distributed`` is initialized or the launcher's
environment says otherwise (``world_coords``).
"""
from __future__ import annotations

from ..base import MXNetError, get_env
from .loader import StreamLoader, default_workers, live_loaders
from .reader import (ReaderPool, ShardSet, default_decode, world_coords)
from .ring import PrefetchRing, StagedBatch, default_depth, make_placer

__all__ = ["StreamLoader", "ShardSet", "ReaderPool", "PrefetchRing",
           "StagedBatch", "make_placer",
           "default_decode", "default_depth", "default_workers",
           "world_coords", "live_loaders", "require_sharded", "state"]


def require_sharded(what):
    """Guard for legacy whole-dataset iterators: in a multi-host world
    every host feeding itself the FULL dataset silently breaks
    data-parallel semantics (each global batch is seen world times).
    Raises a clear ``MXNetError`` naming the replacement; set
    ``MXNET_DATA_ALLOW_UNSHARDED=1`` to accept the duplication
    knowingly (debug/replicated-eval runs)."""
    num_hosts, _host = world_coords()
    if num_hosts <= 1:
        return
    if get_env("MXNET_DATA_ALLOW_UNSHARDED", bool, False):
        return
    raise MXNetError(
        "%s reads the whole dataset on every host — in this %d-host "
        "world each sample would be trained %d times per epoch.  Use "
        "mx.data.StreamLoader (sharded streaming + prefetch ring + "
        "checkpointed cursor), or set MXNET_DATA_ALLOW_UNSHARDED=1 to "
        "bypass this check deliberately." % (what, num_hosts, num_hosts))


def state():
    """Snapshot of every live loader."""
    return [ldr.stats() for ldr in live_loaders()]
