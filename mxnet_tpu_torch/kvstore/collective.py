"""Gradient bucket planning for collectives.

Counterpart of the planner half of ``mxnet_tpu/kvstore/collective.py``
(``default_bucket_bytes``, ``plan_buckets``, ``observe_bucket_fill``).  A
captured training step (``step/capture.py``) plans its gradients into
buckets; in a world of one each bucket's reduction is the identity, so
nothing is reduced and no fill is observed.  The stores and their
all-reduce wait for the multi-card slice.
"""
from __future__ import annotations

from .. import telemetry as _tel
from ..base import get_env

__all__ = ["default_bucket_bytes", "plan_buckets", "observe_bucket_fill"]


def default_bucket_bytes():
    """How many bytes of gradients fuse into one collective
    (``MXNET_KVSTORE_BUCKET_BYTES``, default 4 MiB), read per call."""
    return int(get_env("MXNET_KVSTORE_BUCKET_BYTES", int, 4 << 20))


def plan_buckets(sizes_dtypes, bucket_bytes=None):
    """``[(nbytes, dtype_str), ...]`` in push order -> list of index
    buckets, each reduced by one collective.

    Deterministic and order-preserving, so every rank plans alike.
    Buckets are per dtype (a flat concat needs one dtype) and close once
    they reach ``bucket_bytes``; an array larger than the bound gets a
    bucket of its own."""
    if bucket_bytes is None:
        bucket_bytes = default_bucket_bytes()
    plan, bucket, nbytes, last_dtype = [], [], 0, None
    for i, (size, dtype) in enumerate(sizes_dtypes):
        if bucket and last_dtype != dtype:
            plan.append(bucket)
            bucket, nbytes = [], 0
        last_dtype = dtype
        bucket.append(i)
        nbytes += size
        if nbytes >= bucket_bytes:
            plan.append(bucket)
            bucket, nbytes = [], 0
    if bucket:
        plan.append(bucket)
    return plan


def observe_bucket_fill(bucket_nbytes, op=None, bucket_bytes=None):
    """Feed ``allreduce_bucket_fill`` from a plan's payload bytes per
    bucket, normalised by the ``bucket_bytes`` the plan was built with;
    ``op`` also counts the collectives (``collective_*``) under that
    label."""
    if not _tel.ENABLED:
        return
    denom = float(bucket_bytes if bucket_bytes else default_bucket_bytes())
    for nbytes in bucket_nbytes:
        _tel.ALLREDUCE_BUCKET_FILL.observe(nbytes / denom)
    if op is not None:
        _tel.COLLECTIVE_CALLS.labels(op=op).inc(len(bucket_nbytes))
        _tel.COLLECTIVE_BYTES.labels(op=op).inc(int(sum(bucket_nbytes)))
