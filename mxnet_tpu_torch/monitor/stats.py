"""Per-group stat reductions for mx.monitor.

Counterpart of ``mxnet_tpu/monitor/stats.py``.  ``group_stats`` reduces a
parameter group's weights and gradients to one f32 vector on the device
(``STAT_FIELDS``: squared L2 norm, max |x| and nonfinite count of each),
so the host reads 24 bytes a group, not a tensor per parameter.  The
JAX package jits one program per group signature; here the reduction is
a few ``torch._foreach_*`` launches, the same ops inside a captured step
(``step/capture.py``) and on the stitched path.  Nonfinite elements are
counted, and left out of the norms and maxima.
"""
from __future__ import annotations

import math

import torch

from .. import telemetry as _tel

__all__ = ["group_stats", "unpack", "STAT_FIELDS"]

# layout of the stat vector
STAT_FIELDS = ("w_sq_sum", "w_max_abs", "w_nonfinite",
               "g_sq_sum", "g_max_abs", "g_nonfinite")


def _reduce3(arrays):
    """(sum of squares, max |x|, nonfinite count) over ``arrays``, f32
    0-dim tensors on their device."""
    af = [a.detach().to(torch.float32) for a in arrays]
    clean = [torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)
             for a in af]
    sq = torch.stack(torch._foreach_norm(clean)).square().sum()
    mx = torch.stack(torch._foreach_norm(clean, float("inf"))).max()
    nf = torch.stack([(~torch.isfinite(a)).sum() for a in af]).sum()
    return sq, mx, nf.to(torch.float32)


def group_stats(weights, grads):
    """The group's f32 stat vector, ordered as ``STAT_FIELDS``, on the
    device (nothing is read to the host here)."""
    if _tel.ENABLED:
        _tel.MONITOR_STAT_PROGRAMS.inc()
    return torch.stack(_reduce3(weights) + _reduce3(grads))


def unpack(vec):
    """A stat vector -> named float dict, with the norms (square roots of
    the squared sums, which add across groups)."""
    vals = [float(v) for v in vec]
    out = dict(zip(STAT_FIELDS, vals))
    out["w_norm"] = math.sqrt(max(out["w_sq_sum"], 0.0))
    out["g_norm"] = math.sqrt(max(out["g_sq_sum"], 0.0))
    return out
