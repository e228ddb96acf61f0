"""Gluon utilities: ``split_data``, ``split_and_load``,
``clip_global_norm`` and ``check_sha1``.

Counterpart of ``mxnet_tpu/gluon/utils.py``.  ``download`` is not ported:
it waits for a machine with a network.
"""
from __future__ import annotations

import hashlib
import math
import warnings

import torch

from ..base import MXNetError
from ..context import device_of

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``; the last takes
    the remainder unless ``even_split`` requires none."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            "data size %d cannot be evenly split into %d slices"
            % (size, num_slice))
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.narrow(batch_axis, i * step, end - i * step))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """One slice of ``data`` (a tensor or array) per context, each on its
    context's device; one context takes the whole batch."""
    data = torch.as_tensor(data)
    if len(ctx_list) == 1:
        return [data.to(device_of(ctx_list[0]))]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.to(device_of(ctx)) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (a float), warning if
    it is not finite."""
    if not arrays:
        raise MXNetError("arrays must not be empty")
    with torch.no_grad():
        total = sum(torch.sum(torch.square(a.float())).to(arrays[0].device)
                    for a in arrays)
        total_norm = torch.sqrt(total)
        scale = torch.clamp(max_norm / (total_norm + 1e-8), max=1.0)
        for a in arrays:
            a.copy_(a.float() * scale.to(a.device))
    tn = float(total_norm)
    if check_isfinite and not math.isfinite(tn):
        warnings.warn("nan or inf in gradient global norm")
    return tn


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 is ``sha1_hash`` (hex)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash
