"""Imperative autograd: ``record`` / ``pause`` / ``backward`` over
``torch.autograd``.

Counterpart of ``mxnet_tpu/autograd.py``.  The JAX package keeps its own
tape; here the tape is torch's, and this module keeps the two flags the
Gluon API reads, per thread:

- *recording*: blocks build a graph only inside ``record()``.  A block
  called outside it runs under ``torch.no_grad()`` (``gluon/block.py``),
  so a head computed there has no graph and ``backward()`` on it raises,
  as on the JAX tape.  Torch's global grad mode is never flipped at
  import or outside these scopes.
- *training*: ``Dropout`` and attention dropout act only while it is set
  (``record()`` sets it unless ``train_mode=False``).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "is_recomputing", "recomputing", "backward",
           "grad"]


class _State(threading.local):
    is_recording = False
    is_training = False
    is_recomputing = False


_STATE = _State()


def is_recording():
    return _STATE.is_recording


def is_training():
    return _STATE.is_training


def is_recomputing():
    """Whether the forward running now is an activation recompute (the
    backward of a ``torch.utils.checkpoint`` region): layers that write
    state in their forward (BatchNorm's running statistics) skip the
    write, which the first run already made."""
    return _STATE.is_recomputing


@contextlib.contextmanager
def recomputing(flag=True):
    """Scope in which ``is_recomputing()`` is ``flag``."""
    prev = _STATE.is_recomputing
    _STATE.is_recomputing = flag
    try:
        yield
    finally:
        _STATE.is_recomputing = prev


@contextlib.contextmanager
def _mode(record=None, train=None):
    prev_r, prev_t = _STATE.is_recording, _STATE.is_training
    if record is not None:
        _STATE.is_recording = record
    if train is not None:
        _STATE.is_training = train
    try:
        if record is None:
            yield
        else:
            with torch.set_grad_enabled(record):
                yield
    finally:
        _STATE.is_recording, _STATE.is_training = prev_r, prev_t


def record(train_mode=True):  # pylint: disable=redefined-outer-name
    """Scope: build the autograd graph (torch grad mode on) and, by
    default, train (dropout active)."""
    return _mode(record=True, train=train_mode)


def pause(train_mode=False):  # pylint: disable=redefined-outer-name
    """Scope inside ``record()``: stop recording (torch grad mode off)."""
    return _mode(record=False, train=train_mode)


def train_mode():
    return _mode(train=True)


def predict_mode():
    return _mode(train=False)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _check_heads(heads):
    for h in heads:
        if not (isinstance(h, torch.Tensor) and h.requires_grad):
            raise MXNetError(
                "cannot differentiate a head that was not computed inside "
                "autograd.record() (it has no graph)")


def backward(heads, head_grads=None, retain_graph=False):
    """Accumulate d(heads)/d(parameter) into each parameter's ``.grad``
    (``head_grads`` default to ones, so a head that is not a scalar, such
    as a per-example loss, backpropagates its sum)."""
    heads = _as_list(heads)
    _check_heads(heads)
    grads = ([torch.ones_like(h) for h in heads] if head_grads is None
             else _as_list(head_grads))
    torch.autograd.backward(heads, grads, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False):
    """Gradients of ``heads`` with respect to ``variables``, returned as a
    list (``.grad`` is left as it was)."""
    heads = _as_list(heads)
    _check_heads(heads)
    variables = _as_list(variables)
    grads = None if head_grads is None else _as_list(head_grads)
    try:
        out = torch.autograd.grad(heads, variables, grads,
                                  retain_graph=retain_graph,
                                  create_graph=create_graph)
    except RuntimeError as e:
        raise MXNetError("one of the requested variables is unreachable "
                         "from the heads: %s" % e) from None
    return list(out)
