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

``backward`` and ``grad`` take tensors or ``NDArray`` heads; ``grad``
returns NDArrays for NDArray variables.  A variable is a torch leaf:
a ``gluon.Parameter``, or the tensor of an NDArray after ``attach_grad``
or ``mark_variables``.  Its ``grad_req`` follows the JAX package's
``_write_grads`` (``mxnet_tpu/autograd.py:270-291``): with ``'write'`` the
gradient of a backward replaces the one a leaf holds, with ``'add'`` it is
summed into it, and a leaf the backward does not reach keeps its gradient.
Torch only sums, so ``backward`` first takes the gradient off every
``'write'`` leaf that holds one and gives it back to each leaf the
backward left without one.  That costs one attribute check per live leaf
(``_LEAVES``: the ``Parameter``s and attached NDArrays alive in the
process) and no walk of the graph; in a training loop ``Trainer.step``
has cleared the gradients, so nothing is taken.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "is_recomputing",
           "recomputing", "backward", "grad", "mark_variables", "Function"]


class _State(threading.local):
    is_recording = False
    is_training = False
    is_recomputing = False
    grad_before = None      # torch's grad mode when set_recording(True) ran


_STATE = _State()


def is_recording():
    return _STATE.is_recording


def is_training():
    return _STATE.is_training


def set_recording(is_record):
    """Turn recording on or off outside a scope; returns the previous
    state.  Torch's grad mode follows: on while recording, and back to
    what it was when recording was turned on once it is turned off."""
    prev = _STATE.is_recording
    is_record = bool(is_record)
    if is_record and not prev:
        _STATE.grad_before = torch.is_grad_enabled()
        torch.set_grad_enabled(True)
    elif prev and not is_record:
        before = _STATE.grad_before
        torch.set_grad_enabled(True if before is None else before)
        _STATE.grad_before = None
    _STATE.is_recording = is_record
    return prev


def set_training(train_mode_):
    """Turn training mode on or off; returns the previous state."""
    prev = _STATE.is_training
    _STATE.is_training = bool(train_mode_)
    return prev


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


# every leaf that carries a grad_req: id -> tensor (Parameters register at
# construction, NDArray tensors at attach_grad / mark_variables)
_LEAVES = weakref.WeakValueDictionary()
# the leaves of mark_variables, whose gradient lands in the caller's handle
_HANDLED = weakref.WeakValueDictionary()


def _register_leaf(t):
    _LEAVES[id(t)] = t
    return t


def _make_leaf(t, grad_req="write", grad=None):
    """A fresh leaf over ``t``'s values with ``grad_req`` and gradient
    buffer ``grad`` (zeros when None), as ``attach_grad`` makes it."""
    if grad_req not in ("write", "add", "null"):
        raise MXNetError("grad_req must be one of write, add, null; got %r"
                         % (grad_req,))
    leaf = t.detach()
    if grad_req != "null":
        leaf.requires_grad_(True)
    leaf.grad = torch.zeros_like(leaf) if grad is None else grad
    leaf.grad_req = grad_req
    return _register_leaf(leaf)


def _tensor(x):
    return getattr(x, "_data", x)


def _check_heads(heads):
    for h in heads:
        if not (isinstance(h, torch.Tensor) and h.requires_grad):
            raise MXNetError(
                "cannot differentiate a head that was not computed inside "
                "autograd.record() (it has no graph)")


def _take_write_grads():
    """Detach the gradient of every ``'write'`` leaf that holds one, so the
    backward writes it afresh instead of summing into it; returns the
    leaves with their old gradients, for ``_restore_unreached``."""
    taken = []
    for t in list(_LEAVES.values()):
        if t.grad is not None and getattr(t, "grad_req", None) == "write":
            taken.append((t, t.grad))
            t.grad = None
    return taken


def _restore_unreached(taken):
    """Give each leaf the backward did not reach its old gradient back."""
    for t, old in taken:
        if t.grad is None:
            t.grad = old


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):  # pylint: disable=redefined-outer-name
    """Write d(heads)/d(leaf) into the ``.grad`` of every leaf the heads
    reach, by its ``grad_req`` (``head_grads`` default to ones, so a head
    that is not a scalar, such as a per-example loss, backpropagates its
    sum).  Heads and head gradients may be tensors or NDArrays."""
    heads = [_tensor(h) for h in _as_list(heads)]
    _check_heads(heads)
    grads = ([torch.ones_like(h) for h in heads] if head_grads is None
             else [_tensor(g) for g in _as_list(head_grads)])
    taken = _take_write_grads()
    try:
        torch.autograd.backward(heads, grads, retain_graph=retain_graph)
    finally:
        _restore_unreached(taken)
    for t in list(_HANDLED.values()):
        if t.grad is not None:
            t._mx_grad._data = t.grad


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):  # pylint: disable=redefined-outer-name
    """Gradients of ``heads`` (seeded with ``head_grads``, default ones)
    with respect to ``variables``, returned as a list (``.grad`` is left
    as it was): NDArrays for NDArray variables, tensors for tensors."""
    heads = [_tensor(h) for h in _as_list(heads)]
    _check_heads(heads)
    variables = _as_list(variables)
    grads = ([torch.ones_like(h) for h in heads] if head_grads is None
             else [_tensor(g) for g in _as_list(head_grads)])
    try:
        out = torch.autograd.grad(heads, [_tensor(v) for v in variables],
                                  grads, retain_graph=retain_graph,
                                  create_graph=create_graph)
    except RuntimeError as e:
        raise MXNetError("one of the requested variables is unreachable "
                         "from the heads: %s" % e) from None
    if variables and not isinstance(variables[0], torch.Tensor):
        from .ndarray.ndarray import NDArray

        return [NDArray(g) for g in out]
    return list(out)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each NDArray of ``variables`` a leaf whose gradient lands in the
    matching NDArray of ``gradients`` (that handle is the one its ``.grad``
    returns), by ``grad_reqs``."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, gradient, req in zip(variables, gradients, grad_reqs):
        leaf = _make_leaf(var._data, req, gradient._data)
        leaf._mx_grad = gradient
        _HANDLED[id(leaf)] = leaf
        var._data = leaf


class _UserFunction(torch.autograd.Function):
    """The tape node of one ``Function`` call."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray

        with pause():
            outputs = func.forward(*[NDArray(t) for t in tensors])
        ctx.func = func
        func._single = not isinstance(outputs, (list, tuple))
        return tuple(_tensor(o).detach() for o in _as_list(outputs))

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray

        with pause():
            in_grads = ctx.func.backward(*[NDArray(g) for g in grads])
        return (None,) + tuple(None if g is None else _tensor(g)
                               for g in _as_list(in_grads))


class Function:
    """A user-defined differentiable function on NDArrays: subclass it,
    write ``forward`` and ``backward``, and call an instance.  Inside
    ``record()`` the call is one node of torch's tape whose backward is
    the subclass's ``backward``."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        tensors = [_tensor(x) for x in inputs]
        with torch.set_grad_enabled(is_recording()):
            outs = _UserFunction.apply(self, *tensors)
        wrapped = [NDArray(o) for o in outs]
        return wrapped[0] if self._single else tuple(wrapped)
