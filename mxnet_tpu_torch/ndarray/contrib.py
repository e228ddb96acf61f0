"""``mx.nd.contrib``: control flow (``foreach``, ``while_loop``, ``cond``)
and the small contrib helpers.

Counterpart of ``mxnet_tpu/ndarray/contrib.py``.  The JAX package lowers a
loop to ``lax.scan`` when it is traced and runs it as a Python loop on the
tape under eager autograd; eager PyTorch always takes the second way:
each step's ops go on torch's tape, so gradients reach every array the
body touches (closure captures and cell parameters included).  The shapes
users see are the JAX package's: ``foreach`` stacks each step's outputs
on axis 0, and ``while_loop`` stacks them over ``max_iterations`` steps,
the steps after the loop ended holding zeros.  Loop arrays may be NDArrays
or tensors (nested in lists).

The detection ops (``ops/detection.py``) are here under the reference's
names (``box_iou``, ``box_nms``, ``ROIAlign``, ``MultiBoxPrior``,
``MultiBoxDetection``...), and so are the DGL graph-sampling ops
(``ndarray/dgl.py``).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops.registry import apply_op
from .ndarray import NDArray

__all__ = ["foreach", "while_loop", "cond", "isfinite", "isnan", "isinf",
           "arange_like", "index_copy", "index_array", "getnnz",
           "boolean_mask", "box_iou", "box_nms", "box_encode", "box_decode",
           "bipartite_matching", "ROIAlign", "MultiBoxPrior",
           "MultiBoxDetection", "dgl_csr_neighbor_uniform_sample",
           "dgl_csr_neighbor_non_uniform_sample", "dgl_subgraph",
           "dgl_graph_compact", "dgl_adjacency", "edge_id"]

from .dgl import (  # noqa: E402,F401
    dgl_adjacency, dgl_csr_neighbor_non_uniform_sample,
    dgl_csr_neighbor_uniform_sample, dgl_graph_compact, dgl_subgraph,
    edge_id)
from ..ops.registry import get_op as _get_op  # noqa: E402

box_iou = _get_op("box_iou")
box_nms = _get_op("box_nms")
box_encode = _get_op("box_encode")
box_decode = _get_op("box_decode")
bipartite_matching = _get_op("bipartite_matching")
ROIAlign = _get_op("roi_align")
MultiBoxPrior = _get_op("multibox_prior")
MultiBoxDetection = _get_op("multibox_detection")


def _flatten(x, out):
    """Flatten nested lists/tuples of arrays into ``out``; return the
    spec ``_unflatten`` rebuilds them from."""
    if isinstance(x, (NDArray, torch.Tensor)):
        out.append(x)
        return "_"
    if isinstance(x, (list, tuple)):
        return [_flatten(v, out) for v in x]
    if x is None:
        return None
    raise MXNetError("control flow states must be NDArrays, tensors or "
                     "nested lists of them, got %r" % (type(x),))


def _unflatten(spec, it):
    if spec == "_":
        return next(it)
    if spec is None:
        return None
    return [_unflatten(s, it) for s in spec]


def _stack(arrays):
    if isinstance(arrays[0], NDArray):
        return NDArray(torch.stack([a._data for a in arrays]))
    return torch.stack(arrays)


def _zeros_like(a):
    if isinstance(a, NDArray):
        return NDArray(torch.zeros_like(a._data))
    return torch.zeros_like(a)


def _truth(pred):
    """A predicate (array of one element, or a Python value) as a bool."""
    if isinstance(pred, NDArray):
        pred = pred._data
    if isinstance(pred, torch.Tensor):
        return bool(pred.reshape(()))
    return bool(pred)


def _call(fn, loop_vars):
    return fn(*loop_vars) if isinstance(loop_vars, list) else fn(loop_vars)


def foreach(body, data, init_states, name="foreach"):
    """Run ``body(data_slice, states) -> (outputs, new_states)`` over axis
    0 of ``data`` (an array or nested list of arrays of one length),
    threading the states.  Returns ``(outputs, final_states)``, each
    output stacked over the steps on axis 0."""
    flat_data = []
    data_spec = _flatten(data, flat_data)
    if not flat_data:
        raise MXNetError("foreach needs at least one data array")
    length = flat_data[0].shape[0]
    if any(d.shape[0] != length for d in flat_data):
        raise MXNetError("foreach data arrays must share axis-0 length")
    states = init_states
    columns, out_spec = None, None
    for t in range(length):
        outs, states = body(_unflatten(data_spec,
                                       iter([d[t] for d in flat_data])),
                            states)
        flat = []
        out_spec = _flatten(outs, flat)
        if columns is None:
            columns = [[] for _ in flat]
        for col, o in zip(columns, flat):
            col.append(o)
    if columns is None:
        raise MXNetError("foreach over an empty sequence")
    return _unflatten(out_spec, iter([_stack(c) for c in columns])), states


def while_loop(cond, func, loop_vars, max_iterations=None,
               name="while_loop"):
    """Run ``func(*loop_vars) -> (outputs, new_loop_vars)`` while
    ``cond(*loop_vars)`` holds, at most ``max_iterations`` times.
    Returns ``(outputs, loop_vars)``: each output stacked over
    ``max_iterations`` steps on axis 0, the steps after the loop ended
    holding zeros, and the last loop vars.  With no step run, ``func`` is
    called once off the tape to learn the outputs' shapes, and they are
    all zeros."""
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations")
    max_iterations = int(max_iterations)
    cur = loop_vars
    rows, out_spec = [], None
    while len(rows) < max_iterations and _truth(_call(cond, cur)):
        step = _call(func, cur)
        if not (isinstance(step, tuple) and len(step) == 2):
            raise MXNetError("while_loop func must return "
                             "(outputs, new_loop_vars)")
        outs, cur = step
        flat = []
        out_spec = _flatten(outs, flat)
        rows.append(flat)
    if not rows:
        with torch.no_grad():
            outs, _ = _call(func, cur)
        flat = []
        out_spec = _flatten(outs, flat)
        rows.append([_zeros_like(o) for o in flat])
    pad = [_zeros_like(o) for o in rows[0]]
    rows += [pad] * (max_iterations - len(rows))
    stacked = [_stack(list(col)) for col in zip(*rows)]
    return _unflatten(out_spec, iter(stacked)), cur


def cond(pred, then_func, else_func, name="cond"):
    """``then_func()`` if ``pred`` holds, else ``else_func()``; the branch
    taken runs on the tape."""
    return then_func() if _truth(pred) else else_func()


# ---- small contrib helpers ------------------------------------------------

def isfinite(data):
    return apply_op(lambda x: torch.isfinite(x).float(), data)


def isnan(data):
    return apply_op(lambda x: torch.isnan(x).float(), data)


def isinf(data):
    return apply_op(lambda x: torch.isinf(x).float(), data)


def arange_like(data, start=0.0, step=1.0, axis=None):
    """``start + step * i`` shaped like ``data`` (or along ``axis``)."""

    def fn(x):
        n = x.numel() if axis is None else x.shape[axis]
        out = start + step * torch.arange(n, dtype=torch.float32,
                                          device=x.device)
        return out.reshape(x.shape) if axis is None else out

    fn.__name__ = "arange_like"
    return apply_op(fn, data)


def index_copy(old_tensor, index_vector, new_tensor):
    """``old_tensor`` with its rows at ``index_vector`` replaced by the
    rows of ``new_tensor``."""

    def fn(old, idx, new):
        return old.index_copy(0, idx.long(), new)

    fn.__name__ = "index_copy"
    return apply_op(fn, old_tensor, index_vector, new_tensor)


def index_array(data, axes=None):
    """Each element's coordinates, (..., ndim) int32 (or the ``axes``
    picked)."""

    def fn(x):
        grids = torch.meshgrid(*[torch.arange(s, device=x.device)
                                 for s in x.shape], indexing="ij")
        idx = torch.stack(grids, dim=-1)
        if axes is not None:
            idx = idx[..., list(axes)]
        return idx.int()

    fn.__name__ = "index_array"
    return apply_op(fn, data)


def getnnz(data, axis=None):
    def fn(x):
        nz = x != 0
        return (nz.sum() if axis is None else nz.sum(dim=axis)).int()

    fn.__name__ = "getnnz"
    return apply_op(fn, data)


def boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is non-zero
    (a data-dependent shape; the gradient reaches the kept slices)."""
    i = index._data if isinstance(index, NDArray) else index
    keep = torch.as_tensor(i).bool().nonzero().reshape(-1)

    def fn(x):
        return x.index_select(axis, keep.to(x.device))

    fn.__name__ = "boolean_mask"
    return apply_op(fn, data)
