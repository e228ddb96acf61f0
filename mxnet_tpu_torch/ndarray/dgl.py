"""The DGL graph-sampling ops (``mx.nd.contrib.dgl_*`` and ``edge_id``).

Counterpart of ``mxnet_tpu/ndarray/dgl.py``, whose numpy kernels this
module keeps as they are: CSR neighbor sampling (uniform and weighted),
node-induced subgraphs, graph compaction, adjacency and edge-id lookup.
They walk the graph's CSR structure on the host, as the reference does
(its ``dgl_graph.cc`` has no CUDA kernel): sampling prepares a
mini-batch, whose features the caller then gathers on the card.  Graphs
are ``nd.sparse.CSRNDArray``; the vertex-id and layer arrays come back as
NDArrays on the current context.  Draws come from a numpy generator
seeded from the port's host generator (``_rng``), so ``mx.random.seed``
reproduces a sample; the JAX package seeds its own from its key stream,
so the two packages' draws differ (its tests inject one generator into
both).
"""
from __future__ import annotations

import numpy as _np

from ..base import MXNetError
from .sparse import CSRNDArray, csr_matrix
from .ndarray import NDArray

__all__ = ["dgl_csr_neighbor_uniform_sample",
           "dgl_csr_neighbor_non_uniform_sample",
           "dgl_subgraph", "dgl_graph_compact", "dgl_adjacency", "edge_id"]

_ID_DT = _np.int64


def _nd(arr):
    """A host result as an NDArray on the current context (int64 ids
    become int32, as the JAX package's x32 arrays hold them)."""
    from . import array

    return array(arr)


def _csr_parts(csr):
    if not isinstance(csr, CSRNDArray):
        raise MXNetError("expected a CSRNDArray graph, got %r" % (type(csr),))
    data = _np.asarray(csr.data.asnumpy(), dtype=_ID_DT)
    indices = _np.asarray(csr.indices.asnumpy(), dtype=_ID_DT)
    indptr = _np.asarray(csr.indptr.asnumpy(), dtype=_ID_DT)
    return data, indices, indptr, csr.shape


def _rng():
    """A numpy generator seeded from the port's host generator, so that
    ``mx.random.seed`` reproduces a sample."""
    from .. import random as _random

    return _np.random.default_rng(_random.take_key())


def _sample_neighbors(col, eid, num_neighbor, rng, prob_row=None):
    """Sample ``num_neighbor`` of this row's (col, eid) pairs.

    Uniform keeps the whole row when it is short (dgl_graph.cc:448
    GetUniformSample); non-uniform draws without replacement weighted by
    per-VERTEX probability (GetNonUniformSample:489, ArrayHeap)."""
    n = len(col)
    if n <= num_neighbor:
        return col, eid
    if prob_row is None:
        pick = rng.choice(n, size=num_neighbor, replace=False)
        pick.sort()
    else:
        w = prob_row.astype(_np.float64)
        s = w.sum()
        if not s > 0:
            raise MXNetError("non_uniform_sample: zero total probability "
                             "over a sampled row")
        # without-replacement draws can cover at most the positive-weight
        # candidates; clamp like the reference's ArrayHeap, which can only
        # ever return entries that still carry weight
        k = min(num_neighbor, int((w > 0).sum()))
        pick = rng.choice(n, size=k, replace=False, p=w / s)
        pick.sort()
    return col[pick], eid[pick]


def _neighbor_sample_one(data, indices, indptr, seeds, num_hops,
                         num_neighbor, max_num_vertices, rng, n_cols,
                         prob=None):
    """BFS sampling core (dgl_graph.cc:540 SampleSubgraph)."""
    max_num_vertices = int(max_num_vertices)
    seeds = _np.asarray(seeds, dtype=_ID_DT)
    if max_num_vertices < len(seeds):
        raise MXNetError("max_num_vertices (%d) < number of seeds (%d)"
                         % (max_num_vertices, len(seeds)))
    sub_ver = {}           # vertex -> layer
    queue = []             # (vertex, layer) in discovery order
    for s in seeds:
        s = int(s)
        if s not in sub_ver:
            sub_ver[s] = 0
            queue.append((s, 0))
    neigh = {}             # dst vertex -> (cols, eids) sampled for its row
    idx = 0
    while idx < len(queue) and len(sub_ver) < max_num_vertices:
        dst, level = queue[idx]
        idx += 1
        if level >= num_hops:
            continue
        lo, hi = int(indptr[dst]), int(indptr[dst + 1])
        cols, eids = indices[lo:hi], data[lo:hi]
        prow = prob[cols] if prob is not None else None
        cols, eids = _sample_neighbors(cols, eids, num_neighbor, rng, prow)
        neigh[dst] = (cols, eids)
        for v in cols:
            v = int(v)
            if len(sub_ver) >= max_num_vertices:
                break
            if v not in sub_ver:
                sub_ver[v] = level + 1
                queue.append((v, level + 1))

    verts = _np.array(sorted(sub_ver), dtype=_ID_DT)
    num_vertices = len(verts)
    sampled_ids = _np.zeros(max_num_vertices + 1, dtype=_ID_DT)
    sampled_ids[:num_vertices] = verts
    sampled_ids[max_num_vertices] = num_vertices
    layer = _np.zeros(max_num_vertices, dtype=_ID_DT)
    layer[:num_vertices] = [sub_ver[int(v)] for v in verts]

    # sub-csr: row i = i-th smallest sampled vertex; indices stay GLOBAL
    # ids, data carries the sampled edge ids (dgl_graph.cc:700-760)
    sub_indptr = _np.zeros(max_num_vertices + 1, dtype=_ID_DT)
    sub_cols, sub_eids = [], []
    for i, v in enumerate(verts):
        pair = neigh.get(int(v))
        if pair is not None:
            sub_cols.append(pair[0])
            sub_eids.append(pair[1])
            sub_indptr[i + 1] = sub_indptr[i] + len(pair[0])
        else:
            sub_indptr[i + 1] = sub_indptr[i]
    sub_indptr[num_vertices + 1:] = sub_indptr[num_vertices]
    sub_cols = (_np.concatenate(sub_cols) if sub_cols
                else _np.zeros(0, dtype=_ID_DT))
    sub_eids = (_np.concatenate(sub_eids) if sub_eids
                else _np.zeros(0, dtype=_ID_DT))
    # column space stays the PARENT graph's width: indices are global ids
    # (CSRNeighborUniformSampleShape, dgl_graph.cc:281)
    sub_csr = csr_matrix((sub_eids, sub_cols, sub_indptr),
                         shape=(max_num_vertices, n_cols))
    out = [_nd(sampled_ids), sub_csr]
    if prob is not None:
        sub_prob = _np.zeros(max_num_vertices, dtype=_np.float32)
        sub_prob[:num_vertices] = prob[verts]
        out.append(_nd(sub_prob))
    out.append(_nd(layer))
    return out


def dgl_csr_neighbor_uniform_sample(csr, *seed_arrays, num_args=None,
                                    num_hops=1, num_neighbor=2,
                                    max_num_vertices=100):
    """Uniform neighborhood sampling (dgl_graph.cc:762).

    For each seed array returns (sampled_vertex_ids, sub_csr, layer);
    ``sampled_vertex_ids`` has length max_num_vertices+1 with the true
    vertex count in its last slot."""
    data, indices, indptr, shape = _csr_parts(csr)
    rng = _rng()
    outs = []
    for seeds in seed_arrays:
        seeds = seeds.asnumpy() if isinstance(seeds, NDArray) else seeds
        outs.extend(_neighbor_sample_one(
            data, indices, indptr, seeds, int(num_hops), int(num_neighbor),
            max_num_vertices, rng, shape[1]))
    return outs[0] if len(outs) == 1 else tuple(outs)


def dgl_csr_neighbor_non_uniform_sample(csr, probability, *seed_arrays,
                                        num_args=None, num_hops=1,
                                        num_neighbor=2,
                                        max_num_vertices=100):
    """Probability-weighted neighborhood sampling (dgl_graph.cc:867).

    Returns per seed array (sampled_vertex_ids, sub_csr, prob, layer)."""
    data, indices, indptr, shape = _csr_parts(csr)
    prob = _np.asarray(probability.asnumpy()
                       if isinstance(probability, NDArray) else probability,
                       dtype=_np.float32)
    rng = _rng()
    outs = []
    for seeds in seed_arrays:
        seeds = seeds.asnumpy() if isinstance(seeds, NDArray) else seeds
        outs.extend(_neighbor_sample_one(
            data, indices, indptr, seeds, int(num_hops), int(num_neighbor),
            max_num_vertices, rng, shape[1], prob=prob))
    return tuple(outs)


def dgl_subgraph(graph, *vertex_arrays, num_args=None, return_mapping=False):
    """Node-induced subgraph(s) (dgl_graph.cc:1008 GetSubgraph).

    Vertex lists must be sorted.  Each subgraph csr uses LOCAL vertex ids
    and new edge ids 0..nnz-1; with return_mapping=True a second csr per
    input carries the ORIGINAL edge ids as data."""
    eids, indices, indptr, shape = _csr_parts(graph)
    subs, mappings = [], []
    for varr in vertex_arrays:
        vids = _np.asarray(varr.asnumpy() if isinstance(varr, NDArray)
                           else varr, dtype=_ID_DT)
        if not _np.all(_np.diff(vids) >= 0):
            raise MXNetError("dgl_subgraph: the vertex list must be sorted")
        old2new = {int(v): i for i, v in enumerate(vids)}
        n = len(vids)
        sub_indptr = _np.zeros(n + 1, dtype=_ID_DT)
        cols, oeids = [], []
        for i, v in enumerate(vids):
            lo, hi = int(indptr[v]), int(indptr[v + 1])
            for c, e in zip(indices[lo:hi], eids[lo:hi]):
                new = old2new.get(int(c))
                if new is not None:
                    cols.append(new)
                    oeids.append(int(e))
            sub_indptr[i + 1] = len(cols)
        cols = _np.asarray(cols, dtype=_ID_DT)
        oeids = _np.asarray(oeids, dtype=_ID_DT)
        new_eids = _np.arange(len(cols), dtype=_ID_DT)
        subs.append(csr_matrix((new_eids, cols, sub_indptr), shape=(n, n)))
        if return_mapping:
            mappings.append(csr_matrix((oeids, cols.copy(),
                                        sub_indptr.copy()), shape=(n, n)))
    outs = subs + mappings
    return outs[0] if len(outs) == 1 else tuple(outs)


def dgl_graph_compact(*args, graph_sizes=None, return_mapping=False,
                      num_args=None):
    """Compact sampled subgraphs to local vertex ids (dgl_graph.cc:1583).

    Input pairs: N csr graphs (global col ids, rows already sorted-sampled
    order) + N vertex-id arrays mapping local row -> global id;
    ``graph_sizes`` gives each graph's true vertex count."""
    n = len(args) // 2
    csrs, id_arrs = args[:n], args[n:]
    sizes = graph_sizes if isinstance(graph_sizes, (list, tuple)) \
        else [graph_sizes] * n
    subs, mappings = [], []
    for csr, id_arr, size in zip(csrs, id_arrs, sizes):
        eids, indices, indptr, _shape = _csr_parts(csr)
        ids = _np.asarray(id_arr.asnumpy() if isinstance(id_arr, NDArray)
                          else id_arr, dtype=_ID_DT)
        size = int(size)
        old2new = {int(v): i for i, v in enumerate(ids[:size])}
        new_indptr = indptr[:size + 1].copy()
        keep_cols, keep_eids = [], []
        for i in range(size):
            lo, hi = int(indptr[i]), int(indptr[i + 1])
            for c, e in zip(indices[lo:hi], eids[lo:hi]):
                new = old2new.get(int(c))
                if new is None:
                    raise MXNetError(
                        "dgl_graph_compact: column %d not in id map" % c)
                keep_cols.append(new)
                keep_eids.append(int(e))
        cols = _np.asarray(keep_cols, dtype=_ID_DT)
        oeids = _np.asarray(keep_eids, dtype=_ID_DT)
        subs.append(csr_matrix((_np.arange(len(cols), dtype=_ID_DT), cols,
                                new_indptr), shape=(size, size)))
        if return_mapping:
            mappings.append(csr_matrix((oeids, cols.copy(),
                                        new_indptr.copy()),
                                       shape=(size, size)))
    outs = subs + mappings
    return outs[0] if len(outs) == 1 else tuple(outs)


def dgl_adjacency(graph):
    """CSR graph (int64 edge ids) -> float32 adjacency with unit weights,
    same sparsity structure (dgl_graph.cc:1408)."""
    _eids, indices, indptr, shape = _csr_parts(graph)
    return csr_matrix((_np.ones(len(indices), dtype=_np.float32),
                       indices.copy(), indptr.copy()), shape=shape)


def edge_id(graph, u, v):
    """Edge-id lookup: out[i] = data[u[i], v[i]] or -1 when the edge is
    absent (dgl_graph.cc:1332; output keeps the CSR data dtype, matching
    EdgeIDForwardCsrImpl's MSHADOW_TYPE_SWITCH on the data type — float32
    would corrupt int64 edge ids above 2**24)."""
    data = _np.asarray(graph.data.asnumpy())
    indices = _np.asarray(graph.indices.asnumpy(), dtype=_ID_DT)
    indptr = _np.asarray(graph.indptr.asnumpy(), dtype=_ID_DT)
    uu = _np.asarray(u.asnumpy() if isinstance(u, NDArray) else u,
                     dtype=_ID_DT)
    vv = _np.asarray(v.asnumpy() if isinstance(v, NDArray) else v,
                     dtype=_ID_DT)
    out = _np.full(uu.shape, -1, dtype=data.dtype)
    for i, (a, b) in enumerate(zip(uu, vv)):
        lo, hi = int(indptr[a]), int(indptr[a + 1])
        hit = _np.where(indices[lo:hi] == b)[0]
        if len(hit):
            out[i] = data[lo + int(hit[-1])]
    return _nd(out)
