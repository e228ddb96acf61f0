"""The DGL graph-sampling ops (``mx.nd.contrib.dgl_*``, ``edge_id``)
against the JAX package on the CPU: the cases of the JAX package's
``tests/python/unittest/test_dgl_graph.py``, each through both packages,
with one numpy generator injected into both (``_rng``: the JAX package
seeds its own from its key stream, the port from its generator), so that
the samples must be identical, array for array and dtype for dtype."""
import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ndarray import dgl as jdgl
from mxnet_tpu_torch.ndarray import dgl as tdgl

sp = pytest.importorskip("scipy.sparse")


@pytest.fixture(autouse=True)
def same_draws(monkeypatch):
    """Each sampling call of either package draws from a fresh generator
    of one seed."""
    for mod in (jdgl, tdgl):
        monkeypatch.setattr(mod, "_rng",
                            lambda: onp.random.default_rng(20161))


def parts(x):
    """Every array of an output (a CSR as its three arrays)."""
    if isinstance(x, (list, tuple)):
        return [p for v in x for p in parts(v)]
    if getattr(x, "stype", "default") == "csr":
        return [x.data.asnumpy(), x.indices.asnumpy(), x.indptr.asnumpy()]
    return [x.asnumpy()]


def both(fn):
    ref = fn(mj)
    with mt.cpu():
        got = fn(mt)
    g, r = parts(got), parts(ref)
    assert len(g) == len(r)
    for a, b in zip(g, r):
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
        onp.testing.assert_array_equal(a, b)
    return got, ref


def _full_graph(mx):
    data = onp.arange(1, 21, dtype=onp.int64)
    indices = onp.array([1, 2, 3, 4, 0, 2, 3, 4, 0, 1, 3, 4,
                         0, 1, 2, 4, 0, 1, 2, 3], dtype=onp.int64)
    indptr = onp.array([0, 4, 8, 12, 16, 20], dtype=onp.int64)
    return mx.nd.sparse.csr_matrix((data, indices, indptr), shape=(5, 5))


@pytest.mark.parametrize("seeds,hops,nbr,maxv", [
    ([0, 1, 2, 3, 4], 1, 2, 5), ([0], 1, 1, 4), ([0], 2, 1, 3),
    ([0, 2, 4], 1, 2, 5), ([0, 4], 1, 2, 5), ([0, 4], 2, 2, 5)])
def test_uniform_sample_and_compact(seeds, hops, nbr, maxv):
    def run(mx):
        out = mx.nd.contrib.dgl_csr_neighbor_uniform_sample(
            _full_graph(mx), mx.nd.array(onp.array(seeds, onp.int64)),
            num_args=2, num_hops=hops, num_neighbor=nbr,
            max_num_vertices=maxv)
        out[1].check_format(full_check=True)
        n = int(out[0].asnumpy()[-1])
        compact = mx.nd.contrib.dgl_graph_compact(
            out[1], out[0], graph_sizes=n, return_mapping=False)
        return list(out) + [compact]

    got, _ = both(run)
    assert len(got) == 4


def test_two_seed_arrays_give_two_samples():
    def run(mx):
        return mx.nd.contrib.dgl_csr_neighbor_uniform_sample(
            _full_graph(mx), mx.nd.array(onp.int64([0, 1])),
            mx.nd.array(onp.int64([3])), num_hops=1, num_neighbor=2,
            max_num_vertices=5)

    got, _ = both(run)
    assert len(got) == 6


def test_uniform_sample_reproducible_with_the_port_seed(monkeypatch):
    """Without the injection, ``mx.random.seed`` reproduces a sample."""
    monkeypatch.undo()

    def draw():
        mt.random.seed(7)
        with mt.cpu():
            return parts(mt.nd.contrib.dgl_csr_neighbor_uniform_sample(
                _full_graph(mt), mt.nd.array(onp.int64([0, 2])),
                num_args=2, num_hops=1, num_neighbor=2, max_num_vertices=5))

    for x, y in zip(draw(), draw()):
        onp.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seeds,hops,nbr,maxv", [
    ([0, 1, 2, 3, 4], 1, 2, 5), ([0], 1, 1, 4), ([0], 2, 1, 4),
    ([0, 2, 4], 1, 2, 5), ([0, 4], 2, 2, 5)])
def test_non_uniform_sample(seeds, hops, nbr, maxv):
    prob = onp.array([0.9, 0.8, 0.2, 0.4, 0.1], dtype=onp.float32)

    def run(mx):
        out = mx.nd.contrib.dgl_csr_neighbor_non_uniform_sample(
            _full_graph(mx), mx.nd.array(prob),
            mx.nd.array(onp.array(seeds, onp.int64)), num_args=3,
            num_hops=hops, num_neighbor=nbr, max_num_vertices=maxv)
        assert len(out) == 4
        return out

    both(run)


def _generate_graph(mx, n):
    rs = onp.random.RandomState(3)
    dense = (rs.rand(n, n) < 0.2).astype(onp.float32)
    coo = sp.coo_matrix(dense)
    coo.data = onp.arange(len(coo.row), dtype=onp.float32)
    csr = coo.tocsr()
    return mx.nd.sparse.csr_matrix(
        (csr.data.astype(onp.int64), csr.indices.astype(onp.int64),
         csr.indptr.astype(onp.int64)), shape=(n, n))


@pytest.mark.parametrize("return_mapping", [True, False])
def test_subgraph(return_mapping):
    vertices = onp.unique(onp.random.RandomState(5).randint(0, 100, 20))

    def run(mx):
        return mx.nd.contrib.dgl_subgraph(
            _generate_graph(mx, 100), mx.nd.array(vertices.astype(onp.int64)),
            return_mapping=return_mapping)

    both(run)


def test_unsorted_subgraph_vertices_raise_in_both():
    for mx in (mj, mt):
        with mt.cpu(), pytest.raises(mx.base.MXNetError):
            mx.nd.contrib.dgl_subgraph(_generate_graph(mx, 10),
                                       mx.nd.array(onp.int64([3, 1])))


def test_adjacency():
    both(lambda mx: mx.nd.contrib.dgl_adjacency(_generate_graph(mx, 100)))


def test_edge_id():
    shape = (8, 9)
    rs = onp.random.RandomState(11)
    dense = rs.rand(*shape) * (rs.rand(*shape) < 0.4)
    csr = sp.csr_matrix(dense.astype(onp.float32))
    u = rs.randint(0, shape[0], size=5)
    v = rs.randint(0, shape[1], size=5)

    def run(mx):
        g = mx.nd.sparse.csr_matrix(
            (csr.data, csr.indices.astype(onp.int64),
             csr.indptr.astype(onp.int64)), shape=shape)
        return mx.nd.contrib.edge_id(g, mx.nd.array(u.astype(onp.int64)),
                                     mx.nd.array(v.astype(onp.int64)))

    both(run)


def test_edge_id_keeps_integer_ids():
    big = onp.int64(2 ** 24 + 1)

    def run(mx):
        g = mx.nd.sparse.csr_matrix(
            (onp.array([big, 7], onp.int64), onp.int64([1, 0]),
             onp.int64([0, 1, 2])), shape=(2, 2))
        return mx.nd.contrib.edge_id(g, mx.nd.array(onp.int64([0, 0])),
                                     mx.nd.array(onp.int64([1, 0])))

    got, _ = both(run)
    assert int(got.asnumpy()[0]) == int(big)


def test_sampled_subcsr_keeps_parent_width():
    def run(mx):
        g = mx.nd.sparse.csr_matrix(
            (onp.arange(1, 5, dtype=onp.int64), onp.int64([1, 2, 0, 3]),
             onp.int64([0, 2, 3, 4, 4, 4])), shape=(5, 7))
        out = mx.nd.contrib.dgl_csr_neighbor_uniform_sample(
            g, mx.nd.array(onp.int64([0])), num_args=2, num_hops=1,
            num_neighbor=2, max_num_vertices=4)
        assert out[1].shape[1] == 7
        return out

    both(run)


def test_non_uniform_sample_clamps_to_positive_weights():
    def run(mx):
        g = mx.nd.sparse.csr_matrix(
            (onp.int64([1, 2, 3, 4]), onp.int64([1, 2, 3, 4]),
             onp.int64([0, 4, 4, 4, 4, 4])), shape=(5, 5))
        prob = mx.nd.array(onp.float32([0.0, 0.5, 0.0, 0.5, 0.0]))
        return mx.nd.contrib.dgl_csr_neighbor_non_uniform_sample(
            g, prob, mx.nd.array(onp.int64([0])), num_args=3, num_hops=1,
            num_neighbor=3, max_num_vertices=5)

    got, _ = both(run)
    assert set(got[1].indices.asnumpy().tolist()) == {1, 3}
