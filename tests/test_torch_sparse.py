"""``mx.nd.sparse`` (row_sparse and CSR storage), the lazy SGD/Adam updates,
``Embedding(sparse_grad=True)`` through ``gluon.Trainer``, ``LibSVMIter``'s
CSR batches and sparse records of the reference's ``.params`` format,
against the JAX package on the CPU: every case of the JAX package's
``tests/python/unittest/test_sparse.py`` but the two kvstore ones
(``row_sparse_pull`` is not ported), each through both packages on the
same numpy inputs, within 1e-6; then a small matrix-factorization model
trained with both tables sparse, 3 lazy-Adam and 3 lazy-SGD steps,
within 1e-5."""
import struct

import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

TOL = 1e-6


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()   # not a view of a weight
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def same(got, ref, tol=TOL):
    got, ref = host(got), host(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (
        got.shape, ref.shape, got.dtype, ref.dtype)
    onp.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def both(fn):
    """(port result, JAX result) of ``fn(mx)``, the port's on the CPU."""
    ref = fn(mj)
    with mt.cpu():
        got = fn(mt)
    return got, ref


def _rand_sparse(m, n, density, rs):
    arr = rs.rand(m, n).astype(onp.float32)
    arr[arr > density] = 0
    return arr


def test_csr_construction_roundtrip():
    arr = _rand_sparse(6, 5, 0.4, onp.random.RandomState(0))

    def run(mx):
        csr = mx.nd.sparse.csr_matrix(arr)
        csr2 = mx.nd.sparse.csr_matrix(
            (csr.data.asnumpy(), csr.indices.asnumpy(),
             csr.indptr.asnumpy()), shape=(6, 5))
        assert csr.stype == "csr" and csr.shape == (6, 5)
        return csr, csr2

    (g1, g2), (r1, r2) = both(run)
    for g, r in ((g1, r1), (g2, r2)):
        same(g, r)
        for part in ("data", "indices", "indptr"):
            same(getattr(g, part), getattr(r, part))
    same(g1, arr)


def test_row_sparse_construction_roundtrip():
    arr = onp.zeros((8, 3), onp.float32)
    arr[[1, 4, 6]] = onp.random.RandomState(1).rand(3, 3)

    def run(mx):
        rsp = mx.nd.sparse.row_sparse_array(arr)
        assert rsp.stype == "row_sparse"
        return rsp

    got, ref = both(run)
    same(got, ref)
    same(got.indices, ref.indices)
    same(got.data, ref.data)


@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("transpose_b", [False, True])
def test_csr_dot_dense(transpose_a, transpose_b):
    rs = onp.random.RandomState(2)
    a = _rand_sparse(7, 5, 0.5, rs)
    rows = 7 if transpose_a else 5
    b = rs.rand(*((3, rows) if transpose_b else (rows, 3))).astype(
        onp.float32)

    def run(mx):
        return mx.nd.sparse.dot(mx.nd.sparse.csr_matrix(a), mx.nd.array(b),
                                transpose_a=transpose_a,
                                transpose_b=transpose_b)

    got, ref = both(run)
    same(got, ref)
    want = (a.T if transpose_a else a) @ (b.T if transpose_b else b)
    onp.testing.assert_allclose(host(got), want, rtol=1e-5)


@pytest.mark.parametrize("transpose_a", [False, True])
def test_row_sparse_dot(transpose_a):
    rs = onp.random.RandomState(3)
    arr = onp.zeros((10, 4), onp.float32)
    arr[[2, 5]] = rs.rand(2, 4)
    dense = rs.rand(*((10, 6) if transpose_a else (4, 6))).astype(
        onp.float32)

    def run(mx):
        return mx.nd.sparse.dot(mx.nd.sparse.row_sparse_array(arr),
                                mx.nd.array(dense), transpose_a=transpose_a)

    got, ref = both(run)
    same(got, ref)


def test_dot_of_dense_arrays_is_the_dense_dot():
    rs = onp.random.RandomState(6)
    a, b = rs.rand(3, 4).astype(onp.float32), rs.rand(4, 2).astype(
        onp.float32)
    got, ref = both(lambda mx: mx.nd.sparse.dot(mx.nd.array(a),
                                                mx.nd.array(b)))
    same(got, ref)


def test_cast_storage():
    arr = _rand_sparse(5, 5, 0.4, onp.random.RandomState(4))

    def run(mx):
        x = mx.nd.array(arr)
        csr = mx.nd.sparse.cast_storage(x, "csr")
        rsp = mx.nd.sparse.cast_storage(x, "row_sparse")
        assert (csr.stype, rsp.stype) == ("csr", "row_sparse")
        return (csr, mx.nd.sparse.cast_storage(csr, "default"), rsp,
                mx.nd.sparse.cast_storage(rsp, "default"))

    for g, r in zip(*both(run)):
        same(g, r)


def test_dense_tostype_casts_storage():
    """``NDArray.tostype`` of a dense array gives the sparse array
    ``cast_storage`` gives (the JAX dense ``tostype`` refuses, so this
    holds the port to its ``cast_storage``)."""
    arr = _rand_sparse(5, 4, 0.4, onp.random.RandomState(7))
    with mt.cpu():
        x = mt.nd.array(arr)
        for st in ("csr", "row_sparse"):
            got = x.tostype(st)
            assert got.stype == st
            same(got, arr)
        assert x.tostype("default") is x
    with pytest.raises(mj.base.MXNetError):
        mj.nd.array(arr).tostype("csr")


def test_retain():
    arr = onp.zeros((8, 2), onp.float32)
    arr[[1, 3, 5]] = [[1, 1], [3, 3], [5, 5]]

    def run(mx):
        rsp = mx.nd.sparse.row_sparse_array(arr)
        return rsp.retain(mx.nd.array(onp.array([3, 5], onp.float32)))

    got, ref = both(run)
    same(got, ref)
    same(got.indices, ref.indices)


def test_row_sparse_add():
    a = onp.zeros((6, 2), onp.float32)
    a[[0, 2]] = 1.0
    b = onp.zeros((6, 2), onp.float32)
    b[[2, 4]] = 2.0

    def run(mx):
        sp = mx.nd.sparse
        out = sp.add(sp.row_sparse_array(a), sp.row_sparse_array(b))
        assert out.stype == "row_sparse"
        mixed = sp.add(sp.row_sparse_array(a), mx.nd.array(b))
        return out, mixed

    (g, gm), (r, rm) = both(run)
    same(g, r)
    same(gm, rm)
    same(g, a + b)


def test_sparse_embedding_grad():
    rs = onp.random.RandomState(5)
    grads = rs.rand(2, 3, 4).astype(onp.float32)
    ids = onp.array([[1, 7, 1], [3, 7, 1]], onp.float32)

    def run(mx):
        return mx.nd.sparse.sparse_embedding_grad(
            mx.nd.array(grads), mx.nd.array(ids), vocab_size=10)

    got, ref = both(run)
    assert got.shape == ref.shape == (10, 4)
    same(got, ref)
    same(got.indices, ref.indices)
    same(got.data, ref.data)


@pytest.mark.parametrize("stype", ["row_sparse", "csr", "default"])
def test_sparse_zeros(stype):
    got, ref = both(lambda mx: mx.nd.sparse.zeros(stype, (4, 3)))
    same(got, ref)


def test_libsvm_iter(tmp_path):
    path = str(tmp_path / "data.libsvm")
    with open(path, "w") as f:
        f.write("1 0:1.5 3:2.0\n")
        f.write("0 1:0.5\n")
        f.write("1 2:3.0 4:1.0\n")

    def run(mx):
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(5,),
                              batch_size=2)
        b1, b2 = it.next(), it.next()
        assert b1.data[0].stype == "csr" and b2.pad == 1
        with pytest.raises(StopIteration):
            it.next()
        it.reset()
        assert it.next().pad == 0
        return [b1.data[0], b1.label[0], b2.data[0], b2.label[0]]

    got, ref = both(run)
    for g, r in zip(got, ref):
        same(g, r)
    for part in ("indices", "indptr", "data"):
        same(getattr(got[0], part), getattr(ref[0], part))


def test_row_sparse_from_dense():
    dense = onp.zeros((5, 3), onp.float32)
    dense[1] = 1.0
    dense[4] = 2.0
    got, ref = both(lambda mx: mx.nd.sparse.row_sparse_from_dense(
        mx.nd.array(dense)))
    same(got.indices, ref.indices)
    same(got, ref)


# ---- the lazy updates -----------------------------------------------------


def _update(mx, opt_name, kw, w0, grad, steps=1, dense_grad=None):
    """(weight, state leaves) after ``steps`` updates with ``grad`` given
    as (rows, indices) row_sparse, or dense."""
    w = mx.nd.array(w0)
    o = mx.optimizer.create(opt_name, **kw)
    if mx is mj:
        st = o.create_state(0, w)
    else:
        w = w._data
        st = o.create_state(0, w)
    for _ in range(steps):
        if dense_grad is not None:
            g = mx.nd.array(dense_grad)
            g = g if mx is mj else g._data
        else:
            g = mx.nd.sparse.row_sparse_array(grad, shape=w0.shape)
        o.update(0, w, g, st)
    leaves = [] if st is None else list(st) if isinstance(st, tuple) \
        else [st]
    return w, leaves


@pytest.mark.parametrize("opt_name,kw", [
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9}),
    ("sgd", {"learning_rate": 0.5, "wd": 0.01, "clip_gradient": 0.7}),
    ("adam", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 0.1, "wd": 0.01, "rescale_grad": 0.5})])
def test_lazy_update_touches_only_grad_rows(opt_name, kw):
    rs = onp.random.RandomState(0)
    w0 = rs.rand(6, 3).astype(onp.float32)
    grad = (rs.rand(2, 3).astype(onp.float32) + 0.5, [1, 4])

    def run(mx):
        return _update(mx, opt_name, dict(kw, lazy_update=True), w0, grad,
                       steps=3)

    (gw, gst), (rw, rst) = both(run)
    same(gw, rw)
    for g, r in zip(gst, rst):
        same(g, r)
    out = host(gw)
    onp.testing.assert_array_equal(out[[0, 2, 3, 5]], w0[[0, 2, 3, 5]])
    for s in gst:
        onp.testing.assert_array_equal(host(s)[[0, 2, 3, 5]], 0.0)


def test_adam_lazy_matches_dense_on_touched_rows():
    rs = onp.random.RandomState(0)
    w0 = rs.rand(5, 4).astype(onp.float32)
    grows = rs.rand(2, 4).astype(onp.float32)
    idx = [0, 3]
    dense_g = onp.zeros((5, 4), onp.float32)
    dense_g[idx] = grows

    def run(mx):
        lazy, _ = _update(mx, "adam", {"learning_rate": 0.1,
                                       "lazy_update": True}, w0,
                          (grows, idx))
        dense, _ = _update(mx, "adam", {"learning_rate": 0.1,
                                        "lazy_update": False}, w0, None,
                           dense_grad=dense_g)
        return lazy, dense

    (gl, gd), (rl, rd) = both(run)
    same(gl, rl)
    same(gd, rd)
    same(gl, gd)


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_lazy_update_duplicate_indices_sum(opt_name):
    w0 = onp.ones((4, 2), onp.float32)
    grad = (onp.array([[1., 1.], [2., 2.], [4., 4.]], onp.float32),
            [2, 1, 2])

    def run(mx):
        return _update(mx, opt_name, {"learning_rate": 1.0,
                                      "lazy_update": True}, w0, grad)[0]

    got, ref = both(run)
    same(got, ref)
    if opt_name == "sgd":
        onp.testing.assert_allclose(host(got)[2], 1 - 5.0)


def test_lazy_update_false_takes_the_dense_rule():
    """``lazy_update=False``: the row_sparse gradient is densified, so the
    untouched rows move too (momentum carries them)."""
    w0 = onp.ones((4, 2), onp.float32)
    grad = (onp.ones((1, 2), onp.float32), [1])

    def run(mx):
        return _update(mx, "sgd", {"learning_rate": 0.5, "momentum": 0.9,
                                   "wd": 0.1, "lazy_update": False}, w0,
                       grad, steps=2)[0]

    got, ref = both(run)
    same(got, ref)
    assert not onp.allclose(host(got)[0], 1.0)


# ---- through gluon.Trainer ------------------------------------------------


def _embed(mx, n, d, w0, **kw):
    e = mx.gluon.nn.Embedding(n, d, **kw)
    e.initialize()
    if mx is mj:
        e.weight.set_data(mx.nd.array(w0))
    else:
        with torch.no_grad():
            e.weight.copy_(torch.from_numpy(w0))
    return e


def _weight(mx, p):
    return host(p.data() if mx is mj else p)


@pytest.mark.parametrize("opt_name,lr", [("sgd", 1.0), ("adam", 0.1)])
def test_trainer_row_sparse_grad_end_to_end(opt_name, lr):
    """grad_stype='row_sparse' set on the weight: the Trainer compresses
    the dense backward gradient and the optimizer moves only live rows."""
    w0 = onp.random.RandomState(0).rand(50, 8).astype(onp.float32)

    def run(mx):
        embed = _embed(mx, 50, 8, w0)
        embed.weight.grad_stype = "row_sparse"
        tr = mx.gluon.Trainer(embed.collect_params(), opt_name,
                              {"learning_rate": lr})
        with mx.autograd.record():
            loss = (embed(mx.nd.array(onp.array([1, 3, 3, 7], onp.int32),
                                      dtype="int32")) ** 2).sum()
        loss.backward()
        tr.step(1)
        return _weight(mx, embed.weight)

    got, ref = both(run)
    same(got, ref)
    changed = onp.where(onp.any(got != w0, axis=1))[0].tolist()
    assert changed == [1, 3, 7]


def test_embedding_sparse_grad_three_adam_steps_match_jax():
    """The repair of ``Embedding``'s dropped ``sparse_grad``: three lazy
    Adam steps over ids [1, 2], [3, 4], [3, 4] leave rows 1 and 2 where
    step 1 put them, in both packages."""
    w0 = onp.random.RandomState(0).rand(10, 4).astype(onp.float32)

    def run(mx):
        e = _embed(mx, 10, 4, w0, sparse_grad=True)
        assert e.weight.grad_stype == "row_sparse"
        tr = mx.gluon.Trainer(e.collect_params(), "adam",
                              {"learning_rate": 0.1})
        seen = []
        for ids in ([1, 2], [3, 4], [3, 4]):
            x = mx.nd.array(onp.array(ids, onp.int32), dtype="int32")
            with mx.autograd.record():
                loss = (e(x) ** 2).sum()
            loss.backward()
            tr.step(1)
            seen.append(_weight(mx, e.weight))
        return seen

    got, ref = both(run)
    for g, r in zip(got, ref):
        same(g, r)
    onp.testing.assert_array_equal(got[2][[1, 2]], got[0][[1, 2]])


def test_embedding_weight_initializer_is_used():
    with mt.cpu():
        e = mt.gluon.nn.Embedding(6, 3,
                                  weight_initializer=mt.initializer.One())
        e.initialize()
        onp.testing.assert_array_equal(host(e.weight), onp.ones((6, 3)))
    with pytest.raises(TypeError):
        mt.gluon.nn.Embedding(6, 3, sparse_gradient=True)


def test_trainer_dense_grad_for_non_lazy_optimizer():
    """A row_sparse grad_stype with an optimizer without a lazy rule keeps
    the dense gradient."""
    w0 = onp.random.RandomState(4).rand(20, 4).astype(onp.float32)

    def run(mx):
        embed = _embed(mx, 20, 4, w0)
        embed.weight.grad_stype = "row_sparse"
        tr = mx.gluon.Trainer(embed.collect_params(), "adagrad",
                              {"learning_rate": 0.5})
        with mx.autograd.record():
            loss = (embed(mx.nd.array(onp.array([2, 5], onp.int32),
                                      dtype="int32")) ** 2).sum()
        loss.backward()
        tr.step(1)
        return _weight(mx, embed.weight)

    got, ref = both(run)
    same(got, ref)


def test_parameter_takes_the_sparse_stypes():
    p = mt.gluon.Parameter("w", shape=(3, 2), grad_stype="row_sparse",
                           stype="row_sparse")
    assert (p.stype, p.grad_stype) == ("row_sparse", "row_sparse")
    with pytest.raises(mt.MXNetError):
        mt.gluon.Parameter("w", shape=(3, 2), grad_stype="coo")


# ---- matrix factorization, both tables sparse -----------------------------


class _MF:
    """user . item over two Embedding(sparse_grad=True) tables."""

    def __init__(self, mx, users, items, dim, wu, wi):
        self.mx = mx
        self.u = _embed(mx, users, dim, wu, sparse_grad=True)
        self.i = _embed(mx, items, dim, wi, sparse_grad=True)

    def params(self):
        p = self.u.collect_params()
        p.update({"i_" + k: v for k, v in self.i.collect_params().items()})
        return p

    def __call__(self, uid, iid):
        return (self.u(uid) * self.i(iid)).sum(axis=1)


@pytest.mark.parametrize("opt_name,kw", [
    ("adam", {"learning_rate": 0.05}),
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9})])
def test_matrix_factorization_matches_jax(opt_name, kw):
    rs = onp.random.RandomState(11)
    users, items, dim, B = 40, 30, 8, 16
    wu = rs.normal(0, 0.1, (users, dim)).astype(onp.float32)
    wi = rs.normal(0, 0.1, (items, dim)).astype(onp.float32)
    # 8 distinct ids a table, each twice: repeats to sum, and one row count
    # a step, so the JAX side compiles its row ops once
    def ids(n):
        return rs.permutation(onp.repeat(rs.choice(n, 8, replace=False), 2))

    batches = [(ids(users), ids(items), rs.rand(B).astype(onp.float32) * 5)
               for _ in range(3)]

    def run(mx):
        net = _MF(mx, users, items, dim, wu, wi)
        tr = mx.gluon.Trainer(net.params(), opt_name, dict(kw))
        loss_fn = mx.gluon.loss.L2Loss()
        losses = []
        for u, i, r in batches:
            uid = mx.nd.array(u.astype(onp.int32), dtype="int32")
            iid = mx.nd.array(i.astype(onp.int32), dtype="int32")
            with mx.autograd.record():
                loss = loss_fn(net(uid, iid), mx.nd.array(r))
            loss.backward()
            tr.step(B)
            losses.append(float(loss.mean().asnumpy()))
        return losses, _weight(mx, net.u.weight), _weight(mx, net.i.weight)

    (gl, gu, gi), (rl, ru, ri) = both(run)
    onp.testing.assert_allclose(gl, rl, rtol=1e-5, atol=1e-5)
    same(gu, ru, 1e-5)
    same(gi, ri, 1e-5)
    touched = set(int(u) for u, _, _ in batches for u in u)
    untouched = sorted(set(range(users)) - touched)
    onp.testing.assert_array_equal(gu[untouched], wu[untouched])


# ---- the reference's .params with sparse records ---------------------------


def _record(stype, shape, data, aux):
    """One V2 NDArray record of the reference's format (ndarray.cc
    NDArray::Save): stype, storage shape, shape, context, dtype flag, aux
    dtype flags and shapes, data, aux data."""
    def shp(s):
        return struct.pack("<i", len(s)) + struct.pack("<%dq" % len(s), *s)

    flags = {onp.dtype(onp.float32): 0, onp.dtype(onp.int64): 6}
    out = struct.pack("<I", 0xF993FAC9) + struct.pack("<i", stype)
    out += (shp(data.shape) if stype else b"") + shp(shape)
    out += struct.pack("<ii", 1, 0)
    out += struct.pack("<i", flags[data.dtype])
    for a in aux:
        out += struct.pack("<i", flags[a.dtype]) + shp(a.shape)
    out += data.tobytes() + b"".join(a.tobytes() for a in aux)
    return out


def test_reference_params_with_sparse_records_load_in_both(tmp_path):
    rs = onp.random.RandomState(9)
    rsp_rows = rs.rand(2, 3).astype(onp.float32)
    rsp_idx = onp.array([1, 4], onp.int64)
    csr_dense = _rand_sparse(4, 5, 0.5, rs)
    rows, cols = onp.nonzero(csr_dense)
    indptr = onp.concatenate([[0], onp.cumsum(onp.bincount(
        rows, minlength=4))]).astype(onp.int64)
    dense = rs.rand(2, 2).astype(onp.float32)
    recs = [_record(1, (6, 3), rsp_rows, [rsp_idx]),
            _record(2, (4, 5), csr_dense[rows, cols],
                    [indptr, cols.astype(onp.int64)]),
            _record(0, (2, 2), dense, [])]
    keys = [b"embed", b"feats", b"bias"]
    buf = struct.pack("<QQ", 0x112, 0) + struct.pack("<Q", len(recs))
    buf += b"".join(recs) + struct.pack("<Q", len(keys))
    for k in keys:
        buf += struct.pack("<Q", len(k)) + k
    path = str(tmp_path / "sparse.params")
    with open(path, "wb") as f:
        f.write(buf)

    got, ref = both(lambda mx: mx.nd.load(path))
    assert got["embed"].stype == ref["embed"].stype == "row_sparse"
    assert got["feats"].stype == ref["feats"].stype == "csr"
    for k in ("embed", "feats", "bias"):
        same(got[k], ref[k])
    same(got["feats"].indptr, ref["feats"].indptr)
    want = onp.zeros((6, 3), onp.float32)
    want[[1, 4]] = rsp_rows
    same(got["embed"], want)
    same(got["feats"], csr_dense)
