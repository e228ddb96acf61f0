"""Persistence of the PyTorch port against the JAX package, on the CPU: what
one package writes, the other reads.

- ``nd.save``/``nd.load`` in the npz layout and the reference's binary
  ``.params`` format (a bf16 array included), both ways.
- ``Block.save_parameters``/``load_parameters`` on a net holding one
  Dense's parameters under two names, with ``deduplicate`` True and False,
  and ``Block.save_checkpoint``/``load_checkpoint``, both ways.
- ``Trainer.save_states`` of one package into ``load_states`` of the
  other, then 3 steps of the 2-layer BERT of width 64 (dropout 0, SGD with
  momentum) in both, losses and weights within 1e-5.
- ``Trainer.save_checkpoint``/``load_checkpoint`` across packages, also
  into a trainer that lists its parameters in reverse; a ``FusedTrainer``
  checkpoint across packages (Adam's moments a tuple, the step a uint32).
- ``attach_loader``: the ``StreamLoader`` cursor rides the checkpoint,
  also when restored before the loader is attached.
- ``callback.do_checkpoint`` for a Block and for a trainer.
- A restore under a live ``trainer.capture`` program: the restore swaps
  the optimizer state the program closed over, so it is invalidated and
  the next steps equal an uninterrupted run's.  On the CPU the program runs
  its step function eagerly; the CUDA graph half is held by
  ``chip_smoke.py``'s ``checkpoint_resume`` phase only.
- The two repaired faults: ``collect_params`` lists a shared parameter
  under every name, as the JAX package does, and a ``gluon.Trainer`` over
  such a net matches the JAX package's after 3 steps (which updates the
  shared weight once per name: ``ROADMAP.md`` Queue 3).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, gluon, parallel
from mxnet_tpu_torch import checkpoint as ckpt
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

CPU = mx.cpu()
TOL = 1e-5


def _np(v):
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def _jax_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _port_params(net):
    return {k: p.detach().numpy().copy()
            for k, p in net.collect_params().items()}


def _close(a, b, tol=TOL):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0,
                                   atol=tol * max(1.0, np.abs(b[k]).max()),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# nd.save / nd.load
# ---------------------------------------------------------------------------

def _arrays():
    rs = np.random.RandomState(0)
    return [rs.rand(3, 4).astype(np.float32),
            rs.randint(-9, 9, (5,)).astype(np.int32),
            rs.rand(2, 2, 2).astype(np.float16)]


def _pack(kind, items):
    if kind == "single":
        return items[0]
    if kind == "list":
        return list(items)
    return {"w%d" % i: v for i, v in enumerate(items)}


def _unpack(kind, loaded):
    if kind == "single":
        # the reference format keeps no "single" mark: a list of one
        return [_np(loaded[0] if isinstance(loaded, list) else loaded)]
    if kind == "list":
        return [_np(v) for v in loaded]
    return [_np(loaded["w%d" % i]) for i in range(len(loaded))]


@pytest.mark.parametrize("fmt", ["npz", "reference"])
@pytest.mark.parametrize("kind", ["single", "list", "dict"])
@pytest.mark.parametrize("way", ["jax_to_port", "port_to_jax"])
def test_nd_save_load_across_packages(tmp_path, fmt, kind, way):
    f = str(tmp_path / "x.params")
    want = _arrays()
    if way == "jax_to_port":
        jmx.nd.save(f, _pack(kind, [jmx.nd.array(a, dtype=a.dtype)
                                    for a in want]), format=fmt)
        got = _unpack(kind, mx.nd.load(f, ctx=CPU))
    else:
        mx.nd.save(f, _pack(kind, [mx.nd.array(a, ctx=CPU, dtype=a.dtype)
                                   for a in want]), format=fmt)
        got = _unpack(kind, jmx.nd.load(f))
    if kind == "single":
        want = want[:1]
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with open(f, "rb") as fh:
        assert (fh.read(8) == b"\x12\x01\x00\x00\x00\x00\x00\x00") \
            == (fmt == "reference")


@pytest.mark.parametrize("fmt", ["npz", "reference"])
def test_nd_bfloat16_across_packages(tmp_path, fmt):
    """A bf16 array keeps its bits: the reference format's dtype flag 12
    both ways; in npz the port writes (and reads) the ``<V2`` records the
    JAX package writes for an ``ml_dtypes.bfloat16`` array."""
    import ml_dtypes

    bits = np.arange(-7, 5, dtype=np.int16) * 331
    t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    f = str(tmp_path / "bf.params")
    mx.nd.save(f, {"w": mx.nd.array(t, ctx=CPU)}, format=fmt)
    back = mx.nd.load(f, ctx=CPU)["w"]
    assert back._data.dtype == torch.bfloat16
    assert torch.equal(back._data.view(torch.int16), torch.from_numpy(bits))
    g = str(tmp_path / "jbf.params")
    jmx.nd.save(g, {"w": jmx.nd.array(bits.view(ml_dtypes.bfloat16),
                                      dtype="bfloat16")}, format=fmt)
    got = mx.nd.load(g, ctx=CPU)["w"]
    assert got._data.dtype == torch.bfloat16
    assert np.array_equal(got._data.view(torch.int16).numpy(), bits)
    if fmt == "reference":
        j = jmx.nd.load(f)["w"].asnumpy()
        assert np.array_equal(j.view(np.int16), bits)
    else:
        with np.load(f) as p, np.load(g) as q:
            assert p["w"].dtype.str == q["w"].dtype.str
            assert p["w"].tobytes() == q["w"].tobytes()


# ---------------------------------------------------------------------------
# Block parameters, tied
# ---------------------------------------------------------------------------

def _tied(nn, init):
    net = nn.HybridSequential()
    a, b = nn.Dense(4, in_units=4), nn.Dense(4, in_units=4)
    net.add(a, b)
    if init is not None:
        init(net)
    b.share_parameters(a.collect_params())
    return net


def _jax_tied(seed=0):
    jmx.random.seed(seed)
    return _tied(jnn, lambda n: n.initialize())


def _port_tied(seed=0):
    mx.random.seed(seed)
    return _tied(tnn, lambda n: n.initialize(ctx=CPU))


def test_collect_params_lists_every_name_of_a_shared_parameter():
    jnet, tnet = _jax_tied(), _port_tied()
    assert list(tnet.collect_params()) == list(jnet.collect_params()) \
        == ["0.weight", "0.bias", "1.weight", "1.bias"]
    p = tnet.collect_params()
    assert p["0.weight"] is p["1.weight"] and p["0.bias"] is p["1.bias"]
    assert list(tnet.collect_params("1.*")) == \
        list(jnet.collect_params("1.*"))
    # weights of the JAX net carry over by every name
    convert.load_jax_params(tnet, _jax_params(jnet))
    _close(_port_params(tnet), _jax_params(jnet), 0)


@pytest.mark.parametrize("path", ["stitched", "captured"])
@pytest.mark.parametrize("optimizer,opts", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01, "wd": 0.1})])
def test_trainer_over_a_shared_parameter_matches_jax(optimizer, opts, path):
    """Both names of the shared parameter reach the trainer, as in the
    JAX package; 3 steps, stitched or through ``trainer.capture``, agree
    with the JAX package's (one update per name, the second reading the
    weight the first wrote)."""
    jnet, tnet = _jax_tied(), _port_tied()
    convert.load_jax_params(tnet, _jax_params(jnet))
    jtr = jgluon.Trainer(jnet.collect_params(), optimizer, dict(opts))
    ttr = gluon.Trainer(tnet.collect_params(), optimizer, dict(opts))
    program = ttr.capture(tnet, lambda out, y: (out ** 2).sum())
    rs = np.random.RandomState(3)
    for _ in range(3):
        x = rs.rand(5, 4).astype(np.float32)
        with jautograd.record():
            jl = (jnet(jmx.nd.array(x)) ** 2).sum()
        jl.backward()
        jtr.step(5)
        if path == "captured":
            tl = program(torch.from_numpy(x), torch.zeros(5), batch_size=5)
        else:
            with autograd.record():
                tl = (tnet(torch.from_numpy(x)) ** 2).sum()
            tl.backward()
            ttr.step(5)
        np.testing.assert_allclose(tl.item(), float(jl.asnumpy()),
                                   rtol=TOL)
    _close(_port_params(tnet), _jax_params(jnet))
    if path == "captured":
        report = program.report()
        assert not report["fallbacks"] and report["paths"]["captured"] == 3


def test_grouped_apply_holds_a_shared_parameter_once_a_group():
    """The grouped apply gives a parameter's second listing a group of a
    later round: no multi-tensor launch updates one buffer from two list
    entries (on the card their updates would race)."""
    from mxnet_tpu_torch.optimizer import multi_tensor

    tnet = _port_tied()
    ttr = gluon.Trainer(tnet.collect_params(), "adam",
                        {"learning_rate": 0.01})
    items = [(i, p, torch.zeros_like(p)) for i, p in enumerate(ttr._params)]
    for i, p, _ in items:
        ttr._maybe_init_states(i, p)
    groups, eager = multi_tensor.partition(ttr, items)
    assert not eager
    members = [[i for i, _, _ in m] for m in groups.values()]
    assert members == [[0, 1], [2, 3]]
    for m in groups.values():
        assert len({id(p) for _, p, _ in m}) == len(m)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("way", ["jax_to_port", "port_to_jax"])
def test_save_parameters_of_a_tied_net_across_packages(tmp_path, dedup,
                                                       way):
    f = str(tmp_path / "tied.params")
    jsrc, tsrc = _jax_tied(1), _port_tied(1)
    if way == "jax_to_port":
        jsrc.save_parameters(f, deduplicate=dedup)
        dst = _port_tied(2)
        dst.load_parameters(f)
        _close(_port_params(dst), _jax_params(jsrc), 0)
    else:
        tsrc.save_parameters(f, deduplicate=dedup)
        dst = _jax_tied(2)
        dst.load_parameters(f)
        _close(_jax_params(dst), _port_params(tsrc), 0)
    with np.load(f) as npz:
        assert len(npz.files) == (2 if dedup else 4)


@pytest.mark.parametrize("way", ["jax_to_port", "port_to_jax"])
def test_block_checkpoint_of_a_tied_net_across_packages(tmp_path, way):
    root = str(tmp_path / "ck")
    if way == "jax_to_port":
        src = _jax_tied(3)
        src.save_checkpoint(root, step=4)
        dst = _port_tied(4)
        assert dst.load_checkpoint(root) == 4
        _close(_port_params(dst), _jax_params(src), 0)
    else:
        src = _port_tied(3)
        src.save_checkpoint(root, step=4)
        dst = _jax_tied(4)
        assert dst.load_checkpoint(root) == 4
        _close(_jax_params(dst), _port_params(src), 0)
    assert ckpt.CheckpointManager(root).manifest(4)["n_leaves"] == 2


def test_load_parameters_is_strict_and_places_on_ctx(tmp_path):
    f = str(tmp_path / "p.params")
    src = _port_tied(5)
    src.save_parameters(f)
    net = tnn.HybridSequential()
    net.add(tnn.Dense(4, in_units=4))
    with pytest.raises(mx.MXNetError, match="extra parameters"):
        net.load_parameters(f, ctx=CPU)
    net.load_parameters(f, ctx=CPU, ignore_extra=True)
    np.testing.assert_array_equal(net[0].weight.detach().numpy(),
                                  src[0].weight.detach().numpy())
    fresh = _port_tied(6)
    fresh.load_dict({k: v.detach() for k, v in
                     src.collect_params().items()})
    _close(_port_params(fresh), _port_params(src), 0)


# ---------------------------------------------------------------------------
# Trainer states across packages: the 2-layer BERT
# ---------------------------------------------------------------------------

CFG = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=64)
B, T, MASK = 2, 64, 8
OPT = {"learning_rate": 1e-2, "momentum": 0.9}


def _bert_batch(seed):
    rs = np.random.RandomState(seed)
    return dict(
        ids=rs.randint(0, CFG["vocab_size"], (B, T)).astype(np.int32),
        types=(np.arange(T)[None, :] >= T // 2).repeat(B, 0)
        .astype(np.int32),
        pos=np.stack([rs.choice(T, MASK, replace=False) for _ in range(B)])
        .astype(np.int32),
        labels=rs.randint(0, CFG["vocab_size"], (B, MASK)).astype(np.int32),
        weights=np.ones((B, MASK), np.float32),
        nsp=rs.randint(0, 2, (B,)).astype(np.int32))


def _jax_bert_step(net, tr, batch):
    a = {k: jmx.nd.array(v, dtype=str(v.dtype)) for k, v in batch.items()}
    with jautograd.record():
        mlm, nsp = net(a["ids"], a["types"], None, a["pos"])
        loss = jbert.pretraining_loss(mlm, nsp, a["labels"], a["weights"],
                                      a["nsp"])
    loss.backward()
    tr.step(1)
    return float(loss.asnumpy())


def _port_bert_step(net, tr, batch):
    a = {k: torch.from_numpy(v) for k, v in batch.items()}
    with autograd.record():
        mlm, nsp = net(a["ids"], a["types"], None, a["pos"])
        loss = tbert.pretraining_loss(mlm, nsp, a["labels"], a["weights"],
                                      a["nsp"])
    loss.backward()
    tr.step(1)
    return loss.item()


def _bert_pair():
    jnet = jbert.BERTForPretraining(dropout=0.0, **CFG)
    jnet.initialize()
    rs = np.random.RandomState(0)
    init = {k: (rs.randn(*p.shape) * 0.1 + k.endswith(".gamma"))
            .astype(np.float32) for k, p in jnet.collect_params().items()}
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(init[k]))
    tnet = tbert.BERTForPretraining(dropout=0.0, **CFG)
    tnet.initialize(ctx=CPU)
    convert.load_jax_params(tnet, init)
    return (jnet, jgluon.Trainer(jnet.collect_params(), "sgd", dict(OPT)),
            tnet, gluon.Trainer(tnet.collect_params(), "sgd", dict(OPT)))


@pytest.mark.parametrize("way", ["jax_to_port", "port_to_jax"])
def test_save_states_across_packages_then_three_steps(tmp_path, way):
    """One package takes a step and saves its momentum; the other loads it
    (with the weights), and both take the same 3 steps."""
    jnet, jtr, tnet, ttr = _bert_pair()
    f = str(tmp_path / "trainer.states")
    first = _bert_batch(0)
    if way == "jax_to_port":
        _jax_bert_step(jnet, jtr, first)
        jtr.save_states(f)
        convert.load_jax_params(tnet, _jax_params(jnet))
        ttr.load_states(f)
    else:
        _port_bert_step(tnet, ttr, first)
        ttr.save_states(f)
        for k, p in jnet.collect_params().items():
            p.set_data(jmx.nd.array(_port_params(tnet)[k]))
        jtr.load_states(f)
    assert sorted(ttr._states) == sorted(jtr._states)
    for i in ttr._states:
        np.testing.assert_allclose(_np(ttr._states[i]),
                                   jtr._states[i].asnumpy(), rtol=0,
                                   atol=0)
    for s in range(1, 4):
        batch = _bert_batch(s)
        jl = _jax_bert_step(jnet, jtr, batch)
        tl = _port_bert_step(tnet, ttr, batch)
        np.testing.assert_allclose(tl, jl, rtol=TOL)
    _close(_port_params(tnet), _jax_params(jnet))


# ---------------------------------------------------------------------------
# Trainer and FusedTrainer checkpoints across packages
# ---------------------------------------------------------------------------

def _mlp(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8),
            nn.Dense(4, in_units=16))
    return net


def _mlp_pair(reverse=False, optimizer="adam", opts=None):
    opts = opts or {"learning_rate": 1e-2}
    jnet = _mlp(jnn)
    jnet.initialize()
    tnet = _mlp(tnn)
    tnet.initialize(ctx=CPU)
    convert.load_jax_params(tnet, _jax_params(jnet))
    tparams = list(tnet.collect_params().items())
    if reverse:
        tparams = tparams[::-1]
    return (jnet, jgluon.Trainer(jnet.collect_params(), optimizer,
                                 dict(opts)),
            tnet, gluon.Trainer(dict(tparams), optimizer, dict(opts)))


def _mlp_step(pkg, net, tr, seed):
    x = np.random.RandomState(seed).rand(8, 8).astype(np.float32)
    if pkg == "jax":
        with jautograd.record():
            loss = (net(jmx.nd.array(x)) ** 2).sum()
        loss.backward()
    else:
        with autograd.record():
            loss = (net(torch.from_numpy(x)) ** 2).sum()
        loss.backward()
    tr.step(8)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("way", ["jax_to_port", "port_to_jax"])
def test_trainer_checkpoint_across_packages(tmp_path, way, reverse):
    """Adam's moments and per-parameter counts cross by name, also into a
    port trainer that lists its parameters in reverse."""
    root = str(tmp_path / "tr")
    jnet, jtr, tnet, ttr = _mlp_pair(reverse)
    if way == "jax_to_port":
        for s in range(3):
            _mlp_step("jax", jnet, jtr, s)
        jtr.save_checkpoint(root)
        assert ttr.load_checkpoint(root) == 3
        assert ttr.step_count == 3
        assert ttr.optimizer.num_update == jtr.optimizer.num_update
    else:
        for s in range(3):
            _mlp_step("port", tnet, ttr, s)
        ttr.save_checkpoint(root)
        assert jtr.load_checkpoint(root) == 3
    _close(_port_params(tnet), _jax_params(jnet), 0)
    for s in (7, 8):
        _mlp_step("jax", jnet, jtr, s)
        _mlp_step("port", tnet, ttr, s)
    _close(_port_params(tnet), _jax_params(jnet))


def _fused_batch(seed):
    rs = np.random.RandomState(seed)
    return rs.rand(8, 8).astype(np.float32), rs.randint(0, 4, 8)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("way", ["jax_to_port", "port_to_jax"])
def test_fused_trainer_checkpoint_across_packages(tmp_path, way,
                                                  optimizer):
    root = str(tmp_path / "fused")
    opts = {"learning_rate": 1e-2, "momentum": 0.9} \
        if optimizer == "sgd" else {"learning_rate": 1e-2}
    jnet = _mlp(jnn)
    jnet.initialize()
    tnet = _mlp(tnn)
    tnet.initialize(ctx=CPU)
    convert.load_jax_params(tnet, _jax_params(jnet))
    jtr = jparallel.FusedTrainer(jnet, loss="softmax_ce",
                                 optimizer=optimizer, optimizer_params=opts)
    ttr = parallel.FusedTrainer(tnet, loss="softmax_ce",
                                optimizer=optimizer, optimizer_params=opts)
    if way == "jax_to_port":
        for s in range(2):
            jtr.step(*_fused_batch(s))
        jtr.save_checkpoint(root)
        assert ttr.load_checkpoint(root) == 2   # before the first step
    else:
        for s in range(2):
            ttr.step(*_fused_batch(s))
        path = ttr.save_checkpoint(root)
        assert os.path.basename(path) == "ckpt-00000002"
        assert jtr.load_checkpoint(root) == 2
    manifest = ckpt.CheckpointManager(root).manifest(2)
    names = [e["name"] for e in manifest["leaves"]]
    assert "step" in names
    if optimizer == "adam":
        assert "opt_state/0.weight/1" in names
    step_leaf = manifest["leaves"][names.index("step")]
    assert step_leaf["dtype"] == "uint32" and step_leaf["shape"] == []
    for s in (5, 6):
        x, y = _fused_batch(s)
        jl = float(np.asarray(jtr.step(x, y).asnumpy()))
        tl = ttr.step(torch.from_numpy(x), torch.from_numpy(y)).item()
        np.testing.assert_allclose(tl, jl, rtol=TOL)
    jtr.sync_block()
    _close(_port_params(tnet), _jax_params(jnet))


# ---------------------------------------------------------------------------
# the data cursor, callbacks, a captured restore
# ---------------------------------------------------------------------------

def test_attach_loader_cursor_rides_the_checkpoint(tmp_path):
    from mxnet_tpu_torch import data as tdata
    from mxnet_tpu_torch import recordio as trec

    paths = []
    rs = np.random.RandomState(0)
    for s in range(2):
        idx = str(tmp_path / ("s%d.idx" % s))
        rec = str(tmp_path / ("s%d.rec" % s))
        w = trec.MXIndexedRecordIO(idx, rec, "w")
        for i in range(8):
            img = rs.randint(0, 255, (3, 3, 3)).astype(np.uint8)
            w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i), i, 0),
                                         img, img_fmt=".npy"))
        w.close()
        paths.append(rec)
    root = str(tmp_path / "ck")
    _, _, tnet, ttr = _mlp_pair()
    loader = tdata.StreamLoader(paths, 2, seed=5)
    ttr.attach_loader(loader)
    with mx.cpu():
        it = iter(loader)
        for _ in range(3):
            next(it)
        it.close()
    _mlp_step("port", tnet, ttr, 0)
    ttr.save_checkpoint(root)
    want = loader.state_dict()
    assert want["batch"] == 3
    # attached first, then restored
    _, _, net2, tr2 = _mlp_pair()
    loader2 = tdata.StreamLoader(paths, 2, seed=5)
    tr2.attach_loader(loader2)
    tr2.load_checkpoint(root)
    assert loader2.state_dict() == want
    # restored first: the cursor waits for attach_loader
    _, _, net3, tr3 = _mlp_pair()
    tr3.load_checkpoint(root)
    loader3 = tdata.StreamLoader(paths, 2, seed=5)
    tr3.attach_loader(loader3)
    assert loader3.state_dict() == want


def test_do_checkpoint_for_a_block_and_a_trainer(tmp_path):
    _, _, tnet, ttr = _mlp_pair()
    prefix = str(tmp_path / "run")
    cb = mx.callback.do_checkpoint(prefix, period=2)
    cb(0, tnet)                                  # not on the period
    assert not os.path.exists(prefix + "-0001.params")
    cb(1, tnet)
    fresh = _mlp(tnn)
    fresh.initialize(ctx=CPU)
    fresh.load_parameters(prefix + "-0002.params")
    _close(_port_params(fresh), _port_params(tnet), 0)
    # the JAX package reads the port's file
    jnet = _mlp(jnn)
    jnet.initialize()
    jnet.load_parameters(prefix + "-0002.params")
    _close(_jax_params(jnet), _port_params(tnet), 0)
    _mlp_step("port", tnet, ttr, 0)
    cb(3, ttr)
    mgr = ckpt.CheckpointManager(prefix + "-ckpt")
    assert mgr.steps() == [4] and mgr.validate()[4]["ok"]
    with pytest.raises(mx.MXNetError, match="nothing was written"):
        cb(5, object())


def test_restore_under_a_captured_program(tmp_path):
    """A restore replaces the optimizer state a captured program closed
    over: the program is invalidated, and after two steps off the path
    and the restore, steps 4-6 equal the uninterrupted run's."""
    root = str(tmp_path / "cap")

    def run():
        mx.random.seed(0)
        net = _mlp(tnn)
        net.initialize(ctx=CPU)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 1e-2})
        prog = tr.capture(net, gluon.loss.L2Loss())
        return net, tr, prog

    rs = np.random.RandomState(1)
    xs = [torch.from_numpy(rs.rand(8, 8).astype(np.float32))
          for _ in range(8)]
    ys = [torch.from_numpy(rs.rand(8, 4).astype(np.float32))
          for _ in range(8)]
    net, tr, prog = run()
    want = [prog(xs[i], ys[i]).sum().item() for i in range(3)]
    tr.save_checkpoint(root)
    want += [prog(xs[i], ys[i]).sum().item() for i in range(3, 6)]
    want_w = _port_params(net)

    net, tr, prog = run()
    got = [prog(xs[i], ys[i]).sum().item() for i in range(3)]
    prog(xs[6], ys[6])
    prog(xs[7], ys[7])
    invalidated = []
    orig = prog.invalidate
    prog.invalidate = lambda: (invalidated.append(1), orig())[1]
    assert tr.load_checkpoint(root) == 3
    assert invalidated == [1]
    got += [prog(xs[i], ys[i]).sum().item() for i in range(3, 6)]
    assert got == want
    _close(_port_params(net), want_w, 0)
    rep = prog.report()
    assert rep["paths"]["stitched"] == 0 and not rep["fallbacks"]


@pytest.mark.parametrize("rows", [3, 100])
def test_fixed_order_gradients_equal_pytorchs(rows):
    """On the card ``ops.nn.embedding`` and ``take_along_axis`` sum their
    repeated rows' gradients in a fixed order (``index_put_``; a table of
    at most ``_SMALL_TABLE`` rows by a one-hot product), so a resumed step
    repeats the uninterrupted one bit for bit; the sums are PyTorch's own
    (run here through the same functions, in float64)."""
    import torch.nn.functional as tf

    from mxnet_tpu_torch.ops import nn as ops_nn

    assert (rows <= ops_nn._SMALL_TABLE) == (rows == 3)
    rs = np.random.RandomState(0)
    w = torch.from_numpy(rs.randn(rows, 5)).requires_grad_()
    ids = torch.from_numpy(rs.randint(0, rows, (4, 9)))   # repeats
    g = torch.from_numpy(rs.randn(4, 9, 5))
    got, = torch.autograd.grad(ops_nn._Embedding.apply(ids, w), w, g)
    want, = torch.autograd.grad(tf.embedding(ids, w), w, g)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    x = torch.from_numpy(rs.randn(2, 6, 5)).requires_grad_()
    idx = torch.from_numpy(rs.randint(0, 6, (2, 8, 5)))   # repeats
    gx = torch.from_numpy(rs.randn(2, 8, 5))
    rows = torch.from_numpy(rs.randint(0, 6, (2, 8)))     # repeats
    for ix in (idx, rows.unsqueeze(-1).expand(2, 8, 5)):   # rows summed
        for axis in (1, -2):
            got, = torch.autograd.grad(
                ops_nn._TakeAlongAxis.apply(x, ix, axis), x, gx)
            want, = torch.autograd.grad(torch.gather(x, 1, ix), x, gx)
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.autograd.gradcheck(
        lambda t: ops_nn._TakeAlongAxis.apply(t, idx, 1), (x,))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_small_table_sums_16_bit_gradients_in_float64(dtype):
    """The one-hot product of a small table sums 16-bit gradients in
    float64 and rounds once: each row within one unit of the last place
    of the float64 sum of the same values, over runs of ~200 repeats."""
    from mxnet_tpu_torch.ops import nn as ops_nn

    rs = np.random.RandomState(1)
    w = torch.zeros(2, 8, dtype=dtype, requires_grad=True)
    ids = torch.from_numpy(rs.randint(0, 2, (4, 100)))
    g = torch.from_numpy(rs.randn(4, 100, 8)).to(dtype)
    got, = torch.autograd.grad(ops_nn._Embedding.apply(ids, w), w, g)
    assert got.dtype == dtype
    g64 = g.double().reshape(-1, 8)
    want = torch.stack([g64[ids.reshape(-1) == r].sum(0) for r in (0, 1)])
    ulp = torch.finfo(dtype).eps * want.abs()
    assert ((got.double() - want).abs() <= ulp).all()
