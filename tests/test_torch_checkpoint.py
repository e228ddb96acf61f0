"""``mx.checkpoint`` of the PyTorch port (``mxnet_tpu_torch.checkpoint``) on
the CPU, against the JAX package.

1. The cases of ``tests/python/unittest/test_checkpoint.py``, ported: the
   sharded layout round trip, template and partial restores, retention,
   torn and foreign directories, a crash mid-overwrite and before the
   ``COMMITTED`` marker (through the port's ``resilience.inject``), validate
   and quarantine, the transient-IO retry, ``atomic_file``, async saves
   that neither block past the snapshot nor alias the source, the bounded
   FIFO and failures surfacing on ``wait()``; then the Gluon trainer and
   block bundles and ``do_checkpoint``.
2. Both directions across packages: a step the JAX package writes restores
   in the port with byte-equal leaves and a clean ``validate()``, and a
   step the port writes restores through ``mxnet_tpu.checkpoint``.
3. bfloat16 leaves with ``ml_dtypes`` hidden from the port (a subprocess):
   a JAX-written bf16 leaf reads back bit for bit, and the port writes the
   bytes and manifest entry the JAX package writes.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import checkpoint as jckpt
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint as ckpt
from mxnet_tpu_torch import resilience, telemetry
from mxnet_tpu_torch.checkpoint import layout
from mxnet_tpu_torch.gluon import nn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _clean():
    telemetry.enable()
    resilience.clear()
    yield
    resilience.clear()


def _tree():
    rs = np.random.RandomState(0)
    return {"params": {"w": torch.from_numpy(
                           rs.rand(64, 64).astype(np.float32)),
                       "b": torch.from_numpy(rs.rand(64).astype(np.float32))},
            "opt": (torch.from_numpy(rs.rand(64, 64).astype(np.float32)),
                    None),
            "step": 7}


def _leaves(tree):
    return [np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for v in layout.tree_leaves(tree)]


def _assert_tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# layout + round trip
# ---------------------------------------------------------------------------

def test_roundtrip_sharded_layout(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), group_bytes=1024)
    path = mgr.save(10, _tree())
    names = sorted(os.listdir(path))
    assert layout.COMMITTED in names and layout.MANIFEST in names
    assert any(n.startswith("leaf_") for n in names)
    assert any(n.startswith("group_") for n in names)
    with open(os.path.join(path, layout.MANIFEST)) as f:
        manifest = json.load(f)
    assert manifest["format"] == ckpt.FORMAT == jckpt.FORMAT
    assert manifest["step"] == 10 and manifest["n_leaves"] == 4
    leaf_names = [e["name"] for e in manifest["leaves"]]
    assert "params/w" in leaf_names and "opt/0" in leaf_names
    for e in manifest["leaves"]:
        assert e["file"] in manifest["files"]

    step, tree = mgr.restore(ctx=CPU)
    assert step == 10
    _assert_tree_equal(tree, _tree())
    assert tree["params"]["w"].dtype == torch.float32
    assert tree["opt"][1] is None and isinstance(tree["opt"], tuple)
    assert int(tree["step"]) == 7 and tree["step"].dim() == 0


def test_template_restore_keeps_dtype_and_structure(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    tmpl = _tree()
    tmpl["params"]["w"] = tmpl["params"]["w"].half()
    step, tree = mgr.restore(tmpl)
    assert tree["params"]["w"].dtype == torch.float16
    assert isinstance(tree["opt"], tuple)


def test_partial_restore_reads_subset(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), group_bytes=1024)
    mgr.save(3, _tree())
    sub = mgr.load_leaves(select=lambda n: n.startswith("params/"))
    assert sorted(sub) == ["params/b", "params/w"]
    np.testing.assert_array_equal(sub["params/w"],
                                  _tree()["params"]["w"].numpy())


def test_max_keep_zero_keeps_everything(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), max_keep=0)
    for s in (1, 2, 3, 4, 5):
        path = mgr.save(s, {"x": torch.zeros(2)})
    assert os.path.isdir(path)
    assert mgr.steps() == [1, 2, 3, 4, 5]


def test_small_leaves_split_into_bounded_groups(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), group_bytes=1024)
    tree = {"l%02d" % i: torch.zeros(128) for i in range(8)}  # 512 B each
    path = mgr.save(1, tree)
    groups = sorted(n for n in os.listdir(path) if n.startswith("group_"))
    assert len(groups) > 1, groups
    _assert_tree_equal(mgr.restore(ctx=CPU)[1], tree)


def test_validate_flags_missing_manifest_and_missing_step(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(2)})
    os.unlink(os.path.join(mgr._dir_for(1), layout.MANIFEST))
    report = mgr.validate(quarantine=True)
    assert not report[1]["ok"]
    assert any("MANIFEST" in e for e in report[1]["errors"])
    report = mgr.validate(step=999, quarantine=True)
    assert not report[999]["ok"]
    assert "missing directory" in report[999]["errors"][0]


def test_retention_max_keep_and_keep_every(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), max_keep=2, keep_every=20)
    for s in (10, 20, 25, 30):
        mgr.save(s, {"x": torch.zeros(4)})
    assert mgr.steps() == [20, 25, 30]


def test_leaf_paths_escape_separator(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": {"b": torch.ones(2)}, "a/b": torch.zeros(2)})
    leaves = mgr.load_leaves()
    assert sorted(leaves) == ["a/b", "a\\/b"]
    np.testing.assert_array_equal(leaves["a/b"], np.ones(2, np.float32))
    np.testing.assert_array_equal(leaves["a\\/b"], np.zeros(2, np.float32))


def test_restore_without_ctx_wants_the_card(tmp_path, monkeypatch):
    """No fallback: without ``ctx`` and without a card a restore raises
    (the default context is the card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(2)})
    with pytest.raises(mx.MXNetError, match=r"ctx=mx\.cpu\(\)"):
        mgr.restore()


# ---------------------------------------------------------------------------
# crash consistency
# ---------------------------------------------------------------------------

def test_steps_ignores_torn_and_foreign_dirs(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(5, _tree())
    torn = tmp_path / "ckpt-00000099"
    torn.mkdir()
    (torn / layout.MANIFEST).write_text("{}")
    (tmp_path / "ckpt-notanumber").mkdir()
    assert mgr.steps() == [5] and mgr.latest_step() == 5
    assert ckpt.latest_step(str(tmp_path)) == 5
    with pytest.raises(mx.MXNetError, match="torn"):
        mgr.restore(step=99, ctx=CPU)


def test_crash_mid_overwrite_preserves_previous(tmp_path, monkeypatch):
    """Kill the commit between parking the old directory and publishing
    the new one: a fresh manager promotes the parked copy back."""
    mgr = ckpt.CheckpointManager(str(tmp_path))
    original = {"x": torch.arange(8, dtype=torch.float32)}
    final = mgr.save(5, original)
    real_rename = os.rename

    def dying_rename(src, dst):
        if dst == final and ".saving-" in src:
            raise RuntimeError("simulated crash mid-commit")
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", dying_rename)
    with pytest.raises(RuntimeError, match="simulated crash"):
        mgr.save(5, {"x": torch.zeros(8)})
    monkeypatch.undo()
    mgr2 = ckpt.CheckpointManager(str(tmp_path))
    assert mgr2.steps() == [5]
    _, tree = mgr2.restore(ctx=CPU)
    np.testing.assert_array_equal(tree["x"].numpy(), original["x"].numpy())


@pytest.mark.parametrize("kind", ["fatal", "abort"])
def test_crash_before_marker_never_shadows_latest(tmp_path, kind):
    """The ``checkpoint_marker`` site fires after the shards and the
    manifest are durable and before the ``COMMITTED`` marker: a raise
    (``fatal``), or a hard exit of the writing process (``abort``, in a
    subprocess), leaves a torn directory that no restore trusts."""
    mgr = ckpt.CheckpointManager(str(tmp_path))
    good = {"x": torch.ones(4)}
    mgr.save(7, good)
    if kind == "fatal":
        resilience.plan("checkpoint_marker@0:fatal")
        with pytest.raises(resilience.InjectedFault):
            mgr.save(8, {"x": torch.zeros(4)})
    else:
        code = ("import sys, torch; sys.path.insert(0, %r)\n"
                "from mxnet_tpu_torch import checkpoint as c\n"
                "c.CheckpointManager(%r).save(8, {'x': torch.zeros(4)})\n"
                % (ROOT, str(tmp_path)))
        env = dict(os.environ, MXNET_FAULTS="checkpoint_marker@0:abort")
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == resilience.inject.ABORT_EXIT_CODE, out
        torn = [n for n in os.listdir(tmp_path) if n.startswith(".saving-")]
        assert torn and os.path.isfile(
            tmp_path / torn[0] / layout.MANIFEST)
    mgr2 = ckpt.CheckpointManager(str(tmp_path))
    assert mgr2.latest_step() == 7
    step, tree = mgr2.restore(ctx=CPU)
    assert step == 7
    np.testing.assert_array_equal(tree["x"].numpy(), np.ones(4, np.float32))


def test_validate_detects_and_quarantines_corrupt_shard(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), group_bytes=1024)
    mgr.save(1, {"x": torch.ones(4)})
    mgr.save(2, _tree())
    d = mgr._dir_for(2)
    shard = sorted(n for n in os.listdir(d)
                   if n.endswith((".npy", ".npz")))[0]
    with open(os.path.join(d, shard), "r+b") as f:
        f.seek(12)
        f.write(b"\xde\xad\xbe\xef")
    report = mgr.validate()
    assert report[1]["ok"] and not report[2]["ok"]
    assert any("checksum mismatch" in e for e in report[2]["errors"])
    report = mgr.validate(quarantine=True)
    assert report[2]["quarantined"].endswith(".corrupt")
    assert mgr.steps() == [1]
    step, tree = mgr.restore(ctx=CPU)
    assert step == 1
    np.testing.assert_array_equal(tree["x"].numpy(), np.ones(4, np.float32))


@pytest.mark.parametrize("how", ["inject", "oserror"])
def test_retry_recovers_from_transient_io_error(tmp_path, monkeypatch, how):
    """A transient I/O fault of a commit attempt (the ``checkpoint_commit``
    site's ``io`` kind, or a real ``OSError`` writing the manifest) is
    retried with backoff and the step commits whole."""
    mgr = ckpt.CheckpointManager(str(tmp_path), io_retries=3,
                                 retry_backoff=0.01)
    before = telemetry.value("checkpoint_retries_total")
    fired = telemetry.value("resilience_faults_injected_total",
                            {"site": "checkpoint_commit"})
    if how == "inject":
        resilience.plan("checkpoint_commit@0:io")
    else:
        real_write = layout.write_file_durable
        fails = {"n": 1}

        def flaky_write(path, data):
            if fails["n"] and os.path.basename(path) == layout.MANIFEST:
                fails["n"] -= 1
                raise OSError("transient I/O error")
            return real_write(path, data)

        monkeypatch.setattr(layout, "write_file_durable", flaky_write)
    path = mgr.save(4, {"x": torch.ones(2)})
    assert os.path.isdir(path)
    assert telemetry.value("checkpoint_retries_total") == before + 1
    if how == "inject":
        assert telemetry.value("resilience_faults_injected_total",
                               {"site": "checkpoint_commit"}) == fired + 1
    assert mgr.validate()[4]["ok"]


def test_atomic_file_preserves_existing_on_crash(tmp_path, monkeypatch):
    target = tmp_path / "model.params"
    ckpt.atomic_file(str(target), b"good data")

    def dying_rename(src, dst):
        raise RuntimeError("simulated crash")

    monkeypatch.setattr(os, "rename", dying_rename)
    with pytest.raises(RuntimeError):
        ckpt.atomic_file(str(target), b"half written garbage")
    monkeypatch.undo()
    assert target.read_bytes() == b"good data"


# ---------------------------------------------------------------------------
# async saves
# ---------------------------------------------------------------------------

def _gated(mgr):
    gate = threading.Event()
    real_commit = mgr._commit_once

    def gated_commit(step, spec, host, dtypes=None):
        gate.wait(5.0)
        return real_commit(step, spec, host, dtypes)

    mgr._commit_once = gated_commit
    return gate


def test_async_save_does_not_block_past_snapshot(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    gate = _gated(mgr)
    snap_before = telemetry.get_metric(
        "checkpoint_snapshot_seconds")._default.count
    t0 = time.perf_counter()
    fut = mgr.save_async(1, _tree())
    submit_time = time.perf_counter() - t0
    assert not fut.done() and submit_time < 2.0
    assert telemetry.get_metric(
        "checkpoint_snapshot_seconds")._default.count == snap_before + 1
    gate.set()
    path = fut.result(timeout=30)
    assert path == mgr._dir_for(1) and mgr.wait() == path
    assert telemetry.value("checkpoint_async_queue_depth") == 0
    assert mgr.steps() == [1]


@pytest.mark.parametrize("kind", ["tensor", "numpy", "parameter"])
def test_snapshot_copies_not_aliases(tmp_path, kind):
    """The snapshot copies: writing the source in place after
    ``save_async`` (as the foreach and grouped updates write parameters)
    does not reach the committed step."""
    mgr = ckpt.CheckpointManager(str(tmp_path))
    gate = _gated(mgr)
    want = np.arange(16, dtype=np.float32)
    src = {"tensor": torch.from_numpy(want.copy()),
           "numpy": want.copy(),
           "parameter": mx.gluon.Parameter(data=torch.from_numpy(
               want.copy()))}[kind]
    fut = mgr.save_async(1, {"x": src})
    with torch.no_grad():
        src[:] = -1.0
    gate.set()
    fut.result(timeout=30)
    _, tree = mgr.restore(ctx=CPU)
    np.testing.assert_array_equal(tree["x"].numpy(), want)


def test_async_bounded_inflight_and_fifo(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), max_keep=None,
                                 max_inflight=2)
    futs = [mgr.save_async(s, {"x": torch.full((4,), float(s))})
            for s in range(1, 5)]
    assert mgr.wait() == mgr._dir_for(4)
    assert all(f.done() for f in futs)
    assert mgr.steps() == [1, 2, 3, 4]


def test_async_save_failure_surfaces_on_wait(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), io_retries=1)

    def broken_commit(step, spec, host, dtypes=None):
        raise OSError("disk on fire")

    mgr._commit_once = broken_commit
    mgr.save_async(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError, match="disk on fire"):
        mgr.wait()
    assert mgr.wait() is None


def test_legacy_layout_restores(tmp_path):
    """A step in the pre-manifest layout (``leaves.npz`` + ``meta.json``,
    no marker) is listed, validates as legacy and restores."""
    tree = {"a": np.arange(4, dtype=np.float32), "b": (np.ones(2), None)}
    d = tmp_path / "ckpt-00000012"
    d.mkdir()
    leaves = [tree["a"], np.asarray(tree["b"][0])]
    np.savez(d / "leaves.npz",
             **{"leaf_%d" % i: v for i, v in enumerate(leaves)})
    (d / "meta.json").write_text(json.dumps(
        {"step": 12, "n_leaves": 2, "spec": layout.tree_spec(tree)}))
    mgr = ckpt.CheckpointManager(str(tmp_path))
    assert mgr.steps() == [12] and mgr.validate()[12]["legacy"]
    step, restored = mgr.restore(ctx=CPU)
    assert step == 12
    np.testing.assert_array_equal(restored["a"].numpy(), tree["a"])
    assert restored["b"][1] is None


# ---------------------------------------------------------------------------
# Gluon bundles
# ---------------------------------------------------------------------------

def _gluon_pair(seed, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9}):
    mx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8),
            nn.Dense(4, in_units=16))
    net.initialize(ctx=CPU)
    tr = mx.gluon.Trainer(net.collect_params(), optimizer,
                          dict(optimizer_params))
    return net, tr


def _gluon_step(net, tr, step):
    rs = np.random.RandomState(step)
    x = mx.nd.array(rs.rand(8, 8).astype(np.float32), ctx=CPU)
    with mx.autograd.record():
        loss = (net(x) ** 2).sum()
    loss.backward()
    tr.step(8)


def _params_equal(net, net2, exact=True):
    for (n, p), (n2, p2) in zip(net.collect_params().items(),
                                net2.collect_params().items()):
        assert n == n2
        if exact:
            torch.testing.assert_close(p.detach(), p2.detach(), rtol=0,
                                       atol=0)
        else:
            torch.testing.assert_close(p.detach(), p2.detach(), rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize("opt,opt_params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    # adam also carries the per-index update counts of its bias correction
    ("adam", {"learning_rate": 1e-3}),
])
def test_trainer_checkpoint_roundtrip_with_optimizer_state(
        tmp_path, opt, opt_params):
    net, tr = _gluon_pair(3, opt, opt_params)
    for s in range(3):
        _gluon_step(net, tr, s)
    assert tr.step_count == 3
    path = tr.save_checkpoint(str(tmp_path))
    assert os.path.basename(path) == "ckpt-00000003"
    net2, tr2 = _gluon_pair(4, opt, opt_params)
    _gluon_step(net2, tr2, 99)
    step = tr2.load_checkpoint(str(tmp_path))
    assert tr2.optimizer.num_update == tr.optimizer.num_update
    assert step == 3 and tr2.step_count == 3
    _params_equal(net, net2)
    _gluon_step(net, tr, 5)
    _gluon_step(net2, tr2, 5)
    _params_equal(net, net2)


def test_load_does_not_pin_default_retention(tmp_path):
    net, tr = _gluon_pair(9)
    _gluon_step(net, tr, 0)
    tr.save_checkpoint(str(tmp_path), step=1)
    net2, tr2 = _gluon_pair(10)
    tr2.load_checkpoint(str(tmp_path))
    for s in (2, 3, 4, 5, 6):
        tr2.save_checkpoint(str(tmp_path), step=s, max_keep=None)
    mgr = ckpt.CheckpointManager(str(tmp_path), recover=False)
    assert mgr.steps() == [1, 2, 3, 4, 5, 6], mgr.steps()


def test_trainer_restore_with_reordered_params(tmp_path):
    net, tr = _gluon_pair(12)
    for s in range(3):
        _gluon_step(net, tr, s)
    tr.save_checkpoint(str(tmp_path))
    net2, _ = _gluon_pair(13)
    reordered = dict(reversed(list(net2.collect_params().items())))
    tr2 = mx.gluon.Trainer(reordered, "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
    tr2.load_checkpoint(str(tmp_path))
    _gluon_step(net, tr, 7)
    _gluon_step(net2, tr2, 7)
    _params_equal(net, net2, exact=False)


def test_block_checkpoint_roundtrip(tmp_path):
    net, _ = _gluon_pair(5)
    net.save_checkpoint(str(tmp_path), step=2)
    net2, _ = _gluon_pair(6)
    assert net2.load_checkpoint(str(tmp_path)) == 2
    _params_equal(net, net2)


def test_block_checkpoint_roundtrip_with_tied_params(tmp_path):
    """A tied parameter is written once, and its aliases restore from the
    one leaf."""
    mx.random.seed(11)
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=4))
    tied = nn.Dense(8, in_units=4)
    net.initialize(ctx=CPU)
    tied.weight = net[0].weight
    tied.bias = net[0].bias
    net.add(tied)
    assert list(net.collect_params()) == ["0.weight", "0.bias",
                                          "1.weight", "1.bias"]
    net.save_checkpoint(str(tmp_path), step=1)
    mgr = ckpt.CheckpointManager(str(tmp_path), recover=False)
    assert mgr.manifest(1)["n_leaves"] == 2
    assert net.load_checkpoint(str(tmp_path)) == 1


def test_do_checkpoint_routes_trainer_through_subsystem(tmp_path):
    net, tr = _gluon_pair(8)
    _gluon_step(net, tr, 0)
    cb = mx.callback.do_checkpoint(str(tmp_path / "run"))
    cb(0, tr)
    mgr = ckpt.CheckpointManager(str(tmp_path / "run-ckpt"))
    assert mgr.steps() == [1] and mgr.validate()[1]["ok"]


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _np_tree():
    rs = np.random.RandomState(1)
    return {"params": {"enc.w": rs.rand(300, 300).astype(np.float32),
                       "enc.b": rs.rand(300).astype(np.float32)},
            "opt_state": {"enc.w": (rs.rand(300, 300).astype(np.float32),
                                    rs.rand(300, 300).astype(np.float32))},
            "ids": rs.randint(0, 9, (5,)).astype(np.int32),
            "mask": rs.rand(7) > 0.5,
            "none": None,
            "step": np.uint32(9)}


def test_jax_written_step_restores_in_the_port(tmp_path):
    tree = _np_tree()
    jckpt.CheckpointManager(str(tmp_path), group_bytes=4096).save(9, tree)
    mgr = ckpt.CheckpointManager(str(tmp_path))
    report = mgr.validate()
    assert report[9]["ok"] and report[9]["errors"] == []
    step, got = mgr.restore(ctx=CPU)
    assert step == 9 and got["none"] is None
    assert isinstance(got["opt_state"]["enc.w"], tuple)
    for want, have in zip(layout.tree_leaves(tree),
                          layout.tree_leaves(got)):
        want = np.asarray(want)
        assert isinstance(have, torch.Tensor)
        assert have.numpy().dtype == want.dtype
        assert have.numpy().tobytes() == want.tobytes()
    assert got["step"].dtype == torch.uint32 and int(got["step"]) == 9


def test_port_written_step_restores_in_jax(tmp_path):
    tree = _np_tree()
    port_tree = dict(tree, params={k: torch.from_numpy(v)
                                   for k, v in tree["params"].items()})
    ckpt.CheckpointManager(str(tmp_path), group_bytes=4096).save(9,
                                                                 port_tree)
    jmgr = jckpt.CheckpointManager(str(tmp_path))
    assert jmgr.validate()[9]["ok"]
    step, got = jmgr.restore()
    assert step == 9 and got["none"] is None
    assert isinstance(got["opt_state"]["enc.w"], tuple)
    import jax

    have = jax.tree_util.tree_leaves(got)
    want = layout.tree_leaves(tree)
    assert len(have) == len(want)
    for w, h in zip(want, have):
        np.testing.assert_array_equal(np.asarray(h), np.asarray(w))
    # the manifests agree leaf by leaf (names, shapes, dtypes, files)
    m_port = jmgr.manifest(9)
    jroot = tmp_path / "jax"
    jckpt.CheckpointManager(str(jroot), group_bytes=4096).save(9, tree)
    m_jax = jckpt.CheckpointManager(str(jroot)).manifest(9)
    assert m_port["spec"] == m_jax["spec"]
    assert m_port["leaves"] == m_jax["leaves"]


_HIDDEN = """
import json, sys
sys.modules["ml_dtypes"] = None          # any import of it fails
sys.path.insert(0, %(root)r)
import numpy as np, torch
from mxnet_tpu_torch import checkpoint as c
import mxnet_tpu_torch as mx
step, tree = c.CheckpointManager(%(jax_root)r).restore(ctx=mx.cpu())
w = tree["w"]
c.CheckpointManager(%(port_root)r).save(3, {"w": w, "b": tree["b"]})
print(json.dumps({"dtype": str(w.dtype),
                  "bits": w.view(torch.int16).numpy().tolist(),
                  "ml_dtypes": "ml_dtypes" in sys.modules
                               and sys.modules["ml_dtypes"] is not None}))
"""


def test_bfloat16_leaf_without_ml_dtypes(tmp_path):
    import ml_dtypes

    bits = np.random.RandomState(2).randint(
        -2 ** 15, 2 ** 15, (4, 6)).astype(np.int16)
    bits &= ~np.int16(0x7F80)          # finite values only, no NaN/inf
    w = bits.view(ml_dtypes.bfloat16)
    tree = {"w": w, "b": np.arange(3, dtype=np.float32)}
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    jckpt.CheckpointManager(str(jroot)).save(3, tree)
    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, "-c", _HIDDEN % {"root": ROOT,
                                          "jax_root": str(jroot),
                                          "port_root": str(proot)}],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["dtype"] == "torch.bfloat16" and not res["ml_dtypes"]
    assert np.array_equal(np.asarray(res["bits"], np.int16), bits)
    # the port wrote what the JAX package writes for that leaf
    pm = ckpt.CheckpointManager(str(proot)).manifest(3)
    jm = ckpt.CheckpointManager(str(jroot)).manifest(3)
    assert pm["leaves"] == jm["leaves"]
    assert [e["dtype"] for e in pm["leaves"]] == ["float32", "bfloat16"]
    for fname in pm["files"]:
        with np.load(proot / "ckpt-00000003" / fname) as p, \
                np.load(jroot / "ckpt-00000003" / fname) as j:
            for k in j.files:
                assert p[k].dtype.str == j[k].dtype.str
                assert p[k].tobytes() == j[k].tobytes()
