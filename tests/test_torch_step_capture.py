"""``mx.step`` whole-step capture of the port (``step/capture.py``) and the
monitor numerics it fuses, on the CPU, where the captured step runs its
step function eagerly (on the card it is one CUDA graph, which
``chip_smoke.py`` checks).

- Captured against stitched (``autograd.record`` forward,
  ``autograd.backward``, ``Trainer.step``) bit for bit over 10 steps:
  parameters, optimizer states, update counts and loss, SGD and Adam; a
  scheduler lr moves the captured steps with one build; BatchNorm's
  running statistics; both recompute policies.
- Captured against the JAX package's captured step within
  1e-5 x max(1, max|w|) on the same numpy weights and batch (BERT:
  ``test_torch_step_capture_bert.py``).
- The monitor's stats equal the stitched monitor's (bit for bit) and the
  JAX package's (1e-5); ``skip_step`` changes nothing, ``raise`` names
  the group; the kill switch and the counted fallbacks (non-fusable
  optimizer, ``grad_req='add'``, a failed step before its update).
- The flash plain versions and the dense attention path take a seed as
  an int64 tensor and give what the int seed gives.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import monitor as jmonitor
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon, monitor, telemetry
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import nn as ops_nn
from mxnet_tpu_torch.optimizer import lr_scheduler as tsched
from mxnet_tpu_torch.step import StepProgram, capture

BATCH, DIN, DOUT = 8, 12, 4
TOL = 1e-5
ENV = ("MXNET_MONITOR_SENTINEL", "MXNET_STEP_CAPTURE", "MXNET_STEP_REMAT")


@pytest.fixture(autouse=True)
def _clean():
    telemetry.enable()
    monitor.core.reset()
    yield
    monitor.disable()
    monitor.core.reset()
    jmonitor.disable()
    jmonitor.core.reset()
    for var in ENV:
        os.environ.pop(var, None)


def _data(nan_at=None):
    rs = np.random.RandomState(0)
    x = rs.randn(BATCH, DIN).astype(np.float32)
    if nan_at is not None:
        x[nan_at] = np.nan
    return x, rs.randn(BATCH, DOUT).astype(np.float32)


def _weights(bn=False):
    rs = np.random.RandomState(7)
    w = {"0.weight": rs.randn(16, DIN) * 0.3, "0.bias": rs.randn(16) * 0.1}
    last = "2" if bn else "1"
    w[last + ".weight"] = rs.randn(DOUT, 16) * 0.3
    w[last + ".bias"] = rs.randn(DOUT) * 0.1
    if bn:
        w.update({"1.gamma": 1 + rs.randn(16) * 0.1,
                  "1.beta": rs.randn(16) * 0.1,
                  "1.running_mean": np.zeros(16),
                  "1.running_var": np.ones(16)})
    return {k: v.astype(np.float32) for k, v in w.items()}


def _layers(mod, bn):
    net = mod.HybridSequential()
    if bn:
        net.add(mod.Dense(16, in_units=DIN),
                mod.BatchNorm(in_channels=16),
                mod.Dense(DOUT, in_units=16))
    else:
        net.add(mod.Dense(16, activation="relu", in_units=DIN),
                mod.Dense(DOUT, in_units=16))
    return net


def _make(optname="sgd", opt_params=None, bn=False):
    net = _layers(nn, bn)
    net.initialize(ctx=mx.cpu())
    mx.convert.load_jax_params(net, _weights(bn))
    trainer = gluon.Trainer(
        net.collect_params(), optname,
        dict(opt_params or {"learning_rate": 0.1, "momentum": 0.9}))
    return net, trainer


def _jax_make(optname="sgd", opt_params=None, bn=False):
    net = _layers(jnn, bn)
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(_weights(bn)[k]))
    net.hybridize()
    trainer = jgluon.Trainer(
        net.collect_params(), optname,
        dict(opt_params or {"learning_rate": 0.1, "momentum": 0.9}))
    return net, trainer


def _run_stitched(net, trainer, steps, lr_hook=None, x=None):
    xs, y = _data()
    x = torch.from_numpy(xs if x is None else x)
    y = torch.from_numpy(y)
    loss_fn = gluon.loss.L2Loss()
    for s in range(steps):
        if lr_hook is not None:
            lr_hook(trainer, s)
        with autograd.record():
            loss = loss_fn(net(x), y)
        autograd.backward(loss)
        trainer.step(BATCH)
    return loss.detach()


def _run_captured(net, trainer, steps, lr_hook=None):
    prog = trainer.capture(net, gluon.loss.L2Loss())
    x, y = map(torch.from_numpy, _data())
    loss = None
    for s in range(steps):
        if lr_hook is not None:
            lr_hook(trainer, s)
        loss = prog(x, y)
    return prog, loss


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for s in state for t in _leaves(s)]


def _assert_same(net_a, tr_a, net_b, tr_b):
    pa, pb = net_a.collect_params(), net_b.collect_params()
    for k in pa:
        assert torch.equal(pa[k].detach(), pb[k].detach()), k
    assert set(tr_a._states) == set(tr_b._states)
    for i in tr_a._states:
        for a, b in zip(_leaves(tr_a._states[i]), _leaves(tr_b._states[i])):
            assert torch.equal(a, b), "state %d" % i
    assert tr_a._optimizer._index_update_count == \
        tr_b._optimizer._index_update_count
    assert tr_a._optimizer.num_update == tr_b._optimizer.num_update
    assert tr_a.step_count == tr_b.step_count


def _close(got, want, what, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, "%s: %g" % (what, err)


OPTS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
        ("adam", {"learning_rate": 0.01, "wd": 1e-4})]


# ---- parity ----------------------------------------------------------------

@pytest.mark.parametrize("optname,opt_params", OPTS, ids=["sgd", "adam"])
def test_captured_bit_parity(optname, opt_params):
    net_s, tr_s = _make(optname, opt_params)
    loss_s = _run_stitched(net_s, tr_s, 10)
    net_c, tr_c = _make(optname, opt_params)
    prog, loss_c = _run_captured(net_c, tr_c, 10)
    assert prog.report()["paths"] == {"captured": 10, "stitched": 0}
    assert prog.report()["fallbacks"] == []
    assert torch.equal(loss_s, loss_c)
    _assert_same(net_s, tr_s, net_c, tr_c)
    assert tr_c.step_count == 10


@pytest.mark.parametrize("optname,opt_params", OPTS, ids=["sgd", "adam"])
def test_captured_matches_jax_captured(optname, opt_params):
    net_c, tr_c = _make(optname, opt_params)
    _, loss_c = _run_captured(net_c, tr_c, 10)
    jnet, jtr = _jax_make(optname, opt_params)
    jprog = jtr.capture(jnet, jgluon.loss.L2Loss())
    x, y = map(jmx.nd.array, _data())
    for _ in range(10):
        jloss = jprog(x, y)
    assert jprog.report()["paths"]["captured"] == 10
    _close(loss_c, jloss.asnumpy(), "loss")
    jp = jnet.collect_params()
    for k, p in net_c.collect_params().items():
        _close(p, jp[k].data().asnumpy(), k)


def test_scheduler_lr_change_moves_captured_steps_without_recapture():
    def opts():
        return {"learning_rate": 0.05,
                "lr_scheduler": tsched.FactorScheduler(step=2, factor=0.5)}

    net_s, tr_s = _make("adam", opts())
    _run_stitched(net_s, tr_s, 8)
    net_c, tr_c = _make("adam", opts())
    before = telemetry.value("step_capture_builds_total")
    prog, _ = _run_captured(net_c, tr_c, 8)
    assert telemetry.value("step_capture_builds_total") - before == 1
    assert tr_c.learning_rate == pytest.approx(0.05 * 0.5 ** 3)
    _assert_same(net_s, tr_s, net_c, tr_c)


def test_batchnorm_state_parity():
    net_s, tr_s = _make(bn=True)
    _run_stitched(net_s, tr_s, 5)
    net_c, tr_c = _make(bn=True)
    prog, _ = _run_captured(net_c, tr_c, 5)
    assert prog.report()["paths"]["captured"] == 5
    _assert_same(net_s, tr_s, net_c, tr_c)
    rm = net_c.collect_params()["1.running_mean"]
    assert float(rm.abs().max()) > 0


def test_one_build_per_signature():
    monitor.enable()
    net, trainer = _make()
    prog = trainer.capture(net, gluon.loss.L2Loss())
    x, y = map(torch.from_numpy, _data())
    prog(x, y)
    names = ("step_capture_builds_total", "trainer_fused_builds_total",
             "trainer_eager_updates_total")
    before = {n: telemetry.value(n) for n in names}
    for _ in range(4):
        prog(x, y)
    assert {n: telemetry.value(n) - before[n] for n in names} == \
        {n: 0.0 for n in names}
    prog(x[:4], y[:4])           # a new shape: a new program
    assert telemetry.value("step_capture_builds_total") - \
        before["step_capture_builds_total"] == 1
    rep = prog.report()
    assert rep["paths"]["captured"] == 6 and len(rep["programs"]) == 2
    segs = [s["segment"] for s in rep["programs"][0]["segments"]]
    assert segs == ["forward", "loss", "backward", "allreduce", "stats",
                    "apply"]
    assert rep["programs"][0]["bucket_plan"] == [[0, 1, 2, 3]]
    assert rep["programs"][0]["graph"] is False     # the CPU: eager


# ---- monitor -----------------------------------------------------------------

def test_fused_stats_match_stitched_and_jax():
    monitor.enable()
    net_s, tr_s = _make()
    _run_stitched(net_s, tr_s, 3)
    stitched = monitor.group_values()
    monitor.core.reset()
    net_c, tr_c = _make()
    _run_captured(net_c, tr_c, 3)
    captured = monitor.group_values()
    assert set(captured) == set(stitched) == {"SGD:0.weight+3"}
    assert captured == stitched
    assert monitor.summary()["steps"] == 3
    jmonitor.enable()
    jnet, jtr = _jax_make()
    jprog = jtr.capture(jnet, jgluon.loss.L2Loss())
    x, y = map(jmx.nd.array, _data())
    for _ in range(3):
        jprog(x, y)
    assert jmonitor.core.flush(5)
    want = jmonitor.core.group_values()
    assert set(want) == set(captured)
    for label, st in want.items():
        for field, v in st.items():
            assert captured[label][field] == pytest.approx(v, rel=TOL,
                                                           abs=1e-9), field


def test_skip_step_mutates_nothing():
    os.environ["MXNET_MONITOR_SENTINEL"] = "skip_step"
    monitor.enable()
    net, trainer = _make("adam", {"learning_rate": 0.01})
    prog = trainer.capture(net, gluon.loss.L2Loss())
    x, y = map(torch.from_numpy, _data())
    prog(x, y)
    params0 = {k: p.detach().clone()
               for k, p in net.collect_params().items()}
    states0 = {i: [t.clone() for t in _leaves(s)]
               for i, s in trainer._states.items()}
    counts0 = dict(trainer._optimizer._index_update_count)
    nu0, sc0 = trainer._optimizer.num_update, trainer.step_count
    loss = prog(torch.from_numpy(_data(nan_at=3)[0]), y)
    assert torch.isnan(loss).any()
    for k, p in net.collect_params().items():
        assert torch.equal(params0[k], p.detach()), k
    for i, ts in states0.items():
        for a, b in zip(ts, _leaves(trainer._states[i])):
            assert torch.equal(a, b)
    assert trainer._optimizer._index_update_count == counts0
    assert trainer._optimizer.num_update == nu0
    assert trainer.step_count == sc0
    assert monitor.summary()["skipped_steps"] == 1
    assert prog.report()["skipped_steps"] == 1
    prog(x, y)
    assert trainer.step_count == sc0 + 1
    assert prog.report()["programs"][0]["gate"] is True


def test_stitched_skip_step_mutates_nothing():
    os.environ["MXNET_MONITOR_SENTINEL"] = "skip_step"
    monitor.enable()
    net, trainer = _make("adam", {"learning_rate": 0.01})
    _run_stitched(net, trainer, 1)
    params0 = {k: p.detach().clone()
               for k, p in net.collect_params().items()}
    nu0 = trainer._optimizer.num_update
    _run_stitched(net, trainer, 1, x=_data(nan_at=0)[0])
    for k, p in net.collect_params().items():
        assert torch.equal(params0[k], p.detach())
        assert p.grad is None
    assert trainer._optimizer.num_update == nu0 and trainer.step_count == 1


def test_policy_raise_names_group_and_mutates_nothing():
    os.environ["MXNET_MONITOR_SENTINEL"] = "raise"
    monitor.enable()
    net, trainer = _make()
    prog = trainer.capture(net, gluon.loss.L2Loss())
    x, y = map(torch.from_numpy, _data())
    prog(x, y)
    params0 = {k: p.detach().clone()
               for k, p in net.collect_params().items()}
    nu0 = trainer._optimizer.num_update
    with pytest.raises(MXNetError, match=r"nonfinite gradients in group "
                       r"SGD:0\.weight"):
        prog(torch.from_numpy(_data(nan_at=0)[0]), y)
    for k, p in net.collect_params().items():
        assert torch.equal(params0[k], p.detach())
    assert trainer._optimizer.num_update == nu0
    sc = trainer.step_count
    prog(x, y)
    rep = prog.report()
    assert rep["paths"]["stitched"] == 0 and trainer.step_count == sc + 1
    assert rep["programs"]


# ---- kill switch and fallbacks ---------------------------------------------

def test_kill_switch_runs_stitched():
    os.environ["MXNET_STEP_CAPTURE"] = "0"
    net_s, tr_s = _make()
    _run_stitched(net_s, tr_s, 3)
    net_c, tr_c = _make()
    prog, _ = _run_captured(net_c, tr_c, 3)
    rep = prog.report()
    assert rep["paths"] == {"captured": 0, "stitched": 3}
    assert [f["reason"] for f in rep["fallbacks"]] == ["disabled"]
    _assert_same(net_s, tr_s, net_c, tr_c)


def test_non_fusable_optimizer_falls_back():
    class MySGD(mx.optimizer.SGD):
        pass

    net = nn.Dense(DOUT, in_units=DIN)
    net.initialize(ctx=mx.cpu())
    trainer = gluon.Trainer(net.collect_params(), MySGD(learning_rate=0.1))
    before = telemetry.value("step_capture_fallback_total",
                             {"reason": "eager_members"})
    prog = trainer.capture(net, gluon.loss.L2Loss())
    x, y = map(torch.from_numpy, _data())
    prog(x, y)
    prog(x, y)
    rep = prog.report()
    assert rep["paths"] == {"captured": 0, "stitched": 2}
    assert rep["fallbacks"][0]["reason"] == "eager_members"
    assert telemetry.value("step_capture_fallback_total",
                           {"reason": "eager_members"}) - before == 1
    assert trainer.step_count == 2


def test_grad_req_add_falls_back():
    net, trainer = _make()
    net.collect_params()["0.bias"].grad_req = "add"
    prog = trainer.capture(net, gluon.loss.L2Loss())
    x, y = map(torch.from_numpy, _data())
    prog(x, y)
    assert prog.report()["fallbacks"][0]["reason"] == "grad_req_add"
    assert trainer.step_count == 1


def test_failed_step_falls_back_and_rewinds_once():
    net_s, tr_s = _make("adam", {"learning_rate": 0.01})
    _run_stitched(net_s, tr_s, 4)
    net_c, tr_c = _make("adam", {"learning_rate": 0.01})
    prog = tr_c.capture(net_c, gluon.loss.L2Loss())
    x, y = map(torch.from_numpy, _data())
    prog(x, y)

    def boom(*a, **k):
        raise RuntimeError("poisoned step")

    prog._step_fn = boom
    prog(x, y)
    assert prog.report()["fallbacks"][0]["reason"] == "dispatch_error"
    for _ in range(2):
        prog(x, y)
    assert prog.report()["paths"] == {"captured": 1, "stitched": 3}
    _assert_same(net_s, tr_s, net_c, tr_c)


def test_bucket_fill_only_in_a_wider_world():
    net, trainer = _make()
    prog = trainer.capture(net, gluon.loss.L2Loss())
    x, y = map(torch.from_numpy, _data())
    prog(x, y)
    before = telemetry.value("allreduce_bucket_fill")
    prog(x, y)
    assert telemetry.value("allreduce_bucket_fill") == before
    prog._world = 2
    for _ in range(3):
        prog(x, y)
    n = len(prog.report()["programs"][0]["bucket_plan"])
    assert telemetry.value("allreduce_bucket_fill") - before == 3 * n


# ---- recompute -----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["all", "blocks"])
def test_remat_bit_parity(mode):
    os.environ["MXNET_STEP_REMAT"] = mode
    net_c, tr_c = _make()
    prog, _ = _run_captured(net_c, tr_c, 5)
    assert prog.report()["paths"]["captured"] == 5
    assert prog.report()["programs"][0]["remat"] == mode
    os.environ.pop("MXNET_STEP_REMAT")
    net_s, tr_s = _make()
    _run_stitched(net_s, tr_s, 5)
    _assert_same(net_s, tr_s, net_c, tr_c)


def test_remat_blocks_degrades_on_stateful_forward():
    os.environ["MXNET_STEP_REMAT"] = "blocks"
    net, trainer = _make(bn=True)
    prog = trainer.capture(net, gluon.loss.L2Loss())
    x, y = map(torch.from_numpy, _data())
    for _ in range(4):
        prog(x, y)
    rep = prog.report()
    assert trainer.step_count == 4
    assert "remat_blocks_degraded" in [f["reason"] for f in rep["fallbacks"]]
    assert rep["paths"]["captured"] >= 2
    assert all(p["remat"] == "all" for p in rep["programs"])
    # remat=all recomputes BatchNorm without writing its statistics twice
    os.environ.pop("MXNET_STEP_REMAT")
    net_s, tr_s = _make(bn=True)
    _run_stitched(net_s, tr_s, 4)
    _assert_same(net_s, tr_s, net, trainer)


def test_remat_policy_parsing():
    from mxnet_tpu_torch.step import remat_mode

    for raw, want in (("0", "off"), ("1", "all"), ("BLOCKS", "blocks")):
        os.environ["MXNET_STEP_REMAT"] = raw
        assert remat_mode() == want
    os.environ["MXNET_STEP_REMAT"] = "some"
    with pytest.raises(MXNetError, match="remat policy"):
        remat_mode()


def test_capture_argument_rules():
    net, trainer = _make()
    loss = gluon.loss.L2Loss()
    progs = [capture(net, loss, trainer=trainer),
             capture(trainer, loss, block=net)]
    assert all(isinstance(p, StepProgram) for p in progs)
    with pytest.raises(MXNetError, match="needs the gluon.Trainer"):
        capture(net, loss)
    with pytest.raises(MXNetError, match="needs the block"):
        capture(trainer, loss)
    with pytest.raises(MXNetError, match="two different"):
        capture(trainer, loss, trainer=_make()[1], block=net)
    with pytest.raises(MXNetError, match="axis_name"):
        capture(net, loss, trainer=trainer, axis_name="dp")
    assert len([r for r in trainer._step_programs if r() is not None]) >= 2
    prog = trainer.capture(net, loss)
    prog(*map(torch.from_numpy, _data()))
    trainer._invalidate_step_programs()
    assert prog.report()["programs"] == []


# ---- the seed in device memory -------------------------------------------

@pytest.mark.parametrize("seed", [12345, 2 ** 63 + 977, 2 ** 64 - 1])
def test_seed_tensor_route_equals_int_route(seed):
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(1, 2, 40, 8, generator=g) for _ in range(4))
    st = fa._seed_tensor(seed, torch.device("cpu"))
    assert st.dtype == torch.int64 and st.dim() == 0
    o_i, l_i = fa.flash_attention_reference(q, k, v, False, None, 0.2, seed)
    o_t, l_t = fa.flash_attention_reference(q, k, v, False, None, 0.2, st)
    assert torch.equal(o_i, o_t) and torch.equal(l_i, l_t)
    d_i = fa.flash_attention_backward_reference(q, k, v, o_i, l_i, do,
                                                False, None, 0.2, seed)
    d_t = fa.flash_attention_backward_reference(q, k, v, o_t, l_t, do,
                                                False, None, 0.2, st)
    for a, b in zip(d_i, d_t):
        assert torch.equal(a, b)
    assert torch.equal(fa.dropout_keep_mask(seed, 2, 40, 40, 0.2),
                       fa.dropout_keep_mask(st, 2, 40, 40, 0.2))
    qq, kk, vv = (t.transpose(1, 2).reshape(1, 40, 16) for t in (q, k, v))
    a = ops_nn.multi_head_attention(qq, kk, vv, num_heads=2, impl="dense",
                                    attn_dropout=0.2, dropout_seed=seed)
    b = ops_nn.multi_head_attention(qq, kk, vv, num_heads=2, impl="dense",
                                    attn_dropout=0.2, dropout_seed=st)
    assert torch.equal(a, b)
    with pytest.raises(MXNetError, match="int64"):
        fa._seed_tensor(torch.zeros(2, dtype=torch.int64),
                        torch.device("cpu"))


def test_draw_seed_and_replayable_draws():
    mx.random.seed(3)
    s1, s2 = trandom.draw_seed(), trandom.draw_seed()
    assert s1.dtype == torch.int64 and s1.dim() == 0 and s1 != s2
    log = {"draws": [], "replay": False}
    with trandom.replayable(log):
        a = trandom.draw_seed()
        m = ops_nn.dropout(torch.ones(64), 0.5,
                           generator=trandom.generator("cpu"))
    log["replay"] = True
    with trandom.replayable(log):
        assert torch.equal(trandom.draw_seed(), a)
        assert torch.equal(ops_nn.dropout(
            torch.ones(64), 0.5, generator=trandom.generator("cpu")), m)
    assert len(log["draws"]) == 2


# ---- bf16 with f32 masters: the ResNet recipe's shape, small ---------------

def _conv_net():
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
            nn.BatchNorm(in_channels=8), nn.Activation("relu"),
            nn.GlobalAvgPool2D(), nn.Dense(5, in_units=8))
    net.initialize(ctx=mx.cpu())
    rs = np.random.RandomState(2)
    for name, p in net.collect_params().items():
        if "running" not in name:
            p.set_data(torch.from_numpy(
                rs.randn(*p.shape).astype(np.float32) * 0.3))
    objs = list(net.collect_params().values())
    net.cast("bfloat16")
    assert list(net.collect_params().values()) == objs    # cast in place
    assert {p.dtype for p in objs} == {torch.bfloat16}
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9,
                             "multi_precision": True})
    return net, trainer


def test_bf16_multi_precision_capture_matches_stitched():
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.rand(4, 3, 8, 8).astype(np.float32)) \
        .to(torch.bfloat16)
    y = torch.from_numpy(rs.randint(0, 5, 4))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    net_s, tr_s = _conv_net()
    for _ in range(3):
        with autograd.record():
            loss = loss_fn(net_s(x), y)
        autograd.backward(loss)
        tr_s.step(4)
    net_c, tr_c = _conv_net()
    prog = tr_c.capture(net_c, loss_fn)
    for _ in range(3):
        prog(x, y)
    assert prog.report()["paths"] == {"captured": 3, "stitched": 0}
    _assert_same(net_s, tr_s, net_c, tr_c)
    masters = [tr_c._states[i][0] for i in sorted(tr_c._states)]
    assert {m.dtype for m in masters} == {torch.float32}
    for i, p in enumerate(tr_c._params):
        if p.grad_req != "null":
            assert torch.equal(p.detach(), tr_c._states[i][0]
                               .to(torch.bfloat16))
