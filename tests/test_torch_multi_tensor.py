"""The imperative ``gluon.Trainer``'s grouped multi-tensor apply
(``optimizer/multi_tensor.py``) and the bucket planner
(``kvstore/collective.py``) of the port, on the CPU.

- Per optimizer, the grouped apply against the port's own per-parameter
  path (``MXNET_MULTI_TENSOR=0``) bit for bit -- it is the same list rule
  -- and against the JAX package's grouped apply within
  1e-6 x max(1, max|w|), on the same numpy weights and gradients.
- Scheduler lr through the slots with one group build; ``set_learning_rate``
  rebuilds; ``multi_precision`` bf16 groups with f32 masters.
- Partition keys and reasons, the kill switch, non-fusable optimizers,
  ``register_fusable``, in-place updates, ``group_table``, the slots'
  refusal of host reads while a step is captured, and ``plan_buckets``
  plans equal to the JAX package's.
"""
import math
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.kvstore import collective as jcollective
from mxnet_tpu.optimizer import multi_tensor as jmt
from mxnet_tpu.optimizer import lr_scheduler as jsched
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, gluon, telemetry
from mxnet_tpu_torch.kvstore import collective
from mxnet_tpu_torch.optimizer import SGD, Nadam, multi_tensor
from mxnet_tpu_torch.optimizer import lr_scheduler as tsched

TOL = 1e-6
SPEC = [((8, 4), "float32", {}), ((8,), "float32", {}),
        ((4, 8), "float32", {}), ((3, 3, 2), "float32", {})]
OPTS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("sgd", {"learning_rate": 0.1}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-4}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
    ("lamb", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
    ("adagrad", {"learning_rate": 0.05}),
    ("ftrl", {"learning_rate": 0.1}),
    ("signum", {"learning_rate": 0.01}),
]


@pytest.fixture(autouse=True)
def _clean_env():
    was, jwas = telemetry.ENABLED, jtel.ENABLED
    telemetry.enable()
    jtel.enable()
    os.environ.pop("MXNET_MULTI_TENSOR", None)
    yield
    os.environ.pop("MXNET_MULTI_TENSOR", None)
    if not was:
        telemetry.disable()
    if not jwas:
        jtel.disable()


def _arrays(spec, seed=3, steps=4):
    rs = np.random.RandomState(seed)
    ws = [rs.randn(*s).astype(np.float32) * 0.5 for s, _, _ in spec]
    gs = [[rs.randn(*s).astype(np.float32) for s, _, _ in spec]
          for _ in range(steps)]
    return ws, gs


def _port_params(spec, ws):
    params = {}
    for k, ((_, dtype, kw), w) in enumerate(zip(spec, ws)):
        params["p%d" % k] = gluon.Parameter(
            torch.from_numpy(w.copy()).to(getattr(torch, dtype)), **kw)
    return params


def _port_run(optname, kw, spec=SPEC, steps=3, fused=True, sched=None,
              lr_hook=None, seed=3):
    ws, gs = _arrays(spec, seed, steps)
    params = _port_params(spec, ws)
    kw = dict(kw, lr_scheduler=sched()) if sched else dict(kw)
    trainer = gluon.Trainer(params, optname, kw)
    if not fused:
        os.environ["MXNET_MULTI_TENSOR"] = "0"
    try:
        for s in range(steps):
            if lr_hook is not None:
                lr_hook(trainer, s)
            for p, g in zip(params.values(), gs[s]):
                p.grad = torch.from_numpy(g).to(p.dtype)
            trainer.update(2)
    finally:
        os.environ.pop("MXNET_MULTI_TENSOR", None)
    return trainer, {k: p.detach().clone() for k, p in params.items()}


def _jax_run(optname, kw, spec=SPEC, steps=3, sched=None, lr_hook=None,
             seed=3):
    ws, gs = _arrays(spec, seed, steps)
    params = {}
    for k, ((shape, dtype, pkw), w) in enumerate(zip(spec, ws)):
        p = jgluon.Parameter(name="p%d" % k, shape=shape, dtype=dtype, **pkw)
        p.initialize()
        p.set_data(jmx.nd.array(w).astype(dtype))
        params["p%d" % k] = p
    kw = dict(kw, lr_scheduler=sched()) if sched else dict(kw)
    trainer = jgluon.Trainer(params, optname, kw)
    for s in range(steps):
        if lr_hook is not None:
            lr_hook(trainer, s)
        for p, g in zip(params.values(), gs[s]):
            p.grad()._data = jmx.nd.array(g).astype(p.dtype)._data
        trainer.update(2)
    assert len(trainer._mt_groups) >= 1
    return trainer, {k: p.data().astype("float32").asnumpy()
                     for k, p in params.items()}


def _close(got, want, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, "%s: %g" % (what, err)


@pytest.mark.parametrize("optname,kw", OPTS, ids=lambda v: str(v))
def test_grouped_matches_per_parameter_bitwise(optname, kw):
    t_f, w_f = _port_run(optname, kw, fused=True)
    t_e, w_e = _port_run(optname, kw, fused=False)
    assert len(t_f._mt_groups) == 1 and len(t_e._mt_groups) == 0
    for k in w_f:
        assert torch.equal(w_f[k], w_e[k]), k
    for i in t_f._states:
        for a, b in zip(multi_tensor_leaves(t_f._states[i]),
                        multi_tensor_leaves(t_e._states[i])):
            assert torch.equal(a, b)
    assert t_f._optimizer._index_update_count == \
        t_e._optimizer._index_update_count


def multi_tensor_leaves(state):
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for s in state for t in multi_tensor_leaves(s)]


@pytest.mark.parametrize("optname,kw", OPTS, ids=lambda v: str(v))
def test_grouped_matches_jax_grouped(optname, kw):
    _, w_t = _port_run(optname, kw)
    _, w_j = _jax_run(optname, kw)
    for k in w_t:
        _close(w_t[k], w_j[k], k)


def test_scheduler_lr_through_slots_one_build():
    def sched():
        return tsched.FactorScheduler(step=1, factor=0.7)

    before = telemetry.value("trainer_fused_builds_total",
                             {"optimizer": "SGD"})
    kw = {"learning_rate": 0.1, "momentum": 0.9}
    t_f, w_f = _port_run("sgd", kw, steps=4, sched=sched)
    assert telemetry.value("trainer_fused_builds_total",
                           {"optimizer": "SGD"}) - before == 1
    _, w_e = _port_run("sgd", kw, steps=4, sched=sched, fused=False)
    _, w_j = _jax_run("sgd", kw, steps=4, sched=lambda: jsched.
                      FactorScheduler(step=1, factor=0.7))
    for k in w_f:
        assert torch.equal(w_f[k], w_e[k])
        _close(w_f[k], w_j[k], k)
    assert t_f.learning_rate == pytest.approx(0.1 * 0.7 ** 3)


def test_set_learning_rate_rebuilds_and_stays_correct():
    def hook(trainer, s):
        if s == 2:
            trainer.set_learning_rate(0.02)

    kw = {"learning_rate": 0.1, "momentum": 0.9}
    before = telemetry.value("trainer_fused_builds_total",
                             {"optimizer": "SGD"})
    _, w_f = _port_run("sgd", kw, steps=4, lr_hook=hook)
    assert telemetry.value("trainer_fused_builds_total",
                           {"optimizer": "SGD"}) - before == 2
    _, w_e = _port_run("sgd", kw, steps=4, lr_hook=hook, fused=False)
    _, w_j = _jax_run("sgd", kw, steps=4, lr_hook=hook)
    for k in w_f:
        assert torch.equal(w_f[k], w_e[k])
        _close(w_f[k], w_j[k], k)


def test_multi_precision_bf16_group():
    spec = [((8, 4), "bfloat16", {}), ((4,), "bfloat16", {})]
    kw = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}
    t_f, w_f = _port_run("sgd", kw, spec=spec)
    t_e, w_e = _port_run("sgd", kw, spec=spec, fused=False)
    t_j, _ = _jax_run("sgd", kw, spec=spec)
    assert len(t_f._mt_groups) == 1
    assert multi_tensor.group_table(t_f)[0]["masters"]
    for k in w_f:
        assert w_f[k].dtype == torch.bfloat16
        assert torch.equal(w_f[k], w_e[k])
    for i in t_f._states:
        master = t_f._states[i][0]
        assert master.dtype == torch.float32
        assert torch.equal(master, t_e._states[i][0])
        _close(master, t_j._states[i][0].asnumpy(), "master %d" % i)


def test_partition_splits_on_dtype_and_lr_mult():
    spec = [((4, 4), "float32", {}), ((4, 4), "float32", {}),
            ((4, 4), "bfloat16", {}),                 # dtype split
            ((4, 4), "float32", {"lr_mult": 0.5})]    # lr split
    t, _ = _port_run("sgd", {"learning_rate": 0.1, "momentum": 0.9},
                     spec=spec, steps=1)
    table = multi_tensor.group_table(t)
    assert sorted(r["params"] for r in table) == [1, 1, 2]
    jt, _ = _jax_run("sgd", {"learning_rate": 0.1, "momentum": 0.9},
                     spec=[(s, "float16" if d == "bfloat16" else d, kw)
                           for s, d, kw in spec], steps=1)
    assert sorted(r["params"] for r in table) == \
        sorted(r["params"] for r in jmt.group_table(jt))


def test_partition_reasons():
    ws, gs = _arrays([((4, 4), "float32", {}), ((6, 4), "float32", {})])
    params = _port_params([((4, 4), "float32", {}),
                           ((6, 4), "float32", {})], ws)
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
    plist = list(params.values())
    for i, p in enumerate(plist):
        trainer._maybe_init_states(i, p)
    items = [(i, p, torch.from_numpy(g)) for i, (p, g)
             in enumerate(zip(plist, gs[0]))]
    groups, eager = multi_tensor.partition(trainer, items)
    assert len(groups) == 1 and eager == []
    items[1] = (1, plist[1], items[1][2].to_sparse())
    groups, eager = multi_tensor.partition(trainer, items)
    assert len(groups) == 1 and [(i, r) for i, _, _, r in eager] == \
        [(1, "row_sparse")]
    os.environ["MXNET_MULTI_TENSOR"] = "0"
    groups, eager = multi_tensor.partition(trainer, items[:1])
    assert groups == {} and eager[0][3] == "disabled"


def test_kill_switch_and_nonfusable_count_eager_updates():
    before = telemetry.value("trainer_eager_updates_total",
                             {"reason": "disabled"})
    _port_run("sgd", {"learning_rate": 0.1}, steps=1, fused=False)
    assert telemetry.value("trainer_eager_updates_total",
                           {"reason": "disabled"}) - before == len(SPEC)
    for optname in ("nadam", "sgld"):
        before = telemetry.value("trainer_eager_updates_total",
                                 {"reason": "optimizer"})
        t, _ = _port_run(optname, {"learning_rate": 0.01}, steps=1)
        assert len(t._mt_groups) == 0
        assert telemetry.value("trainer_eager_updates_total",
                               {"reason": "optimizer"}) - before == len(SPEC)
    assert not multi_tensor.is_fusable(Nadam())


def test_custom_subclass_fused_only_when_registered():
    class MySGD(SGD):
        pass

    ws, gs = _arrays(SPEC)
    params = _port_params(SPEC, ws)
    trainer = gluon.Trainer(params, MySGD(learning_rate=0.1))
    for p, g in zip(params.values(), gs[0]):
        p.grad = torch.from_numpy(g)
    trainer.update(2)
    assert len(trainer._mt_groups) == 0
    assert not multi_tensor.is_fusable(trainer._optimizer)
    multi_tensor.register_fusable(MySGD)
    try:
        for p, g in zip(params.values(), gs[1]):
            p.grad = torch.from_numpy(g)
        trainer.update(2)
        assert len(trainer._mt_groups) == 1
    finally:
        multi_tensor._FUSABLE.discard(MySGD)


def test_update_in_place_keeps_tensors_and_grads():
    ws, gs = _arrays(SPEC)
    params = _port_params(SPEC, ws)
    trainer = gluon.Trainer(params, "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    handles = {k: (p, p.data_ptr()) for k, p in params.items()}
    grads = {}
    for (k, p), g in zip(params.items(), gs[0]):
        p.grad = grads[k] = torch.from_numpy(g.copy())
    trainer.update(2)
    for k, p in params.items():
        assert handles[k][0] is p and p.data_ptr() == handles[k][1]
        assert not np.array_equal(p.detach().numpy(), ws[list(params)
                                                        .index(k)])
        np.testing.assert_array_equal(grads[k].numpy(),
                                      gs[0][list(params).index(k)])
        assert p.grad is None       # grad_req='write': cleared
    assert float(trainer._states[0].abs().max()) > 0


def test_group_table_shape():
    t, _ = _port_run("adam", {"learning_rate": 0.01}, steps=1)
    rows = multi_tensor.group_table(t)
    assert len(rows) == 1
    r = rows[0]
    assert r["optimizer"] == "Adam" and r["params"] == len(SPEC)
    assert r["programs_per_step"] == 1 and r["bytes"] > 0
    assert r["host_scalar_slots"] == 5      # lr, wd, rescale, c1, c2
    assert r["provenance"] == "not ported"


def test_slots_refuse_host_reads_while_capturing():
    slots = multi_tensor.Slots({"lr": 0.5, "wd": 0.0}, torch.device("cpu"))
    assert float(slots.values["lr"]) == 0.5
    with multi_tensor.capturing():
        with pytest.raises(MXNetError, match="float"):
            float(slots.values["lr"])
        with pytest.raises(MXNetError, match="bool"):
            bool(slots.values["wd"])
        # arithmetic stays on the device
        assert isinstance(slots.values["lr"] * 2.0, torch.Tensor)
    slots.write({"lr": 0.25, "wd": 1.0})
    assert float(slots.values["lr"]) == 0.25
    with pytest.raises(MXNetError, match="slot names"):
        slots.write({"lr": 0.1})


def test_plan_buckets_ordering_and_bound():
    kib = 1024
    sizes = [(300 * kib, "float32")] * 10
    plan = collective.plan_buckets(sizes, bucket_bytes=1024 * kib)
    assert [i for b in plan for i in b] == list(range(10))
    assert len(plan) <= math.ceil(sum(s for s, _ in sizes) / (1024.0 * kib))
    for b in plan[:-1]:
        assert sum(sizes[i][0] for i in b) >= 1024 * kib
    sizes = [(10 * kib, "float32"), (10 * kib, "bfloat16"),
             (5000 * kib, "float32"), (10 * kib, "float32")]
    assert collective.plan_buckets(sizes, bucket_bytes=1024 * kib) == \
        [[0], [1], [2], [3]]
    assert collective.plan_buckets([(10, "float32")] * 3,
                                   bucket_bytes=1 << 20) == [[0, 1, 2]]


@pytest.mark.parametrize("seed", range(4))
def test_plan_buckets_equal_jax(seed):
    rs = np.random.RandomState(seed)
    sizes = [(int(rs.randint(1, 3 << 20)),
              ["float32", "bfloat16", "float16"][rs.randint(0, 3)
                                                 if seed % 2 else 0])
             for _ in range(40)]
    for bb in (None, 1 << 20, 5 << 20):
        assert collective.plan_buckets(sizes, bucket_bytes=bb) == \
            jcollective.plan_buckets(sizes, bucket_bytes=bb)
    assert collective.default_bucket_bytes() == \
        jcollective.default_bucket_bytes()


def test_observe_bucket_fill():
    before = telemetry.value("allreduce_bucket_fill")
    collective.observe_bucket_fill([1 << 20, 3 << 20], op="allreduce",
                                   bucket_bytes=4 << 20)
    assert telemetry.value("allreduce_bucket_fill") - before == 2
    assert telemetry.value("collective_calls_total",
                           {"op": "allreduce"}) >= 2


def test_trainer_surface(tmp_path):
    ws, _ = _arrays(SPEC)
    params = _port_params(SPEC, ws)
    t = gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
    assert t.learning_rate == 0.1 and t.optimizer is t._optimizer
    assert t.step_count == 0 and t._param_names == list(params)
    # the optimizer checkpoints are ported: an empty state round trips
    t.save_states(str(tmp_path / "states"))
    t.load_states(str(tmp_path / "states"))
    assert t._states == {}
    assert mx.optimizer.multi_tensor is multi_tensor
