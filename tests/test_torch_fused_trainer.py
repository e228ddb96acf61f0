"""The port's ``parallel.FusedTrainer``, ``parallel.optim`` (the foreach
optimizer rules) and ``optimizer.lr_scheduler`` against the JAX package's,
on the CPU.

- A small Dense + LayerNorm net in f32 with the same numpy weights and
  batch on both sides: 10-step trajectories of sgd, nag, adam, adamw and
  lamb, with and without a scheduler.  Both sides do the same f32 math in
  another order (XLA fuses and contracts into FMAs; the port runs
  ``torch._foreach_*`` ops), so the weights agree to a few ulps: within
  1e-5 relative (``rtol``), with an ``atol`` of 1e-5 x the tensor's largest
  magnitude for entries near 0.
- The learning rates of every scheduler with warm-up, to 1e-12: the same
  Python arithmetic on both sides.
- ``grad_accum`` (k microbatches, mean gradient, one update) at the same
  bound, and its raise on an indivisible batch; ``mesh=``/``zero=`` raise;
  ``state_dict``/``load_state_dict`` resume bit for bit;
  ``contrib.amp.convert_model`` casts what the JAX one casts.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, parallel
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.optimizer import lr_scheduler as tsched

B, IN, HID, OUT = 8, 8, 16, 4
RTOL = 1e-5
OPTS = {
    "sgd": dict(learning_rate=0.1, momentum=0.9, wd=0.01),
    "nag": dict(learning_rate=0.1, momentum=0.9, wd=0.01,
                clip_gradient=0.05),
    "adam": dict(learning_rate=0.01, wd=0.01),
    "adamw": dict(learning_rate=0.01, wd=0.1, clip_gradient=0.2),
    "lamb": dict(learning_rate=0.01, wd=0.01),
}


def _net(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(HID, in_units=IN, activation="tanh"),
            nn.LayerNorm(in_channels=HID),
            nn.Dense(OUT, in_units=HID))
    return net


def _weights(seed=0):
    rs = np.random.RandomState(seed)
    shapes = {"0.weight": (HID, IN), "0.bias": (HID,), "1.gamma": (HID,),
              "1.beta": (HID,), "2.weight": (OUT, HID), "2.bias": (OUT,)}
    w = {k: (rs.randn(*s) * 0.5).astype(np.float32)
         for k, s in shapes.items()}
    w["1.gamma"] += 1.0
    return w


def _batches(n, batch=B, seed=1):
    rs = np.random.RandomState(seed)
    return [(rs.randn(batch, IN).astype(np.float32),
             rs.randint(0, OUT, batch).astype(np.int32)) for _ in range(n)]


def _jax_trainer(opt, kw, sched=None, **tkw):
    net = _net(jnn)
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(_weights()[k]))
    params = dict(kw, lr_scheduler=sched) if sched else dict(kw)
    return net, jpar.FusedTrainer(net, optimizer=opt,
                                  optimizer_params=params, **tkw)


def _port_trainer(opt, kw, sched=None, **tkw):
    net = _net(tnn)
    net.initialize(ctx=mx.cpu())
    mx.convert.load_jax_params(net, _weights())
    params = dict(kw, lr_scheduler=sched) if sched else dict(kw)
    return net, parallel.FusedTrainer(net, optimizer=opt,
                                      optimizer_params=params, **tkw)


def _run_jax(opt, kw, batches, sched=None, **tkw):
    net, tr = _jax_trainer(opt, kw, sched, **tkw)
    losses = [float(tr.step(x, y).asnumpy()) for x, y in batches]
    tr.sync_block()
    return losses, {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}


def _run_port(opt, kw, batches, sched=None, **tkw):
    net, tr = _port_trainer(opt, kw, sched, **tkw)
    losses = [tr.step(torch.from_numpy(x), torch.from_numpy(y)).item()
              for x, y in batches]
    return losses, {k: p.detach().numpy()
                    for k, p in net.collect_params().items()}


def _close(got, want):
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=RTOL, atol=RTOL * float(np.abs(w).max()),
            err_msg=k)


def _cosine(pkg, lr):
    return pkg.CosineScheduler(max_update=10, base_lr=lr, final_lr=lr / 100,
                               warmup_steps=3, warmup_begin_lr=lr / 10)


@pytest.mark.parametrize("sched", [False, True], ids=["const", "cosine"])
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_ten_step_trajectory_matches_jax(opt, sched):
    batches = _batches(1) * 10         # one batch: the loss must fall
    lr = OPTS[opt]["learning_rate"]
    want_losses, want = _run_jax(
        opt, OPTS[opt], batches,
        _cosine(jmx.lr_scheduler, lr) if sched else None)
    losses, got = _run_port(opt, OPTS[opt], batches,
                            _cosine(tsched, lr) if sched else None)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=0)
    _close(got, want)
    assert losses[-1] < losses[0]


def _schedulers(pkg):
    return {
        "factor": pkg.FactorScheduler(step=3, factor=0.5, base_lr=1.0,
                                      warmup_steps=4, warmup_begin_lr=0.2),
        "multifactor": pkg.MultiFactorScheduler(
            step=[5, 9, 14], factor=0.3, base_lr=0.8, warmup_steps=3,
            warmup_mode="constant", warmup_begin_lr=0.05),
        "poly": pkg.PolyScheduler(max_update=20, base_lr=0.5, pwr=3,
                                  final_lr=0.01, warmup_steps=5),
        "cosine": pkg.CosineScheduler(max_update=20, base_lr=0.5,
                                      final_lr=0.02, warmup_steps=4,
                                      warmup_begin_lr=0.1),
        "warmup": pkg.LRScheduler(base_lr=0.4, warmup_steps=25,
                                  warmup_begin_lr=0.1),
    }


@pytest.mark.parametrize("kind", ["factor", "multifactor", "poly", "cosine",
                                  "warmup"])
def test_scheduler_learning_rates_match_jax(kind):
    js, ts = _schedulers(jmx.lr_scheduler)[kind], _schedulers(tsched)[kind]
    if kind == "warmup":   # the base class: its warm-up alone
        want = [js.get_warmup_lr(n) for n in range(25)]
        got = [ts.get_warmup_lr(n) for n in range(25)]
        with pytest.raises(NotImplementedError):
            ts(1)
    else:
        want = [js(n) for n in range(1, 26)]
        got = [ts(n) for n in range(1, 26)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert len(set(np.round(got, 12))) > 3       # the schedule moves


def test_grad_accum_matches_jax_and_refuses_an_indivisible_batch():
    batches = _batches(4, batch=2 * B)
    kw = OPTS["adam"]
    want_losses, want = _run_jax("adam", kw, batches, grad_accum=4)
    losses, got = _run_port("adam", kw, batches, grad_accum=4)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=0)
    _close(got, want)
    # four microbatches of 4 give the mean gradient of one batch of 16
    _, whole = _run_port("adam", kw, batches)
    _close(whole, want)
    x, y = _batches(1, batch=B + 1)[0]
    for trainer in (_jax_trainer("sgd", {}, grad_accum=2)[1],
                    _port_trainer("sgd", {}, grad_accum=2)[1]):
        with pytest.raises(Exception, match="not divisible by grad_accum"):
            xs = (x, y) if trainer.__module__.startswith("mxnet_tpu.") \
                else (torch.from_numpy(x), torch.from_numpy(y))
            trainer.step(*xs)


def test_mesh_and_zero_are_not_ported():
    net = _net(tnn)
    with pytest.raises(MXNetError, match="not ported"):
        parallel.FusedTrainer(net, mesh=object())
    with pytest.raises(MXNetError, match="not ported"):
        parallel.FusedTrainer(net, zero=1)
    with pytest.raises(MXNetError, match="dtype"):
        parallel.FusedTrainer(net, dtype="int8")
    with pytest.raises(MXNetError, match="not ported"):
        parallel.PipelineTrainer(net)


def test_state_dict_round_trip():
    batches = _batches(5)
    xs = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches]
    net, tr = _port_trainer("adam", OPTS["adam"])
    assert tr.state_dict() is None and tr.params is None
    for b in xs[:3]:
        tr.step(*b)
    saved = tr.state_dict()
    assert saved["step"] == 3 and set(saved["opt_state"]) == set(tr._trainable)
    assert all(isinstance(v, tuple) and len(v) == 2
               for v in saved["opt_state"].values())
    for b in xs[3:]:
        tr.step(*b)
    want = {k: v.clone() for k, v in tr.params.items()}
    # a fresh trainer on fresh weights, loaded before its first step
    net2, tr2 = _port_trainer("adam", OPTS["adam"])
    tr2.load_state_dict(saved)
    for b in xs[3:]:
        tr2.step(*b)
    tr2.sync_block()
    for k, v in net2.collect_params().items():
        torch.testing.assert_close(v.detach(), want[k], rtol=0, atol=0)
    # and into a running trainer
    tr2.load_state_dict(saved)
    for b in xs[3:]:
        tr2.step(*b)
    for k, v in tr2.params.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_convert_model_casts_what_jax_casts(dtype):
    jnet, tnet = _net(jnn), _net(tnn)
    jnet.initialize()
    tnet.initialize(ctx=mx.cpu())
    jamp.convert_model(jnet, dtype)
    assert amp.convert_model(tnet, dtype) is tnet
    want = {k: str(p.data().dtype) for k, p in jnet.collect_params().items()}
    got = {k: str(p.dtype).replace("torch.", "")
           for k, p in tnet.collect_params().items()}
    assert got == want
    assert got["1.gamma"] == "float32" and got["0.weight"] == dtype
    # the op half is ported: init turns the rewrite on, disable off
    amp.init()
    try:
        assert amp.is_active() and amp.target_dtype() == "bfloat16"
    finally:
        amp.disable()
    assert not amp.is_active()
