"""The fault-handling slice as a whole, and the captured step's fault
sites, on the CPU against the JAX package.

- Capture: a ``step_capture`` fault at build runs that signature stitched
  with reason ``injected_fault`` (as the JAX package's program does); a
  fault at dispatch is re-raised (never replayed stitched) with the update
  counts rewound, and the supervised run ends bit for bit on an
  uninterrupted captured run, with the JAX package's supervised captured
  run's losses within 1e-5 relative.
- The slice: a small BERT (2 layers, width 64, T=256, so that
  ``impl='auto'`` takes the flash path: the port's kernels' plain
  versions, the JAX package's Pallas kernels in interpret mode) trained
  through ``parallel.FusedTrainer`` under ``resilience.Supervisor`` with a
  ``trainer_step`` transient at step 2 and ``preempt.request()`` during
  step 4, then resumed in-process by a fresh trainer.  Its final weights
  equal an uninterrupted port run's exactly and the JAX package's same
  supervised run's within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.block import HybridBlock as JHybridBlock
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.resilience import inject as jinject
from mxnet_tpu.resilience import preempt as jpreempt
from mxnet_tpu.resilience import supervisor as jsup
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, parallel, telemetry
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.resilience import inject, preempt
from mxnet_tpu_torch.resilience import supervisor as tsup

from test_torch_resilience import (_mlp, _same, _short,  # noqa: F401
                                   _weights, threads_settle)


@pytest.fixture(autouse=True)
def _clean():
    telemetry.enable()
    telemetry.reset()
    for inj, pre in ((inject, preempt), (jinject, jpreempt)):
        inj.clear()
        pre.clear()
    yield
    for inj, pre in ((inject, preempt), (jinject, jpreempt)):
        inj.clear()
        pre.clear()


# ---------------------------------------------------------------------------
# the captured step's sites
# ---------------------------------------------------------------------------

def _cap_batches(step):
    rs = np.random.RandomState(100 + step % 5)
    return (rs.rand(16, 8).astype(np.float32),
            rs.randint(0, 4, 16).astype(np.int32))


def _program(pkg, seed=5):
    net = _mlp(pkg, _weights(seed))
    g = gluon if pkg is mx else jgluon
    tr = g.Trainer(net.collect_params(), "adam", {"learning_rate": 0.01})
    loss = g.loss.SoftmaxCrossEntropyLoss()
    return net, tr, loss, tr.capture(net, loss)


def _put(pkg):
    def batches(step):
        x, y = _cap_batches(step)
        if pkg is mx:
            return torch.from_numpy(x), torch.from_numpy(y)
        return jmx.nd.array(x), jmx.nd.array(y)

    return batches


def _weights_of(net):
    return {_short(k): (p.detach().numpy() if isinstance(p, torch.Tensor)
                        else p.data().asnumpy())
            for k, p in net.collect_params().items()}


def test_build_fault_runs_the_signature_stitched():
    reasons, progs = {}, {}
    for pkg, inj in ((mx, inject), (jmx, jinject)):
        net, tr, loss, progs[pkg] = _program(pkg)
        inj.plan("step_capture@0")
        progs[pkg](*_put(pkg)(0))
        rep = progs[pkg].report()
        reasons[pkg] = ([f["reason"] for f in rep["fallbacks"]],
                        rep["paths"]["stitched"], len(rep["programs"]))
    assert reasons[mx] == reasons[jmx] == (["injected_fault"], 1, 0)
    progs[mx](*_put(mx)(1))             # the signature stays stitched
    assert progs[mx].report()["paths"] == {"captured": 0, "stitched": 2}

    assert telemetry.value("step_capture_fallback_total",
                           {"reason": "injected_fault"}) == 1


def test_dispatch_fault_is_reraised_and_the_run_replays_exactly(tmp_path):
    n = 6
    ref_net, _, _, ref_prog = _program(mx)
    ref_losses = [float(ref_prog(*_put(mx)(s)).mean()) for s in range(n)]
    out = {}
    for pkg, inj, sup in ((mx, inject, tsup), (jmx, jinject, jsup)):
        net, tr, loss, prog = _program(pkg)
        opt = tr._optimizer
        seen = []

        def on_failure(step, exc, opt=opt, seen=seen):
            seen.append((step, type(exc).__name__, opt.num_update,
                         dict(opt._index_update_count)))

        inj.plan("step_capture@3")
        s = sup.Supervisor(
            sup.GluonStepLoop(net, tr, loss, step_program=prog),
            pkg.checkpoint.CheckpointManager(str(tmp_path / pkg.__name__)),
            checkpoint_every=2, backoff=sup.Backoff(base=0.0, jitter=0.0),
            on_failure=on_failure)
        losses = s.run(_put(pkg), n)
        out[pkg] = (losses, _weights_of(net), s.restarts, seen,
                    prog.report())
    losses, weights, restarts, seen, rep = out[mx]
    assert restarts == out[mx][2] == 1
    # raised as the fault, not replayed stitched, with the counts of the
    # three completed steps
    assert seen[0][:3] == out[jmx][3][0][:3] == (3, "InjectedFault", 3)
    assert set(seen[0][3].values()) == {3}
    assert rep["fallbacks"] == [] and rep["paths"]["stitched"] == 0
    assert losses == ref_losses
    _same(weights, _weights_of(ref_net))
    np.testing.assert_allclose(losses, out[jmx][0], rtol=1e-5)


# ---------------------------------------------------------------------------
# the slice: a small BERT, supervised, faulted, preempted and resumed
# ---------------------------------------------------------------------------

CFG = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
           num_heads=2, max_length=256)
B, T, M, STEPS = 2, 256, 38, 6
OPT = {"learning_rate": 0.1, "momentum": 0.0}


class _JStep(JHybridBlock):
    def __init__(self):
        super().__init__()
        self.model = jbert.BERTForPretraining(dropout=0.0, **CFG)

    def forward(self, ids, types, pos):
        return self.model(ids, types, valid_length=None,
                          masked_positions=pos)


class _TStep(mx.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.model = tbert.BERTForPretraining(dropout=0.0, **CFG)

    def forward(self, ids, types, pos):
        return self.model(ids, types, valid_length=None,
                          masked_positions=pos)


def _jax_loss(outs, labels, nsp):
    mlm, nsp_scores = outs
    logp = jax.nn.log_softmax(mlm, -1)
    ll = jnp.take_along_axis(logp, labels[..., None].astype(jnp.int32),
                             -1)[..., 0]
    nlogp = jax.nn.log_softmax(nsp_scores, -1)
    nll = jnp.take_along_axis(nlogp, nsp[:, None].astype(jnp.int32),
                              -1)[..., 0]
    return -jnp.mean(ll) - jnp.mean(nll)


def _port_loss(outs, labels, nsp):
    mlm, nsp_scores = outs
    ll = torch.gather(torch.log_softmax(mlm, -1), -1,
                      labels.long()[..., None])[..., 0]
    nll = torch.gather(torch.log_softmax(nsp_scores, -1), -1,
                       nsp.long()[:, None])[..., 0]
    return -ll.mean() - nll.mean()


def _init(names_shapes):
    rs = np.random.RandomState(0)
    init = {}
    for name, shape in names_shapes:
        init[name] = (rs.randn(*shape) * 0.1).astype(np.float32)
        if name.endswith(".gamma"):
            init[name] += 1.0
    return init


def _bert_batches(step):
    rs = np.random.RandomState(50 + step)
    x = (rs.randint(0, CFG["vocab_size"], (B, T)).astype(np.int32),
         rs.randint(0, 2, (B, T)).astype(np.int32),
         np.sort(rs.choice(T, (B, M)), 1).astype(np.int32))
    y = (rs.randint(0, CFG["vocab_size"], (B, M)).astype(np.int32),
         rs.randint(0, 2, B).astype(np.int32))
    return x, y


def _port_trainer(init):
    net = _TStep()
    net.initialize(ctx=mx.cpu())
    mx.convert.load_jax_params(net, init)
    return net, parallel.FusedTrainer(net, loss_fn=_port_loss,
                                      optimizer="sgd",
                                      optimizer_params=dict(OPT))


def _port_batches(step):
    x, y = _bert_batches(step)
    return tuple(map(torch.from_numpy, x)), tuple(map(torch.from_numpy, y))


def _preempting(batches, pre):
    def run(step):
        if step == 4 and not pre.requested():
            pre.request(grace=60.0)     # "SIGTERM" during step 4
        return batches(step)

    return run


def _supervised(pkg, sup, inj, pre, trainer, root, batches):
    inj.plan("trainer_step@2")
    s = sup.Supervisor(trainer, pkg.checkpoint.CheckpointManager(root),
                       checkpoint_every=2,
                       backoff=sup.Backoff(base=0.0, jitter=0.0))
    first = s.run(_preempting(batches, pre), STEPS)
    assert s.restarts == 1 and s.preempted and len(first) == 5
    assert s.emergency_checkpoint is not None
    pre.clear()
    return first


def test_bert_slice_supervised_preempted_and_resumed(tmp_path):
    probe = _TStep()
    probe.initialize(ctx=mx.cpu())
    init = _init([(k, tuple(p.shape))
                  for k, p in probe.collect_params().items()])

    ref_net, ref = _port_trainer(init)
    ref_losses = [ref.step(*_port_batches(s)).item() for s in range(STEPS)]

    net, tr = _port_trainer(init)
    first = _supervised(mx, tsup, inject, preempt, tr, str(tmp_path / "t"),
                        _port_batches)
    net2, tr2 = _port_trainer(init)             # a fresh process's trainer
    with mx.cpu():
        rest = tsup.Supervisor(tr2, mx.checkpoint.CheckpointManager(
            str(tmp_path / "t")), checkpoint_every=2).run(_port_batches,
                                                          STEPS)
    assert first + rest == ref_losses
    got = {k: p.detach().numpy() for k, p in net2.collect_params().items()}
    _same(got, {k: p.detach().numpy()
                for k, p in ref_net.collect_params().items()})

    jnet = _JStep()
    jnet.initialize()
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(init[k]))
    jtr = jpar.FusedTrainer(jnet, loss_fn=_jax_loss, optimizer="sgd",
                            optimizer_params=dict(OPT))
    jfirst = _supervised(jmx, jsup, jinject, jpreempt, jtr,
                         str(tmp_path / "j"), _bert_batches)
    # the JAX side resumes on its trainer (the restore replaces its whole
    # state; a second trainer would only add a compile)
    jrest = jsup.Supervisor(jtr, jmx.checkpoint.CheckpointManager(
        str(tmp_path / "j")), checkpoint_every=2).run(_bert_batches, STEPS)
    jtr.sync_block()

    np.testing.assert_allclose(first + rest, jfirst + jrest, rtol=1e-4)
    for k, p in jnet.collect_params().items():
        np.testing.assert_allclose(got[k], p.data().asnumpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
