"""The port's ``parallel.FusedTrainer`` on a ResNet (BatchNorm running
statistics, deferred shapes) against the JAX package's, on the CPU.

A small ResNet v1 with bottleneck blocks (layers [1, 1, 1, 1], channels
[8, 16, 32, 64, 128], 10 classes), the recipe's block kind, with deferred
input channels on both sides and the same numpy weights: three steps of
SGD with momentum (``bench.py``'s ResNet recipe: lr 0.05, momentum 0.9,
``softmax_ce``) on one fixed 32x3x64x64 batch.  Three steps at lr 0.05
cross ReLU and max-pool kinks, and at some batches one package's f32
rounding lands on the other side of one; this batch is one on which both
packages' f32 trajectories agree with a float64 run of the same math.

- f32, ``grad_accum`` 1 and 2: the losses, the final weights and the
  running statistics (updated by each step's forward, threaded through
  the microbatches in order) within 1e-4 x max(1, max|ref|).
- bf16 (``dtype='bfloat16'``, in ``test_torch_resnet_trainer_bf16.py``):
  the three steps run on both sides, the losses fall, and the masters
  and the running statistics stay float32; the first loss (the bf16
  forward at the shared weights) agrees within 2e-2 relative.  The later
  losses are not held to 2e-2: the port rounds every op's output to bf16
  (as the card computes it), while XLA on the CPU keeps intermediates of
  the JAX package's bf16 step in f32, so the two bf16 gradients at the
  same weights differ well past 2e-2 in the BatchNorm layers, and so do
  the later losses.

Each JAX trajectory runs once, in a module-scoped fixture.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import initializer as jinit
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

LAYERS, CHANNELS, CLASSES = [1, 1, 1, 1], [8, 16, 32, 64, 128], 10
B, STEPS, TOL, TOL_BF16 = 32, 3, 1e-4, 2e-2
OPT = {"learning_rate": 0.05, "momentum": 0.9}
RUNS = {"f32": dict(), "f32_accum2": dict(grad_accum=2),
        "bf16": dict(dtype="bfloat16")}
RUN_NAMES = ["f32", "f32_accum2"]


def _batch():
    rs = np.random.RandomState(12)
    return (rs.rand(B, 3, 64, 64).astype(np.float32),
            rs.randint(0, CLASSES, B).astype(np.int32))


def _jax_net(x):
    net = jres.ResNetV1(jres.BottleneckV1, LAYERS, CHANNELS, classes=CLASSES)
    net.initialize(init=jinit.Zero())
    net(jmx.nd.array(x[:1]))          # the deferred-shape probe
    return net


def make_weights():
    x, _ = _batch()
    shapes = {k: p.shape for k, p in _jax_net(x).collect_params().items()}
    rs = np.random.RandomState(5)
    out = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            v = 0.5 + rs.rand(*shape)
        elif leaf == "gamma":
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif leaf in ("beta", "running_mean", "bias"):
            v = 0.1 * rs.randn(*shape)
        else:
            v = rs.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        out[name] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def weights():
    return make_weights()


def make_runs(name, weights):
    """(name, (JAX losses, params), (port losses, params), port net) for
    one trainer configuration."""
    kw = RUNS[name]
    x, y = _batch()
    jnet = _jax_net(x)
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(weights[k]))
    jtr = jpar.FusedTrainer(jnet, loss="softmax_ce", optimizer="sgd",
                            optimizer_params=dict(OPT), **kw)
    jl = [float(jtr.step(x, y).asnumpy()) for _ in range(STEPS)]
    jtr.sync_block()
    jp = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = tres.ResNetV1(tres.BottleneckV1, LAYERS, CHANNELS,
                         classes=CLASSES)
    tnet.initialize(ctx=mx.cpu())
    ttr = parallel.FusedTrainer(tnet, loss="softmax_ce", optimizer="sgd",
                                optimizer_params=dict(OPT), **kw)
    mx.convert.load_jax_params(tnet, weights)
    tl = [ttr.step(torch.from_numpy(x), torch.from_numpy(y)).item()
          for _ in range(STEPS)]
    tp = {k: p.detach().numpy() for k, p in tnet.collect_params().items()}
    return name, (jl, jp), (tl, tp), tnet


@pytest.fixture(scope="module", params=RUN_NAMES)
def runs(request, weights):
    return make_runs(request.param, weights)


def test_losses_match(runs):
    check_losses(runs)


def test_weights_and_running_stats_match(runs, weights):
    check_weights_and_running_stats(runs, weights)


def check_losses(runs):
    name, (jl, _), (tl, _), _ = runs
    assert tl[-1] < tl[0] and np.all(np.isfinite(tl))
    if name == "bf16":
        # the first step's loss is the bf16 forward at the shared weights;
        # later ones follow each package's own bf16 updates (see
        # test_bf16_gradients_match for the update at shared weights)
        np.testing.assert_allclose(tl[0], jl[0], rtol=TOL_BF16)
    else:
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=TOL * max(1.0, max(map(abs, jl))))


def check_weights_and_running_stats(runs, weights):
    name, (_, jp), (_, tp), tnet = runs
    assert {p.dtype for p in tnet.collect_params().values()} \
        == {torch.float32}
    stats = [k for k in tp if "running_" in k]
    assert len(stats) == 2 * sum("gamma" in k for k in tp)
    for k in stats:
        assert not np.allclose(tp[k], weights[k]), k
    if name == "bf16":
        return
    for k, want in jp.items():
        np.testing.assert_allclose(
            tp[k], want, rtol=0,
            atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=k)


def test_first_step_probes_deferred_shapes():
    """A net left with deferred shapes is probed by the trainer's first
    step, then trained."""
    x, y = _batch()
    mx.random.seed(0)
    net = tres.ResNetV1(tres.BasicBlockV1, LAYERS, CHANNELS,
                        classes=CLASSES)
    net.initialize(ctx=mx.cpu())
    assert any(p._needs_shape() for p in net.collect_params().values())
    tr = parallel.FusedTrainer(net, loss="softmax_ce", optimizer="sgd",
                               optimizer_params=dict(OPT))
    loss = tr.step(torch.from_numpy(x), torch.from_numpy(y))
    assert np.isfinite(loss.item())
    params = net.collect_params()
    assert not any(p._needs_shape() for p in params.values())
    assert tuple(params["features.0.weight"].shape) == (8, 3, 7, 7)
    assert not torch.equal(params["features.1.running_mean"],
                           torch.zeros(8))

