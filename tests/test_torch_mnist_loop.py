"""``examples/mnist_mlp.py``'s loop (``BASELINE.json`` config 1, the Gluon
MLP on MNIST) on the PyTorch port against the JAX package, on the CPU.

Both packages run the example's code: ``vision.MNIST(train=True)
.transform_first(ToTensor())`` (the synthetic set, the same images in
both), ``gluon.data.DataLoader(batch_size=256, shuffle=True)``, the
three-layer MLP with deferred input sizes, ``hybridize()``,
``SoftmaxCrossEntropyLoss``, Adam at lr 1e-3 through ``gluon.Trainer``,
``autograd.record()`` / ``loss.backward()`` / ``trainer.step(1)``.  The
port starts from the JAX package's weights (``convert.load_jax_params``)
and the loaders shuffle under the same ``np.random.seed``; the per-batch
losses over 6 batches agree within 1e-4, the batches arrive on the
port's current context without being moved, and test accuracy is
computed the example's way.
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert

TOL = 1e-4
BATCHES = 6


def _net(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(128, activation="relu"),
            nn.Dense(64, activation="relu"),
            nn.Dense(10))
    return net


def _loaders(mx, root):
    from importlib import import_module

    vision = import_module(mx.__name__ + ".gluon.data.vision")
    to_tensor = vision.transforms.ToTensor()
    train = vision.datasets.MNIST(root=root, train=True).transform_first(
        to_tensor)
    test = vision.datasets.MNIST(root=root, train=False).transform_first(
        to_tensor)
    return (mx.gluon.data.DataLoader(train, batch_size=256, shuffle=True),
            mx.gluon.data.DataLoader(test, batch_size=256))


def _loop(mx, net, train_loader, test_loader):
    """The example's epoch body, cut to BATCHES training batches."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
    losses, where = [], set()
    for i, (x, y) in enumerate(train_loader):
        if i == BATCHES:
            break
        with mx.autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
        where.add(str(x.context))
    correct = n = 0
    for x, y in test_loader:
        pred = net(x).asnumpy().argmax(axis=1)
        correct += int((pred == y.asnumpy()).sum())
        n += x.shape[0]
    return losses, correct / n, where


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mnist"))
    mj.random.seed(42)
    jnet = _net(mj)
    jnet.initialize()
    jnet.hybridize()
    jnet(mj.nd.zeros((1, 1, 28, 28)))          # shapes the deferred layers
    init = {k: v.data().asnumpy() for k, v in jnet.collect_params().items()}
    jtrain, jtest = _loaders(mj, root)
    np.random.seed(0)
    jax_run = _loop(mj, jnet, jtrain, jtest)
    with mt.cpu():
        mt.random.seed(42)
        tnet = _net(mt)
        tnet.initialize()
        tnet.hybridize()
        convert.load_jax_params(tnet, init)
        ttrain, ttest = _loaders(mt, root)
        np.random.seed(0)
        port_run = _loop(mt, tnet, ttrain, ttest)
    return jax_run, port_run, ttrain


def test_losses_match_jax(runs):
    (jl, _, _), (tl, _, _), _ = runs
    assert len(tl) == BATCHES and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)


def test_accuracy_matches_jax_and_batches_stay_put(runs):
    (_, jacc, _), (_, tacc, where), loader = runs
    assert where == {"cpu(0)"} and loader.route == "inline"
    assert abs(tacc - jacc) <= 2.0 / 1024
