"""The port's vision ResNets (``gluon.model_zoo.vision``) and deferred
shape inference against the JAX package's, on the CPU.

Small ResNets (layers [1, 1, 1, 1], channels [8, 16, 32, 64, 128], 10
classes) of both v1 block kinds here and both v2 kinds in
``test_torch_resnet_v2.py`` (the JAX side's compiles take ~3 s a model),
built with deferred input channels on both sides: the JAX net is probed
once on a 4x3x64x64 batch (the last stage's BatchNorm sees 4 x 2 x 2
values a channel; at 2x3x32x32 it sees 2, and its f32 rounding is too ill
conditioned to compare), its
parameter names and shapes must be the port's after
``convert.load_jax_params`` fills the port's still-deferred parameters,
and random numpy weights (BatchNorm statistics included) go to both.
Then, within 1e-4 x max(1, max|ref|):

- eval-mode outputs (moving statistics);
- train-mode outputs, the gradients of ``sum(out * ct)`` for every
  parameter and the input (``jax.vjp`` of the JAX block's pure function
  under ``jit``), and the running statistics the call leaves behind
  (biased batch variance, kept at weight 0.9).

Plus the port's own deferred-shape behaviour: a first call fills
deferred parameters with the recorded initializers, a deferred parameter
never initialized raises, and ``vision.get_model`` builds every family
under the JAX package's names and finds no upstream dotted name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import initializer as jinit
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

LAYERS, CHANNELS, CLASSES = [1, 1, 1, 1], [8, 16, 32, 64, 128], 10
X_SHAPE = (4, 3, 64, 64)      # the last stage's BatchNorm sees 4 x 2 x 2
TOL = 1e-4
VARIANTS = {"v1_bottleneck": (1, "BottleneckV1", 95),
            "v1_basic": (1, "BasicBlockV1", 67),
            "v2_bottleneck": (2, "BottleneckV2", 79),
            "v2_basic": (2, "BasicBlockV2", 59)}


def random_weights(shapes, seed):
    """numpy weights by name: He-scaled convs and dense, BatchNorm gamma
    near 1, beta, running mean near 0 and running variance in [0.5, 1.5)."""
    rs = np.random.RandomState(seed)
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


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=TOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def make_pair(variant):
    """(JAX net, port net, weights, x, ct) for one variant, with the same
    weights on both sides."""
    version, block, n_params = VARIANTS[variant]
    rs = np.random.RandomState(version * 10 + len(block))
    x = rs.randn(*X_SHAPE).astype(np.float32)
    ct = rs.randn(X_SHAPE[0], CLASSES).astype(np.float32)
    jnet = getattr(jres, "ResNetV%d" % version)(
        getattr(jres, block), LAYERS, CHANNELS, classes=CLASSES)
    jnet.initialize(init=jinit.Zero())
    jnet(jmx.nd.array(x))                    # the deferred-shape probe
    shapes = {k: p.shape for k, p in jnet.collect_params().items()}
    assert len(shapes) == n_params
    w = random_weights(shapes, seed=version)
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(w[k]))
    tnet = getattr(tres, "ResNetV%d" % version)(
        getattr(tres, block), LAYERS, CHANNELS, classes=CLASSES)
    tnet.initialize(ctx=mx.cpu())
    assert any(p._needs_shape() for p in tnet.collect_params().values())
    mx.convert.load_jax_params(tnet, w)
    return jnet, tnet, w, x, ct


@pytest.fixture(scope="module", params=["v1_basic", "v1_bottleneck"])
def pair(request):
    return make_pair(request.param)


def test_names_and_shapes_match(pair):
    check_names_and_shapes(pair)


def test_eval_outputs_match(pair):
    check_eval_outputs(pair)


def test_train_outputs_grads_and_running_stats_match(pair):
    check_train_outputs_grads_and_running_stats(pair)


def check_names_and_shapes(pair):
    jnet, tnet, w, _, _ = pair
    assert [(k, tuple(p.shape)) for k, p in tnet.collect_params().items()] \
        == [(k, tuple(p.shape)) for k, p in jnet.collect_params().items()]
    grad_req = {k: p.grad_req for k, p in jnet.collect_params().items()}
    assert {k: p.grad_req for k, p in tnet.collect_params().items()} \
        == grad_req


def check_eval_outputs(pair):
    jnet, tnet, _, x, _ = pair
    want = jnet(jmx.nd.array(x)).asnumpy()
    got = tnet(torch.from_numpy(x))
    _close(got, want, "eval output")


def check_train_outputs_grads_and_running_stats(pair):
    jnet, tnet, w, x, ct = pair
    apply_fn, params = jnet.export_pure(training=True)
    key = jax.random.PRNGKey(0)

    def fwd(p, xx):
        outs, states = apply_fn(p, key, xx)
        return outs[0], states

    def vjp(p, xx, c):
        (out, states), pull = jax.vjp(fwd, p, xx)
        zero = jax.tree_util.tree_map(jnp.zeros_like, states)
        return out, states, pull((c, zero))

    jout, jstates, (jgp, jgx) = jax.jit(vjp)(params, jnp.asarray(x),
                                              jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    with autograd.record():
        out = tnet(xt)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out, jout, "train output")
    _close(xt.grad, jgx, "input gradient")
    tparams = tnet.collect_params()
    for k, p in tparams.items():
        if p.grad_req == "null":
            assert p.grad is None, k
        else:
            _close(p.grad, jgp[k], "gradient of " + k)
    stats = sorted(k for k in w if "running_" in k)
    assert sorted(jstates) == stats
    for k in stats:
        _close(tparams[k], jstates[k], "running stat " + k)
        assert not np.allclose(tparams[k].detach().numpy(), w[k]), k


def test_first_call_fills_deferred_parameters():
    mx.random.seed(3)
    net = tnn.HybridSequential(
        tnn.Conv2D(4, 3, padding=1, weight_initializer="ones"),
        tnn.BatchNorm(), tnn.Activation("relu"), tnn.Dense(5))
    net.initialize(ctx=mx.cpu())
    shapes = {k: tuple(p.shape) for k, p in net.collect_params().items()}
    assert shapes == {"0.weight": (4, 0, 3, 3), "0.bias": (4,),
                      "1.gamma": (0,), "1.beta": (0,),
                      "1.running_mean": (0,), "1.running_var": (0,),
                      "3.weight": (5, 0), "3.bias": (5,)}
    out = net(torch.ones(2, 3, 6, 6))
    assert out.shape == (2, 5)
    p = net.collect_params()
    assert tuple(p["0.weight"].shape) == (4, 3, 3, 3)
    assert torch.equal(p["0.weight"], torch.ones(4, 3, 3, 3))
    assert torch.equal(p["1.gamma"], torch.ones(4))
    assert torch.equal(p["1.running_var"], torch.ones(4))
    assert torch.equal(p["1.running_mean"], torch.zeros(4))
    assert tuple(p["3.weight"].shape) == (5, 144)
    assert p["3.weight"].abs().max() <= 0.07 and p["3.weight"].std() > 0


def test_deferred_parameter_not_initialized_raises():
    net = tnn.Dense(3)
    with pytest.raises(MXNetError, match="initialize"):
        net(torch.ones(2, 4))
    with pytest.raises(MXNetError, match="shape"):
        mx.convert.load_jax_params(net, {"weight": np.ones((4, 4), "f4"),
                                         "bias": np.ones(3, "f4")})
    mx.convert.load_jax_params(net, {"weight": np.ones((3, 4), "f4"),
                                     "bias": np.ones(3, "f4")})
    assert net(torch.ones(2, 4)).tolist() == [[5.0] * 3] * 2


# upstream name: (the JAX package's name, the family's class)
_FAMILIES = {"vgg16": ("vgg16", "VGG"), "alexnet": ("alexnet", "AlexNet"),
             "mobilenet1.0": ("mobilenet1_0", "MobileNet"),
             "squeezenet1.0": ("squeezenet1_0", "SqueezeNet"),
             "densenet121": ("densenet121", "DenseNet"),
             "inceptionv3": ("inception_v3", "Inception3")}


@pytest.mark.parametrize("name", ["vgg16", "alexnet", "mobilenet1.0",
                                  "squeezenet1.0", "densenet121",
                                  "inceptionv3"])
def test_get_model_names_the_family_not_ported(name):
    """Every family is ported: ``get_model`` builds it under the JAX
    package's name, with the JAX parameter names; an upstream dotted name
    is not found, as in the JAX package (``get_model`` only lower-cases
    and maps ``-`` to ``_``)."""
    from mxnet_tpu.gluon.model_zoo import vision as jvision

    jname, cls = _FAMILIES[name]
    net = tvision.get_model(jname, classes=7)
    assert type(net).__name__ == cls
    assert list(net.collect_params()) == list(
        jvision.get_model(jname, classes=7).collect_params())
    if jname != name:
        with pytest.raises(MXNetError, match="not found"):
            tvision.get_model(name)
        with pytest.raises(jmx.base.MXNetError, match="not found"):
            jvision.get_model(name)


def test_get_model_builds_ported_resnets():
    net = tvision.get_model("ResNet18-v1", classes=7)
    assert isinstance(net, tres.ResNetV1)
    with pytest.raises(MXNetError, match="not found"):
        tvision.get_model("resnet19_v1")
    with pytest.raises(MXNetError, match="pretrained"):
        tvision.resnet50_v1(pretrained=True)
