"""The port's vision families (VGG, AlexNet, MobileNet v1/v2, SqueezeNet,
DenseNet, Inception-v3) and ``vision.get_model`` against the JAX
package's, on the CPU.

Each family runs at ``tests/python/unittest/test_model_zoo.py``'s own
small sizes (7 classes): the port's net is built with deferred shapes,
shaped by one call, and given random numpy weights (BatchNorm statistics
included) through ``convert.load_jax_params``; the JAX net takes the same
arrays by name (``set_data``; the names and shapes must be the port's).
The eval-mode outputs agree within 1e-4 x max(1, max|ref|), the JAX side
being the block's pure function under ``jax.jit``.  The families' blocks
in train mode, with gradients, are in ``test_torch_vision_blocks.py``.

``get_model`` takes every name of the JAX registry and builds the same
parameter names and (partial) shapes; the upstream dotted names are not
found in either package; ``pretrained=True`` raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

TOL = 1e-4
CLASSES = 7
EVAL_CASES = {"squeezenet1_0": (1, 64), "mobilenet0_25": (1, 32),
              "mobilenet_v2_0_25": (1, 32), "densenet121": (1, 32),
              "alexnet": (1, 224), "vgg11": (1, 32),
              "inception_v3": (1, 299)}
def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=TOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def random_weights(shapes, rs):
    """He-scaled convs and dense, BatchNorm gamma near 1, beta, biases and
    running means near 0, running variances in [0.5, 1.5)."""
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


def make_pair(name, B, hw, seed):
    rs = np.random.RandomState(seed)
    x = rs.rand(B, 3, hw, hw).astype(np.float32)
    tnet = tvision.get_model(name, classes=CLASSES)
    tnet.initialize(ctx=mx.cpu())
    with autograd.pause():
        tnet(torch.from_numpy(x))
    shapes = {k: tuple(p.shape) for k, p in tnet.collect_params().items()}
    w = random_weights(shapes, rs)
    mx.convert.load_jax_params(tnet, w)
    jnet = jvision.get_model(name, classes=CLASSES)
    assert list(jnet.collect_params()) == list(shapes)
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(w[k]))
    assert {k: tuple(p.shape) for k, p in jnet.collect_params().items()} \
        == shapes
    return jnet, tnet, w, x, rs


@pytest.mark.parametrize("name", sorted(EVAL_CASES))
def test_family_eval_output_matches_jax(name):
    B, hw = EVAL_CASES[name]
    jnet, tnet, _, x, _ = make_pair(name, B, hw, seed=hw)
    apply_fn, params = jnet.export_pure(training=False)
    want = jax.jit(lambda p, xx: apply_fn(p, jax.random.PRNGKey(0),
                                          xx)[0][0])(params, jnp.asarray(x))
    got = tnet(torch.from_numpy(x))
    assert got.shape == (B, CLASSES)
    _close(got, want, name + " eval output")


def test_get_model_builds_every_jax_name():
    names = sorted(n for n in jvision._models if not n.startswith("get_"))
    assert sorted(tvision._models) == sorted(jvision._models)
    assert len(names) == 34
    for name in names:
        t = tvision.get_model(name, classes=CLASSES)
        j = jvision.get_model(name, classes=CLASSES)
        assert [(k, tuple(p.shape)) for k, p in t.collect_params().items()] \
            == [(k, tuple(p.shape)) for k, p in j.collect_params().items()], \
            name
    for fn, arg in (("get_vgg", 16), ("get_mobilenet", 0.5),
                    ("get_mobilenet_v2", 0.75)):
        t = getattr(tvision, fn)(arg, classes=CLASSES)
        j = getattr(jvision, fn)(arg, classes=CLASSES)
        assert list(t.collect_params()) == list(j.collect_params())


@pytest.mark.parametrize("name", ["vgg16", "alexnet", "mobilenet1_0",
                                  "mobilenet_v2_1_0", "squeezenet1_1",
                                  "densenet121", "inception_v3"])
def test_pretrained_raises(name):
    with pytest.raises(MXNetError,
                       match=r"load_parameters\(<file>\).*Queue 1 item 10"):
        tvision.get_model(name, pretrained=True)
