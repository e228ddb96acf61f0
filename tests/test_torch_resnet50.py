"""Full-width ``resnet50_v1`` of the port against the JAX package's, on
the CPU: after one deferred-shape probe at 1x3x32x32 on each side, the
parameter names, shapes and ``grad_req``s are the same (299 parameters;
the v1 bottleneck's body convs keep their bias), and the port's 1000-class
output has the JAX model's shape."""
import numpy as np
import torch

import mxnet_tpu as jmx
from mxnet_tpu import initializer as jinit
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision


def test_resnet50_v1_names_and_shapes_match_jax():
    x = np.zeros((1, 3, 32, 32), np.float32)
    jnet = jvision.resnet50_v1()
    jnet.initialize(init=jinit.Zero())
    jout = jnet(jmx.nd.array(x))
    tnet = tvision.get_model("resnet50_v1")
    tnet.initialize(ctx=mx.cpu())
    tout = tnet(torch.from_numpy(x))
    want = [(k, tuple(p.shape), p.grad_req)
            for k, p in jnet.collect_params().items()]
    got = [(k, tuple(p.shape), p.grad_req)
           for k, p in tnet.collect_params().items()]
    assert len(got) == 299 and got == want
    assert ("features.4.0.body.0.bias", (64,), "write") in got
    assert tuple(tout.shape) == jout.shape == (1, 1000)
