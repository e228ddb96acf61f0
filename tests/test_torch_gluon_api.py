"""The Gluon surface of the PyTorch port against the JAX package, on the
CPU: a parameter declared the Gluon way, ``gluon.Constant``,
``Block.collect_params(select)``, ``Block.initialize(verbose=)`` and
``Sequential``/``HybridSequential`` indexing and slicing.

A custom block declares ``gluon.Parameter("alpha", shape=(1,),
init="ones")`` beside a ``Dense``; both packages give the same output
(within 1e-6) once the Dense weights are carried over.  The port reads a
parameter's value as the parameter itself where the JAX package calls
``p.data()`` (``mxnet_tpu_torch/gluon/parameter.py``'s docstring).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import MXNetError, convert
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.gluon import nn as tnn

TOL = 1e-6


class _JaxScale(jgluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.alpha = jgluon.Parameter("alpha", shape=(1,), init="ones")
        self.offset = jgluon.Constant(np.array([0.5, -1.0, 2.0], np.float32))
        self.dense = jnn.Dense(3, in_units=4)

    def forward(self, x):
        return self.dense(x) * self.alpha.data() + self.offset.data()


class _PortScale(tgluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.alpha = tgluon.Parameter("alpha", shape=(1,), init="ones")
        self.offset = tgluon.Constant(np.array([0.5, -1.0, 2.0], np.float32))
        self.dense = tnn.Dense(3, in_units=4)

    def forward(self, x):
        return self.dense(x) * self.alpha + self.offset


def _jax_params(block):
    return {k: v.data().asnumpy() for k, v in block.collect_params().items()}


def test_parameter_declared_the_gluon_way_runs_as_in_jax():
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    mj.random.seed(0)
    jblk = _JaxScale()
    jblk.initialize()
    want = jblk(mj.nd.array(x)).asnumpy()
    tblk = _PortScale()
    tblk.initialize(ctx=mt.cpu())
    # the initializer named by the parameter fills it, the constant keeps
    # its value through initialize
    np.testing.assert_array_equal(tblk.alpha.detach().numpy(), [1.0])
    np.testing.assert_array_equal(tblk.offset.detach().numpy(),
                                  [0.5, -1.0, 2.0])
    params = _jax_params(jblk)
    assert sorted(params) == sorted(tblk.collect_params())
    convert.load_jax_params(tblk, params)
    with mt.cpu():
        got = tblk(mt.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_parameter_names_match_jax():
    jblk, tblk = _JaxScale(), _PortScale()
    for blk in (jblk, tblk):
        names = {k: p.name for k, p in blk.collect_params().items()}
        assert names == {"alpha": "alpha", "offset": "offset",
                         "dense.weight": "weight", "dense.bias": "bias"}
    assert tgluon.Parameter("w", shape=(2,)).name == "w"
    assert tgluon.Parameter(shape=(2,)).name \
        == jgluon.Parameter(shape=(2,)).name == "weight"


def test_parameter_arguments_match_jax():
    for kw in ({"grad_req": "null"}, {"differentiable": False},
               {"lr_mult": 2.0, "wd_mult": 0.0}, {"dtype": "float16"}):
        jp = jgluon.Parameter("p", shape=(2, 3), **kw)
        tp = tgluon.Parameter("p", shape=(2, 3), **kw)
        assert (tp.grad_req, tp.lr_mult, tp.wd_mult) \
            == (jp.grad_req, jp.lr_mult, jp.wd_mult)
        assert tuple(tp.shape) == jp.shape
        assert np.dtype(str(tp.dtype).split(".")[-1]) == jp.dtype
    const = tgluon.Constant([1.0, 2.0])
    assert const.grad_req == "null" and const.name == "const"
    assert not const.requires_grad


@pytest.mark.parametrize("kw", [{"stype": "row_sparse"},
                                {"grad_stype": "row_sparse"},
                                {"sharding": ("dp", None)}],
                         ids=["stype", "grad_stype", "sharding"])
def test_unported_parameter_storage_raises(kw):
    """A ``sharding`` is not ported and raises; the sparse ``stype`` and
    ``grad_stype`` are (``nd.sparse``) and are kept as the JAX package
    keeps them."""
    jp = jgluon.Parameter("w", shape=(4, 2), **kw)  # the JAX package takes it
    if "sharding" in kw:
        with pytest.raises(MXNetError, match="not ported"):
            tgluon.Parameter("w", shape=(4, 2), **kw)
        return
    tp = tgluon.Parameter("w", shape=(4, 2), **kw)
    assert (tp.stype, tp.grad_stype) == (jp.stype, jp.grad_stype)


def test_parameter_of_unknown_shape_takes_the_shape_it_is_given():
    p = tgluon.Parameter("w", allow_deferred_init=True)
    p.initialize(ctx=mt.cpu())
    p.set_data(np.ones((2, 3), np.float32))
    assert tuple(p.shape) == (2, 3) and p.name == "w"


def _two_layer(nn):
    return nn.HybridSequential(nn.Dense(4, in_units=3),
                               nn.Dense(2, in_units=4))


def test_collect_params_select_matches_jax():
    jnet, tnet = _two_layer(jnn), _two_layer(tnn)
    for select in (".*bias", "0\\..*", ".*weight|.*bias", None):
        assert list(tnet.collect_params(select)) \
            == list(jnet.collect_params(select)), select
    assert list(tnet.collect_params(".*bias")) == ["0.bias", "1.bias"]


def test_initialize_accepts_verbose_and_a_ctx_list():
    jnet, tnet = _two_layer(jnn), _two_layer(tnn)
    jnet.initialize(None, None, True)        # init, ctx, verbose
    tnet.initialize(None, [mt.cpu()], True)
    tnet.initialize(verbose=True, force_reinit=True, ctx=mt.cpu())
    assert all(p.device.type == "cpu"
               for p in tnet.collect_params().values())


@pytest.mark.parametrize("kind", ["Sequential", "HybridSequential"])
def test_sequential_len_index_and_slice_match_jax(kind):
    jnet = getattr(jnn, kind)()
    tnet = getattr(tnn, kind)()
    for net, nn in ((jnet, jnn), (tnet, tnn)):
        net.add(nn.Dense(4, in_units=3), nn.Dense(5, in_units=4),
                nn.Dense(2, in_units=5))
    assert len(tnet) == len(jnet) == 3
    assert isinstance(tnet[0], tnn.Dense) and tnet[-1] is list(tnet)[-1]
    head = tnet[:2]
    assert type(head) is type(tnet) and type(jnet[:2]) is type(jnet)
    assert len(head) == len(jnet[:2]) == 2 and head[1] is tnet[1]
    mj.random.seed(1)
    jnet.initialize()
    x = np.random.RandomState(2).randn(6, 3).astype(np.float32)
    want = jnet[:2](mj.nd.array(x)).asnumpy()
    tnet.initialize(ctx=mt.cpu())
    convert.load_jax_params(tnet, _jax_params(jnet))
    got = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tnet(torch.from_numpy(x)).numpy(),
                               jnet(mj.nd.array(x)).asnumpy(),
                               rtol=TOL, atol=TOL)
