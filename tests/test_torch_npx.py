"""``mx.npx``, the np-mode switches, ``mx.operator`` (``npx.Custom``) and
``autograd.Function``/``set_recording``/``set_training`` of the PyTorch
port against the JAX package, on the CPU.

Every public name of the JAX ``mx.npx`` exists in the port's.  Each npx
op is the registry op of the same name and runs one case through both
packages: the case of ``test_torch_nd_ops.py``'s table where it has one
(``check_op``), else one below.  A ``CustomOp`` with a forward and a
backward, written once for each package, gives the same outputs and
gradients in both, alone and between built-in ops on the tape, and so
does a user ``autograd.Function``.
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from test_torch_nd_ops import SPECS, check_op

RS = np.random.RandomState(3)
X = (RS.rand(2, 5).astype(np.float32) - 0.5) * 4

JAX_NPX = sorted(n for n in dir(mj.npx)
                 if not n.startswith("_") and n != "annotations")


def test_every_npx_export_exists():
    missing = [n for n in JAX_NPX if not hasattr(mt.npx, n)]
    assert missing == []


def _ops():
    out = {}
    for n in JAX_NPX:
        obj = getattr(mt.npx, n)
        if isinstance(obj, mt.ops.Operator):
            out[n] = obj.name
    return out


NPX_OPS = _ops()
# npx ops whose registry name has no case in test_torch_nd_ops.py's table
OWN = {
    "quantize": ([X, np.float32(-2.0), np.float32(2.0)], {}),
    "quantize_v2": ([X], {}),
    "dequantize": ([RS.randint(-127, 128, (2, 5)).astype(np.int8),
                    np.float32(-1.0), np.float32(1.0)], {}),
    "requantize": ([RS.randint(-2 ** 20, 2 ** 20, (2, 5)).astype(np.int32),
                    np.float32(-9.0), np.float32(9.0)], {}),
}


def test_npx_ops_are_the_registry_ops():
    for n, opname in NPX_OPS.items():
        assert getattr(mt.npx, n) is mt.ops.get_op(opname)
        assert opname in SPECS or opname in OWN, opname
    assert len(NPX_OPS) >= 40


@pytest.mark.parametrize("name", sorted(NPX_OPS))
def test_npx_op_matches_jax(name):
    opname = NPX_OPS[name]
    if opname in SPECS:
        check_op(opname)
        return
    inputs, attrs = OWN[opname]
    ref = getattr(mj.npx, name)(*[mj.nd.array(x) for x in inputs], **attrs)
    with mt.cpu():
        got = getattr(mt.npx, name)(*[mt.nd.array(x) for x in inputs],
                                    **attrs)
    for g, r in zip(got, ref):
        g, r = g.asnumpy(), r.asnumpy()
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_allclose(g.astype(np.float32),
                                   r.astype(np.float32), rtol=1e-6)


def test_npx_helpers():
    assert mt.npx.num_gpus() == mt.num_gpus()
    assert mt.npx.num_tpus() == 0
    with pytest.raises(mt.MXNetError):
        mt.npx.tpu()
    assert mt.npx.cpu() == mt.cpu() and mt.npx.random is mt.random
    assert mt.npx.image.to_tensor is mt.nd.image.to_tensor
    assert mt.npx.fully_connected is mt.nd.FullyConnected
    mt.npx.seed(5)
    with mt.cpu():
        a = mt.random.uniform(shape=(3,))
        mt.npx.seed(5)
        b = mt.random.uniform(shape=(3,))
    assert np.array_equal(a.asnumpy(), b.asnumpy())
    mt.npx.waitall()


def test_npx_save_load(tmp_path):
    f = str(tmp_path / "x.npz")
    with mt.cpu():
        mt.npx.save(f, [mt.np.array(X)])
        back = mt.npx.load(f)
    assert np.array_equal(back[0].asnumpy(), X)
    assert np.array_equal(mj.npx.load(f)[0].asnumpy(), X)


# ---- np-mode switches -------------------------------------------------------

def test_np_switches_match_jax():
    for mx in (mj, mt):
        mx.npx.set_np()
        assert mx.npx.is_np_array() and mx.npx.is_np_shape()
        mx.util.set_np(shape=False, array=False)
        assert not mx.npx.is_np_array() and not mx.npx.is_np_shape()
        with mx.util.np_array(True), mx.util.np_shape(True):
            assert mx.util.is_np_array() and mx.util.is_np_shape()
        assert not mx.util.is_np_array()
        mx.npx.reset_np()
        assert mx.npx.is_np_array() and mx.npx.is_np_shape()

        @mx.npx.use_np
        class Net:
            pass

        assert mx.use_np(Net) is Net and mx.npx.use_np_shape(len) is len
        assert mx.npx.use_np_array(len) is len
    assert mt.util.get_cuda_compute_capability(mt.cpu()) is None
    assert mt.set_np is mt.util.set_np and mt.is_np_array is mt.util.is_np_array


# ---- mx.operator: CustomOp -----------------------------------------------

def _register(mx):
    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            y = 1.0 / (1.0 + (-in_data[0]).exp())
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))

    class SigmoidProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    class Split(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[1])
            self.assign(out_data[1], req[1], in_data[0] * 2)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0] * in_data[1] + out_grad[1] * 2)
            self.assign(in_grad[1], req[1], out_grad[0] * in_data[0])

    class SplitProp(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["prod", "double"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Split()

    mx.operator.register("npx_test_sigmoid")(SigmoidProp)
    mx.operator.register("npx_test_split")(SplitProp)


_register(mj)
_register(mt)


def _custom(mx):
    a, b = mx.nd.array(X), mx.nd.array(X[::-1].copy())
    a.attach_grad()
    b.attach_grad()
    with mx.autograd.record():
        h = a * 2
        y = mx.npx.Custom(h, op_type="npx_test_sigmoid")
        p, d = mx.npx.Custom(y, b, op_type="npx_test_split")
        loss = mx.nd.sum(p * 3 + d)
    loss.backward()
    plain = mx.nd.Custom(mx.nd.array(X), op_type="npx_test_sigmoid")
    return [y, p, d, a.grad, b.grad, plain]


def test_custom_op_matches_jax():
    ref = _custom(mj)
    with mt.cpu():
        got = _custom(mt)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.asnumpy(), r.asnumpy(), rtol=1e-5,
                                   atol=1e-6)
    assert set(mt.operator.get_all_registered()) >= {"npx_test_sigmoid",
                                                     "npx_test_split"}
    with pytest.raises(mt.MXNetError):
        mt.npx.Custom(mt.nd.array(X, ctx=mt.cpu()), op_type="no_such_op")


# ---- autograd.Function, set_recording, set_training ------------------------

def _function(mx):
    class ScaledExp(mx.autograd.Function):
        def forward(self, x, y):
            out = x.exp() * y
            self.save_for_backward(out, y)
            return out

        def backward(self, dout):
            out, y = self.saved_tensors
            return dout * out, dout * out / y

    x, y = mx.nd.array(X), mx.nd.array(np.abs(X) + 0.5)
    x.attach_grad()
    y.attach_grad()
    with mx.autograd.record():
        z = ScaledExp()(x * 1.5, y)
        loss = mx.nd.sum(z * z)
    loss.backward()
    return [z, x.grad, y.grad]


def test_autograd_function_matches_jax():
    ref = _function(mj)
    with mt.cpu():
        got = _function(mt)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.asnumpy(), r.asnumpy(), rtol=1e-5,
                                   atol=1e-6)


def test_set_recording_and_set_training():
    import torch

    assert mt.autograd.set_recording(True) is False
    assert mt.autograd.is_recording() and torch.is_grad_enabled()
    with mt.cpu():
        x = mt.nd.array(X)
        x.attach_grad()
        loss = mt.nd.sum(x * x)
    assert mt.autograd.set_recording(False) is True
    assert not mt.autograd.is_recording()
    loss.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 2 * X, rtol=1e-6)
    assert mt.autograd.set_training(True) is False
    assert mt.autograd.is_training()
    assert mt.autograd.set_training(False) is True
    assert not mt.autograd.is_training()
    assert torch.is_grad_enabled()      # back to what it was


@pytest.mark.parametrize("training,use_global_stats,fix_gamma", [
    (True, False, False), (False, False, False), (True, True, True)])
def test_npx_batch_norm_matches_jax(training, use_global_stats, fix_gamma):
    x = (RS.rand(4, 3, 5, 5).astype(np.float32) - 0.5) * 3 + 1
    g, b = RS.rand(3).astype(np.float32), RS.rand(3).astype(np.float32)
    mm, mv = RS.rand(3).astype(np.float32), RS.rand(3).astype(np.float32)

    def run(mx):
        return mx.npx.batch_norm(*[mx.nd.array(a) for a in (x, g, b, mm, mv)],
                                 training=training, fix_gamma=fix_gamma,
                                 use_global_stats=use_global_stats)

    ref = run(mj)
    with mt.cpu():
        got = run(mt)
    for gg, r in zip(got, ref):
        np.testing.assert_allclose(gg.asnumpy(), r.asnumpy(), rtol=1e-5,
                                   atol=1e-5)
