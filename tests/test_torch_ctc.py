"""The port's CTC loss (``ops.nn.ctc_loss``, ``nd.ctc_loss``/``nd.CTCLoss``
and ``gluon.loss.CTCLoss``) against the JAX package's, on the CPU.

The same numpy activations and labels go through both packages: blank
first and last, labels padded with -1 (and with 0 where 0 is the blank),
lengths given and derived, frames cut short by ``data_lengths``, and an
alignment that cannot fit (more labels than frames: both give a finite loss
of about 1e30 from the -1e30 log-zero, where ``F.ctc_loss`` gives inf).
The losses agree within 1e-5 x max(1, max|ref|), and the gradients of
their weighted sum with respect to the activations within the same, the
infeasible case's too (finite on both sides).  The block runs in NTC and
TNC layouts with NT and TN labels and a ``sample_weight``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.ops import nn as tops

T, B, V = 7, 3, 6


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


RS = np.random.RandomState(0)
DATA = (RS.randn(T, B, V) * 1.5).astype(np.float32)
PADDED = np.array([[1, 2, -1, -1], [3, 3, 4, -1], [5, 1, 2, 4]], np.float32)
ZERO_PADDED = np.array([[1, 2, 0, 0], [3, 3, 4, 0], [5, 1, 2, 4]],
                       np.float32)
LAST = np.array([[0, 2, -1, -1], [3, 3, 4, -1], [1, 0, 2, 4]], np.float32)
CASES = {
    "first_derived": (PADDED, {}, "first"),
    "first_zero_padded": (ZERO_PADDED, {}, "first"),
    "last_derived": (LAST, {}, "last"),
    "given_lengths": (PADDED, {"label_lengths": np.array([1, 3, 2], np.int32),
                               "data_lengths": np.array([7, 5, 6],
                                                        np.int32)},
                      "first"),
    "last_given_lengths": (LAST, {"label_lengths": np.array([2, 2, 4],
                                                            np.int32)},
                           "last"),
    # 3 x (3, 3) needs 6 frames with the blank between the repeats
    "infeasible": (np.array([[3, 3, 3, 3], [1, 2, -1, -1],
                             [2, 2, 2, 2]], np.float32),
                   {"data_lengths": np.array([5, 7, 4], np.int32)}, "first"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ctc_loss_matches_jax(case):
    label, lengths, blank = CASES[case]
    probe = RS.rand(B).astype(np.float32) + 0.5

    def jloss_fn(d):
        return jreg.get_op("ctc_loss").fn(
            d, jnp.asarray(label), blank_label=blank,
            **{k: jnp.asarray(v) for k, v in lengths.items()})

    want = np.asarray(jloss_fn(jnp.asarray(DATA)))
    want_g = np.asarray(jax.grad(lambda d: jnp.sum(jloss_fn(d) * probe))(
        jnp.asarray(DATA)))
    data = torch.tensor(DATA, requires_grad=True)
    got = tops.ctc_loss(data, torch.from_numpy(label), blank_label=blank,
                        **{k: torch.from_numpy(v)
                           for k, v in lengths.items()})
    (got * torch.from_numpy(probe)).sum().backward()
    _close(got, want)
    _close(data.grad, want_g)
    if case == "infeasible":
        assert (want[[0, 2]] > 1e29).all() and want[1] < 1e3
        assert not torch.isfinite(torch.nn.functional.ctc_loss(
            torch.log_softmax(torch.from_numpy(DATA), -1),
            torch.tensor([[3, 3, 3, 3]] * 3), torch.tensor([5, 7, 4]),
            torch.tensor([4, 4, 4]), reduction="none")[0])


def test_nd_ctc_loss_and_alias():
    label, _, _ = CASES["first_derived"]
    want = jmx.nd.ctc_loss(jmx.nd.array(DATA), jmx.nd.array(label))
    with mx.cpu():
        got = mx.nd.ctc_loss(mx.nd.array(DATA), mx.nd.array(label))
        alias = mx.nd.CTCLoss(mx.nd.array(DATA), mx.nd.array(label))
    _close(got.asnumpy(), want.asnumpy())
    np.testing.assert_array_equal(alias.asnumpy(), got.asnumpy())


@pytest.mark.parametrize("layout,label_layout", [("NTC", "NT"),
                                                 ("TNC", "TN")])
def test_ctc_loss_block_matches_jax(layout, label_layout):
    label, _, _ = CASES["first_derived"]
    pred = DATA if layout == "TNC" else DATA.transpose(1, 0, 2)
    lab = label if label_layout == "NT" else label.T
    lens = np.array([2, 3, 4], np.int32)
    sw = np.array([[0.5], [1.0], [2.0]], np.float32)[:, 0]
    want = jloss.CTCLoss(layout, label_layout)(
        jmx.nd.array(pred), jmx.nd.array(lab), None,
        jmx.nd.array(lens, dtype="int32"), jmx.nd.array(sw)).asnumpy()
    got = tloss.CTCLoss(layout, label_layout)(
        torch.from_numpy(pred), torch.from_numpy(lab), None,
        torch.from_numpy(lens), torch.from_numpy(sw))
    _close(got, want)
