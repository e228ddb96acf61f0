"""The port's legacy fused ``nd.RNN`` op against the JAX package's, on the
CPU.

- The packed layout (every (layer, direction)'s i2h and h2h weights first,
  then all the biases), every mode, one or two layers and directions, with
  and without ``state_outputs``: the outputs and states through both
  registries on the same numpy inputs, within 1e-5 x max(1, max|ref|), and
  the gradients of the inputs, states and packed vector under
  ``autograd.record()`` against the JAX package's.
- ``lstm_state_clip_min/max`` clips the final cell state only, as in the
  JAX package (upstream MXNet clips at every step): the outputs and hT
  equal the unclipped call's.
- One output (no ``state_outputs``) stays a bare NDArray under
  ``record()``, and its backward reaches the input (the port of
  ``test_optimizer_ops.py``'s ``test_rnn_single_output_under_record``).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.rnn.rnn_layer import _GATES

T, B, I, H = 4, 3, 5, 6


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _packed(rs, mode, L, ndir):
    G = _GATES[mode]
    ws, bs = [], []
    for layer in range(L):
        isz = I if layer == 0 else H * ndir
        for _ in range(ndir):
            ws += [rs.randn(G * H, isz), rs.randn(G * H, H)]
            bs += [rs.randn(G * H), rs.randn(G * H)]
    return (np.concatenate([w.ravel() for w in ws + bs]) * 0.3) \
        .astype(np.float32)


def _inputs(mode, L, ndir, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(T, B, I).astype(np.float32), _packed(rs, mode, L, ndir),
            rs.randn(L * ndir, B, H).astype(np.float32),
            rs.randn(L * ndir, B, H).astype(np.float32))


def _run(pkg, arrays, mode, L, bi, state_outputs, grad, **attrs):
    """(outputs, gradients of x, packed, h0[, c0]) through ``pkg``'s
    registry; the gradients of the sum of every output times 0.5."""
    nd = pkg.nd
    x, packed, h0, c0 = (nd.array(a) for a in arrays)
    leaves = [x, packed, h0] + ([c0] if mode == "lstm" else [])
    for a in leaves:
        a.attach_grad()
    with pkg.autograd.record():
        outs = nd.RNN(x, packed, h0, c0 if mode == "lstm" else None,
                      state_size=H, num_layers=L, mode=mode,
                      bidirectional=bi, state_outputs=state_outputs,
                      **attrs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((o * 0.5).sum() for o in outs)
    if grad:
        loss.backward()
    return ([o.asnumpy() for o in outs],
            [a.grad.asnumpy() for a in leaves] if grad else [])


CASES = [(mode, L, bi, so) for mode in ("lstm", "gru", "rnn_tanh",
                                        "rnn_relu")
         for L, bi, so in ((1, False, True), (2, True, False))] + [
    ("lstm", 2, True, True), ("gru", 2, False, True)]


@pytest.mark.parametrize("mode,L,bi,state_outputs", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_rnn_op_matches_jax(mode, L, bi, state_outputs):
    arrays = _inputs(mode, L, 2 if bi else 1, seed=L + 10 * bi)
    want, want_g = _run(jmx, arrays, mode, L, bi, state_outputs, True)
    with mx.cpu():
        got, got_g = _run(mx, arrays, mode, L, bi, state_outputs, True)
    assert len(got) == len(want) == (
        1 if not state_outputs else 3 if mode == "lstm" else 2)
    for g, w in zip(got + got_g, want + want_g):
        assert g.shape == w.shape
        _close(g, w)


def test_state_clip_clips_only_the_final_cell_state():
    arrays = _inputs("lstm", 2, 1, seed=3)
    clip = dict(lstm_state_clip_min=-0.05, lstm_state_clip_max=0.05)
    with mx.cpu():
        free, _ = _run(mx, arrays, "lstm", 2, False, True, False)
        clipped, _ = _run(mx, arrays, "lstm", 2, False, True, False, **clip)
    want, _ = _run(jmx, arrays, "lstm", 2, False, True, False, **clip)
    for g, w in zip(clipped, want):
        _close(g, w)
    np.testing.assert_array_equal(clipped[0], free[0])   # out: unclipped
    np.testing.assert_array_equal(clipped[1], free[1])   # hT: unclipped
    np.testing.assert_array_equal(clipped[2], np.clip(free[2], -0.05, 0.05))
    assert np.abs(free[2]).max() > 0.05   # the clip did bite


def test_rnn_single_output_under_record():
    rs = np.random.RandomState(23)
    G = _GATES["lstm"]
    packed = (np.concatenate([rs.randn(G * H * I), rs.randn(G * H * H),
                              rs.randn(2 * G * H)]) * 0.1).astype(np.float32)
    with mx.cpu():
        x = mx.nd.array(rs.randn(2, 2, I))
        x.attach_grad()
        h0 = mx.nd.zeros((1, 2, H))
        with mx.autograd.record():
            out = mx.nd.RNN(x, mx.nd.array(packed), h0, None, state_size=H,
                            num_layers=1, mode="lstm")
            assert isinstance(out, mx.nd.NDArray)
            loss = out.sum()
        loss.backward()
    assert x.grad.shape == x.shape
    assert np.abs(x.grad.asnumpy()).max() > 0
