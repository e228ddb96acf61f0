"""The port's flash attention (``mxnet_tpu_torch.ops.flash_attention``)
against the JAX package's Pallas kernel, on the CPU.

The JAX side runs the Pallas kernels in interpret mode (their CPU default,
as ``tests/python/unittest/test_flash_attention.py`` runs them); the port's
CPU path is the kernel's plain version.  Same numpy inputs, fp32, atol
1e-5: both sides compute in fp32 and differ only in summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_attention as pa
from mxnet_tpu_torch.ops import flash_attention as fa

B, H = 2, 2
ATOL = 1e-5


def _inputs(T, D, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, H, T, D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [128, 200])  # 200: ragged against 64-blocks
def test_flash_attention_matches_pallas(T, causal, D):
    q, k, v = _inputs(T, D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out = pa.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                  block_k=64)
    want_out_lse, want_lse = pa.flash_attention_lse(
        jq, jk, jv, causal=causal, block_q=64, block_k=64)

    launches = fa.flash_attention.launches
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal)
    out_lse, lse = fa.flash_attention_lse(tq, tk, tv, causal)
    assert fa.flash_attention.launches == launches  # CPU: no kernel launch
    assert out.dtype == torch.float32 and lse.shape == (B, H, T)
    torch.testing.assert_close(out_lse, out, rtol=0, atol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out_lse),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_attention_matches_jax(causal):
    q, k, v = _inputs(200, 32, seed=1)
    want = pa.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, block_k=64)
    got = fa.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("seq_q,seq_k,head_dim,has_mask", [
    (512, 512, 64, False), (256, 256, 256, False), (255, 256, 64, False),
    (128, 1024, 64, False), (512, 512, 264, False), (512, 512, 64, True),
    (64, 64, 16, False)])
def test_use_flash_parity(seq_q, seq_k, head_dim, has_mask):
    assert fa.use_flash(seq_q, seq_k, head_dim, has_mask) == \
        pa.use_flash(seq_q, seq_k, head_dim, has_mask)


def test_dropout_is_refused_until_the_training_slice():
    # CPU dropout is the dense oracle fed the kernels' own mask
    # (dropout_keep_mask), and the LSE stays undropped
    q, k, v = map(torch.from_numpy, _inputs(128, 32))
    p, seed = 0.1, 77
    out = fa.flash_attention(q, k, v, dropout_p=p, seed=seed)
    _, lse = fa.flash_attention_reference(q, k, v, dropout_p=p, seed=seed)
    keep = fa.dropout_keep_mask(seed, B * H, 128, 128, p)
    s = q @ k.transpose(-1, -2) / 32 ** 0.5
    w = torch.softmax(s, -1) * keep.reshape(s.shape) / (1 - p)
    np.testing.assert_allclose(out.numpy(), (w @ v).numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=0, atol=ATOL)
