"""The port's flash-attention backward and attention dropout
(``mxnet_tpu_torch.ops.flash_attention``), on the CPU.

- Without dropout, the plain backward (and the ``autograd.Function`` on CPU
  tensors) against ``jax.vjp`` of the JAX package's Pallas kernels in
  interpret mode (their CPU default), 64-wide blocks, atol 1e-5: both sides
  compute in fp32 and differ only in summation order.
- With dropout the two packages' random bits differ by design, so the port
  is held to itself: ``gradcheck`` in float64 (forward and backward agree
  on one mask), the dense oracle fed ``dropout_keep_mask``, and the mask's
  own properties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_attention as pa
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import nn as tnn

B, H = 2, 2
ATOL = 1e-5


def _inputs(T, D, seed=0, n=4, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, H, T, D).astype(dtype) for _ in range(n)]


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [128, 200])  # 200: ragged against 64-blocks
def test_backward_matches_pallas(T, causal, D):
    q, k, v, do = _inputs(T, D, seed=T + D)
    _, vjp = jax.vjp(lambda a, b, c: pa.flash_attention(
        a, b, c, causal=causal, block_q=64, block_k=64),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = fa.flash_attention_reference(tq, tk, tv, causal)
    plain = fa.flash_attention_backward_reference(tq, tk, tv, out, lse, tdo,
                                                  causal)
    for got, ref in zip(plain, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)

    # the autograd.Function: same forward, same plain backward on the CPU
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    launches = (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
                fa.flash_bwd_dkv.launches)
    fa.flash_attention(*leaves, causal).backward(tdo)
    assert (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == launches   # CPU: no kernel
    for leaf, ref in zip(leaves, plain):
        torch.testing.assert_close(leaf.grad, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_gradcheck(causal):
    rs = np.random.RandomState(3)
    q = torch.from_numpy(rs.randn(1, 2, 10, 4)).requires_grad_()
    k = torch.from_numpy(rs.randn(1, 2, 9, 4)).requires_grad_()
    v = torch.from_numpy(rs.randn(1, 2, 9, 4)).requires_grad_()

    def f(a, b, c):
        return fa.flash_attention(a, b, c, causal, dropout_p=0.3,
                                  seed=987654321)

    assert torch.autograd.gradcheck(f, (q, k, v), eps=1e-6, atol=1e-6)


def _dense_dropout(q, k, v, causal, p, seed):
    """dropout(softmax(s)) @ v with the kernels' mask, written out."""
    Bq, Hq, Tq, D = q.shape
    s = q @ k.transpose(-1, -2) / D ** 0.5
    if causal:
        s = s.masked_fill(~torch.ones(Tq, k.shape[2]).bool().tril(), -1e30)
    keep = fa.dropout_keep_mask(seed, Bq * Hq, Tq, k.shape[2], p)
    w = torch.softmax(s, -1) * keep.reshape(s.shape) / (1 - p)
    return w @ v


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_output_equals_dense_oracle(causal):
    q, k, v = map(torch.from_numpy, _inputs(200, 32, seed=5, n=3))
    seed, p = 2 ** 40 + 7, 0.2
    want = _dense_dropout(q, k, v, causal, p, seed)
    out = fa.flash_attention(q, k, v, causal, dropout_p=p, seed=seed)
    torch.testing.assert_close(out, want, rtol=0, atol=ATOL)
    # the LSE stays undropped
    _, lse = fa.flash_attention_reference(q, k, v, causal, dropout_p=p,
                                          seed=seed)
    _, lse0 = fa.flash_attention_lse(q, k, v, causal)
    torch.testing.assert_close(lse, lse0, rtol=0, atol=0)
    # the mask does not depend on the tile size: blockwise at two block
    # sizes takes the same mask as the dense oracle
    for block_k in (32, 64):
        got = fa.blockwise_attention(q, k, v, causal, block_k=block_k,
                                     dropout_p=p, seed=seed)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_attention_impls_share_one_mask():
    """multi_head_attention: the dense branch (T=64) and the kernel branch
    (T=256) both drop with dropout_keep_mask of the same seed."""
    rs = np.random.RandomState(7)
    for T in (64, 256):
        q, k, v = (torch.from_numpy(rs.randn(2, T, 32).astype(np.float32))
                   for _ in range(3))
        got = {impl: tnn.multi_head_attention(
            q, k, v, num_heads=2, impl=impl, attn_dropout=0.1,
            dropout_seed=11) for impl in ("dense", "pallas", "auto")}
        torch.testing.assert_close(got["dense"], got["pallas"], rtol=0,
                                   atol=ATOL)
        taken = "pallas" if T == 256 else "dense"
        torch.testing.assert_close(got["auto"], got[taken], rtol=0, atol=0)
    with pytest.raises(Exception, match="dropout_seed"):
        tnn.multi_head_attention(q, k, v, num_heads=2, attn_dropout=0.1)


def test_dropout_mask_is_deterministic_and_seeded():
    a = fa.dropout_keep_mask(5, 4, 64, 96, 0.3)
    assert a.shape == (4, 64, 96) and a.dtype == torch.bool
    assert torch.equal(a, fa.dropout_keep_mask(5, 4, 64, 96, 0.3))
    # small seeds differ in one word only: each still gets its own mask
    # (mirrors test_flash_dropout_distinct_masks_for_small_seeds)
    masks = [fa.dropout_keep_mask(s, 4, 64, 96, 0.3) for s in (1, 2, 2 ** 32)]
    for i in range(3):
        for j in range(i + 1, 3):
            assert not torch.equal(masks[i], masks[j])
    # and the outputs differ with the mask
    q, k, v = map(torch.from_numpy, _inputs(128, 32, n=3))
    o1 = fa.flash_attention(q, k, v, dropout_p=0.3, seed=1)
    o2 = fa.flash_attention(q, k, v, dropout_p=0.3, seed=2)
    assert not torch.allclose(o1, o2)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keep_rate_within_three_sigma(p):
    n = 8 * 256 * 256
    kept = fa.dropout_keep_mask(123, 8, 256, 256, p).sum().item()
    sigma = (n * p * (1 - p)) ** 0.5
    assert abs(kept - n * (1 - p)) < 3 * sigma


def test_dropout_mask_columns_are_absolute():
    """A column window of the mask (col0 offset, as a kernel tile sees it)
    is the same window of the whole mask."""
    full = fa.dropout_keep_mask(9, 3, 50, 130, 0.25)
    for col0, width in ((0, 64), (64, 64), (128, 2), (37, 11)):
        part = fa.dropout_keep_mask(9, 3, 50, width, 0.25, col0=col0)
        assert torch.equal(part, full[:, :, col0:col0 + width])


def test_mask_hash_matches_reference_values():
    """The integer hash of the plain version against values worked out
    with Python integers (the arithmetic the CUDA header does mod 2^32)."""
    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)

    seed, bh, row, col = 0xDEADBEEF12345678, 3, 17, 250
    h = fmix((seed & 0xFFFFFFFF) ^ 0x9E3779B9)
    h = fmix(h ^ (seed >> 32))
    rk = fmix(fmix(h ^ bh) ^ row)
    want = fmix((rk + col * 0x9E3779B9) & 0xFFFFFFFF)
    got = fa._keep_bits(seed, torch.tensor([bh]), torch.tensor([row]),
                        torch.tensor([col]))
    assert int(got) == want


@pytest.mark.parametrize("causal", [False, True])
def test_lse_gradient_matches_pallas(causal):
    """``flash_attention_lse``'s LSE carries its gradient: a loss of
    out.sum() + lse.sum() against ``jax.grad`` of the same loss through
    the JAX package's ``flash_attention_lse`` (its Δ − dlse fold), fp32,
    atol 1e-5."""
    q, k, v = _inputs(200, 32, seed=11, n=3)

    def loss(a, b, c):
        out, lse = pa.flash_attention_lse(a, b, c, causal=causal,
                                          block_q=64, block_k=64)
        return out.sum() + lse.sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out, lse = fa.flash_attention_lse(*leaves, causal)
    (out.sum() + lse.sum()).backward()
    for leaf, ref in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   rtol=0, atol=ATOL)
    # the LSE term is really there: without it the gradient differs
    plain = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*plain, causal).sum().backward()
    assert not torch.allclose(plain[0].grad, leaves[0].grad, atol=1e-3)


@pytest.mark.parametrize("D", [36, 100])
def test_head_dim_padding_is_exact(D):
    """The wrappers' zero-padding of D to a multiple of 8 (what the
    kernels get for a ragged D): the plain versions on the padded inputs,
    with the scale of the true D and sliced back, against the plain
    versions on the unpadded ones, fp32, within 1e-6 x max(1, max|ref|)
    (the padded rows are summed in another order)."""
    q, k, v, do = map(torch.from_numpy, _inputs(130, D, seed=D))
    scale = 1.0 / D ** 0.5
    pq, pk, pv, pdo = fa._pad_head_dim(q, k, v, do)
    assert pq.shape[-1] == D + (-D % 8) and not pq[..., D:].any()
    out, lse = fa.flash_attention_reference(q, k, v, True)
    pout, plse = fa.flash_attention_reference(pq, pk, pv, True, scale)
    def close(got, ref):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6 * max(
            1.0, ref.abs().max().item()))

    close(fa._unpad(pout, D), out)
    close(plse, lse)
    assert not pout[..., D:].any()
    delta = fa._delta(do, out)
    close(fa._delta(pdo, pout), delta)
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, do,
                                                 True, None, 0.1, 5)
    dq = fa.flash_bwd_dq_reference(pq, pk, pv, pdo, plse, delta, True,
                                   scale, 0.1, 5)
    dk, dv = fa.flash_bwd_dkv_reference(pq, pk, pv, pdo, plse, delta, True,
                                        scale, 0.1, 5)
    for got, ref in zip((dq, dk, dv), want):
        close(fa._unpad(got, D), ref)


def test_fp16_ragged_head_dim_matches_pallas():
    """float16 at D=36: the port's flash attention (its plain versions on
    the CPU) against the Pallas kernels in interpret mode, forward and
    ``jax.vjp``.  Both compute in fp32 from the same fp16 inputs and round
    their outputs to fp16 (2^-11 relative): out within 2e-3, dq/dk/dv
    within 2e-3 x max(1, max|ref|)."""
    q, k, v, do = _inputs(200, 36, seed=36, dtype=np.float16)
    out, vjp = jax.vjp(lambda a, b, c: pa.flash_attention(
        a, b, c, causal=True, block_q=64, block_k=64),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    assert out.dtype == jnp.float16
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    got = fa.flash_attention(*leaves, True)
    assert got.dtype == torch.float16
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(out, np.float32), rtol=0, atol=2e-3)
    for leaf, ref in zip(leaves, want):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(leaf.grad.float().numpy(), ref, rtol=0,
                                   atol=2e-3 * max(1.0, np.abs(ref).max()))
