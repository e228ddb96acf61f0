"""The numerical design of the tensor-core flash forward
(``mxnet_tpu_torch/csrc/flash_fwd.cu``), emulated on the CPU.

The kernel computes Q·Kᵀ and P·V on the tensor cores.  fp32 inputs take
3xTF32: every operand is split into hi = tf32(x) and lo = tf32(x - hi)
(round to nearest, ties away, as ``cvt.rna.tf32.f32``) and the products
lo·hi + hi·lo + hi·hi are accumulated in fp32.  bf16 inputs take bf16
products with P rounded to bf16 before P·V.  Between the products the
kernel runs the online softmax over 64-key tiles in fp32 with exp2 and
log2(e) folded into the scale.

``emulate_forward`` repeats that arithmetic tile by tile with numpy fp32
matrix products on operands rounded by bit arithmetic, and the tests pin
the choice of route: 3xTF32 meets the kernel's 1e-4 gate on O against
float64 and 1xTF32 does not; the bf16 route stays inside its 2e-2 gate.
The emulated kernel is also held against the JAX package's Pallas forward
(interpret mode) and against the port's plain version with dropout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_attention as pa
from mxnet_tpu_torch.ops import flash_attention as fa

LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
NEG_INF = np.float32(-1e30)
TOL_O = {"3xtf32": 1e-4, "bf16": 2e-2}   # chip_smoke.py's gates on O
TOL_LSE = 1e-3


def tf32(x):
    """fp32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), by bit arithmetic on an int32 view."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((bits + np.int32(0x1000)) & np.int32(~0x1FFF)).view(np.float32)


def bf16(x):
    """fp32 -> the nearest bf16 value (ties to even), kept in fp32."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def product(a, b, route):
    """a @ b as the kernel's tensor cores form it: exact products of the
    rounded operands, fp32 accumulation."""
    if route == "bf16":
        return bf16(a) @ bf16(b)
    a_hi, b_hi = tf32(a), tf32(b)
    if route == "1xtf32":
        return a_hi @ b_hi
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def emulate_forward(q, k, v, route, causal=False, keep=None, p=0.0,
                    block_k=64):
    """The kernel's forward on fp32 numpy (BH, T, D) arrays -> (O, LSE):
    64-key tiles, scale applied to S in fp32 after the product, top-left
    causal mask, online softmax in exp2 with an undropped denominator,
    dropout ``keep`` (bool (BH, Tq, Tk)) on P before P·V."""
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    scale_log2 = np.float32(1.0 / np.sqrt(D)) * LOG2E
    rows = np.arange(Tq)[:, None]
    m = np.full((BH, Tq), NEG_INF, np.float32)
    l = np.zeros((BH, Tq), np.float32)
    acc = np.zeros((BH, Tq, D), np.float32)
    for k0 in range(0, Tk, block_k):
        kb, vb = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        s = product(q, kb.transpose(0, 2, 1), route) * scale_log2
        if causal:
            cols = k0 + np.arange(kb.shape[1])[None, :]
            s = np.where(cols > rows, NEG_INF, s)
        m_new = np.maximum(m, s.max(-1))
        pt = np.exp2(s - m_new[..., None])
        corr = np.exp2(m - m_new)
        l = l * corr + pt.sum(-1)
        if keep is not None:
            pt = np.where(keep[:, :, k0:k0 + block_k],
                          pt * np.float32(1.0 / (1.0 - p)), np.float32(0))
        acc = acc * corr[..., None] + product(pt, vb, route)
        m = m_new
    l = np.maximum(l, np.float32(1e-30))
    return acc / l[..., None], m * LN2 + np.log(l)


def reference64(q, k, v, causal=False):
    """Dense softmax attention in float64 -> (O, LSE)."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = q @ k.transpose(0, 2, 1) / np.sqrt(q.shape[-1])
    if causal:
        Tq, Tk = s.shape[1:]
        s = np.where(np.triu(np.ones((Tq, Tk), bool), 1), -np.inf, s)
    mx = s.max(-1, keepdims=True)
    e = np.exp(s - mx)
    tot = e.sum(-1, keepdims=True)
    return (e / tot) @ v, (mx + np.log(tot))[..., 0]


def _inputs(BH, T, D, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(BH, T, D).astype(np.float32) for _ in range(3)]


def test_tf32_rounding_bits():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)        # TF32's spacing at 1
    x = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -12, 1 + 3 * 2.0 ** -11,
                  -(1 + 2.0 ** -11), 0.0, 3.0], np.float32)
    want = np.array([one + ulp, one, one + 2 * ulp, -(one + ulp), 0.0, 3.0],
                    np.float32)
    np.testing.assert_array_equal(tf32(x), want)   # ties go away from 0
    # hi + lo keeps ~21 bits: the split behind 3xTF32
    y = np.random.RandomState(1).randn(4096).astype(np.float32)
    hi = tf32(y)
    lo = tf32(y - hi)
    assert np.all(hi.view(np.int32) & 0x1FFF == 0)
    assert np.abs(hi + lo - y).max() <= 2.0 ** -20 * np.abs(y).max()
    assert np.abs(hi - y).max() > 2.0 ** -13 * np.abs(y).max()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("route", ["3xtf32", "1xtf32", "bf16"])
def test_route_error_against_float64(route, causal):
    # one batch of 12 heads at the serving shape T=512, D=64
    q, k, v = _inputs(12, 512, 64)
    if route == "bf16":
        q, k, v = map(bf16, (q, k, v))     # the kernel sees bf16 inputs
    out, lse = emulate_forward(q, k, v, route, causal)
    ref_o, ref_lse = reference64(q, k, v, causal)
    err_o = np.abs(out - ref_o).max()
    err_lse = np.abs(lse - ref_lse).max()
    if route == "1xtf32":
        assert err_o > TOL_O["3xtf32"], err_o   # why the kernel splits
    else:
        assert err_o <= TOL_O[route], err_o
        assert err_lse <= TOL_LSE, err_lse
    if route == "3xtf32":
        assert err_o <= 1e-5, err_o   # the gate holds with 10x to spare


@pytest.mark.parametrize("causal", [False, True])
def test_emulated_kernel_matches_pallas(causal):
    # ragged T=200 against 64-key tiles, through the JAX package's kernel
    q, k, v = _inputs(2, 200, 64, seed=3)
    want_o, want_lse = pa.flash_attention_lse(
        *(jnp.asarray(x[None]) for x in (q, k, v)), causal=causal,
        block_q=64, block_k=64)
    out, lse = emulate_forward(q, k, v, "3xtf32", causal)
    np.testing.assert_allclose(out, np.asarray(want_o)[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse, np.asarray(want_lse)[0], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_emulated_dropout_matches_plain_version(causal):
    # P dropped after the softmax with the kernels' mask, denominator and
    # LSE undropped: the plain version's function
    q, k, v = _inputs(4, 130, 32, seed=4)
    p, seed = 0.1, 2024
    keep = fa.dropout_keep_mask(seed, 4, 130, 130, p).numpy()
    out, lse = emulate_forward(q, k, v, "3xtf32", causal, keep=keep, p=p)
    want_o, want_lse = fa.flash_attention_reference(
        *(torch.from_numpy(x[None]) for x in (q, k, v)), causal,
        dropout_p=p, seed=seed)
    np.testing.assert_allclose(out, want_o[0].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse, want_lse[0].numpy(), rtol=0, atol=1e-5)
