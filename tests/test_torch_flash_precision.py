"""The numerical design of the tensor-core flash kernels
(``mxnet_tpu_torch/csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), emulated
on the CPU.

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

``emulate_backward`` does the same for the dq and dk/dv kernels: P and dS
recomputed from the saved LSE in exp2 over 64-wide tiles, S, dP, dQ, dK
and dV formed by the same rounded products, P·m and dS rounded to bf16
before their products on the bf16 route.  The same gates hold on dq, dk
and dv, scaled by max(1, max|ref|) as ``chip_smoke.py`` scales them.
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
    dropout ``keep`` (bool (BH, Tq, Tk)) on P before P·V and 1 / (1 - p)
    on O at the end."""
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
            pt = np.where(keep[:, :, k0:k0 + block_k], pt, np.float32(0))
        acc = acc * corr[..., None] + product(pt, vb, route)
        m = m_new
    l = np.maximum(l, np.float32(1e-30))
    inv = np.float32(1.0 / (1.0 - p)) if keep is not None else np.float32(1)
    return acc * (inv / l)[..., None], m * LN2 + np.log(l)


def emulate_backward(q, k, v, do, lse, delta, route, causal=False,
                     keep=None, p=0.0, block=64):
    """The kernels' backward on fp32 numpy (BH, T, D) arrays, from the
    forward's ``lse`` and Δ = rowsum(dO∘O) (BH, Tq) -> (dq, dk, dv).

    dq kernel: 64-key tiles of S = Q·Kᵀ and dP = dO·Vᵀ, P = exp2(S·scale·
    log2(e) − lse·log2(e)), dS = P∘(m·dP − Δ), dQ += dS·K, scaled at the
    end.  dk/dv kernel: 64-query tiles of the same terms, dV += (P∘keep)ᵀ
    ·dO, scaled by 1 / (1 - p) at the end, and dK += dSᵀ·Q, dK scaled at
    the end.  ``keep`` (bool (BH, Tq, Tk)) is the dropout mask, m = keep /
    (1 - p)."""
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    scale = np.float32(1.0 / np.sqrt(D))
    lse2 = (lse * LOG2E)[..., None]
    dl = delta[..., None]
    inv = np.float32(1.0 / (1.0 - p))

    def terms(r0, r1, c0, c1):
        """(P∘keep, dS) of queries r0:r1 against keys c0:c1."""
        s = product(q[:, r0:r1], k[:, c0:c1].transpose(0, 2, 1), route)
        if causal:
            above = np.arange(c0, c1)[None, :] > np.arange(r0, r1)[:, None]
            s = np.where(above, NEG_INF, s)
        pt = np.exp2(s * (scale * LOG2E) - lse2[:, r0:r1])
        dp = product(do[:, r0:r1], v[:, c0:c1].transpose(0, 2, 1), route)
        pk = pt
        if keep is not None:
            kept = keep[:, r0:r1, c0:c1]
            pk = np.where(kept, pt, np.float32(0))
            dp = np.where(kept, dp * inv, np.float32(0))
        return pk, pt * (dp - dl[:, r0:r1])

    dq = np.zeros_like(q)
    for c0 in range(0, Tk, block):
        c1 = min(c0 + block, Tk)
        dq += product(terms(0, Tq, c0, c1)[1], k[:, c0:c1], route)
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for r0 in range(0, Tq, block):
        r1 = min(r0 + block, Tq)
        pk, ds = terms(r0, r1, 0, Tk)
        dv += product(pk.transpose(0, 2, 1), do[:, r0:r1], route)
        dk += product(ds.transpose(0, 2, 1), q[:, r0:r1], route)
    return dq * scale, dk * scale, dv * (inv if keep is not None else 1)


def backward64(q, k, v, do, causal=False):
    """Dense attention's gradients in float64 -> ((dq, dk, dv), lse, Δ)."""
    q, k, v, do = (x.astype(np.float64) for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = q @ k.transpose(0, 2, 1) * scale
    if causal:
        Tq, Tk = s.shape[1:]
        s = np.where(np.triu(np.ones((Tq, Tk), bool), 1), -np.inf, s)
    mx = s.max(-1, keepdims=True)
    lse = mx + np.log(np.exp(s - mx).sum(-1, keepdims=True))
    p = np.exp(s - lse)
    delta = (do * (p @ v)).sum(-1, keepdims=True)
    ds = p * (do @ v.transpose(0, 2, 1) - delta)
    grads = (ds @ k * scale, ds.transpose(0, 2, 1) @ q * scale,
             p.transpose(0, 2, 1) @ do)
    return grads, lse[..., 0], delta[..., 0]


def _gate_err(got, ref):
    """max|got - ref| / max(1, max|ref|), chip_smoke.py's backward error."""
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("route", ["3xtf32", "1xtf32", "bf16"])
def test_backward_route_error_against_float64(route, causal):
    # four heads at the training shape T=512, D=64, with the LSE and Δ of
    # an exact forward
    rs = np.random.RandomState(5)
    q, k, v, do = (rs.randn(4, 512, 64).astype(np.float32)
                   for _ in range(4))
    if route == "bf16":
        q, k, v, do = map(bf16, (q, k, v, do))
    ref, lse, delta = backward64(q, k, v, do, causal)
    got = emulate_backward(q, k, v, do, lse.astype(np.float32),
                           delta.astype(np.float32), route, causal)
    errs = [_gate_err(g, r) for g, r in zip(got, ref)]
    if route == "1xtf32":
        # why both backward kernels split: dq and dk miss the gate
        assert max(errs) > TOL_O["3xtf32"], errs
    else:
        assert max(errs) <= TOL_O[route], errs
    if route == "3xtf32":
        assert max(errs) <= 1e-5, errs   # the gate holds with 10x to spare


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [128, 200])   # 200: ragged against 64-tiles
def test_emulated_backward_matches_pallas(T, causal):
    # the JAX package's _flash_backward (interpret mode, 64-wide blocks)
    # from its own forward's O and LSE
    rs = np.random.RandomState(T)
    q, k, v, do = (rs.randn(2, T, 64).astype(np.float32) for _ in range(4))
    seed = jnp.zeros((1,), jnp.int32)
    jq, jk, jv, jdo = (jnp.asarray(x[None]) for x in (q, k, v, do))
    out, lse = pa._flash_forward(jq, jk, jv, seed, causal, None, 64, 64,
                                 True, 0.0, want_lse=True)
    want = pa._flash_backward(jq, jk, jv, seed, out, lse, jdo, causal,
                              1.0 / 8.0, 64, 64, True, 0.0)
    delta = (do * np.asarray(out)[0]).sum(-1)
    got = emulate_backward(q, k, v, do, np.asarray(lse)[:, :T], delta,
                           "3xtf32", causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w)[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_emulated_backward_dropout_matches_plain_version(causal):
    # the dropout factor on P·m and dP with the kernels' mask: the plain
    # backward's function
    q, k, v = _inputs(4, 130, 32, seed=6)
    do = np.random.RandomState(7).randn(4, 130, 32).astype(np.float32)
    p, seed = 0.1, 2024
    keep = fa.dropout_keep_mask(seed, 4, 130, 130, p).numpy()
    tq, tk, tv, tdo = (torch.from_numpy(x[None]) for x in (q, k, v, do))
    out, lse = fa.flash_attention_reference(tq, tk, tv, causal,
                                            dropout_p=p, seed=seed)
    want = fa.flash_attention_backward_reference(tq, tk, tv, out, lse, tdo,
                                                 causal, None, p, seed)
    delta = fa._delta(tdo, out)[0].numpy()
    got = emulate_backward(q, k, v, do, lse[0].numpy(), delta, "3xtf32",
                           causal, keep=keep, p=p)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w[0].numpy(), rtol=0, atol=1e-5)
