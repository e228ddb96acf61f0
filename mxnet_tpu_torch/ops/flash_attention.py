"""Flash attention: the hand-written CUDA forward kernel and its plain
PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas_attention.py``.  Layout is
(B, H, T, D) as there.

- ``flash_attention``           -- the wrapper.  A CUDA tensor launches
                                   ``csrc/flash_fwd.cu`` (the port of the
                                   Pallas ``_flash_kernel``) or raises; a
                                   CPU tensor runs the plain version.
- ``flash_attention_reference`` -- the plain version: dense fp32 softmax
                                   attention plus the row logsumexp.
- ``blockwise_attention``       -- a plain port of the JAX blockwise
                                   online-softmax scan (``impl='flash'``).

Forward only: the backward kernels and in-kernel dropout arrive with the
training slice, so ``dropout_p > 0`` raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_reference",
           "blockwise_attention", "use_flash", "DEFAULT_BLOCKWISE_K"]

_NEG_INF = -1e30
DEFAULT_BLOCKWISE_K = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scale(q, sm_scale):
    return sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def _no_dropout(dropout_p):
    if dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet: it lands with the "
            "training slice (backward kernels + in-kernel dropout mask)")


def flash_attention_reference(q, k, v, causal=False, sm_scale=None):
    """Dense softmax attention in fp32 -> (out in q's dtype, lse fp32).

    ``lse`` is (B, H, Tq): log sum_k exp(scale * q.k) over the keys each
    query may see (top-left aligned causal mask, as the TPU kernel)."""
    scale = _scale(q, sm_scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype), lse


def flash_attention(q, k, v, causal=False, sm_scale=None, dropout_p=0.0):
    """Flash attention forward -> ``(out, lse)``.

    q: (B, H, Tq, D); k, v: (B, H, Tk, D); out like q; lse (B, H, Tq) fp32.
    Tensors on the CPU take ``flash_attention_reference``.  CUDA tensors
    launch the kernel: contiguous float32 or bfloat16, D a multiple of 8
    and at most 256; anything else raises (``use_flash`` also admits a D
    that is no multiple of 8, which raises here rather than falling back).
    ``flash_attention.launches`` counts kernel launches."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        _no_dropout(dropout_p)
        return flash_attention_reference(q, k, v, causal, sm_scale)
    return _flash_forward_cuda(q, k, v, bool(causal), _scale(q, sm_scale),
                               dropout_p)


flash_attention.launches = 0


def _flash_forward_cuda(q, k, v, causal, scale, dropout_p):
    from . import _ext

    _no_dropout(dropout_p)
    if not all(t.device.type == "cuda" for t in (q, k, v)) or \
            len({t.device for t in (q, k, v)}) != 1:
        raise MXNetError("flash_attention: q, k, v must all lie on one "
                         "CUDA device or all on the CPU (got %s)"
                         % [str(t.device) for t in (q, k, v)])
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise MXNetError("flash_attention kernel takes float32 or bfloat16 "
                         "q/k/v of one dtype (got %s)"
                         % [t.dtype for t in (q, k, v)])
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention expects (B, H, T, D) tensors")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if tuple(k.shape) != (B, H, Tk, D) or tuple(v.shape) != (B, H, Tk, D):
        raise MXNetError("flash_attention: k/v shapes %s/%s do not match q "
                         "%s" % (tuple(k.shape), tuple(v.shape),
                                 tuple(q.shape)))
    if D % 8 or D > 256 or min(B, H, Tq, Tk) < 1:
        raise MXNetError("flash_attention kernel needs D a multiple of 8 "
                         "and <= 256 and non-empty tensors (got %s, Tk=%d)"
                         % (tuple(q.shape), Tk))
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise MXNetError("flash_attention kernel takes contiguous q/k/v")
    lib = _ext.load()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.mx_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B * H, Tq, Tk, D, ctypes.c_float(scale),
        int(causal), _DTYPE_CODE[q.dtype], q.device.index or 0, stream)
    if err != 0:
        raise MXNetError("flash_fwd launch failed: CUDA error %d" % err)
    flash_attention.launches += 1
    return out, lse


def blockwise_attention(q, k, v, causal=False, sm_scale=None, block_k=None,
                        dropout_p=0.0):
    """Online-softmax attention over K/V blocks of ``block_k`` keys (plain
    PyTorch; the port of the JAX ``lax.scan`` version, default 256)."""
    _no_dropout(dropout_p)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = _scale(q, sm_scale)
    block_k = min(int(block_k or DEFAULT_BLOCKWISE_K), Tk)
    qs = q.float() * scale
    q_idx = torch.arange(Tq, device=q.device)
    m = torch.full((B, H, Tq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, Tk, block_k):
        kblk = k[:, :, k0:k0 + block_k].float()
        vblk = v[:, :, k0:k0 + block_k].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qs, kblk)
        if causal:
            k_idx = k0 + torch.arange(kblk.shape[2], device=q.device)
            s = s.masked_fill(k_idx[None, :] > q_idx[:, None], _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                   vblk)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def use_flash(seq_q, seq_k, head_dim, has_mask):
    """Dispatch heuristic for impl='auto': flash pays off once the score
    matrix no longer fits the fusion footprint; dense einsum wins short-T."""
    if has_mask:
        return False
    return seq_q * seq_k >= 256 * 256 and head_dim <= 256
