"""Flash attention: the hand-written CUDA kernels (forward, dq, dk/dv) and
their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas_attention.py``.  Layout is
(B, H, T, D) as there.

- ``flash_attention``        -- the entry point -> ``out``: a
                                ``torch.autograd.Function`` (in place of the
                                JAX ``custom_vjp``) whose forward is
                                ``csrc/flash_fwd.cu`` and whose backward is
                                Δ = rowsum(dO∘O) followed by ``flash_bwd_dq``
                                and ``flash_bwd_dkv`` (``csrc/flash_bwd.cu``).
- ``flash_attention_lse``    -- ``(out, lse)`` with the LSE differentiable
                                (no dropout): its cotangent folds into the
                                same kernels as Δ − dlse.
- ``flash_bwd_dq``,
  ``flash_bwd_dkv``          -- the backward kernels' wrappers.
- ``*_reference``            -- the plain versions, dense in fp32 (fp64 for
                                fp64 inputs).
- ``dropout_keep_mask``      -- the exact keep mask the kernels regenerate.
- ``blockwise_attention``    -- a plain port of the JAX blockwise
                                online-softmax scan (``impl='flash'``).

The forward's tile is a choice: ``block_q`` query rows a block (16 a warp)
and ``block_k`` keys a K/V tile.  ``compiled_tiles`` lists the pairs
``csrc/flash_fwd.cu`` instantiates for a dtype and head dim, the hand-set
default first (``default_tiles``); without dropout the other row count
(64 <-> 128) is compiled too, where its shared memory fits.  An explicit
pair wins; else, with ``mx.autotune`` on, the ``flash_attention`` site's
stored winner; else the default.  A stored winner that is not compiled is
counted (``autotune_fallback_total{reason="invalid_config"}``) and gives
the default; an explicit pair that is not compiled raises on the card.
The plain versions are exact whatever the tiling and ignore the pair.
The backward kernels keep their one tile.

Every wrapper takes its plain version for tensors on the CPU only; a CUDA
tensor launches the kernel or raises.  The kernels take float32, bfloat16
and float16 and any head dim D <= 256: a D that is no multiple of 8 is
zero-padded to the next one for the launch (the kernels copy rows in
16-byte chunks) and the outputs are sliced back.  The padding is exact:
zero columns add nothing to q.k, to Δ or to the LSE, and the scale comes
from the true D.

Attention dropout (``dropout_p`` > 0) drops probabilities after the
softmax, as the TPU kernels do: the softmax denominator and the LSE keep the
undropped mass.  Its keep bit is a counter-based hash of the absolute
(seed, batch*head, query row, key column) (``csrc/flash_common.cuh``), so
the mask is independent of the kernels' tile sizes, is regenerated by all
three kernels and never stored; ``dropout_keep_mask`` computes the same
bits with integer tensor ops.  Its bits do not match the TPU generator's.
The kernels read the 64-bit seed from device memory: a seed given as an
int64 tensor on the card (``random.draw_seed``) is read where it lies, so
a step captured into a CUDA graph draws a new mask on every replay; an
int seed is copied to the card first.  The plain versions take either.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_lse",
           "flash_attention_reference", "compiled_tiles", "default_tiles",
           "flash_attention_backward_reference", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_bwd_dq_reference",
           "flash_bwd_dkv_reference", "dropout_keep_mask",
           "blockwise_attention", "use_flash", "DEFAULT_BLOCKWISE_K"]

_NEG_INF = -1e30
DEFAULT_BLOCKWISE_K = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16"}
# a block's shared memory on an H100 (csrc/flash_fwd.cu's Smem::kBytes
# must not exceed it)
_SMEM_LIMIT = 232448


def _head_bucket(D):
    """The head-dim instance a D runs in (D padded to a multiple of 8)."""
    Dp = D + (-D % 8)
    return next(b for b in (32, 64, 128, 256) if Dp <= b)


def _smem_bytes(dtype, kD, rows, keys):
    """Shared memory of one forward instance: Q and a two-stage K/V ring,
    rows padded by 16 bytes (``Smem`` of csrc/flash_fwd.cu)."""
    size = 4 if dtype == "float32" else 2
    ld = kD + 16 // size
    return (rows + 4 * keys) * ld * size


def default_tiles(dtype, D):
    """The forward's hand-set (block_q, block_k) for a dtype name and head
    dim: 128 rows (8 warps) for float32, 64 (4 warps) for the 16-bit types
    and for float32 at D > 128; 64 keys, 32 for float32 at D > 128."""
    kD = _head_bucket(D)
    if dtype == "float32":
        return (64, 32) if kD > 128 else (128, 64)
    return (64, 64)


def compiled_tiles(dtype, D, dropout=False):
    """The (block_q, block_k) pairs csrc/flash_fwd.cu instantiates for
    ``dtype`` (a name) and head dim ``D``, the default first.  Dropout runs
    the default alone; without it the other row count (64 <-> 128) at the
    default key tile, where its shared memory fits a block."""
    rows, keys = default_tiles(dtype, D)
    out = [(rows, keys)]
    other = 192 - rows
    if not dropout and \
            _smem_bytes(dtype, _head_bucket(D), other, keys) <= _SMEM_LIMIT:
        out.append((other, keys))
    return out


def _tuned_tiles(q, k, causal, dropout_p, compiled):
    """The ``flash_attention`` autotune winner for this workload among
    ``compiled``, or the default (``compiled[0]``): off, cold, under
    dropout (it pins the default, as in the JAX package) or for a stored
    pair that is not compiled (counted as ``invalid_config``)."""
    from .. import autotune as _at

    if dropout_p > 0.0 or not _at.is_enabled():
        return compiled[0]
    B, H, Tq, D = q.shape
    cfg = _at.lookup("flash_attention",
                     (B, H, Tq, k.shape[2], D, _DTYPE_NAME[q.dtype],
                      bool(causal)), list(compiled[0]))
    try:
        tuned = (int(cfg[0]), int(cfg[1]))
    except (TypeError, ValueError, IndexError):
        tuned = None
    if tuned in compiled:
        return tuned
    _at.fallback("invalid_config")
    return compiled[0]


def _resolve_tiles(q, k, causal, dropout_p, block_q, block_k):
    """(block_q, block_k) of a forward launch: the explicit values, else
    the autotune winner, else the default.  Raises on a pair that was not
    compiled."""
    dname = _DTYPE_NAME[q.dtype]
    D = q.shape[-1]
    compiled = compiled_tiles(dname, D, dropout_p > 0.0)
    tiles = compiled[0]
    if block_q is None or block_k is None:
        tiles = _tuned_tiles(q, k, causal, dropout_p, compiled)
    want = (int(block_q) if block_q is not None else tiles[0],
            int(block_k) if block_k is not None else tiles[1])
    if want not in compiled:
        raise MXNetError(
            "flash_attention: tiles (block_q=%d, block_k=%d) are not compiled "
            "for %s at D=%d%s; compiled: %s"
            % (want + (dname, D, " with dropout" if dropout_p else "",
                       [list(t) for t in compiled])))
    return want


# the launch counts are read across threads (a server's scheduler and a
# hot swap's warm-up launch at once): each increment under one lock
_COUNT = threading.Lock()

# ---- the dropout mask (the hash of csrc/flash_common.cuh) -----------------
_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x, c):
    """x * c mod 2^32 for x in [0, 2^32) (int64 tensor or int) and a 32-bit
    constant c, with no intermediate above 2^49."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _fmix32(h):
    """murmur3's 32-bit finaliser on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _keep_threshold(p):
    """Keep when bits < this: the TPU kernel's uint32((1-p)·(2^32-1))."""
    return int((1.0 - p) * float(2 ** 32 - 1))


def _seed_halves(seed):
    """(low, high) 32-bit halves of a 64-bit seed: an int, or a 0-dim (or
    one-element) int64 tensor holding its bits, split on its device."""
    if isinstance(seed, torch.Tensor):
        s = seed.reshape(()).to(torch.int64)
        return s & _MASK32, (s >> 32) & _MASK32
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s & _MASK32, s >> 32


def _keep_bits(seed, bh, rows, cols):
    """Hash bits for every (bh, row, col): int64 (len(bh), len(rows),
    len(cols)) in [0, 2^32).  bh, rows, cols: 1-D int64 tensors; seed an
    int or an int64 tensor (``_seed_halves``)."""
    lo, hi = _seed_halves(seed)
    h = _fmix32(lo ^ _GOLDEN)
    h = _fmix32(h ^ hi)
    bh_key = _fmix32(h ^ bh)                                  # (BH,)
    row_key = _fmix32(bh_key[:, None] ^ rows[None, :])        # (BH, Tq)
    col = _mul32(cols, _GOLDEN)                               # (Tk,)
    return _fmix32((row_key[:, :, None] + col[None, None, :]) & _MASK32)


def dropout_keep_mask(seed, BH, Tq, Tk, p, device=None, col0=0):
    """The kernels' keep mask: bool (BH, Tq, Tk), True where the attention
    probability of (batch*head, query row, key column + col0) is kept at
    dropout rate ``p`` with 64-bit ``seed`` (an int, or an int64 tensor
    on ``device`` holding its bits)."""
    def ar(n, start=0):
        return torch.arange(start, start + n, dtype=torch.int64,
                            device=device)

    return _keep_bits(seed, ar(BH), ar(Tq), ar(Tk, col0)) \
        < _keep_threshold(p)


def _acc_dtype(x):
    """Accumulation type of the plain versions: fp32, or fp64 for fp64."""
    return torch.promote_types(x.dtype, torch.float32)


def _scale(q, sm_scale):
    return sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def _drop_factor(seed, p, B, H, Tq, Tk, k0, device, dtype):
    """keep / (1 - p) as a (B, H, Tq, Tk) tensor of ``dtype``."""
    keep = dropout_keep_mask(seed, B * H, Tq, Tk, p, device, col0=k0)
    return keep.reshape(B, H, Tq, Tk).to(dtype) / (1.0 - p)


def _scores(q, k, causal, scale, ft):
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ft) * scale, k.to(ft))
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_attention_reference(q, k, v, causal=False, sm_scale=None,
                              dropout_p=0.0, seed=0):
    """Dense softmax attention -> (out in q's dtype, lse).

    ``lse`` is (B, H, Tq): log sum_k exp(scale * q.k) over the keys each
    query may see (top-left aligned causal mask, as the TPU kernel), fp32
    (fp64 for fp64 inputs).  With ``dropout_p`` the probabilities are
    multiplied by ``dropout_keep_mask(seed, ...) / (1 - dropout_p)`` after
    the softmax; ``lse`` stays undropped."""
    scale = _scale(q, sm_scale)
    ft = _acc_dtype(q)
    s = _scores(q, k, causal, scale, ft)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if dropout_p > 0.0:
        B, H, Tq, Tk = s.shape
        p = p * _drop_factor(seed, dropout_p, B, H, Tq, Tk, 0, q.device, ft)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(ft))
    return out.to(q.dtype), lse


def _bwd_terms(q, k, v, do, lse, delta, causal, scale, dropout_p, seed):
    """(p*m, ds) of the backward, dense: p = exp(s - lse), m the dropout
    factor, ds = p * (m * dO.v - delta)."""
    ft = _acc_dtype(q)
    s = _scores(q, k, causal, scale, ft)
    p = torch.exp(s - lse.to(ft)[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(ft), v.to(ft))
    pm = p
    if dropout_p > 0.0:
        B, H, Tq, Tk = s.shape
        m = _drop_factor(seed, dropout_p, B, H, Tq, Tk, 0, q.device, ft)
        pm, dp = p * m, dp * m
    return pm, p * (dp - delta.to(ft)[..., None])


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=False,
                           scale=None, dropout_p=0.0, seed=0):
    """Plain version of the dq kernel: dq = scale * ds K, in q's dtype."""
    scale = _scale(q, scale)
    _, ds = _bwd_terms(q, k, v, do, lse, delta, causal, scale, dropout_p,
                       seed)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(ds.dtype)) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal=False,
                            scale=None, dropout_p=0.0, seed=0):
    """Plain version of the dk/dv kernel: dv = (p m)^T dO and
    dk = scale * ds^T Q, in k's and v's dtypes."""
    scale = _scale(q, scale)
    pm, ds = _bwd_terms(q, k, v, do, lse, delta, causal, scale, dropout_p,
                        seed)
    ft = ds.dtype
    dv = torch.einsum("bhqk,bhqd->bhkd", pm, do.to(ft))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(ft) * scale)
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(do, o):
    """Δ = rowsum(dO∘O), the softmax backward's row term (fp32, or fp64
    for fp64 inputs), as the JAX package computes it outside its kernels."""
    ft = _acc_dtype(o)
    return (do.to(ft) * o.to(ft)).sum(-1)


def flash_attention_backward_reference(q, k, v, o, lse, do, causal=False,
                                       scale=None, dropout_p=0.0, seed=0):
    """The plain backward: (dq, dk, dv) of ``flash_attention_reference``
    at output ``o`` and cotangent ``do``, a dense recompute with the same
    dropout mask."""
    delta = _delta(do, o)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale,
                                dropout_p, seed)
    return (dq,) + flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                           scale, dropout_p, seed)


# ---- the kernels' wrappers ------------------------------------------------
def _on_cpu(*ts):
    return all(t.device.type == "cpu" for t in ts)


def _check_device(name, ts):
    if not all(t.device.type == "cuda" for t in ts) or \
            len({t.device for t in ts}) != 1:
        raise MXNetError("%s: inputs must all lie on one CUDA device or all "
                         "on the CPU (got %s)"
                         % (name, [str(t.device) for t in ts]))


def _stream(t):
    """The current stream of ``t``'s card, as the C entry points take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name, ts, shapes):
    """Checks every kernel wrapper makes before it launches: one CUDA
    device, float32/bfloat16/float16 of one dtype, (B, H, T, D) with D at
    most 256, contiguous."""
    _check_device(name, ts)
    dtype = ts[0].dtype
    if dtype not in _DTYPE_CODE or any(t.dtype != dtype for t in ts):
        raise MXNetError("%s kernel takes float32, bfloat16 or float16 "
                         "inputs of one dtype (got %s)"
                         % (name, [t.dtype for t in ts]))
    for t, want in zip(ts, shapes):
        if t.dim() != 4 or tuple(t.shape) != want:
            raise MXNetError("%s: shape %s, expected %s"
                             % (name, tuple(t.shape), want))
    B, H, Tq, D = shapes[0]
    if D > 256 or min(B, H, Tq, D, shapes[1][2]) < 1:
        raise MXNetError("%s kernel needs 1 <= D <= 256 and non-empty "
                         "tensors (got %s, Tk=%d)"
                         % (name, shapes[0], shapes[1][2]))
    if not all(t.is_contiguous() for t in ts):
        raise MXNetError("%s kernel takes contiguous inputs" % name)


def _check_aligned(name, what, ts):
    """The kernels copy rows in 16-byte cp.async chunks: a view off a
    16-byte boundary would fault the card's context instead of raising."""
    if any(t.data_ptr() % 16 for t in ts):
        raise MXNetError("%s kernel needs %s to start on a 16-byte boundary "
                         "(addresses mod 16: %s)"
                         % (name, what, [t.data_ptr() % 16 for t in ts]))


def _check_rows(name, ts, B, H, Tq):
    _check_device(name, ts)
    for t in ts:
        if t.dtype != torch.float32 or \
                tuple(t.shape) != (B, H, Tq) or not t.is_contiguous():
            raise MXNetError("%s: lse/delta must be contiguous float32 "
                             "(B, H, Tq) on the card (got %s %s %s)"
                             % (name, t.dtype, tuple(t.shape), t.device))


def _seed_tensor(seed, device):
    """The seed as a one-element int64 tensor on ``device``, the memory the
    kernels read it from: a tensor seed is checked and used as it is
    (nothing is read back to the host, so a captured launch sees each
    replay's seed); an int seed is copied there."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1 or \
                seed.device != device:
            raise MXNetError("dropout seed must be one int64 on %s (got "
                             "%s %s on %s)" % (device, seed.dtype,
                                               tuple(seed.shape),
                                               seed.device))
        return seed.contiguous()
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor(s - (1 << 64) if s >> 63 else s, dtype=torch.int64,
                        device=device)


def _dropout_args(dropout_p, seed, device):
    """((flag, seed address, keep threshold, 1 / keep) for the C entry
    points, the seed tensor the address points into)."""
    if not 0.0 <= dropout_p < 1.0:
        raise MXNetError("dropout_p must lie in [0, 1), got %r" % dropout_p)
    if dropout_p == 0.0:
        return (0, None, 0, ctypes.c_float(1.0)), None
    st = _seed_tensor(seed, device)
    return ((1, st.data_ptr(), _keep_threshold(dropout_p),
             ctypes.c_float(1.0 / (1.0 - dropout_p))), st)


def _launch(name, fn, *args):
    err = fn(*args)
    if err != 0:
        raise MXNetError("%s launch failed: CUDA error %d" % (name, err))


def _pad_head_dim(*ts):
    """Zero-pad the last dim of each tensor to the next multiple of 8, the
    width the kernels' 16-byte row copies need; unchanged when it is one."""
    D = ts[0].shape[-1]
    pad = -D % 8
    if not pad:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in ts)


def _unpad(t, D):
    """The first D columns of a kernel output, as a contiguous tensor."""
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def _flash_forward(q, k, v, causal, scale, dropout_p, seed, block_q=None,
                   block_k=None):
    """Forward wrapper: plain version on the CPU (exact whatever the
    tiling: the tiles are ignored), the kernel on the card at the tiles
    ``_resolve_tiles`` gives."""
    if _on_cpu(q, k, v):
        if (block_q is None or block_k is None) and q.dim() == 4 and \
                q.dtype in _DTYPE_NAME and q.shape[-1] <= 256:
            # the lookup is counted as on the card; its answer is moot
            _tuned_tiles(q, k, causal, dropout_p,
                         compiled_tiles(_DTYPE_NAME[q.dtype], q.shape[-1],
                                        dropout_p > 0.0))
        return flash_attention_reference(q, k, v, causal, scale, dropout_p,
                                         seed)
    from . import _ext

    if q.dim() != 4 or k.dim() != 4:
        raise MXNetError("flash_attention expects (B, H, T, D) tensors")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    _check_cuda("flash_attention", (q, k, v),
                ((B, H, Tq, D), (B, H, Tk, D), (B, H, Tk, D)))
    rows, keys = _resolve_tiles(q, k, causal, dropout_p, block_q, block_k)
    q, k, v = _pad_head_dim(q, k, v)
    _check_aligned("flash_attention", "q, k and v", (q, k, v))
    # seed_mem holds the seed's memory until the launch is enqueued
    drop, seed_mem = _dropout_args(dropout_p, seed, q.device)
    lib = _ext.load()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    stream = _stream(q)
    _launch("flash_fwd", lib.mx_flash_fwd,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B * H, Tq, Tk, q.shape[-1],
            ctypes.c_float(scale), int(causal), _DTYPE_CODE[q.dtype], rows,
            *drop, q.device.index or 0, stream)
    with _COUNT:
        flash_attention.launches += 1
        flash_attention.launches_by_tile[rows, keys] = \
            flash_attention.launches_by_tile.get((rows, keys), 0) + 1
    return _unpad(out, D), lse


def _bwd_args(name, q, k, v, do, lse, delta):
    """Checks, then the head-dim padding: -> (q, k, v, do) as launched and
    (B, H, Tq, Tk, D) with D the true head dim."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    _check_cuda(name, (q, k, v, do),
                ((B, H, Tq, D), (B, H, Tk, D), (B, H, Tk, D),
                 (B, H, Tq, D)))
    _check_rows(name, (lse, delta), B, H, Tq)
    q, k, v, do = _pad_head_dim(q, k, v, do)
    _check_aligned(name, "q, k, v and dO", (q, k, v, do))
    return (q, k, v, do), (B, H, Tq, Tk, D)


def flash_bwd_dq(q, k, v, do, lse, delta, causal=False, scale=None,
                 dropout_p=0.0, seed=0):
    """dq of flash attention from the forward's ``lse`` and Δ =
    rowsum(dO∘O): the ``csrc/flash_bwd.cu`` dq kernel on the card (port of
    the Pallas ``_bwd_dq_kernel``), ``flash_bwd_dq_reference`` on the CPU.
    ``flash_bwd_dq.launches`` counts kernel launches."""
    scale = _scale(q, scale)
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                      scale, dropout_p, seed)
    from . import _ext

    (q, k, v, do), (B, H, Tq, Tk, D) = _bwd_args("flash_bwd_dq", q, k, v,
                                                 do, lse, delta)
    # seed_mem holds the seed's memory until the launch is enqueued
    drop, seed_mem = _dropout_args(dropout_p, seed, q.device)
    lib = _ext.load()
    dq = torch.empty_like(q)
    stream = _stream(q)
    _launch("flash_bwd_dq", lib.mx_flash_bwd_dq,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, Tq, Tk,
            q.shape[-1], ctypes.c_float(scale), int(causal),
            _DTYPE_CODE[q.dtype], *drop, q.device.index or 0, stream)
    with _COUNT:
        flash_bwd_dq.launches += 1
    return _unpad(dq, D)


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False, scale=None,
                  dropout_p=0.0, seed=0):
    """(dk, dv) of flash attention: the ``csrc/flash_bwd.cu`` dk/dv kernel
    on the card (port of the Pallas ``_bwd_dkv_kernel``),
    ``flash_bwd_dkv_reference`` on the CPU.  ``flash_bwd_dkv.launches``
    counts kernel launches."""
    scale = _scale(q, scale)
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                       scale, dropout_p, seed)
    from . import _ext

    (q, k, v, do), (B, H, Tq, Tk, D) = _bwd_args("flash_bwd_dkv", q, k, v,
                                                 do, lse, delta)
    # seed_mem holds the seed's memory until the launch is enqueued
    drop, seed_mem = _dropout_args(dropout_p, seed, q.device)
    lib = _ext.load()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = _stream(q)
    _launch("flash_bwd_dkv", lib.mx_flash_bwd_dkv,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B * H, Tq, Tk, q.shape[-1], ctypes.c_float(scale), int(causal),
            _DTYPE_CODE[q.dtype], *drop, q.device.index or 0, stream)
    with _COUNT:
        flash_bwd_dkv.launches += 1
    return _unpad(dk, D), _unpad(dv, D)


flash_bwd_dkv.launches = 0


def _flash_backward(ctx, do, dlse=None):
    """(dq, dk, dv) from a forward's saved tensors: Δ = rowsum(dO∘O), less
    the LSE's cotangent where the LSE is an output (the reference's fold:
    ds = p·(dp − Δ) and ∂lse/∂s = p), then the dq and dk/dv kernels."""
    q, k, v, out, lse = ctx.saved_tensors
    causal, scale, dropout_p, seed = ctx.args
    do = do.contiguous()   # arrives strided from the head transposes
    delta = _delta(do, out)
    if dlse is not None:
        delta = delta - dlse.to(delta.dtype)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, dropout_p,
                      seed)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                           dropout_p, seed)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash kernel -> O, saving q, k, v, O and the LSE (the
    seed, int or device tensor, rides along, so the backward regenerates
    the mask from the same one).  Backward: Δ,
    then the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout_p, seed, block_q,
                block_k):
        out, lse = _flash_forward(q, k, v, causal, scale, dropout_p, seed,
                                  block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        return _flash_backward(ctx, do) + (None,) * 6


class _FlashAttentionLSE(torch.autograd.Function):
    """As ``_FlashAttention`` without dropout, returning (O, LSE) with the
    LSE's cotangent folded into Δ."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        out, lse = _flash_forward(q, k, v, causal, scale, 0.0, 0, block_q,
                                  block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, 0.0, 0)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return _flash_backward(ctx, do, dlse) + (None,) * 4


def flash_attention(q, k, v, causal=False, sm_scale=None, block_q=None,
                    block_k=None, dropout_p=0.0, seed=0):
    """Flash attention -> ``out``, differentiable in q, k, v.

    q: (B, H, Tq, D); k, v: (B, H, Tk, D); out like q.  Tensors on the CPU
    take the plain versions.  CUDA tensors launch the kernels: contiguous
    float32, bfloat16 or float16 with D <= 256 (a D that is no multiple of
    8 is zero-padded for the launch); anything else raises.
    ``block_q``/``block_k`` pick the forward kernel's tile (query rows a
    block, keys a K/V tile) among ``compiled_tiles``; None takes the
    ``mx.autotune`` winner or the default, and a pair that was not
    compiled raises on the card.  ``dropout_p`` drops attention
    probabilities with the mask of 64-bit ``seed`` (``dropout_keep_mask``):
    an int, or an int64 tensor on q's device that the kernels read
    (``random.draw_seed``); forward and backward read the same one.  The
    JAX package's ``dropout_key`` (a threefry key) and ``interpret``
    (Pallas' interpret mode) have no counterpart: ``seed`` takes the
    key's place and the CPU's plain version interpret's.
    ``flash_attention.launches`` counts forward kernel launches, and
    ``flash_attention.launches_by_tile`` those of each (block_q,
    block_k)."""
    if not isinstance(seed, torch.Tensor):
        seed = int(seed)
    return _FlashAttention.apply(q, k, v, bool(causal), _scale(q, sm_scale),
                                 float(dropout_p), seed, block_q, block_k)


flash_attention.launches = 0
flash_attention.launches_by_tile = {}


def flash_attention_lse(q, k, v, causal=False, sm_scale=None, block_q=None,
                        block_k=None):
    """Flash attention -> ``(out, lse)``, both differentiable: ``lse``
    (B, H, Tq) fp32 is log sum_k exp(scale * q.k), and its cotangent
    folds into the backward as Δ − dlse (the kernels are
    ``flash_attention``'s, ``block_q``/``block_k`` as there).  No
    dropout, as in the JAX package, where it merges partial results of
    ring attention."""
    return _FlashAttentionLSE.apply(q, k, v, bool(causal),
                                    _scale(q, sm_scale), block_q, block_k)


def blockwise_attention(q, k, v, causal=False, sm_scale=None, block_k=None,
                        dropout_p=0.0, seed=0):
    """Online-softmax attention over K/V blocks of ``block_k`` keys (plain
    PyTorch; the port of the JAX ``lax.scan`` version, default 256).  With
    dropout, the numerator takes the kernels' mask of ``seed`` and the
    denominator the undropped mass."""
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
        if dropout_p > 0.0:
            p = p * _drop_factor(seed, dropout_p, B, H, Tq, kblk.shape[2],
                                 k0, q.device, torch.float32)
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
