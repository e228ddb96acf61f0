"""Linear-algebra operator family (the reference's ``_linalg_*``).

Counterpart of ``mxnet_tpu/ops/linalg.py``: the ``la_op.cc`` family
(gemm, gemm2, potrf, potri, trmm, trsm, syrk, gelqf, syevd, sumlogdiag,
the diag/trian helpers, inverse, det, slogdet) and the numpy linalg front
(cholesky, qr, svd, eig(h)(vals), solve, lstsq, pinv, ...).  Each op is a
batched ``torch.linalg`` expression (cuSOLVER/cuBLAS on the card), on
torch's tape where the JAX op is differentiable.

``gelqf`` has no torch op: it is the QR of the transpose, as in the JAX
package.  The nonsymmetric ``eig``/``eigvals`` run on the device here
(``torch.linalg.eig``; the JAX package calls back to host numpy) and
return complex64.
"""
from __future__ import annotations

import numpy as _np
import torch

from .registry import register

__all__ = []


def _t(x):
    """Batched matrix transpose (leading dims are batch)."""
    return x.transpose(-1, -2)


def _promotes(fn):
    """``fn`` with integer tensor arguments in float32, as the
    ``jnp.linalg`` functions promote them (torch's refuse integers)."""
    import functools

    @functools.wraps(fn)
    def op(*args, **kwargs):
        return fn(*[a.to(torch.float32) if isinstance(a, torch.Tensor)
                    and not (a.is_floating_point() or a.is_complex())
                    else a for a in args], **kwargs)

    return op


# The float32 routes torch takes on the card for ``eigh`` and ``svd``
# (cuSOLVER; for the SVD its default ``gesvdj``) are far less accurate
# than LAPACK's float32: relative errors of 2.2e-4 in the eigenvalues and
# 7.3e-5 in the singular values of 32 x 512 x 512 SPD matrices, where
# LAPACK's float32 eigenvalues are 1.1e-7 off; the same one matrix at a
# time or batched, TF32 on or off.  Their float64 routes round to float32
# exactly, and the eigensolver's runs 3x faster than its float32 one.  So
# a float32 matrix on the card is decomposed in float64 and the results
# rounded back (``chip_smoke.py``'s ``np_front`` phase, part d, reads
# both routes).

def _up(A):
    return A.double() if A.is_cuda and A.dtype == torch.float32 else A


def _down(out, A):
    return out.float() if out.dtype == torch.float64 and \
        A.dtype == torch.float32 else out


def _eigh(A, UPLO="L", eigenvectors=True):
    """``torch.linalg.eigh`` (``eigvalsh`` without ``eigenvectors``)."""
    if not eigenvectors:
        return _down(torch.linalg.eigvalsh(_up(A), UPLO=UPLO), A)
    w, v = torch.linalg.eigh(_up(A), UPLO=UPLO)
    return _down(w, A), _down(v, A)


def _svd(A, full_matrices=False):
    return tuple(_down(t, A) for t in torch.linalg.svd(
        _up(A), full_matrices=full_matrices))


def _svdvals(A):
    return _down(torch.linalg.svdvals(_up(A)), A)


# ---- la_op.cc family ------------------------------------------------------

@register("linalg_gemm")
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    """C' = alpha * op(A) @ op(B) + beta * C; ``axis`` names the matrix-row
    axis (moved into place, multiplied, moved back)."""
    if axis != -2:
        A, B, C = (torch.movedim(t, axis, -2) for t in (A, B, C))
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    out = alpha * torch.matmul(a, b) + beta * C
    return torch.movedim(out, -2, axis) if axis != -2 else out


@register("linalg_gemm2")
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("linalg_potrf")
def linalg_potrf(A):
    """Cholesky factor L with A = L L^T."""
    return torch.linalg.cholesky(A)


@register("linalg_potri")
def linalg_potri(L):
    """A^-1 from A's Cholesky factor: (L L^T)^-1 = L^-T L^-1."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(
        L.shape)
    linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.matmul(_t(linv), linv)


@register("linalg_trmm")
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """out = alpha * op(A) @ B (or B @ op(A)), A triangular."""
    tri = torch.tril(A) if lower else torch.triu(A)
    tri = _t(tri) if transpose else tri
    out = torch.matmul(B, tri) if rightside else torch.matmul(tri, B)
    return alpha * out


@register("linalg_trsm")
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Solve op(A) X = alpha B (or X op(A) = alpha B), A triangular."""
    tri = torch.tril(A) if lower else torch.triu(A)
    upper = not lower
    if transpose:
        tri, upper = _t(tri), lower
    return torch.linalg.solve_triangular(tri, alpha * B, upper=upper,
                                         left=not rightside)


@register("linalg_syrk")
def linalg_syrk(A, transpose=False, alpha=1.0):
    """alpha * A A^T (or A^T A when transpose)."""
    return alpha * (torch.matmul(_t(A), A) if transpose
                    else torch.matmul(A, _t(A)))


@register("linalg_gelqf", num_outputs=2)
@_promotes
def linalg_gelqf(A):
    """LQ factorization A = L Q with Q's rows orthonormal: the QR of A^T."""
    q, r = torch.linalg.qr(_t(A), mode="reduced")
    return _t(r), _t(q)


@register("linalg_syevd", num_outputs=2)
def linalg_syevd(A):
    """(U, lambda) with A = U^T diag(lambda) U (rows are eigenvectors)."""
    w, v = _eigh(A)
    return _t(v), w


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register("linalg_extractdiag")
def linalg_extractdiag(A, offset=0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("linalg_makediag")
def linalg_makediag(a, offset=0):
    return torch.diag_embed(a, offset=offset)


@register("linalg_extracttrian")
def linalg_extracttrian(A, offset=0, lower=True):
    """The (lower/upper) triangle packed into a vector."""
    n = A.shape[-1]
    rows, cols = _np.tril_indices(n, k=offset) if lower else \
        _np.triu_indices(n, k=offset)
    return A[..., torch.from_numpy(rows).to(A.device),
             torch.from_numpy(cols).to(A.device)]


@register("linalg_maketrian")
def linalg_maketrian(a, offset=0, lower=True):
    """Unpack a triangle of length n(n+1)/2 (shrunk by ``offset``)."""
    L = a.shape[-1]
    k = abs(offset)
    n = int((_np.sqrt(8 * L + 1) - 1) / 2) + k
    rows, cols = _np.tril_indices(n, k=-k if offset <= 0 else 0) if lower \
        else _np.triu_indices(n, k=k if offset >= 0 else 0)
    rows, cols = rows[:L], cols[:L]
    out = torch.zeros(a.shape[:-1] + (n, n), dtype=a.dtype, device=a.device)
    return _put_batched(out, rows, cols, a)


def _put_batched(out, rows, cols, a):
    flat = out.reshape(-1, out.shape[-2] * out.shape[-1])
    idx = torch.from_numpy(rows * out.shape[-1] + cols).to(a.device)
    flat = flat.index_copy(1, idx, a.reshape(-1, a.shape[-1]))
    return flat.reshape(out.shape)


@register("linalg_inverse")
def linalg_inverse(A):
    return torch.linalg.inv(A)


@register("linalg_det")
def linalg_det(A):
    return torch.linalg.det(A)


@register("linalg_slogdet", num_outputs=2)
def linalg_slogdet(A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


# ---- numpy/linalg front-end ----------------------------------------------

@register("linalg_cholesky")
def linalg_cholesky(A, upper=False):
    L = torch.linalg.cholesky(A)
    return _t(L) if upper else L


@register("linalg_qr", num_outputs=2)
@_promotes
def linalg_qr(A, mode="reduced"):
    q, r = torch.linalg.qr(A, mode=mode)
    return q, r


@register("linalg_svd", num_outputs=3)
@_promotes
def linalg_svd(A, full_matrices=False):
    return _svd(A, full_matrices)


@register("linalg_svdvals")
@_promotes
def linalg_svdvals(A):
    return _svdvals(A)


@register("linalg_eigh", num_outputs=2)
def linalg_eigh(A, UPLO="L"):
    return _eigh(A, UPLO)


@register("linalg_eigvalsh")
def linalg_eigvalsh(A, UPLO="L"):
    return _eigh(A, UPLO, eigenvectors=False)


@register("linalg_eig", num_outputs=2, differentiable=False)
def linalg_eig(A):
    """Nonsymmetric eigendecomposition, complex64 outputs."""
    w, v = torch.linalg.eig(A)
    return w.to(torch.complex64), v.to(torch.complex64)


@register("linalg_eigvals", differentiable=False)
def linalg_eigvals(A):
    return torch.linalg.eigvals(A).to(torch.complex64)


@register("linalg_solve")
def linalg_solve(A, b):
    if b.dim() == A.dim() - 1:      # a vector right-hand side (numpy rule)
        return torch.linalg.solve(A, b.unsqueeze(-1)).squeeze(-1)
    return torch.linalg.solve(A, b)


@register("linalg_lstsq", num_outputs=4, differentiable=False)
@_promotes
def linalg_lstsq(A, b, rcond=None):
    """(x, residuals, rank, singular values), as ``jnp.linalg.lstsq``
    returns them: the SVD route (``gelsd``'s answer), written out so the
    card runs it too (``torch.linalg.lstsq`` takes only ``gels`` there)."""
    vec = b.dim() == 1
    bb = b.unsqueeze(-1) if vec else b
    m, n = A.shape[-2], A.shape[-1]
    u, s, vt = _svd(A)
    if rcond is None:
        rcond = torch.finfo(A.dtype).eps * max(m, n)
    keep = s > rcond * s.max()
    sinv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                       torch.zeros_like(s))
    x = _t(vt) @ (sinv.unsqueeze(-1) * (_t(u) @ bb))
    rank = keep.sum().to(torch.int32)
    # every column's residual, whatever the rank: ``jnp.linalg.lstsq``'s
    # answer (numpy's is empty for a deficient or wide A)
    resid = ((A @ x - bb) ** 2).sum(-2)
    return (x.squeeze(-1) if vec else x), resid, rank, s


@register("linalg_pinv")
@_promotes
def linalg_pinv(A, rcond=None):
    if rcond is None:
        rcond = 10 * max(A.shape[-2:]) * torch.finfo(A.dtype).eps
    return _down(torch.linalg.pinv(_up(A), rtol=rcond), A)


@register("linalg_matrix_rank", differentiable=False)
@_promotes
def linalg_matrix_rank(A, tol=None):
    if tol is None:
        return torch.linalg.matrix_rank(_up(A), rtol=torch.finfo(
            A.dtype).eps * max(A.shape[-2:]))
    return (_svdvals(A) > tol).sum(-1)


@register("linalg_matrix_power")
def linalg_matrix_power(A, n=1):
    return torch.linalg.matrix_power(A, n)


@register("linalg_norm")
@_promotes
def linalg_norm(A, ord=None, axis=None, keepdims=False):
    if ord is None and axis is None:
        return torch.linalg.vector_norm(A, keepdim=keepdims) if not keepdims \
            else torch.linalg.vector_norm(A.reshape(-1)).reshape(
                (1,) * A.dim())
    if isinstance(axis, (tuple, list)) and len(axis) == 2 or (
            axis is None and A.dim() == 2):
        # the 2-norms and the nuclear norm are singular values
        x = _up(A) if ord in (2, -2, "nuc") else A
        return _down(torch.linalg.matrix_norm(
            x, ord="fro" if ord is None else ord,
            dim=tuple(axis) if axis is not None else (-2, -1),
            keepdim=keepdims), A)
    return torch.linalg.vector_norm(A, ord=2 if ord is None else ord,
                                    dim=axis, keepdim=keepdims)


@register("linalg_cond", differentiable=False)
@_promotes
def linalg_cond(A, p=None):
    return _down(torch.linalg.cond(_up(A), p=p), A)


@register("linalg_multi_dot")
def linalg_multi_dot(*arrays):
    return torch.linalg.multi_dot(list(arrays))


@register("linalg_tensorinv")
def linalg_tensorinv(A, ind=2):
    return torch.linalg.tensorinv(A, ind=ind)


@register("linalg_tensorsolve")
def linalg_tensorsolve(A, b, axes=None):
    return torch.linalg.tensorsolve(A, b, dims=axes)
