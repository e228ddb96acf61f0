"""``mx.nd.linalg``: the LAPACK-family namespace.

Counterpart of ``mxnet_tpu/ndarray/linalg.py``: each short name is the
registry op ``linalg_<name>`` (``nd.linalg.potrf`` is ``linalg_potrf``).
"""
from __future__ import annotations

from ..ops import linalg as _linalg  # noqa: F401  (registration)
from ..ops.registry import get_op as _get_op

_SHORT = [
    "gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "syrk", "gelqf",
    "syevd", "sumlogdiag", "extractdiag", "makediag", "extracttrian",
    "maketrian", "inverse", "det", "slogdet", "cholesky", "qr", "svd",
    "svdvals", "eig", "eigh", "eigvals", "eigvalsh", "solve", "lstsq",
    "pinv", "matrix_rank", "matrix_power", "norm", "cond", "multi_dot",
    "tensorinv", "tensorsolve",
]

for _name in _SHORT:
    globals()[_name] = _get_op("linalg_" + _name)

__all__ = list(_SHORT)
