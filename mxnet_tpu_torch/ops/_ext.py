"""Build and load the port's CUDA kernels.

The sources under ``mxnet_tpu_torch/csrc/`` have a plain C interface.  At
first use, ``nvcc`` compiles them for ``sm_90a`` into one shared library
under ``build/torch_ext/`` of the checkout (rebuilt whenever a source is
newer than the library), and ``ctypes`` loads it.  Nothing is built at
import time, and a failed build raises with the compiler's output: there is
no plain-PyTorch stand-in for a missing kernel.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from ..base import MXNetError

__all__ = ["SOURCES", "LIBRARY", "build", "load"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
LIBRARY = _PKG.parent / "build" / "torch_ext" / "libmxnet_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB = None
build_log = ""  # nvcc's output (ptxas register/shared-memory report)


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError(
            "nvcc not found (looked in %s and on PATH): the port's CUDA "
            "kernels cannot be built on this machine" % cand)
    return found


def _stale():
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any(src.stat().st_mtime > built for src in SOURCES)


def build(force=False):
    """Compile the kernels if the library is missing or older than its
    sources; returns the library path.  Raises with nvcc's stderr."""
    global build_log
    with _LOCK:
        if not force and not _stale():
            return LIBRARY
        nvcc = _nvcc()
        LIBRARY.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIBRARY.parent)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)],
                capture_output=True, text=True, check=False)
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise MXNetError("nvcc failed (exit %d):\n%s"
                                 % (proc.returncode, build_log))
            os.replace(tmp, LIBRARY)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return LIBRARY


def load():
    """The loaded kernel library (built first when needed)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = build()
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(path))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.mx_flash_fwd.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                         ctypes.c_float, ci, ci, ci, vp]
            lib.mx_flash_fwd.restype = ci
            _LIB = lib
    return _LIB
