"""Build and load the port's CUDA kernels.

The sources under ``mxnet_tpu_torch/csrc/`` have a plain C interface.  At
first use, ``nvcc`` compiles them for ``sm_90a``, one process per source,
all started together, and links the objects into one shared library under
``build/torch_ext/`` of the checkout (rebuilt whenever a source or header
is newer than the library); ``ctypes`` loads it.  Nothing is built at import
time, and a failed build raises with the compiler's output: there is no
plain-PyTorch stand-in for a missing kernel.
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

__all__ = ["SOURCES", "LIBRARY", "bind", "build", "load"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
HEADERS = sorted((_PKG / "csrc").glob("*.cuh"))
LIBRARY = _PKG.parent / "build" / "torch_ext" / "libmxnet_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    return any(src.stat().st_mtime > built for src in SOURCES + HEADERS)


def build(force=False):
    """Compile the kernels if the library is missing or older than its
    sources; returns the library path.  Raises with nvcc's stderr."""
    global build_log
    with _LOCK:
        if not force and not _stale():
            return LIBRARY
        nvcc = _nvcc()
        LIBRARY.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=LIBRARY.parent) as tmp:
            objs = [os.path.join(tmp, src.stem + ".o") for src in SOURCES]
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(SOURCES, objs)]
            logs = [proc.communicate()[0] for proc in procs]
            build_log = "".join("== %s\n%s" % (src.name, log)
                                for src, log in zip(SOURCES, logs))
            failed = [src.name for src, proc in zip(SOURCES, procs)
                      if proc.returncode != 0]
            if failed:
                raise MXNetError("nvcc failed on %s:\n%s"
                                 % (", ".join(failed), build_log))
            lib = os.path.join(tmp, LIBRARY.name)
            proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                                  capture_output=True, text=True,
                                  check=False)
            build_log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise MXNetError("nvcc link failed (exit %d):\n%s"
                                 % (proc.returncode, build_log))
            os.replace(lib, LIBRARY)
        return LIBRARY


def bind(lib):
    """Declare the C entry points' signatures on a loaded ``ctypes``
    library; returns ``lib``."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # dropout flag, the seed's address in device memory, keep threshold,
    # 1 / keep
    drop = [ci, vp, ctypes.c_uint32, cf]
    # the forward also takes its tile's query rows after the dtype
    sigs = {"mx_flash_fwd": [vp] * 5 + [ci] * 4 + [cf, ci, ci, ci],
            "mx_flash_bwd_dq": [vp] * 7 + [ci] * 4 + [cf, ci, ci],
            "mx_flash_bwd_dkv": [vp] * 8 + [ci] * 4 + [cf, ci, ci]}
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args + drop + [ci, vp]
        fn.restype = ci
    return lib


def load():
    """The loaded kernel library (built first when needed)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = build()
    with _LOCK:
        if _LIB is None:
            _LIB = bind(ctypes.CDLL(str(path)))
    return _LIB
