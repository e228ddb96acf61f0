"""Package rules of the PyTorch port (``mxnet_tpu_torch``).

- Import: every module of the port imports without pulling ``jax`` or
  ``mxnet_tpu`` into the process, and no source line imports them.
- No fallback: entry points without a ctx want the card and raise where
  there is none; a tensor that is not on the CPU never reaches a kernel's
  plain version.
- Signatures: every public callable the two packages share (module-level
  functions and classes, and the public methods of shared classes) takes
  every argument of the JAX package's, but for the spellings listed in
  ``SPELLINGS``, each documented and pointing to its ``ROADMAP.md`` item;
  and the positional parameters both take come in the JAX package's
  order (at the JAX package's positions, or, for a callable with listed
  spellings, in its relative order).
- The persistence modules (``checkpoint/``, ``legacy_io.py``) never
  import ``ml_dtypes``: the card's machine has none, and bf16 leaves go
  through 16-bit integer views.
- Names: every public name of the JAX ``mx.nd``, ``mx.np`` and ``mx.npx``
  is in the port's, but for the names of the modules a later slice ports
  (``DEFERRED``, each with its ``ROADMAP.md`` item) and the few that are
  not API (``NOT_API``).
"""
import ctypes
import importlib
import inspect
import json
import pkgutil
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, serve, trace
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import _ext
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import nn as ops_nn

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "mxnet_tpu_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import mxnet_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__,
                                              "mxnet_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_import_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "mxnet_tpu_torch.serve.server" in res["modules"]
    assert "mxnet_tpu_torch.ops._ext" in res["modules"]
    for mod in ("error", "ndarray", "ndarray.ndarray", "random",
                "ops.registry", "ops.core", "ops.tensor_tail",
                "ops.legacy", "ops.random_ops", "ndarray.contrib",
                "gluon.rnn", "gluon.rnn.rnn_layer", "gluon.rnn.rnn_cell",
                "gluon.model_zoo.language_model", "native", "recordio",
                "image", "io", "data", "data.reader", "data.ring",
                "data.loader", "gluon.data", "gluon.data.dataset",
                "gluon.data.sampler", "gluon.data.batchify",
                "gluon.data.dataloader", "gluon.data.vision",
                "gluon.data.vision.datasets",
                "gluon.data.vision.transforms", "gluon.nn.moe",
                "serve.kvcache", "serve.decode", "serve.cache",
                "serve.spec",
                "contrib.amp.lists", "gluon.model_zoo.vision.vgg",
                "gluon.model_zoo.vision.alexnet",
                "gluon.model_zoo.vision.mobilenet",
                "gluon.model_zoo.vision.squeezenet",
                "gluon.model_zoo.vision.densenet",
                "gluon.model_zoo.vision.inception", "checkpoint",
                "checkpoint.layout", "checkpoint.manager",
                "checkpoint.writer", "resilience", "resilience.inject",
                "legacy_io", "callback", "config", "metric",
                "ndarray.sparse", "ndarray.dgl", "ops.detection",
                "ops.parity", "resilience.preempt",
                "resilience.supervisor", "elastic", "dist", "dist.timeouts",
                "obs", "obs.core", "obs.slo_engine", "obs.attribution"):
        assert "mxnet_tpu_torch." + mod in res["modules"]
    assert res["bad"] == []


# notes of modules a slice has since ported: none may come back
PORTED_NOTES = {
    "resilience/__init__.py": ["waits in", "Only ``inject`` is ported"],
    "resilience/inject.py": ["wait for their modules (``ROADMAP.md`` "
                             "Queue\n1 item 8"],
    "parallel/__init__.py": ["fault-injection\nsite in ``step`` waits"],
    "step/capture.py": ["the fault-injection and deadline sites"],
    "data/reader.py": ["injection\nsite is not ported"],
    "data/loader.py": ["drain hook (``resilience.preempt``) is not"],
    "gluon/data/dataloader.py": ["(``resilience.preempt``) is not ported"],
    "serve/server.py": ["item 8, part 2", "the SLO block of"],
}


@pytest.mark.parametrize("rel", sorted(PORTED_NOTES))
def test_ported_modules_lose_their_not_ported_notes(rel):
    """Each of these notes said a module of ``ROADMAP.md`` Queue 1 item 8,
    part 2 was missing; those modules are ported (``resilience/{preempt,
    supervisor}.py``, ``dist/timeouts.py``, ``elastic.py``, ``obs/``)."""
    text = (PKG / rel).read_text()
    assert [n for n in PORTED_NOTES[rel] if n in text] == []
    assert "item 8, part 2" not in text


_IMPORT = re.compile(r"^\s*(?:from|import)\s+[^#\n]*"
                     r"(?:\bmxnet_tpu\b(?!_torch)|\bjax\b)", re.M)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in PKG.rglob("*.py")]
    + [Path("chip_smoke.py"), Path("tests/np_cases.py"),
       Path("tests/parity_cases.py")]), ids=str)
def test_source_imports_neither_jax_nor_mxnet_tpu(path):
    assert _IMPORT.findall((ROOT / path).read_text()) == []


_ML_DTYPES = re.compile(r"^\s*(?:from|import)\s+[^#\n]*\bml_dtypes\b",
                        re.M)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in (PKG / "checkpoint").rglob("*.py")]
    + [Path("mxnet_tpu_torch/legacy_io.py")]), ids=str)
def test_persistence_modules_import_no_ml_dtypes(path):
    assert _ML_DTYPES.findall((ROOT / path).read_text()) == []


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_server_without_ctx_wants_the_card(monkeypatch):
    _no_card(monkeypatch)
    blk = nn.Dense(4, flatten=False, in_units=16)
    with pytest.raises(MXNetError, match=r"ctx=mx\.cpu\(\)"):
        serve.Server(blk, config=serve.ServeConfig(
            sample_shapes=[(8, 16)], batch_sizes=(1,), max_batch_size=1))
    with pytest.raises(MXNetError, match=r"ctx=mx\.cpu\(\)"):
        mx.gpu(0).torch_device


class _ClaimsCuda:
    """Stands in for a CUDA tensor: passes every check the wrapper makes
    before it needs the kernel library."""

    device = torch.device("cuda", 0)
    dtype = torch.float32
    shape = (1, 2, 64, 32)
    ptr = 256

    def data_ptr(self):
        return self.ptr

    def dim(self):
        return 4

    def is_contiguous(self):
        return True


@pytest.fixture
def no_reference(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    for name in ("flash_attention_reference", "flash_bwd_dq_reference",
                 "flash_bwd_dkv_reference"):
        monkeypatch.setattr(fa, name, refuse)


def test_cuda_tensor_without_kernel_library_raises(monkeypatch, tmp_path,
                                                   no_reference):
    # no library on disk and no nvcc to build one
    monkeypatch.setattr(_ext, "LIBRARY", tmp_path / "absent.so")
    monkeypatch.setattr(_ext, "_LIB", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    launches = fa.flash_attention.launches
    t = _ClaimsCuda()
    with pytest.raises(MXNetError, match="nvcc not found"):
        fa.flash_attention(t, t, t)
    assert fa.flash_attention.launches == launches


@pytest.mark.parametrize("which", [0, 1, 2], ids=["q", "k", "v"])
def test_misaligned_input_is_refused_before_any_launch(monkeypatch,
                                                       no_reference, which):
    # a contiguous view 4 bytes past an allocation's start: the forward's
    # 16-byte copies would fault the card's context on it
    def no_load():
        raise AssertionError("kernel library loaded for a misaligned input")

    monkeypatch.setattr(_ext, "load", no_load)
    qkv = [_ClaimsCuda() for _ in range(3)]
    qkv[which].ptr = 256 + 4
    launches = fa.flash_attention.launches
    with pytest.raises(MXNetError, match="16-byte boundary"):
        fa.flash_attention(*qkv)
    assert fa.flash_attention.launches == launches


_DTYPE_OF_CODE = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}


def _host_view(ptr, shape, dtype):
    """The memory at a data pointer as a writable tensor (CPU memory)."""
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).reshape(shape)


class _HostKernels:
    """Stands in for the kernel library: each entry point reads its inputs
    through the pointers it is given (CPU memory here), runs the plain
    version at the head dim it was launched with, writes its outputs and
    records the launch."""

    def __init__(self):
        self.calls = []
        self.rows = []   # the forward tile's query rows of each launch

    def _in(self, ptrs, bh, Tq, Tk, D, code, tk_rows):
        dt = _DTYPE_OF_CODE[code]
        return [_host_view(p, (1, bh, Tk if k else Tq, D), dt)
                for p, k in zip(ptrs, tk_rows)]

    def mx_flash_fwd(self, q, k, v, o, lse, bh, Tq, Tk, D, scale, causal,
                     code, rows, *rest):
        self.calls.append(("fwd", D, code))
        self.rows.append(rows)
        q, k, v, o = self._in((q, k, v, o), bh, Tq, Tk, D, code,
                              (0, 1, 1, 0))
        out, l = fa.flash_attention_reference(q, k, v, causal, scale.value)
        o.copy_(out)
        _host_view(lse, (1, bh, Tq), torch.float32).copy_(l)
        return 0

    def _bwd(self, name, ptrs, outs, bh, Tq, Tk, D, scale, causal, code):
        self.calls.append((name, D, code))
        q, k, v, do = self._in(ptrs[:4], bh, Tq, Tk, D, code, (0, 1, 1, 0))
        lse, delta = (_host_view(p, (1, bh, Tq), torch.float32)
                      for p in ptrs[4:])
        ref = getattr(fa, name + "_reference")(q, k, v, do, lse, delta,
                                               causal, scale.value)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for dst, r, k_rows in zip(outs, ref, (name == "flash_bwd_dkv",) * 2):
            self._in((dst,), bh, Tq, Tk, D, code, (k_rows,))[0].copy_(r)
        return 0

    def mx_flash_bwd_dq(self, q, k, v, do, lse, delta, dq, bh, Tq, Tk, D,
                        scale, causal, code, *rest):
        return self._bwd("flash_bwd_dq", (q, k, v, do, lse, delta), (dq,),
                         bh, Tq, Tk, D, scale, causal, code)

    def mx_flash_bwd_dkv(self, q, k, v, do, lse, delta, dk, dv, bh, Tq, Tk,
                         D, scale, causal, code, *rest):
        return self._bwd("flash_bwd_dkv", (q, k, v, do, lse, delta),
                         (dk, dv), bh, Tq, Tk, D, scale, causal, code)


@pytest.mark.parametrize("dtype,D", [("float16", 32), ("float32", 36),
                                     ("float16", 36), ("bfloat16", 100)])
def test_fp16_and_ragged_head_dim_reach_the_kernel(monkeypatch, dtype, D):
    """What ``impl='auto'`` sends to the kernels beyond f32/bf16 at D % 8
    == 0 (float16, or a D that is no multiple of 8, as the JAX package's
    ``use_flash`` admits) launches them and gives the result: the wrapper
    zero-pads D to the next multiple of 8, passes dtype code 2 for float16,
    and slices the outputs back.  The kernel library is stood in for by
    the plain versions on host memory (``_HostKernels``), with the CUDA-only
    checks and the stream lookup lifted; the result must match the dense
    attention within 1e-5 (f32) or 2e-3 / 2e-2 (fp16 / bf16 rounding of
    values below 1, plus the input's own rounding)."""
    lib = _HostKernels()
    monkeypatch.setattr(_ext, "load", lambda: lib)
    monkeypatch.setattr(fa, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(fa, "_check_device", lambda name, ts: None)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    dt = getattr(torch, dtype)
    rs = np.random.RandomState(D)
    Bn, T, Hn = 1, 256, 2
    q, k, v, do = (torch.from_numpy(rs.randn(Bn, T, Hn * D)
                                    .astype(np.float32)).to(dt)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops_nn.multi_head_attention(*leaves, num_heads=Hn, impl="auto")
    out.backward(do)
    code = {"float32": 0, "bfloat16": 1, "float16": 2}[dtype]
    padded = D + (-D % 8)
    assert lib.calls == [("fwd", padded, code), ("flash_bwd_dq", padded, code),
                         ("flash_bwd_dkv", padded, code)]
    dense = [t.clone().float().requires_grad_() for t in (q, k, v)]
    want = ops_nn.multi_head_attention(*dense, num_heads=Hn, impl="dense")
    want.backward(do.float())
    tol = {"float32": 1e-5, "float16": 2e-3, "bfloat16": 2e-2}[dtype]
    assert out.dtype == dt and out.shape == want.shape
    for got, ref in zip([out] + [t.grad for t in leaves],
                        [want] + [t.grad for t in dense]):
        torch.testing.assert_close(got.float(), ref.detach(), rtol=0,
                                   atol=tol * max(1.0, ref.abs().max().item()))


def test_uncompiled_tiles_are_refused_on_the_card(monkeypatch):
    """The forward's tile is a compiled choice: each compiled pair reaches
    the launch as its row count; an explicit pair that was not compiled
    raises before anything is launched (nothing is rounded, nothing falls
    back), as does another row count under dropout, which runs the
    default tile alone."""
    lib = _HostKernels()
    monkeypatch.setattr(_ext, "load", lambda: lib)
    monkeypatch.setattr(fa, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(fa, "_check_device", lambda name, ts: None)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    q = torch.randn(1, 2, 64, 64)
    for bq, bk in fa.compiled_tiles("float32", 64):
        fa.flash_attention(q, q, q, block_q=bq, block_k=bk)
    fa.flash_attention(q, q, q, block_q=64)    # block_k: the default's 64
    assert lib.rows == [128, 64, 64]
    launches = fa.flash_attention.launches
    for bq, bk in ((512, 512), (128, 32), (96, 64), (256, 64)):
        with pytest.raises(MXNetError, match="not compiled"):
            fa.flash_attention(q, q, q, block_q=bq, block_k=bk)
    with pytest.raises(MXNetError, match="not compiled"):
        fa.flash_attention(q, q, q, block_q=64, block_k=64, dropout_p=0.1,
                           seed=1)
    with pytest.raises(MXNetError, match="not compiled"):
        fa.flash_attention_lse(q, q, q, block_q=32)
    assert fa.flash_attention.launches == launches and len(lib.rows) == 3


@pytest.mark.parametrize("bq,bk", [(None, None), (64, 64), (128, 64),
                                   (512, 512), (7, 3)])
def test_cpu_ignores_the_tiles(bq, bk):
    """On the CPU the plain version runs whatever the pair: it is exact
    whatever the tiling."""
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(2, 3, 96, 40).astype(np.float32))
               for _ in range(3))
    for causal in (False, True):
        want, want_lse = fa.flash_attention_reference(q, k, v, causal)
        out = fa.flash_attention(q, k, v, causal, block_q=bq, block_k=bk)
        out2, lse = fa.flash_attention_lse(q, k, v, causal, block_q=bq,
                                           block_k=bk)
        assert (out - want).abs().max().item() == 0
        assert (out2 - want).abs().max().item() == 0
        assert (lse - want_lse).abs().max().item() == 0


@pytest.mark.parametrize("which", [0, 1, 2, 3], ids=["q", "k", "v", "dO"])
@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_misaligned_backward_input_is_refused_before_any_launch(
        monkeypatch, no_reference, kernel, which):
    # the backward kernels copy q, k, v and dO rows in 16-byte chunks too
    def no_load():
        raise AssertionError("kernel library loaded for a misaligned input")

    monkeypatch.setattr(_ext, "load", no_load)
    ts = [_ClaimsCuda() for _ in range(4)]
    ts[which].ptr = 256 + 4
    rows = _ClaimsCuda()
    rows.shape = (1, 2, 64)
    fn = getattr(fa, kernel)
    launches = fn.launches
    with pytest.raises(MXNetError, match="16-byte boundary"):
        fn(*ts, rows, rows)
    assert fn.launches == launches


@pytest.mark.parametrize("fault", ["meta", "mixed", "dropout"])
def test_non_cpu_tensor_never_takes_the_plain_version(no_reference, fault):
    q = torch.zeros(1, 2, 64, 32, device="meta")
    k = torch.zeros(1, 2, 64, 32, device="cpu" if fault == "mixed"
                    else "meta")
    with pytest.raises(MXNetError):
        fa.flash_attention(q, k, q, dropout_p=0.1 if fault == "dropout"
                           else 0.0, seed=3)


@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_backward_kernels_never_take_the_plain_version(no_reference,
                                                       kernel):
    q = torch.zeros(1, 2, 64, 32, device="meta")
    rows = torch.zeros(1, 2, 64, device="meta")
    with pytest.raises(MXNetError):
        getattr(fa, kernel)(q, q, q, q, rows, rows, dropout_p=0.1, seed=3)


def test_cuda_backward_without_kernel_library_raises(monkeypatch, tmp_path,
                                                    no_reference):
    monkeypatch.setattr(_ext, "LIBRARY", tmp_path / "absent.so")
    monkeypatch.setattr(_ext, "_LIB", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    rows = _ClaimsCuda()
    rows.shape = (1, 2, 64)
    t = _ClaimsCuda()
    launches = fa.flash_bwd_dq.launches
    with pytest.raises(MXNetError, match="nvcc not found"):
        fa.flash_bwd_dq(t, t, t, t, rows, rows)
    assert fa.flash_bwd_dq.launches == launches


def test_initialize_without_ctx_wants_the_card(monkeypatch):
    _no_card(monkeypatch)
    blk = nn.Dense(4, flatten=False, in_units=16)
    with pytest.raises(MXNetError, match=r"ctx=mx\.cpu\(\)"):
        blk.initialize()
    blk.initialize(ctx=mx.cpu())
    assert all(p.device.type == "cpu" and p.requires_grad
               for p in blk.collect_params().values())


def test_cpu_ctx_serves():
    blk = nn.Dense(4, flatten=False, in_units=16)
    cfg = serve.ServeConfig(sample_shapes=[(8, 16)], batch_sizes=(1,),
                            max_batch_size=1)
    with serve.Server(blk, ctx=mx.cpu(), config=cfg) as srv:
        out = srv.submit(np.ones((3, 16), np.float32), request_id="r-cpu")
    assert out.shape == (3, 4) and srv.runner.device.type == "cpu"
    spans = {e["name"] for e in trace.events() if e["trace"] == "r-cpu"}
    assert {"serve_enqueue", "serve_queue_wait", "serve_dispatch",
            "serve_pad", "serve_execute", "serve_unpad",
            "serve_request"} <= spans


def test_ext_bind_declares_every_entry_point():
    class Lib:  # stands in for a loaded ctypes library
        pass

    lib = Lib()
    for name in ("mx_flash_fwd", "mx_flash_bwd_dq", "mx_flash_bwd_dkv"):
        setattr(lib, name, type(name, (), {})())
    _ext.bind(lib)
    # the forward also takes its tile's query rows
    assert [len(getattr(lib, n).argtypes) for n in
            ("mx_flash_fwd", "mx_flash_bwd_dq", "mx_flash_bwd_dkv")] \
        == [19, 20, 21]


def test_ptxas_report_reads_registers_and_spills():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    log = ("ptxas info    : Compiling entry function '_Z6kernelPf' for "
           "'sm_90a'\n"
           "ptxas info    : Function properties for _Z6kernelPf\n"
           "    8 bytes stack frame, 24 bytes spill stores, 16 bytes spill "
           "loads\n"
           "ptxas info    : Used 128 registers, 528 bytes cmem[0]\n")
    (entry,) = chip_smoke.ptxas_report(log)
    assert (entry["registers"], entry["spill_stores"], entry["spill_loads"],
            entry["stack"]) == (128, 24, 16, 8)
    assert "kernel" in entry["function"]


@pytest.mark.parametrize("make", [
    lambda: nn.Conv2D(4, 3, in_channels=3),
    lambda: nn.Conv2D(4, 3),                   # deferred input channels
    lambda: nn.BatchNorm(),
    lambda: mx.gluon.model_zoo.vision.resnet18_v1(classes=10),
], ids=["conv2d", "conv2d_deferred", "batchnorm", "resnet18_v1"])
def test_vision_blocks_without_ctx_want_the_card(monkeypatch, make):
    _no_card(monkeypatch)
    blk = make()
    with pytest.raises(MXNetError, match=r"ctx=mx\.cpu\(\)"):
        blk.initialize()
    blk.initialize(ctx=mx.cpu())
    assert all(p.device.type == "cpu"
               for p in blk.collect_params().values())


_CHIP_SMOKE_PROBE = """
import json, sys
sys.path.insert(0, %r)
import chip_smoke
import mxnet_tpu_torch.step.capture, mxnet_tpu_torch.monitor.core
import mxnet_tpu_torch.optimizer.multi_tensor, mxnet_tpu_torch.kvstore.collective
tables = chip_smoke._np_cases()     # np_front's case tables, as the card loads them
assert tables.CASES and tables.KEYWORDS and tables.REFERENCE_NP_SURFACE
assert chip_smoke._parity_cases().CASES    # and nd_tail's
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu", "pytest"))
print(json.dumps({"bad": bad, "phases": sorted(
    n for n in dir(chip_smoke) if n.startswith("phase_"))}))
"""


def test_chip_smoke_and_step_modules_pull_in_no_jax():
    """``chip_smoke.py``, the case tables its ``np_front`` and ``nd_tail``
    phases load and the modules of whole-step capture (the grouped apply, the
    monitor, the bucket planner) import neither JAX, the JAX package nor
    pytest; the script has its captured phases."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _CHIP_SMOKE_PROBE
                          % str(ROOT)], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert {"phase_train_captured", "phase_train_captured_resnet",
            "phase_train_lstm", "phase_train_gpt_lm", "phase_rnn_parts",
            "phase_train_vision", "phase_vision_zoo",
            "phase_train_amp_fp16",
            "phase_checkpoint_resume", "phase_nd_tail"} <= set(res["phases"])


@pytest.mark.parametrize("kind", ["int", "tensor"])
def test_dropout_seed_reaches_the_kernels_by_address(monkeypatch, kind):
    """The kernels read the dropout seed from memory: the wrappers hand
    the C entry points the address of a one-element int64 holding it --
    the caller's own tensor where the seed is one (no copy, no host read),
    else a copy of the int -- and the forward and backward read the same
    seed."""
    seen = []

    def note(flag, addr):   # read while the launch's memory is alive
        seen.append((flag, addr,
                     _host_view(addr, (1,), torch.int64).item()))

    class Lib(_HostKernels):
        def mx_flash_fwd(self, *args):
            note(*args[13:15])        # after the tile's rows
            return super().mx_flash_fwd(*args)

        def mx_flash_bwd_dq(self, *args):
            note(*args[14:16])
            return super().mx_flash_bwd_dq(*args)

        def mx_flash_bwd_dkv(self, *args):
            note(*args[15:17])
            return super().mx_flash_bwd_dkv(*args)

    monkeypatch.setattr(_ext, "load", lambda: Lib())
    monkeypatch.setattr(fa, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(fa, "_check_device", lambda name, ts: None)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    value = 2 ** 63 + 12345          # the top bit set: a negative int64
    seed = value if kind == "int" else fa._seed_tensor(value,
                                                       torch.device("cpu"))
    q, k, v = (torch.randn(1, 2, 64, 32).requires_grad_() for _ in range(3))
    fa.flash_attention(q, k, v, dropout_p=0.1, seed=seed).sum().backward()
    assert [flag for flag, _, _ in seen] == [1, 1, 1]
    for _, addr, got in seen:
        assert got & (2 ** 64 - 1) == value
        if kind == "tensor":
            assert addr == seed.data_ptr()


# JAX modules whose names a later slice ports: {module: ROADMAP item}
# (none is left: the second slice of Queue 1 item 6 ported the last ones)
DEFERRED = {}
# names of the JAX namespaces that are no API of the port:
# {namespace.name: why}
NOT_API = {
    "nd.pickle": "the stdlib module, imported by the JAX ndarray package",
    "nd.from_jax": "JAX interop; the port's is nd.from_torch",
    "np.apply_op": "the registry helper the JAX numpy module imports",
}


def _deferred_names():
    """{JAX registry name: defining module} for the deferred modules'
    ops.  ``mxnet_tpu/ops/__init__.py`` imports ``parity`` last, after
    ``image_ops``, whose last registration is ``SpatialTransformer``: the
    registry's later names are parity's (its aliases of other modules'
    functions included)."""
    import mxnet_tpu as mj
    from mxnet_tpu.ops import registry as jreg

    names = list(jreg._OP_REGISTRY)
    out = {n: "mxnet_tpu.ops.parity"
           for n in names[names.index("SpatialTransformer") + 1:]}
    for n in names:
        if jreg.get_op(n).fn.__module__ == "mxnet_tpu.ops.detection":
            out[n] = "mxnet_tpu.ops.detection"
    out["sparse"] = mj.nd.sparse.__name__
    out["dgl"] = mj.nd.dgl.__name__
    return out


def test_jax_front_door_names_are_ported_or_deferred():
    """The name guard of ``mx.nd``, ``mx.np`` and ``mx.npx``."""
    import mxnet_tpu as mj

    deferred = _deferred_names()
    seen_not_api, bad = set(), []
    for ns in ("nd", "np", "npx"):
        jmod, tmod = getattr(mj, ns), getattr(mx, ns)
        names = (dir(jmod) if ns != "np" else list(jmod.__dict__))
        for n in names:
            if n.startswith("_") or n == "annotations" or hasattr(tmod, n):
                continue
            key = "%s.%s" % (ns, n)
            if key in NOT_API:
                seen_not_api.add(key)
            elif deferred.get(n) not in DEFERRED:
                bad.append(key)
    assert bad == []
    assert seen_not_api == set(NOT_API)
    # every listed module still has a name the port lacks
    left = {deferred[n] for n in dir(mj.nd)
            if n in deferred and not hasattr(mx.nd, n)}
    assert left == set()


# JAX arguments the port lacks on purpose: {"module.name": (arguments,
# where it is written down)}
SPELLINGS = {
    ".serve.server.Server": (["tenant"], "ROADMAP.md Queue 1 item 9"),
    ".monitor.stats.group_stats": (["g_arrs", "w_arrs"],
                                   "ROADMAP.md Queue 1 item 8"),
    # dropout draws from the port's generators, not threefry keys
    # (random.py; ROADMAP.md Rules, "RNG")
    ".ops.nn.dropout": (["key", "mode"], "ROADMAP.md Rules, RNG"),
    ".ops.nn.multi_head_attention": (["dropout_key"],
                                     "ROADMAP.md Rules, RNG"),
    ".ndarray.multi_head_attention": (["dropout_key"],
                                      "ROADMAP.md Rules, RNG"),
    # the flash kernels take the port's ``seed`` for the threefry key, and
    # their plain version on the CPU stands for Pallas' interpret mode
    ".ops.flash_attention.flash_attention": (["dropout_key", "interpret"],
                                             "ROADMAP.md Rules, RNG"),
    ".ops.flash_attention.flash_attention_lse": (["interpret"],
                                                 "ROADMAP.md Rules, RNG"),
    ".ops.flash_attention.blockwise_attention": (["dropout_key"],
                                                 "ROADMAP.md Rules, RNG"),
}


def _params(obj):
    obj = getattr(obj, "fn", obj)       # a registry Operator: its function
    try:
        return inspect.signature(obj).parameters
    except (TypeError, ValueError):
        return None


def _lacks(jax_obj, port_obj):
    """The JAX arguments ``port_obj`` does not take (a ``**kwargs`` takes
    any keyword; ``*args`` needs one of its own)."""
    jp, tp = _params(jax_obj), _params(port_obj)
    if jp is None or tp is None:
        return []
    kinds = {p.kind for p in tp.values()}
    out = []
    for name, p in jp.items():
        if p.kind == p.VAR_POSITIONAL:
            if p.VAR_POSITIONAL not in kinds:
                out.append("*" + name)
        elif p.kind != p.VAR_KEYWORD and name not in tp \
                and p.VAR_KEYWORD not in kinds:
            out.append(name)
    return sorted(out)


# port modules whose JAX counterpart has another name
_PAIRED = {".ops.flash_attention": ".ops.pallas_attention"}


def _shared_callables():
    """(dotted name, JAX object, port object) for every public callable
    of a port module that its JAX counterpart also has."""
    import torch.nn as tnn

    module_methods = set(dir(tnn.Module))
    mods = ["mxnet_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
        mx.__path__, "mxnet_tpu_torch.")]
    for mod in mods:
        rel = mod[len("mxnet_tpu_torch"):]
        try:
            jmod = importlib.import_module(
                "mxnet_tpu" + _PAIRED.get(rel, rel))
        except ImportError:
            continue
        tmod = importlib.import_module(mod)
        for name in dir(tmod):
            tobj, jobj = getattr(tmod, name), getattr(jmod, name, None)
            if name.startswith("_") or jobj is None or inspect.ismodule(
                    tobj) or not (callable(tobj) and callable(jobj)):
                continue
            if getattr(tobj, "__module__", mod) != mod \
                    and not mod.endswith("ndarray"):
                continue                  # checked where it is defined
            yield "%s.%s" % (rel, name), jobj, tobj
            if not (inspect.isclass(tobj) and inspect.isclass(jobj)):
                continue
            for meth in dir(tobj):
                tm, jm = getattr(tobj, meth, None), getattr(jobj, meth, None)
                if meth.startswith("_") or jm is None or not callable(tm) \
                        or not callable(jm):
                    continue
                if meth in module_methods and not meth.startswith(
                        ("initialize", "collect_params", "cast",
                         "zero_grad", "register_child", "hybridize",
                         "register_forward", "apply")):
                    continue              # nn.Module's own, not Gluon's
                yield "%s.%s.%s" % (rel, name, meth), jm, tm


def test_shared_callables_take_the_jax_arguments():
    """The signature guard: a JAX argument the port lacks fails, unless it
    is a documented spelling (``SPELLINGS``); a listed spelling the port
    has since taken up fails too, so the list stays true."""
    seen, bad = set(), []
    for name, jobj, tobj in _shared_callables():
        lacks = _lacks(jobj, tobj)
        allowed = SPELLINGS.get(name, ([], None))[0]
        if lacks:
            seen.add(name)
        if sorted(lacks) != sorted(allowed) and lacks:
            bad.append((name, lacks))
    assert bad == []
    assert sorted(seen) == sorted(SPELLINGS)
    names = {n for n, _, _ in _shared_callables()}
    for must in (".gluon.parameter.Parameter", ".gluon.block.Block.initialize",
                 ".gluon.block.Block.collect_params", ".random.uniform",
                 ".random.categorical", ".io.ImageRecordIter",
                 ".gluon.data.dataloader.DataLoader",
                 ".data.loader.StreamLoader", ".image.imresize",
                 ".contrib.amp.init", ".contrib.amp.LossScaler",
                 ".contrib.amp.lists.classification", ".gluon.nn.moe.MoE",
                 ".gluon.block.Block.share_parameters",
                 ".gluon.block.Block.register_forward_hook",
                 ".gluon.parameter.Parameter.reset_ctx",
                 ".gluon.nn.basic_layers.GroupNorm",
                 ".gluon.model_zoo.vision.vgg.get_vgg",
                 ".gluon.model_zoo.vision.inception.inception_v3",
                 ".optimizer.multi_tensor.register_fusable",
                 ".checkpoint.manager.CheckpointManager",
                 ".gluon.block.Block.save_parameters",
                 ".gluon.trainer.Trainer.save_checkpoint",
                 ".parallel.FusedTrainer.save_checkpoint",
                 ".serve.server.Server.swap",
                 ".serve.server.Server.submit_decode",
                 ".serve.server.Server.start_http",
                 ".serve.decode.DecodeRunner", ".serve.decode.TinyDecoder",
                 ".serve.decode.DecodeScheduler.submit",
                 ".serve.kvcache.PagePool", ".serve.cache.PrefixCache",
                 ".serve.spec.SpecPlane", ".telemetry.totals",
                 ".resilience.inject.poisoned",
                 ".ops.flash_attention.flash_attention",
                 ".ops.flash_attention.flash_attention_lse",
                 ".ops.flash_attention.blockwise_attention",
                 ".profiler.set_state", ".autotune.lookup",
                 ".trace.watchdog.install", ".monitor.divergence.observe_loss"):
        assert must in names, must


def _positional(obj):
    params = _params(obj)
    if params is None:
        return None
    return [n for n, p in params.items()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def test_shared_callables_take_positional_arguments_in_the_jax_order():
    """The order guard: a positional parameter both packages take sits at
    the JAX package's position, so a positional call binds alike in both;
    for a callable with listed spellings (``SPELLINGS``), the shared
    positional parameters but the listed ones keep the JAX relative
    order."""
    bad = []
    for name, jobj, tobj in _shared_callables():
        jpos, tpos = _positional(jobj), _positional(tobj)
        if jpos is None or tpos is None:
            continue
        shared = [n for n in jpos if n in tpos]
        if name in SPELLINGS:
            excused = set(SPELLINGS[name][0])
            shared = [n for n in shared if n not in excused]
            ok = [n for n in tpos if n in shared] == shared
        else:
            ok = all(jpos.index(n) == tpos.index(n) for n in shared)
        if not ok:
            bad.append((name, jpos, tpos))
    assert bad == []


def test_launch_counts_survive_concurrent_launches(monkeypatch):
    """A server's scheduler and a hot swap's warm-up launch at once: the
    launch counters take a lock, so no increment is lost (eight threads,
    a switch interval of a microsecond)."""
    import threading

    class Lib(_HostKernels):
        def mx_flash_fwd(self, *args):
            return 0                       # the count is what is checked

    monkeypatch.setattr(_ext, "load", lambda: Lib())
    monkeypatch.setattr(fa, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(fa, "_check_device", lambda name, ts: None)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    q = torch.randn(1, 1, 16, 8)
    before, n, calls = fa.flash_attention.launches, 8, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            fa.flash_attention(q, q, q) for _ in range(calls)])
            for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert fa.flash_attention.launches - before == n * calls
