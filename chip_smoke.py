#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``mxnet_tpu_torch``).

    python3 chip_smoke.py [--seed N]

Needs one CUDA card (NVIDIA H100), ``nvcc`` and numpy; never imports JAX
or ``mxnet_tpu``.  Phases, each printed as one JSON line:

1. device  -- card name and count, and ``nvidia-smi`` name + power limit.
2. build   -- nvcc time for ``mxnet_tpu_torch/csrc/*.cu`` (sm_90a, one
   nvcc per source, in parallel) and every kernel instance's registers,
   stack and spills from ``-Xptxas -v``.
3. kernels -- the three flash-attention kernels against their plain
   PyTorch versions on the card, over shapes x {f32, bf16} x {causal, not}
   x dropout p in {0, 0.1}: the forward (O, LSE) and the backward (dq, dk,
   dv against ``flash_attention_backward_reference``, within
   1e-4*max(1, max|ref|) in f32 and 2e-2*max(1, max|ref|) in bf16), each
   with its device time (a ``torch.cuda._sleep`` ahead of the window keeps
   the host's enqueue out of it; the forward also prints its host time a
   call), the plain version's, PyTorch's ``F.scaled_dot_product_attention``
   under the fastest backend that accepts the case (``library_backend``; a
   yardstick only, the port never calls it; for the backward its fwd+bwd
   minus its fwd) and the card's bound (f32 cases also give the bound on
   the TF32 tensor cores with the three products of 3xTF32 the kernels do:
   ``bound_3xtf32_ms`` for the forward, ``dq_bound_3xtf32_ms`` and
   ``dkv_bound_3xtf32_ms`` for the backward).  A contiguous view off a
   16-byte boundary is refused by the three kernels' wrappers and C entry
   points.
4. serve   -- full-width BERT-base (12 x 768, 12 heads, vocab 30522,
   max_length 512) in f32 with random weights from ``--seed``, served
   through ``serve.Server(...).submit()`` on the card: 32 concurrent
   requests of 64..512 tokens.  Every output is finite and shaped; the
   forward kernel's launch count is exactly 12 x the batches dispatched;
   two requests match the same model run on the CPU.
5. train   -- full-width BERT-base pretraining (``BERTForPretraining``,
   dropout 0.1 on hidden states and attention) with Adam at lr 1e-4, fp32
   with TF32 off: 10 steps of ``autograd.record()``, ``backward()`` and
   ``trainer.step(1)`` on one synthetic batch (B=8, T=512, 76 masked
   positions).  Every loss is finite and the last is below the first; the
   forward, dq and dk/dv kernels each launch exactly 12 x 10 times; one
   step's parameter gradients at B=1 with dropout off match the same model
   on the CPU within 1e-3*max(1, max|g|).

Then the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the script exits non-zero and prints no result line.  Without a card,
or without the package beside it, it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM published peaks (dense), the rates ``bound_ms`` divides by
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,     # fp32 outside the tensor cores
              "bfloat16": 989e12}   # bf16 tensor cores
TF32_FLOPS = 495e12                 # TF32 tensor cores (3xTF32: 3 products)
SLEEP_CYCLES_PER_S = 2.0e9  # above the H100's 1.98 GHz boost clock, so a
                            # ``torch.cuda._sleep`` lasts at least as asked
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")
TOL_O = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_LSE = 1e-3
TOL_SERVE = 1e-3
TOL_GRAD = 1e-3      # card vs CPU parameter gradients, x max(1, max|g|)
DROPOUT_P = 0.1
SEED_DROP = 0x5EED_0F_D120   # the kernel phase's dropout seed
KERNELS = {  # name: (source, the Pallas kernel it replaces)
    "flash_fwd": ("mxnet_tpu_torch/csrc/flash_fwd.cu",
                  "mxnet_tpu/ops/pallas_attention.py:203"),
    "flash_bwd_dq": ("mxnet_tpu_torch/csrc/flash_bwd.cu",
                     "mxnet_tpu/ops/pallas_attention.py:256"),
    "flash_bwd_dkv": ("mxnet_tpu_torch/csrc/flash_bwd.cu",
                      "mxnet_tpu/ops/pallas_attention.py:301"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit("chip_smoke: FAILED: " + msg)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_time(fn, iters):
    """(device ms, host ms, covered) per call of ``fn`` over ``iters`` calls.

    A ``torch.cuda._sleep`` enqueued ahead of the timed window holds the
    card while the host enqueues every call, so the CUDA events time the
    launches back to back and not the host's Python work between them
    (shape checks, allocation, the ctypes call).  ``covered`` says the
    sleep outlasted the host's enqueue; the sleep is lengthened and the
    window retaken once if it did not."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    sleep_ms = 2.0 + 1.5e3 * (time.perf_counter() - t0) * iters
    torch.cuda.synchronize()
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(int(sleep_ms * 1e-3 * SLEEP_CYCLES_PER_S))
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        covered = host_ms < ev[0].elapsed_time(ev[1])
        if covered:
            break
        sleep_ms = 2.0 * host_ms + 2.0
    return ev[1].elapsed_time(ev[2]) / iters, host_ms / iters, covered


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    return cuda_time(fn, iters)[0]


def sdpa_fastest(torch, fn, iters, minus=None):
    """``fn`` (a call of PyTorch's SDPA) under each backend that accepts
    the case -> (name, ms) of the fastest, and the names of the backends
    that refused it (inside ``sdpa_kernel([backend])`` a backend that does
    not take the inputs raises RuntimeError at the call).  With ``minus``,
    each backend's time of ``minus`` is taken off its time of ``fn``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    best, refused = None, []
    for name in SDPA_BACKENDS:
        with sdpa_kernel([getattr(SDPBackend, name)]):
            try:
                fn()
            except RuntimeError:
                refused.append(name.lower())
                continue
            ms = cuda_ms(fn, iters)
            if minus is not None:
                ms -= cuda_ms(minus, iters)
        if best is None or ms < best[1]:
            best = (name.lower(), ms)
    if best is None:
        fail("no SDPA backend accepted the case")
    return best[0], best[1], refused


def ptxas_report(log):
    """Registers, stack and spills of every kernel instance from nvcc's
    ``-Xptxas -v`` output, names demangled with ``cu++filt`` or
    ``c++filt`` where the machine has one."""
    import re
    import shutil

    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out.append({"function": name})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and out:
            out[-1].update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    cand = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                        "bin", "cu++filt")
    filt = cand if os.path.exists(cand) else shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(
            e["function"] for e in out), capture_output=True, text=True,
            check=True, timeout=60).stdout.splitlines()
        for e, n in zip(out, names):   # "void ns::kernel<...>(args)"
            m = re.search(r"(\w+<[^()]*>|\w+)\(", n)
            e["function"] = m.group(1) if m else n
    return out


def _pairs(Tq, Tk, causal):
    """(query, key) pairs a query may see (top-left causal mask)."""
    return sum(min(i + 1, Tk) for i in range(Tq)) if causal else Tq * Tk


def _bound(nbytes, ops, dtype):
    """(ms, "bytes"|"operations"): the larger of bytes over the memory
    rate and operations over the dtype's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(B, H, Tq, Tk, D, dtype, causal):
    """Forward: Q/K/V read once, O and LSE written once; 4*D operations
    per (query, visible key) pair."""
    itemsize = 4 if dtype == "float32" else 2
    nbytes = B * H * (2 * Tq * D + 2 * Tk * D) * itemsize + B * H * Tq * 4
    return _bound(nbytes, 4.0 * B * H * D * _pairs(Tq, Tk, causal), dtype)


def _bound_3xtf32(nbytes, ops):
    """An fp32 function's bound on the TF32 tensor cores with the 3xTF32
    split the kernels use: the same bytes, three times the products at
    495 TFLOP/s."""
    return max(nbytes / HBM_BYTES_PER_S * 1e3, 3 * ops / TF32_FLOPS * 1e3)


def attention_bound_3xtf32(B, H, Tq, Tk, D, causal):
    """The fp32 forward's bound at 3xTF32 (bytes as ``attention_bound``)."""
    nbytes = B * H * (2 * Tq * D + 2 * Tk * D) * 4 + B * H * Tq * 4
    return _bound_3xtf32(nbytes, 4.0 * B * H * D * _pairs(Tq, Tk, causal))


def _backward_work(B, H, Tq, Tk, D, dtype, causal):
    """{"bwd", "dq", "dkv"}: (bytes, operations).  The whole backward
    reads Q, K, V, O, dO, LSE and delta once and writes dQ, dK, dV once,
    and does 10*D operations per visible pair (recomputing S, then dP, dV,
    dK, dQ).  The dq function alone reads Q, K, V, dO, LSE, delta and
    writes dQ (6*D: S, dP, dQ); the dk/dv function writes dK, dV (8*D: S,
    dP, dV, dK)."""
    itemsize = 4 if dtype == "float32" else 2
    bh, pairs, rows = B * H, _pairs(Tq, Tk, causal), 2 * B * H * Tq * 4
    tq, tk = Tq * D * itemsize, Tk * D * itemsize
    return {"bwd": (bh * (4 * tq + 4 * tk) + rows, 10.0 * bh * D * pairs),
            "dq": (bh * (3 * tq + 2 * tk) + rows, 6.0 * bh * D * pairs),
            "dkv": (bh * (2 * tq + 4 * tk) + rows, 8.0 * bh * D * pairs)}


def backward_bounds(B, H, Tq, Tk, D, dtype, causal):
    """{"bwd", "dq", "dkv"}: (ms, by) of ``_backward_work``."""
    return {name: _bound(nbytes, ops, dtype) for name, (nbytes, ops)
            in _backward_work(B, H, Tq, Tk, D, dtype, causal).items()}


def backward_bounds_3xtf32(B, H, Tq, Tk, D, causal):
    """{"dq", "dkv"}: the fp32 backward kernels' bounds at 3xTF32."""
    work = _backward_work(B, H, Tq, Tk, D, "float32", causal)
    return {name: _bound_3xtf32(*work[name]) for name in ("dq", "dkv")}


def _rel_err(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max().item()
            / max(1.0, ref.abs().max().item()))


def _sdpa_backward(torch, F, q, k, v, do, causal, p, iters):
    """The backward half of PyTorch's SDPA under its fastest backend:
    fwd+bwd through ``torch.autograd.grad`` minus fwd -> (backend, ms,
    refused)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*leaves, dropout_p=p,
                                              is_causal=causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, do)

    return sdpa_fastest(torch, fwd_bwd, iters, minus=fwd)


def phase_kernels(torch, fa, seed):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    # the serving and training shapes, then ragged ones and the head
    # dims that take the other tiles (D=40: 2 columns a lane; D=256: the
    # 32-row tiles of the backward)
    shapes = [(8, 12, 512, 512, 64), (4, 12, 512, 512, 64),
              (2, 12, 512, 512, 64), (1, 12, 512, 512, 64),
              (2, 4, 200, 200, 64), (1, 2, 384, 512, 128),
              (1, 3, 100, 100, 40), (1, 2, 130, 70, 256)]
    fwd_cases, bwd_cases = [], []
    for B, H, Tq, Tk, D in shapes:
        serve_shape = (H, Tq, Tk, D) == (12, 512, 512, 64)
        for dname in ("float32", "bfloat16"):
            for causal in (False, True):
                if serve_shape and B != 8 and (dname != "float32" or causal):
                    continue  # the other serving batches: f32, not causal
                dt = getattr(torch, dname)
                q, k, v = (torch.randn(B, H, T, D, device="cuda",
                                       generator=gen, dtype=dt)
                           for T in (Tq, Tk, Tk))
                do = torch.randn(B, H, Tq, D, device="cuda", generator=gen,
                                 dtype=dt)
                iters = 20 if B * H * Tq * Tk > 1 << 22 else 50
                for p in (0.0, DROPOUT_P):
                    if serve_shape and B != 8 and p:
                        continue
                    fwd_cases.append(_fwd_case(torch, F, fa, q, k, v, causal,
                                               p, dname, iters))
                    bwd_cases.append(_bwd_case(torch, F, fa, q, k, v, do,
                                               causal, p, dname, iters))
    emit({"phase": "kernels", "kernel": "flash_fwd", "cases": fwd_cases})
    emit({"phase": "kernels", "kernel": "flash_bwd_dq+flash_bwd_dkv",
          "cases": bwd_cases})
    _misaligned_refused(torch, fa)
    return fwd_cases, bwd_cases


def _misaligned_refused(torch, fa):
    """A contiguous view 4 bytes past a 16-byte boundary: the forward's,
    the dq and the dk/dv kernels' wrappers and C entry points all refuse
    it, and the card stays usable."""
    from mxnet_tpu_torch.ops import _ext

    bad = torch.zeros(2 * 64 * 64 + 1, device="cuda")[1:].view(1, 2, 64, 64)
    good = torch.zeros(1, 2, 64, 64, device="cuda")
    rows = torch.zeros(1, 2, 64, device="cuda")
    calls = {"flash_attention": lambda: fa.flash_attention(bad, bad, bad),
             "flash_bwd_dq": lambda: fa.flash_bwd_dq(
                 good, good, good, bad, rows, rows),
             "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(
                 bad, good, good, good, rows, rows)}
    for name, call in calls.items():
        try:
            call()
        except fa.MXNetError:
            continue
        fail("%s took a misaligned input" % name)
    lib = _ext.load()
    p = [t.data_ptr() for t in (bad, good, rows)]
    tail = [ctypes.c_float(0.125), 0, 0, *fa._dropout_args(0.0, 0), 0,
            torch.cuda.current_stream().cuda_stream]
    errs = {"mx_flash_fwd": lib.mx_flash_fwd(
                p[0], p[0], p[0], p[1], p[2], 2, 64, 64, 64, *tail),
            "mx_flash_bwd_dq": lib.mx_flash_bwd_dq(
                p[1], p[1], p[1], p[0], p[2], p[2], p[1], 2, 64, 64, 64,
                *tail),
            "mx_flash_bwd_dkv": lib.mx_flash_bwd_dkv(
                p[0], p[1], p[1], p[1], p[2], p[2], p[1], p[1], 2, 64, 64,
                64, *tail)}
    for name, err in errs.items():
        if err == 0:
            fail("%s launched on a misaligned input" % name)
    torch.cuda.synchronize()
    good.add_(1.0)   # the context still runs kernels
    torch.cuda.synchronize()
    emit({"phase": "kernels", "misaligned_input_refused": sorted(calls),
          "entry_point_errors": errs})


def _fwd_case(torch, F, fa, q, k, v, causal, p, dname, iters):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    out, lse = fa.flash_attention(q, k, v, causal, dropout_p=p,
                                  seed=SEED_DROP)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal,
                                                    dropout_p=p,
                                                    seed=SEED_DROP)
    err_o = (out.float() - ref_out.float()).abs().max().item()
    err_l = (lse - ref_lse).abs().max().item()
    ok = err_o <= TOL_O[dname] and err_l <= TOL_LSE
    bound, by = attention_bound(B, H, Tq, Tk, D, dname, causal)
    ms, host_ms, covered = cuda_time(lambda: fa.flash_attention(
        q, k, v, causal, dropout_p=p, seed=SEED_DROP), iters)
    backend, lib_ms, refused = sdpa_fastest(
        torch, lambda: F.scaled_dot_product_attention(
            q, k, v, dropout_p=p, is_causal=causal), iters)
    case = {
        "shape": [B, H, Tq, Tk, D], "dtype": dname, "causal": causal,
        "dropout_p": p, "max_abs_err_o": err_o, "max_abs_err_lse": err_l,
        "tol_o": TOL_O[dname], "tol_lse": TOL_LSE, "ok": ok,
        "ms": ms, "host_ms": host_ms, "sleep_covered": covered,
        "plain_ms": cuda_ms(lambda: fa.flash_attention_reference(
            q, k, v, causal, dropout_p=p, seed=SEED_DROP), iters),
        "library_ms": lib_ms, "library_backend": backend,
        "library_refused": refused,
        "bound_ms": bound, "bound_by": by}
    if dname == "float32":
        case["bound_3xtf32_ms"] = attention_bound_3xtf32(B, H, Tq, Tk, D,
                                                         causal)
    if not ok:
        emit({"phase": "kernels", "failed_case": case})
        fail("flash_fwd disagrees with its plain version at %s"
             % case["shape"])
    return case


def _bwd_case(torch, F, fa, q, k, v, do, causal, p, dname, iters):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    out, lse = fa.flash_attention(q, k, v, causal, dropout_p=p,
                                  seed=SEED_DROP)
    delta = fa._delta(do, out)
    args = (q, k, v, do, lse, delta, causal, None, p, SEED_DROP)

    def kernels():
        fa.flash_bwd_dq(*args)
        fa.flash_bwd_dkv(*args)

    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    ref = fa.flash_attention_backward_reference(q, k, v, out, lse, do,
                                                causal, None, p, SEED_DROP)
    names = ("dq", "dk", "dv")
    errs = {n: _rel_err(g, r) for n, g, r in zip(names, (dq, dk, dv), ref)}
    abs_errs = {n: (g.float() - r.float()).abs().max().item()
                for n, g, r in zip(names, (dq, dk, dv), ref)}
    tol = 1e-4 if dname == "float32" else 2e-2
    ok = all(e <= tol for e in errs.values())
    bounds = backward_bounds(B, H, Tq, Tk, D, dname, causal)
    backend, lib_ms, refused = _sdpa_backward(torch, F, q, k, v, do, causal,
                                              p, iters)
    case = {
        "shape": [B, H, Tq, Tk, D], "dtype": dname, "causal": causal,
        "dropout_p": p, "rel_err": errs, "max_abs_err": abs_errs,
        "tol": tol, "ok": ok,
        "ms": cuda_ms(lambda: (fa._delta(do, out), kernels()), iters),
        "dq_ms": cuda_ms(lambda: fa.flash_bwd_dq(*args), iters),
        "dkv_ms": cuda_ms(lambda: fa.flash_bwd_dkv(*args), iters),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_backward_reference(
            q, k, v, out, lse, do, causal, None, p, SEED_DROP), iters),
        "plain_dq_ms": cuda_ms(lambda: fa.flash_bwd_dq_reference(*args),
                               iters),
        "plain_dkv_ms": cuda_ms(lambda: fa.flash_bwd_dkv_reference(*args),
                                iters),
        "library_ms": lib_ms, "library_backend": backend,
        "library_refused": refused,
        "bound_ms": bounds["bwd"][0], "bound_by": bounds["bwd"][1],
        "dq_bound_ms": bounds["dq"][0], "dq_bound_by": bounds["dq"][1],
        "dkv_bound_ms": bounds["dkv"][0], "dkv_bound_by": bounds["dkv"][1]}
    if dname == "float32":
        for name, ms in backward_bounds_3xtf32(B, H, Tq, Tk, D,
                                               causal).items():
            case[name + "_bound_3xtf32_ms"] = ms
    if not ok:
        emit({"phase": "kernels", "failed_case": case})
        fail("flash backward disagrees with its plain version at %s"
             % case["shape"])
    return case


def bert_params(block, seed):
    """BERT init from numpy: normal(0, 0.02) weights and embeddings,
    zero biases, LayerNorm gamma 1 and beta 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in block.collect_params().items():
        shape = tuple(p.shape)
        if name.endswith(".gamma"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith(".beta") or name.endswith(".bias"):
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = rng.standard_normal(shape, dtype=np.float32) * 0.02
    return out


def phase_serve(torch, mx, fa, seed, smi):
    from mxnet_tpu_torch.gluon.model_zoo import bert

    T, units, vocab, n_req = 512, 768, 30522, 32
    t0 = time.perf_counter()
    gpu_block = bert.bert_12_768_12(vocab_size=vocab, max_length=T)
    params = bert_params(gpu_block, seed)
    mx.convert.load_jax_params(gpu_block, params)
    cpu_block = bert.bert_12_768_12(vocab_size=vocab, max_length=T)
    mx.convert.load_jax_params(cpu_block, params)
    del params
    t_build = time.perf_counter() - t0

    cfg = mx.serve.ServeConfig(max_batch_size=8,
                               sample_shapes=[((T,), (T,))], dtype="int32")
    t0 = time.perf_counter()
    srv = mx.serve.Server(gpu_block, config=cfg)    # no ctx: the card
    t_warm = time.perf_counter() - t0
    if srv.runner.device.type != "cuda":
        fail("the server did not land on the card: %s" % srv.runner.device)

    rng = np.random.default_rng(seed + 1)
    lengths = rng.integers(64, T + 1, n_req)
    reqs = []
    for L in lengths:
        ids = rng.integers(0, vocab, L).astype(np.int32)
        types = (np.arange(L) >= L // 2).astype(np.int32)
        reqs.append((ids, types))

    def submit(x):
        t = time.perf_counter()
        out = srv.submit(x)
        return out, time.perf_counter() - t

    try:
        mx.telemetry.reset()
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_req) as pool:
            results = list(pool.map(submit, reqs))
        wall = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        batches = int(mx.telemetry.value("serve_batches_total"))
        pad_elems = mx.telemetry.value("serve_pad_elements_total")
    finally:
        srv.shutdown()

    for i, ((seq, pooled), _) in enumerate(results):
        L = int(lengths[i])
        if seq.shape != (L, units) or pooled.shape != (units,):
            fail("request %d: shapes %s/%s" % (i, seq.shape, pooled.shape))
        if not (np.isfinite(seq).all() and np.isfinite(pooled).all()):
            fail("request %d: nonfinite output" % i)
    if launches <= 0 or launches != 12 * batches:
        fail("flash_fwd launched %d times over %d batches (want 12 per "
             "batch)" % (launches, batches))

    # where a full batch's time goes: one B=8 forward against its 12
    # flash launches at the same shape
    x8 = torch.zeros((8, T), dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: gpu_block(x8, x8), 5)
        q = torch.randn(8, 12, T, units // 12, device="cuda")
        flash_ms = 12 * cuda_ms(lambda: fa.flash_attention(q, q, q), 20)

    # two requests against the same model on the CPU, padded as served
    cpu_err = 0.0
    for i in (0, 1):
        L = int(lengths[i])
        ids = np.zeros((1, T), np.int32)
        types = np.zeros((1, T), np.int32)
        ids[0, :L], types[0, :L] = reqs[i]
        with torch.inference_mode():
            seq, pooled = cpu_block(torch.from_numpy(ids),
                                    torch.from_numpy(types))
        got_seq, got_pooled = results[i][0]
        cpu_err = max(cpu_err,
                      float(np.abs(got_seq - seq[0, :L].numpy()).max()),
                      float(np.abs(got_pooled - pooled[0].numpy()).max()))
    if cpu_err > TOL_SERVE:
        fail("served outputs differ from the CPU run by %g" % cpu_err)

    lat = np.array([r[1] for r in results]) * 1e3
    real = int(lengths.sum())
    emit({"phase": "serve", "model": "bert_12_768_12", "dtype": "float32",
          "tf32": False, "requests": n_req, "batches": batches,
          "flash_launches": launches,
          "real_tokens": real,
          # both inputs (ids, token types) are padded alike
          "padded_tokens": real + int(pad_elems) // 2,
          "wall_s": wall, "requests_per_s": n_req / wall,
          "tokens_per_s": real / wall,
          "latency_ms_p50": float(np.percentile(lat, 50)),
          "latency_ms_p99": float(np.percentile(lat, 99)),
          "cpu_max_abs_err": cpu_err, "tol": TOL_SERVE,
          "forward_ms_b8": fwd_ms, "flash_ms_b8": flash_ms,
          "flash_share_b8": flash_ms / fwd_ms,
          "model_build_s": t_build, "warm_up_s": t_warm,
          "card": smi})
    return launches


def _train_batch(rng, B, T, M, vocab):
    ids = rng.integers(0, vocab, (B, T)).astype(np.int64)
    types = (np.arange(T)[None, :] >= T // 2).repeat(B, 0).astype(np.int64)
    pos = np.stack([rng.choice(T, M, replace=False) for _ in range(B)])
    return dict(ids=ids, types=types, pos=pos.astype(np.int64),
                labels=rng.integers(0, vocab, (B, M)).astype(np.int64),
                weights=np.ones((B, M), np.float32),
                nsp=rng.integers(0, 2, (B,)).astype(np.int64))


def _train_step(mx, bert, net, batch, train_mode=True):
    """record -> forward + loss -> backward; returns the loss tensor."""
    with mx.autograd.record(train_mode=train_mode):
        mlm, nsp = net(batch["ids"], batch["types"], None, batch["pos"])
        loss = bert.pretraining_loss(mlm, nsp, batch["labels"],
                                     batch["weights"], batch["nsp"])
    loss.backward()
    return loss


def phase_train(torch, mx, fa, seed, smi):
    from mxnet_tpu_torch.gluon.model_zoo import bert

    B, T, M, vocab, steps = 8, 512, 76, 30522, 10
    H, D = 12, 64
    t0 = time.perf_counter()
    net = bert.bert_12_768_12(pretraining=True, vocab_size=vocab,
                              max_length=T, dropout=DROPOUT_P)
    net.initialize()                    # no ctx: the card
    mx.convert.load_jax_params(net, bert_params(net, seed))
    params = net.collect_params()
    if any(p.device.type != "cuda" for p in params.values()):
        fail("initialize() did not place the parameters on the card")
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-4})
    rng = np.random.default_rng(seed + 2)
    host = _train_batch(rng, B, T, M, vocab)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    t_build = time.perf_counter() - t0
    mx.random.seed(seed)

    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, fwd_ms, bwd_ms, upd_ms = [], [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        with mx.autograd.record():
            mlm, nsp = net(batch["ids"], batch["types"], None, batch["pos"])
            loss = bert.pretraining_loss(mlm, nsp, batch["labels"],
                                         batch["weights"], batch["nsp"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.step(1)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        losses.append(loss.item())
        fwd_ms.append((t1 - t0) * 1e3)
        bwd_ms.append((t2 - t1) * 1e3)
        upd_ms.append((t3 - t2) * 1e3)
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()

    if not all(np.isfinite(losses)):
        fail("nonfinite training loss: %s" % losses)
    if not losses[-1] < losses[0]:
        fail("training loss did not fall: %s" % losses)
    for name, n in launches.items():
        if n != 12 * steps:
            fail("%s launched %d times in %d steps (want 12 per step)"
                 % (name, n, steps))

    step_ms = [f + b + u for f, b, u in zip(fwd_ms, bwd_ms, upd_ms)]
    med = float(np.median(step_ms))
    # the 36 kernel launches of one step, timed alone at the step's shapes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, T, D, device="cuda", generator=gen)
                   for _ in range(4))
    with torch.no_grad():
        out, lse = fa.flash_attention(q, k, v, dropout_p=DROPOUT_P, seed=1)
        delta = fa._delta(do, out)
        args = (q, k, v, do, lse, delta, False, None, DROPOUT_P, 1)
        kern_ms = 12 * (cuda_ms(lambda: fa.flash_attention(
            q, k, v, dropout_p=DROPOUT_P, seed=1), 20)
            + cuda_ms(lambda: fa.flash_bwd_dq(*args), 20)
            + cuda_ms(lambda: fa.flash_bwd_dkv(*args), 20))
    del q, k, v, do, out, lse, delta

    grad_err = _train_grad_parity(torch, mx, bert, net, host, vocab, T)
    emit({"phase": "train", "model": "bert_12_768_12", "head":
          "BERTForPretraining", "dtype": "float32", "tf32": False,
          "batch": B, "seq_len": T, "masked_positions": M,
          "dropout": DROPOUT_P, "optimizer": "adam", "lr": 1e-4,
          "steps": steps, "losses": losses, "launches": launches,
          "step_ms": step_ms, "step_ms_median": med,
          "forward_ms_median": float(np.median(fwd_ms)),
          "backward_ms_median": float(np.median(bwd_ms)),
          "update_ms_median": float(np.median(upd_ms)),
          "tokens_per_s": B * T / (med / 1e3),
          "kernels_ms_per_step": kern_ms, "kernels_share": kern_ms / med,
          "max_memory_allocated_bytes": peak,
          "grad_parity_b1_max_rel_err": grad_err, "grad_tol": TOL_GRAD,
          "model_build_s": t_build, "card": smi})
    return launches


def _train_grad_parity(torch, mx, bert, net, host, vocab, T):
    """One step's gradients at B=1 with dropout off (``record(train_mode=
    False)``), card against the same weights on the CPU: the largest
    |g_card - g_cpu| / max(1, max|g_cpu|) over the parameters."""
    one = {k: v[:1] for k, v in host.items()}
    net.zero_grad(set_to_none=True)
    _train_step(mx, bert, net, {k: torch.from_numpy(v).cuda()
                                for k, v in one.items()}, train_mode=False)
    cpu = bert.bert_12_768_12(pretraining=True, vocab_size=vocab,
                              max_length=T, dropout=DROPOUT_P)
    mx.convert.load_jax_params(cpu, {k: p.detach().cpu().numpy()
                                     for k, p in net.collect_params().items()})
    _train_step(mx, bert, cpu, {k: torch.from_numpy(v)
                                for k, v in one.items()}, train_mode=False)
    worst = 0.0
    card = net.collect_params()
    for name, p in cpu.collect_params().items():
        g = p.grad
        err = ((card[name].grad.cpu() - g).abs().max().item()
               / max(1.0, g.abs().max().item()))
        worst = max(worst, err)
        if err > TOL_GRAD:
            fail("gradient of %s differs from the CPU run by %g (x max(1, "
                 "max|g|))" % (name, err))
    net.zero_grad(set_to_none=True)
    return worst


def _kernel_entry(name, launches, case, ms, plain_ms, bound, max_abs_err):
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": case[ms],
            "plain_ms": case[plain_ms], "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": case["library_ms"],
            "library_backend": case["library_backend"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _ext
    from mxnet_tpu_torch.ops import flash_attention as fa

    # full-fp32 matrix products on the card: TF32 keeps ~3 digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "name": name, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _ext.build(force=True)
    emit({"phase": "build", "nvcc_s": time.perf_counter() - t0,
          "sources": [str(s.relative_to(_ext.LIBRARY.parents[2]))
                      for s in _ext.SOURCES],
          "ptxas": ptxas_report(_ext.build_log)})

    fwd_cases, bwd_cases = phase_kernels(torch, fa, args.seed)
    serve_launches = phase_serve(torch, mx, fa, args.seed, smi)
    train_launches = phase_train(torch, mx, fa, args.seed, smi)

    # the main paths' shape, (8, 12, 512, 512, 64) f32, not causal: the
    # forward as served (no dropout), the backward as trained (p = 0.1)
    def main_case(cases, p):
        return next(c for c in cases if c["shape"] == [8, 12, 512, 512, 64]
                    and c["dtype"] == "float32" and not c["causal"]
                    and c["dropout_p"] == p)

    fwd, bwd = main_case(fwd_cases, 0.0), main_case(bwd_cases, DROPOUT_P)
    served = [c for c in fwd_cases if c["shape"][1:] == [12, 512, 512, 64]
              and c["dtype"] == "float32" and not c["causal"]]
    entries = [_kernel_entry(
        "flash_fwd", serve_launches + train_launches["flash_attention"], fwd,
        "ms", "plain_ms", (fwd["bound_ms"], fwd["bound_by"]),
        max(c["max_abs_err_o"] for c in served))]
    entries[0]["launches_by_path"] = {
        "serve": serve_launches, "train": train_launches["flash_attention"]}
    entries[0]["bound_3xtf32_ms"] = fwd["bound_3xtf32_ms"]
    for kname, short, outs in (("flash_bwd_dq", "dq", ("dq",)),
                               ("flash_bwd_dkv", "dkv", ("dk", "dv"))):
        entries.append(_kernel_entry(
            kname, train_launches[kname], bwd, short + "_ms",
            "plain_%s_ms" % short,
            (bwd[short + "_bound_ms"], bwd[short + "_bound_by"]),
            max(bwd["max_abs_err"][o] for o in outs)))
        entries[-1]["bound_3xtf32_ms"] = bwd[short + "_bound_3xtf32_ms"]
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
