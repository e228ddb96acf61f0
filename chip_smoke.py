#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``mxnet_tpu_torch``).

    python3 chip_smoke.py [--seed N]

Needs one CUDA card (NVIDIA H100), ``nvcc`` and numpy; never imports JAX
or ``mxnet_tpu``.  Phases, each printed as one JSON line:

1. device  -- card name and count, and ``nvidia-smi`` name + power limit.
2. build   -- nvcc time for ``mxnet_tpu_torch/csrc/*.cu`` (sm_90a).
3. kernels -- the flash-attention forward kernel against its plain PyTorch
   version on the card, over shapes x {f32, bf16} x {causal, not}, with
   its time, the plain version's, ``F.scaled_dot_product_attention``'s
   (a yardstick only; the port never calls it) and the card's bound.
4. serve   -- full-width BERT-base (12 x 768, 12 heads, vocab 30522,
   max_length 512) in f32 with random weights from ``--seed``, served
   through ``serve.Server(...).submit()`` on the card: 32 concurrent
   requests of 64..512 tokens.  Every output is finite and shaped; the
   kernel's launch count is exactly 12 x the batches dispatched; two
   requests match the same model run on the CPU.

Then the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the script exits non-zero and prints no result line.  Without a card,
or without the package beside it, it exits non-zero.
"""
from __future__ import annotations

import argparse
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
TOL_O = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_LSE = 1e-3
TOL_SERVE = 1e-3
FLASH_SOURCE = "mxnet_tpu_torch/csrc/flash_fwd.cu"
FLASH_REPLACES = "mxnet_tpu/ops/pallas_attention.py:203"


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit("chip_smoke: FAILED: " + msg)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(B, H, Tq, Tk, D, dtype, causal):
    """(ms, "bytes"|"operations"): Q/K/V read once, O and LSE written
    once; 4*D operations per (query, visible key) pair."""
    itemsize = 4 if dtype == "float32" else 2
    nbytes = B * H * (2 * Tq * D + 2 * Tk * D) * itemsize + B * H * Tq * 4
    pairs = sum(min(i + 1, Tk) for i in range(Tq)) if causal else Tq * Tk
    ops = 4.0 * B * H * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, fa, seed):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = [(8, 12, 512, 512, 64), (4, 12, 512, 512, 64),
              (2, 12, 512, 512, 64), (1, 12, 512, 512, 64),
              (2, 4, 200, 200, 64), (1, 2, 384, 512, 128)]
    cases = []
    for B, H, Tq, Tk, D in shapes:
        serve_shape = (H, Tq, Tk, D) == (12, 512, 512, 64)
        for dname in ("float32", "bfloat16"):
            for causal in (False, True):
                if serve_shape and B != 8 and (dname != "float32" or causal):
                    continue  # the other serving batches: f32, not causal
                dt = getattr(torch, dname)
                q = torch.randn(B, H, Tq, D, device="cuda", generator=gen,
                                dtype=dt)
                k = torch.randn(B, H, Tk, D, device="cuda", generator=gen,
                                dtype=dt)
                v = torch.randn(B, H, Tk, D, device="cuda", generator=gen,
                                dtype=dt)
                out, lse = fa.flash_attention(q, k, v, causal)
                torch.cuda.synchronize()
                ref_out, ref_lse = fa.flash_attention_reference(
                    q, k, v, causal)
                err_o = (out.float() - ref_out.float()).abs().max().item()
                err_l = (lse - ref_lse).abs().max().item()
                ok = err_o <= TOL_O[dname] and err_l <= TOL_LSE
                bound, by = attention_bound(B, H, Tq, Tk, D, dname, causal)
                iters = 20 if B * H * Tq * Tk > 1 << 22 else 50
                case = {
                    "shape": [B, H, Tq, Tk, D], "dtype": dname,
                    "causal": causal, "max_abs_err_o": err_o,
                    "max_abs_err_lse": err_l, "tol_o": TOL_O[dname],
                    "tol_lse": TOL_LSE, "ok": ok,
                    "ms": cuda_ms(lambda: fa.flash_attention(
                        q, k, v, causal), iters),
                    "plain_ms": cuda_ms(lambda: fa.flash_attention_reference(
                        q, k, v, causal), iters),
                    "library_ms": cuda_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=causal), iters),
                    "bound_ms": bound, "bound_by": by}
                cases.append(case)
                if not ok:
                    emit({"phase": "kernels", "failed_case": case})
                    fail("flash_fwd disagrees with its plain version at %s"
                         % case["shape"])
    emit({"phase": "kernels", "kernel": "flash_fwd", "cases": cases})
    return cases


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
          "ptxas": [ln.strip() for ln in _ext.build_log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    cases = phase_kernels(torch, fa, args.seed)
    launches = phase_serve(torch, mx, fa, args.seed, smi)

    main_case = cases[0]   # (8, 12, 512, 512, 64) f32, not causal
    serve_cases = [c for c in cases if c["shape"][1:] == [12, 512, 512, 64]
                   and c["dtype"] == "float32" and not c["causal"]]
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": launches,
        "max_abs_err": max(c["max_abs_err_o"] for c in serve_cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
