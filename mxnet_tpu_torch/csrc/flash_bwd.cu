// Flash-attention backward for Hopper (sm_90a), fp32 and bf16 inputs: the
// dq kernel and the dk/dv kernel.
//
// Replaces mxnet_tpu/ops/pallas_attention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (driven by _flash_backward).  Both recompute the attention
// probabilities from the forward's saved LSE instead of storing them:
//     s  = scale * q.k            (causal: key k <= query q, else p = 0)
//     p  = exp(s - lse)           (rows past Tq or keys past Tk: p = 0)
//     m  = keep / (1 - p_drop)    (dropout; 1 without)
//     dp = (dO . v) * m
//     ds = p * (dp - delta)       delta = rowsum(dO * O), computed by the host
//     dq = scale * sum_k ds k                     (dq kernel)
//     dv = sum_q (p * m) dO,  dk = scale * sum_q ds q   (dk/dv kernel)
// The keep bits are the forward's (flash_common.cuh), regenerated here from
// the absolute (row, column).  As in the JAX package, the work is split into
// two kernels that each own their output tile, so no atomics are needed and
// the result is deterministic; the price is that both recompute s and dp.
//
// Design.  8 warps a block, fp32 math on the CUDA cores for both input types
// (no wgmma, TMA or pipelining yet: simple and correct first).  Tiles are
// chosen by D so that shared memory stays under the 227 KB a block may have:
//   D <= 128: R = 8 rows a warp, 64-row tiles;  D > 128: R = 4, 32-row tiles.
// dq kernel:  one block per (b*h, 8R query rows); warp w owns rows w*R..;
//   the block loops over 32*KPL-key tiles of K and V (stopping at the
//   diagonal under causal); a lane scores keys lane, lane+32.. against its
//   warp's rows, writes ds to a per-warp shared tile, and accumulates dq
//   columns lane, lane+32, ...
// dk/dv kernel: one block per (b*h, 8R keys); warp w owns keys w*R..; the
//   block loops over 32*KPL-row tiles of Q and dO from the causal start
//   `lo`; a lane handles queries lane, lane+32.., writes p*m and ds to
//   per-warp shared tiles and accumulates dk and dv columns lane, lane+32..
// Ragged edges are masked loads (rows and keys past the end read as zero)
// and masked probabilities, so the host pads nothing.
//
// Bound on an H100 SXM at the BERT-base training shape B=8, H=12, T=512,
// D=64 in fp32: the minimal backward does 10*D operations per (query, key)
// pair, 16.1 GFLOP = 0.24 ms at 67 TFLOP/s, against 0.03 ms for its bytes:
// bound by operations.  The two-kernel split does 14*D (dq: 6*D, dk/dv:
// 8*D), which is this design's cost.
#include "flash_common.cuh"

namespace {

using namespace mxflash;

// Shared-memory floats.  A tile read row-wise by lanes (K, V in the dq
// kernel; Q, dO in the dk/dv kernel) has row stride D+4, so float4 reads by
// lanes from different rows hit distinct banks.
__host__ __device__ inline size_t dq_smem_floats(int D, int R, int KPL) {
  const size_t bq = (size_t)kWarps * R, bk = (size_t)32 * KPL;
  return 2 * bq * D + 2 * bk * (D + 4) + (size_t)kWarps * R * bk;
}
__host__ __device__ inline size_t dkv_smem_floats(int D, int R, int KPL) {
  const size_t bk = (size_t)kWarps * R, bq = (size_t)32 * KPL;
  return 2 * bk * D + 2 * bq * (D + 4) + 2 * bq + 2 * (size_t)kWarps * R * bq;
}

// NC = output columns per lane = ceil(D / 32); R rows a warp; KPL keys a
// lane per tile.
template <typename T, int NC, int R, int KPL>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Tq, int Tk, int D, int nq, float scale, int causal,
                    int dropout, Dropout drop) {
  constexpr int BQ = kWarps * R, BK = 32 * KPL;
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;
  float* sQ = smem;              // BQ x D, scaled
  float* sO = sQ + BQ * D;       // BQ x D, dO
  float* sK = sO + BQ * D;       // BK x ld
  float* sV = sK + BK * ld;      // BK x ld
  float* sS = sV + BK * ld;      // per warp: R x BK of ds

  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x - bh * nq) * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * R;
  const size_t qoff = (size_t)bh * Tq * D, koff = (size_t)bh * Tk * D;
  float* myS = sS + warp * R * BK;

  for (int i = tid; i < BQ * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D, qi = q0 + r;
    const bool ok = qi < Tq;
    sQ[i] = ok ? to_float(q[qoff + (size_t)qi * D + c]) * scale : 0.f;
    sO[i] = ok ? to_float(dout[qoff + (size_t)qi * D + c]) : 0.f;
  }

  float row_lse[R], row_delta[R], acc[R][NC];
  uint32_t rkey[R];
  const uint32_t bh_key = dropout ? drop_bh_key(drop.seed, bh) : 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + r0 + r;
    row_lse[r] = qi < Tq ? lse[(size_t)bh * Tq + qi] : 0.f;
    row_delta[r] = qi < Tq ? delta[(size_t)bh * Tq + qi] : 0.f;
    rkey[r] = dropout ? drop_row_key(bh_key, qi) : 0u;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  int nk = (Tk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BK * D; i += blockDim.x) {
      const int r = i / D, c = i - r * D, kk = k0 + r;
      const bool ok = kk < Tk;
      sK[r * ld + c] = ok ? to_float(k[koff + (size_t)kk * D + c]) : 0.f;
      sV[r * ld + c] = ok ? to_float(v[koff + (size_t)kk * D + c]) : 0.f;
    }
    __syncthreads();

    // s and dO.v for keys lane + 32t against the warp's rows
    float s[R][KPL], dp[R][KPL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int t = 0; t < KPL; ++t) s[r][t] = dp[r][t] = 0.f;
    }
    for (int d = 0; d < D; d += 4) {
      float4 kv[KPL], vv[KPL];
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        kv[t] = *reinterpret_cast<const float4*>(&sK[(lane + 32 * t) * ld + d]);
        vv[t] = *reinterpret_cast<const float4*>(&sV[(lane + 32 * t) * ld + d]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qa = *reinterpret_cast<const float4*>(&sQ[(r0 + r) * D + d]);
        const float4 oa = *reinterpret_cast<const float4*>(&sO[(r0 + r) * D + d]);
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          s[r][t] += dot4(qa, kv[t]);
          dp[r][t] += dot4(oa, vv[t]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = q0 + r0 + r;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int kk = k0 + lane + 32 * t;
        const bool valid = kk < Tk && !(causal && kk > qi);
        const float p = valid ? expf(s[r][t] - row_lse[r]) : 0.f;
        float g = dp[r][t];
        if (dropout)
          g = drop_keep(rkey[r], kk, drop.thresh) ? g * drop.inv_keep : 0.f;
        myS[r * BK + lane + 32 * t] = p * (g - row_delta[r]);
      }
    }
    __syncwarp();

    // dq += ds K over this tile, four keys at a time
    for (int kk = 0; kk < BK; kk += 4) {
      float4 ds[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        ds[r] = *reinterpret_cast<const float4*>(&myS[r * BK + kk]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        if (col < D) {
          const float k0v = sK[(kk + 0) * ld + col], k1v = sK[(kk + 1) * ld + col];
          const float k2v = sK[(kk + 2) * ld + col], k3v = sK[(kk + 3) * ld + col];
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r][c] += ds[r].x * k0v + ds[r].y * k1v + ds[r].z * k2v +
                         ds[r].w * k3v;
        }
      }
    }
    __syncwarp();  // myS is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= Tq) continue;
    T* row = dq + qoff + (size_t)qi * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < D) row[col] = from_float<T>(acc[r][c] * scale);
    }
  }
}

// NC as above; R keys a warp; KPL queries a lane per tile.
template <typename T, int NC, int R, int KPL>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Tq, int Tk, int D, int nk,
                     float scale, int causal, int dropout, Dropout drop) {
  constexpr int BKEY = kWarps * R, BQ = 32 * KPL;
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;
  float* sK = smem;                 // BKEY x D
  float* sV = sK + BKEY * D;        // BKEY x D
  float* sQ = sV + BKEY * D;        // BQ x ld, scaled
  float* sO = sQ + BQ * ld;         // BQ x ld, dO
  float* sL = sO + BQ * ld;         // BQ lse
  float* sD = sL + BQ;              // BQ delta
  float* sP = sD + BQ;              // per warp: R x BQ of p*m
  float* sS = sP + kWarps * R * BQ; // per warp: R x BQ of ds

  const int bh = blockIdx.x / nk;
  const int k0 = (blockIdx.x - bh * nk) * BKEY;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * R;
  const size_t qoff = (size_t)bh * Tq * D, koff = (size_t)bh * Tk * D;
  float* myP = sP + warp * R * BQ;
  float* myS = sS + warp * R * BQ;

  for (int i = tid; i < BKEY * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D, kk = k0 + r;
    const bool ok = kk < Tk;
    sK[i] = ok ? to_float(k[koff + (size_t)kk * D + c]) : 0.f;
    sV[i] = ok ? to_float(v[koff + (size_t)kk * D + c]) : 0.f;
  }

  float acc_k[R][NC], acc_v[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  }
  const uint32_t bh_key = dropout ? drop_bh_key(drop.seed, bh) : 0u;

  const int nq = (Tq + BQ - 1) / BQ;
  // causal: query tiles wholly before this key tile see none of its keys
  const int lo = causal ? k0 / BQ : 0;
  for (int i = lo; i < nq; ++i) {
    const int q0 = i * BQ;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    for (int e = tid; e < BQ * D; e += blockDim.x) {
      const int r = e / D, c = e - r * D, qi = q0 + r;
      const bool ok = qi < Tq;
      sQ[r * ld + c] = ok ? to_float(q[qoff + (size_t)qi * D + c]) * scale : 0.f;
      sO[r * ld + c] = ok ? to_float(dout[qoff + (size_t)qi * D + c]) : 0.f;
    }
    for (int e = tid; e < BQ; e += blockDim.x) {
      const bool ok = q0 + e < Tq;
      sL[e] = ok ? lse[(size_t)bh * Tq + q0 + e] : 0.f;
      sD[e] = ok ? delta[(size_t)bh * Tq + q0 + e] : 0.f;
    }
    __syncthreads();

    // s and dO.v for queries lane + 32t against the warp's keys
    float s[R][KPL], dp[R][KPL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int t = 0; t < KPL; ++t) s[r][t] = dp[r][t] = 0.f;
    }
    for (int d = 0; d < D; d += 4) {
      float4 qv[KPL], ov[KPL];
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        qv[t] = *reinterpret_cast<const float4*>(&sQ[(lane + 32 * t) * ld + d]);
        ov[t] = *reinterpret_cast<const float4*>(&sO[(lane + 32 * t) * ld + d]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 ka = *reinterpret_cast<const float4*>(&sK[(r0 + r) * D + d]);
        const float4 va = *reinterpret_cast<const float4*>(&sV[(r0 + r) * D + d]);
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          s[r][t] += dot4(ka, qv[t]);
          dp[r][t] += dot4(va, ov[t]);
        }
      }
    }

#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int qq = lane + 32 * t, qi = q0 + qq;
      const uint32_t rkey = dropout ? drop_row_key(bh_key, qi) : 0u;
      const float l = sL[qq], dl = sD[qq];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int kk = k0 + r0 + r;
        // padded query rows give p = 0, not exp(s - garbage)
        const bool valid = qi < Tq && kk < Tk && !(causal && kk > qi);
        const float p = valid ? expf(s[r][t] - l) : 0.f;
        float pm = p, g = dp[r][t];
        if (dropout) {
          const bool keep = drop_keep(rkey, kk, drop.thresh);
          pm = keep ? p * drop.inv_keep : 0.f;
          g = keep ? g * drop.inv_keep : 0.f;
        }
        myP[r * BQ + qq] = pm;
        myS[r * BQ + qq] = p * (g - dl);
      }
    }
    __syncwarp();

    // dv += (p m)^T dO, dk += ds^T (scale Q), four queries at a time
    for (int qq = 0; qq < BQ; qq += 4) {
      float4 pv[R], dsv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pv[r] = *reinterpret_cast<const float4*>(&myP[r * BQ + qq]);
        dsv[r] = *reinterpret_cast<const float4*>(&myS[r * BQ + qq]);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        if (col < D) {
          const float o0 = sO[(qq + 0) * ld + col], o1 = sO[(qq + 1) * ld + col];
          const float o2 = sO[(qq + 2) * ld + col], o3 = sO[(qq + 3) * ld + col];
          const float a0 = sQ[(qq + 0) * ld + col], a1 = sQ[(qq + 1) * ld + col];
          const float a2 = sQ[(qq + 2) * ld + col], a3 = sQ[(qq + 3) * ld + col];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc_v[r][c] += pv[r].x * o0 + pv[r].y * o1 + pv[r].z * o2 + pv[r].w * o3;
            acc_k[r][c] += dsv[r].x * a0 + dsv[r].y * a1 + dsv[r].z * a2 +
                           dsv[r].w * a3;
          }
        }
      }
    }
    __syncwarp();  // myP/myS are rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kk = k0 + r0 + r;
    if (kk >= Tk) continue;
    T* krow = dk + koff + (size_t)kk * D;
    T* vrow = dv + koff + (size_t)kk * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        krow[col] = from_float<T>(acc_k[r][c]);  // already scale * ds^T Q
        vrow[col] = from_float<T>(acc_v[r][c]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq; or dk and dv
  int bh, Tq, Tk, D;
  float scale;
  int causal, dropout;
  Dropout drop;
};

template <typename T, int NC, int R, int KPL>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = dq_smem_floats(a.D, R, KPL) * sizeof(float);
  auto kern = flash_bwd_dq_kernel<T, NC, R, KPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int bq = kWarps * R, nq = (a.Tq + bq - 1) / bq;
  kern<<<dim3((unsigned)(a.bh * nq)), dim3(kWarps * 32), smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.Tq, a.Tk, a.D, nq, a.scale, a.causal,
      a.dropout, a.drop);
  return cudaGetLastError();
}

template <typename T, int NC, int R, int KPL>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats(a.D, R, KPL) * sizeof(float);
  auto kern = flash_bwd_dkv_kernel<T, NC, R, KPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int bk = kWarps * R, nk = (a.Tk + bk - 1) / bk;
  kern<<<dim3((unsigned)(a.bh * nk)), dim3(kWarps * 32), smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.Tq, a.Tk, a.D, nk,
      a.scale, a.causal, a.dropout, a.drop);
  return cudaGetLastError();
}

// D <= 128: 8 rows a warp and 64-wide tiles; D > 128: 4 rows a warp and
// 32-wide tiles (shared memory: 166 KB for dk/dv at D=128, 140 KB at 256).
template <typename T, bool kDkv>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  switch ((a.D + 31) / 32) {
#define MX_CASE(NC, R, KPL)                                               \
  case NC:                                                                \
    return kDkv ? launch_dkv<T, NC, R, KPL>(a, stream)                    \
                : launch_dq<T, NC, R, KPL>(a, stream);
    MX_CASE(1, 8, 2) MX_CASE(2, 8, 2) MX_CASE(3, 8, 2) MX_CASE(4, 8, 2)
    MX_CASE(5, 4, 1) MX_CASE(6, 4, 1) MX_CASE(7, 4, 1) MX_CASE(8, 4, 1)
#undef MX_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kDkv>
int run(const Args& a, int dtype, int device, void* stream) {
  if (a.D <= 0 || a.D > 256 || a.D % 8 != 0 || a.bh <= 0 || a.Tq <= 0 ||
      a.Tk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) err = dispatch<float, kDkv>(a, s);
  else if (dtype == 1) err = dispatch<__nv_bfloat16, kDkv>(a, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace

// Plain C entry points, bound with ctypes.  q/dout/dq: contiguous
// (B*H, Tq, D); k/v/dk/dv: (B*H, Tk, D), all of dtype 0 = float32 or
// 1 = bfloat16; lse, delta: (B*H, Tq) float32.  dropout != 0 regenerates the
// forward's mask from (seed, thresh) and scales kept terms by inv_keep.
// Each launches on `stream` of `device` and returns cudaGetLastError().
extern "C" int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int Tq,
                               int Tk, int D, float scale, int causal,
                               int dtype, int dropout,
                               unsigned long long seed, unsigned int thresh,
                               float inv_keep, int device, void* stream) {
  const Args a{q,  k,  v,  dout,  lse,    delta,   dq,
               nullptr, bh, Tq, Tk, D, scale, causal, dropout,
               Dropout{seed, thresh, inv_keep}};
  return run<false>(a, dtype, device, stream);
}

extern "C" int mx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int bh, int Tq, int Tk, int D, float scale,
                                int causal, int dtype, int dropout,
                                unsigned long long seed, unsigned int thresh,
                                float inv_keep, int device, void* stream) {
  const Args a{q,  k,  v,  dout, lse,   delta,  dk,      dv,
               bh, Tq, Tk, D,    scale, causal, dropout, Dropout{seed, thresh, inv_keep}};
  return run<true>(a, dtype, device, stream);
}
