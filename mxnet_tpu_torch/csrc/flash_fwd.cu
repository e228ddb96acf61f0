// Flash-attention forward for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces mxnet_tpu/ops/pallas_attention.py:_flash_kernel (the Pallas TPU
// forward kernel driven by _flash_forward).  Computes, per (batch*head):
//     O   = softmax(scale * Q K^T) V          (causal: key k <= query q)
//     LSE = log sum_k exp(scale * q.k)        one fp32 value per query row
// with the online softmax of the TPU kernel: running max m, running
// denominator l and the output accumulator kept in fp32 while K/V tiles
// stream past.  Q is scaled in fp32 as it is loaded, as the TPU kernel does.
// With dropout p (training), O = (softmax(s) * keep / (1-p)) V: the keep
// bits come from the hash of flash_common.cuh, the denominator and the LSE
// stay undropped, and the backward kernels (flash_bwd.cu) regenerate the
// same bits.
//
// Design.  One thread block owns one (b*h, 64-row query tile); 8 warps own 8
// rows each.  The block loops over 64-key tiles of K and V staged in shared
// memory (converted to fp32 on the way in).  A lane computes the scores of
// keys lane and lane+32 for its warp's 8 rows, the warp reduces max and sum
// with shuffles, writes its 8x64 probability tile to shared memory, and then
// each lane accumulates output columns lane, lane+32, ... for the 8 rows.
// Ragged edges are masked loads (rows past Tq or keys past Tk read as zero,
// keys past Tk score -1e30), so the host pads nothing.  Under causal masking
// the tile loop stops at the last tile that reaches the diagonal.  O is
// written in the input type, LSE as a flat fp32 (B*H, Tq) array.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores, 989 TFLOP/s bf16 dense): at the BERT-base serving shape B=8, H=12,
// T=512, D=64, reading Q/K/V and writing O moves 50.3 MB in fp32 (15 us) or
// 25.2 MB in bf16 (7.5 us); the math is 4*B*H*T^2*D = 6.4 GFLOP, 96 us at
// the fp32 rate.  The fp32 path is bound by operations and this kernel
// computes in fp32 on the CUDA cores for both input types, without wgmma,
// TMA or pipelining: simple and correct first.  Its inner loops are bound
// by shared-memory loads (10 loads per 64 FMAs in QK^T, fewer in PV).
#include "flash_common.cuh"

namespace {

using namespace mxflash;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp

// Shared-memory floats for head dim D: Q tile (stride D), K tile (stride
// D+4: lanes reading float4s from different key rows then hit distinct
// banks), V tile (stride D), and each warp's probability tile.
__host__ __device__ inline size_t smem_floats(int D) {
  return (size_t)kBlockQ * D + (size_t)kBlockK * (D + 4) +
         (size_t)kBlockK * D + (size_t)kWarps * kRows * kBlockK;
}

// NC = output columns per lane = ceil(D / 32); D is a multiple of 8, <= 256.
// kDropout: attention-probability dropout (a separate instance, so the
// inference kernel's instructions are those of the kernel without dropout).
template <typename T, int NC, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, int D, int nq,
                 float scale, int causal, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = D + 4;
  float* sQ = smem;
  float* sK = sQ + kBlockQ * D;
  float* sV = sK + kBlockK * ldk;
  float* sP = sV + kBlockK * D;

  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x - bh * nq) * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * kRows;  // first tile row of this warp
  const T* qb = q + (size_t)bh * Tq * D;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  float* myP = sP + warp * kRows * kBlockK;

  for (int i = tid; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D, qi = q0 + r;
    sQ[i] = qi < Tq ? to_float(qb[(size_t)qi * D + c]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
  uint32_t rkey[kRows];  // dropout: one hash key per query row
  const uint32_t bh_key = kDropout ? drop_bh_key(drop.seed, bh) : 0u;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (kDropout) rkey[r] = drop_row_key(bh_key, q0 + r0 + r);
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  int nk = (Tk + kBlockK - 1) / kBlockK;
  if (causal) nk = min(nk, (q0 + kBlockQ + kBlockK - 1) / kBlockK);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int r = i / D, c = i - r * D, kk = k0 + r;
      const bool ok = kk < Tk;
      sK[r * ldk + c] = ok ? to_float(kb[(size_t)kk * D + c]) : 0.f;
      sV[i] = ok ? to_float(vb[(size_t)kk * D + c]) : 0.f;
    }
    __syncthreads();

    // scores of keys lane and lane+32 against the warp's rows
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&sK[lane * ldk + d]);
      const float4 kc =
          *reinterpret_cast<const float4*>(&sK[(lane + 32) * ldk + d]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qa =
            *reinterpret_cast<const float4*>(&sQ[(r0 + r) * D + d]);
        s[r][0] += qa.x * ka.x + qa.y * ka.y + qa.z * ka.z + qa.w * ka.w;
        s[r][1] += qa.x * kc.x + qa.y * kc.y + qa.z * kc.z + qa.w * kc.w;
      }
    }

    // mask, then the online-softmax update of (m, l, acc).  The
    // denominator l keeps the undropped mass (dropout(softmax(s)) V, as
    // the TPU kernel); only the probabilities into acc are dropped.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + r0 + r;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int kk = k0 + lane + 32 * t;
        if (kk >= Tk || (causal && kk > qi)) s[r][t] = kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
      float d0 = p0, d1 = p1;
      if (kDropout) {
        d0 = drop_keep(rkey[r], k0 + lane, drop.thresh) ? p0 * drop.inv_keep : 0.f;
        d1 = drop_keep(rkey[r], k0 + lane + 32, drop.thresh) ? p1 * drop.inv_keep
                                                            : 0.f;
      }
      myP[r * kBlockK + lane] = d0;
      myP[r * kBlockK + lane + 32] = d1;
    }
    __syncwarp();

    // acc += P V over this tile, four keys at a time
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        p[r] = *reinterpret_cast<const float4*>(&myP[r * kBlockK + kk]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        if (col < D) {
          const float v0 = sV[(kk + 0) * D + col], v1 = sV[(kk + 1) * D + col];
          const float v2 = sV[(kk + 2) * D + col], v3 = sV[(kk + 3) * D + col];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][c] += p[r].x * v0 + p[r].y * v1 + p[r].z * v2 + p[r].w * v3;
        }
      }
    }
    __syncwarp();  // myP is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= Tq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / lc;
    T* orow = o + ((size_t)bh * Tq + qi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < D) orow[col] = from_float<T>(acc[r][c] * inv);
    }
    if (lane == 0) lse[(size_t)bh * Tq + qi] = m[r] + logf(lc);
  }
}

template <typename T, int NC, bool kDropout>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int Tq, int Tk, int D, float scale,
                   int causal, Dropout drop, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NC, kDropout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nq = (Tq + kBlockQ - 1) / kBlockQ;
  flash_fwd_kernel<T, NC, kDropout>
      <<<dim3((unsigned)(bh * nq)), dim3(kWarps * 32), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Tq, Tk, D, nq,
      scale, causal, drop);
  return cudaGetLastError();
}

template <typename T, bool kDropout>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int Tq, int Tk, int D, float scale,
                     int causal, Dropout drop, cudaStream_t stream) {
  switch ((D + 31) / 32) {
#define MX_CASE(NC)                                                         \
  case NC:                                                                  \
    return launch<T, NC, kDropout>(q, k, v, o, lse, bh, Tq, Tk, D, scale,   \
                                   causal, drop, stream);
    MX_CASE(1) MX_CASE(2) MX_CASE(3) MX_CASE(4)
    MX_CASE(5) MX_CASE(6) MX_CASE(7) MX_CASE(8)
#undef MX_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dropout(const void* q, const void* k, const void* v,
                             void* o, float* lse, int bh, int Tq, int Tk,
                             int D, float scale, int causal, int dropout,
                             Dropout drop, cudaStream_t stream) {
  return dropout ? dispatch<T, true>(q, k, v, o, lse, bh, Tq, Tk, D, scale,
                                     causal, drop, stream)
                 : dispatch<T, false>(q, k, v, o, lse, bh, Tq, Tk, D, scale,
                                      causal, drop, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes.  q/k/v/o: contiguous (B*H, T, D)
// of dtype 0 = float32 or 1 = bfloat16; lse: (B*H, Tq) float32.  dropout != 0
// drops attention probabilities with the mask of flash_common.cuh (seed,
// keep threshold, 1 / (1 - p)).  Launches on `stream` of `device` and
// returns cudaGetLastError() (0 on success).
extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int Tq, int Tk,
                            int D, float scale, int causal, int dtype,
                            int dropout, unsigned long long seed,
                            unsigned int thresh, float inv_keep, int device,
                            void* stream) {
  if (D <= 0 || D > 256 || D % 8 != 0 || bh <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const Dropout drop{seed, thresh, inv_keep};
  if (dtype == 0)
    err = dispatch_dropout<float>(q, k, v, o, l, bh, Tq, Tk, D, scale, causal,
                                  dropout, drop, s);
  else if (dtype == 1)
    err = dispatch_dropout<__nv_bfloat16>(q, k, v, o, l, bh, Tq, Tk, D, scale,
                                          causal, dropout, drop, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
