// Flash-attention forward for Hopper (sm_90a) on the tensor cores, fp32,
// bf16 and fp16 inputs.
//
// Replaces mxnet_tpu/ops/pallas_attention.py:_flash_kernel (the Pallas TPU
// forward kernel driven by _flash_forward).  Computes, per (batch*head):
//     O   = softmax(scale * Q K^T) V          (causal: key k <= query q)
//     LSE = log sum_k exp(scale * q.k)        one fp32 value per query row
// with the online softmax of the TPU kernel: running max m, running
// denominator l and the output accumulator kept in fp32 while K/V tiles
// stream past.  With dropout p (training), O = (softmax(s) * keep / (1-p)) V:
// the keep bits come from the hash of flash_common.cuh at each element's
// absolute (row, column), the denominator and the LSE stay undropped, and
// the backward kernels (flash_bwd.cu) regenerate the same bits.  P * keep
// enters the product and 1 / (1-p) scales O once at the end, so a 16-bit
// P is not rounded after the scaling.
//
// Bounds on an H100 SXM at the BERT-base serving shape B=8, H=12, T=512,
// D=64: the math is 4*B*H*T^2*D = 6.44 GFLOP; reading Q/K/V and writing O
// moves 50.3 MB in fp32 (15 us at 3.35 TB/s) or 25.2 MB in bf16 (7.5 us).
// On the CUDA cores (67 TFLOP/s fp32) the math alone takes 96 us.  On the
// TF32 tensor cores with the 3xTF32 split used here it is 3 x 6.44 GFLOP at
// 495 TFLOP/s = 39 us; in bf16 at 989 TFLOP/s 6.5 us, below the bytes.
//
// Design (FlashAttention-2 arrangement on mma.sync).  A block owns one
// (b*h, query tile): 8 warps and 128 rows for fp32 (each K/V tile fetched
// from L2 then serves twice the rows), 4 warps and 64 rows for bf16 (more
// blocks stay resident) and for fp32 at D > 128 (shared memory).  Each warp
// owns 16 query rows, the m16 of the MMA, and keeps its scores, m, l and the
// O accumulator in fp32 registers in the accumulator layout (flash_mma.cuh).
// The block loops over tiles of kBlockN keys (64; 32 for fp32 at D > 128,
// where a double-buffered 64-key tile would not fit in shared memory):
//  - K/V tiles stream through a two-stage ring in shared memory with
//    cp.async (16 B a thread): one barrier a tile, after which tile j+1 is
//    issued into the stage tile j-1 left and streams in while tile j is
//    computed; cp.async.wait_group replaces a load-then-sync.  Keys past
//    Tk are zero-filled through the copy's src-size, rows past Tq
//    likewise; the host pads nothing.  Row strides D+4 floats / D+8 bf16
//    spread a warp's fragment loads over all banks.
//  - bf16 and fp16 (one code path, T picks the MMA): S = Q K^T and O += P V
//    by mma m16n8k16 with Q, K fragments from ldmatrix and V's from
//    ldmatrix.trans; P is rounded to T and packed straight from the S
//    accumulator into the A fragment (the two layouts line up).  The scale is applied to S in fp32 after the product.
//  - fp32: 3xTF32, mma m16n8k8 with every operand split into hi + lo TF32
//    parts and hi*hi + hi*lo + lo*hi summed (1xTF32 misses the 1e-4 gate).
//    Every warp splits the K/V elements it reads (an integer add and mask
//    for each TF32 rounding); splitting each tile once into shared memory
//    measured no faster.  The TF32 accumulator layout (columns 2t, 2t+1)
//    is not the A layout (k = t, t+4), so within every 8-key slab P's keys
//    are relabelled (physical key 2t is k = t, 2t+1 is k = t+4) and V's B
//    fragment is read with the same relabelling.
//  - Masks and dropout act on S / P in the accumulator layout, at their true
//    (row, column); row max and row sum reduce over the 4 threads of a quad.
//    exp2 with log2(e) folded into the scale; the LSE written is natural-log.
//  - Head dims are instantiated by bucket (32, 64, 128, 256; the columns
//    past D are zero in shared memory).  Q's fragments stay in registers
//    where they fit (fp32 D <= 64, bf16 D <= 128), else are re-read from
//    shared memory each tile.
// Left to a later design: wgmma with TMA (the only way to the full tensor
// rate; it needs swizzled descriptors and a K-major V for TF32), warp
// specialisation, and overlapping the softmax of one tile with the MMAs of
// the next.
#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace mxflash;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of one instance: Q (16 rows a warp) and a two-stage ring of
// K and V tiles (kBlockN rows each), all with row stride kLd elements.
template <typename T, int kD, int kBlockN, int kWarps>
struct Smem {
  static constexpr int kLd = kD + (std::is_same<T, float>::value ? 4 : 8);
  static constexpr int kQ = kWarps * 16 * kLd;
  static constexpr int kKV = kBlockN * kLd;  // one K or V stage
  static constexpr size_t kBytes = (size_t)(kQ + 4 * kKV) * sizeof(T);
};

// kD: head-dim bucket (D <= kD, a multiple of 8); kBlockN keys a tile;
// kWarps: warps a block, 16 query rows each; kDropout: attention-probability
// dropout (a separate instance, so the inference kernel's instructions are
// those of the kernel without dropout).
template <typename T, int kD, int kBlockN, int kWarps, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, int D, int nq,
                 float scale_log2, int causal, Dropout drop) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kThreads = kWarps * 32, kBlockM = kWarps * 16;
  using SM = Smem<T, kD, kBlockN, kWarps>;
  constexpr int kLd = SM::kLd;
  constexpr int kE = 16 / (int)sizeof(T);  // elements in one 16-byte copy
  constexpr int kNT = kBlockN / 8;         // 8-key score tiles
  constexpr int kDT = kD / 8;              // 8-column output tiles
  constexpr int kKS = kF32 ? kD / 8 : kD / 16;  // MMA k-steps over D
  constexpr int kQF = kF32 ? 8 : 4;        // Q fragment registers a k-step
  constexpr bool kQRegs = kF32 ? kD <= 64 : kD <= 128;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + SM::kQ;       // [2][kBlockN][kLd]
  T* sV = sK + 2 * SM::kKV;  // [2][kBlockN][kLd]

  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x - bh * nq) * kBlockM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;  // first tile row of this warp
  const T* qb = q + (size_t)bh * Tq * D;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;

  // Columns D..kD stay zero: the copies below write only the first D.  The
  // rows of Q, K and V are contiguous with one stride.
  if (D < kD) {
    const int pad = kD - D;
    for (int i = tid; i < (kBlockM + 4 * kBlockN) * pad; i += kThreads)
      sQ[(i / pad) * kLd + D + i % pad] = from_float<T>(0.f);
  }
  // rows row0.. of a (rows, D) matrix into a tile; rows at or past `valid`
  // are zero-filled
  const auto copy_rows = [&](T* dst, const T* src, int row0, int nrows,
                             int valid) {
    constexpr int kChunks = kD / kE;
    for (int i = tid; i < nrows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * kE, row = row0 + r;
      if (c < D) {
        const bool ok = row < valid;
        cp_async_16(dst + r * kLd + c, src + (size_t)(ok ? row : 0) * D + c,
                    ok ? 16 : 0);
      }
    }
  };
  const auto load_kv = [&](int stage, int k0) {
    copy_rows(sK + stage * SM::kKV, kb, k0, kBlockN, Tk);
    copy_rows(sV + stage * SM::kKV, vb, k0, kBlockN, Tk);
  };
  // The A fragment of Q for k-step ks (fp32: hi in f[0..3], lo in f[4..7]).
  const auto load_qfrag = [&](int ks, uint32_t* f) {
    if constexpr (kF32) {
      const float* p = sQ + (m0 + g) * kLd + ks * 8 + t;
      const float x[4] = {p[0], p[8 * kLd], p[4], p[8 * kLd + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(x[i], f[i], f[4 + i]);
    } else {
      ldmatrix_x4(f, sQ + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                         ks * 16 + (lane >> 4) * 8);
    }
  };

  copy_rows(sQ, qb, q0, kBlockM, Tq);
  load_kv(0, 0);
  cp_async_commit();

  int nk = (Tk + kBlockN - 1) / kBlockN;
  if (causal) nk = min(nk, (q0 + kBlockM + kBlockN - 1) / kBlockN);

  // this thread's two query rows (accumulator rows g and g+8)
  const int row_a = q0 + m0 + g, row_b = row_a + 8;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  uint32_t key_a = 0u, key_b = 0u;
  if (kDropout) {
    const uint32_t bh_key = drop_bh_key(drop, bh);
    key_a = drop_row_key(bh_key, row_a);
    key_b = drop_row_key(bh_key, row_b);
  }
  uint32_t qf[kQRegs ? kKS : 1][kQF];

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBlockN;
    cp_async_wait_all();  // this thread's copies of tile j (and Q) landed
    __syncthreads();     // ... every thread's, and tile j-1 is done with
    if (j + 1 < nk) {    // so tile j+1 streams into its stage meanwhile
      load_kv((j + 1) & 1, k0 + kBlockN);
      cp_async_commit();
    }
    const T* tK = sK + (j & 1) * SM::kKV;
    const T* tV = sV + (j & 1) * SM::kKV;
    if constexpr (kQRegs) {
      if (j == 0) {
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) load_qfrag(ks, qf[ks]);
      }
    }

    // S = Q K^T (unscaled) in the accumulator layout
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t a_buf[kQF];
      const uint32_t* a;
      if constexpr (kQRegs) {
        a = qf[ks];
      } else {
        load_qfrag(ks, a_buf);
        a = a_buf;
      }
      if constexpr (kF32) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float* p = tK + (nt * 8 + g) * kLd + ks * 8 + t;
          uint32_t b_hi[2], b_lo[2];
          split_tf32(p[0], b_hi[0], b_lo[0]);
          split_tf32(p[4], b_hi[1], b_lo[1]);
          mma_3xtf32(s[nt], a, a + 4, b_hi, b_lo);
        }
      } else {
#pragma unroll
        for (int n2 = 0; n2 < kNT / 2; ++n2) {
          uint32_t b[4];
          ldmatrix_x4(b, tK + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                             ks * 16 + ((lane >> 3) & 1) * 8);
          mma16<T>(s[2 * n2], a, b);
          mma16<T>(s[2 * n2 + 1], a, b + 2);
        }
      }
    }

    // scale (log2 units) and mask at the true (row, column)
    const bool edge = k0 + kBlockN > Tk ||
                      (causal && k0 + kBlockN - 1 > q0 + m0);
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= Tk || (causal && col > row)) x = kNegInf;
        }
        s[nt][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
    // online softmax: the denominator keeps the undropped mass (dropout
    // (softmax(s)) V, as the TPU kernel); only P into acc is dropped
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float c_a = exp2f(m_a - mn_a), c_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] - (e < 2 ? mn_a : mn_b));
        if (e < 2) sum_a += p;
        else sum_b += p;
        if (kDropout) {  // 1 / (1 - p) is applied to O at the end
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          if (!drop_keep(e < 2 ? key_a : key_b, col, drop.thresh)) p = 0.f;
        }
        s[nt][e] = p;
      }
    }
    l_a = l_a * c_a + sum_a;  // per-thread partial sums: the quad's
    l_b = l_b * c_b + sum_b;  // share one c, so reduce once at the end
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][0] *= c_a;
      acc[dt][1] *= c_a;
      acc[dt][2] *= c_b;
      acc[dt][3] *= c_b;
    }

    // O += P V
    if constexpr (kF32) {
#pragma unroll
      for (int j8 = 0; j8 < kNT; ++j8) {
        // P's keys relabelled within the slab: physical 2t -> k = t,
        // 2t+1 -> k = t+4; V's rows follow the same relabelling
        uint32_t a_hi[4], a_lo[4];
        split_tf32(s[j8][0], a_hi[0], a_lo[0]);
        split_tf32(s[j8][2], a_hi[1], a_lo[1]);
        split_tf32(s[j8][1], a_hi[2], a_lo[2]);
        split_tf32(s[j8][3], a_hi[3], a_lo[3]);
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          const float* p = tV + (j8 * 8 + 2 * t) * kLd + dt * 8 + g;
          uint32_t b_hi[2], b_lo[2];
          split_tf32(p[0], b_hi[0], b_lo[0]);
          split_tf32(p[kLd], b_hi[1], b_lo[1]);
          mma_3xtf32(acc[dt], a_hi, a_lo, b_hi, b_lo);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        const uint32_t a[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                               pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                               pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int d2 = 0; d2 < kDT / 2; ++d2) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, tV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                     d2 * 16 + (lane >> 4) * 8);
          mma16<T>(acc[2 * d2], a, b);
          mma16<T>(acc[2 * d2 + 1], a, b + 2);
        }
      }
    }
  }

  // O = acc / l (with dropout acc / (1 - p) / l) in the input type;
  // LSE = m ln 2 + log l (natural log)
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row_b : row_a;
    if (row >= Tq) continue;
    const float lc = fmaxf(h ? l_b : l_a, 1e-30f);
    const float inv = (kDropout ? drop.inv_keep : 1.f) / lc;
    T* orow = o + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < D)
        store2(orow + col, acc[dt][2 * h] * inv, acc[dt][2 * h + 1] * inv);
    }
    if (t == 0) lse[(size_t)bh * Tq + row] = (h ? m_b : m_a) * kLn2 + logf(lc);
  }
}

template <typename T, int kD, int kBlockN, int kWarps, bool kDropout>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int Tq, int Tk, int D, float scale,
                   int causal, Dropout drop, cudaStream_t stream) {
  const size_t smem = Smem<T, kD, kBlockN, kWarps>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kD, kBlockN, kWarps, kDropout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nq = (Tq + kWarps * 16 - 1) / (kWarps * 16);
  flash_fwd_kernel<T, kD, kBlockN, kWarps, kDropout>
      <<<dim3((unsigned)(bh * nq)), dim3(kWarps * 32), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Tq, Tk, D, nq,
      scale * kLog2e, causal, drop);
  return cudaGetLastError();
}

// Head-dim buckets.  The default tile: fp32 runs 128-row blocks (8 warps:
// each K/V tile read from L2 serves twice the rows) except at D > 128,
// where it takes 64-row blocks and 32-key tiles to fit shared memory; bf16
// and fp16 run 64-row blocks (4 warps), which keep more blocks resident.
// Without dropout the other row count (`rows` 64 <-> 128, kWarps 4 <-> 8)
// is instantiated too, at the same key tile, where its shared memory fits
// (not fp32 at D > 128): the autotune site's candidates.  Each warp's 16
// rows run the same K/V tiles in the same order whatever the block's
// height, and a tile a causal block runs past a warp's last row is all
// masked for that warp (p = 0 adds exact zeros), so both heights give the
// same bits.  Key tiles stay one per bucket: another one would change the
// online softmax's partition and so the bits.  Dropout pins the default.
template <typename T, int kD, int kBlockN, int kWDef, bool kAlt, bool kDropout>
cudaError_t launch_rows(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int Tq, int Tk, int D,
                        float scale, int causal, int rows, Dropout drop,
                        cudaStream_t stream) {
  constexpr int kWAlt = 12 - kWDef;  // 8 <-> 4 warps
  if (rows == kWDef * 16)
    return launch<T, kD, kBlockN, kWDef, kDropout>(
        q, k, v, o, lse, bh, Tq, Tk, D, scale, causal, drop, stream);
  if constexpr (kAlt && !kDropout) {
    if (rows == kWAlt * 16)
      return launch<T, kD, kBlockN, kWAlt, kDropout>(
          q, k, v, o, lse, bh, Tq, Tk, D, scale, causal, drop, stream);
  }
  return cudaErrorInvalidValue;  // a row count that was not compiled
}

template <typename T, bool kDropout>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int Tq, int Tk, int D, float scale,
                     int causal, int rows, Dropout drop, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kW = kF32 ? 8 : 4;
  if (D <= 32)
    return launch_rows<T, 32, 64, kW, true, kDropout>(
        q, k, v, o, lse, bh, Tq, Tk, D, scale, causal, rows, drop, stream);
  if (D <= 64)
    return launch_rows<T, 64, 64, kW, true, kDropout>(
        q, k, v, o, lse, bh, Tq, Tk, D, scale, causal, rows, drop, stream);
  if (D <= 128)
    return launch_rows<T, 128, 64, kW, true, kDropout>(
        q, k, v, o, lse, bh, Tq, Tk, D, scale, causal, rows, drop, stream);
  // D = 256: fp32 with 128 rows would need 266,240 bytes of shared memory
  return launch_rows<T, 256, kF32 ? 32 : 64, 4, !kF32, kDropout>(
      q, k, v, o, lse, bh, Tq, Tk, D, scale, causal, rows, drop, stream);
}

template <typename T>
cudaError_t dispatch_dropout(const void* q, const void* k, const void* v,
                             void* o, float* lse, int bh, int Tq, int Tk,
                             int D, float scale, int causal, int rows,
                             int dropout, Dropout drop, cudaStream_t stream) {
  return dropout ? dispatch<T, true>(q, k, v, o, lse, bh, Tq, Tk, D, scale,
                                     causal, rows, drop, stream)
                 : dispatch<T, false>(q, k, v, o, lse, bh, Tq, Tk, D, scale,
                                      causal, rows, drop, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes.  q/k/v/o: contiguous (B*H, T, D)
// of dtype 0 = float32, 1 = bfloat16 or 2 = float16; lse: (B*H, Tq) float32.
// rows: query rows a block, one of the compiled tiles (64 or 128; see
// dispatch); any other is refused.  dropout != 0 drops attention
// probabilities with the mask of flash_common.cuh (the address of the
// 64-bit seed in device memory, keep threshold, 1 / (1 - p)).  Launches on
// `stream` of `device` and returns cudaGetLastError() (0 on success).
extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int Tq, int Tk,
                            int D, float scale, int causal, int dtype,
                            int rows, int dropout,
                            const unsigned long long* seed,
                            unsigned int thresh, float inv_keep, int device,
                            void* stream) {
  if (D <= 0 || D > 256 || D % 8 != 0 || bh <= 0 || Tq <= 0 || Tk <= 0 ||
      (dropout && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  // rows are D * sizeof(T) bytes apart, a multiple of 16: the 16-byte
  // cp.async copies (and the paired stores of O) then need only aligned bases
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const Dropout drop{seed, thresh, inv_keep};
  if (dtype == 0)
    err = dispatch_dropout<float>(q, k, v, o, l, bh, Tq, Tk, D, scale, causal,
                                  rows, dropout, drop, s);
  else if (dtype == 1)
    err = dispatch_dropout<__nv_bfloat16>(q, k, v, o, l, bh, Tq, Tk, D, scale,
                                          causal, rows, dropout, drop, s);
  else if (dtype == 2)
    err = dispatch_dropout<__half>(q, k, v, o, l, bh, Tq, Tk, D, scale,
                                   causal, rows, dropout, drop, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
