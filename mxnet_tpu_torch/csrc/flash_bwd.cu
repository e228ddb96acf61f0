// Flash-attention backward for Hopper (sm_90a) on the tensor cores, fp32,
// bf16 and fp16 inputs: the dq kernel and the dk/dv kernel.
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
// the result is deterministic; the price is that both recompute s and dp
// (14*D operations a (query, key) pair against 10*D for one fused pass).
//
// Bounds on an H100 SXM at the BERT-base training shape B=8, H=12, T=512,
// D=64: dq does 6*D operations a pair (S, dP, dQ), 9.7 GFLOP, and dk/dv 8*D
// (S, dP, dV, dK), 12.9 GFLOP, against ~25 MB of bytes each (8 us in fp32):
// both are bound by operations.  On the TF32 tensor cores with the three
// products of 3xTF32 (495 TFLOP/s) that is 0.059 and 0.078 ms; in bf16 (989
// TFLOP/s) 0.010 and 0.013 ms, near the bytes.
//
// Design: FlashAttention-2's backward on mma.sync, with the forward's
// helpers and fragment layouts (flash_fwd.cu, flash_mma.cuh).
//  - dk/dv kernel: a block owns (b*h, a tile of 16*kWarps keys); each warp
//    owns 16 keys, the m16 of the MMA, and keeps dK and dV in fp32
//    accumulators.  Tiles of kBlockM queries of Q and dO, with their LSE and
//    delta, stream through a two-stage cp.async ring from the causal start
//    `lo` (pallas_attention.py:357).  Each step works in the transposed
//    (key x query) layout: S^T = K Q^T, P^T = exp(S^T - lse[col]), dP^T =
//    V dO^T, dS^T = P^T (m dP^T - delta[col]), dV += (P^T keep) dO (the
//    1 / (1 - p) of m applied to dV at the end) and dK += dS^T Q.  LSE and delta are indexed by the accumulator's column, so a
//    thread reads them for its columns 2t, 2t+1 from shared memory; the
//    dropout row key belongs to the query, so a thread hashes it once a tile
//    for each of its columns.  At D = 256 the two accumulators (256 floats a
//    thread) do not fit in registers: the block makes two passes over the
//    queries, each owning 128 of the output columns (S^T and dP^T are
//    recomputed).
//  - dq kernel: a block owns (b*h, a tile of 16*kWarps queries); each warp
//    owns 16 query rows and keeps dQ in fp32.  K and V tiles stream through
//    the ring, stopping at the diagonal when causal.  S = Q K^T, dP = dO
//    V^T, P = exp(S - lse[row]) (the LSE is known: no online softmax), dS =
//    P (m dP - delta[row]), dQ += dS K, scaled once at the end.
//  - Products: S and dP are the forward's Q K^T (A from the warp's 16 rows,
//    B from a tile read row-wise: mma_abt); dV, dK and dQ are its P V (the
//    accumulator becomes the A fragment, B is read down the tile's rows:
//    mma_pb).  bf16 and fp16: m16n8k16 with ldmatrix (ldmatrix.trans for
//    mma_pb), P keep and dS rounded to the input type as they are packed.
//    fp32: 3xTF32 on m16n8k8
//    (1xTF32 misses the 1e-4 gate), with the forward's relabelling inside
//    each 8-wide slab (physical column 2t is k = t, 2t+1 is k = t+4) so the
//    accumulator feeds the A fragment with no shuffle.
//  - K/V (dk/dv kernel) and Q/dO (dq kernel) stay in shared memory for the
//    whole block and their A fragments are re-read each tile: the fp32
//    accumulators leave no registers to hold them.  Row strides D+4 floats /
//    D+8 bf16 spread fragment loads over all banks.  Rows past Tq or Tk are
//    zero-filled by the copies (src-size 0) and masked; LSE and delta rows
//    start at bh*Tq*4 bytes, not always 16-aligned, so they come in 4-byte
//    copies.  The host pads nothing.  Head dims by bucket 32/64/128/256,
//    the columns past D zero.
#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace mxflash;

constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int kD>
struct Tile {
  static constexpr int kLd = kD + (std::is_same<T, float>::value ? 4 : 8);
  static constexpr int kE = 16 / (int)sizeof(T);  // elements a 16-byte copy
};

// Rows row0.. of a (rows, D) matrix into a tile of row stride kLd; rows at
// or past `valid` are zero-filled.  Columns D..kD are not written.
template <typename T, int kD, int kThreads>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int row0,
                                          int nrows, int valid, int D,
                                          int tid) {
  constexpr int kLd = Tile<T, kD>::kLd, kE = Tile<T, kD>::kE;
  constexpr int kChunks = kD / kE;
  for (int i = tid; i < nrows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kE, row = row0 + r;
    if (c < D) {
      const bool ok = row < valid;
      cp_async_16(dst + r * kLd + c, src + (size_t)(ok ? row : 0) * D + c,
                  ok ? 16 : 0);
    }
  }
}

// n floats src[row0..] into dst; at or past `valid` zero.
template <int kThreads>
__device__ __forceinline__ void copy_floats(float* dst, const float* src,
                                            int row0, int n, int valid,
                                            int tid) {
  for (int i = tid; i < n; i += kThreads) {
    const bool ok = row0 + i < valid;
    cp_async_4(dst + i, src + (ok ? row0 + i : 0), ok ? 4 : 0);
  }
}

// Columns D..kD of `rows` consecutive tile rows, zeroed once a block: the
// copies never write them.
template <typename T, int kD, int kThreads>
__device__ __forceinline__ void zero_pad(T* base, int rows, int D, int tid) {
  if (D < kD) {
    const int pad = kD - D;
    for (int i = tid; i < rows * pad; i += kThreads)
      base[(i / pad) * Tile<T, kD>::kLd + D + i % pad] = from_float<T>(0.f);
  }
}

// s[nt] += A B^T for one warp: A the 16 rows at sA, B the 8*kNT rows at sB,
// both kD wide with the tile stride (the forward's S = Q K^T).
template <typename T, int kD, int kNT>
__device__ __forceinline__ void mma_abt(float (*s)[4], const T* sA,
                                        const T* sB, int lane) {
  constexpr int kLd = Tile<T, kD>::kLd;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks) {
      const float* pa = sA + g * kLd + ks * 8 + t;
      uint32_t a_hi[4], a_lo[4];
      split_tf32(pa[0], a_hi[0], a_lo[0]);
      split_tf32(pa[8 * kLd], a_hi[1], a_lo[1]);
      split_tf32(pa[4], a_hi[2], a_lo[2]);
      split_tf32(pa[8 * kLd + 4], a_hi[3], a_lo[3]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float* pb = sB + (nt * 8 + g) * kLd + ks * 8 + t;
        uint32_t b_hi[2], b_lo[2];
        split_tf32(pb[0], b_hi[0], b_lo[0]);
        split_tf32(pb[4], b_hi[1], b_lo[1]);
        mma_3xtf32(s[nt], a_hi, a_lo, b_hi, b_lo);
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, sA + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                         ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n2 = 0; n2 < kNT / 2; ++n2) {
        uint32_t b[4];
        ldmatrix_x4(b, sB + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                           ks * 16 + ((lane >> 3) & 1) * 8);
        mma16<T>(s[2 * n2], a, b);
        mma16<T>(s[2 * n2 + 1], a, b + 2);
      }
    }
  }
}

// acc[dt] += P B for one warp: P is 16 x 8*kKT in the accumulator layout
// (p[j] its 8-wide column tile j), B the 8*kKT rows at sB, of which the
// 8*kDT columns from sB's first (the forward's O += P V).
template <typename T, int kD, int kKT, int kDT>
__device__ __forceinline__ void mma_pb(float (*acc)[4], const float (*p)[4],
                                       const T* sB, int lane) {
  constexpr int kLd = Tile<T, kD>::kLd;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j8 = 0; j8 < kKT; ++j8) {
      // P's columns relabelled within the slab: physical 2t -> k = t,
      // 2t+1 -> k = t+4; B's rows follow the same relabelling
      uint32_t a_hi[4], a_lo[4];
      split_tf32(p[j8][0], a_hi[0], a_lo[0]);
      split_tf32(p[j8][2], a_hi[1], a_lo[1]);
      split_tf32(p[j8][1], a_hi[2], a_lo[2]);
      split_tf32(p[j8][3], a_hi[3], a_lo[3]);
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const float* pb = sB + (j8 * 8 + 2 * t) * kLd + dt * 8 + g;
        uint32_t b_hi[2], b_lo[2];
        split_tf32(pb[0], b_hi[0], b_lo[0]);
        split_tf32(pb[kLd], b_hi[1], b_lo[1]);
        mma_3xtf32(acc[dt], a_hi, a_lo, b_hi, b_lo);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kKT / 2; ++kk) {
      const uint32_t a[4] = {pack2<T>(p[2 * kk][0], p[2 * kk][1]),
                             pack2<T>(p[2 * kk][2], p[2 * kk][3]),
                             pack2<T>(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack2<T>(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < kDT / 2; ++d2) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, sB + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                   d2 * 16 + (lane >> 4) * 8);
        mma16<T>(acc[2 * d2], a, b);
        mma16<T>(acc[2 * d2 + 1], a, b + 2);
      }
    }
  }
}

template <int kN>
__device__ __forceinline__ void zero_acc(float (*a)[4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// ---- dk/dv ----------------------------------------------------------------
// Shared memory: K and V (16 rows a warp), a two-stage ring of Q and dO
// tiles (kBlockM rows each), all with the tile stride, then the ring's LSE
// and delta (kBlockM floats a stage each).
template <typename T, int kD, int kBlockM, int kWarps>
struct DkvSmem {
  static constexpr int kKV = kWarps * 16 * Tile<T, kD>::kLd;  // K or V
  static constexpr int kQO = kBlockM * Tile<T, kD>::kLd;  // a Q or dO stage
  static constexpr int kRows = 2 * kWarps * 16 + 4 * kBlockM;
  static constexpr size_t kBytes =
      (size_t)(2 * kKV + 4 * kQO) * sizeof(T) + 4 * kBlockM * sizeof(float);
};

// kD: head-dim bucket (D <= kD, a multiple of 8); kBlockM queries a tile;
// kWarps: warps a block, 16 keys each; kDropout: a separate instance, so the
// kernel without dropout carries none of its instructions.
template <typename T, int kD, int kBlockM, int kWarps, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Tq, int Tk, int D, int nkb,
                     float scale, float scale_log2, int causal,
                     Dropout drop) {
  constexpr int kThreads = kWarps * 32, kBlockN = kWarps * 16;
  using SM = DkvSmem<T, kD, kBlockM, kWarps>;
  constexpr int kLd = Tile<T, kD>::kLd;
  constexpr int kNT = kBlockM / 8;          // 8-query tiles of S^T
  static_assert(4 * kNT <= 32, "one keep bit a tile element");
  constexpr int kDC = kD < 128 ? kD : 128;  // dK/dV columns a pass
  constexpr int kDT = kDC / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + SM::kKV;
  T* sQ = sV + SM::kKV;      // [2][kBlockM][kLd]
  T* sO = sQ + 2 * SM::kQO;  // [2][kBlockM][kLd]
  float* sL = reinterpret_cast<float*>(sO + 2 * SM::kQO);  // [2][kBlockM]
  float* sDl = sL + 2 * kBlockM;                           // [2][kBlockM]

  const int bh = blockIdx.x / nkb;
  const int k0 = (blockIdx.x - bh * nkb) * kBlockN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;  // first tile key of this warp
  const T* qb = q + (size_t)bh * Tq * D;
  const T* ob = dout + (size_t)bh * Tq * D;
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;

  zero_pad<T, kD, kThreads>(sK, SM::kRows, D, tid);
  copy_rows<T, kD, kThreads>(sK, k + (size_t)bh * Tk * D, k0, kBlockN, Tk,
                             D, tid);
  copy_rows<T, kD, kThreads>(sV, v + (size_t)bh * Tk * D, k0, kBlockN, Tk,
                             D, tid);
  const auto load_q = [&](int stage, int q0) {
    copy_rows<T, kD, kThreads>(sQ + stage * SM::kQO, qb, q0, kBlockM, Tq, D,
                               tid);
    copy_rows<T, kD, kThreads>(sO + stage * SM::kQO, ob, q0, kBlockM, Tq, D,
                               tid);
    copy_floats<kThreads>(sL + stage * kBlockM, lb, q0, kBlockM, Tq, tid);
    copy_floats<kThreads>(sDl + stage * kBlockM, db, q0, kBlockM, Tq, tid);
  };

  const int nq = (Tq + kBlockM - 1) / kBlockM;
  // causal: query tiles wholly before this key tile see none of its keys
  const int lo = causal ? min(k0 / kBlockM, nq) : 0;
  const int key_a = k0 + m0 + g, key_b = key_a + 8;  // accumulator rows
  const uint32_t bh_key = kDropout ? drop_bh_key(drop, bh) : 0u;

  for (int c0 = 0; c0 < D; c0 += kDC) {
    float acc_k[kDT][4], acc_v[kDT][4];
    zero_acc<kDT>(acc_k);
    zero_acc<kDT>(acc_v);
    if (c0 > 0) __syncthreads();  // the last pass is done with the ring
    if (lo < nq) load_q(0, lo * kBlockM);
    cp_async_commit();

    for (int i = lo; i < nq; ++i) {
      const int q0 = i * kBlockM, stage = (i - lo) & 1;
      cp_async_wait_all();  // this thread's copies of tile i landed
      __syncthreads();     // ... every thread's, and tile i-1 is done with
      if (i + 1 < nq) {    // so tile i+1 streams in meanwhile
        load_q(stage ^ 1, q0 + kBlockM);
        cp_async_commit();
      }
      // causal: every query of the tile before every key of the warp
      if (causal && q0 + kBlockM - 1 < k0 + m0) continue;
      const T* tQ = sQ + stage * SM::kQO;
      const T* tO = sO + stage * SM::kQO;
      const float* tL = sL + stage * kBlockM;
      const float* tDl = sDl + stage * kBlockM;

      float s[kNT][4], dp[kNT][4];
      zero_acc<kNT>(s);
      mma_abt<T, kD, kNT>(s, sK + m0 * kLd, tQ, lane);  // S^T = K Q^T

      // P^T into s at the true (key, query), and the dropout keep bits of
      // the tile's 4*kNT elements into `keep` before dP^T needs registers
      const bool edge = q0 + kBlockM > Tq || (causal && q0 < k0 + m0 + 15);
      uint32_t keep = 0u;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = q0 + nt * 8 + 2 * t;  // this thread's queries
        const float2 l2 =
            *reinterpret_cast<const float2*>(tL + nt * 8 + 2 * t);
        const float lq[2] = {l2.x * kLog2e, l2.y * kLog2e};
        uint32_t rk[2] = {0u, 0u};
        if (kDropout) {
          rk[0] = drop_row_key(bh_key, col);
          rk[1] = drop_row_key(bh_key, col + 1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1, qi = col + c, ki = e < 2 ? key_a : key_b;
          float p = exp2f(fmaf(s[nt][e], scale_log2, -lq[c]));
          if (edge && (qi >= Tq || (causal && ki > qi))) p = 0.f;
          s[nt][e] = p;
          if (kDropout && drop_keep(rk[c], ki, drop.thresh))
            keep |= 1u << (4 * nt + e);
        }
      }

      zero_acc<kNT>(dp);
      mma_abt<T, kD, kNT>(dp, sV + m0 * kLd, tO, lane);  // dP^T = V dO^T
      // P^T keep into s, dS^T into dp
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(tDl + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[nt][e];
          float gd = dp[nt][e];
          if (kDropout) {
            const bool kept = (keep >> (4 * nt + e)) & 1u;
            s[nt][e] = kept ? p : 0.f;  // 1 / (1 - p): on dV at the end
            gd = kept ? gd * drop.inv_keep : 0.f;
          }
          dp[nt][e] = p * (gd - (e & 1 ? d2.y : d2.x));
        }
      }
      mma_pb<T, kD, kNT, kDT>(acc_v, s, tO + c0, lane);   // dV += P^T k dO
      mma_pb<T, kD, kNT, kDT>(acc_k, dp, tQ + c0, lane);  // dK += dS^T Q
    }
    cp_async_wait_all();  // (no tile at all: the K/V copies)

    const float vscale = kDropout ? drop.inv_keep : 1.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? key_b : key_a;
      if (row >= Tk) continue;
      T* krow = dk + ((size_t)bh * Tk + row) * D;
      T* vrow = dv + ((size_t)bh * Tk + row) * D;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const int col = c0 + dt * 8 + 2 * t;
        if (col < D) {
          store2(krow + col, acc_k[dt][2 * h] * scale,
                 acc_k[dt][2 * h + 1] * scale);
          store2(vrow + col, acc_v[dt][2 * h] * vscale,
                 acc_v[dt][2 * h + 1] * vscale);
        }
      }
    }
  }
}

// ---- dq -------------------------------------------------------------------
// Shared memory: Q and dO (16 rows a warp) and a two-stage ring of K and V
// tiles (kBlockN rows each), all with the tile stride.
template <typename T, int kD, int kBlockN, int kWarps>
struct DqSmem {
  static constexpr int kQO = kWarps * 16 * Tile<T, kD>::kLd;  // Q or dO
  static constexpr int kKV = kBlockN * Tile<T, kD>::kLd;  // a K or V stage
  static constexpr int kRows = 2 * kWarps * 16 + 4 * kBlockN;
  static constexpr size_t kBytes = (size_t)(2 * kQO + 4 * kKV) * sizeof(T);
};

// kD as above; kBlockN keys a tile; kWarps warps a block, 16 query rows
// each.
template <typename T, int kD, int kBlockN, int kWarps, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Tq, int Tk, int D, int nqb, float scale,
                    float scale_log2, int causal, Dropout drop) {
  constexpr int kThreads = kWarps * 32, kBlockM = kWarps * 16;
  using SM = DqSmem<T, kD, kBlockN, kWarps>;
  constexpr int kLd = Tile<T, kD>::kLd;
  constexpr int kNT = kBlockN / 8;  // 8-key tiles of S
  constexpr int kDT = kD / 8;       // 8-column tiles of dQ

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sO = sQ + SM::kQO;
  T* sK = sO + SM::kQO;      // [2][kBlockN][kLd]
  T* sV = sK + 2 * SM::kKV;  // [2][kBlockN][kLd]

  const int bh = blockIdx.x / nqb;
  const int q0 = (blockIdx.x - bh * nqb) * kBlockM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;  // first tile row of this warp
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;

  zero_pad<T, kD, kThreads>(sQ, SM::kRows, D, tid);
  copy_rows<T, kD, kThreads>(sQ, q + (size_t)bh * Tq * D, q0, kBlockM, Tq, D,
                             tid);
  copy_rows<T, kD, kThreads>(sO, dout + (size_t)bh * Tq * D, q0, kBlockM,
                             Tq, D, tid);
  const auto load_kv = [&](int stage, int k0) {
    copy_rows<T, kD, kThreads>(sK + stage * SM::kKV, kb, k0, kBlockN, Tk, D,
                               tid);
    copy_rows<T, kD, kThreads>(sV + stage * SM::kKV, vb, k0, kBlockN, Tk, D,
                               tid);
  };
  load_kv(0, 0);
  cp_async_commit();

  int nk = (Tk + kBlockN - 1) / kBlockN;
  if (causal) nk = min(nk, (q0 + kBlockM + kBlockN - 1) / kBlockN);

  // this thread's two query rows (accumulator rows g and g+8): LSE in log2
  // units, delta and the dropout row keys
  const int row[2] = {q0 + m0 + g, q0 + m0 + g + 8};
  float lr[2], dr[2];
  uint32_t rk[2] = {0u, 0u};
  const uint32_t bh_key = kDropout ? drop_bh_key(drop, bh) : 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row[h] < Tq;
    lr[h] = ok ? lse[(size_t)bh * Tq + row[h]] * kLog2e : 0.f;
    dr[h] = ok ? delta[(size_t)bh * Tq + row[h]] : 0.f;
    if (kDropout) rk[h] = drop_row_key(bh_key, row[h]);
  }
  float acc[kDT][4];
  zero_acc<kDT>(acc);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBlockN;
    cp_async_wait_all();  // this thread's copies of tile j (and Q, dO)
    __syncthreads();     // ... every thread's, and tile j-1 is done with
    if (j + 1 < nk) {
      load_kv((j + 1) & 1, k0 + kBlockN);
      cp_async_commit();
    }
    // causal: every key of the tile after every row of the warp
    if (causal && k0 > q0 + m0 + 15) continue;
    const T* tK = sK + (j & 1) * SM::kKV;
    const T* tV = sV + (j & 1) * SM::kKV;

    float s[kNT][4], dp[kNT][4];
    zero_acc<kNT>(s);
    zero_acc<kNT>(dp);
    mma_abt<T, kD, kNT>(s, sQ + m0 * kLd, tK, lane);   // S = Q K^T
    mma_abt<T, kD, kNT>(dp, sO + m0 * kLd, tV, lane);  // dP = dO V^T

    // dS into s, at the true (row, column)
    const bool edge = k0 + kBlockN > Tk ||
                      (causal && k0 + kBlockN - 1 > q0 + m0);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = k0 + nt * 8 + 2 * t + (e & 1);
        float p = exp2f(fmaf(s[nt][e], scale_log2, -lr[h]));
        if (edge && (col >= Tk || (causal && col > row[h]))) p = 0.f;
        float gd = dp[nt][e];
        if (kDropout)
          gd = drop_keep(rk[h], col, drop.thresh) ? gd * drop.inv_keep : 0.f;
        s[nt][e] = p * (gd - dr[h]);
      }
    }
    mma_pb<T, kD, kNT, kDT>(acc, s, tK, lane);  // dQ += dS K
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= Tq) continue;
    T* out = dq + ((size_t)bh * Tq + row[h]) * D;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < D)
        store2(out + col, acc[dt][2 * h] * scale, acc[dt][2 * h + 1] * scale);
    }
  }
}

// ---- launch ---------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq; or dk and dv
  int bh, Tq, Tk, D;
  float scale;
  int causal;
  Dropout drop;
};

template <typename T, int kD, int kBlockN, int kWarps, bool kDropout>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = DqSmem<T, kD, kBlockN, kWarps>::kBytes;
  const auto kern = flash_bwd_dq_kernel<T, kD, kBlockN, kWarps, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nqb = (a.Tq + kWarps * 16 - 1) / (kWarps * 16);
  kern<<<dim3((unsigned)(a.bh * nqb)), dim3(kWarps * 32), smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.Tq, a.Tk, a.D, nqb, a.scale,
      a.scale * kLog2e, a.causal, a.drop);
  return cudaGetLastError();
}

template <typename T, int kD, int kBlockM, int kWarps, bool kDropout>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const size_t smem = DkvSmem<T, kD, kBlockM, kWarps>::kBytes;
  const auto kern = flash_bwd_dkv_kernel<T, kD, kBlockM, kWarps, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nkb = (a.Tk + kWarps * 16 - 1) / (kWarps * 16);
  kern<<<dim3((unsigned)(a.bh * nkb)), dim3(kWarps * 32), smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.Tq, a.Tk, a.D, nkb,
      a.scale, a.scale * kLog2e, a.causal, a.drop);
  return cudaGetLastError();
}

// Tiles by head-dim bucket: the dq kernel's key tile, the dk/dv kernel's
// query tile and the warps a block; sized so that shared memory stays under
// the 227 KB a block may have and the fp32 accumulators in registers:
//   fp32 D <= 64: 64 and 8 warps for both (139 KB each at D = 64);
//   fp32 D = 128: dq 64, dk/dv 16, 4 warps (203 / 101 KB);
//   fp32 D = 256: 16, 4 warps (200 KB each);
//   bf16, fp16: dq 64 to D = 128 and 32 at D = 256; dk/dv 64 to D = 64
//   and 16 beyond, where the dK and dV accumulators take 128 registers; 4 warps.
template <typename T, bool kDkv, bool kDropout>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
#define MX_LAUNCH(kD, kDqN, kDkvM, kW)                                   \
  return kDkv ? launch_dkv<T, kD, kDkvM, kW, kDropout>(a, stream)        \
              : launch_dq<T, kD, kDqN, kW, kDropout>(a, stream)
  constexpr int kW = kF32 ? 8 : 4;
  if (a.D <= 32) MX_LAUNCH(32, 64, 64, kW);
  if (a.D <= 64) MX_LAUNCH(64, 64, 64, kW);
  if (a.D <= 128) MX_LAUNCH(128, 64, 16, 4);
  MX_LAUNCH(256, kF32 ? 16 : 32, 16, 4);
#undef MX_LAUNCH
}

template <bool kDkv>
int run(const Args& a, int dtype, int dropout, int device, void* stream) {
  if (a.D <= 0 || a.D > 256 || a.D % 8 != 0 || a.bh <= 0 || a.Tq <= 0 ||
      a.Tk <= 0 || (dropout && a.drop.seed == nullptr))
    return (int)cudaErrorInvalidValue;
  // rows are D * sizeof(T) bytes apart, a multiple of 16: the 16-byte
  // cp.async copies (and the paired stores) then need only aligned bases
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) |
       reinterpret_cast<uintptr_t>(a.dout) |
       reinterpret_cast<uintptr_t>(a.out0) |
       reinterpret_cast<uintptr_t>(a.out1)) & 15)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dropout ? dispatch<float, kDkv, true>(a, s)
                  : dispatch<float, kDkv, false>(a, s);
  else if (dtype == 1)
    err = dropout ? dispatch<__nv_bfloat16, kDkv, true>(a, s)
                  : dispatch<__nv_bfloat16, kDkv, false>(a, s);
  else if (dtype == 2)
    err = dropout ? dispatch<__half, kDkv, true>(a, s)
                  : dispatch<__half, kDkv, false>(a, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace

// Plain C entry points, bound with ctypes.  q/dout/dq: contiguous
// (B*H, Tq, D); k/v/dk/dv: (B*H, Tk, D), all of dtype 0 = float32,
// 1 = bfloat16 or 2 = float16, starting on a 16-byte boundary; lse, delta: (B*H, Tq)
// float32.  dropout != 0 regenerates the forward's mask from (the seed at
// `seed` in device memory, thresh) and scales kept terms by inv_keep.  Each launches on `stream` of
// `device` and returns cudaGetLastError() (0 on success).
extern "C" int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int Tq,
                               int Tk, int D, float scale, int causal,
                               int dtype, int dropout,
                               const unsigned long long* seed,
                               unsigned int thresh,
                               float inv_keep, int device, void* stream) {
  const Args a{q,  k,  v,  dout, lse,   delta,  dq,
               nullptr, bh, Tq, Tk, D, scale, causal,
               Dropout{seed, thresh, inv_keep}};
  return run<false>(a, dtype, dropout, device, stream);
}

extern "C" int mx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int bh, int Tq, int Tk, int D, float scale,
                                int causal, int dtype, int dropout,
                                const unsigned long long* seed,
                               unsigned int thresh,
                                float inv_keep, int device, void* stream) {
  const Args a{q,  k,  v,  dout, lse,   delta,  dk,    dv,
               bh, Tq, Tk, D,    scale, causal, Dropout{seed, thresh, inv_keep}};
  return run<true>(a, dtype, dropout, device, stream);
}
