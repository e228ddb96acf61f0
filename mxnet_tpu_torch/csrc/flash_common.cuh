// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// conversion from fp32 to the input type, the mask value, and the
// attention-dropout mask.
//
// The dropout mask replaces mxnet_tpu/ops/pallas_attention.py:_tile_keep_mask,
// which seeds the TPU's generator per (seed, bh, q-block, k-block) tile.  Here
// the keep bit of one attention probability is a counter-based hash of the
// ABSOLUTE (seed, bh, query row, key column), so the mask does not depend on
// the tile sizes, and the forward, dq and dk/dv kernels regenerate exactly the
// same bits without storing any:
//     bh_key  = f(f(f(lo32(seed) ^ G) ^ hi32(seed)) ^ bh)
//     row_key = f(bh_key ^ row)
//     bits    = f(row_key + col * G)            (all arithmetic mod 2^32)
// with f the murmur3 32-bit finaliser and G = 0x9e3779b9.  A probability is
// kept when bits < uint32((1 - p) * (2^32 - 1)), the TPU kernel's threshold.
// mxnet_tpu_torch/ops/flash_attention.py:dropout_keep_mask computes the same
// bits with integer tensor ops; the tests and chip_smoke.py hold the two
// together.  The seed lives in device memory (Dropout::seed).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxflash {

constexpr float kNegInf = -1e30f; // the TPU kernels' mask value
constexpr uint32_t kGolden = 0x9e3779b9u;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// ---- dropout mask ---------------------------------------------------------
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}
__device__ __forceinline__ uint32_t drop_bh_key(unsigned long long seed,
                                                uint32_t bh) {
  uint32_t h = fmix32((uint32_t)seed ^ kGolden);
  h = fmix32(h ^ (uint32_t)(seed >> 32));
  return fmix32(h ^ bh);
}
__device__ __forceinline__ uint32_t drop_row_key(uint32_t bh_key, int row) {
  return fmix32(bh_key ^ (uint32_t)row);
}
__device__ __forceinline__ bool drop_keep(uint32_t row_key, int col,
                                          uint32_t thresh) {
  return fmix32(row_key + (uint32_t)col * kGolden) < thresh;
}

// Dropout parameters handed from the host: the seed's address in device
// memory (read by the kernel, so a launch captured into a CUDA graph sees
// the seed its replay drew), the keep threshold and 1 / (1 - p).
struct Dropout {
  const unsigned long long* seed;
  uint32_t thresh;
  float inv_keep;
};

__device__ __forceinline__ uint32_t drop_bh_key(const Dropout& drop,
                                                uint32_t bh) {
  return drop_bh_key(__ldg(drop.seed), bh);
}

}  // namespace mxflash
