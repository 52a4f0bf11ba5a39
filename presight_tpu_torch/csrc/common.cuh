// Shared declarations of the port's CUDA kernels (plain C interface, loaded
// with ctypes; no PyTorch headers).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PTK_EXPORT extern "C" __attribute__((visibility("default")))

// The 8 trilinear corners in the reference's enumeration order
// (presight_tpu/ops/hash_encoding.py _CORNER_BITS; bit 1 picks the +1 corner
// on that axis), packed as one bit per corner and axis:
//   c : 0 1 2 3 4 5 6 7
//   x : 1 1 0 0 1 1 0 0  -> 0x33
//   y : 1 0 0 1 1 0 0 1  -> 0x99
//   z : 1 1 1 1 0 0 0 0  -> 0x0F
__device__ __forceinline__ int corner_bit_x(int c) { return (0x33 >> c) & 1; }
__device__ __forceinline__ int corner_bit_y(int c) { return (0x99 >> c) & 1; }
__device__ __forceinline__ int corner_bit_z(int c) { return (0x0F >> c) & 1; }

// Trilinear weight of corner c for in-cell offsets (ox, oy, oz), multiplied
// in the reference's order ((wx * wy) * wz).
__device__ __forceinline__ float corner_weight(int c, float ox, float oy, float oz) {
  const float wx = corner_bit_x(c) ? ox : __fsub_rn(1.0f, ox);
  const float wy = corner_bit_y(c) ? oy : __fsub_rn(1.0f, oy);
  const float wz = corner_bit_z(c) ? oz : __fsub_rn(1.0f, oz);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

static inline unsigned int ceil_div64(int64_t a, int64_t b) {
  return (unsigned int)((a + b - 1) / b);
}

// ---- asynchronous copies into shared memory (K2, K2b, K3b, K5) ----

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending));
}

// ---- hash grid (K1, K1b) ----

constexpr int kMaxLevels = 16;

struct LevelTables {
  const float* table[kMaxLevels];  // level l's first row
  float scale[kMaxLevels];         // level resolution (HashEncodingConfig.scalings)
};

__device__ __forceinline__ uint32_t raw_hash(uint32_t x, uint32_t y, uint32_t z) {
  return (x * 1u) ^ (y * 2654435761u) ^ (z * 805459861u);
}

constexpr uint32_t kExpertPrime = 3674653429u;

// ---- grouped MLP (K2, K2b) ----

constexpr int kMaxLayers = 4;
constexpr int kTile = 64;  // a CUDA block's rows are a multiple of it, inside one expert block

struct MlpLayers {
  const float* w[kMaxLayers];  // (E, in, out)
  const float* b[kMaxLayers];  // (E, out)
  int dim[kMaxLayers + 1];     // dim[0] = in, dim[l + 1] = out of layer l
  int n_layers;
};

// ---- per-ray warp scans (K3, K3b) ----

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}
