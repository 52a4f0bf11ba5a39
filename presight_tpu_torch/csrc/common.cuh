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
