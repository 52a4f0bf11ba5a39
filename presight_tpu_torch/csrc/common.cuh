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

// Dynamic shared memory a block may use on an H100.
constexpr int kSmemLimit = 232448;

// Advance a flattened (row, column) index of rows of width w by 32:
// row += 32 / w (q), col += 32 % w (rem), carrying into the row.
__device__ __forceinline__ void step32(int& row, int& col, int q, int rem, int w) {
  row += q;
  col += rem;
  if (col >= w) {
    col -= w;
    ++row;
  }
}

// ---- asynchronous copies into shared memory (K1, K2, K2b, K3, K3b, K5) ----

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

// The cell of one (sample, level): in-cell offsets (the trilinear weights'
// inputs) and masked hashes -- row[0] the cell's row ('cell', 'shared';
// the expert id XOR-mixed in for 'shared'), or row[c] corner c's ('corner').
struct HashCell {
  float ox, oy, oz;
  uint32_t row[8];
};

// K1 and K1b both find a sample's cell here, so they cannot drift apart.
// Hazards kept from the reference: `scaled` is an explicitly rounded product
// (__fmul_rn), so the compiler cannot fuse p*s - floor(p*s) into an FMA and
// move a sample into another cell; 'corner' uses ceilf(scaled), which
// differs from floor+1 at integer coordinates; the hash wraps in uint32
// exactly like the reference's masked int64 arithmetic.
__device__ __forceinline__ HashCell hash_cell(const float* __restrict__ p, float scale,
                                              int storage, bool mix_expert, int32_t e,
                                              uint32_t mask) {
  HashCell cell;
  const float x = __fmul_rn(p[0], scale);
  const float y = __fmul_rn(p[1], scale);
  const float z = __fmul_rn(p[2], scale);
  const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
  cell.ox = __fsub_rn(x, fx);
  cell.oy = __fsub_rn(y, fy);
  cell.oz = __fsub_rn(z, fz);
  const uint32_t ix = (uint32_t)(int32_t)fx;
  const uint32_t iy = (uint32_t)(int32_t)fy;
  const uint32_t iz = (uint32_t)(int32_t)fz;
  if (storage == 0) {
    const uint32_t cx = (uint32_t)(int32_t)ceilf(x);
    const uint32_t cy = (uint32_t)(int32_t)ceilf(y);
    const uint32_t cz = (uint32_t)(int32_t)ceilf(z);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      cell.row[c] = raw_hash(corner_bit_x(c) ? cx : ix, corner_bit_y(c) ? cy : iy,
                             corner_bit_z(c) ? cz : iz) & mask;
    }
  } else {
    uint32_t h = raw_hash(ix, iy, iz);
    if (storage == 2 && mix_expert) h ^= (uint32_t)e * kExpertPrime;
    cell.row[0] = h & mask;
  }
  return cell;
}

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
