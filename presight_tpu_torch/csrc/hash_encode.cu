// K1 hash_encode_fwd: multi-resolution hash-grid lookup + trilinear blend.
//
// Replaces presight_tpu/ops/hash_encoding.py::hash_encode (:343-422) with
// _raw_hash (:322-334), trilerp_weights (:312-319) and the row gather of
// _gather_rows (:294-309) -- the XLA formulation that stands in for
// tiny-cuda-nn's HashGrid. All three table layouts:
//   storage 0 'corner': 8 gathers of an F-wide row per (sample, level),
//                       corners hashed from floor/ceil coordinates;
//   storage 1 'cell'  : one 8F-wide row per (sample, level), hashed on the
//                       floor coordinate, corner-major [c0: F | c1: F | ...];
//   storage 2 'shared': like 'cell' with one table per level shared by all
//                       experts; the expert id is XOR-mixed into the hash.
//
// What bounds it on an H100: random row reads. On the main path a chunk
// reads ~1.58M padded samples x 4 levels x a 320-byte row (~2 GB) from a
// 168-MB table set, and does ~10 FLOPs per byte read, so it is bound by
// device memory and L2 traffic, not arithmetic.
//
// Design: one thread per (sample, level, feature). The F threads of one
// (sample, level) are adjacent in the warp, so for each corner they read F
// consecutive floats of the same row together: a row costs its own 32-byte
// sectors once and nothing more. Output writes are fully coalesced (the
// output index is the thread index). Hash arithmetic is recomputed per
// feature; it is a handful of integer ops against a ~300 ns row fetch.
// Hazards kept from the reference: `scaled` is an explicitly rounded
// product (__fmul_rn), so the compiler cannot fuse p*s - floor(p*s) into an
// FMA and move a sample into another cell; 'corner' uses ceilf(scaled),
// which differs from floor+1 at integer coordinates; the hash wraps in
// uint32 exactly like the reference's masked int64 arithmetic.
#include "common.cuh"

namespace {

__global__ void hash_encode_fwd_kernel(const float* __restrict__ pos,
                                       const int32_t* __restrict__ expert,
                                       LevelTables t, int64_t n, int L, int F,
                                       uint32_t mask, int storage,
                                       int64_t expert_stride_rows,
                                       float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * L * F) return;
  const int f = (int)(i % F);
  const int64_t nl = i / F;
  const int l = (int)(nl % L);
  const int64_t s = nl / L;

  const float scale = t.scale[l];
  const float x = __fmul_rn(pos[s * 3 + 0], scale);
  const float y = __fmul_rn(pos[s * 3 + 1], scale);
  const float z = __fmul_rn(pos[s * 3 + 2], scale);
  const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
  const float ox = __fsub_rn(x, fx), oy = __fsub_rn(y, fy), oz = __fsub_rn(z, fz);
  const uint32_t ix = (uint32_t)(int32_t)fx;
  const uint32_t iy = (uint32_t)(int32_t)fy;
  const uint32_t iz = (uint32_t)(int32_t)fz;
  const int32_t e = expert != nullptr ? expert[s] : 0;
  const float* __restrict__ table = t.table[l];

  float acc = 0.0f;
  if (storage == 0) {
    const uint32_t cx = (uint32_t)(int32_t)ceilf(x);
    const uint32_t cy = (uint32_t)(int32_t)ceilf(y);
    const uint32_t cz = (uint32_t)(int32_t)ceilf(z);
    const int64_t base = (int64_t)e * expert_stride_rows;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t h = raw_hash(corner_bit_x(c) ? cx : ix, corner_bit_y(c) ? cy : iy,
                                  corner_bit_z(c) ? cz : iz) & mask;
      acc += __ldg(table + (base + h) * F + f) * corner_weight(c, ox, oy, oz);
    }
  } else {
    uint32_t h = raw_hash(ix, iy, iz);
    int64_t base = 0;
    if (storage == 2) {
      if (expert != nullptr) h ^= (uint32_t)e * kExpertPrime;
    } else {
      base = (int64_t)e * expert_stride_rows;
    }
    const float* __restrict__ row = table + (base + (h & mask)) * (8 * F);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc += __ldg(row + c * F + f) * corner_weight(c, ox, oy, oz);
    }
  }
  out[i] = acc;
}

}  // namespace

// tables: host array of L device pointers (level l's first row); scales:
// host array of L floats. expert may be null (single-expert table).
PTK_EXPORT int hash_encode_fwd(const float* pos, const int32_t* expert,
                               const void* const* tables, const float* scales,
                               int64_t n, int L, int F, int log2_table_size,
                               int storage, int64_t expert_stride_rows,
                               float* out, void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  LevelTables t;
  for (int l = 0; l < L; ++l) {
    t.table[l] = static_cast<const float*>(tables[l]);
    t.scale[l] = scales[l];
  }
  const uint32_t mask = (uint32_t)((1ull << log2_table_size) - 1ull);
  const int threads = 256;
  hash_encode_fwd_kernel<<<ceil_div64(n * L * F, threads), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      pos, expert, t, n, L, F, mask, storage, expert_stride_rows, out);
  return (int)cudaGetLastError();
}
