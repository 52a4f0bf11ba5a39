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
// 168-MB table set, and does ~10 FLOPs per byte read, so it is bound by the
// L2's bandwidth to the SMs and by the rows that miss the L2, not by
// arithmetic.
//
// Design (v2): a warp takes 32 (sample, level) pairs, one per lane. Each
// lane finds its pair's cell with hash_cell (common.cuh, shared with K1b:
// one hash per cell row, not per feature) and keeps the 8 trilinear
// weights in shared memory. Pairs of the warp that read the same row (the
// samples of a ray often share a coarse cell) share one copy
// (__match_any_sync). The warp then starts cp.async copies of its distinct
// rows into shared memory, all in flight at once: 16-byte copies where the
// rows are 16-byte aligned, as every 'cell'/'shared' row of 8F floats is,
// 4-byte copies otherwise; 10 KB a warp on the main field. The lanes then
// blend from shared memory over the flattened (pair, feature) index and
// write the output coalesced. The pairs are numbered sample-major (q = s *
// L + l), so a warp writes 32F consecutive floats. A level-major order (the
// blocks of one level together, so the L2 holds one level's table at a
// time, but each (sample, level) an F-float piece at a stride of L * F
// floats) was slower on every input measured (PERF.md).
#include "common.cuh"

namespace {

constexpr int kPairs = 32;    // (sample, level) pairs of a warp, one per lane
constexpr int kMaxWarps = 4;  // warps per CUDA block

// Shared memory of one warp in bytes: the staged rows (8F floats a row,
// corner-major like a 'cell' row), the 8 weights of each pair, the source of
// each row segment (8 corner rows for 'corner', one cell row otherwise), and
// each pair's staged row. Every part is a multiple of 16 bytes.
__host__ __device__ inline size_t warp_smem_bytes(int F, int segs) {
  return (size_t)kPairs * (8 * F + 8) * sizeof(float) + (size_t)kPairs * segs * sizeof(void*) +
         (size_t)kPairs * sizeof(int);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
hash_encode_fwd_kernel(const float* __restrict__ pos, const int32_t* __restrict__ expert,
                       LevelTables t, int64_t n, int L, int F, uint32_t mask, int storage,
                       int64_t expert_stride_rows, int vec, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int segs = storage == 0 ? 8 : 1;
  char* base = reinterpret_cast<char*>(smem4) + warp * warp_smem_bytes(F, segs);
  float* rows_s = reinterpret_cast<float*>(base);
  float* w_s = rows_s + kPairs * 8 * F;
  const float** src_s = reinterpret_cast<const float**>(w_s + kPairs * 8);
  int* slot_s = reinterpret_cast<int*>(src_s + kPairs * segs);

  const int64_t total = n * L;
  const int64_t q0 = ((int64_t)blockIdx.x * (blockDim.x / 32) + warp) * kPairs;
  if (q0 >= total) return;  // whole warps exit together; only __syncwarp below
  const int pairs = (int)min((int64_t)kPairs, total - q0);

  // 1. One cell, hash and set of weights per pair.
  const bool valid = lane < pairs;
  const float* src = nullptr;
  if (valid) {
    const int64_t q = q0 + lane;
    const int64_t s = q / L;
    const int l = (int)(q - s * L);
    const int32_t e = expert != nullptr ? expert[s] : 0;
    const HashCell cell = hash_cell(pos + s * 3, t.scale[l], storage, expert != nullptr, e, mask);
    float w[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) w[c] = corner_weight(c, cell.ox, cell.oy, cell.oz);
    reinterpret_cast<float4*>(w_s)[lane * 2] = make_float4(w[0], w[1], w[2], w[3]);
    reinterpret_cast<float4*>(w_s)[lane * 2 + 1] = make_float4(w[4], w[5], w[6], w[7]);
    const float* table = t.table[l];
    if (storage == 0) {
      const int64_t eb = (int64_t)e * expert_stride_rows;
#pragma unroll
      for (int c = 0; c < 8; ++c) src_s[lane * 8 + c] = table + (eb + cell.row[c]) * F;
    } else {
      const int64_t eb = storage == 1 ? (int64_t)e * expert_stride_rows : 0;
      src = table + (eb + cell.row[0]) * (8 * F);
    }
  }
  // Pairs that share a cell row share one staged copy.
  int rows = pairs;
  if (storage == 0) {
    slot_s[lane] = lane;
  } else {
    const unsigned same =
        __match_any_sync(kFullMask, (unsigned long long)reinterpret_cast<uintptr_t>(src));
    const int leader = __ffs(same) - 1;
    const unsigned leaders = __ballot_sync(kFullMask, valid && leader == lane);
    const int slot = __popc(leaders & ((1u << leader) - 1u));
    slot_s[lane] = slot;
    if (valid && leader == lane) src_s[slot] = src;
    rows = __popc(leaders);
  }
  __syncwarp();

  // 2. The distinct rows into shared memory, every copy in flight at once.
  const int per_pair = 8 * F / vec;  // copies of one row
  const int seg_w = 8 * F / segs;    // floats of one row segment
  {
    int p = lane / per_pair, k = lane % per_pair;
    const int q = 32 / per_pair, rem = 32 % per_pair;
    for (; p < rows; step32(p, k, q, rem, per_pair)) {
      const int o = k * vec;  // float offset in the row's 8F
      const float* from = segs == 1 ? src_s[p] + o : src_s[p * 8 + o / seg_w] + o % seg_w;
      float* dst = rows_s + p * 8 * F + o;
      if (vec == 4) {
        cp_async16(dst, from);
      } else {
        cp_async4(dst, from);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  // 3. Blend, lanes over (pair, feature): out = sum_c row[c * F + f] * w_c.
  int p = lane / F, f = lane % F;
  const int q = 32 / F, rem = 32 % F;
  for (; p < pairs; step32(p, f, q, rem, F)) {
    const float* row = rows_s + slot_s[p] * 8 * F + f;
    const float4 wa = reinterpret_cast<const float4*>(w_s)[p * 2];
    const float4 wb = reinterpret_cast<const float4*>(w_s)[p * 2 + 1];
    const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc += row[c * F] * w[c];
    out[(q0 + p) * F + f] = acc;
  }
}

}  // namespace

// tables: host array of L device pointers (level l's first row); scales:
// host array of L floats. expert may be null (single-expert table).
PTK_EXPORT int hash_encode_fwd(const float* pos, const int32_t* expert,
                               const void* const* tables, const float* scales,
                               int64_t n, int L, int F, int log2_table_size,
                               int storage, int64_t expert_stride_rows, float* out,
                               void* stream) {
  if (L < 1 || L > kMaxLevels || F < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  LevelTables t;
  // 16-byte row copies where every row starts 16-byte aligned: the level
  // pointers are, and a row is a multiple of 4 floats (8F for 'cell' and
  // 'shared', F for 'corner'); 4-byte copies otherwise.
  int vec = storage != 0 || F % 4 == 0 ? 4 : 1;
  for (int l = 0; l < L; ++l) {
    t.table[l] = static_cast<const float*>(tables[l]);
    t.scale[l] = scales[l];
    if (reinterpret_cast<uintptr_t>(tables[l]) % 16 != 0) vec = 1;
  }
  const uint32_t mask = (uint32_t)((1ull << log2_table_size) - 1ull);
  const size_t per_warp = warp_smem_bytes(F, storage == 0 ? 8 : 1);
  int warps = kMaxWarps;
  while (warps > 1 && warps * per_warp > (size_t)kSmemLimit) warps /= 2;
  if (warps * per_warp > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;  // F too large
  const size_t smem = warps * per_warp;
  cudaError_t err = cudaFuncSetAttribute(hash_encode_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  hash_encode_fwd_kernel<<<ceil_div64(n * L, (int64_t)warps * kPairs), warps * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      pos, expert, t, n, L, F, mask, storage, expert_stride_rows, vec, out);
  return (int)cudaGetLastError();
}
