// K1b hash_encode_bwd: the cotangent rows and keys of the hash-table
// gradient, per (sample, level) -- the first half of K1's backward.
//
// Replaces the transpose of the row gather in
// presight_tpu/ops/hash_encoding.py::_gather_rows (:294-309), which XLA
// emits as a scatter-add, and the sort-then-scatter of
// _gather_rows_sorted_grad (:181-213). The port does the same
// sort-then-reduce: this kernel writes (key, row) pairs, torch.sort orders
// the keys stably, and K5 (sorted_accum.cu) reads the rows through the
// sort's permutation and adds each run to the gradient. For a table gradient
// dT[key] += w_c * g[sample, level, :]:
//   storage 0 'corner': 8 rows of F per (sample, level), key
//                       e * L * T + l * T + hash(corner) (ceil corners);
//   storage 1 'cell'  : one 8F row [w_0 g | ... | w_7 g] per (sample,
//                       level), key e * L * T + l * T + hash(floor);
//   storage 2 'shared': as 'cell' with key l * T + (hash ^ expert mix); K5
//                       adds key l * T + row to row `row` of level l's
//                       table gradient.
// The cell, its index and the trilinear weights come from hash_cell
// (common.cuh), which K1 uses too, so the keys name the rows K1 read.
//
// What bounds it on an H100: device memory. It reads 16 B of position and
// expert id and F floats of upstream gradient per (sample, level) and
// writes 8F floats and a key: an 8x expansion of g, written once,
// coalesced. The arithmetic is a handful of integer and float ops.
//
// Design: one thread per (sample, level, feature): the F threads
// of one (sample, level) sit side by side, so for each corner c they write
// F consecutive floats of the row; the thread of feature 0 writes the key.
#include "common.cuh"

namespace {

__global__ void hash_encode_bwd_kernel(const float* __restrict__ pos,
                                       const int32_t* __restrict__ expert,
                                       const float* __restrict__ grad, LevelTables t, int64_t n,
                                       int L, int F, int log2T, int storage,
                                       int32_t* __restrict__ keys, float* __restrict__ rows) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * L * F) return;
  const int f = (int)(i % F);
  const int64_t nl = i / F;
  const int l = (int)(nl % L);
  const int64_t s = nl / L;
  const uint32_t mask = (uint32_t)((1ull << log2T) - 1ull);
  const int64_t T = (int64_t)1 << log2T;

  const int32_t e = expert != nullptr ? expert[s] : 0;
  const HashCell cell = hash_cell(pos + s * 3, t.scale[l], storage, expert != nullptr, e, mask);
  const float g = grad[i];  // grad is (n, L * F): its index is the thread's

  if (storage == 0) {
    const int64_t base = ((int64_t)e * L + l) * T;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int64_t r = nl * 8 + c;
      rows[r * F + f] = __fmul_rn(corner_weight(c, cell.ox, cell.oy, cell.oz), g);
      if (f == 0) keys[r] = (int32_t)(base + cell.row[c]);
    }
  } else {
    float* __restrict__ row = rows + nl * (8 * F);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      row[c * F + f] = __fmul_rn(corner_weight(c, cell.ox, cell.oy, cell.oz), g);
    }
    if (f == 0) {
      const int64_t base = (int64_t)l * T + (storage == 1 ? (int64_t)e * L * T : 0);
      keys[nl] = (int32_t)(base + cell.row[0]);
    }
  }
}

}  // namespace

// scales: host array of L floats; expert may be null. grad (n, L * F);
// keys (n * L) or (n * L * 8) for 'corner'; rows (n * L, 8F) or
// (n * L * 8, F).
PTK_EXPORT int hash_encode_bwd(const float* pos, const int32_t* expert, const float* grad,
                               const float* scales, int64_t n, int L, int F,
                               int log2_table_size, int storage, int32_t* keys, float* rows,
                               void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  LevelTables t;
  for (int l = 0; l < L; ++l) {
    t.table[l] = nullptr;
    t.scale[l] = scales[l];
  }
  const int threads = 256;
  hash_encode_bwd_kernel<<<ceil_div64(n * L * F, threads), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      pos, expert, grad, t, n, L, F, log2_table_size, storage, keys, rows);
  return (int)cudaGetLastError();
}
