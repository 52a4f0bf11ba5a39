// S1 bev_pool_fwd: lift-splat pooling of depth-weighted image features
// into the BEV voxel grid.
//
// Replaces no TPU kernel: the JAX package computes it with XLA
// (presight_tpu/occupancy/bev_pool.py:29 bev_pool_v2, one segment_sum over
// every frustum point with a dump row), standing in for the reference's
// own CUDA kernel bev_pool_v2 (occupancy/mmdet3d/ops/bev_pool_v2/src/
// bev_pool_cuda.cu:21-140), which this one follows: an interval sum over
// points sorted by voxel rank.
//
// Contract: point p of depth (B, N, D, H, W) (flat index p) adds
// depth[p] * feat[b, n, h, w, :] into voxel floor((coor[p] - lb) / iv) of
// the (B, C, Z, Y, X) output; points outside the (X, Y, Z) grid are
// dropped. Every output element is written once (empty voxels get 0), and
// each voxel sums its points in point order (the wrapper sorts the ranks
// stably), so two calls give bitwise equal results; no atomics.
//
// Three launches:
//   bev_pool_ranks  one thread a point: the voxel arithmetic, exactly the
//                   plain version's (floorf(__fsub_rn(c, lb) / iv) with IEEE
//                   division, no reciprocal), so a point on a voxel face
//                   lands where the plain version puts it; rank
//                   ((b * Z + z) * Y + y) * X + x, or B * Z * Y * X outside.
//   (torch.sort of the ranks, stable, in the wrapper)
//   starts          one thread a voxel (and one past the end): the first
//                   sorted position of its rank, by binary search over the
//                   sorted ranks (1.5 MB at the reference shapes: in L2).
//   sum             one thread per (voxel, 32-channel chunk), voxels
//                   fastest within a warp: it reads its interval of the
//                   permutation, sums depth * feat for its 32 channels in
//                   registers, and writes them, each channel plane's 32
//                   consecutive voxels of a warp in one coalesced store.
//
// What bounds it on an H100: device memory. The output is written once
// (81.9 MB at the reference shapes: 640,000 voxels x 32 channels) and
// dominates; depth, feat and coor are read once (7.6 MB).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // channels a thread of the sum kernel holds
constexpr unsigned int kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads) bev_pool_ranks_kernel(
    const float* __restrict__ coor, int64_t n, int64_t per_batch, float lbx, float lby, float lbz,
    float ivx, float ivy, float ivz, int gx, int gy, int gz, int32_t* __restrict__ ranks) {
  const int32_t dump = (int32_t)((n / per_batch) * gx * gy * gz);
  for (int64_t p = blockIdx.x * (int64_t)kThreads + threadIdx.x; p < n;
       p += (int64_t)gridDim.x * kThreads) {
    const float* c = coor + p * 3;
    const float vx = floorf(__fdiv_rn(__fsub_rn(c[0], lbx), ivx));
    const float vy = floorf(__fdiv_rn(__fsub_rn(c[1], lby), ivy));
    const float vz = floorf(__fdiv_rn(__fsub_rn(c[2], lbz), ivz));
    const bool inside = vx >= 0.0f && vx < (float)gx && vy >= 0.0f && vy < (float)gy &&
                        vz >= 0.0f && vz < (float)gz;
    const int b = (int)(p / per_batch);
    ranks[p] = inside ? ((b * gz + (int)vz) * gy + (int)vy) * gx + (int)vx : dump;
  }
}

__global__ void __launch_bounds__(kThreads) bev_pool_starts_kernel(
    const int32_t* __restrict__ sorted, int64_t n, int64_t cells, int32_t* __restrict__ starts) {
  for (int64_t v = blockIdx.x * (int64_t)kThreads + threadIdx.x; v <= cells;
       v += (int64_t)gridDim.x * kThreads) {
    int64_t lo = 0, hi = n;  // first position whose rank is >= v
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (sorted[mid] < v) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    starts[v] = (int32_t)lo;
  }
}

__global__ void __launch_bounds__(kThreads) bev_pool_sum_kernel(
    const float* __restrict__ depth, const float* __restrict__ feat,
    const int64_t* __restrict__ order, const int32_t* __restrict__ starts, int64_t cells,
    int64_t cells_per_batch, int chunks, int C, int64_t dhw, int64_t hw,
    float* __restrict__ out) {
  const int64_t total = cells * chunks;
  for (int64_t t = blockIdx.x * (int64_t)kThreads + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * kThreads) {
    const int64_t cell = t % cells;
    const int c0 = (int)(t / cells) * kChunk;
    const int width = min(kChunk, C - c0);
    float acc[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) acc[j] = 0.0f;
    const int32_t lo = starts[cell], hi = starts[cell + 1];
    for (int32_t i = lo; i < hi; ++i) {
      const int64_t p = order[i];
      const float d = depth[p];
      const float* f = feat + ((p / dhw) * hw + p % hw) * C + c0;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < width) acc[j] = __fadd_rn(acc[j], __fmul_rn(d, f[j]));
      }
    }
    const int64_t b = cell / cells_per_batch;
    float* o = out + (b * C + c0) * cells_per_batch + (cell - b * cells_per_batch);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < width) o[j * cells_per_batch] = acc[j];
    }
  }
}

unsigned int blocks_for(int64_t work) {
  const unsigned int b = ceil_div64(work, kThreads);
  return b < kMaxBlocks ? b : kMaxBlocks;
}

}  // namespace

// coor (n, 3) f32, per_batch = N * D * H * W points; ranks (n,) int32 out.
PTK_EXPORT int bev_pool_ranks(const float* coor, int64_t n, int64_t per_batch, float lbx,
                              float lby, float lbz, float ivx, float ivy, float ivz, int gx,
                              int gy, int gz, int32_t* ranks, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  if (per_batch <= 0 || n % per_batch) return (int)cudaErrorInvalidValue;
  bev_pool_ranks_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coor, n, per_batch, lbx, lby, lbz, ivx, ivy, ivz, gx, gy, gz, ranks);
  return (int)cudaGetLastError();
}

// depth (n,) f32 in (B, N, D, H, W) order, feat (B * N * H * W, C) f32,
// sorted (n,) int32 ranks and order (n,) int64 from a stable sort, dhw =
// D * H * W, hw = H * W, cells_per_batch = Z * Y * X; starts (B *
// cells_per_batch + 1,) int32 scratch; out (B, C, Z, Y, X) f32, every
// element written.
PTK_EXPORT int bev_pool_fwd(const float* depth, const float* feat, const int32_t* sorted,
                            const int64_t* order, int64_t n, int64_t dhw, int64_t hw, int C,
                            int B, int64_t cells_per_batch, int32_t* starts, float* out,
                            void* stream) {
  if (C < 1 || B < 1 || dhw < 1 || hw < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t cells = (int64_t)B * cells_per_batch;
  bev_pool_starts_kernel<<<blocks_for(cells + 1), kThreads, 0, st>>>(sorted, n, cells, starts);
  const int chunks = (C + kChunk - 1) / kChunk;
  bev_pool_sum_kernel<<<blocks_for(cells * chunks), kThreads, 0, st>>>(
      depth, feat, order, starts, cells, cells_per_batch, chunks, C, dhw, hw, out);
  return (int)cudaGetLastError();
}
