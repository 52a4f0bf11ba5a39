// S1 bev_pool_fwd: lift-splat pooling of depth-weighted image features
// into the BEV voxel grid.
//
// Replaces no TPU kernel: the JAX package computes it with XLA
// (presight_tpu/occupancy/bev_pool.py:29 bev_pool_v2, one segment_sum over
// every frustum point with a dump row), standing in for the reference's
// own CUDA kernel bev_pool_v2 (occupancy/mmdet3d/ops/bev_pool_v2/src/
// bev_pool_cuda.cu:21-140): an interval sum over points grouped by voxel.
//
// Contract: point p of depth (B, N, D, H, W) (flat index p) adds
// depth[p] * feat[b, n, h, w, :] into voxel floor((coor[p] - lb) / iv) of
// the (B, C, Z, Y, X) output; points outside the (X, Y, Z) grid are
// dropped. Every output element is written once (empty voxels get 0), and
// each voxel sums its points in point order, so two calls give bitwise
// equal results; no float atomics.
//
// What bounds it on an H100: device memory. The output is written once
// (81.9 MB at the reference shapes: 640,000 voxels x 32 channels) and
// dominates; depth, feat and coor are read once (7.6 MB). Most voxels are
// empty (503k of 640k in the rig) and the rest hold ~1.5 points on
// average, a few tens next to the cameras. The sum pass stays under that
// rate, held back by its chains of dependent loads (first positions, then
// points, then depths and rows); PERF.md gives the times.
//
// Design: a counting sort by voxel in the kernel's own passes (no library
// sort), then one pass over the output in whole lines. One memset and four
// launches, on one int32 scratch buffer the wrapper allocates per call
// (bev_pool_scratch_ints):
//   count  one thread a point: its rank by voxel_rank (the plain version's
//          voxel arithmetic exactly), -1 outside; its arrival slot in the voxel by an integer atomicAdd
//          on the voxel's count (exact; the order of arrival is not).
//   scan   the exclusive scan of the counts in tiles of 2048 voxels; the
//          last tile to finish scans the tiles' totals, so a voxel's first
//          position is its in-tile offset plus its tile's prefix.
//   place  one thread a point: perm[first(rank) + slot] = p.
//   sum    a block takes a run of 128 consecutive voxels (64 past C = 32,
//          32 past C = 64) and cuts it into chunks of at most 16 voxels,
//          each ending where the points pass a multiple of 64; its warps
//          take the chunks from a shared counter, so a chunk of light
//          voxels costs a warp one load of their points and the heavy
//          voxels next to the cameras spread over the block. A chunk's
//          points (in groups of up to 256) are loaded at once and put back
//          in point order within each voxel by rank (the point indices are
//          distinct). Lane = channel then sums depth * feature in that
//          order, voxel after voxel, each point's depth and 128-byte
//          feature row loaded together, 8 points in flight, into the
//          block's (C x run) tile in shared memory, which goes out in
//          streaming float4 stores, each channel plane's run in whole
//          lines. An empty voxel costs only its zeros in that write. A
//          voxel of more than 256 points is sorted in place in perm (a
//          warp bitonic network) and summed the same way.
// Every call sorts its intervals again: nothing survives from one call to
// the next. The backward (S1b, below) needs no sort: it gathers g by each
// point's voxel_rank, pixel by pixel.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanItems = 8;
constexpr int kScanTile = kThreads * kScanItems;  // voxels a scan block covers
constexpr int kCap = 256;    // points of a group of voxels a warp holds in shared memory
constexpr int kAhead = 8;    // feature rows a warp keeps in flight
constexpr int kChunk = 16;   // most voxels a warp takes from its block's run at a time
constexpr int kBudget = 64;  // points past which a chunk ends
constexpr unsigned int kMaxBlocks = 132 * 16;
constexpr unsigned int kFull = 0xffffffffu;

unsigned int blocks_for(int64_t work) {
  const unsigned int b = ceil_div64(work, kThreads);
  return b < kMaxBlocks ? b : kMaxBlocks;
}

// Scratch layout, in int32 words: counts (and then in-tile offsets) of the
// cells and one past the end, in whole scan tiles; the scan's done ticket;
// the tiles' totals and prefixes; each point's rank and slot; perm.
int64_t scan_tiles(int64_t cells) { return (cells + 1 + kScanTile - 1) / kScanTile; }

int64_t counted_words(int64_t cells) { return scan_tiles(cells) * kScanTile + 4; }

int64_t scratch_words(int64_t n, int64_t cells) {
  return counted_words(cells) + 2 * scan_tiles(cells) + 3 * n;
}

struct Scratch {
  int32_t *offsets, *ticket, *tile_sum, *tile_prefix, *rank, *slot, *perm;
};

Scratch scratch_layout(int32_t* base, int64_t n, int64_t cells) {
  const int64_t tiles = scan_tiles(cells);
  Scratch s;
  s.offsets = base;
  s.ticket = base + counted_words(cells) - 4;
  s.tile_sum = base + counted_words(cells);
  s.tile_prefix = s.tile_sum + tiles;
  s.rank = s.tile_prefix + tiles;
  s.slot = s.rank + n;
  s.perm = s.slot + n;
  return s;
}

// The plain version's voxel arithmetic: floorf(__fsub_rn(c, lb) / iv) with
// IEEE division (no reciprocal), so a point on a voxel face lands where the
// plain version puts it. Returns the flat rank ((b * Z + z) * Y + y) * X + x
// of point c of batch b, or -1 outside the grid. S1's count pass and S1b
// both take it.
__device__ __forceinline__ int32_t voxel_rank(const float* c, int b, float lbx, float lby,
                                              float lbz, float ivx, float ivy, float ivz, int gx,
                                              int gy, int gz) {
  const float vx = floorf(__fdiv_rn(__fsub_rn(c[0], lbx), ivx));
  const float vy = floorf(__fdiv_rn(__fsub_rn(c[1], lby), ivy));
  const float vz = floorf(__fdiv_rn(__fsub_rn(c[2], lbz), ivz));
  if (!(vx >= 0.0f && vx < (float)gx && vy >= 0.0f && vy < (float)gy && vz >= 0.0f &&
        vz < (float)gz)) {
    return -1;
  }
  return ((b * gz + (int)vz) * gy + (int)vy) * gx + (int)vx;
}

__global__ void __launch_bounds__(kThreads) bev_pool_count_kernel(
    const float* __restrict__ coor, int64_t n, int64_t per_batch, float lbx, float lby, float lbz,
    float ivx, float ivy, float ivz, int gx, int gy, int gz, int32_t* __restrict__ counts,
    int32_t* __restrict__ rank, int32_t* __restrict__ slot) {
  for (int64_t p = blockIdx.x * (int64_t)kThreads + threadIdx.x; p < n;
       p += (int64_t)gridDim.x * kThreads) {
    const int32_t r = voxel_rank(coor + p * 3, (int)(p / per_batch), lbx, lby, lbz, ivx, ivy,
                                 ivz, gx, gy, gz);
    if (r >= 0) slot[p] = atomicAdd(counts + r, 1);
    rank[p] = r;
  }
}

__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += t;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_tot[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();
  return before + inc - v;
}

// counts (cells + 1, zero-padded to whole tiles of kScanTile) -> in-tile
// exclusive offsets; the last block to finish writes each tile's exclusive
// prefix.
__global__ void __launch_bounds__(kThreads) bev_pool_scan_kernel(
    int32_t* __restrict__ offsets, int tiles, int32_t* ticket,
    int32_t* tile_sum, int32_t* tile_prefix) {
  __shared__ int warp_tot[kWarps];
  __shared__ bool last;
  // The thread's 8 counts in two 16-byte loads (the buffer holds whole
  // tiles; counts past len are 0).
  const int64_t base = (int64_t)blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int4* mine = reinterpret_cast<int4*>(offsets + base);
  const int4 lo = mine[0], hi = mine[1];
  int v[kScanItems] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}, sum = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) sum += v[i];
  int total;
  int run = block_exclusive_scan(sum, warp_tot, total);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int c = v[i];
    v[i] = run;
    run += c;
  }
  mine[0] = make_int4(v[0], v[1], v[2], v[3]);
  mine[1] = make_int4(v[4], v[5], v[6], v[7]);
  if (threadIdx.x == 0) {
    tile_sum[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(ticket, 1) == tiles - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const int s = t < tiles ? __ldcg(tile_sum + t) : 0;
    int chunk;
    const int ex = block_exclusive_scan(s, warp_tot, chunk);
    if (t < tiles) tile_prefix[t] = carry + ex;
    carry += chunk;
  }
}

__device__ __forceinline__ int32_t first_of(const int32_t* offsets, const int32_t* tile_prefix,
                                            int64_t cell) {
  return offsets[cell] + tile_prefix[cell / kScanTile];
}

__global__ void __launch_bounds__(kThreads) bev_pool_place_kernel(
    int64_t n, const int32_t* __restrict__ offsets, const int32_t* __restrict__ tile_prefix,
    const int32_t* __restrict__ rank, const int32_t* __restrict__ slot,
    int32_t* __restrict__ perm) {
  for (int64_t p = blockIdx.x * (int64_t)kThreads + threadIdx.x; p < n;
       p += (int64_t)gridDim.x * kThreads) {
    const int32_t r = rank[p];
    if (r >= 0) perm[first_of(offsets, tile_prefix, r) + slot[p]] = (int32_t)p;
  }
}

// Sort a[0, len) ascending by the warp: a bitonic network over the next
// power of two whose every comparator puts the smaller value first, so the
// positions past len (taken as +infinity) never move and are never touched.
__device__ void warp_sort(int32_t* a, uint32_t len) {
  const uint32_t lane = threadIdx.x & 31;
  uint32_t size = 1;
  while (size < len) size <<= 1;
  for (uint32_t k = 2; k <= size; k <<= 1) {
    for (uint32_t j = k >> 1; j > 0; j >>= 1) {
      for (uint32_t t = lane; t < size >> 1; t += 32) {
        const uint32_t off = t & (j - 1), base = (t - off) << 1;  // (t / j) * 2j
        // The merge's first step mirrors within each run of k; the others
        // compare at distance j.
        const uint32_t i = base + off, partner = j == k >> 1 ? base + k - 1 - off : i + j;
        if (partner < len) {
          const int32_t x = a[i], y = a[partner];
          if (x > y) {
            a[i] = y;
            a[partner] = x;
          }
        }
      }
      __syncwarp();
    }
  }
}

// Sum of depth * feature over points already in point order (pts, global),
// lane = channel, into the tile's column col: each 32 points' depth and
// pixel loaded at once, kAhead feature rows in flight.
__device__ void sum_sorted(const int32_t* pts, int n, const float* __restrict__ depth,
                           const float* __restrict__ feat, int C, int dhw, int hw, float* tile,
                           int stride, int col) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.0f;
    for (int k0 = 0; k0 < n; k0 += 32) {
      const int m = min(32, n - k0);
      float dk = 0.0f;
      int32_t ak = 0;
      if (lane < m) {
        const int32_t p = pts[k0 + lane];
        dk = depth[p];
        ak = (p / dhw) * hw + p % hw;
      }
      for (int k = 0; k < m; k += kAhead) {
        float f[kAhead], dd[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int32_t at = __shfl_sync(kFull, ak, (k + u) & 31);
          dd[u] = __shfl_sync(kFull, dk, (k + u) & 31);
          f[u] = k + u < m && c < C ? feat[(int64_t)at * C + c] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (k + u < m) acc = __fadd_rn(acc, __fmul_rn(dd[u], f[u]));
        }
      }
    }
    if (c < C) tile[c * stride + col] = acc;
  }
}

// The interval sum over a run of kRun consecutive voxels a block. The
// run's first positions go to shared memory at once, and the run is cut
// into chunks of at most kChunk voxels, each ending where the points pass
// a multiple of kBudget; the warps take the chunks from a shared counter,
// so that the heavy voxels next to the cameras spread over the block while
// a chunk of light ones costs a warp one load of its points. Within a chunk, voxels
// go in groups whose points fit in kCap: a group's points are loaded at
// once and put in point order within each voxel by rank (point indices are
// distinct), then summed in that order voxel after voxel, lane = channel,
// each point's depth and feature row loaded together, kAhead points in
// flight. A voxel of more than kCap points is sorted in place in perm. The
// block's (C, kRun) tile goes out through shared memory.
template <int kRun>
__global__ void __launch_bounds__(kThreads) bev_pool_sum_kernel(
    const float* __restrict__ depth, const float* __restrict__ feat,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ tile_prefix,
    int32_t* perm, int64_t cells, int64_t cells_per_batch, int C, int dhw, int hw,
    float* __restrict__ out) {
  constexpr int kStride = kRun + 1;  // a pad word against bank conflicts
  extern __shared__ float smem[];
  __shared__ int32_t firsts[kRun + 1], chunk_start[kRun + 1];
  __shared__ int chunks, next_chunk, warp_cuts[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* tile = smem;
  int32_t* src = reinterpret_cast<int32_t*>(smem + C * kStride) + warp * 3 * kCap;
  int32_t* point_of = src + kCap;     // in point order within each voxel
  int32_t* pixel_of = point_of + kCap;
  const bool vector_out = cells_per_batch % 4 == 0;
  for (int64_t v0 = (int64_t)blockIdx.x * kRun; v0 < cells; v0 += (int64_t)gridDim.x * kRun) {
    for (int i = threadIdx.x; i <= kRun; i += kThreads) {
      firsts[i] = first_of(offsets, tile_prefix, v0 + i < cells ? v0 + i : cells);
    }
    for (int e = threadIdx.x; e < C * kStride; e += kThreads) tile[e] = 0.0f;
    if (threadIdx.x == 0) next_chunk = 0;
    __syncthreads();
    // Cut the run into chunks: a chunk starts every kChunk voxels and where
    // a voxel's first position crosses a multiple of kBudget, so that a
    // heavy voxel ends its chunk and the warps share the heavy ones.
    const int t = threadIdx.x;
    const bool cut = t < kRun && (t % kChunk == 0 || (firsts[t] - firsts[0]) / kBudget !=
                                                         (firsts[t - 1] - firsts[0]) / kBudget);
    const unsigned flags = __ballot_sync(kFull, cut);
    if (lane == 0) warp_cuts[warp] = __popc(flags);
    __syncthreads();
    int at = __popc(flags & ((1u << lane) - 1));
    for (int w = 0; w < warp; ++w) at += warp_cuts[w];
    if (cut) chunk_start[at] = t;
    if (t == kRun - 1) {
      chunks = at + cut;
      chunk_start[at + cut] = kRun;
    }
    __syncthreads();
    for (;;) {
      int chunk = 0;
      if (lane == 0) chunk = atomicAdd(&next_chunk, 1);
      chunk = __shfl_sync(kFull, chunk, 0);
      if (chunk >= chunks) break;
      const int stop = chunk_start[chunk + 1];
      for (int i0 = chunk_start[chunk], i1; i0 < stop; i0 = i1) {
        const int32_t base = firsts[i0];
        i1 = i0 + 1;
        while (i1 < stop && firsts[i1 + 1] - base <= kCap) ++i1;
        const int total = firsts[i1] - base;
        if (total > kCap) {  // one voxel
          warp_sort(perm + base, total);
          sum_sorted(perm + base, total, depth, feat, C, dhw, hw, tile, kStride, i0);
          __syncwarp();
          continue;
        }
        if (total == 0) continue;
        for (int k = lane; k < total; k += 32) src[k] = perm[base + k];
        __syncwarp();
        for (int k = lane; k < total; k += 32) {
          // Point k's voxel [lo, hi) within the group; its rank there places it.
          int lo = 0, hi = total;
          for (int i = i0 + 1; i < i1; ++i) {
            const int f = firsts[i] - base;
            if (f <= k) {
              lo = f;
            } else if (f < hi) {
              hi = f;
            }
          }
          const int32_t p = src[k];
          int r = lo;
          for (int j = lo; j < hi; ++j) r += src[j] < p;
          point_of[r] = p;
          pixel_of[r] = (p / dhw) * hw + p % hw;
        }
        __syncwarp();
        for (int c0 = 0; c0 < C; c0 += 32) {
          const int c = c0 + lane;
          float acc = 0.0f;
          int i = i0, end = firsts[i0 + 1] - base;
          for (int s0 = 0; s0 < total; s0 += kAhead) {
            float d[kAhead], f[kAhead];
#pragma unroll
            for (int u = 0; u < kAhead; ++u) {
              const bool in = s0 + u < total;
              d[u] = in ? depth[point_of[s0 + u]] : 0.0f;
              f[u] = in && c < C ? feat[(int64_t)pixel_of[s0 + u] * C + c] : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < kAhead; ++u) {
              const int s = s0 + u;
              if (s < total) {
                while (s >= end) {  // voxel i is summed
                  if (c < C) tile[c * kStride + i] = acc;
                  acc = 0.0f;
                  ++i;
                  end = firsts[i + 1] - base;
                }
                acc = __fadd_rn(acc, __fmul_rn(d[u], f[u]));
              }
            }
          }
          if (c < C) tile[c * kStride + i] = acc;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    const int64_t b = v0 / cells_per_batch;
    if (vector_out && v0 + kRun <= (b + 1) * cells_per_batch) {  // whole run in one batch
      float* o = out + b * C * cells_per_batch + (v0 - b * cells_per_batch);
      for (int e = threadIdx.x; e < C * kRun / 4; e += kThreads) {
        const int c = e / (kRun / 4), x = 4 * (e - c * (kRun / 4));
        const float* t = tile + c * kStride + x;
        __stcs(reinterpret_cast<float4*>(o + (int64_t)c * cells_per_batch + x),
               make_float4(t[0], t[1], t[2], t[3]));  // streaming: the output passes L2 by
      }
    } else {
      for (int e = threadIdx.x; e < C * kRun; e += kThreads) {
        const int c = e / kRun, col = e - c * kRun;
        const int64_t cell = v0 + col;
        if (cell < cells) {
          const int64_t bc = cell / cells_per_batch;
          out[(bc * C + c) * cells_per_batch + (cell - bc * cells_per_batch)] =
              tile[c * kStride + col];
        }
      }
    }
    __syncthreads();
  }
}

// Voxels a block's run takes: 128 up to C = 32, 64 up to C = 64, 32 beyond;
// the tile stays near 16 KB.
int sum_run(int C) { return C <= 32 ? 128 : C <= 64 ? 64 : 32; }

size_t sum_smem(int C) {
  return (size_t)C * (sum_run(C) + 1) * sizeof(float) +
         (size_t)kWarps * 3 * kCap * sizeof(int32_t);
}

template <int kRun>
int launch_sum(size_t smem, cudaStream_t st, const float* depth, const float* feat,
               const Scratch& s, int64_t cells, int64_t cells_per_batch, int C, int dhw,
               int hw, float* out) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bev_pool_sum_kernel<kRun>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  unsigned int blocks = ceil_div64(cells, kRun);
  if (blocks > 132 * 64) blocks = 132 * 64;
  bev_pool_sum_kernel<kRun><<<blocks, kThreads, smem, st>>>(
      depth, feat, s.offsets, s.tile_prefix, s.perm, cells, cells_per_batch, C, dhw, hw, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The int32 words of bev_pool_fwd's scratch buffer for n points and cells
// voxels (all batches).
PTK_EXPORT int64_t bev_pool_scratch_ints(int64_t n, int64_t cells) {
  return scratch_words(n, cells);
}

// depth (n,) f32 in (B, N, D, H, W) order, feat (B * N * H * W, C) f32, coor
// (n, 3) f32; per_batch = N * D * H * W points, dhw = D * H * W, hw = H * W;
// lb, iv the grid's lower bound and interval (x, y, z), (gx, gy, gz) its
// size; scratch of bev_pool_scratch_ints(n, B * gx * gy * gz) int32 words;
// out (B, C, gz, gy, gx) f32, every element written.
PTK_EXPORT int bev_pool_fwd(const float* depth, const float* feat, const float* coor, int64_t n,
                            int64_t per_batch, int64_t dhw, int64_t hw, int C, int B, float lbx,
                            float lby, float lbz, float ivx, float ivy, float ivz, int gx, int gy,
                            int gz, int32_t* scratch, float* out, void* stream) {
  const int64_t cells_per_batch = (int64_t)gx * gy * gz;
  const int64_t cells = B * cells_per_batch;
  const size_t smem = sum_smem(C);
  if (C < 1 || B < 1 || dhw < 1 || hw < 1 || per_batch <= 0 || n != B * per_batch ||
      n >= INT32_MAX || cells >= INT32_MAX - kScanTile || smem > (size_t)kSmemLimit) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = scratch_layout(scratch, n, cells);
  cudaError_t err = cudaMemsetAsync(s.offsets, 0, counted_words(cells) * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    bev_pool_count_kernel<<<blocks_for(n), kThreads, 0, st>>>(
        coor, n, per_batch, lbx, lby, lbz, ivx, ivy, ivz, gx, gy, gz, s.offsets, s.rank, s.slot);
  }
  const int tiles = (int)scan_tiles(cells);
  bev_pool_scan_kernel<<<tiles, kThreads, 0, st>>>(s.offsets, tiles, s.ticket,
                                                    s.tile_sum, s.tile_prefix);
  if (n > 0) {
    bev_pool_place_kernel<<<blocks_for(n), kThreads, 0, st>>>(n, s.offsets, s.tile_prefix,
                                                              s.rank, s.slot, s.perm);
  }
  switch (sum_run(C)) {
    case 128:
      return launch_sum<128>(smem, st, depth, feat, s, cells, cells_per_batch, C, (int)dhw,
                             (int)hw, out);
    case 64:
      return launch_sum<64>(smem, st, depth, feat, s, cells, cells_per_batch, C, (int)dhw,
                            (int)hw, out);
    default:
      return launch_sum<32>(smem, st, depth, feat, s, cells, cells_per_batch, C, (int)dhw,
                            (int)hw, out);
  }
}

// ---------------------------------------------------------------------------
// S1b bev_pool_bwd: the gradient of S1.
//
// Replaces no TPU kernel: the JAX package takes it by autodiff of its XLA
// segment_sum (presight_tpu/occupancy/bev_pool.py:29; the transpose of a
// segment sum is a gather), the reference by its own bev_pool_v2 backward
// kernel.
//
// Contract: for incoming g (B, C, Z, Y, X) and point p of pixel
// pix = (b, n, h, w) in voxel v(p) (the forward's arithmetic),
//   d depth[p]      = sum_c feat[pix, c] * g[b, c, v(p)]   (0 outside the grid)
//   d feat[pix, c]  = sum_d depth[pix, d] * g[b, c, v(pix, d)]
// Every output element is written once; no atomics, so two calls are
// bitwise equal.
//
// What bounds it on an H100: device memory. The work is small (4 flops a
// point and channel); the bytes it must move are depth, feat and coor once,
// the rows of g at the occupied voxels, and the two gradients (about 26 MB
// at the reference shapes, where g itself is 81.9 MB of mostly empty
// voxels). g arrives channel-major: a point's 32 channels lie a plane
// (640,000 floats) apart, 32 sectors for one point.
//
// Design: one launch, a warp a pixel, lane = channel (C up to 128 in
// chunks of 32, in registers), the pixel's bins in ascending order, 32 at a
// time: lane j first resolves bin d0 + j's voxel (voxel_rank, as the count
// pass does) and depth, then the warp walks the 32 bins, kAhead
// voxels' channels in flight, adding depth * g into d feat in bin order
// (the plain version's order) and reducing feat . g over the lanes into
// d depth, which lane j writes for bin d0 + j. The gather reads g's channel
// planes where they lie: a first pass transposing g to (B, Z, Y, X, C)
// rows, so that a point's channels are one 128-byte line, moved all of g
// twice and was slower on the rig.
namespace {

constexpr int kBins = 32;  // bins a warp resolves at once, one a lane

template <int kChunks>
__global__ void __launch_bounds__(kThreads) bev_pool_bwd_kernel(
    const float* __restrict__ depth, const float* __restrict__ feat,
    const float* __restrict__ coor, const float* __restrict__ g, int64_t pixels, int N, int D,
    int64_t hw, int C, float lbx, float lby, float lbz, float ivx, float ivy, float ivz, int gx,
    int gy, int gz, float* __restrict__ d_depth, float* __restrict__ d_feat) {
  const int lane = threadIdx.x & 31;
  const int64_t cells_per_batch = (int64_t)gx * gy * gz;
  for (int64_t pix = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); pix < pixels;
       pix += (int64_t)gridDim.x * kWarps) {
    const int64_t bn = pix / hw, s = pix - bn * hw;
    const int b = (int)(bn / N);
    float f[kChunks], acc[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = k * 32 + lane;
      f[k] = c < C ? feat[pix * C + c] : 0.0f;
      acc[k] = 0.0f;
    }
    const int64_t first = bn * D * hw + s;  // the pixel's point of bin 0; bins lie hw apart
    for (int d0 = 0; d0 < D; d0 += kBins) {
      int32_t cell = -1;  // lane j: bin d0 + j's voxel (all batches), -1 outside
      float dep = 0.0f;
      if (d0 + lane < D) {
        const int64_t p = first + (int64_t)(d0 + lane) * hw;
        cell = voxel_rank(coor + p * 3, b, lbx, lby, lbz, ivx, ivy, ivz, gx, gy, gz);
        if (cell >= 0) dep = depth[p];
      }
      const int m = min(kBins, D - d0);
      float mine = 0.0f;  // lane j: d depth of bin d0 + j
      for (int j0 = 0; j0 < m; j0 += kAhead) {
        float gv[kAhead][kChunks], dj[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int j = j0 + u;
          const int32_t at = __shfl_sync(kFull, cell, j & 31);
          dj[u] = __shfl_sync(kFull, dep, j & 31);
          const int64_t bb = at / cells_per_batch;
#pragma unroll
          for (int k = 0; k < kChunks; ++k) {
            const int c = k * 32 + lane;
            float v = 0.0f;
            if (j < m && at >= 0 && c < C) {
              v = g[(bb * C + c) * cells_per_batch + (at - bb * cells_per_batch)];
            }
            gv[u][k] = v;
          }
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (j0 + u < m) {
            float part = 0.0f;
#pragma unroll
            for (int k = 0; k < kChunks; ++k) {
              acc[k] = __fadd_rn(acc[k], __fmul_rn(dj[u], gv[u][k]));
              part = __fadd_rn(part, __fmul_rn(f[k], gv[u][k]));
            }
            part = warp_sum(part);
            if (lane == j0 + u) mine = part;
          }
        }
      }
      if (d0 + lane < D) d_depth[first + (int64_t)(d0 + lane) * hw] = mine;
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = k * 32 + lane;
      if (c < C) d_feat[pix * C + c] = acc[k];
    }
  }
}

template <int kChunks>
int launch_bwd(cudaStream_t st, const float* depth, const float* feat, const float* coor,
               const float* g, int64_t pixels, int N, int D, int64_t hw, int C, float lbx,
               float lby, float lbz, float ivx, float ivy, float ivz, int gx, int gy, int gz,
               float* d_depth, float* d_feat) {
  unsigned int blocks = ceil_div64(pixels, kWarps);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bev_pool_bwd_kernel<kChunks><<<blocks, kThreads, 0, st>>>(
      depth, feat, coor, g, pixels, N, D, hw, C, lbx, lby, lbz, ivx, ivy, ivz, gx, gy, gz,
      d_depth, d_feat);
  return (int)cudaGetLastError();
}

}  // namespace

// depth (B, N, D, H, W) f32, feat (B, N, H, W, C) f32, coor (B, N, D, H, W, 3)
// f32, g (B, C, gz, gy, gx) f32, contiguous; hw = H * W; lb, iv the grid's
// lower bound and interval (x, y, z); d_depth and d_feat shaped as depth
// and feat, every element written. C up to 128.
PTK_EXPORT int bev_pool_bwd(const float* depth, const float* feat, const float* coor,
                            const float* g, int B, int N, int D, int64_t hw, int C, float lbx,
                            float lby, float lbz, float ivx, float ivy, float ivz, int gx, int gy,
                            int gz, float* d_depth, float* d_feat, void* stream) {
  const int64_t cells = (int64_t)B * gx * gy * gz;
  const int64_t points = (int64_t)B * N * D * hw;
  if (C < 1 || C > 128 || B < 1 || N < 1 || D < 1 || hw < 1 || gx < 1 || gy < 1 || gz < 1 ||
      points >= INT32_MAX || cells >= INT32_MAX - kScanTile) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t pixels = (int64_t)B * N * hw;
  const int chunks = (C + 31) / 32;
  if (chunks == 1) {
    return launch_bwd<1>(st, depth, feat, coor, g, pixels, N, D, hw, C, lbx, lby, lbz, ivx, ivy,
                         ivz, gx, gy, gz, d_depth, d_feat);
  }
  if (chunks == 2) {
    return launch_bwd<2>(st, depth, feat, coor, g, pixels, N, D, hw, C, lbx, lby, lbz, ivx, ivy,
                         ivz, gx, gy, gz, d_depth, d_feat);
  }
  return launch_bwd<4>(st, depth, feat, coor, g, pixels, N, D, hw, C, lbx, lby, lbz, ivx, ivy,
                       ivz, gx, gy, gz, d_depth, d_feat);
}
