// S2 stereo_cost_volume_fwd: the BEVStereo temporal matching cost over
// depth hypotheses, softmaxed over depth.
//
// Replaces no TPU kernel: the JAX package computes it with XLA
// (presight_tpu/occupancy/view_transformer.py:168 stereo_cost_volume, a
// scan over the depth bins of a four-corner gather, :94-126), standing in
// for the reference's own CUDA path (view_transformer.py:615-643
// calculate_cost_volumn, a grid_sample per group of channels).
//
// Contract, per (bn, pixel) and depth bin d: the bilinear sample of
// prev (BN, H, W, C) at grid[bn, d * H * W + pixel] (normalised to
// [-1, 1], align_corners=True: x = (g + 1) / 2 * (W - 1)), a corner counting
// when 0 <= xi <= W - 1 and 0 <= yi <= H - 1 (zeros padding), blended as the
// JAX package does (((c0 + c1) + c2) + c3, c_k = v_k * w_k, w from
// (1 - wx) and wx); cost = sum_c |curr - warped|, + bias where the
// warped channel 0 is exactly 0.0 (view_transformer.py:198: an exact-zero
// test, common on post-ReLU features, not an "all corners outside" test);
// then softmax(-cost) over the D bins. Out (BN, H, W, D); optionally the
// costs (BN, H, W, D) and the bias mask (uint8). The warped volume
// (BN, D, H, W, C), ~6 GB at the reference shapes, is never materialised.
// Two calls give bitwise equal results (no atomics).
//
// What bounds it on an H100: operations. Per (pixel, bin) and channel, a
// blend of k inside corners (2k - 1 flops), a difference, an absolute
// value and an add: ~14 GFLOP at the reference shapes over 67 TFLOP/s f32;
// the bytes (prev and curr once, the grid, the output) are ~190 MB. What
// holds the kernel back is latency: a design that reads a bin's four 1-KB
// corner rows from L2 for every (pixel, bin) waits on ~22 GB of L2 reads a
// frame; this one waits on fewer reloads, and on its own chains of
// shuffles, blends and adds with 16 warps an SM (~120 registers a thread).
//
// Design. One warp per (bn, pixel), blocks of 8 warps on consecutive
// pixels of one image row (their epipolar lines cross the same rows of
// prev, so L1 serves some of what one warp loads to its neighbours). Lane
// l holds channels l, l + 32, ..., K a lane (K = 8 at C = 256; wider C runs
// in chunks of 32 K channels), of the current pixel and of the four corner
// rows of the bin in hand, in registers.
//   - No serial grid load: each group of 32 bins starts with lane i
//     computing bin i's corner key and four weights (zero for a corner
//     outside) from a position loaded during the group before; the bin
//     loop takes them by shuffle.
//   - Corner rows are reused from bin to bin. The bins of a pixel walk its
//     epipolar line, and past the nearest few they step by less than a
//     pixel of the stride-4 map: most bins keep all four rows, a step of
//     one pixel keeps two (or one, diagonally), and only rows not held are
//     loaded (0.63 row loads a (pixel, bin) on the reference rig, against
//     3.66 inside corners). A step of more than one pixel, backwards or
//     forwards, loads all four. The key is the top-left corner clamped to
//     [-2, W] x [-2, H]: a block further out is wholly outside (zero rows,
//     zero weights) like the clamped one, so samples that leave the image,
//     and the -2 of a point behind the camera, share it.
//     view_transformer.stereo_row_fetches counts the loads of this rule.
//   - Channel 0's blend keeps the JAX order and rounding (products, then
//     ((t0 + t1) + t2) + t3, unfused), so the exact-zero bias mask is the
//     plain version's in every sample; the other channels blend by fmaf
//     into two running sums. An outside corner's row and weight are both
//     0, a +0 term, as the masked blend gives.
//   - No shuffle reduction per bin: each lane stores its partial cost of
//     the bin in shared memory, and after each group of 32 bins lane i
//     adds up bin i's 32 partials. Lane 0 keeps the mask. The bias, the
//     optional outputs and the softmax over the D bins run across the
//     lanes at the end, in coalesced stores.
// Tried on the card and slower (PERF.md, Findings): prefetching a later
// bin's rows into L1, staging them in shared memory by cp.async two bins
// ahead (110 KB a block), blending two bins of the same rows at once, and
// 80 registers a thread for 24 warps an SM (spills); each was slower.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr unsigned int kMaxBlocks = 132 * 64;
constexpr unsigned int kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The K channels c0 + 32 j of the row of prev at (x, y), or zeros where the
// corner is outside the image (or the channel past C).
template <int K>
__device__ __forceinline__ void load_row(float (&row)[K], const float* __restrict__ img, int x,
                                         int y, int H, int W, int C, int c0) {
  const bool inside = x >= 0 && x < W && y >= 0 && y < H;
  const float* r = img + (inside ? ((int64_t)y * W + x) * C : 0);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = c0 + 32 * j;
    row[j] = inside && c < C ? __ldg(r + c) : 0.0f;
  }
}

template <int K>
__device__ __forceinline__ void copy_row(float (&dst)[K], const float (&src)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) dst[j] = src[j];
}

// Bin d's corner key and weights: the top-left corner clamped to [-2, W] x
// [-2, H], packed (y + 2) << 16 | (x + 2), and each corner's weight in the
// JAX rounding, 0 for a corner outside.
struct BinCorners {
  int key;
  float w00, w10, w01, w11;
};

__device__ __forceinline__ BinCorners bin_corners(float2 gp, float fw, float fh, int H, int W) {
  const float x = __fmul_rn(__fmul_rn(__fadd_rn(gp.x, 1.0f), 0.5f), fw);
  const float y = __fmul_rn(__fmul_rn(__fadd_rn(gp.y, 1.0f), 0.5f), fh);
  const float x0 = floorf(x), y0 = floorf(y);
  const float x1 = __fadd_rn(x0, 1.0f), y1 = __fadd_rn(y0, 1.0f);
  const float wx = __fsub_rn(x, x0), wy = __fsub_rn(y, y0);
  const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
  const bool ix0 = x0 >= 0.0f && x0 <= fw, ix1 = x1 >= 0.0f && x1 <= fw;
  const bool iy0 = y0 >= 0.0f && y0 <= fh, iy1 = y1 >= 0.0f && y1 <= fh;
  const int xa = (int)fminf(fmaxf(x0, -2.0f), (float)W);  // NaN -> -2: outside
  const int ya = (int)fminf(fmaxf(y0, -2.0f), (float)H);
  return {((ya + 2) << 16) | (xa + 2), ix0 && iy0 ? __fmul_rn(ux, uy) : 0.0f,
          ix1 && iy0 ? __fmul_rn(wx, uy) : 0.0f, ix0 && iy1 ? __fmul_rn(ux, wy) : 0.0f,
          ix1 && iy1 ? __fmul_rn(wx, wy) : 0.0f};
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32) stereo_cost_volume_kernel(
    const float* __restrict__ prev, const float* __restrict__ curr,
    const float* __restrict__ grid, int64_t BN, int H, int W, int C, int D, float bias,
    float* __restrict__ out, float* __restrict__ cost_out, uint8_t* __restrict__ invalid_out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* parts = smem + warp * 32 * 33;  // (bin of the group, lane), a pad word a row
  float* cost = smem + kWarps * 32 * 33 + warp * D;
  uint8_t* invalid = reinterpret_cast<uint8_t*>(smem + kWarps * (32 * 33 + D)) + warp * D;
  const int64_t HW = (int64_t)H * W;
  const float fw = (float)(W - 1), fh = (float)(H - 1);
  for (int64_t q = blockIdx.x * (int64_t)kWarps + warp; q < BN * HW;
       q += (int64_t)gridDim.x * kWarps) {
    const int64_t bn = q / HW, pix = q - bn * HW;
    const float* img = prev + bn * HW * C;
    const float* gpix = grid + (bn * D * HW + pix) * 2;
    for (int cb = 0; cb < C; cb += 32 * K) {
      const int c0 = cb + lane;
      float cur[K], r00[K], r10[K], r01[K], r11[K];
#pragma unroll
      for (int j = 0; j < K; ++j) cur[j] = c0 + 32 * j < C ? curr[q * C + c0 + 32 * j] : 0.0f;
      int held = -1, hx = 0, hy = 0;  // key and top-left corner of the rows held
      float2 gp = lane < D ? *reinterpret_cast<const float2*>(gpix + lane * HW * 2)
                           : make_float2(0.0f, 0.0f);
      for (int g = 0; g < D; g += 32) {
        // Lane i: bin g + i's corners; the next group's position in flight.
        const BinCorners mine = bin_corners(gp, fw, fh, H, W);
        if (g + 32 + lane < D) {
          gp = *reinterpret_cast<const float2*>(gpix + (g + 32 + lane) * HW * 2);
        }
        const int bins = min(32, D - g);
        for (int i = 0; i < bins; ++i) {
          const int k = __shfl_sync(kFull, mine.key, i);
          const float a00 = __shfl_sync(kFull, mine.w00, i), a10 = __shfl_sync(kFull, mine.w10, i);
          const float a01 = __shfl_sync(kFull, mine.w01, i), a11 = __shfl_sync(kFull, mine.w11, i);
          if (k != held) {  // warp-uniform
            const int nx = (k & 0xffff) - 2, ny = (k >> 16) - 2;
            const int dx = nx - hx, dy = ny - hy;
            const bool near = held >= 0 && dx >= -1 && dx <= 1 && dy >= -1 && dy <= 1;
            if (near) {  // carry the rows the new block shares with the old
              if (dx == 1) {
                copy_row(r00, r10);
                copy_row(r01, r11);
              } else if (dx == -1) {
                copy_row(r10, r00);
                copy_row(r11, r01);
              }
              if (dy == 1) {
                copy_row(r00, r01);
                copy_row(r10, r11);
              } else if (dy == -1) {
                copy_row(r01, r00);
                copy_row(r11, r10);
              }
            }
            if (!near || dx == -1 || dy == -1) load_row(r00, img, nx, ny, H, W, C, c0);
            if (!near || dx == 1 || dy == -1) load_row(r10, img, nx + 1, ny, H, W, C, c0);
            if (!near || dx == -1 || dy == 1) load_row(r01, img, nx, ny + 1, H, W, C, c0);
            if (!near || dx == 1 || dy == 1) load_row(r11, img, nx + 1, ny + 1, H, W, C, c0);
            held = k;
            hx = nx;
            hy = ny;
          }
          // Channel c0: the JAX order and rounding (channel 0 decides the mask).
          const float v0 = __fadd_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(r00[0], a00), __fmul_rn(r10[0], a10)),
                        __fmul_rn(r01[0], a01)),
              __fmul_rn(r11[0], a11));
          // Two running sums, so that each add waits on half as many.
          float part[2] = {fabsf(__fsub_rn(cur[0], v0)), 0.0f};
#pragma unroll
          for (int j = 1; j < K; ++j) {
            const float v =
                fmaf(r11[j], a11, fmaf(r01[j], a01, fmaf(r10[j], a10, r00[j] * a00)));
            part[j & 1] += fabsf(cur[j] - v);
          }
          parts[i * 33 + lane] = part[0] + part[1];
          if (cb == 0 && lane == 0) invalid[g + i] = v0 == 0.0f ? 1 : 0;
        }
        // Lane i sums bin g + i's partial costs over the lanes.
        __syncwarp();
        if (lane < bins) {
          float sum = 0.0f;
#pragma unroll 8
          for (int j = 0; j < 32; ++j) sum += parts[lane * 33 + j];
          cost[g + lane] = cb == 0 ? sum : cost[g + lane] + sum;
        }
        __syncwarp();
      }
    }
    float m = -INFINITY;
    for (int d = lane; d < D; d += 32) {
      const bool inv = invalid[d] != 0;
      const float c = bias != 0.0f && inv ? __fadd_rn(cost[d], bias) : cost[d];
      cost[d] = c;
      if (cost_out) cost_out[q * D + d] = c;
      if (invalid_out) invalid_out[q * D + d] = inv ? 1 : 0;
      m = fmaxf(m, -c);
    }
    m = warp_max(m);
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s += expf(__fsub_rn(-cost[d], m));
    s = warp_sum(s);
    for (int d = lane; d < D; d += 32) out[q * D + d] = __fdiv_rn(expf(__fsub_rn(-cost[d], m)), s);
    __syncwarp();
  }
}

template <int K>
int launch(unsigned int blocks, size_t smem, cudaStream_t st, const float* prev,
           const float* curr, const float* grid, int64_t BN, int H, int W, int C, int D,
           float bias, float* out, float* cost, uint8_t* invalid) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stereo_cost_volume_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  stereo_cost_volume_kernel<K><<<blocks, kWarps * 32, smem, st>>>(
      prev, curr, grid, BN, H, W, C, D, bias, out, cost, invalid);
  return (int)cudaGetLastError();
}

}  // namespace

// prev, curr (BN, H, W, C) f32; grid (BN, D * H * W, 2) f32, D-major; out
// (BN, H, W, D) f32; cost (BN, H, W, D) f32 and invalid (BN, H, W, D) uint8
// may be null.
PTK_EXPORT int stereo_cost_volume_fwd(const float* prev, const float* curr, const float* grid,
                                      int64_t BN, int H, int W, int C, int D, float bias,
                                      float* out, float* cost, uint8_t* invalid, void* stream) {
  const size_t smem = (size_t)kWarps * ((32 * 33 + D) * sizeof(float) + D);
  if (C < 1 || D < 1 || H < 1 || W < 1 || H > 32000 || W > 32000 ||
      smem > (size_t)kSmemLimit) {
    return (int)cudaErrorInvalidValue;
  }
  if (BN == 0) return (int)cudaGetLastError();
  unsigned int blocks = ceil_div64(BN * H * W, kWarps);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lanes = (C + 31) / 32;  // channels a lane holds, in chunks of at most 8
  if (lanes <= 1) {
    return launch<1>(blocks, smem, st, prev, curr, grid, BN, H, W, C, D, bias, out, cost, invalid);
  } else if (lanes <= 2) {
    return launch<2>(blocks, smem, st, prev, curr, grid, BN, H, W, C, D, bias, out, cost, invalid);
  } else if (lanes <= 4) {
    return launch<4>(blocks, smem, st, prev, curr, grid, BN, H, W, C, D, bias, out, cost, invalid);
  }
  return launch<8>(blocks, smem, st, prev, curr, grid, BN, H, W, C, D, bias, out, cost, invalid);
}
