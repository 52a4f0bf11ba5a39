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
//
// Design (the first, simple one): one warp per (bn, pixel), blocks of 8
// warps walking the pixels in order (so the blocks in flight read one
// camera's previous features, 11.5 MB at the reference shapes: L2). The
// warp copies its pixel's C current channels to shared memory, then for
// each bin reads the sample position (one 8-byte load), computes the
// corners and weights (the same in every lane), and each lane blends
// channels lane, lane + 32, ... from the (up to) four corner rows that lie
// inside (coalesced 128-byte reads per corner), accumulates |diff|, and the
// warp sums by shuffles. Lane 0 keeps the bin's cost in shared memory; the
// softmax over the D bins runs across the lanes at the end.
//
// What bounds it on an H100: operations. Per (pixel, bin) and channel, a
// blend of k inside corners (2k - 1 flops), a difference, an absolute
// value and an add: ~15 GFLOP at the reference shapes over 67 TFLOP/s f32;
// the bytes (prev and curr once, the grid, the output) are ~190 MB. This
// kernel reads each corner row from L2 for every bin (~24 GB of L2 reads):
// that, not the bound, is its time.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr unsigned int kMaxBlocks = 132 * 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kWarps * 32) stereo_cost_volume_kernel(
    const float* __restrict__ prev, const float* __restrict__ curr,
    const float* __restrict__ grid, int64_t BN, int H, int W, int C, int D, float bias,
    float* __restrict__ out, float* __restrict__ cost_out, uint8_t* __restrict__ invalid_out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* cur = smem + warp * (C + D);
  float* cost = cur + C;
  const int64_t HW = (int64_t)H * W;
  const float fw = (float)(W - 1), fh = (float)(H - 1);
  for (int64_t q = blockIdx.x * (int64_t)kWarps + warp; q < BN * HW;
       q += (int64_t)gridDim.x * kWarps) {
    const int64_t bn = q / HW, pix = q - bn * HW;
    for (int c = lane; c < C; c += 32) cur[c] = curr[q * C + c];
    __syncwarp();
    const float* img = prev + bn * HW * C;
    for (int d = 0; d < D; ++d) {
      const float2 g = *reinterpret_cast<const float2*>(grid + ((bn * D + d) * HW + pix) * 2);
      const float x = __fmul_rn(__fmul_rn(__fadd_rn(g.x, 1.0f), 0.5f), fw);
      const float y = __fmul_rn(__fmul_rn(__fadd_rn(g.y, 1.0f), 0.5f), fh);
      const float x0 = floorf(x), y0 = floorf(y);
      const float x1 = __fadd_rn(x0, 1.0f), y1 = __fadd_rn(y0, 1.0f);
      const float wx = __fsub_rn(x, x0), wy = __fsub_rn(y, y0);
      const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
      const bool ix0 = x0 >= 0.0f && x0 <= fw, ix1 = x1 >= 0.0f && x1 <= fw;
      const bool iy0 = y0 >= 0.0f && y0 <= fh, iy1 = y1 >= 0.0f && y1 <= fh;
      const bool in00 = ix0 && iy0, in10 = ix1 && iy0, in01 = ix0 && iy1, in11 = ix1 && iy1;
      const float w00 = __fmul_rn(ux, uy), w10 = __fmul_rn(wx, uy);
      const float w01 = __fmul_rn(ux, wy), w11 = __fmul_rn(wx, wy);
      // Row pointers only where the corner is inside (xi, yi in range).
      const int xi = in00 || in01 ? (int)x0 : 0, yi = in00 || in10 ? (int)y0 : 0;
      const float* r00 = img + ((int64_t)yi * W + xi) * C;
      const float* r10 = img + ((int64_t)yi * W + (in10 || in11 ? (int)x1 : 0)) * C;
      const float* r01 = img + ((int64_t)(in01 || in11 ? (int)y1 : 0) * W + xi) * C;
      const float* r11 = img + ((int64_t)(in11 ? (int)y1 : 0) * W + (in11 ? (int)x1 : 0)) * C;
      float part = 0.0f, ch0 = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float t0 = in00 ? __fmul_rn(r00[c], w00) : 0.0f;
        const float t1 = in10 ? __fmul_rn(r10[c], w10) : 0.0f;
        const float t2 = in01 ? __fmul_rn(r01[c], w01) : 0.0f;
        const float t3 = in11 ? __fmul_rn(r11[c], w11) : 0.0f;
        const float v = __fadd_rn(__fadd_rn(__fadd_rn(t0, t1), t2), t3);
        part = __fadd_rn(part, fabsf(__fsub_rn(cur[c], v)));
        if (c == 0) ch0 = v;
      }
      part = warp_sum(part);
      const float w0 = __shfl_sync(0xffffffffu, ch0, 0);
      if (lane == 0) {
        const bool invalid = w0 == 0.0f;
        const float cst = bias != 0.0f && invalid ? __fadd_rn(part, bias) : part;
        cost[d] = cst;
        if (cost_out) cost_out[q * D + d] = cst;
        if (invalid_out) invalid_out[q * D + d] = invalid ? 1 : 0;
      }
    }
    __syncwarp();
    float m = -INFINITY;
    for (int d = lane; d < D; d += 32) m = fmaxf(m, -cost[d]);
    m = warp_max(m);
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s += expf(__fsub_rn(-cost[d], m));
    s = warp_sum(s);
    for (int d = lane; d < D; d += 32) out[q * D + d] = __fdiv_rn(expf(__fsub_rn(-cost[d], m)), s);
    __syncwarp();
  }
}

}  // namespace

// prev, curr (BN, H, W, C) f32; grid (BN, D * H * W, 2) f32, D-major; out
// (BN, H, W, D) f32; cost (BN, H, W, D) f32 and invalid (BN, H, W, D) uint8
// may be null.
PTK_EXPORT int stereo_cost_volume_fwd(const float* prev, const float* curr, const float* grid,
                                      int64_t BN, int H, int W, int C, int D, float bias,
                                      float* out, float* cost, uint8_t* invalid, void* stream) {
  const size_t smem = (size_t)kWarps * (C + D) * sizeof(float);
  if (C < 1 || D < 1 || H < 1 || W < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (BN == 0) return (int)cudaGetLastError();
  unsigned int blocks = ceil_div64(BN * H * W, kWarps);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  stereo_cost_volume_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      prev, curr, grid, BN, H, W, C, D, bias, out, cost, invalid);
  return (int)cudaGetLastError();
}
