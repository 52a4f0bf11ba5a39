// S3 deformable sampling of the online-mapping model, forward only:
//   msda_fwd           multi-scale deformable attention: the temporal
//                      self-attention, the spatial cross-attention over the
//                      cameras' compacted queries, the decoder's
//                      cross-attention;
//   deform_im2col_fwd  DCNv2's mask-modulated columns, which one f32
//                      cuBLAS product then turns into the convolution.
//
// Replaces no TPU kernel: the JAX package samples with XLA gathers
// (presight_tpu/mapping/bev_encoder.py:90 deformable_taps, the fused SCA
// core's row gather, DeformConv2d's bilinear_sample), standing in for mmcv's
// MultiScaleDeformableAttention and ModulatedDeformConv2d CUDA ops.
//
// Bilinear taps as the JAX package's packed_rows_weights computes them:
// x0 = floor(px), wx = px - x0 (likewise y), corner weights (1 - wy)(1 - wx),
// (1 - wy) wx, wy (1 - wx) and wy wx, rounded one product at a time; a
// corner outside [0, W) x [0, H) weighs 0 (zeros padding). Corner tests are
// made on the floored floats, so no coordinate is converted to an integer
// before it is known to lie in the map.
//
// What bounds them on an H100. msda_fwd: bytes. A tap reads four corner
// rows of hd = 32 floats (128 bytes each) of one head; at the reference
// shapes the spatial cross-attention alone makes ~1.2e7 such reads (~1.5 GB)
// from value tables of ~8 MB a camera (48 MB in all, within the 50-MB L2),
// so the reads come mostly from L2 and the kernel waits on their latency;
// the bound counts the value maps, locations, weights and output once.
// deform_im2col_fwd: the columns it writes (~0.33 GB for stage 3's 1,024
// channels at 6 x 30 x 50 pixels x 9 taps); the input (37 MB) stays in L2.
//
// Design.
//   msda_fwd: one warp per (map, query, head), lane c the head's channel c
//   (hd <= 32), so a corner is one coalesced 128-byte row segment. Taps go
//   in groups of 32: lane i loads tap i's location and attention weight
//   (coalesced), computes its four row offsets and its four corner weights
//   times the attention weight (0 for a corner outside), and the tap loop
//   takes them by shuffle; a corner of weight 0 is not read. The four
//   corner loads of a tap are issued before their products, and the loop is
//   unrolled, so a warp keeps several 128-byte reads in flight; 8 warps a
//   block, a grid-stride loop over the warps.
//   deform_im2col_fwd: one warp per (output pixel, tap). Every lane computes
//   the tap's position (oy * stride + (ky - k / 2)) + dy as the JAX package
//   does (exact integer grid, one rounding) and the four corner weights;
//   the lanes then walk the C channels in float4 steps (C % 4 == 0, else
//   one float at a time), blend the four corners by fmaf, multiply by the
//   modulation mask and store the column segment (coalesced).
// Two calls give bitwise equal results (no atomics).

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr unsigned int kMaxBlocks = 1u << 20;
constexpr unsigned int kFull = 0xffffffffu;
constexpr int kMaxMsdaLevels = 8;

struct MsdaLevels {
  int h[kMaxMsdaLevels];
  int w[kMaxMsdaLevels];
  int start[kMaxMsdaLevels];  // first row of level l in a map's value rows
};

// The four corners of a tap: flat rows (relative to the level's first row)
// and weights, 0 (and row 0) for a corner outside the H x W map.
__device__ __forceinline__ void bilinear_corners(float px, float py, int H, int W,
                                                 float scale, int (&row)[4], float (&w)[4]) {
  const float x0f = floorf(px), y0f = floorf(py);
  const float wx = __fsub_rn(px, x0f), wy = __fsub_rn(py, y0f);
  const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
  const bool xa = x0f >= 0.0f && x0f <= (float)(W - 1);   // x0 inside
  const bool xb = x0f >= -1.0f && x0f <= (float)(W - 2);  // x0 + 1 inside
  const bool ya = y0f >= 0.0f && y0f <= (float)(H - 1);
  const bool yb = y0f >= -1.0f && y0f <= (float)(H - 2);
  const int x0 = (xa || xb) ? (int)x0f : 0;
  const int y0 = (ya || yb) ? (int)y0f : 0;
  w[0] = (ya && xa) ? __fmul_rn(__fmul_rn(uy, ux), scale) : 0.0f;
  w[1] = (ya && xb) ? __fmul_rn(__fmul_rn(uy, wx), scale) : 0.0f;
  w[2] = (yb && xa) ? __fmul_rn(__fmul_rn(wy, ux), scale) : 0.0f;
  w[3] = (yb && xb) ? __fmul_rn(__fmul_rn(wy, wx), scale) : 0.0f;
  row[0] = (ya && xa) ? y0 * W + x0 : 0;
  row[1] = (ya && xb) ? y0 * W + x0 + 1 : 0;
  row[2] = (yb && xa) ? (y0 + 1) * W + x0 : 0;
  row[3] = (yb && xb) ? (y0 + 1) * W + x0 + 1 : 0;
}

// value (B, R, D); loc (B, Q, Hh, L, T, 2) as (x, y) pixel coordinates of
// level l; attn (B, Q, Hh, L, T); out (B, Q, D), D = Hh * hd.
__global__ void __launch_bounds__(kWarps * 32)
msda_fwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, MsdaLevels lv, int64_t n_warps, int Q, int R,
                int D, int Hh, int hd, int L, int T, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int NT = L * T;
  const bool active = lane < hd;
  for (int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); warp < n_warps;
       warp += (int64_t)gridDim.x * kWarps) {
    const int h = (int)(warp % Hh);
    const int64_t b = warp / Hh / Q;
    const float* vb = value + b * (int64_t)R * D + h * hd + (active ? lane : 0);
    const float* lw = loc + warp * NT * 2;
    const float* aw = attn + warp * NT;
    float acc = 0.0f;
    for (int base = 0; base < NT; base += 32) {
      const int j = base + lane;
      int row[4] = {0, 0, 0, 0};
      float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (j < NT) {
        const int l = j / T;
        bilinear_corners(__ldg(lw + 2 * j), __ldg(lw + 2 * j + 1), lv.h[l], lv.w[l],
                         __ldg(aw + j), row, w);
        const int s = lv.start[l];
        row[0] += s;
        row[1] += s;
        row[2] += s;
        row[3] += s;
      }
      const int n = min(32, NT - base);
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        float wk[4], v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          wk[c] = __shfl_sync(kFull, w[c], k);
          const int r = __shfl_sync(kFull, row[c], k);
          v[c] = (wk[c] != 0.0f) ? __ldg(vb + (int64_t)r * D) : 0.0f;
        }
        acc = fmaf(wk[0], v[0], acc);
        acc = fmaf(wk[1], v[1], acc);
        acc = fmaf(wk[2], v[2], acc);
        acc = fmaf(wk[3], v[3], acc);
      }
    }
    if (active) out[(warp / Hh) * D + h * hd + lane] = acc;
  }
}

template <int kVec>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<4> {
  using T = float4;
};

__device__ __forceinline__ float blend(float m, const float (&w)[4], float a, float b, float c,
                                       float d) {
  float s = __fmul_rn(w[0], a);
  s = fmaf(w[1], b, s);
  s = fmaf(w[2], c, s);
  s = fmaf(w[3], d, s);
  return __fmul_rn(s, m);
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }

__device__ __forceinline__ float blend_vec(float m, const float (&w)[4], float a, float b,
                                           float c, float d) {
  return blend(m, w, a, b, c, d);
}
__device__ __forceinline__ float4 blend_vec(float m, const float (&w)[4], float4 a, float4 b,
                                            float4 c, float4 d) {
  return make_float4(blend(m, w, a.x, b.x, c.x, d.x), blend(m, w, a.y, b.y, c.y, d.y),
                     blend(m, w, a.z, b.z, c.z, d.z), blend(m, w, a.w, b.w, c.w, d.w));
}

// x (B, H, W, C); off (B, Ho, Wo, K*K, 2) as (dy, dx); mask (B, Ho, Wo, K*K);
// cols (B * Ho * Wo, K*K * C): cols[p, t * C + c] = mask * bilinear(x[b], py, px)[c].
template <int kVec>
__global__ void __launch_bounds__(kWarps * 32)
deform_im2col_kernel(const float* __restrict__ x, const float* __restrict__ off,
                     const float* __restrict__ mask, int64_t n_warps, int H, int W, int C, int Ho,
                     int Wo, int k, int stride, float* __restrict__ cols) {
  using V = typename Vec<kVec>::T;
  const int lane = threadIdx.x & 31;
  const int KK = k * k;
  const int CV = C / kVec;
  for (int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); warp < n_warps;
       warp += (int64_t)gridDim.x * kWarps) {
    const int t = (int)(warp % KK);
    const int64_t p = warp / KK;
    const int64_t b = p / ((int64_t)Ho * Wo);
    const int pix = (int)(p % ((int64_t)Ho * Wo));
    const int oy = pix / Wo, ox = pix % Wo;
    const float gy = (float)(oy * stride) + (float)(t / k - k / 2);
    const float gx = (float)(ox * stride) + (float)(t % k - k / 2);
    const float py = __fadd_rn(gy, __ldg(off + warp * 2));
    const float px = __fadd_rn(gx, __ldg(off + warp * 2 + 1));
    const float m = __ldg(mask + warp);
    int row[4];
    float w[4];
    bilinear_corners(px, py, H, W, 1.0f, row, w);
    const V* xb = reinterpret_cast<const V*>(x + b * (int64_t)H * W * C);
    V* dst = reinterpret_cast<V*>(cols + warp * C);
    const V zero = V();
    for (int c = lane; c < CV; c += 32) {
      const V a = w[0] != 0.0f ? load(xb + (int64_t)row[0] * CV + c) : zero;
      const V bb = w[1] != 0.0f ? load(xb + (int64_t)row[1] * CV + c) : zero;
      const V cc = w[2] != 0.0f ? load(xb + (int64_t)row[2] * CV + c) : zero;
      const V d = w[3] != 0.0f ? load(xb + (int64_t)row[3] * CV + c) : zero;
      dst[c] = blend_vec(m, w, a, bb, cc, d);
    }
  }
}

unsigned int blocks_for(int64_t warps) {
  const unsigned int b = ceil_div64(warps, kWarps);
  return b > kMaxBlocks ? kMaxBlocks : b;
}

}  // namespace

// levels: host array of 3 * L ints (h, w, first row of each level).
PTK_EXPORT int msda_fwd(const float* value, const float* loc, const float* attn,
                        const int64_t* levels, int64_t B, int Q, int R, int D, int Hh, int L,
                        int T, float* out, void* stream) {
  if (Hh < 1 || D % Hh != 0 || D / Hh > 32 || L < 1 || L > kMaxMsdaLevels || T < 1 ||
      (int64_t)R * D >= (int64_t)1 << 31) {
    return (int)cudaErrorInvalidValue;
  }
  MsdaLevels lv;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = (int)levels[3 * l];
    lv.w[l] = (int)levels[3 * l + 1];
    lv.start[l] = (int)levels[3 * l + 2];
    if (lv.h[l] < 1 || lv.w[l] < 1 || lv.start[l] < 0 ||
        (int64_t)lv.start[l] + (int64_t)lv.h[l] * lv.w[l] > R) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const int64_t warps = B * Q * Hh;
  if (warps == 0) return (int)cudaGetLastError();
  msda_fwd_kernel<<<blocks_for(warps), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      value, loc, attn, lv, warps, Q, R, D, Hh, D / Hh, L, T, out);
  return (int)cudaGetLastError();
}

PTK_EXPORT int deform_im2col_fwd(const float* x, const float* off, const float* mask, int64_t B,
                                 int H, int W, int C, int Ho, int Wo, int k, int stride,
                                 float* cols, void* stream) {
  if (H < 1 || W < 1 || C < 1 || k < 1 || stride < 1 || (int64_t)H * W >= (int64_t)1 << 31) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t warps = B * Ho * Wo * k * k;
  if (warps == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  if (vec) {
    deform_im2col_kernel<4><<<blocks_for(warps), kWarps * 32, 0, st>>>(
        x, off, mask, warps, H, W, C, Ho, Wo, k, stride, cols);
  } else {
    deform_im2col_kernel<1><<<blocks_for(warps), kWarps * 32, 0, st>>>(
        x, off, mask, warps, H, W, C, Ho, Wo, k, stride, cols);
  }
  return (int)cudaGetLastError();
}
