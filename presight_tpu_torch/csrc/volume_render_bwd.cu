// K3b volume_render_bwd: backward of K3 (weights, accumulation, expected
// depth and composite) to the densities and the payload rows.
//
// Replaces XLA's autodiff of presight_tpu/ops/rays.py::get_weights
// (:68-90), ops/renderers.py::render_accumulation and render_depth_expected
// (:25-54) and the fused segment-sum composite of
// models/nerfacto_ms.py::forward.field_eval (:456-479). The median depth is
// stop-gradient there and gets no gradient here.
//
// Per ray, with dd_s = delta_s sigma_s, alpha_s = 1 - exp(-dd_s),
// T_s = exp(-sum_{j<s} dd_j) and w_s = nan_to_num(alpha_s T_s):
//   gw_s   = dL/dw_s + dL/dacc + dL/dcomposite . payload[row(s)]
//            + ge (t_s / b - a / b^2),  a = sum w t, b = sum w + 1e-10,
//            ge = dL/dexpected times jnp.clip's derivative at the batch
//            bounds [lo, hi] (1 inside, 0.5 at a tie, 0 outside, for the
//            max with lo and then the min with hi);
//   gw_s   = 0 where alpha_s T_s is not finite (nan_to_num);
//   dsigma_j = delta_j (gw_j T_j exp(-dd_j) - sum_{s>j} gw_s alpha_s T_s);
//   dpayload[row(s)] = w_s dL/dcomposite (each padded row is read by at
//   most one sample, so it is written without atomics; rows no sample
//   reads are left as the caller zeroed them).
//
// What bounds it on an H100: device memory. Per sample it reads delta,
// sigma, t, w, dL/dw and its payload row and writes dsigma and the payload
// row's gradient; a few tens of FLOPs per sample.
//
// Design: one warp per ray, as K3. Lanes take consecutive samples. Pass 1
// recomputes the exclusive prefix of dd with K3's warp scan (so T_s is
// K3's) and the sums a and b in K3's order (so the expected depth, and a
// tie with the clip bounds, are K3's). Pass 2 takes the samples one by one,
// the lanes spread over payload channels (coalesced): the dot product with
// dL/dcomposite is a warp sum and the payload gradient row is written in
// the same sweep. Pass 3 runs over the samples from the last chunk to the
// first with a reverse warp scan and a carry, for the suffix sums.
#include <float.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  // d/dx min(max(x, lo), hi) as JAX differentiates it (0.5 at a tie).
  const float a = x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
  const float m = fmaxf(x, lo);
  const float b = m < hi ? 1.0f : (m == hi ? 0.5f : 0.0f);
  return a * b;
}

__global__ void __launch_bounds__(kWarps * 32)
volume_render_bwd_kernel(const float* __restrict__ deltas, const float* __restrict__ density,
                         const float* __restrict__ steps, const float* __restrict__ clip,
                         const float* __restrict__ payload,
                         const int32_t* __restrict__ payload_index,
                         const float* __restrict__ weights, const float* __restrict__ g_w,
                         const float* __restrict__ g_acc, const float* __restrict__ g_exp,
                         const float* __restrict__ g_comp, int64_t R, int S, int C,
                         float* __restrict__ d_density, float* __restrict__ d_payload) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t r = (int64_t)blockIdx.x * kWarps + warp;
  if (r >= R) return;  // whole warps exit together; only __syncwarp below
  float* trans_s = smem + warp * S;               // T_s
  float* gw_s = smem + (kWarps + warp) * S;       // dL/dw_s, then gw_s alpha_s T_s
  const int64_t base = r * S;

  // Pass 1: transmittance, and K3's sums for the expected depth.
  float carry = 0.0f, wsum = 0.0f, wtsum = 0.0f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool valid = s < S;
    const float dd = valid ? __fmul_rn(deltas[base + s], density[base + s]) : 0.0f;
    const float inc = warp_inclusive_scan(dd, lane);
    float excl = __shfl_up_sync(kFullMask, inc, 1);
    if (lane == 0) excl = 0.0f;
    if (valid) {
      trans_s[s] = expf(-(carry + excl));
      gw_s[s] = g_w[base + s];
    }
    carry += __shfl_sync(kFullMask, inc, 31);
    if (steps != nullptr && valid) {
      const float w = weights[base + s];
      wsum += w;
      wtsum += w * steps[base + s];
    }
  }
  float ge = 0.0f, inv_b = 0.0f, a_over_b2 = 0.0f;
  if (steps != nullptr) {
    wsum = warp_sum(wsum);
    wtsum = warp_sum(wtsum);
    const float b = wsum + 1e-10f;
    ge = g_exp[r] * clip_grad(wtsum / b, clip[0], clip[1]);
    inv_b = 1.0f / b;
    a_over_b2 = wtsum / (b * b);
  }
  __syncwarp();

  // Pass 2: gradient of each weight; the payload rows' gradients.
  for (int s = 0; s < S; ++s) {
    float dot = 0.0f;
    if (payload != nullptr) {
      const int64_t row = payload_index != nullptr ? payload_index[base + s] : base + s;
      const float w = weights[base + s];
      for (int c = lane; c < C; c += 32) {
        const float gc = g_comp[r * C + c];
        dot += gc * payload[row * C + c];
        d_payload[row * C + c] = w * gc;
      }
      dot = warp_sum(dot);
    }
    if (lane == 0) {
      float gw = gw_s[s] + dot;
      if (steps != nullptr) {
        gw += g_acc[r];
        gw += ge * steps[base + s] * inv_b - ge * a_over_b2;
      }
      gw_s[s] = gw;
    }
  }
  __syncwarp();

  // Pass 3: dsigma_j = delta_j (gw_j T_j e^{-dd_j} - sum_{s>j} gw_s alpha_s T_s).
  float suffix = 0.0f;  // sum over the chunks after the current one
  const int last0 = ((S - 1) / 32) * 32;
  for (int s0 = last0; s0 >= 0; s0 -= 32) {
    const int s = s0 + lane;
    const bool valid = s < S;
    float gw = 0.0f, q = 0.0f, e_dd = 0.0f, delta = 0.0f;
    if (valid) {
      delta = deltas[base + s];
      const float dd = __fmul_rn(delta, density[base + s]);
      e_dd = expf(-dd);
      const float T = trans_s[s];
      const float alpha = __fsub_rn(1.0f, e_dd);
      const float w_raw = __fmul_rn(alpha, T);
      gw = isfinite(w_raw) ? gw_s[s] : 0.0f;
      q = gw * alpha * T;
      gw *= T * e_dd;
    }
    // Reverse inclusive scan of q over the lanes, then shift by one lane.
    float v = q;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_down_sync(kFullMask, v, off);
      if (lane + off < 32) v += u;
    }
    float after = __shfl_down_sync(kFullMask, v, 1);
    if (lane == 31) after = 0.0f;
    if (valid) d_density[base + s] = delta * (gw - (suffix + after));
    suffix += __shfl_sync(kFullMask, v, 0);
  }
}

}  // namespace

// steps, clip, g_acc and g_exp are null together (weights only); payload,
// g_comp and d_payload are null together; payload_index may be null (rows in
// sample order). clip is a device pointer to {min, max} of steps.
PTK_EXPORT int volume_render_bwd(const float* deltas, const float* density, const float* steps,
                                 const float* clip, const float* payload,
                                 const int32_t* payload_index, const float* weights,
                                 const float* g_w, const float* g_acc, const float* g_exp,
                                 const float* g_comp, int64_t R, int S, int C,
                                 float* d_density, float* d_payload, void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)2 * kWarps * S * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(volume_render_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  volume_render_bwd_kernel<<<ceil_div64(R, kWarps), kWarps * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      deltas, density, steps, clip, payload, payload_index, weights, g_w, g_acc, g_exp, g_comp,
      R, S, C, d_density, d_payload);
  return (int)cudaGetLastError();
}
