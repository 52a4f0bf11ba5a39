// K3 volume_render_fwd: per-ray volume-rendering weights, composite,
// accumulation, expected depth and median depth in one pass.
//
// Replaces presight_tpu/ops/rays.py::get_weights (:68-90),
// presight_tpu/ops/renderers.py (:25-54) and the fused rgb+semantics
// segment_sum render inside models/nerfacto_ms.py::forward.field_eval
// (:456-479) -- which stand in for nerfacc's accumulate_along_rays.
//
// Per ray of S samples:
//   dd_s = delta_s * sigma_s, alpha_s = 1 - exp(-dd_s),
//   T_s = exp(-sum_{j<s} dd_j), w_s = alpha_s * T_s, with nan_to_num
//   (NaN -> 0, +-inf -> +-FLT_MAX, as jnp.nan_to_num);
//   composite = sum_s w_s * payload[row(s)], row(s) = payload_index[r*S+s]
//   (the padded slot of the sample) or r*S+s;
//   accumulation = sum_s w_s;
//   expected = sum_s w_s t_s / (accumulation + 1e-10), clipped to the
//   batch-global [min t, max t] (computed by the caller, passed as `clip`);
//   median = t at the number of samples whose cumulative weight is below
//   `threshold` (searchsorted side='left'), clipped to S - 1.
//
// What bounds it on an H100: device memory. Each sample is read once
// (delta, sigma, t: 12 B) plus its payload row (67 floats on the main
// path); there are ~20 FLOPs per sample. Unfused, the reference runs a
// cumsum, an exp, several reductions and a (R*S, C) weighted scatter, each a
// full pass over memory.
//
// Design: one warp per ray. Lanes take consecutive samples (coalesced
// reads), the exclusive prefix sum and the cumulative weight are warp scans
// with shuffles, the sums are butterfly reductions, and the median index is
// a ballot count. The weights and payload row indices of the ray are kept
// in shared memory for the composite, where lanes take consecutive payload
// channels so each payload row is read by one coalesced access per sample.
#include <float.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__device__ __forceinline__ float nan_to_num(float w) {
  if (isnan(w)) return 0.0f;
  if (isinf(w)) return w > 0.0f ? FLT_MAX : -FLT_MAX;
  return w;
}

__global__ void __launch_bounds__(kWarps * 32)
volume_render_fwd_kernel(const float* __restrict__ deltas, const float* __restrict__ density,
                         const float* __restrict__ steps, const float* __restrict__ clip,
                         const float* __restrict__ payload,
                         const int32_t* __restrict__ payload_index, int64_t R, int S,
                         int C, float threshold, float* __restrict__ weights,
                         float* __restrict__ acc_out, float* __restrict__ depth_out,
                         float* __restrict__ expected_out, float* __restrict__ composite) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t r = (int64_t)blockIdx.x * kWarps + warp;
  if (r >= R) return;  // whole warps exit together; only __syncwarp below
  float* w_s = smem + warp * S;
  int32_t* row_s = reinterpret_cast<int32_t*>(smem + kWarps * S) + warp * S;
  const int64_t base = r * S;

  float carry = 0.0f;   // sum of dd over earlier 32-sample chunks
  float wcarry = 0.0f;  // cumulative weight over earlier chunks
  float wsum = 0.0f, wtsum = 0.0f;
  int below = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool valid = s < S;
    const float dd = valid ? __fmul_rn(deltas[base + s], density[base + s]) : 0.0f;
    const float inc = warp_inclusive_scan(dd, lane);
    float excl = __shfl_up_sync(kFullMask, inc, 1);
    if (lane == 0) excl = 0.0f;
    const float alpha = __fsub_rn(1.0f, expf(-dd));
    const float w = valid ? nan_to_num(__fmul_rn(alpha, expf(-(carry + excl)))) : 0.0f;
    carry += __shfl_sync(kFullMask, inc, 31);
    const float cum = wcarry + warp_inclusive_scan(w, lane);
    wcarry = __shfl_sync(kFullMask, cum, 31);
    if (valid) {
      weights[base + s] = w;
      w_s[s] = w;
      if (payload != nullptr) {
        row_s[s] = payload_index != nullptr ? payload_index[base + s] : (int32_t)(base + s);
      }
    }
    if (steps != nullptr) {
      below += __popc(__ballot_sync(kFullMask, valid && cum < threshold));
      wsum += w;
      if (valid) wtsum += w * steps[base + s];
    }
  }

  if (steps != nullptr) {
    wsum = warp_sum(wsum);
    wtsum = warp_sum(wtsum);
    if (lane == 0) {
      acc_out[r] = wsum;
      const int idx = below < S - 1 ? below : S - 1;
      depth_out[r] = steps[base + idx];
      const float expected = wtsum / (wsum + 1e-10f);
      expected_out[r] = fminf(fmaxf(expected, clip[0]), clip[1]);
    }
  }

  if (payload != nullptr) {
    __syncwarp();
    for (int c = lane; c < C; c += 32) {
      float acc = 0.0f;
      for (int s = 0; s < S; ++s) acc += w_s[s] * payload[(int64_t)row_s[s] * C + c];
      composite[r * C + c] = acc;
    }
  }
}

}  // namespace

// steps, clip and the three per-ray outputs are null together (weights
// only). payload and composite are null together; payload_index may be null
// (payload rows in sample order). clip is a device pointer to {min, max}.
PTK_EXPORT int volume_render_fwd(const float* deltas, const float* density, const float* steps,
                                 const float* clip, const float* payload,
                                 const int32_t* payload_index, int64_t R, int S, int C,
                                 float threshold, float* weights, float* acc_out,
                                 float* depth_out, float* expected_out, float* composite,
                                 void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)kWarps * S * (sizeof(float) + sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(volume_render_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  volume_render_fwd_kernel<<<ceil_div64(R, kWarps), kWarps * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      deltas, density, steps, clip, payload, payload_index, R, S, C, threshold, weights,
      acc_out, depth_out, expected_out, composite);
  return (int)cudaGetLastError();
}
