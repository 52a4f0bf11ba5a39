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
// Design (v2): one warp per ray, up to four rays per CUDA block. At entry
// each warp loads the first 32 samples' delta, sigma and t, reads its
// ray's payload row indices and starts cp.async copies of the S payload
// rows (48 x 67 floats, 12.9 KB on the main path; 4-byte copies, as a
// 67-float row is only 4-byte aligned) into shared memory, all in flight
// at once, as K3b does. The weight pass runs while they fly, each chunk's
// inputs loaded one chunk ahead: lanes take consecutive samples (coalesced
// reads), the exclusive prefix sum and the cumulative weight are warp
// scans with shuffles, the sums are butterfly reductions, and the median
// index is a ballot count (K3b recomputes T_s and the sums in this order).
// The composite then runs over the staged rows, lanes over channels (a row
// stride of C puts the lanes on consecutive floats), each lane summing up
// to three channels in one pass over the samples, each in sample order.
// The weights-only launches (proposal rounds) stage no rows. A ray is
// staged only as far as shared memory holds it (kSmemLimit, one ray a
// block at least): where its S x C rows do not fit with its weights and
// row indices (S * (C + 2) floats above 58,112: S > 842 at C = 67), the
// composite reads the rows from device memory; where its weights and row
// indices do not fit either (S > 29,056 with a payload, S > 58,112
// without), it keeps the weights in the `weights` output and reads the row
// indices from payload_index. So K3 takes a ray of any length. The weight
// pass, T_s and the sums K3b recomputes run in one order on every path;
// the composite of an unstaged ray adds its samples in blocks of 32 (one
// sum per block, then the block sums in order), since one running sum over
// tens of thousands of samples drifts past 1e-5 of the composite.
#include <float.h>

#include "common.cuh"

namespace {

constexpr int kMaxRays = 4;  // rays (warps) per CUDA block
constexpr int kBlock = 32;   // samples per partial composite sum of an unstaged ray

// How much of a ray lives in shared memory: its weights, row indices and
// payload rows (kStageRows), its weights and row indices (kStageSamples),
// or nothing (kStageNone: weights in the output, indices in payload_index).
enum Stage { kStageRows, kStageSamples, kStageNone };

__device__ __forceinline__ float nan_to_num(float w) {
  if (isnan(w)) return 0.0f;
  if (isinf(w)) return w > 0.0f ? FLT_MAX : -FLT_MAX;
  return w;
}

// Floats of shared memory per ray at a stage: w_s, with a payload the row
// index of each sample, and at kStageRows the S x C payload rows.
__host__ __device__ inline int64_t ray_smem_floats(int S, int C, bool with_payload, int stage) {
  if (stage == kStageNone) return 0;
  return S + (with_payload ? S + (stage == kStageRows ? (int64_t)S * C : 0) : 0);
}

template <int kStage>
__global__ void __launch_bounds__(kMaxRays * 32)
volume_render_fwd_kernel(const float* __restrict__ deltas, const float* __restrict__ density,
                         const float* __restrict__ steps, const float* __restrict__ clip,
                         const float* __restrict__ payload,
                         const int32_t* __restrict__ payload_index, int64_t R, int S,
                         int C, float threshold, float* __restrict__ weights,
                         float* __restrict__ acc_out, float* __restrict__ depth_out,
                         float* __restrict__ expected_out, float* __restrict__ composite) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x / 32) + warp;
  if (r >= R) return;  // whole warps exit together; only __syncwarp below
  const bool with_payload = payload != nullptr;
  const bool staged = kStage == kStageRows && with_payload;
  const int64_t base = r * S;
  float* ray_s = smem + (size_t)warp * ray_smem_floats(S, C, with_payload, kStage);
  float* w_s = kStage == kStageNone ? weights + base : ray_s;
  int32_t* row_s = reinterpret_cast<int32_t*>(ray_s + S);
  float* tile_s = ray_s + 2 * S;  // the ray's payload rows, S x C
  // The payload row of sample s.
  auto row_of = [&](int s) -> int64_t {
    if (kStage != kStageNone) return row_s[s];
    return payload_index != nullptr ? payload_index[base + s] : base + s;
  };

  // The first chunk's inputs of the weight pass, loaded before the copies.
  float d_next = 0.0f, sig_next = 0.0f, t_next = 0.0f;
  if (lane < S) {
    d_next = deltas[base + lane];
    sig_next = density[base + lane];
    if (steps != nullptr) t_next = steps[base + lane];
  }

  // Start the copies of the payload rows.
  if (kStage != kStageNone && with_payload) {
    for (int s = lane; s < S; s += 32) {
      row_s[s] = payload_index != nullptr ? payload_index[base + s] : (int32_t)(base + s);
    }
    __syncwarp();
  }
  if (staged) {
    int s = lane / C, c = lane % C;
    const int q = 32 / C, rem = 32 % C;
#pragma unroll 4
    for (int k = lane; k < S * C; k += 32) {
      cp_async4(tile_s + k, payload + (int64_t)row_s[s] * C + c);
      step32(s, c, q, rem, C);
    }
    cp_async_commit();
  }

  float carry = 0.0f;   // sum of dd over earlier 32-sample chunks
  float wcarry = 0.0f;  // cumulative weight over earlier chunks
  float wsum = 0.0f, wtsum = 0.0f;
  int below = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool valid = s < S;
    const float dd = valid ? __fmul_rn(d_next, sig_next) : 0.0f;
    const float t_s = t_next;
    if (s + 32 < S) {
      d_next = deltas[base + s + 32];
      sig_next = density[base + s + 32];
      if (steps != nullptr) t_next = steps[base + s + 32];
    }
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
      if (kStage != kStageNone) w_s[s] = w;
    }
    if (steps != nullptr) {
      below += __popc(__ballot_sync(kFullMask, valid && cum < threshold));
      wsum += w;
      if (valid) wtsum += w * t_s;
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

  if (with_payload) {
    if (staged) cp_async_wait<0>();
    __syncwarp();  // also orders the weights written to device memory (kStageNone)
    // Each lane sums up to three channels (c, c + 32, c + 64) in one pass
    // over the samples, each in sample order; an unstaged ray's samples in
    // blocks of kBlock, each block's sum then to the total.
    for (int c = lane; c < C; c += 96) {
      const bool has1 = c + 32 < C, has2 = c + 64 < C;
      float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
      if constexpr (kStage == kStageRows) {
        for (int s = 0; s < S; ++s) {
          const float w = w_s[s];
          const float* row = staged ? tile_s + s * C + c : payload + row_of(s) * C + c;
          acc0 += w * row[0];
          if (has1) acc1 += w * row[32];
          if (has2) acc2 += w * row[64];
        }
      } else {
        float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
        for (int s = 0; s < S; ++s) {
          const float w = w_s[s];
          const float* row = payload + row_of(s) * C + c;
          b0 += w * row[0];
          if (has1) b1 += w * row[32];
          if (has2) b2 += w * row[64];
          if (s % kBlock == kBlock - 1 || s == S - 1) {
            acc0 += b0;
            acc1 += b1;
            acc2 += b2;
            b0 = b1 = b2 = 0.0f;
          }
        }
      }
      composite[r * C + c] = acc0;
      if (has1) composite[r * C + c + 32] = acc1;
      if (has2) composite[r * C + c + 64] = acc2;
    }
  }
}

template <int kStage>
cudaError_t launch(int rays, size_t smem, cudaStream_t st, const float* deltas,
                   const float* density, const float* steps, const float* clip,
                   const float* payload, const int32_t* payload_index, int64_t R, int S, int C,
                   float threshold, float* weights, float* acc_out, float* depth_out,
                   float* expected_out, float* composite) {
  cudaError_t err = cudaFuncSetAttribute(volume_render_fwd_kernel<kStage>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  volume_render_fwd_kernel<kStage><<<ceil_div64(R, rays), rays * 32, smem, st>>>(
      deltas, density, steps, clip, payload, payload_index, R, S, C, threshold, weights,
      acc_out, depth_out, expected_out, composite);
  return cudaGetLastError();
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
  const bool with_payload = payload != nullptr;
  if (S < 1 || (with_payload && C < 1)) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  // Stage as much of one ray as fits in shared memory.
  int stage = kStageRows;
  while (stage != kStageNone &&
         ray_smem_floats(S, C, with_payload, stage) * sizeof(float) > (size_t)kSmemLimit) {
    ++stage;
  }
  int rays = kMaxRays;
  const size_t per_ray = (size_t)ray_smem_floats(S, C, with_payload, stage) * sizeof(float);
  while (rays > 1 && rays * per_ray > (size_t)kSmemLimit) rays /= 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = stage == kStageRows      ? &launch<kStageRows>
                   : stage == kStageSamples ? &launch<kStageSamples>
                                            : &launch<kStageNone>;
  return (int)run(rays, rays * per_ray, st, deltas, density, steps, clip, payload,
                  payload_index, R, S, C, threshold, weights, acc_out, depth_out, expected_out,
                  composite);
}
