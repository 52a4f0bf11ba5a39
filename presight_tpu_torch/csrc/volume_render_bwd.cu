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
//   reads are zero).
//
// What bounds it on an H100: device memory. Per sample it reads delta,
// sigma, t, w, dL/dw and its payload row and writes dsigma and the payload
// row's gradient; a few tens of FLOPs per sample.
//
// Design (v2): one warp per ray, as K3, and up to four rays per CUDA
// block. Each warp first starts cp.async copies of its ray's S payload rows
// (through payload_index; 48 x 67 floats, 12.9 KB on the main path) and of
// dL/dcomposite into shared memory, all in flight at once, so a block keeps
// ~50 KB of loads outstanding. While they fly, pass 1 recomputes the
// exclusive prefix of dd with K3's warp scan (so T_s is K3's) and the sums
// a and b in K3's order (so the expected depth, and a tie with the clip
// bounds, are K3's). Pass 2 gives each lane its own samples: the dot
// product of a payload row with dL/dcomposite runs over the staged row in
// shared memory (row stride C; an odd C, 67 on the main path, puts the 32
// lanes' rows in 32 different banks), with no warp reduction. The payload
// gradient rows are written from shared memory with the lanes over the
// flattened (sample, channel) index, so consecutive lanes write
// consecutive floats of a row. Pass 3 runs over the samples from the last
// chunk to the first with a reverse warp scan and a carry, for the suffix
// sums. Rows of d_payload that no sample reads (padding slots) are zeroed
// by one memset in the same call. The weights-only launch (proposal
// rounds) runs passes 1 and 3.
//
// A ray is staged only as far as shared memory holds it (kSmemLimit, one
// ray a block at least): where its S x C payload rows do not fit (4S + C +
// S * C floats above 58,112: S > 817 at C = 67), passes 2 read them from
// device memory; where the per-sample arrays do not fit either (4S + C
// floats with a payload, 3S without), w_s is read from `weights`, the row
// indices from payload_index, dL/dcomposite from g_comp, gw_s is kept in
// d_density (each lane rewrites only its own samples) and T_s in a scratch
// buffer of R x S floats that the wrapper allocates for such rays only
// (volume_render_bwd_scratch_floats). Every path recomputes T_s, a and b as
// K3 does and sums in the same order, so K3b takes a ray of any length and
// gives the same bits on each.
#include <float.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxRays = 4;  // rays (warps) per CUDA block

// How much of a ray lives in shared memory (as in K3): the per-sample
// arrays, dL/dcomposite and the payload rows (kStageRows), all but the
// payload rows (kStageSamples), or nothing (kStageNone).
enum Stage { kStageRows, kStageSamples, kStageNone };

__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  // d/dx min(max(x, lo), hi) as JAX differentiates it (0.5 at a tie).
  const float a = x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
  const float m = fmaxf(x, lo);
  const float b = m < hi ? 1.0f : (m == hi ? 0.5f : 0.0f);
  return a * b;
}

// Floats of shared memory per ray at a stage: T_s, gw_s, w_s, and with a
// payload the row index of each sample, dL/dcomposite and at kStageRows the
// S x C payload rows.
__host__ __device__ inline int64_t ray_smem_floats(int S, int C, bool with_payload, int stage) {
  if (stage == kStageNone) return 0;
  return 3 * (int64_t)S +
         (with_payload ? S + C + (stage == kStageRows ? (int64_t)S * C : 0) : 0);
}

int ray_stage(int S, int C, bool with_payload) {
  int stage = kStageRows;
  while (stage != kStageNone &&
         ray_smem_floats(S, C, with_payload, stage) * sizeof(float) > (size_t)kSmemLimit) {
    ++stage;
  }
  return stage;
}

template <int kStage>
__global__ void __launch_bounds__(kMaxRays * 32)
volume_render_bwd_kernel(const float* __restrict__ deltas, const float* __restrict__ density,
                         const float* __restrict__ steps, const float* __restrict__ clip,
                         const float* __restrict__ payload,
                         const int32_t* __restrict__ payload_index,
                         const float* __restrict__ weights, const float* __restrict__ g_w,
                         const float* __restrict__ g_acc, const float* __restrict__ g_exp,
                         const float* __restrict__ g_comp, int64_t R, int S, int C,
                         float* __restrict__ d_density, float* __restrict__ d_payload,
                         float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x / 32) + warp;
  if (r >= R) return;  // whole warps exit together; only __syncwarp below
  const bool with_payload = payload != nullptr;
  constexpr bool kStaged = kStage != kStageNone;
  const int64_t base = r * S;
  float* ray_s = smem + (size_t)warp * ray_smem_floats(S, C, with_payload, kStage);
  float* trans_s = kStaged ? ray_s : scratch + base;        // T_s
  float* gw_s = kStaged ? ray_s + S : d_density + base;     // dL/dw_s, then gw_s
  float* w_stage = ray_s + 2 * S;                           // w_s, when staged
  const float* w_s = kStaged ? w_stage : weights + base;
  int32_t* row_s = reinterpret_cast<int32_t*>(ray_s + 3 * S);  // payload row of each sample
  float* gc_stage = ray_s + 4 * S;                          // dL/dcomposite, when staged
  const float* gc_s = kStaged || !with_payload ? gc_stage : g_comp + r * C;
  float* tile_s = gc_stage + C;  // the ray's payload rows, S x C (kStageRows)
  const int q = with_payload ? 32 / C : 0, rem = with_payload ? 32 % C : 0;
  // The payload row of sample s.
  auto row_of = [&](int s) -> int64_t {
    if (kStaged) return row_s[s];
    return payload_index != nullptr ? payload_index[base + s] : base + s;
  };

  // Start the copies of the payload rows and of dL/dcomposite.
  if (kStaged && with_payload) {
    for (int s = lane; s < S; s += 32) {
      row_s[s] = payload_index != nullptr ? payload_index[base + s] : (int32_t)(base + s);
    }
    for (int c = lane; c < C; c += 32) cp_async4(gc_stage + c, g_comp + r * C + c);
    __syncwarp();
    if (kStage == kStageRows) {
      int s = lane / C, c = lane % C;
      for (int k = lane; k < S * C; k += 32) {
        cp_async4(tile_s + k, payload + (int64_t)row_s[s] * C + c);
        step32(s, c, q, rem, C);
      }
    }
    cp_async_commit();
  }

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
    if (valid && (steps != nullptr || with_payload)) {
      const float w = weights[base + s];
      if (kStaged) w_stage[s] = w;
      if (steps != nullptr) {
        wsum += w;
        wtsum += w * steps[base + s];
      }
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
  if (kStaged && with_payload) cp_async_wait<0>();
  __syncwarp();

  // Pass 2: each lane the gradient of its own samples' weights.
  for (int s = lane; s < S; s += 32) {
    float gw = gw_s[s];
    if (with_payload) {
      const float* row = kStage == kStageRows ? tile_s + s * C : payload + row_of(s) * C;
      float dot = 0.0f;
      for (int c = 0; c < C; ++c) dot += gc_s[c] * row[c];
      gw += dot;
    }
    if (steps != nullptr) {
      gw += g_acc[r];
      gw += ge * steps[base + s] * inv_b - ge * a_over_b2;
    }
    gw_s[s] = gw;
  }
  // The payload rows' gradients, consecutive lanes on consecutive floats.
  if (with_payload) {
    // (S x C may pass 2^31 only where the rows are not staged.)
    using Index = typename std::conditional<kStage == kStageRows, int, int64_t>::type;
    int s = lane / C, c = lane % C;
    for (Index k = lane; k < (Index)S * C; k += 32) {
      d_payload[row_of(s) * C + c] = w_s[s] * gc_s[c];
      step32(s, c, q, rem, C);
    }
  }
  __syncwarp();

  // Pass 3: dsigma_j = delta_j (gw_j T_j e^{-dd_j} - sum_{s>j} gw_s alpha_s T_s).
  float suffix = 0.0f;  // sum over the chunks after the current one
  const int last0 = ((S - 1) / 32) * 32;
  for (int s0 = last0; s0 >= 0; s0 -= 32) {
    const int s = s0 + lane;
    const bool valid = s < S;
    float gw = 0.0f, qv = 0.0f, e_dd = 0.0f, delta = 0.0f;
    if (valid) {
      delta = deltas[base + s];
      const float dd = __fmul_rn(delta, density[base + s]);
      e_dd = expf(-dd);
      const float T = trans_s[s];
      const float alpha = __fsub_rn(1.0f, e_dd);
      const float w_raw = __fmul_rn(alpha, T);
      gw = isfinite(w_raw) ? gw_s[s] : 0.0f;
      qv = gw * alpha * T;
      gw *= T * e_dd;
    }
    // Reverse inclusive scan of qv over the lanes, then shift by one lane.
    float v = qv;
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

template <int kStage>
cudaError_t launch(int rays, size_t smem, cudaStream_t st, const float* deltas,
                   const float* density, const float* steps, const float* clip,
                   const float* payload, const int32_t* payload_index, const float* weights,
                   const float* g_w, const float* g_acc, const float* g_exp, const float* g_comp,
                   int64_t R, int S, int C, float* d_density, float* d_payload, float* scratch) {
  cudaError_t err = cudaFuncSetAttribute(volume_render_bwd_kernel<kStage>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  volume_render_bwd_kernel<kStage><<<ceil_div64(R, rays), rays * 32, smem, st>>>(
      deltas, density, steps, clip, payload, payload_index, weights, g_w, g_acc, g_exp, g_comp,
      R, S, C, d_density, d_payload, scratch);
  return cudaGetLastError();
}

}  // namespace

// Floats of the scratch buffer volume_render_bwd needs for R rays of S
// samples (0 unless a ray's per-sample arrays do not fit in shared memory).
PTK_EXPORT int64_t volume_render_bwd_scratch_floats(int64_t R, int S, int C, int with_payload) {
  return ray_stage(S, C, with_payload != 0) == kStageNone ? R * S : 0;
}

// steps, clip, g_acc and g_exp are null together (weights only); payload,
// g_comp and d_payload are null together (P payload rows of C floats);
// payload_index may be null (rows in sample order). clip is a device pointer
// to {min, max} of steps. d_payload is zeroed here, then written. scratch
// holds volume_render_bwd_scratch_floats(R, S, C, payload != null) floats
// (null where that is 0).
PTK_EXPORT int volume_render_bwd(const float* deltas, const float* density, const float* steps,
                                 const float* clip, const float* payload,
                                 const int32_t* payload_index, const float* weights,
                                 const float* g_w, const float* g_acc, const float* g_exp,
                                 const float* g_comp, int64_t R, int S, int C, int64_t P,
                                 float* d_density, float* d_payload, float* scratch,
                                 void* stream) {
  const bool with_payload = payload != nullptr;
  if (S < 1 || (with_payload && C < 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (with_payload) {
    cudaError_t err = cudaMemsetAsync(d_payload, 0, (size_t)P * C * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  if (R == 0) return (int)cudaGetLastError();
  const int stage = ray_stage(S, C, with_payload);
  if (stage == kStageNone && scratch == nullptr) return (int)cudaErrorInvalidValue;
  int rays = kMaxRays;
  const size_t per_ray = (size_t)ray_smem_floats(S, C, with_payload, stage) * sizeof(float);
  while (rays > 1 && rays * per_ray > (size_t)kSmemLimit) rays /= 2;
  const auto run = stage == kStageRows      ? &launch<kStageRows>
                   : stage == kStageSamples ? &launch<kStageSamples>
                                            : &launch<kStageNone>;
  return (int)run(rays, rays * per_ray, st, deltas, density, steps, clip, payload,
                  payload_index, weights, g_w, g_acc, g_exp, g_comp, R, S, C, d_density,
                  d_payload, scratch);
}
