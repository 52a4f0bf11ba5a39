// K4 prop_grid_density_fwd: density of the cached first-round proposal grid.
//
// Replaces presight_tpu/fields/prop_field.py::prop_grid_density (:160-182),
// which reads a per-expert dense G^3 grid of cell rows (8 corner densities
// per row, _CORNER_BITS order) refreshed from the fine proposal field.
// Fused per sample:
//   nearest-centroid expert (argmin of squared distance, first on ties,
//   fields/router.py::assign_experts);
//   AABB normalisation, L-inf contraction and [0,1] mapping with the
//   out-of-range selector (ops/math.py::contract_positions, :69-83);
//   floor clipped to [0, G-1], in-cell offset clipped to [0, 1];
//   one 8-float row gather, trilinear blend, times the selector.
//
// What bounds it on an H100: the row gather. The main path samples
// 32768 rays x 64 = 2.1M points per chunk, each reading one 32-byte row of
// the 134-MB grid (random in the grid, but rays are spatially coherent, so
// neighbouring samples share rows in L2) and ~60 FLOPs of routing and
// contraction. Unfused, the reference materialises the (N, E) distance
// matrix, the per-sample AABBs and five intermediate (N, 3) arrays.
//
// Design: one thread per sample; the E centroids and AABBs are staged in
// shared memory; the 8-float row is read as two float4 loads (rows are
// 32-byte aligned). Every operation whose rounding decides a cell or an
// expert is written with explicitly rounded intrinsics, so the compiler
// cannot contract it into an FMA and disagree with the reference about which
// cell or expert a sample falls in.
#include "common.cuh"

namespace {

constexpr int kMaxExperts = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float contract_linf_axis(float v, float mag, float safe_mag) {
  // (2 - 1/|x|) * (x/|x|) outside the unit cube, x inside.
  return mag < 1.0f ? v
                    : __fmul_rn(__fsub_rn(2.0f, __fdiv_rn(1.0f, safe_mag)),
                                __fdiv_rn(v, safe_mag));
}

__global__ void __launch_bounds__(kThreads)
prop_grid_density_kernel(const float* __restrict__ pos, const float* __restrict__ centroids,
                         const float* __restrict__ aabbs, const float* __restrict__ grid,
                         int64_t n, int E, int G, float* __restrict__ out) {
  __shared__ float cent_s[kMaxExperts * 3];
  __shared__ float aabb_s[kMaxExperts * 6];
  for (int i = threadIdx.x; i < E * 3; i += kThreads) cent_s[i] = centroids[i];
  for (int i = threadIdx.x; i < E * 6; i += kThreads) aabb_s[i] = aabbs[i];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;

  const float p[3] = {pos[i * 3 + 0], pos[i * 3 + 1], pos[i * 3 + 2]};
  int e = 0;
  float best = 0.0f;
  for (int k = 0; k < E; ++k) {
    const float dx = __fsub_rn(p[0], cent_s[k * 3 + 0]);
    const float dy = __fsub_rn(p[1], cent_s[k * 3 + 1]);
    const float dz = __fsub_rn(p[2], cent_s[k * 3 + 2]);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    if (k == 0 || d2 < best) {
      best = d2;
      e = k;
    }
  }

  float x[3];
  for (int a = 0; a < 3; ++a) {
    const float lo = aabb_s[e * 6 + a], hi = aabb_s[e * 6 + 3 + a];
    const float t = __fdiv_rn(__fsub_rn(p[a], lo), __fsub_rn(hi, lo));
    x[a] = __fsub_rn(__fmul_rn(t, 2.0f), 1.0f);
  }
  const float mag = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fabsf(x[2]));
  const float safe_mag = fmaxf(mag, 1e-12f);
  bool inside = true;
  for (int a = 0; a < 3; ++a) {
    x[a] = __fdiv_rn(__fadd_rn(contract_linf_axis(x[a], mag, safe_mag), 2.0f), 4.0f);
    inside = inside && x[a] > 0.0f && x[a] < 1.0f;
  }
  const float sel = inside ? 1.0f : 0.0f;

  int cell[3];
  float off[3];
  const float g = (float)G;
  for (int a = 0; a < 3; ++a) {
    const float scaled = __fmul_rn(__fmul_rn(x[a], sel), g);
    const float fl = fminf(fmaxf(floorf(scaled), 0.0f), g - 1.0f);
    off[a] = fminf(fmaxf(__fsub_rn(scaled, fl), 0.0f), 1.0f);
    cell[a] = (int)fl;
  }
  const int64_t cidx = ((int64_t)cell[0] * G + cell[1]) * G + cell[2];
  const float4* row = reinterpret_cast<const float4*>(grid + ((int64_t)e * G * G * G + cidx) * 8);
  const float4 lo4 = __ldg(row), hi4 = __ldg(row + 1);
  const float v[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
  float dens = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) dens += v[c] * corner_weight(c, off[0], off[1], off[2]);
  out[i] = dens * sel;
}

}  // namespace

// grid: (E * G^3, 8) f32 cell rows; centroids (E, 3); aabbs (E, 2, 3).
PTK_EXPORT int prop_grid_density_fwd(const float* pos, const float* centroids,
                                     const float* aabbs, const float* grid, int64_t n, int E,
                                     int G, float* out, void* stream) {
  if (E < 1 || E > kMaxExperts || G < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  prop_grid_density_kernel<<<ceil_div64(n, kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      pos, centroids, aabbs, grid, n, E, G, out);
  return (int)cudaGetLastError();
}
