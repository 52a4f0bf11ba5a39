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
// What bounds it on an H100: its instructions. The bytes are few (12 B of
// position in and 4 B of density out per sample, 0.010 ms at 3.35 TB/s for
// a 2.1M-sample render chunk), the rows a chunk reads sit in L2 (a G = 16
// grid, every row in L2, runs no faster), and the first design spent ~450
// instructions a sample (SASS): the 16-way routing loop of separately
// rounded differences, squares and sums (~236) and twelve IEEE divisions
// of ~10 instructions (three by the expert's extent, six by the
// contraction's magnitude, three by 4.0).
//
// Design (v2), every rounding that decides an expert or a cell kept:
//   * Routing in two cheap passes with an exact check. Pass 1 computes
//     A_k = |c_k|^2 - 2 p.c_k with three FMAs (d^2_k less |p|^2) and their
//     minimum; pass 2 counts the experts within W of it, W = 32u (|c|^2_max
//     + 2 |p|_1 |c|_max + |p|^2) with u = 2^-24. |A_k - (d^2_k - |p|^2)| <=
//     6.01u M and the reference's separately rounded d^2 is within 4.0001u
//     (|p|^2 + M) of the true one, M = |c|^2_max + 2 |p|_1 |c|_max, so one
//     expert within W means every other one's rounded d^2 is larger: that
//     expert is the reference's argmin. Otherwise (two centroids within W
//     in squared distance, 3e-5 of a render's samples, or a bound that is
//     not finite) the sample runs the reference's exact loop. Slots past E
//     hold A = +inf.
//   * Divisions: (x + 2) / 4 is fmaf(x, 0.25, 0.5) -- RN(x/4 + 1/2) equals
//     RN(x + 2)/4, as x + 2 is 0 or at least 2^-23 here, so no subnormal
//     is rounded -- and 2t - 1 is fmaf(t, 2, -1), 2t being exact. The
//     contraction divides once by the magnitude for 1/|x| and once per
//     axis; the division by the expert's extent stays __fdiv_rn (a staged
//     reciprocal with one FMA correction is not proven correctly rounded
//     for every input). Seven IEEE divisions remain, four of them only
//     outside the unit cube.
//   * One sample a thread, and at most as many blocks as the card holds at
//     once, each staging the experts once and then looping over tiles: the
//     staging (two dependent rounds of loads and a barrier) per 128
//     samples cost more than the routing it feeds. Four samples a thread
//     (16-byte loads, four gathers in flight) ran no faster: 119 registers
//     left 16 warps an SM, and each IEEE division's branch to its slow path
//     keeps the compiler from interleaving the samples' chains.
// Up to 16 experts run the unrolled passes on 16 slots, up to 64 on 64.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxExperts = 64;
constexpr int kThreads = 128;
constexpr float kBoundScale = 1.9073486e-6f;  // 32u, u = 2^-24

// The reference's expert: argmin of ((dx*dx + dy*dy) + dz*dz), each step
// rounded, first index on ties.
__device__ __noinline__ int exact_expert(float px, float py, float pz,
                                         const float* __restrict__ cent, int E) {
  int e = 0;
  float best = 0.0f;
  for (int k = 0; k < E; ++k) {
    const float dx = __fsub_rn(px, cent[k * 3 + 0]);
    const float dy = __fsub_rn(py, cent[k * 3 + 1]);
    const float dz = __fsub_rn(pz, cent[k * 3 + 2]);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    if (k == 0 || d2 < best) {
      best = d2;
      e = k;
    }
  }
  return e;
}

// One sample's cell: the row it reads, its in-cell offsets and selector.
struct Cell {
  const float4* row;
  float ox, oy, oz, sel;
};

__device__ __forceinline__ Cell locate(float px, float py, float pz, int e, float4 lo,
                                       float4 ext, const float* __restrict__ grid, int G) {
  // AABB normalisation: ((p - lo) / (hi - lo)) * 2 - 1.
  float x = fmaf(__fdiv_rn(__fsub_rn(px, lo.x), ext.x), 2.0f, -1.0f);
  float y = fmaf(__fdiv_rn(__fsub_rn(py, lo.y), ext.y), 2.0f, -1.0f);
  float z = fmaf(__fdiv_rn(__fsub_rn(pz, lo.z), ext.z), 2.0f, -1.0f);
  // L-inf contraction: (2 - 1/|x|) * (x / |x|) outside the unit cube.
  const float mag = fmaxf(fmaxf(fabsf(x), fabsf(y)), fabsf(z));
  if (!(mag < 1.0f)) {
    const float safe = fmaxf(mag, 1e-12f);
    const float k = __fsub_rn(2.0f, __fdiv_rn(1.0f, safe));
    x = __fmul_rn(k, __fdiv_rn(x, safe));
    y = __fmul_rn(k, __fdiv_rn(y, safe));
    z = __fmul_rn(k, __fdiv_rn(z, safe));
  }
  // (x + 2) / 4 and the (0, 1) selector.
  x = fmaf(x, 0.25f, 0.5f);
  y = fmaf(y, 0.25f, 0.5f);
  z = fmaf(z, 0.25f, 0.5f);
  const bool inside = x > 0.0f && x < 1.0f && y > 0.0f && y < 1.0f && z > 0.0f && z < 1.0f;
  Cell cell;
  cell.sel = inside ? 1.0f : 0.0f;
  // (x * sel) * G, as the reference rounds it: x * sel is x or +-0, exact.
  const float g = (float)G, sel_g = cell.sel * g;
  int c[3];
  float off[3];
  const float v[3] = {x, y, z};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float scaled = __fmul_rn(v[a], sel_g);
    const float fl = fminf(fmaxf(floorf(scaled), 0.0f), g - 1.0f);
    off[a] = fminf(fmaxf(__fsub_rn(scaled, fl), 0.0f), 1.0f);
    c[a] = (int)fl;
  }
  cell.ox = off[0];
  cell.oy = off[1];
  cell.oz = off[2];
  const uint32_t row = ((uint32_t)(e * G + c[0]) * G + c[1]) * G + c[2];  // < E G^3 < 2^31
  cell.row = reinterpret_cast<const float4*>(grid) + (size_t)row * 2;
  return cell;
}

__device__ __forceinline__ float blend(const Cell& cell, float4 lo4, float4 hi4) {
  const float v[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
  float dens = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) dens += v[c] * corner_weight(c, cell.ox, cell.oy, cell.oz);
  return dens * cell.sel;
}

// One sample: route, locate, gather, blend.
template <int kE>
__device__ __forceinline__ float density(float px, float py, float pz,
                                         const float* __restrict__ grid, int E, int G,
                                         const float4* route_s, const float4* lo_s,
                                         const float4* ext_s, const float* cent_s,
                                         float cc_max, float cm2) {
  // Pass 1: A_k and their minimum.
  float a[kE];
  float amin = INFINITY;
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const float4 r = route_s[k];
    a[k] = fmaf(px, r.x, fmaf(py, r.y, fmaf(pz, r.z, r.w)));
    amin = fminf(amin, a[k]);
  }
  // Pass 2: the experts within W of the minimum (their count, and the
  // index where there is one).
  const float l1 = fabsf(px) + fabsf(py) + fabsf(pz);
  const float m = fmaf(pz, pz, fmaf(py, py, fmaf(px, px, fmaf(l1, cm2, cc_max))));
  const float thr = amin + fmaf(m, kBoundScale, 1e-30f);
  int found = 0;
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    if (a[k] <= thr) found += 1 + (k << 8);
  }
  const int e = (found & 255) == 1 && thr < INFINITY ? found >> 8
                                                     : exact_expert(px, py, pz, cent_s, E);
  const Cell cell = locate(px, py, pz, e, lo_s[e], ext_s[e], grid, G);
  return blend(cell, __ldg(cell.row), __ldg(cell.row + 1));
}

// One thread a sample; each block stages the experts once and then loops
// over tiles of kThreads samples.
template <int kE>
__global__ void __launch_bounds__(kThreads)
prop_grid_density_kernel(const float* __restrict__ pos, const float* __restrict__ centroids,
                         const float* __restrict__ aabbs, const float* __restrict__ grid,
                         int64_t n, int E, int G, float* __restrict__ out) {
  __shared__ float4 route_s[kE];  // (-2 cx, -2 cy, -2 cz, |c|^2), +inf past E
  __shared__ float4 lo_s[kE], ext_s[kE];
  __shared__ float cent_s[kE * 3];
  __shared__ float bound_s[2];  // max |c|^2, 2 max |c_a|
  for (int k = threadIdx.x; k < kE; k += kThreads) {
    if (k < E) {
      const float cx = centroids[k * 3], cy = centroids[k * 3 + 1], cz = centroids[k * 3 + 2];
      cent_s[k * 3] = cx;
      cent_s[k * 3 + 1] = cy;
      cent_s[k * 3 + 2] = cz;
      route_s[k] = make_float4(-2.0f * cx, -2.0f * cy, -2.0f * cz,
                               __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)),
                                         __fmul_rn(cz, cz)));
      const float* b = aabbs + k * 6;
      lo_s[k] = make_float4(b[0], b[1], b[2], 0.0f);
      ext_s[k] = make_float4(__fsub_rn(b[3], b[0]), __fsub_rn(b[4], b[1]),
                             __fsub_rn(b[5], b[2]), 0.0f);
    } else {
      route_s[k] = make_float4(0.0f, 0.0f, 0.0f, INFINITY);
    }
  }
  if (threadIdx.x < 32) {  // the bound's constants, one warp
    float cc = 0.0f, cm = 0.0f;
    for (int k = threadIdx.x; k < E; k += 32) {
      const float cx = centroids[k * 3], cy = centroids[k * 3 + 1], cz = centroids[k * 3 + 2];
      cc = fmaxf(cc, fmaf(cz, cz, fmaf(cy, cy, cx * cx)));
      cm = fmaxf(cm, fmaxf(fmaxf(fabsf(cx), fabsf(cy)), fabsf(cz)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      cc = fmaxf(cc, __shfl_xor_sync(kFullMask, cc, o));
      cm = fmaxf(cm, __shfl_xor_sync(kFullMask, cm, o));
    }
    if (threadIdx.x == 0) {
      bound_s[0] = cc;
      bound_s[1] = 2.0f * cm;
    }
  }
  __syncthreads();
  const float cc_max = bound_s[0], cm2 = bound_s[1];
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    out[i] = density<kE>(pos[i * 3], pos[i * 3 + 1], pos[i * 3 + 2], grid, E, G, route_s, lo_s,
                         ext_s, cent_s, cc_max, cm2);
  }
}

// One block a tile of kThreads samples, at most as many blocks as the card
// holds at once.
template <int kE>
cudaError_t launch(const float* pos, const float* centroids, const float* aabbs,
                   const float* grid, int64_t n, int E, int G, float* out, cudaStream_t st) {
  static int resident = 0;  // blocks the card holds at once
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prop_grid_density_kernel<kE>,
                                                          kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
  }
  const int64_t tiles = ceil_div64(n, kThreads);
  prop_grid_density_kernel<kE><<<(unsigned)(tiles < resident ? tiles : resident), kThreads, 0,
                                 st>>>(pos, centroids, aabbs, grid, n, E, G, out);
  return cudaGetLastError();
}

}  // namespace

// grid: (E * G^3, 8) f32 cell rows; centroids (E, 3); aabbs (E, 2, 3).
PTK_EXPORT int prop_grid_density_fwd(const float* pos, const float* centroids,
                                     const float* aabbs, const float* grid, int64_t n, int E,
                                     int G, float* out, void* stream) {
  if (E < 1 || E > kMaxExperts || G < 1 || (int64_t)E * G * G * G >= (int64_t(1) << 31)) {
    return (int)cudaErrorInvalidValue;  // the reference's int32 row index has the same limit
  }
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(E <= 16 ? launch<16>(pos, centroids, aabbs, grid, n, E, G, out, st)
                       : launch<kMaxExperts>(pos, centroids, aabbs, grid, n, E, G, out, st));
}
