// The pieces K2 (mlp_blocks.cu) and K2b (mlp_blocks_bwd.cu) share: products
// on the tensor cores at f32 accuracy (3xTF32 on mma.sync m16n8k8), the
// fragment layouts, the activation buffers' strides and the row loads.
//
// 3xTF32 ("fast accurate f32" in CUTLASS): each f32 operand x is split into
// big = tf32(x) and small = tf32(x - big), both rounded to nearest with ties
// away from zero (cvt.rna); acc += a_small*b_big + a_big*b_small + a_big*b_big
// in the f32 accumulator. The dropped a_small*b_small term and the rounding
// of small leave each product ~2^-21 off exact, so sums keep f32 accuracy.
//
// m16n8k8 fragments (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, by column):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// C and A hold different elements, so a layer's output goes back through
// shared memory before it feeds the next layer.
#pragma once

#include "common.cuh"

constexpr int kMaxWidth = 80;          // widest layer the kernels take
constexpr int kMaxN8 = kMaxWidth / 8;  // n8 tiles of the widest layer
constexpr int kWarpRows = 16;          // rows of one warp's m16 tile
constexpr int kSmemPerSm = 233472;     // shared memory of an SM
constexpr int kSmemReserved = 1024;    // the system's share of it per block

// Blocks of `bytes` dynamic shared memory that fit on one SM.
inline int blocks_per_sm(size_t bytes) { return (int)(kSmemPerSm / (bytes + kSmemReserved)); }

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Row stride (floats) of an activation buffer of `cols` columns: the least
// s >= cols with s = 4 (mod 8), so the A-fragment loads of a warp (row g,
// column t) fall in 32 distinct banks and every row starts 16-byte aligned.
__host__ __device__ inline int act_stride(int cols) { return cols + ((12 - cols % 8) % 8); }

// Row stride of a weight matrix kept row-major in shared memory: the least
// s >= cols with s = 8 (mod 16), so B-fragment loads (row t, column g) fall
// in distinct banks.
__host__ __device__ inline int weight_stride(int cols) { return cols + ((24 - cols % 16) % 16); }

// cvt.rna.tf32.f32 for finite x, in two integer operations (ptxas expands
// the instruction with a check for Inf and NaN that the split does not
// need): add half of the kept last place, clear the 13 dropped bits.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(__fsub_rn(x, __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment split in two: b[0], b[1] the big parts of b0, b1; b[2], b[3]
// their small parts.
struct BFrag {
  uint32_t b[4];
};

// d[nt] += A.B[nt] at f32 accuracy for nt < N8: for each accumulator the
// two cross terms first, then big x big. The products are issued term by
// term across the N8 accumulators, so consecutive mma.sync are independent
// and fill the tensor pipe; each accumulator still sees the same three
// products in the same order. Every product of K2 and K2b goes through
// here, so K2b's recomputed forward is bitwise K2's.
template <int N8>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N8][4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], const BFrag (&f)[N8]) {
#pragma unroll
  for (int nt = 0; nt < N8; ++nt) mma_tf32(d[nt], a_small, f[nt].b[0], f[nt].b[1]);
#pragma unroll
  for (int nt = 0; nt < N8; ++nt) mma_tf32(d[nt], a_big, f[nt].b[2], f[nt].b[3]);
#pragma unroll
  for (int nt = 0; nt < N8; ++nt) mma_tf32(d[nt], a_big, f[nt].b[0], f[nt].b[1]);
}

// The raw f32 A fragment of rows [0, 16) and columns [k0, k0 + 8) of a
// row-major buffer: (g, k0 + t), (g + 8, k0 + t), (g, k0 + t + 4),
// (g + 8, k0 + t + 4).
__device__ __forceinline__ float4 frag_a(const float* a, int lda, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = a + g * lda + k0 + t;
  return make_float4(p[0], p[8 * lda], p[4], p[8 * lda + 4]);
}

// The raw f32 B fragment of rows [k0, k0 + 8) and columns [n0, n0 + 8) of a
// row-major matrix b (row stride ldb): (k0 + t, n0 + g), (k0 + t + 4, n0 + g).
__device__ __forceinline__ float2 frag_b(const float* b, int ldb, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = b + (k0 + t) * ldb + n0 + g;
  return make_float2(p[0], p[4 * ldb]);
}

// The same of the transpose of b: B[k][n] = b[n][k].
__device__ __forceinline__ float2 frag_b_t(const float* b, int ldb, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = b + (n0 + g) * ldb + k0 + t;
  return make_float2(p[0], p[4]);
}

// A B fragment as the mma takes it: already split (uint4: big b0, big b1,
// small b0, small b1) or split here.
__device__ __forceinline__ BFrag to_frag(uint4 v) { return BFrag{{v.x, v.y, v.z, v.w}}; }
__device__ __forceinline__ BFrag to_frag(float2 v) {
  BFrag f;
  split_tf32(v.x, f.b[0], f.b[2]);
  split_tf32(v.y, f.b[1], f.b[3]);
  return f;
}

// acc[nt] = A (16 x 8 k_steps) . B (n8 tile nt), for nt < N8: each sum runs
// over the k8 steps in order from 0, three products a step. load_a(ks)
// gives the raw A fragment of step ks (float4), load_b(ks, nt) the B
// fragment (uint4 already split, or raw float2). N8 is a compile-time
// count, so the N8 independent accumulators have no branch between them;
// and the fragments of step ks + 1 are loaded before the products of step
// ks are issued, so shared-memory latency hides behind the tensor pipe.
template <int N8, class LoadA, class LoadB>
__device__ __forceinline__ void warp_product(float (&acc)[N8][4], int k_steps, LoadA load_a,
                                             LoadB load_b) {
  using BRaw = decltype(load_b(0, 0));
#pragma unroll
  for (int nt = 0; nt < N8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
  float4 a_raw = load_a(0);
  BRaw b_raw[N8];
#pragma unroll
  for (int nt = 0; nt < N8; ++nt) b_raw[nt] = load_b(0, nt);
  for (int ks = 0; ks < k_steps; ++ks) {
    uint32_t a_big[4], a_small[4];
    split_tf32(a_raw.x, a_big[0], a_small[0]);
    split_tf32(a_raw.y, a_big[1], a_small[1]);
    split_tf32(a_raw.z, a_big[2], a_small[2]);
    split_tf32(a_raw.w, a_big[3], a_small[3]);
    BFrag f[N8];
#pragma unroll
    for (int nt = 0; nt < N8; ++nt) f[nt] = to_frag(b_raw[nt]);
    if (ks + 1 < k_steps) {
      a_raw = load_a(ks + 1);
#pragma unroll
      for (int nt = 0; nt < N8; ++nt) b_raw[nt] = load_b(ks + 1, nt);
    }
    mma_3xtf32<N8>(acc, a_big, a_small, f);
  }
}

// The A loader of a row-major buffer of 16 rows (row stride lda).
__device__ __forceinline__ auto rows_a(const float* a, int lda) {
  return [=](int ks) { return frag_a(a, lda, ks * 8); };
}

// Calls f(row, col, value) for each element of the warp's C fragments
// (rows [0, 16), columns [0, 8 N8)).
template <int N8, class F>
__device__ __forceinline__ void for_each_c(const float (&acc)[N8][4], F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < N8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) f(g + (i >> 1) * 8, nt * 8 + 2 * t + (i & 1), acc[nt][i]);
}

// Calls f(row, col, v0, v1) for each pair of neighbouring columns (col
// even) of the warp's C fragments.
template <int N8, class F>
__device__ __forceinline__ void for_each_c2(const float (&acc)[N8][4], F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < N8; ++nt) {
    f(g, nt * 8 + 2 * t, acc[nt][0], acc[nt][1]);
    f(g + 8, nt * 8 + 2 * t, acc[nt][2], acc[nt][3]);
  }
}

template <int N>
struct Int {
  static constexpr int value = N;
};

// f(Int<n8>{}) for n8 in 1..kMaxN8: a layer's width as a compile-time count.
template <class F>
__device__ __forceinline__ void with_n8(int n8, F f) {
  switch (n8) {
    case 1: f(Int<1>{}); break;
    case 2: f(Int<2>{}); break;
    case 3: f(Int<3>{}); break;
    case 4: f(Int<4>{}); break;
    case 5: f(Int<5>{}); break;
    case 6: f(Int<6>{}); break;
    case 7: f(Int<7>{}); break;
    case 8: f(Int<8>{}); break;
    case 9: f(Int<9>{}); break;
    default: f(Int<kMaxN8>{}); break;
  }
}

// The epilogue's activations, the same in K2 and K2b.
__device__ __forceinline__ float relu(float v) { return v > 0.0f ? v : 0.0f; }
__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// Floats that layer l's weights and bias take in the staging area (a
// multiple of 4, so every layer starts 16-byte aligned).
__host__ __device__ inline int staged_floats(const MlpLayers& p, int l) {
  return (p.dim[l] * p.dim[l + 1] + p.dim[l + 1] + 3) & ~3;
}

// The whole block copies expert e's weights and biases into the shared
// staging area (16-byte aligned, `capacity` floats, which holds any one
// layer) with cp.async, as many layers at a time as fit, every copy of a
// group in flight at once; then build(l, w, b) (w row-major fan_in x
// fan_out, b fan_out, both in shared memory) lays each layer out for the
// kernel. Returns with the block synchronised.
template <class Build>
__device__ __forceinline__ void stage_layers(float* staging, int capacity, const MlpLayers& p,
                                             int e, Build build) {
  for (int l0 = 0, l1; l0 < p.n_layers; l0 = l1) {
    int used = 0;
    for (l1 = l0; l1 < p.n_layers && used + staged_floats(p, l1) <= capacity; ++l1) {
      const int fan_in = p.dim[l1], fan_out = p.dim[l1 + 1], count = fan_in * fan_out;
      const float* w = p.w[l1] + (int64_t)e * count;
      float* dst = staging + used;
      if (count % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
        for (int i = threadIdx.x * 4; i < count; i += blockDim.x * 4) cp_async16(dst + i, w + i);
      } else {
        for (int i = threadIdx.x; i < count; i += blockDim.x) cp_async4(dst + i, w + i);
      }
      const float* b = p.b[l1] + (int64_t)e * fan_out;
      for (int i = threadIdx.x; i < fan_out; i += blockDim.x) cp_async4(dst + count + i, b + i);
      used += staged_floats(p, l1);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int l = l0, off = 0; l < l1; off += staged_floats(p, l), ++l) {
      build(l, staging + off, staging + off + p.dim[l] * p.dim[l + 1]);
    }
    __syncthreads();
  }
}

// One warp starts copying rows [row0, row0 + 16) of the (n, cols) matrix
// src into dst (row stride ld) with cp.async: 16-byte copies where every
// row is 16-byte aligned (vec), else 4-byte ones (the rgb head's 47-wide
// rows). Rows at or past row_end, and columns [cols, cols_pad), are set
// to zero with plain stores, so padded lanes never hold garbage.
__device__ __forceinline__ void load_rows_async(float* dst, int ld, const float* src, int cols,
                                                int cols_pad, int64_t row0, int64_t row_end,
                                                bool vec) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    const int chunks = cols / 4;
    for (int i = lane; i < kWarpRows * chunks; i += 32) {
      const int r = i / chunks, c = (i % chunks) * 4;
      float* d = dst + r * ld + c;
      if (row0 + r < row_end) {
        cp_async16(d, src + (row0 + r) * cols + c);
      } else {
        d[0] = d[1] = d[2] = d[3] = 0.0f;
      }
    }
  } else {
    for (int i = lane; i < kWarpRows * cols; i += 32) {
      const int r = i / cols, c = i % cols;
      if (row0 + r < row_end) {
        cp_async4(dst + r * ld + c, src + (row0 + r) * cols + c);
      } else {
        dst[r * ld + c] = 0.0f;
      }
    }
  }
  const int pad = cols_pad - cols;
  for (int i = lane; i < kWarpRows * pad; i += 32) dst[(i / pad) * ld + cols + i % pad] = 0.0f;
}
