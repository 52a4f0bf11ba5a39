// K2b mlp_blocks_bwd: backward of K2, the fused expert-grouped small MLP
// (1-4 layers, ReLU between layers, optional sigmoid epilogue).
//
// Replaces XLA's autodiff of presight_tpu/ops/mlp.py::apply_mlp_blocks
// (:184-212; the per-block einsum with each block's expert weights) and of
// apply_mlp (:62-75). Given the input X (n, in), the upstream gradient dY
// (n, out) and the per-expert weights, it gives dX (n, in) and, per expert,
// dW (E, in, out) and db (E, out) summed over every tile of that expert.
//
// What bounds it on an H100: the CUDA cores' f32 FMA rate. Per row it
// recomputes the forward (sum of in*out over layers multiply-adds) and does
// two products per layer (dX and dW), about 3x the forward's work; the
// bytes are the rows of X, dY and dX and a partial dW per tile.
//
// Design: one CUDA block per tile of kTile (64) rows of one expert, as K2.
// The block keeps the expert's weights and every layer's activations for
// its tile in shared memory: it recomputes the forward with K2's
// arithmetic (the same fmaf chain over k from 0, then + bias), so the ReLU
// masks and the sigmoid' of the epilogue are the forward's own, then walks
// the layers backwards: dPre = dAct * (act > 0), partial dW = act^T dPre
// and db = sum_r dPre over the tile's rows, dAct = dPre W^T. The three
// products share K2's register tile: each thread owns 4 x 4 outputs, so
// per step of the inner sum it loads 4 + 4 values from shared memory for
// 16 FMAs (dAct is computed transposed, so a warp's weight loads are
// broadcasts and its gradient loads fall in distinct banks). Each tile
// writes its partial dW and db to a scratch row; a second kernel sums, for
// each expert and weight element, the partials of that expert's tiles in
// tile order. No atomics: the result is deterministic. Sums run in another
// grouping than the plain version's (tiles of 64 rows, then tiles in order,
// against per-512-row blocks), so dW and db agree within float rounding.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

constexpr int kRows = 4;  // register tile: rows x outputs per thread
constexpr int kCols = 4;

// out(m, n) = sum_k a(m, k) * b(k, n) for m < M, n < N, each sum an fmaf
// chain over k from 0 (K2's order). Threads take 4 x 4 tiles, the output
// group fastest and a thread's columns strided by the number of groups.
template <class A, class B, class Store>
__device__ __forceinline__ void tile_product(int M, int N, int K, A a, B b, Store store) {
  const int col_groups = (N + kCols - 1) / kCols;
  const int row_groups = (M + kRows - 1) / kRows;
  for (int t = threadIdx.x; t < row_groups * col_groups; t += kThreads) {
    const int m0 = (t / col_groups) * kRows, cg = t % col_groups;
    int row[kRows], col[kCols];  // clamped to valid indices; stores are masked
#pragma unroll
    for (int r = 0; r < kRows; ++r) row[r] = min(m0 + r, M - 1);
#pragma unroll
    for (int c = 0; c < kCols; ++c) col[c] = min(cg + c * col_groups, N - 1);
    float acc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
    for (int k = 0; k < K; ++k) {
      float av[kRows], bv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) av[r] = a(row[r], k);
#pragma unroll
      for (int c = 0; c < kCols; ++c) bv[c] = b(k, col[c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = cg + c * col_groups;
        if (m0 + r < M && j < N) store(m0 + r, j, acc[r][c]);
      }
  }
}

// c[r][j] = sum_k a[r][k] * w[k][j] + b[j] (ReLU), K2's arithmetic.
__device__ void layer_forward(const float* a, const float* w, const float* b, float* c,
                              int rows, int fan_in, int fan_out, int stride, bool relu) {
  tile_product(
      rows, fan_out, fan_in, [&](int m, int k) { return a[m * stride + k]; },
      [&](int k, int n) { return w[k * fan_out + n]; },
      [&](int m, int n, float v) {
        const float s = v + b[n];
        c[m * stride + n] = relu ? fmaxf(s, 0.0f) : s;
      });
}

__global__ void __launch_bounds__(kThreads)
mlp_blocks_bwd_kernel(const float* __restrict__ h, const int32_t* __restrict__ block_expert,
                      const float* __restrict__ dout, int64_t n, int64_t rows_per_group,
                      MlpLayers p, int sigmoid, int64_t partial_size,
                      float* __restrict__ dx, float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int64_t row0 = (int64_t)blockIdx.x * kTile;
  const int rows = (int)min((int64_t)kTile, n - row0);
  const int e = block_expert != nullptr ? block_expert[row0 / rows_per_group] : 0;
  const int L = p.n_layers, S = p.stride;

  float* w_s[kMaxLayers];
  float* b_s[kMaxLayers];
  float* act[kMaxLayers + 1];  // act[0] = X, act[l + 1] = output of layer l
  float* cursor = smem;
  for (int l = 0; l < L; ++l) {
    const int fan_in = p.dim[l], fan_out = p.dim[l + 1];
    w_s[l] = cursor;
    cursor += fan_in * fan_out;
    b_s[l] = cursor;
    cursor += fan_out;
    const float* __restrict__ wg = p.w[l] + (int64_t)e * fan_in * fan_out;
    const float* __restrict__ bg = p.b[l] + (int64_t)e * fan_out;
    for (int i = threadIdx.x; i < fan_in * fan_out; i += kThreads) w_s[l][i] = wg[i];
    for (int i = threadIdx.x; i < fan_out; i += kThreads) b_s[l][i] = bg[i];
  }
  for (int l = 0; l <= L; ++l) {
    act[l] = cursor;
    cursor += kTile * S;
  }
  float* g_cur = cursor;
  float* g_next = cursor + kTile * S;

  const int in0 = p.dim[0], out_dim = p.dim[L];
  for (int i = threadIdx.x; i < rows * in0; i += kThreads) {
    act[0][(i / in0) * S + (i % in0)] = h[row0 * in0 + i];
  }
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    layer_forward(act[l], w_s[l], b_s[l], act[l + 1], rows, p.dim[l], p.dim[l + 1], S, l < L - 1);
    __syncthreads();
  }

  // dY, through the sigmoid epilogue: d pre = dY * s * (1 - s).
  for (int i = threadIdx.x; i < rows * out_dim; i += kThreads) {
    const int r = i / out_dim, j = i % out_dim;
    float g = dout[row0 * out_dim + i];
    if (sigmoid) {
      const float s = 1.0f / (1.0f + expf(-act[L][r * S + j]));
      g = g * (s * (1.0f - s));
    }
    g_cur[r * S + j] = g;
  }
  __syncthreads();

  float* part = partial + (int64_t)blockIdx.x * partial_size;
  int64_t offset = 0;
  for (int l = 0; l < L; ++l) offset += (int64_t)p.dim[l] * p.dim[l + 1] + p.dim[l + 1];
  for (int l = L - 1; l >= 0; --l) {
    const int fan_in = p.dim[l], fan_out = p.dim[l + 1];
    offset -= (int64_t)fan_in * fan_out + fan_out;
    if (l < L - 1) {  // ReLU: the gradient passes where the output was > 0
      for (int i = threadIdx.x; i < rows * fan_out; i += kThreads) {
        const int r = i / fan_out, j = i % fan_out;
        if (!(act[l + 1][r * S + j] > 0.0f)) g_cur[r * S + j] = 0.0f;
      }
      __syncthreads();
    }
    // partial dW[k][j] = sum_r act[r][k] * g[r][j]; db[j] = sum_r g[r][j].
    const float* a_l = act[l];
    const float* g_l = g_cur;
    float* dw_part = part + offset;
    tile_product(
        fan_in, fan_out, rows, [&](int k, int r) { return a_l[r * S + k]; },
        [&](int r, int j) { return g_l[r * S + j]; },
        [&](int k, int j, float v) { dw_part[k * fan_out + j] = v; });
    for (int j = threadIdx.x; j < fan_out; j += kThreads) {
      float acc = 0.0f;
      for (int r = 0; r < rows; ++r) acc += g_cur[r * S + j];
      part[offset + (int64_t)fan_in * fan_out + j] = acc;
    }
    // dAct[r][k] = sum_j W[k][j] * g[r][j], as the product (k, r).
    const float* w = w_s[l];
    float* g_out = g_next;
    tile_product(
        fan_in, rows, fan_out, [&](int k, int j) { return w[k * fan_out + j]; },
        [&](int j, int r) { return g_l[r * S + j]; },
        [&](int k, int r, float v) { g_out[r * S + k] = v; });
    __syncthreads();
    float* tmp = g_cur;
    g_cur = g_next;
    g_next = tmp;
  }
  for (int i = threadIdx.x; i < rows * in0; i += kThreads) {
    dx[row0 * in0 + i] = g_cur[(i / in0) * S + (i % in0)];
  }
}

struct LayerGrads {
  float* dw[kMaxLayers];  // (E, in, out)
  float* db[kMaxLayers];  // (E, out)
};

// For each expert and element of the flattened [dW_0 | db_0 | dW_1 | ...]
// layout: the sum, in tile order, of the partials of that expert's tiles.
__global__ void mlp_blocks_bwd_reduce_kernel(const float* __restrict__ partial,
                                             const int32_t* __restrict__ block_expert,
                                             int64_t num_tiles, int64_t rows_per_group,
                                             int num_experts, MlpLayers p, LayerGrads g,
                                             int64_t partial_size) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)num_experts * partial_size) return;
  const int e = (int)(i / partial_size);
  const int64_t q = i % partial_size;
  float acc = 0.0f;
  for (int64_t t = 0; t < num_tiles; ++t) {
    const int te = block_expert != nullptr ? block_expert[(t * kTile) / rows_per_group] : 0;
    if (te == e) acc += partial[t * partial_size + q];
  }
  int64_t offset = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const int64_t nw = (int64_t)p.dim[l] * p.dim[l + 1], nb = p.dim[l + 1];
    if (q < offset + nw) {
      g.dw[l][e * nw + (q - offset)] = acc;
      return;
    }
    if (q < offset + nw + nb) {
      g.db[l][e * nb + (q - offset - nw)] = acc;
      return;
    }
    offset += nw + nb;
  }
}

}  // namespace

// weights, biases, dweights, dbiases: host arrays of n_layers device
// pointers; dims: host array of n_layers + 1 ints. block_expert may be null
// (one expert). partial: scratch of ceil(n / 64) * sum(in * out + out)
// floats. dx (n, in); dweights[l] (E, in, out) and dbiases[l] (E, out) are
// written in full.
PTK_EXPORT int mlp_blocks_bwd(const float* h, const int32_t* block_expert, const float* dout,
                              int64_t n, int64_t rows_per_group, int num_experts,
                              const void* const* weights, const void* const* biases,
                              const int* dims, int n_layers, int sigmoid, float* dx,
                              void* const* dweights, void* const* dbiases, float* partial,
                              void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  if (block_expert != nullptr && rows_per_group % kTile != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  MlpLayers p;
  LayerGrads g;
  p.n_layers = n_layers;
  int max_width = 0;
  int64_t partial_size = 0;
  for (int l = 0; l <= n_layers; ++l) {
    p.dim[l] = dims[l];
    max_width = dims[l] > max_width ? dims[l] : max_width;
  }
  for (int l = 0; l < n_layers; ++l) {
    p.w[l] = static_cast<const float*>(weights[l]);
    p.b[l] = static_cast<const float*>(biases[l]);
    g.dw[l] = static_cast<float*>(dweights[l]);
    g.db[l] = static_cast<float*>(dbiases[l]);
    partial_size += (int64_t)dims[l] * dims[l + 1] + dims[l + 1];
  }
  p.stride = max_width | 1;
  const size_t smem =
      ((size_t)partial_size + (size_t)(n_layers + 3) * kTile * p.stride) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mlp_blocks_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t num_tiles = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mlp_blocks_bwd_kernel<<<(unsigned)num_tiles, kThreads, smem, s>>>(
      h, block_expert, dout, n, rows_per_group, p, sigmoid, partial_size, dx, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  mlp_blocks_bwd_reduce_kernel<<<ceil_div64((int64_t)num_experts * partial_size, threads),
                                 threads, 0, s>>>(partial, block_expert, num_tiles,
                                                  rows_per_group, num_experts, p, g,
                                                  partial_size);
  return (int)cudaGetLastError();
}
