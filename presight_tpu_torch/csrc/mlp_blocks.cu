// K2 mlp_blocks_fwd: fused expert-grouped small MLP (1-4 layers, ReLU between
// layers, optional sigmoid epilogue).
//
// Replaces presight_tpu/ops/mlp.py::apply_mlp_blocks (:184-212) and
// apply_mlp (:62-75), which stand in for tiny-cuda-nn's FullyFusedMLP. The
// batch is block-padded by expert: every run of `rows_per_group` rows
// (GROUP_BLOCK = 512 on the main path) belongs to one expert, named by
// block_expert. A null block_expert means one expert (the shared proposal
// MLP and apply_mlp).
//
// What bounds it on an H100: the layers are 1..128 wide, far too narrow for
// a matrix unit to pay off in f32, and an unfused version writes every
// intermediate activation (up to 1.58M x 80 floats per head per chunk) to
// device memory and reads it back. Fused, the only traffic is the input and
// output rows; the work is ~27k multiply-adds per sample on the main path,
// so it is bound by the CUDA cores' f32 FMA rate and shared-memory loads.
//
// Design: one CUDA block per tile of kTile rows of one expert. The block
// copies that expert's whole layer stack (the largest, the semantic head,
// is ~50 KB) into dynamic shared memory, loads the input tile with
// coalesced reads, and runs every layer out of shared memory, ping-ponging
// two activation buffers; intermediate activations never reach device
// memory. Each thread owns a 4-row x 4-output register tile of a layer: per
// input k it loads 4 activations and 4 weights and does 16 FMAs, so shared
// memory feeds two FMAs per load. Threads take tiles with the output group
// fastest and a thread's outputs strided by the number of groups, so a
// warp reads few activation rows (as broadcasts) and consecutive weight
// columns; activation rows are padded to an odd stride
// so the rows a warp reads fall in different banks. Each output is still
// summed over k in order from 0, one FMA at a time.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // register tile: rows x outputs per thread
constexpr int kCols = 4;

__global__ void __launch_bounds__(kThreads)
mlp_blocks_fwd_kernel(const float* __restrict__ h, const int32_t* __restrict__ block_expert,
                      int64_t n, int64_t rows_per_group, MlpLayers p, int sigmoid,
                      float* __restrict__ out) {
  extern __shared__ float smem[];
  const int64_t row0 = (int64_t)blockIdx.x * kTile;
  const int rows = (int)min((int64_t)kTile, n - row0);
  const int e = block_expert != nullptr ? block_expert[row0 / rows_per_group] : 0;

  // Expert e's weights and biases, layer after layer.
  float* w_s[kMaxLayers];
  float* b_s[kMaxLayers];
  float* cursor = smem;
  for (int l = 0; l < p.n_layers; ++l) {
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
  float* act_in = cursor;
  float* act_out = cursor + kTile * p.stride;

  const int in0 = p.dim[0];
  const float* __restrict__ hg = h + row0 * in0;
  for (int i = threadIdx.x; i < rows * in0; i += kThreads) {
    act_in[(i / in0) * p.stride + (i % in0)] = hg[i];
  }
  __syncthreads();

  for (int l = 0; l < p.n_layers; ++l) {
    const int fan_in = p.dim[l], fan_out = p.dim[l + 1];
    const bool relu = l < p.n_layers - 1;
    const float* __restrict__ w = w_s[l];
    const float* __restrict__ b = b_s[l];
    const int col_groups = (fan_out + kCols - 1) / kCols;
    const int row_groups = (rows + kRows - 1) / kRows;
    for (int t = threadIdx.x; t < row_groups * col_groups; t += kThreads) {
      // Outputs cg, cg + col_groups, ...: a warp's weight loads for one c
      // hit consecutive addresses.
      const int r0 = (t / col_groups) * kRows, cg = t % col_groups;
      int col[kCols];  // clamped to a valid column; stores are masked below
#pragma unroll
      for (int c = 0; c < kCols; ++c) col[c] = min(cg + c * col_groups, fan_out - 1);
      float acc[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
      const float* a = act_in + r0 * p.stride;
      for (int k = 0; k < fan_in; ++k) {
        float av[kRows], wv[kCols];
#pragma unroll
        for (int r = 0; r < kRows; ++r) av[r] = a[r * p.stride + k];
#pragma unroll
        for (int c = 0; c < kCols; ++c) wv[c] = w[k * fan_out + col[c]];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(av[r], wv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int j = cg + c * col_groups;
          if (r0 + r < rows && j < fan_out) {
            const float s = acc[r][c] + b[j];
            act_out[(r0 + r) * p.stride + j] = relu ? fmaxf(s, 0.0f) : s;
          }
        }
      }
    }
    __syncthreads();
    float* tmp = act_in;
    act_in = act_out;
    act_out = tmp;
  }

  const int out_dim = p.dim[p.n_layers];
  float* __restrict__ og = out + row0 * out_dim;
  for (int i = threadIdx.x; i < rows * out_dim; i += kThreads) {
    float v = act_in[(i / out_dim) * p.stride + (i % out_dim)];
    if (sigmoid) v = 1.0f / (1.0f + expf(-v));
    og[i] = v;
  }
}

}  // namespace

// weights, biases: host arrays of n_layers device pointers; dims: host
// array of n_layers + 1 ints. block_expert may be null (one expert).
PTK_EXPORT int mlp_blocks_fwd(const float* h, const int32_t* block_expert, int64_t n,
                              int64_t rows_per_group, const void* const* weights,
                              const void* const* biases, const int* dims, int n_layers,
                              int sigmoid, float* out, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  if (block_expert != nullptr && rows_per_group % kTile != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  MlpLayers p;
  p.n_layers = n_layers;
  int max_width = 0;
  size_t weight_floats = 0;
  for (int l = 0; l <= n_layers; ++l) {
    p.dim[l] = dims[l];
    max_width = dims[l] > max_width ? dims[l] : max_width;
  }
  for (int l = 0; l < n_layers; ++l) {
    p.w[l] = static_cast<const float*>(weights[l]);
    p.b[l] = static_cast<const float*>(biases[l]);
    weight_floats += (size_t)dims[l] * dims[l + 1] + dims[l + 1];
  }
  p.stride = max_width | 1;
  const size_t smem = (weight_floats + 2 * (size_t)kTile * p.stride) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mlp_blocks_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlp_blocks_fwd_kernel<<<ceil_div64(n, kTile), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      h, block_expert, n, rows_per_group, p, sigmoid, out);
  return (int)cudaGetLastError();
}
