// K2 mlp_blocks_fwd: fused expert-grouped small MLP (1-4 layers, ReLU between
// layers, optional sigmoid epilogue), on the tensor cores at f32 accuracy.
//
// Replaces presight_tpu/ops/mlp.py::apply_mlp_blocks (:184-212) and
// apply_mlp (:62-75), which stand in for tiny-cuda-nn's FullyFusedMLP. The
// batch is block-padded by expert: every run of `rows_per_group` rows
// (GROUP_BLOCK = 512 on the main path) belongs to one expert, named by
// block_expert. A null block_expert means one expert (the shared proposal
// MLP and apply_mlp).
//
// What bounds it on an H100: each head is a chain of small matrix products
// (~27k multiply-adds per sample on the main path). On the CUDA cores'
// f32 FMAs that is bound by operations; on the tensor cores in 3xTF32
// (three TF32 products per f32 product, 495/3 TFLOP/s) the base MLP on a
// render chunk needs ~0.15 ms of arithmetic against ~0.23 ms to read its
// inputs and write its outputs once, so at the published rates it is bound
// by bytes. In practice the tensor pipe (mma.sync reaches only part of the
// 495), the shared-memory loads that feed it (a 16-byte B fragment per
// three mma, every 16 rows) and the per-row epilogue are what it waits on.
//
// Design: every product is mma.sync m16n8k8 TF32 with the 3xTF32 split
// (mlp_mma.cuh), so the sums keep f32 accuracy. A CUDA block takes
// rows_per_cta consecutive rows (a multiple of 64 inside one expert block,
// chosen by the wrapper so a launch has at least two blocks per SM) and
// loads its expert's whole layer stack into shared memory once (staged
// with cp.async), split into big and small TF32 parts and laid out in
// B-fragment order (one 16-byte load per lane per fragment, no bank
// conflicts); K and N are padded to multiples of 8 with zeros. A block has
// 4 or 8 warps, whichever keeps more warps on an SM. Each warp then walks
// 16-row tiles of the block's rows on its own: it copies the next tile's
// input rows with cp.async into its second buffer while it computes the
// current one, and chains the layers through its own 16 rows of shared
// memory (C fragments back to rows, then A fragments), with __syncwarp
// only: no block-wide barrier after the weights are loaded. A layer's n8
// tiles are a compile-time count (with_n8), so their independent mma
// chains overlap. The last layer's epilogue (bias, sigmoid) goes back to
// the warp's rows, which it then writes out with coalesced stores.
#include "mlp_mma.cuh"

namespace {

constexpr int kMinWarps = 4;
constexpr int kMaxWarps = 8;

struct FwdShape {
  int k8[kMaxLayers];     // k8 steps of layer l (input width / 8, rounded up)
  int n8[kMaxLayers];     // n8 tiles of layer l
  int frag_off[kMaxLayers];  // first uint4 of layer l's fragments
  int bias_off[kMaxLayers];  // first float of layer l's padded bias
  int stride;             // activation row stride
};

__global__ void __launch_bounds__(kMaxWarps * 32)
mlp_blocks_fwd_kernel(const float* __restrict__ h, const int32_t* __restrict__ block_expert,
                      int64_t n, int64_t rows_per_group, int64_t rows_per_cta, MlpLayers p,
                      FwdShape s, int sigmoid_out, bool vec, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* frags = reinterpret_cast<uint4*>(smem_raw);  // then biases, then row buffers
  const int L = p.n_layers;
  float* bias =
      reinterpret_cast<float*>(frags + s.frag_off[L - 1] + s.k8[L - 1] * s.n8[L - 1] * 32);
  float* act = bias + s.bias_off[L - 1] + s.n8[L - 1] * 8;

  const int64_t row_begin = (int64_t)blockIdx.x * rows_per_cta;
  const int64_t row_end = min(row_begin + rows_per_cta, n);
  const int e = block_expert != nullptr ? block_expert[row_begin / rows_per_group] : 0;

  // Expert e's stack, split, in B-fragment order: element (ks, nt, lane)
  // holds W[8 ks + t][8 nt + g] and W[8 ks + t + 4][8 nt + g], big then
  // small. The layers are staged in the (not yet used) row buffers.
  const int S = s.stride;
  stage_layers(act, (int)(blockDim.x / 32) * 2 * kWarpRows * S, p, e,
               [&](int l, const float* w, const float* b) {
                 const int fan_in = p.dim[l], fan_out = p.dim[l + 1];
                 const int count = s.k8[l] * s.n8[l] * 32;
                 for (int i = threadIdx.x; i < count; i += blockDim.x) {
                   const int lane = i & 31, tile = i >> 5;
                   const int k = (tile / s.n8[l]) * 8 + (lane & 3);
                   const int j = (tile % s.n8[l]) * 8 + (lane >> 2);
                   const float w0 = (k < fan_in && j < fan_out) ? w[k * fan_out + j] : 0.0f;
                   const float w1 = (k + 4 < fan_in && j < fan_out) ? w[(k + 4) * fan_out + j]
                                                                    : 0.0f;
                   uint4 f;
                   split_tf32(w0, f.x, f.z);
                   split_tf32(w1, f.y, f.w);
                   frags[s.frag_off[l] + i] = f;
                 }
                 for (int j = threadIdx.x; j < s.n8[l] * 8; j += blockDim.x) {
                   bias[s.bias_off[l] + j] = j < fan_out ? b[j] : 0.0f;
                 }
               });

  const int warp = threadIdx.x >> 5, num_warps = blockDim.x >> 5;
  const int in0 = p.dim[0], out_dim = p.dim[L];
  float* const buf0 = act + warp * 2 * kWarpRows * S;  // the warp's two row buffers
  const int tiles = (int)((row_end - row_begin + kWarpRows - 1) / kWarpRows);
  if (warp < tiles) {
    load_rows_async(buf0, S, h, in0, s.k8[0] * 8, row_begin + warp * kWarpRows, row_end, vec);
  }
  cp_async_commit();
  for (int tile = warp, it = 0; tile < tiles; tile += num_warps, ++it) {
    float* cur = buf0 + (it & 1) * kWarpRows * S;
    const int64_t row0 = row_begin + (int64_t)tile * kWarpRows;
    if (tile + num_warps < tiles) {
      load_rows_async(buf0 + ((it + 1) & 1) * kWarpRows * S, S, h, in0, s.k8[0] * 8,
                      row0 + num_warps * kWarpRows, row_end, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    for (int l = 0; l < L; ++l) {
      const uint4* f = frags + s.frag_off[l];
      const float* b = bias + s.bias_off[l];
      const int n8 = s.n8[l];
      with_n8(n8, [&](auto n8c) {
        constexpr int N8 = decltype(n8c)::value;
        float acc[N8][4];
        warp_product<N8>(acc, s.k8[l], rows_a(cur, S), [&](int ks, int nt) {
          return f[(ks * N8 + nt) * 32 + (threadIdx.x & 31)];
        });
        __syncwarp();  // every lane has read the layer's input before it is overwritten
        // Rows and biases are 8-byte aligned: store column pairs.
        if (l < L - 1) {
          for_each_c2<N8>(acc, [&](int r, int j, float v0, float v1) {
            const float2 bj = *reinterpret_cast<const float2*>(b + j);
            *reinterpret_cast<float2*>(cur + r * S + j) = make_float2(relu(v0 + bj.x),
                                                                      relu(v1 + bj.y));
          });
        } else {
          for_each_c2<N8>(acc, [&](int r, int j, float v0, float v1) {
            const float2 bj = *reinterpret_cast<const float2*>(b + j);
            v0 = v0 + bj.x;
            v1 = v1 + bj.y;
            *reinterpret_cast<float2*>(cur + r * S + j) =
                sigmoid_out ? make_float2(sigmoid(v0), sigmoid(v1)) : make_float2(v0, v1);
          });
        }
      });
      __syncwarp();
    }
    // The output rows, from the warp's buffer to device memory, coalesced.
    const int rows = (int)min((int64_t)kWarpRows, row_end - row0);
    float* __restrict__ og = out + row0 * out_dim;
    if (out_dim % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
      const int q = out_dim / 4;  // 16-byte pieces of a row
      int r = (threadIdx.x & 31) / q, c = (threadIdx.x & 31) % q;
      for (int i = threadIdx.x & 31; i < rows * q; i += 32) {
        reinterpret_cast<float4*>(og)[i] = *reinterpret_cast<const float4*>(cur + r * S + c * 4);
        for (c += 32; c >= q; c -= q) ++r;  // piece i + 32
      }
    } else {
      for (int i = threadIdx.x & 31; i < rows * out_dim; i += 32) {
        og[i] = cur[(i / out_dim) * S + i % out_dim];
      }
    }
    __syncwarp();
  }
}

}  // namespace

// weights, biases: host arrays of n_layers device pointers; dims: host
// array of n_layers + 1 ints, each 1..80. block_expert may be null (one
// expert). rows_per_cta: a multiple of 64 that divides rows_per_group.
PTK_EXPORT int mlp_blocks_fwd(const float* h, const int32_t* block_expert, int64_t n,
                              int64_t rows_per_group, int64_t rows_per_cta,
                              const void* const* weights, const void* const* biases,
                              const int* dims, int n_layers, int sigmoid, float* out,
                              void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  if (rows_per_cta <= 0 || rows_per_cta % kTile != 0) return (int)cudaErrorInvalidValue;
  if (block_expert != nullptr && rows_per_group % rows_per_cta != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  MlpLayers p;
  FwdShape s;
  p.n_layers = n_layers;
  int width = 0, frags = 0, bias = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] > kMaxWidth) return (int)cudaErrorInvalidValue;
    p.dim[l] = dims[l];
    width = round8(dims[l]) > width ? round8(dims[l]) : width;
  }
  for (int l = 0; l < n_layers; ++l) {
    p.w[l] = static_cast<const float*>(weights[l]);
    p.b[l] = static_cast<const float*>(biases[l]);
    s.k8[l] = round8(dims[l]) / 8;
    s.n8[l] = round8(dims[l + 1]) / 8;
    s.frag_off[l] = frags;
    s.bias_off[l] = bias;
    frags += s.k8[l] * s.n8[l] * 32;
    bias += s.n8[l] * 8;
  }
  s.stride = act_stride(width);
  // 4 or 8 warps a block, whichever keeps more warps on an SM (the one with
  // more blocks on a tie: one block's weight load overlaps another's work).
  int warps = 0, best = 0;
  size_t smem = 0;
  for (int w = kMinWarps; w <= kMaxWarps && w * kWarpRows <= rows_per_cta; w *= 2) {
    const size_t bytes = (size_t)frags * sizeof(uint4) + (size_t)bias * sizeof(float) +
                         (size_t)w * 2 * kWarpRows * s.stride * sizeof(float);
    int staged = 0;  // the row buffers stage the weights: the widest layer must fit
    for (int l = 0; l < n_layers; ++l) staged = max(staged, staged_floats(p, l));
    const bool fits = bytes <= (size_t)kSmemLimit && staged <= w * 2 * kWarpRows * s.stride;
    const int resident = fits ? w * blocks_per_sm(bytes) : 0;
    if (resident > best) {
      warps = w, best = resident, smem = bytes;
    }
  }
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const bool vec = dims[0] % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(mlp_blocks_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlp_blocks_fwd_kernel<<<ceil_div64(n, rows_per_cta), warps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      h, block_expert, n, rows_per_group, rows_per_cta, p, s, sigmoid, vec, out);
  return (int)cudaGetLastError();
}
