// K2b mlp_blocks_bwd: backward of K2, the fused expert-grouped small MLP
// (1-4 layers, ReLU between layers, optional sigmoid epilogue), on the
// tensor cores at f32 accuracy.
//
// Replaces XLA's autodiff of presight_tpu/ops/mlp.py::apply_mlp_blocks
// (:184-212; the per-block einsum with each block's expert weights) and of
// apply_mlp (:62-75). Given the input X (n, in), the upstream gradient dY
// (n, out) and the per-expert weights, it gives dX (n, in) and, per expert,
// dW (E, in, out) and db (E, out) summed over every row of that expert.
//
// What bounds it on an H100: per row it recomputes the forward and does two
// products per layer (dAct = dPre W^T and dW += act^T dPre), ~3x K2's
// arithmetic; in 3xTF32 on the tensor cores (495/3 TFLOP/s) the base MLP
// on a training microbatch needs ~0.01 ms of it, as long as it takes to
// read X and dY and write dX once. What cost the CUDA-core version most
// was not that: a partial dW per 64-row tile (32 MB per base-MLP call,
// more than the inputs) and a reduction in which every thread walked every
// tile to keep its own expert's. This design removes both; what it waits
// on now is latency: its shared memory (every layer's input of 64 rows,
// the weights and the dW accumulators) leaves room for one block per SM,
// so its warps' loads, splits and mma chains have little to overlap them.
//
// Design: a CUDA block of 8 warps takes rows_per_cta consecutive rows (a
// multiple of 64 inside one expert block, as K2) in rounds of 64; the
// round's four 16-row groups have two warps each, which split every
// product's n8 tiles between them and meet at a named barrier. The block
// loads its expert's stack into shared memory once, row-major with a padded
// stride, so the same words give the B fragments of W (forward) and of W^T
// (dAct); each fragment is split into big and small TF32 parts as it is
// loaded. Per round, each pair recomputes the forward of its 16 rows with
// K2's fragment arithmetic (the same split values, products and order,
// mlp_mma.cuh), so its ReLU masks and sigmoid' are bitwise K2's, keeping
// every layer's input in shared memory; the last layer's epilogue turns dY
// into dPre. Then, layer by layer from the last: the block's warps share
// out 16-row strips of dW = act^T dPre (half of a strip's n8 tiles at a
// time, the round's 64 rows as the inner dimension) and add them to the
// block's dW accumulators in shared memory (db likewise, one column per thread;
// each element has one owner, so no atomics), and each pair computes dAct
// for its own rows, masks it with the layer input's ReLU and writes it over
// that input (dX goes to device memory). X for the next round is copied
// with cp.async into a second buffer while the current one computes, and
// dY as soon as the forward has used it. The block writes one partial dW
// and db row at the end, from shared memory with coalesced stores. A
// reduction kernel sums, for each expert, only that expert's partials, in
// block order, through an index built on the device just before the main
// kernel by a one-block counting sort (stable) of the blocks' experts, with
// the offsets of each expert's run: no host sync. No atomics: the result
// is deterministic. Sums run in another grouping than the plain version's
// (64-row rounds, blocks in order, against per-512-row blocks), so dW and
// db agree within float rounding.
#include "mlp_mma.cuh"

namespace {

constexpr int kRowGroups = 4;                // 16-row groups of a round
constexpr int kRound = kRowGroups * kWarpRows;  // rows a round
constexpr int kWarps = 2 * kRowGroups;       // two warps share each row group
constexpr int kThreads = kWarps * 32;

// The two warps of row group (warp % kRowGroups) take the first and the
// second half of a product's n8 tiles; pair_sync joins them at named
// barrier 1 + group.
__device__ __forceinline__ void pair_sync(int group) {
  asm volatile("bar.sync %0, 64;" ::"r"(1 + group));
}

// Calls f(Int<count>{}, first) for this warp's half of n8 tiles (first:
// the half's first tile); nothing for an empty half.
template <class F>
__device__ __forceinline__ void with_half(int n8, int half, F f) {
  const int first = half == 0 ? 0 : (n8 + 1) / 2;
  const int count = half == 0 ? (n8 + 1) / 2 : n8 / 2;
  if (count > 0) with_n8(count, [&](auto c) { f(c, first); });
}

struct BwdShape {
  int k8[kMaxLayers];            // input width / 8 of layer l, rounded up
  int n8[kMaxLayers];            // output width / 8
  int m16[kMaxLayers];           // 16-row strips of dW_l (input width / 16)
  int w_off[kMaxLayers];         // first float of layer l's weights
  int w_stride[kMaxLayers];      // row stride of layer l's weights
  int w_words;                   // floats of all layers' weights
  int bias_off[kMaxLayers];      // first float of layer l's padded bias
  int bias_words;
  int grad_words;                // floats of the dW and db accumulators
  int act_words;                 // floats of the row buffers
  int slot_off[kMaxLayers + 1];  // slot l holds layer l's input (slot 0 = X), then dPre
  int slot_stride[kMaxLayers + 1];
  int x2_off;                    // the second X buffer
  int dy_off, dy_stride;
  int64_t partial_size;          // floats of one partial row
  int w_part[kMaxLayers];        // dW_l's place in a partial row (and in the accumulators)
  int b_part[kMaxLayers];        // db_l's place
};

__global__ void __launch_bounds__(kThreads, 1)
mlp_blocks_bwd_kernel(const float* __restrict__ h, const int32_t* __restrict__ block_expert,
                      const float* __restrict__ dout, int64_t n, int64_t rows_per_group,
                      int64_t rows_per_cta, MlpLayers p, BwdShape s, int sigmoid_out,
                      bool vec_x, bool vec_y, float* __restrict__ dx,
                      float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  float* w = smem;                       // the stack, row-major, padded
  float* bias = w + s.w_words;
  float* grads = bias + s.bias_words;    // dW and db, laid out as a partial row
  float* act = grads + s.grad_words;     // X (two buffers), dY, slots 1..L
  const int L = p.n_layers;

  const int64_t row_begin = (int64_t)blockIdx.x * rows_per_cta;
  const int64_t row_end = min(row_begin + rows_per_cta, n);
  const int e = block_expert != nullptr ? block_expert[row_begin / rows_per_group] : 0;

  // Expert e's stack: (8 k8) rows x w_stride columns, zero outside fan_in x
  // fan_out. The layers are staged in the (not yet used) row buffers.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  stage_layers(act, s.act_words, p, e, [&](int l, const float* wl, const float* bl) {
    const int fan_in = p.dim[l], fan_out = p.dim[l + 1], ws = s.w_stride[l];
    for (int k = warp; k < s.k8[l] * 8; k += kWarps) {
      for (int j = lane; j < ws; j += 32) {
        w[s.w_off[l] + k * ws + j] = k < fan_in && j < fan_out ? wl[k * fan_out + j] : 0.0f;
      }
    }
    for (int j = threadIdx.x; j < s.n8[l] * 8; j += kThreads) {
      bias[s.bias_off[l] + j] = j < fan_out ? bl[j] : 0.0f;
    }
  });
  for (int i = threadIdx.x; i < s.partial_size; i += kThreads) grads[i] = 0.0f;

  const int in0 = p.dim[0], out_dim = p.dim[L];
  const int group = warp % kRowGroups, half = warp / kRowGroups;
  const int wr = group * kWarpRows;  // the warp's first row in a round
  float* dy = act + s.dy_off + wr * s.dy_stride;
  const int rounds = (int)((row_end - row_begin + kRound - 1) / kRound);
  // The first warp of a group copies its rows of X, the second its rows of dY.
  if (half == 0) {
    load_rows_async(act + s.slot_off[0] + wr * s.slot_stride[0], s.slot_stride[0], h, in0,
                    s.k8[0] * 8, row_begin + wr, row_end, vec_x);
  } else {
    load_rows_async(dy, s.dy_stride, dout, out_dim, s.n8[L - 1] * 8, row_begin + wr, row_end,
                    vec_y);
  }
  cp_async_commit();
  for (int round = 0; round < rounds; ++round) {
    const int64_t row0 = row_begin + (int64_t)round * kRound + wr;  // the group's first row
    float* x = act + ((round & 1) ? s.x2_off : s.slot_off[0]);  // X, two buffers in turn
    if (half == 0 && round + 1 < rounds) {
      load_rows_async(act + ((round & 1) ? s.slot_off[0] : s.x2_off) + wr * s.slot_stride[0],
                      s.slot_stride[0], h, in0, s.k8[0] * 8, row0 + kRound, row_end, vec_x);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    pair_sync(group);

    // Forward of the group's rows, K2's arithmetic (each accumulator sees
    // K2's products in K2's order); slot l + 1 gets layer l's output, and
    // slot L gets dPre of the last layer.
    for (int l = 0; l < L; ++l) {
      const int ws = s.w_stride[l], sa = s.slot_stride[l], so = s.slot_stride[l + 1];
      const float* wl = w + s.w_off[l];
      const float* b = bias + s.bias_off[l];
      const float* a = (l == 0 ? x : act + s.slot_off[l]) + wr * sa;
      float* o = act + s.slot_off[l + 1] + wr * so;
      with_half(s.n8[l], half, [&](auto n8c, int first) {
        constexpr int N8 = decltype(n8c)::value;
        float acc[N8][4];
        warp_product<N8>(acc, s.k8[l], rows_a(a, sa), [&](int ks, int nt) {
          return frag_b(wl, ws, ks * 8, (first + nt) * 8);
        });
        if (l < L - 1) {
          for_each_c<N8>(acc, [&](int r, int j, float v) {
            j += first * 8;
            o[r * so + j] = relu(v + b[j]);
          });
        } else {
          for_each_c<N8>(acc, [&](int r, int j, float v) {
            j += first * 8;
            float grad = dy[r * s.dy_stride + j];
            if (sigmoid_out) {
              const float sg = sigmoid(v + b[j]);
              grad = grad * (sg * (1.0f - sg));
            }
            o[r * so + j] = grad;
          });
        }
      });
      if (l < L - 1) pair_sync(group);
    }
    __syncthreads();
    // The forward has read this round's dY: fetch the next round's.
    if (half == 1 && round + 1 < rounds) {
      load_rows_async(dy, s.dy_stride, dout, out_dim, s.n8[L - 1] * 8, row0 + kRound, row_end,
                      vec_y);
      cp_async_commit();
    }

    for (int l = L - 1; l >= 0; --l) {
      const int fan_in = p.dim[l], fan_out = p.dim[l + 1];
      const int sa = s.slot_stride[l], sd = s.slot_stride[l + 1], ws = s.w_stride[l];
      const float* a_l = l == 0 ? x : act + s.slot_off[l];
      const float* d_l = act + s.slot_off[l + 1];
      const float* wl = w + s.w_off[l];
      // dW_l += act_l^T dPre_l over the round's rows: work items of a 16-row
      // strip of dW and one half of its n8 tiles, one item per warp at a time.
      float* gw = grads + s.w_part[l];
      for (int item = warp; item < 2 * s.m16[l]; item += kWarps) {
        const int m0 = item / 2 * 16;
        with_half(s.n8[l], item % 2, [&](auto n8c, int first) {
          constexpr int N8 = decltype(n8c)::value;
          float acc[N8][4];
          warp_product<N8>(
              acc, kRound / 8,
              [&](int ks) {  // A = act_l^T
                const float* a0 = a_l + (ks * 8 + t) * sa + m0 + g;
                return make_float4(a0[0], a0[8], a0[4 * sa], a0[4 * sa + 8]);
              },
              [&](int ks, int nt) { return frag_b(d_l, sd, ks * 8, (first + nt) * 8); });
          for_each_c<N8>(acc, [&](int r, int j, float v) {
            j += first * 8;
            if (m0 + r < fan_in && j < fan_out) gw[(m0 + r) * fan_out + j] += v;
          });
        });
      }
      for (int c = threadIdx.x; c < fan_out; c += kThreads) {
        float sum = 0.0f;
        for (int r = 0; r < kRound; ++r) sum += d_l[r * sd + c];
        grads[s.b_part[l] + c] += sum;
      }
      __syncthreads();  // every warp has read act_l before it is overwritten

      // dAct_l = dPre_l W_l^T for the group's rows, this warp's half of the
      // columns.
      with_half(s.k8[l], half, [&](auto k8c, int first) {
        constexpr int N8 = decltype(k8c)::value;
        float acc[N8][4];
        warp_product<N8>(acc, s.n8[l], rows_a(d_l + wr * sd, sd), [&](int ks, int nt) {
          return frag_b_t(wl, ws, ks * 8, (first + nt) * 8);
        });
        if (l > 0) {  // dPre_{l-1}: dAct where the layer input passed its ReLU
          float* o = act + s.slot_off[l] + wr * sa;
          for_each_c<N8>(acc, [&](int r, int j, float v) {
            j += first * 8;
            o[r * sa + j] = o[r * sa + j] > 0.0f ? v : 0.0f;
          });
        } else {
          for_each_c<N8>(acc, [&](int r, int j, float v) {
            j += first * 8;
            if (row0 + r < row_end && j < in0) dx[(row0 + r) * in0 + j] = v;
          });
        }
      });
      if (l > 0) __syncthreads();
    }
  }

  // One partial row per block.
  __syncthreads();
  float* part = partial + (int64_t)blockIdx.x * s.partial_size;
  for (int i = threadIdx.x; i < s.partial_size; i += kThreads) part[i] = grads[i];
}

// The reduction's index, one block: the blocks (CTAs) of the main kernel
// sorted stably by expert (a counting sort over the expert blocks, each of
// ctas_per_group consecutive CTAs), and the offsets of each expert's run.
// index = [order (num_groups * ctas_per_group) | offsets (num_experts + 1)].
__global__ void mlp_blocks_bwd_index_kernel(const int32_t* __restrict__ block_expert,
                                            int num_groups, int ctas_per_group,
                                            int num_experts, int32_t* __restrict__ index) {
  extern __shared__ int32_t idx_smem[];
  int32_t* expert = idx_smem;                 // num_groups
  int32_t* start = expert + num_groups;       // num_groups: each group's first place
  int32_t* offsets = start + num_groups;      // num_experts + 1
  for (int b = threadIdx.x; b < num_groups; b += blockDim.x) expert[b] = block_expert[b];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int x = 0; x <= num_experts; ++x) offsets[x] = 0;
    for (int b = 0; b < num_groups; ++b) offsets[expert[b] + 1] += ctas_per_group;
    for (int x = 0; x < num_experts; ++x) offsets[x + 1] += offsets[x];
    for (int b = 0; b < num_groups; ++b) {  // groups in order: the sort is stable
      start[b] = offsets[expert[b]];
      offsets[expert[b]] += ctas_per_group;
    }
    for (int x = num_experts; x > 0; --x) offsets[x] = offsets[x - 1];
    offsets[0] = 0;
  }
  __syncthreads();
  int32_t* order = index;
  const int num_ctas = num_groups * ctas_per_group;
  for (int c = threadIdx.x; c < num_ctas; c += blockDim.x) {
    order[start[c / ctas_per_group] + c % ctas_per_group] = c;
  }
  for (int x = threadIdx.x; x <= num_experts; x += blockDim.x) index[num_ctas + x] = offsets[x];
}

struct LayerGrads {
  float* dw[kMaxLayers];  // (E, in, out)
  float* db[kMaxLayers];  // (E, out)
};

// For expert blockIdx.y and element q of the flattened [dW_0 | db_0 | dW_1
// | ...] layout: the sum of that expert's block partials, in block order.
// cta_order lists the blocks grouped by expert (mlp_blocks_bwd_index_kernel);
// expert e's run is [expert_offsets[e], expert_offsets[e + 1]).
// A null cta_order gives every block to expert 0 (the others get zeros).
__global__ void mlp_blocks_bwd_reduce_kernel(const float* __restrict__ partial,
                                             const int32_t* __restrict__ cta_order,
                                             const int32_t* __restrict__ expert_offsets,
                                             int num_ctas, MlpLayers p, LayerGrads g,
                                             int64_t partial_size) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int e = blockIdx.y;
  if (q >= partial_size) return;
  const int begin = cta_order != nullptr ? expert_offsets[e] : 0;
  const int end = cta_order != nullptr ? expert_offsets[e + 1] : (e == 0 ? num_ctas : 0);
  float acc = 0.0f;
  for (int j = begin; j < end; ++j) {
    const int64_t c = cta_order != nullptr ? cta_order[j] : j;
    acc += partial[c * partial_size + q];
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
// pointers; dims: host array of n_layers + 1 ints, each 1..80. block_expert
// may be null (one expert). rows_per_cta: a multiple of 64 that divides
// rows_per_group. partial: scratch of ceil(n / rows_per_cta) * sum(in * out
// + out) floats; index: scratch of ceil(n / rows_per_cta) + num_experts + 1
// ints (unused with a null block_expert). dx (n, in); dweights[l] (E, in,
// out) and dbiases[l] (E, out) are written in full.
PTK_EXPORT int mlp_blocks_bwd(const float* h, const int32_t* block_expert, const float* dout,
                              int64_t n, int64_t rows_per_group, int64_t rows_per_cta,
                              int num_experts, const void* const* weights,
                              const void* const* biases, const int* dims, int n_layers,
                              int sigmoid, float* dx, void* const* dweights,
                              void* const* dbiases, float* partial, int32_t* index,
                              void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  if (rows_per_cta <= 0 || rows_per_cta % kTile != 0) return (int)cudaErrorInvalidValue;
  if (block_expert != nullptr && rows_per_group % rows_per_cta != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  MlpLayers p;
  LayerGrads g;
  BwdShape s;
  p.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] > kMaxWidth) return (int)cudaErrorInvalidValue;
    p.dim[l] = dims[l];
  }
  int words = 0, bias = 0, row = 0;  // row: floats of a partial row so far
  for (int l = 0; l < n_layers; ++l) {
    p.w[l] = static_cast<const float*>(weights[l]);
    p.b[l] = static_cast<const float*>(biases[l]);
    g.dw[l] = static_cast<float*>(dweights[l]);
    g.db[l] = static_cast<float*>(dbiases[l]);
    s.k8[l] = round8(dims[l]) / 8;
    s.n8[l] = round8(dims[l + 1]) / 8;
    s.m16[l] = round16(dims[l]) / 16;
    s.w_stride[l] = weight_stride(s.n8[l] * 8);
    s.w_off[l] = words;
    words += s.k8[l] * 8 * s.w_stride[l];
    s.bias_off[l] = bias;
    bias += s.n8[l] * 8;
    s.w_part[l] = row;
    s.b_part[l] = row + dims[l] * dims[l + 1];
    row += dims[l] * dims[l + 1] + dims[l + 1];
  }
  s.w_words = words;
  s.bias_words = bias;
  s.partial_size = row;
  s.grad_words = (row + 3) & ~3;
  // Slot 0 (X) and slots 1..L-1 are read as act^T in 16-column strips,
  // slot L (dPre of the last layer) only in 8-wide tiles.
  for (int l = 0; l < n_layers; ++l) s.slot_stride[l] = act_stride(round16(dims[l]));
  s.slot_stride[n_layers] = act_stride(round8(dims[n_layers]));
  s.dy_stride = s.slot_stride[n_layers];
  int floats = 0;
  s.slot_off[0] = floats;
  floats += kRound * s.slot_stride[0];
  s.x2_off = floats;
  floats += kRound * s.slot_stride[0];
  s.dy_off = floats;
  floats += kRound * s.dy_stride;
  for (int l = 1; l <= n_layers; ++l) {
    s.slot_off[l] = floats;
    floats += kRound * s.slot_stride[l];
  }
  s.act_words = floats;
  const size_t smem = ((size_t)words + bias + s.grad_words + floats) * sizeof(float);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_layers; ++l) {  // the row buffers stage the weights
    if (staged_floats(p, l) > floats) return (int)cudaErrorInvalidValue;
  }
  const bool vec_x = dims[0] % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  const bool vec_y = dims[n_layers] % 4 == 0 && reinterpret_cast<uintptr_t>(dout) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(mlp_blocks_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned num_ctas = ceil_div64(n, rows_per_cta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_expert != nullptr) {
    const int groups = (int)(n / rows_per_group), per_group = (int)(rows_per_group / rows_per_cta);
    const size_t index_smem = (2 * (size_t)groups + num_experts + 1) * sizeof(int32_t);
    if (index_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    mlp_blocks_bwd_index_kernel<<<1, 256, index_smem, st>>>(block_expert, groups, per_group,
                                                            num_experts, index);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  mlp_blocks_bwd_kernel<<<num_ctas, kThreads, smem, st>>>(h, block_expert, dout, n,
                                                          rows_per_group, rows_per_cta, p, s,
                                                          sigmoid, vec_x, vec_y, dx, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const dim3 grid(ceil_div64(s.partial_size, threads), (unsigned)num_experts);
  const int32_t* order = block_expert != nullptr ? index : nullptr;
  mlp_blocks_bwd_reduce_kernel<<<grid, threads, 0, st>>>(partial, order, index + num_ctas,
                                                         (int)num_ctas, p, g, s.partial_size);
  return (int)cudaGetLastError();
}
