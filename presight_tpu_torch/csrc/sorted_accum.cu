// K5 sorted_accum: out[key] += sum of the rows of each run of equal keys,
// over rows sorted by key (a segment sum over sorted keys).
//
// Replaces the Pallas probe sorted_accum of scripts_dev/pallas_accum.py:30
// (P1; same operation in scripts_dev/profile_scatter_variants.py:70,
// profile_scan2.py:69 and profile_scan3.py:80), whose plain reference is
// jax.ops.segment_sum. On the port's training path it is the last stage of
// the hash-table gradient: K1b writes one cotangent row per (sample, level)
// (or per corner), torch.sort orders the keys stably, and this kernel reads
// the rows through the sort's permutation, reduces each run and adds it to
// the tables' gradient once.
//
// Contract: sorted row i is rows[order[i]] (order: torch.sort's int64
// indices). The output is P parts of part_rows rows
// each (the 'shared' storage's level tables, or one table): key k lives in
// part k / part_rows at row k % part_rows. It is accumulated into, never
// zeroed. No float atomics: every output element is written by one thread
// with its sums in a fixed order, so two calls give bitwise equal results.
//
// What bounds it on an H100: device memory. Each row is read once, the
// keys and the permutation once, and each distinct key's output row is
// read and written once; one add per input element.
//
// Design (v3): a CUDA block walks tiles of 64 sorted rows (one tile after
// another, gridDim apart; four blocks fit on an SM). It copies a tile's keys
// and row indices to shared memory in one round of loads, then its rows,
// gathered through `order`, with cp.async: 16-byte copies where C is a
// multiple of 4 (80-wide rows: 20 vectors), 4-byte ones otherwise; the next
// tile's copies are in flight while the current one is reduced (double
// buffering). The tile is cut into G sub-segments; one thread per
// (sub-segment, vector column) sums its rows from shared memory. The
// pieces of runs that cross a sub-segment boundary are chained in shared
// memory by the thread of the sub-segment where the run starts. Each run
// that ends in the tile leaves its sum in its last row's slot of the
// shared tile, and then the whole block adds those sums to out, the
// threads over (row, column) with up to eight output reads in flight each
// before the writes: the reads of out are the kernel's latency, and a
// thread that read-modify-wrote each run as it found it would wait on
// every one. A run that crosses the tile's end leaves a tile partial (and
// the piece that opens a tile, a run started before it, leaves another).
// The carry pass, one block per tile where a crossing run starts, finds
// where the run ends from the tiles' flags (ballots); its eight warps add
// the tile partials (warp w every eighth, the lanes over the columns; a
// training microbatch has runs of ~14,000 rows, over 200 tiles), and the
// block adds the eight sums in warp order and writes out once. The TPU
// probe carried a running sum in VMEM across a sequential grid; on the GPU
// the carry is the second pass.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kRowsPerTile = 64;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // what the shared memory of 80-wide rows allows
constexpr int kCarryThreads = 256;
constexpr int kBatch = 8;  // output rows a thread reads before it writes them

struct OutParts {
  float* part[kMaxLevels];
  int64_t part_rows;
};

__device__ __forceinline__ float* out_row(const OutParts& out, int32_t key, int C) {
  const int64_t p = key / out.part_rows;
  return out.part[p] + (key - p * out.part_rows) * (int64_t)C;
}

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
template <typename Vec>
__device__ __forceinline__ Vec vzero();
template <>
__device__ __forceinline__ float vzero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 vzero<float4>() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

__device__ __forceinline__ void copy_async(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void copy_async(float4* dst, const float4* src) {
  cp_async16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src));
}

// Dynamic shared memory of the tile kernel, in bytes (host and device agree).
inline size_t tile_smem_bytes(int C, int G) {
  return sizeof(float) * ((size_t)2 * kRowsPerTile * C + (size_t)2 * G * C) +
         sizeof(int64_t) * 2 * kRowsPerTile + sizeof(int32_t) * (2 * (kRowsPerTile + 2) + G) + G;
}

// flags[t]: bit 0 -- tile t opens with a piece of a run that started before
// it (its sum in open_part[t]); bit 1 -- that run goes on past the tile's
// end (the whole tile is one piece); bit 2 -- t closes with a piece of a run
// that starts in t and goes on (its sum in close_part[t]). Sub-segment flags
// in shared memory mean the same for sub-segments.
template <typename Vec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sorted_accum_tiles(const int32_t* __restrict__ keys, const int64_t* __restrict__ order,
                   const float* __restrict__ rows, int64_t n, int C, int G, OutParts out,
                   int64_t num_tiles, float* __restrict__ open_part,
                   float* __restrict__ close_part, uint8_t* __restrict__ flags) {
  constexpr int kVec = sizeof(Vec) / sizeof(float);
  extern __shared__ float4 smem_raw[];
  const int V = C / kVec;
  const int sub = (kRowsPerTile + G - 1) / G;
  Vec* rows_s = reinterpret_cast<Vec*>(smem_raw);  // [2][kRowsPerTile * V]
  int64_t* order_s = reinterpret_cast<int64_t*>(rows_s + 2 * kRowsPerTile * V);  // [2][kRowsPerTile]
  Vec* open_s = reinterpret_cast<Vec*>(order_s + 2 * kRowsPerTile);  // [G * V]
  Vec* close_s = open_s + G * V;                                      // [G * V]
  int32_t* keys_s = reinterpret_cast<int32_t*>(close_s + G * V);      // [2][kRowsPerTile + 2]
  int32_t* open_end = keys_s + 2 * (kRowsPerTile + 2);  // [G] last row of g's opening piece
  uint8_t* sflags = reinterpret_cast<uint8_t*>(open_end + G);  // [G]
  const int tid = threadIdx.x;

  // Stage `tile` into buffer `buf`: ks[i + 1] = keys[lo + i] for i in
  // [-1, len] (-1 where there is no row) and the tile's row indices, in one
  // round of loads; then start the rows' copies.
  auto issue = [&](int64_t tile, int buf) {
    const int64_t lo = tile * kRowsPerTile;
    const int len = (int)min((int64_t)kRowsPerTile, n - lo);
    int32_t* ks = keys_s + buf * (kRowsPerTile + 2);
    int64_t* os = order_s + buf * kRowsPerTile;
    for (int i = tid; i < len + 2; i += kThreads) {
      const int64_t g = lo - 1 + i;
      ks[i] = (g >= 0 && g < n) ? keys[g] : -1;
      if (i < len) os[i] = order[lo + i];
    }
    __syncthreads();
    Vec* rs = rows_s + buf * kRowsPerTile * V;
    for (int j = tid; j < len * V; j += kThreads) {
      const int i = j / V;
      copy_async(rs + j, reinterpret_cast<const Vec*>(rows + os[i] * C) + (j - i * V));
    }
    cp_async_commit();
  };

  int buf = 0;
  if ((int64_t)blockIdx.x < num_tiles) issue(blockIdx.x, 0);
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, buf ^= 1) {
    const int64_t next = tile + gridDim.x;
    if (next < num_tiles) {
      issue(next, buf ^ 1);  // in flight while this tile is reduced
    } else {
      cp_async_commit();  // an empty group, so the wait below means "this tile"
    }
    cp_async_wait<1>();
    __syncthreads();

    const int64_t lo = tile * kRowsPerTile;
    const int len = (int)min((int64_t)kRowsPerTile, n - lo);
    const int32_t* ks = keys_s + buf * (kRowsPerTile + 2);
    Vec* rs = rows_s + buf * kRowsPerTile * V;
    const int active = (len + sub - 1) / sub;

    // A: each (sub-segment, column) walks its rows. The sum of a run that
    // starts and ends in the sub-segment goes into its last row's slot of
    // the tile (a slot only this thread reads); the pieces at the
    // sub-segment's edges go to open_s / close_s.
    for (int it = tid; it < active * V; it += kThreads) {
      const int g = it / V, v = it - g * V;
      const int a = g * sub, b = min(len, a + sub);
      Vec acc = vzero<Vec>();
      int start = a;
      uint8_t f = 0;
      for (int i = a; i < b; ++i) {
        acc = vadd(acc, rs[i * V + v]);
        const int32_t key = ks[i + 1];
        const bool run_ends = ks[i + 2] != key;
        if (i + 1 < b && !run_ends) continue;  // the piece goes on inside the sub-segment
        const bool opens = start == a && ks[a] == key;
        if (opens) {
          open_s[it] = acc;
          f |= run_ends ? 1 : 3;
          if (v == 0) open_end[g] = i;
        } else if (!run_ends) {
          close_s[it] = acc;
          f |= 4;
        } else {
          rs[i * V + v] = acc;
        }
        acc = vzero<Vec>();
        start = i + 1;
      }
      if (v == 0) sflags[g] = f;
    }
    __syncthreads();

    // B: the thread of the sub-segment where a crossing run starts chains
    // its pieces; a run that ends in the tile leaves its sum in its last
    // row's slot, one that goes past the tile leaves the tile's close
    // partial. The piece that opens the tile leaves its open partial.
    for (int it = tid; it < active * V; it += kThreads) {
      const int g = it / V, v = it - g * V;
      if (sflags[g] & 4) {
        Vec acc = close_s[it];
        int u = g + 1;
        for (; u < active; ++u) {
          acc = vadd(acc, open_s[u * V + v]);
          if (!(sflags[u] & 2)) break;
        }
        if (u < active) {
          rs[open_end[u] * V + v] = acc;
        } else {
          reinterpret_cast<Vec*>(close_part + tile * C)[v] = acc;
        }
      }
      if (g == 0 && (sflags[0] & 1)) {
        Vec acc = open_s[v];
        for (int u = 1; u < active && (sflags[u - 1] & 2); ++u) acc = vadd(acc, open_s[u * V + v]);
        reinterpret_cast<Vec*>(open_part + tile * C)[v] = acc;
      }
    }
    __syncthreads();

    // C: add every run that ends in the tile, other than the one that
    // opens it, to out: the lanes over (row, column), so a run's output row
    // is read and written by consecutive threads, and kBatch independent
    // reads in flight per thread before the writes.
    auto flushed = [&](int it) -> Vec* {  // out's element for item it, if its run is added here
      if (it >= len * V) return nullptr;
      const int i = it / V;
      const int32_t key = ks[i + 1];
      if (ks[i + 2] == key || key == ks[0]) return nullptr;
      return reinterpret_cast<Vec*>(out_row(out, key, C)) + (it - i * V);
    };
    for (int base = tid; base < len * V; base += kThreads * kBatch) {
      Vec val[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const Vec* src = flushed(base + u * kThreads);
        if (src != nullptr) val[u] = *src;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        Vec* dst = flushed(base + u * kThreads);
        if (dst != nullptr) *dst = vadd(val[u], rs[base + u * kThreads]);
      }
    }
    if (tid == 0) {
      const int32_t before = ks[0], first = ks[1], last = ks[len], after = ks[len + 1];
      uint8_t f = 0;
      if (before == first) f |= after == first ? 3 : 1;
      if (after == last && !(f & 2)) f |= 4;
      flags[tile] = f;
    }
    __syncthreads();  // the buffers are refilled by the next iteration's issue
  }
}

// One block per tile t that closes with a crossing run (the others exit):
// warp 0 finds the tile where the run ends from the flags (ballots over 32
// tiles at a time); then warp w adds the open partials of tiles t + 1 + w,
// t + 1 + w + 8, ... up to that tile, the lanes over the columns, and the
// block adds close_part[t] and the eight warp sums, in warp order, to the
// run's output row.
__global__ void __launch_bounds__(kCarryThreads)
sorted_accum_carry(const int32_t* __restrict__ keys, int64_t n, int C, OutParts out,
                   int64_t num_tiles, const float* __restrict__ open_part,
                   const float* __restrict__ close_part, const uint8_t* __restrict__ flags) {
  constexpr int kWarps = kCarryThreads / 32;
  extern __shared__ float part_s[];  // [kWarps][C]
  __shared__ int64_t end_s;
  const int64_t t = blockIdx.x;
  if (!(flags[t] & 4)) return;  // the whole block exits
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    int64_t end = -1;  // the last tile holding a piece of the run
    for (int64_t base = t + 1; end < 0; base += 32) {
      const int64_t u = base + lane;
      const uint8_t f = u < num_tiles ? flags[u] : 0;
      const unsigned stop = __ballot_sync(kFullMask, !(f & 2));
      if (stop) end = base + __ffs(stop) - 1;
    }
    if (lane == 0) end_s = end;
  }
  __syncthreads();
  const int64_t end = end_s;
  for (int c = lane; c < C; c += 32) {
    float acc = 0.0f;
#pragma unroll 4
    for (int64_t u = t + 1 + warp; u <= end; u += kWarps) acc += open_part[u * C + c];
    part_s[warp * C + c] = acc;
  }
  __syncthreads();
  float* o = out_row(out, keys[min(n, (t + 1) * kRowsPerTile) - 1], C);
  for (int c = threadIdx.x; c < C; c += kCarryThreads) {
    float acc = close_part[t * C + c];
    for (int w = 0; w < kWarps; ++w) acc += part_s[w * C + c];
    o[c] += acc;
  }
}

template <typename Vec>
int launch(const int32_t* keys, const int64_t* order, const float* rows, int64_t n, int C,
           const OutParts& out, int64_t num_tiles, float* open_part, float* close_part,
           uint8_t* flags, cudaStream_t st) {
  const int V = C / (int)(sizeof(Vec) / sizeof(float));
  const int G = std::max(1, std::min(kRowsPerTile, kThreads / V));
  const size_t smem = tile_smem_bytes(C, G);
  auto kernel = sorted_accum_tiles<Vec>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;  // C too wide for shared memory
  const int64_t grid = std::min(num_tiles, (int64_t)per_sm * sms);
  kernel<<<(unsigned)grid, kThreads, smem, st>>>(keys, order, rows, n, C, G, out, num_tiles,
                                                 open_part, close_part, flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sorted_accum_carry<<<(unsigned)num_tiles, kCarryThreads,
                       sizeof(float) * (kCarryThreads / 32) * C, st>>>(
      keys, n, C, out, num_tiles, open_part, close_part, flags);
  return (int)cudaGetLastError();
}

}  // namespace

// keys (n,) int32 sorted ascending; order (n,) int64; rows (>= n, C);
// parts: num_parts (<= 16) device pointers of part_rows x C floats each,
// accumulated into. vec 4 takes 16-byte copies (C % 4 == 0 and rows and
// parts 16-byte aligned), vec 1 4-byte ones. scratch: 2 * ceil(n / 64) * C
// floats; flags: ceil(n / 64) bytes.
PTK_EXPORT int sorted_accum(const int32_t* keys, const int64_t* order, const float* rows,
                            int64_t n, int C, float* const* parts, int num_parts,
                            int64_t part_rows, int vec, float* scratch, uint8_t* flags,
                            void* stream) {
  if (C < 1 || num_parts < 1 || num_parts > kMaxLevels || part_rows < 1 ||
      (vec != 1 && vec != 4) || C % vec != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  OutParts out;
  for (int p = 0; p < num_parts; ++p) out.part[p] = parts[p];
  out.part_rows = part_rows;
  const int64_t num_tiles = (n + kRowsPerTile - 1) / kRowsPerTile;
  float* open_part = scratch;
  float* close_part = scratch + num_tiles * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec == 4 ? launch<float4>(keys, order, rows, n, C, out, num_tiles, open_part,
                                   close_part, flags, st)
                  : launch<float>(keys, order, rows, n, C, out, num_tiles, open_part,
                                  close_part, flags, st);
}
