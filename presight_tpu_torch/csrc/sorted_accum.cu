// K5 sorted_accum: out[key] += sum of the rows of each run of equal keys,
// over rows sorted by key (a segment sum over sorted keys).
//
// Replaces the Pallas probe sorted_accum of scripts_dev/pallas_accum.py:30
// (P1; same operation in scripts_dev/profile_scatter_variants.py:70,
// profile_scan2.py:69 and profile_scan3.py:80), whose plain reference is
// jax.ops.segment_sum. On the port's training path it is the last stage of
// the hash-table gradient: K1b writes one cotangent row per (sample, level)
// (or per corner), torch.sort orders the keys stably, the rows are gathered
// into that order, and this kernel reduces each run and adds it to the
// gradient once.
//
// What bounds it on an H100: device memory. Each sorted row is read once
// (C floats) and each distinct key's output row is read and written once;
// there is one add per input element, far below the card's FLOP rate.
//
// Design: the keys of a training microbatch cluster -- a ray's samples
// share the coarse levels' cells -- so runs reach 10^4 rows, and a thread
// that walks a whole run serially is the whole kernel's latency. Here the
// sorted rows are cut into segments of kSeg rows. Pass 1 has one thread per
// (segment, channel), channel fastest (coalesced reads): it walks its
// segment, adds each run that starts and ends inside the segment to out
// directly, and leaves the pieces of runs that cross a segment boundary in
// two scratch rows per segment (the piece that opens the segment, the piece
// that closes it). Pass 2 has one thread per (segment, channel) for each
// segment where a crossing run starts: it adds that run's pieces, segment
// after segment, and adds the sum to out once. Every output element is
// written by one thread, so there are no atomics, and the sums run in a
// fixed order: the result is deterministic. The TPU probe carried a running
// sum in VMEM across a sequential grid; on the GPU the carry is pass 2.
#include "common.cuh"

namespace {

constexpr int kSeg = 64;  // rows per segment

// flags[s]: bit 0 -- segment s opens with a piece of a run that started
// before it; bit 1 -- that piece runs to the end of s and on past it;
// bit 2 -- s closes with a piece of a run that starts in s and goes on.
__global__ void sorted_accum_pass1(const int32_t* __restrict__ keys,
                                   const float* __restrict__ rows, int64_t n, int C,
                                   int64_t num_seg, float* __restrict__ out,
                                   float* __restrict__ open_part, float* __restrict__ close_part,
                                   uint8_t* __restrict__ flags) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_seg * C) return;
  const int64_t s = t / C;
  const int c = (int)(t % C);
  const int64_t lo = s * kSeg, hi = min(n, lo + kSeg);
  uint8_t f = 0;
  int64_t start = lo;
  float acc = 0.0f;
  for (int64_t i = lo; i < hi; ++i) {
    acc += rows[i * C + c];
    const int32_t key = keys[i];
    const bool run_ends = i + 1 == n || keys[i + 1] != key;
    if (i + 1 < hi && !run_ends) continue;  // the piece goes on inside the segment
    const bool opens = start == lo && lo > 0 && keys[lo - 1] == key;
    if (opens) {
      open_part[s * C + c] = acc;
      f |= run_ends ? 1 : 3;
    } else if (!run_ends) {
      close_part[s * C + c] = acc;
      f |= 4;
    } else {
      out[(int64_t)key * C + c] += acc;
    }
    acc = 0.0f;
    start = i + 1;
  }
  if (c == 0) flags[s] = f;
}

__global__ void sorted_accum_pass2(const int32_t* __restrict__ keys, int64_t n, int C,
                                   int64_t num_seg, float* __restrict__ out,
                                   const float* __restrict__ open_part,
                                   const float* __restrict__ close_part,
                                   const uint8_t* __restrict__ flags) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_seg * C) return;
  const int64_t s = t / C;
  if (!(flags[s] & 4)) return;
  const int c = (int)(t % C);
  float acc = close_part[s * C + c];
  for (int64_t u = s + 1; u < num_seg; ++u) {
    acc += open_part[u * C + c];
    if (!(flags[u] & 2)) break;
  }
  const int64_t last_row = min(n, (s + 1) * kSeg) - 1;
  out[(int64_t)keys[last_row] * C + c] += acc;
}

}  // namespace

// keys (n,) int32 sorted ascending; rows (n, C) in that order; out (T, C)
// is accumulated into (the caller zeroes it for a fresh gradient). scratch:
// 2 * ceil(n / 64) * C floats; flags: ceil(n / 64) bytes.
PTK_EXPORT int sorted_accum(const int32_t* keys, const float* rows, int64_t n, int C,
                            float* out, float* scratch, uint8_t* flags, void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int64_t num_seg = (n + kSeg - 1) / kSeg;
  float* open_part = scratch;
  float* close_part = scratch + num_seg * C;
  const int threads = 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sorted_accum_pass1<<<ceil_div64(num_seg * C, threads), threads, 0, st>>>(
      keys, rows, n, C, num_seg, out, open_part, close_part, flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sorted_accum_pass2<<<ceil_div64(num_seg * C, threads), threads, 0, st>>>(
      keys, n, C, num_seg, out, open_part, close_part, flags);
  return (int)cudaGetLastError();
}
