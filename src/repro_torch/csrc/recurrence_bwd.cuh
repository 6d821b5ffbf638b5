// Shared by the two recurrences' forward and backward kernels
// (rwkv6_wkv*.cu, selective_scan*.cu): where the forward keeps the
// states the backward recomputes from, the warp sums the backward
// kernels take, and the fixed-order sum of per-block partials that
// replaces float atomics (two runs give the same bits).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace recurrence {
// internal linkage: every .cu that includes this has its own copy (each
// is compiled on its own and linked into one library)
namespace {

// Under grad the WKV forward writes the state S before every
// kWkvCheckpoint-th step (b, h, ceil(s / 8), dh, dh), the scan forward
// h before every kScanCheckpoint-th step (b, ceil(s / 4), n, di), both
// f32. The backward kernels recompute the states in between from these.
// A sparser spacing would move fewer bytes (at rwkv6-7b's training shape
// the WKV checkpoints are 268 MB, at jamba's the scan's 537 MB, each
// written once and read once) for more recomputation and a longer
// history held on chip; neither backward kernel is bound by its bytes
// (PERF.md).
constexpr int kWkvCheckpoint = 8;
constexpr int kScanCheckpoint = 4;

// Adds the N values `v` of this lane over the lanes that differ in bits
// OFF, OFF / 2, ..., LAST of `lane` (a butterfly; N >= 2 at each level):
// each level keeps the upper half of the values where the lane's bit is
// set and adds the partner's, so after the levels the lane holds N /
// 2^levels whole sums, the first of which is value `halved_first`.
template <int N, int OFF, int LAST>
__device__ __forceinline__ void halve_sum(float* v, int lane) {
  if constexpr (OFF >= LAST && OFF > 0) {
    static_assert(N >= 2, "one value left before the last level");
    constexpr int H = N / 2;
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int q = 0; q < H; ++q) {
      const float send = up ? v[q] : v[q + H];
      const float keep = up ? v[q + H] : v[q];
      v[q] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    halve_sum<H, OFF / 2, LAST>(v, lane);
  }
}

// Which value of its N the lane holds first after halve_sum<N, OFF, LAST>.
template <int N, int OFF, int LAST>
__device__ __forceinline__ int halved_first(int lane) {
  int first = 0;
#pragma unroll
  for (int off = OFF, half = N / 2; off >= LAST && off > 0;
       off /= 2, half /= 2)
    if (lane & off) first += half;
  return first;
}

// v += the same value of the lanes that differ in bits OFF, OFF / 2,
// ..., 1 of the lane (each lane ends with the whole sum).
template <int OFF>
__device__ __forceinline__ void add_lanes(float& v) {
  if constexpr (OFF > 0) {
    v += __shfl_xor_sync(0xffffffffu, v, OFF);
    add_lanes<OFF / 2>(v);
  }
}

// out[i] = sum over p = 0 .. nparts - 1, in that order, of
// parts[p * count + i]: the second pass over per-block partial sums.
__global__ void __launch_bounds__(256)
sum_parts_kernel(const float* __restrict__ parts, float* __restrict__ out,
                 int nparts, int64_t count) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < nparts; ++p) acc += parts[(size_t)p * count + i];
    out[i] = acc;
  }
}

inline cudaError_t sum_parts(const float* parts, float* out, int nparts,
                             int64_t count, cudaStream_t stream) {
  const int64_t blocks = (count + 255) / 256;
  sum_parts_kernel<<<(unsigned)(blocks < (1 << 20) ? blocks : (1 << 20)),
                     256, 0, stream>>>(parts, out, nparts, count);
  return cudaGetLastError();
}

}  // namespace
}  // namespace recurrence
