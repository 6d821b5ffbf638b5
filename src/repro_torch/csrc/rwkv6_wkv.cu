// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rwkv6_wkv.py::rwkv6_wkv (the Pallas TPU
// kernel, body `_kernel`). Same function, for every (batch, head) pair
// of r, k, v, w (b, h, s, dh) and bonus u (h, dh), from S = 0:
//   y_t[i] = sum_j r_t[j] * (S[j,i] + u[j] * k_t[j] * v_t[i])
//   S[j,i] = w_t[j] * S[j,i] + k_t[j] * v_t[i]
// Outputs y (b, h, s, dh) f32 and S_final (b, h, dh, dh) f32 in the
// [key_dim j, val_dim i] layout of src/repro/models/rwkv.py. Inputs are
// f32 or bf16 (all four alike), u is f32, all arithmetic is f32.
//
// What bounds it on this card: each input element is read once and each
// output written once, about 5 * dh flops per element of r (the dh x dh
// state update and read-out per step), so at dh = 64 the function sits
// near the balance point of 3.35 TB/s against 67 TFLOP/s f32 (bound by
// bytes at the rwkv6-7b prefill shape). The recurrence is sequential in
// time, so the real limit of this simple design is latency: one
// (batch, head) pair per block walks its s steps one after another.
//
// What the design does about it: one block of dh threads per
// (batch, head) pair; thread i keeps the value column S[:, i] in
// registers for the whole sequence, so the state never touches memory
// until S_final is written. Time steps are staged kChunk at a time in
// double-buffered shared memory: each thread loads its element of the
// next chunk's r, k, v, w into registers while the block computes the
// current chunk, so one __syncthreads and one round of global-load
// latency serve kChunk steps. The inner loop reads r, k, w, u as float4
// broadcasts from shared memory and splits the read-out sum over four
// accumulators to shorten the FMA dependency chain. Any length works:
// the Pallas chunk has no counterpart here and no chunk has to divide s.
// Packing several pairs per block, a chunked tensor-core form and TMA
// are for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;  // time steps staged in shared memory at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Loads this thread's element of steps [t0, t0 + kChunk) of the four
// inputs into registers (steps past s are left as they were).
template <typename T, int DH>
__device__ __forceinline__ void fetch(const T* __restrict__ r,
                                      const T* __restrict__ k,
                                      const T* __restrict__ v,
                                      const T* __restrict__ w, size_t base,
                                      int t0, int s, int i,
                                      float (&pr)[kChunk],
                                      float (&pk)[kChunk],
                                      float (&pv)[kChunk],
                                      float (&pw)[kChunk]) {
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const int t = t0 + c;
    if (t < s) {
      const size_t o = base + (size_t)t * DH + i;
      pr[c] = to_f32(r[o]);
      pk[c] = to_f32(k[o]);
      pv[c] = to_f32(v[o]);
      pw[c] = to_f32(w[o]);
    }
  }
}

// One (j, i) term of a step: read-out with the bonus, then the decay.
__device__ __forceinline__ void wkv_term(float& st, float rj, float kj,
                                         float wj, float uj, float vi,
                                         float& acc) {
  const float kv = kj * vi;
  acc = fmaf(rj, fmaf(uj, kv, st), acc);
  st = fmaf(wj, st, kv);
}

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
rwkv6_wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, float* __restrict__ y,
                 float* __restrict__ s_final, int h, int s) {
  // [buffer][r, k, v, w][step][channel]
  __shared__ __align__(16) float stage[2][4][kChunk][DH];
  __shared__ __align__(16) float su[DH];
  const int i = threadIdx.x;
  const int bh = blockIdx.x;
  const size_t base = (size_t)bh * s * DH;
  su[i] = u[(size_t)(bh % h) * DH + i];

  float state[DH];  // S[:, i], the value column this thread owns
#pragma unroll
  for (int j = 0; j < DH; ++j) state[j] = 0.f;

  float pr[kChunk], pk[kChunk], pv[kChunk], pw[kChunk];
  fetch<T, DH>(r, k, v, w, base, 0, s, i, pr, pk, pv, pw);
  int buf = 0;
  for (int t0 = 0; t0 < s; t0 += kChunk, buf ^= 1) {
    // stage[buf] was last read two chunks ago, before the previous
    // chunk's barrier, so writing it now needs no barrier of its own
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      stage[buf][0][c][i] = pr[c];
      stage[buf][1][c][i] = pk[c];
      stage[buf][2][c][i] = pv[c];
      stage[buf][3][c][i] = pw[c];
    }
    // the next chunk's loads are in flight while this chunk computes
    fetch<T, DH>(r, k, v, w, base, t0 + kChunk, s, i, pr, pk, pv, pw);
    __syncthreads();
    const int n = min(kChunk, s - t0);
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      const float* sr = stage[buf][0][c];
      const float* sk = stage[buf][1][c];
      const float* sw = stage[buf][3][c];
      const float vi = stage[buf][2][c][i];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
      for (int j = 0; j < DH; j += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(sr + j);
        const float4 k4 = *reinterpret_cast<const float4*>(sk + j);
        const float4 w4 = *reinterpret_cast<const float4*>(sw + j);
        const float4 u4 = *reinterpret_cast<const float4*>(su + j);
        wkv_term(state[j + 0], r4.x, k4.x, w4.x, u4.x, vi, acc0);
        wkv_term(state[j + 1], r4.y, k4.y, w4.y, u4.y, vi, acc1);
        wkv_term(state[j + 2], r4.z, k4.z, w4.z, u4.z, vi, acc2);
        wkv_term(state[j + 3], r4.w, k4.w, w4.w, u4.w, vi, acc3);
      }
      y[base + (size_t)(t0 + c) * DH + i] = (acc0 + acc1) + (acc2 + acc3);
    }
  }
  float* sf = s_final + (size_t)bh * DH * DH;
#pragma unroll
  for (int j = 0; j < DH; ++j) sf[j * DH + i] = state[j];
}

template <typename T, int DH>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* y, void* s_final,
                   int b, int h, int s, cudaStream_t stream) {
  rwkv6_wkv_kernel<T, DH><<<(unsigned)(b * h), DH, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(s_final), h, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* y, void* s_final,
                     int b, int h, int s, int dh, cudaStream_t stream) {
  if (dh == 32)
    return launch<T, 32>(r, k, v, w, u, y, s_final, b, h, s, stream);
  if (dh == 64)
    return launch<T, 64>(r, k, v, w, u, y, s_final, b, h, s, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w alike; u is float32).
// dh: 32 or 64. Returns the launch's cudaError_t.
extern "C" int repro_rwkv6_wkv(const void* r, const void* k, const void* v,
                               const void* w, const void* u, void* y,
                               void* s_final, int b, int h, int s, int dh,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || h <= 0 || s <= 0 || (int64_t)b * h > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, y, s_final, b, h, s, dh, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, y, s_final, b, h, s, dh,
                                   st);
  return cudaErrorInvalidValue;
}
