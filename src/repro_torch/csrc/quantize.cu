// Per-row symmetric int8 quantization for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quantize.py::quantize_int8 (the Pallas TPU
// kernel, body `_kernel`). Same function, per row of x (rows, d):
// absmax = max(|x|, 1e-12), scale = absmax / 127,
// q = clip(round_half_even(x / scale), -127, 127); outputs int8 q
// (rows, d) and f32 scale (rows,). XLA compiles the Pallas body's
// division by the constant 127 into a multiply by float32(1/127), and
// so does this kernel (kernels/ref.py states why); x / scale stays a
// true division there and here.
//
// What bounds it on this card: it reads each input once and writes a
// quarter of it back, with a handful of operations per element, so it
// is bound by memory, and at the split-NN path's size ((8R, 64) f32,
// 1 MiB read at R = 512) by launch latency.
//
// What the design does about it: one warp per row, so the row's absmax
// is a register max plus a five-step shuffle reduction, with no shared
// memory and no second read of device memory: each lane keeps its
// elements of the row in registers between the absmax pass and the
// quantize pass (rows wider than 32 * kMaxPerLane read again from
// device memory, where L1 still holds them). Bit-exact agreement with
// the reference needs an IEEE division (`__fdiv_rn`, and the file is
// built without --use_fast_math, which would make it a reciprocal) and
// round half to even (`rintf`, not `roundf`). Any row count works: the
// Pallas `block_r` tiling has no counterpart here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 8;  // rows up to 256 wide stay in registers

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ int8_t quantize_one(float x, float scale) {
  float r = rintf(__fdiv_rn(x, scale));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<int8_t>(r);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale_out, int64_t rows, int d) {
  const int lane = threadIdx.x % 32;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + row * d;
  int8_t* qr = q + row * d;

  float vals[kMaxPerLane];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    vals[i] = c < d ? to_f32(xr[c]) : 0.f;
    amax = fmaxf(amax, fabsf(vals[i]));
  }
  for (int c = lane + 32 * kMaxPerLane; c < d; c += 32)
    amax = fmaxf(amax, fabsf(to_f32(xr[c])));
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const float scale = __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < d) qr[c] = quantize_one(vals[i], scale);
  }
  for (int c = lane + 32 * kMaxPerLane; c < d; c += 32)
    qr[c] = quantize_one(to_f32(xr[c]), scale);
  if (lane == 0) scale_out[row] = scale;
}

template <typename T>
cudaError_t launch(const void* x, void* q, void* scale, int64_t rows,
                   int d, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  quantize_int8_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                            stream>>>(static_cast<const T*>(x),
                                      static_cast<int8_t*>(q),
                                      static_cast<float*>(scale), rows, d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_quantize_int8(const void* x, void* q, void* scale,
                                   int64_t rows, int d, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || (rows + kWarpsPerBlock - 1) / kWarpsPerBlock
                                 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, q, scale, rows, d, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, q, scale, rows, d, st);
  return cudaErrorInvalidValue;
}
