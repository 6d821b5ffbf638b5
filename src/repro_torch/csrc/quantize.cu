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
// 1 MiB read at R = 512) by what a launch costs: the grid's ramp, a
// block's first load's latency and its last store's drain.
//
// What the design does about it, two variants of one function:
//
// * `quantize_vec_kernel`, where a row is whole 16-byte chunks (d a
//   multiple of 4 in f32, of 8 in bf16) and x is 16-byte aligned: a row
//   is spread over G lanes, G the power of two at or above its chunk
//   count (16 lanes at d 64 in f32, so a warp takes two rows), each
//   lane loading a chunk with one 16-byte load (a float4, or 8 bf16).
//   The row's absmax is a register max and a log2(G)-step shuffle
//   inside the lane group, with no shared memory and no second read of
//   device memory (up to 4 chunks a lane stay in registers; wider rows
//   read again from L1). Each lane stores its chunk's codes as one
//   packed 4-byte (f32) or 8-byte (bf16) store, and the group's first
//   lane the row's scale. The grid is one wave (as many blocks as the
//   SMs hold at once) walking the row groups with a stride, so a large
//   input needs no second wave and a small one launches no more blocks
//   than it has row groups. A block's scales gathered in shared memory
//   and stored as one coalesced store measured slower at both (4096,
//   64) and (1,048,576, 64): the barrier a pass costs more than the
//   scattered 4-byte stores (PERF.md).
// * `quantize_int8_kernel` (the first port's), for a width that is not
//   whole 16-byte chunks or an x that is not 16-byte aligned: one warp
//   a row, one 4-byte (or 2-byte) load and a 1-byte store per element,
//   a five-step shuffle.
//
// Bit-exact agreement with the reference needs an IEEE division
// (`__fdiv_rn`, and the file is built without --use_fast_math, which
// would make it a reciprocal) and round half to even (`rintf`, not
// `roundf`); the absmax is a max, exact in any order. Any row count
// works: the Pallas `block_r` tiling has no counterpart here.
//
// `repro_quantize_int8_floor` launches what bounds the vector variant
// from below at a given shape, for the kernel table: an empty kernel on
// the same grid, and a copy that reads x (f32) and writes a quarter of
// its bytes with the same loads, stores and grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxPerLane = 8;  // scalar variant: rows up to 256 wide
                                // stay in registers
constexpr int kMaxChunks = 4;   // vector variant: chunks a lane keeps

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ int8_t quantize_one(float x, float scale) {
  float r = rintf(__fdiv_rn(x, scale));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<int8_t>(r);
}

__device__ __forceinline__ float row_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
}

// ------------------------------------------------------ vector variant
// one 16-byte chunk of T: its values as f32, and its codes' packed store
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
  static __device__ __forceinline__ void store(int8_t* p,
                                               const float (&v)[4],
                                               float scale) {
    *reinterpret_cast<char4*>(p) =
        make_char4(quantize_one(v[0], scale), quantize_one(v[1], scale),
                   quantize_one(v[2], scale), quantize_one(v[3], scale));
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(int8_t* p,
                                               const float (&v)[8],
                                               float scale) {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                      quantize_one(v[i], scale)))
                  << (8 * (i % 4));
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
};

// G lanes a row, CPL chunks a lane in registers; kThreads / G rows a
// block a pass of the grid-stride loop
template <typename T, int G, int CPL>
__global__ void __launch_bounds__(kThreads)
quantize_vec_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scale_out, int64_t rows, int d) {
  using C = Chunk<T>;
  constexpr int V = C::kN;
  constexpr int RPB = kThreads / G;
  const int sub = threadIdx.x % G;
  const int local = threadIdx.x / G;
  const int chunks = d / V;
  for (int64_t base = (int64_t)blockIdx.x * RPB; base < rows;
       base += (int64_t)gridDim.x * RPB) {
    const int64_t row = base + local;
    const bool live = row < rows;
    const T* xr = x + row * d;
    int8_t* qr = q + row * d;

    float v[CPL][V];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = sub + G * i;
      if (live && c < chunks) {
        C::load(xr + c * V, v[i]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[i][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(v[i][e]));
    }
    if (live) {
      for (int c = sub + G * CPL; c < chunks; c += G) {
        float w[V];
        C::load(xr + c * V, w);
#pragma unroll
        for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(w[e]));
      }
    }
    // every lane takes part (rows past the end with amax 0), and the
    // offsets stay inside the G-lane group
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

    const float scale = row_scale(amax);
    if (live) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = sub + G * i;
        if (c < chunks) C::store(qr + c * V, v[i], scale);
      }
      for (int c = sub + G * CPL; c < chunks; c += G) {
        float w[V];
        C::load(xr + c * V, w);
        C::store(qr + c * V, w, scale);
      }
    }
    if (sub == 0 && live) scale_out[row] = scale;
  }
}

// ------------------------------------------------------ scalar variant
template <typename T>
__global__ void __launch_bounds__(kThreads)
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

  const float scale = row_scale(amax);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < d) qr[c] = quantize_one(vals[i], scale);
  }
  for (int c = lane + 32 * kMaxPerLane; c < d; c += 32)
    qr[c] = quantize_one(to_f32(xr[c]), scale);
  if (lane == 0) scale_out[row] = scale;
}

// ----------------------------------------------------- launch floors
__global__ void floor_empty_kernel() {}

// the vector variant's loads, stores and grid for f32 at G lanes a row,
// one chunk a lane, with no reduction and no arithmetic: each value's
// low byte is its "code"
template <int G>
__global__ void __launch_bounds__(kThreads)
floor_copy_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                  int64_t rows, int d) {
  constexpr int RPB = kThreads / G;
  const int sub = threadIdx.x % G;
  const int chunks = d / 4;
  for (int64_t base = (int64_t)blockIdx.x * RPB; base < rows;
       base += (int64_t)gridDim.x * RPB) {
    const int64_t row = base + threadIdx.x / G;
    if (row < rows && sub < chunks) {
      const float4 r =
          *reinterpret_cast<const float4*>(x + row * d + sub * 4);
      *reinterpret_cast<char4*>(q + row * d + sub * 4) = make_char4(
          (signed char)__float_as_int(r.x), (signed char)__float_as_int(r.y),
          (signed char)__float_as_int(r.z), (signed char)__float_as_int(r.w));
    }
  }
}

// ------------------------------------------------------------ dispatch
template <typename T>
bool vector_ok(const void* x, int d) {
  return d % Chunk<T>::kN == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

int lanes_for(int chunks) {
  int g = 1;
  while (g < chunks && g < 32) g *= 2;
  return g;
}

// one wave: as many blocks as the device holds at once, no more than the
// row groups
template <typename K>
cudaError_t one_wave(K kernel, int64_t groups, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t wave = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(groups < wave ? groups : wave);
  return cudaSuccess;
}

template <typename T, int G, int CPL>
cudaError_t launch_vec(const void* x, void* q, void* scale, int64_t rows,
                       int d, cudaStream_t stream) {
  auto kernel = quantize_vec_kernel<T, G, CPL>;
  int blocks = 0;
  cudaError_t err =
      one_wave(kernel, (rows + kThreads / G - 1) / (kThreads / G), &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                          static_cast<int8_t*>(q),
                                          static_cast<float*>(scale), rows,
                                          d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec_lanes(const void* x, void* q, void* scale,
                             int64_t rows, int d, cudaStream_t stream) {
  const int chunks = d / Chunk<T>::kN;
  switch (lanes_for(chunks)) {
    case 1: return launch_vec<T, 1, 1>(x, q, scale, rows, d, stream);
    case 2: return launch_vec<T, 2, 1>(x, q, scale, rows, d, stream);
    case 4: return launch_vec<T, 4, 1>(x, q, scale, rows, d, stream);
    case 8: return launch_vec<T, 8, 1>(x, q, scale, rows, d, stream);
    case 16: return launch_vec<T, 16, 1>(x, q, scale, rows, d, stream);
    default:
      if (chunks <= 32)
        return launch_vec<T, 32, 1>(x, q, scale, rows, d, stream);
      if (chunks <= 64)
        return launch_vec<T, 32, 2>(x, q, scale, rows, d, stream);
      return launch_vec<T, 32, kMaxChunks>(x, q, scale, rows, d, stream);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* q, void* scale, int64_t rows,
                   int d, cudaStream_t stream) {
  if (vector_ok<T>(x, d))
    return launch_vec_lanes<T>(x, q, scale, rows, d, stream);
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_int8_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), rows, d);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_floor(const void* x, void* q, int64_t rows, int d,
                         int kind, cudaStream_t stream) {
  constexpr int RPB = kThreads / G;
  const int64_t groups = (rows + RPB - 1) / RPB;
  int blocks = 0;
  cudaError_t err =
      kind == 0 ? one_wave(quantize_vec_kernel<float, G, 1>, groups, &blocks)
                : one_wave(floor_copy_kernel<G>, groups, &blocks);
  if (err != cudaSuccess) return err;
  if (kind == 0)
    floor_empty_kernel<<<blocks, kThreads, 0, stream>>>();
  else
    floor_copy_kernel<G><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q), rows, d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_quantize_int8(const void* x, void* q, void* scale,
                                   int64_t rows, int d, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, q, scale, rows, d, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, q, scale, rows, d, st);
  return cudaErrorInvalidValue;
}

// 1 where a call on x of width d runs the vector variant, 0 where it
// runs the scalar one, -1 for an unknown dtype
extern "C" int repro_quantize_int8_variant(const void* x, int d, int dtype) {
  if (dtype == 0) return vector_ok<float>(x, d) ? 1 : 0;
  if (dtype == 1) return vector_ok<__nv_bfloat16>(x, d) ? 1 : 0;
  return -1;
}

// The vector variant's floor at (rows, d) f32, d a multiple of 4 up to
// 128 and x 16-byte aligned: kind 0 launches an empty kernel on its
// grid, kind 1 the copy of x's values' low bytes into q.
extern "C" int repro_quantize_int8_floor(const void* x, void* q,
                                         int64_t rows, int d, int kind,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || d > 128 || !vector_ok<float>(x, d) ||
      (kind != 0 && kind != 1))
    return cudaErrorInvalidValue;
  switch (lanes_for(d / 4)) {
    case 1: return launch_floor<1>(x, q, rows, d, kind, st);
    case 2: return launch_floor<2>(x, q, rows, d, kind, st);
    case 4: return launch_floor<4>(x, q, rows, d, kind, st);
    case 8: return launch_floor<8>(x, q, rows, d, kind, st);
    case 16: return launch_floor<16>(x, q, rows, d, kind, st);
    default: return launch_floor<32>(x, q, rows, d, kind, st);
  }
}
