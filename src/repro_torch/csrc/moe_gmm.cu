// Grouped expert matmul for Hopper (sm_90a), f32 or bf16 in, f32 math.
//
// Replaces: src/repro/kernels/moe_gmm.py::moe_gmm (the Pallas TPU kernel,
// body `_kernel`). Same function: for every expert e of x (e, c, d) and
// w (e, d, f), out[e] = x[e] @ w[e], accumulated in f32 and cast to x's
// dtype. Unlike the Pallas kernel, no block has to divide c, d or f: the
// MoE decode path's capacity is c = 4.
//
// What bounds it on this card: at the granite-moe prefill shape
// (40, 512, 1536) @ (40, 1536, 512) the product is 32.2 GFLOP against
// 294 MB, so the f32 rate (67 TFLOP/s outside the tensor cores; TF32 is
// off, the f32 tolerance is 2e-4) bounds it at 0.48 ms. At decode
// (c = 4) the same weights are 126 MB for 0.25 GFLOP: bytes bound it at
// 0.038 ms.
//
// What the design does about it: it is written from what it computes,
// not from the Pallas grid. One block of 256 threads per (f-tile,
// c-tile, expert) computes a 64 x 64 output tile; each thread keeps a
// 4 x 4 piece of it in registers, so every value read from shared
// memory feeds four FMAs. The d-loop stages 16-deep tiles of x and w in
// double-buffered shared memory: while the block computes one tile, the
// next one is in flight through 16-byte `cp.async` copies (rows past c,
// d or f are zero-filled by the copy itself). Where a row of x or w is
// not a whole number of 16-byte chunks (or a base pointer is not
// 16-byte aligned) the same loop stages the tiles with plain loads, one
// element at a time. No model config in the repo takes that path (every
// MoE d_model and d_expert is a multiple of 8, and models/moe.py hands
// the kernel fresh buffers); it keeps the wrapper's contract, any c, d
// and f as the plain version takes, so that no shape that runs on the
// CPU raises on the card. The decode shape wastes most of a 64-row tile:
// a narrow-tile variant, `wgmma` and TMA with bf16 or TF32 inputs are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kBM = 64;        // rows of x (capacity slots) per block
constexpr int kBN = 64;        // columns of w per block
constexpr int kBK = 16;        // depth of a shared-memory stage

template <typename T>
struct Tile {
  // elements of T in one 16-byte chunk, and padded row strides that
  // keep every chunk 16-byte aligned and the compute loop's reads
  // free of bank conflicts
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kStrideA = kBK + kVec;
  static constexpr int kStrideB = kBN + kVec;
};

// four consecutive elements of shared memory as floats
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes from global to shared memory, asynchronously; with `full`
// false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stages the d-tile starting at k0 of this block's x rows (as[row][k])
// and w columns (bs[k][col]); zeros wherever the tile leaves x or w.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(const T* __restrict__ x,
                                      const T* __restrict__ w, T* as, T* bs,
                                      int c, int d, int f, int m0, int n0,
                                      int k0) {
  constexpr int V = Tile<T>::kVec;
  constexpr int SA = Tile<T>::kStrideA;
  constexpr int SB = Tile<T>::kStrideB;
  const int tid = threadIdx.x;
  if (VEC) {
    // d % V == 0 and f % V == 0: a chunk lies wholly inside or outside
    for (int i = tid; i < kBM * (kBK / V); i += kThreads) {
      const int row = i / (kBK / V);
      const int kc = (i % (kBK / V)) * V;
      const bool in = m0 + row < c && k0 + kc < d;
      const T* src = in ? x + (int64_t)(m0 + row) * d + k0 + kc : x;
      cp_async16(as + row * SA + kc, src, in);
    }
    for (int i = tid; i < kBK * (kBN / V); i += kThreads) {
      const int k = i / (kBN / V);
      const int nc = (i % (kBN / V)) * V;
      const bool in = k0 + k < d && n0 + nc < f;
      const T* src = in ? w + (int64_t)(k0 + k) * f + n0 + nc : w;
      cp_async16(bs + k * SB + nc, src, in);
    }
  } else {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int row = i / kBK, k = i % kBK;
      as[row * SA + k] = (m0 + row < c && k0 + k < d)
                             ? x[(int64_t)(m0 + row) * d + k0 + k]
                             : T(0.f);
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, n = i % kBN;
      bs[k * SB + n] = (k0 + k < d && n0 + n < f)
                           ? w[(int64_t)(k0 + k) * f + n0 + n]
                           : T(0.f);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int c, int d, int f) {
  constexpr int SA = Tile<T>::kStrideA;
  constexpr int SB = Tile<T>::kStrideB;
  __shared__ __align__(16) T as[2][kBM * SA];
  __shared__ __align__(16) T bs[2][kBK * SB];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  x += (int64_t)e * c * d;
  w += (int64_t)e * d * f;
  out += (int64_t)e * c * f;
  const int tx = threadIdx.x % 16;  // this thread's columns: n0 + 4 tx + j
  const int ty = threadIdx.x / 16;  // its rows: m0 + 4 ty + i

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_k = (d + kBK - 1) / kBK;
  stage<T, VEC>(x, w, as[0], bs[0], c, d, f, m0, n0, 0);
  cp_async_commit();
  for (int t = 0; t < n_k; ++t) {
    const int buf = t & 1;
    // the other buffer was last read before the previous iteration's
    // closing barrier, so the next tile may land in it now
    if (t + 1 < n_k)
      stage<T, VEC>(x, w, as[buf ^ 1], bs[buf ^ 1], c, d, f, m0, n0,
                    (t + 1) * kBK);
    cp_async_commit();     // an empty group on the last tile
    cp_async_wait_one();   // this tile's copies have landed
    __syncthreads();
    const T* a = as[buf] + (4 * ty) * SA;
    const T* b = bs[buf] + 4 * tx;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float av[4][4], bv[4][4];  // av[row][k], bv[k][col]
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(a + i * SA + kk, av[i]);
#pragma unroll
      for (int k = 0; k < 4; ++k) load4(b + (kk + k) * SB, bv[k]);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i][k], bv[k][j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= c) break;
    T* orow = out + (int64_t)row * f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      if (col < f) store(orow + col, acc[i][j]);
    }
  }
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, const void* w, void* out, int e, int c,
                   int d, int f, cudaStream_t stream) {
  dim3 grid((f + kBN - 1) / kBN, (c + kBM - 1) / kBM, e);
  moe_gmm_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), c, d, f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* out, int e, int c,
                     int d, int f, cudaStream_t stream) {
  constexpr int V = Tile<T>::kVec;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if (aligned && d % V == 0 && f % V == 0)
    return launch<T, true>(x, w, out, e, c, d, f, stream);
  return launch<T, false>(x, w, out, e, c, d, f, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike). x (e, c, d),
// w (e, d, f), out (e, c, f), all contiguous. Returns the launch's
// cudaError_t.
extern "C" int repro_moe_gmm(const void* x, const void* w, void* out, int e,
                             int c, int d, int f, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e <= 0 || c <= 0 || d <= 0 || f <= 0 || e > 65535 ||
      (c + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(x, w, out, e, c, d, f, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, w, out, e, c, d, f, st);
  return cudaErrorInvalidValue;
}
