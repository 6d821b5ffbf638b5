// Grouped expert matmul for Hopper (sm_90a), f32 or bf16 in, f32 math.
//
// Replaces: src/repro/kernels/moe_gmm.py::moe_gmm (the Pallas TPU kernel,
// body `_kernel`). Same function: for every expert e of x (e, c, d) and
// w (e, d, f), out[e] = x[e] @ w[e], accumulated in f32 and cast to x's
// dtype. Unlike the Pallas kernel, no block has to divide c, d or f: the
// MoE decode path's capacity is c = 4.
//
// What bounds it on this card: at decode (c = 4) bytes. jamba's gate/up
// (4, 4, 8192) @ (4, 8192, 24576) streams 3.2 GB of weights for 6.4
// GFLOP: 0.96 ms at 3.35 TB/s. At prefill operations: granite's (40,
// 512, 1536) @ (40, 1536, 512) is 32.2 GFLOP against 294 MB, 0.195 ms
// on the tensor cores in 3xTF32 (495 / 3 TFLOP/s), jamba's 2.06 TFLOP
// 12.5 ms.
//
// What the design does about it, two kernels chosen by the capacity c:
//
// * c <= 16 (decode): `gmm_stream_kernel` reads every weight byte once.
//   A block of 8 warps owns one expert, a strip of 128 columns of f and
//   a range of d; w's rows are contiguous along f, so 16 KB stages of
//   the strip (32 rows in f32) stream through a 4-stage `cp.async` ring
//   with the block's c rows of x beside them. A thread takes 4 columns
//   of every eighth row of a stage and keeps c x 4 sums in registers,
//   the x values read as shared-memory broadcasts; the 8 row groups'
//   sums are added in shared memory at the end. Where the experts'
//   128-column strips make fewer than 4 blocks an SM, the strips narrow
//   to 64 columns if that alone makes enough (granite's down: 480 -> 960
//   blocks); where they are still too few (jamba's down: 64 strips x 4
//   experts), d is split across blocks: each writes its sums to a
//   workspace and a second kernel adds the parts in a fixed order, so a
//   result never depends on the order blocks ran in (no atomics).
//   Loading w straight into registers instead of the ring measured no
//   faster on the card.
// * c > 16 (prefill): `gmm_mma_kernel`, 128 x 128 output tiles of 8
//   warps, each warp a 64 x 32 piece, 32-deep d stages of x and w in a
//   3-stage `cp.async` ring in dynamic shared memory, rows padded so
//   that fragment loads are free of bank conflicts. The products run on
//   `mma.sync` (`mma_tf32.cuh`): f32 as m16n8k8 TF32 with the 3xTF32
//   split (f32 accuracy; one TF32 pass would not keep 2e-4), bf16 as
//   m16n8k16. The tensor cores truncate each sum they return (round
//   toward zero), which over jamba's 3 x 1,024 products into one
//   accumulator grew a bias of 1e-3; so each stage's products go into a
//   fresh partial sum that plain f32 adds (to nearest) fold into the
//   total. That doubles the accumulators: one block of 8 warps an SM. w (d, f) has f contiguous, MN-major for the B operand,
//   which `wgmma` takes in TF32 only K-major: hence `mma.sync`.
//
// Both stage with 16-byte `cp.async` copies (rows past c, d or f are
// zero-filled by the copy itself). Where a row of x or w is not a whole
// number of 16-byte chunks (or a base pointer is not 16-byte aligned)
// the same loops stage the tiles with plain loads, one element at a
// time. No model config in the repo takes that path (every MoE d_model
// and d_expert is a multiple of 8, and models/moe.py hands the kernel
// fresh buffers); it keeps the wrapper's contract, any c, d and f as the
// plain version takes, so that no shape that runs on the CPU raises on
// the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using mma::store;
using mma::to_f32;

constexpr int kThreads = 256;  // 8 warps, both kernels
constexpr int kDecodeMaxC = 16;
constexpr int kMinSplitStages = 8;  // a d split streams 8 stages or more

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);  // elements a 16-byte chunk
};

// rows [r0, r0 + rows) x cols [c0, c0 + cols) of a row-major (.., ld_g)
// global matrix into a shared tile of row stride ld_s; zeros from row
// r_end and col c_end on. VEC: 16-byte copies (cols, ld_g, c0 and c_end
// are multiples of the chunk), else plain loads.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(T* dst, int ld_s,
                                      const T* __restrict__ src,
                                      int64_t ld_g, int r0, int rows,
                                      int r_end, int c0, int cols,
                                      int c_end) {
  if (VEC) {
    constexpr int V = Vec<T>::kN;
    const int cpr = cols / V;
    for (int i = threadIdx.x; i < rows * cpr; i += kThreads) {
      const int r = i / cpr;
      const int cc = (i % cpr) * V;
      const bool in = r0 + r < r_end && c0 + cc < c_end;
      mma::cp_async16(dst + r * ld_s + cc,
                      in ? src + (r0 + r) * ld_g + c0 + cc : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, cc = i % cols;
      dst[r * ld_s + cc] = (r0 + r < r_end && c0 + cc < c_end)
                               ? src[(r0 + r) * ld_g + c0 + cc]
                               : T(0.f);
    }
  }
}

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

// -------------------------------------------------------- decode: stream
// BN columns of f a block (128, or 64 where the experts' strips would
// be too few), 4 a thread; a stage is KR rows of d, BN * KR = 4096
// elements (16 KB in f32)
template <int BN>
struct Stream {
  static constexpr int kKR = 4096 / BN;
  static constexpr int kRowsAPass = kThreads / (BN / 4);
  static constexpr int kStages = 4;
};

template <typename T, int CM, int BN>
constexpr int stream_smem_bytes() {
  constexpr int KR = Stream<BN>::kKR;
  constexpr int ring = Stream<BN>::kStages * (KR * BN + CM * KR) *
                       static_cast<int>(sizeof(T));
  constexpr int red = kThreads * 4 * CM * 4;
  return ring > red ? ring : red;
}

// grid: (strips of f, splits of d, experts). CM >= c rows of x (rows of
// x past c are zero-filled). splits == 1: out (T); else ws (f32 parts,
// [split][e][c][f]).
template <typename T, int CM, int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
gmm_stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ out, float* __restrict__ ws, int c, int d,
                  int f, int chunk) {
  constexpr int KR = Stream<BN>::kKR, S = Stream<BN>::kStages;
  constexpr int RP = Stream<BN>::kRowsAPass;  // rows read side by side
  extern __shared__ __align__(16) unsigned char smem[];
  T* wring = reinterpret_cast<T*>(smem);  // [S][KR][BN]
  T* xring = wring + S * KR * BN;         // [S][CM][KR]

  const int e = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int d0 = blockIdx.y * chunk;
  const int d1 = min(d, d0 + chunk);
  x += (int64_t)e * c * d;
  w += (int64_t)e * d * f;
  // this thread's row of each pass and its 4 columns
  const int rg = threadIdx.x / (BN / 4), cl = 4 * (threadIdx.x % (BN / 4));

  float acc[CM][4];
#pragma unroll
  for (int i = 0; i < CM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_k = (d1 - d0 + KR - 1) / KR;
  auto load_stage = [&](int kt) {
    const int slot = kt % S;
    const int k0 = d0 + kt * KR;
    stage<T, VEC>(wring + slot * KR * BN, BN, w, f, k0, KR, d1, n0, BN, f);
    stage<T, VEC>(xring + slot * CM * KR, KR, x, d, 0, CM, c, k0, KR, d1);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_k) load_stage(s);
    mma::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    mma::cp_async_wait<S - 2>();  // stage kt has landed
    __syncthreads();
    // the slot refilled now was read in iteration kt - 1, before the
    // barrier above
    if (kt + S - 1 < n_k) load_stage(kt + S - 1);
    mma::cp_async_commit();
    const T* ws_t = wring + (kt % S) * KR * BN;
    const T* xs_t = xring + (kt % S) * CM * KR;
#pragma unroll
    for (int rr = 0; rr < KR / RP; ++rr) {
      const int r = rg + RP * rr;
      float wv[4];
      load4(ws_t + r * BN + cl, wv);
#pragma unroll
      for (int i = 0; i < CM; ++i) {
        const float xv = to_f32(xs_t[i * KR + r]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' sums meet there

  float* red = reinterpret_cast<float*>(smem);  // [RP][CM][BN]
#pragma unroll
  for (int i = 0; i < CM; ++i)
    *reinterpret_cast<float4*>(red + (rg * CM + i) * BN + cl) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  for (int o = threadIdx.x; o < CM * BN; o += kThreads) {
    const int i = o / BN, col = o % BN;
    if (i >= c || n0 + col >= f) continue;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < RP; ++q) sum += red[(q * CM + i) * BN + col];
    const int64_t at = ((int64_t)e * c + i) * f + n0 + col;
    if (gridDim.y == 1)
      store(out + at, sum);
    else
      ws[(int64_t)blockIdx.y * gridDim.z * c * f + at] = sum;
  }
}

// out = the sum of the splits' parts, in split order
template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out,
                  int64_t n, int splits) {
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += ws[s * n + i];
    store(out + i, sum);
  }
}

// ---------------------------------------------------- prefill: tensor cores
template <typename T>
struct MmaTile {
  static constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
  static constexpr int kLdA = kBK + Vec<T>::kN;   // x tile [BM][BK]
  static constexpr int kLdB = kBN + 8;          // w tile [BK][BN]
  static constexpr int kStageElems = kBM * kLdA + kBK * kLdB;
  static constexpr int kSmemBytes =
      kStages * kStageElems * static_cast<int>(sizeof(T));
};

// one 8-deep (f32) or 16-deep (bf16) step of the warp's 64 x 32 piece.
// f32: SAFE takes the inf-safe split; otherwise the split of finite
// values, which sets `special` where an element needed the other
template <bool SAFE>
__device__ __forceinline__ void mma_step(float (&acc)[4][4][4],
                                         const float* as, const float* bs,
                                         int g, int t, bool& special) {
  constexpr int LDA = MmaTile<float>::kLdA, LDB = MmaTile<float>::kLdB;
  mma::Split<2> b[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float bv[2];
    mma::load_b_tf32_kn(bv, bs + 8 * n, LDB, g, t);
    b[n] = SAFE ? mma::split<true>(bv) : mma::split_finite(bv, special);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float av[4];
    mma::load_a_tf32(av, as + 16 * m * LDA, LDA, g, t);
    const mma::Split<4> a =
        SAFE ? mma::split<true>(av) : mma::split_finite(av, special);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma::mma_3xtf32(acc[m][n], a, b[n]);
  }
}

template <bool SAFE>
__device__ __forceinline__ void mma_step(float (&acc)[4][4][4],
                                         const __nv_bfloat16* as,
                                         const __nv_bfloat16* bs, int g,
                                         int t, bool&) {
  constexpr int LDA = MmaTile<__nv_bfloat16>::kLdA;
  constexpr int LDB = MmaTile<__nv_bfloat16>::kLdB;
  uint32_t b[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) mma::load_b_bf16_kn(b[n], bs + 8 * n, LDB, g, t);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    uint32_t a[4];
    mma::load_a_bf16(a, as + 16 * m * LDA, LDA, g, t);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma::mma_bf16(acc[m][n], a, b[n]);
  }
}

// grid: (tiles of f, tiles of c, experts)
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
gmm_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int c, int d, int f) {
  using Tile = MmaTile<T>;
  constexpr int BM = Tile::kBM, BN = Tile::kBN, BK = Tile::kBK;
  constexpr int S = Tile::kStages, LDA = Tile::kLdA, LDB = Tile::kLdB;
  constexpr int KSTEP = sizeof(T) == 4 ? 8 : 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [S][A tile, B tile]

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  x += (int64_t)e * c * d;
  w += (int64_t)e * d * f;
  out += (int64_t)e * c * f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // the warp's 64 x 32 piece

  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

  const int n_k = (d + BK - 1) / BK;
  auto load_stage = [&](int kt) {
    T* a = ring + (kt % S) * Tile::kStageElems;
    T* b = a + BM * LDA;
    const int k0 = kt * BK;
    stage<T, VEC>(a, LDA, x, d, m0, BM, c, k0, BK, d);
    stage<T, VEC>(b, LDB, w, f, k0, BK, d, n0, BN, f);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_k) load_stage(s);
    mma::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    mma::cp_async_wait<S - 2>();
    __syncthreads();
    if (kt + S - 1 < n_k) load_stage(kt + S - 1);
    mma::cp_async_commit();
    const T* a = ring + (kt % S) * Tile::kStageElems;
    const T* b = a + BM * LDA;
    // the tensor cores round their sums toward zero: a stage's products
    // go into a fresh partial sum, added to the total in f32 (to
    // nearest), so the bias grows with the stage's magnitude, not the
    // total's
    float part[4][4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[m][n][q] = 0.f;
    bool special = false;
#pragma unroll
    for (int kk = 0; kk < BK; kk += KSTEP)
      mma_step<false>(part, a + (64 * wm) * LDA + kk, b + kk * LDB + 32 * wn,
                      g, t, special);
    // f32: a NaN, an inf or a value that rounds to inf among the warp's
    // fragments of the stage (rare): the stage again, with the inf-safe
    // split, its products into a fresh partial sum
    if (sizeof(T) == 4 && __any_sync(0xffffffffu, special)) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[m][n][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; kk += KSTEP)
        mma_step<true>(part, a + (64 * wm) * LDA + kk,
                       b + kk * LDB + 32 * wn, g, t, special);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][n][q] += part[m][n][q];
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * wm + 16 * m + g + 8 * r;
      if (row >= c) continue;
      T* orow = out + (int64_t)row * f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = n0 + 32 * wn + 8 * n + 2 * t;
        const float v0 = acc[m][n][2 * r], v1 = acc[m][n][2 * r + 1];
        if (col + 1 < f && f % 2 == 0) {
          mma::store2(orow + col, v0, v1);
        } else {
          if (col < f) store(orow + col, v0);
          if (col + 1 < f) store(orow + col + 1, v1);
        }
      }
    }
}

// ------------------------------------------------------------- the plan
struct Plan {
  int kernel;  // 0 = stream (c <= 16), 1 = tensor cores
  int strip;   // stream: columns of f a block, 128 or 64
  int splits;  // stream: blocks d is cut into (1 = no second pass)
};

// Stream: 128-column strips, or 64 where that alone makes 4 blocks an
// SM; d split across blocks where the strips are still too few.
Plan plan(int e, int c, int d, int f) {
  if (c > kDecodeMaxC) return {1, 0, 1};
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t target = 4LL * sms;
  const int64_t wide = (int64_t)((f + 127) / 128) * e;
  const int64_t narrow = (int64_t)((f + 63) / 64) * e;
  const int strip = wide < target && narrow >= target ? 64 : 128;
  const int64_t blocks = strip == 64 ? narrow : wide;
  const int kr = 4096 / strip;
  const int stages = (d + kr - 1) / kr;
  int want = (int)((target + blocks - 1) / blocks);
  const int most = stages / kMinSplitStages;
  if (want > most) want = most;
  if (want < 1) want = 1;
  const int chunk = (stages + want - 1) / want * kr;
  return {0, strip, (d + chunk - 1) / chunk};
}

template <typename T, int CM, int BN, bool VEC>
cudaError_t launch_stream(const T* x, const T* w, T* out, float* ws, int e,
                          int c, int d, int f, int splits,
                          cudaStream_t stream) {
  constexpr int bytes = stream_smem_bytes<T, CM, BN>();
  constexpr int KR = Stream<BN>::kKR;
  static bool done[64] = {};
  cudaError_t err =
      mma::allow_smem(gmm_stream_kernel<T, CM, BN, VEC>, bytes, done);
  if (err != cudaSuccess) return err;
  const int stages = (d + KR - 1) / KR;
  const int chunk = (stages + splits - 1) / splits * KR;
  dim3 grid((f + BN - 1) / BN, splits, e);
  gmm_stream_kernel<T, CM, BN, VEC><<<grid, kThreads, bytes, stream>>>(
      x, w, out, ws, c, d, f, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t n = (int64_t)e * c * f;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  gmm_reduce_kernel<T><<<(int)(blocks < 4096 ? blocks : 4096), kThreads, 0,
                         stream>>>(ws, out, n, splits);
  return cudaGetLastError();
}

template <typename T, int CM, bool VEC>
cudaError_t launch_stream(const T* x, const T* w, T* out, float* ws, int e,
                          int c, int d, int f, const Plan& p,
                          cudaStream_t stream) {
  if (p.strip == 64)
    return launch_stream<T, CM, 64, VEC>(x, w, out, ws, e, c, d, f,
                                         p.splits, stream);
  return launch_stream<T, CM, 128, VEC>(x, w, out, ws, e, c, d, f, p.splits,
                                        stream);
}

template <typename T, bool VEC>
cudaError_t launch(const void* xv, const void* wv, void* outv, void* wsv,
                   int e, int c, int d, int f, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* out = static_cast<T*>(outv);
  float* ws = static_cast<float*>(wsv);
  const Plan p = plan(e, c, d, f);
  if (p.kernel == 0) {
    if (p.splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
    if (c <= 4)
      return launch_stream<T, 4, VEC>(x, w, out, ws, e, c, d, f, p, stream);
    if (c <= 8)
      return launch_stream<T, 8, VEC>(x, w, out, ws, e, c, d, f, p, stream);
    return launch_stream<T, 16, VEC>(x, w, out, ws, e, c, d, f, p, stream);
  }
  using Tile = MmaTile<T>;
  static bool done[64] = {};
  cudaError_t err =
      mma::allow_smem(gmm_mma_kernel<T, VEC>, Tile::kSmemBytes, done);
  if (err != cudaSuccess) return err;
  dim3 grid((f + Tile::kBN - 1) / Tile::kBN, (c + Tile::kBM - 1) / Tile::kBM,
            e);
  gmm_mma_kernel<T, VEC><<<grid, kThreads, Tile::kSmemBytes, stream>>>(
      x, w, out, c, d, f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* out, void* ws,
                     int e, int c, int d, int f, cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if (aligned && d % V == 0 && f % V == 0)
    return launch<T, true>(x, w, out, ws, e, c, d, f, stream);
  return launch<T, false>(x, w, out, ws, e, c, d, f, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike). x (e, c, d),
// w (e, d, f), out (e, c, f), all contiguous; ws: f32 scratch of
// splits * e * c * f elements where `repro_moe_gmm_plan` gives splits >
// 1, else unused. Returns the launch's cudaError_t.
extern "C" int repro_moe_gmm(const void* x, const void* w, void* out,
                             void* ws, int e, int c, int d, int f,
                             int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e <= 0 || c <= 0 || d <= 0 || f <= 0 || e > 65535 ||
      (c + MmaTile<float>::kBM - 1) / MmaTile<float>::kBM > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(x, w, out, ws, e, c, d, f, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, out, ws, e, c, d, f, st);
  return cudaErrorInvalidValue;
}

// The kernel a call of these sizes runs on the current device: 0 =
// stream (c <= 16), 1 = tensor cores; *strip: the stream's columns a
// block; *splits: the blocks it cuts d into.
extern "C" int repro_moe_gmm_plan(int e, int c, int d, int f, int* strip,
                                  int* splits) {
  const Plan p = plan(e, c, d, f);
  *strip = p.strip;
  *splits = p.splits;
  return p.kernel;
}
