// Mamba S6 selective scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/selective_scan.py::selective_scan (the
// Pallas TPU kernel, body `_kernel`). Same function, for every batch row
// b and channel d of dt, u (b, s, di), B, C (b, s, n) and A (di, n),
// from h = 0:
//   h_t[d, k] = exp(dt_t[d] * A[d, k]) * h_{t-1}[d, k]
//               + dt_t[d] * u_t[d] * B_t[k]
//   y_t[d]    = sum_k h_t[d, k] * C_t[k]
// Outputs y (b, s, di) f32 and h_final (b, di, n) f32. dt, B and C are
// f32 or bf16 (alike), u is f32 or bf16 on its own, A is f32; all
// arithmetic is f32. The decay is exp2 of dt * A * log2(e): each thread
// keeps its row of A pre-scaled by log2(e) in registers, and a decay is
// one multiply and one `ex2.approx.ftz.f32` on the special-function
// unit (relative error ~2 ulp), where the first design's accurate
// `expf` spent ~10 FMA-pipe instructions around its `ex2`. A decay
// below 2^-126 is flushed to 0 (it would scale h by less than 1e-38);
// the form that keeps subnormals wraps each `ex2` in a test and two
// multiplies, and measured slower on the card.
// The argument is rounded twice (A * log2 e, then dt times it) instead
// of once: at jamba's dt the decay moves by a few f32 ulps a step, and
// tests/test_torch_recurrence_order.py holds that model, +-2 ulp in the
// worst direction over 512 steps, within the path's 2e-5 of the output's
// largest magnitude against a float64 recurrence.
//
// What bounds it on this card: each input element is read once and each
// output written once. At jamba's prefill shape (b 4, s 512, di 16384,
// n 16) in f32, dt, u and y are 134.2 MB each, h_final 4.2 MB, B, C and
// A ~1.3 MB together: 407 MB, 0.121 ms at 3.35 TB/s. It also computes
// b * s * di * n = 537 M exponentials on the special-function units, 16
// a clock an SM: 254 k clocks over 132 SMs, ~0.13 ms at 1.98 GHz and
// ~0.145 ms at 1.755. That floor, not the bytes, binds once the
// exponential is one `ex2`: the kernel cannot go under it without
// taking exponentials off that unit. Measured, it runs above both
// floors; moving a share of the exponentials to a polynomial on the FMA
// pipes, splitting n over two lanes, 64 or 256 threads a block and
// 8-step chunks all measured slower or no faster on the card, so the
// limit is neither the special-function unit alone nor occupancy.
//
// What the design does about it: the Pallas kernel carries h in VMEM
// across a sequential grid axis of sequence chunks; here a thread owns
// one (batch, channel) recurrence for the whole sequence and keeps its
// n states and its row of A in registers, so h never touches memory
// until h_final is written. At jamba's shape that is b * di = 65,536
// recurrences, 512 blocks of 128 threads (~15.5 warps an SM), and each
// thread's n states are n independent update chains a step, enough
// work in flight to cover the latency of each. dt_t and u_t of
// neighbouring channels are neighbouring addresses, so their loads and
// the y store coalesce; each thread loads its dt and u of the next
// kChunk steps into registers while it computes this chunk, and takes
// dt * u once a step for all n states. B_t and C_t are the same
// for every channel of a batch row: a chunk of them is staged in
// double-buffered shared memory for the whole block and read as float4
// broadcasts. Any s and di work (a ragged di is masked). Any n >= 1
// works, as the Pallas kernel's does: n of 4, 8 or 16 (every config of
// the repo) is a template parameter, N = n; any other n up to 64 runs
// the same kernel at N = 32 or 64 with the states past n masked (their
// A, B and C are zero, so they stay 0 and add nothing to y); above 64
// a thread walks its n states in a loop, keeping them in h_final's row
// (global memory, cached in L1/L2) instead of registers. A chunked
// tensor-core form would not lower the floor: its decays are the same
// exponentials.
//
// Under grad (h_chk not null) the kernel also writes h before every 4th
// step to h_chk (b, ceil(s / 4), n, di) f32, from which the backward
// kernel (selective_scan_bwd.cu) recomputes the states between (four
// checkpoints a staged chunk, from the registers that hold h anyway).
// The layout is state-major so that each store of a warp is 128
// contiguous bytes: with a thread's n states contiguous (..., di, n),
// as first written, a warp's store touched 32 sectors for 128 bytes,
// and the forward under grad took 1.366 ms at jamba's shape against
// 0.209 without; state-major it takes 0.376
// (launch/recurrence_turns.py, PERF.md).
// The writes are a template parameter (CKPT): serving runs a kernel
// without them (a null test in the step loop cost 3.4% at jamba's
// shape, measured in turns). State dims above 16 have no backward
// kernel and take no h_chk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "recurrence_bwd.cuh"

namespace {

constexpr int kThreads = 128;  // channels of one batch row per block
constexpr int kChunk = 16;     // time steps staged at once
constexpr float kLog2e = 1.44269504088896341f;
constexpr int kCk = recurrence::kScanCheckpoint;
static_assert(kChunk % kCk == 0, "checkpoints at fixed steps of a chunk");

// 2^x on the special-function unit (~2 ulp), a result below 2^-126
// flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int N>
struct Stage {
  // elements of B (and of C) in one chunk, and each thread's share
  static constexpr int kElems = kChunk * N;
  static constexpr int kLoads = (kElems + kThreads - 1) / kThreads;
};

// This thread's dt and u of steps [t0, t0 + kChunk) and its share of the
// chunk's B and C, into registers (steps past s are left as they were).
// n is the state dim of B and C (N, or less where the tail is masked).
template <typename TX, typename TU, int N>
__device__ __forceinline__ void fetch(
    const TX* __restrict__ dt, const TU* __restrict__ u,
    const TX* __restrict__ bm, const TX* __restrict__ cm, size_t row,
    int t0, int s, int di, int n, int ch, bool active,
    float (&pdt)[kChunk],
    float (&pu)[kChunk], float (&pb)[Stage<N>::kLoads],
    float (&pc)[Stage<N>::kLoads]) {
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const int t = t0 + c;
    if (active && t < s) {
      const size_t o = (row + t) * di + ch;
      pdt[c] = to_f32(dt[o]);
      pu[c] = to_f32(u[o]);
    }
  }
  // B and C of a batch row's chunk are kChunk * n consecutive elements
  const size_t base = (row + t0) * n;
  const int left = (s - t0) * n;
#pragma unroll
  for (int i = 0; i < Stage<N>::kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < kChunk * n && e < left) {
      pb[i] = to_f32(bm[base + e]);
      pc[i] = to_f32(cm[base + e]);
    }
  }
}

// EXACT: n == N. Otherwise n < N and the states n..N-1 are masked: their
// A, B and C are zero, so they stay 0 and add nothing to y. CKPT: write
// h_chk.
template <typename TX, typename TU, int N, bool EXACT, bool CKPT>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const TX* __restrict__ dt, const TX* __restrict__ bm,
                      const TX* __restrict__ cm, const TU* __restrict__ u,
                      const float* __restrict__ a_mat, float* __restrict__ y,
                      float* __restrict__ h_final, float* __restrict__ h_chk,
                      int s, int di, int n_arg) {
  // [buffer][step][state]
  __shared__ __align__(16) float sb[2][kChunk][N];
  __shared__ __align__(16) float sc[2][kChunk][N];
  const int n = EXACT ? N : n_arg;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool active = ch < di;
  const size_t row = (size_t)blockIdx.y * s;  // (batch, t = 0)

  if (!EXACT) {
    // the masked states' B and C: zero once, never written again
    for (int e = threadIdx.x; e < 2 * kChunk * N; e += kThreads) {
      (&sb[0][0][0])[e] = 0.f;
      (&sc[0][0][0])[e] = 0.f;
    }
    __syncthreads();  // before any thread stages a chunk over the zeros
  }
  float a2[N], h[N];  // A[ch, k] * log2(e), and the states
#pragma unroll
  for (int k = 0; k < N; ++k) {
    a2[k] = active && k < n ? a_mat[(size_t)ch * n + k] * kLog2e : 0.f;
    h[k] = 0.f;
  }

  float pdt[kChunk], pu[kChunk], cdt[kChunk], cu[kChunk];
  float pb[Stage<N>::kLoads], pc[Stage<N>::kLoads];
#pragma unroll
  for (int c = 0; c < kChunk; ++c) pdt[c] = pu[c] = 0.f;
#pragma unroll
  for (int i = 0; i < Stage<N>::kLoads; ++i) pb[i] = pc[i] = 0.f;
  fetch<TX, TU, N>(dt, u, bm, cm, row, 0, s, di, n, ch, active, pdt, pu,
                   pb, pc);
  int buf = 0;
  for (int t0 = 0; t0 < s; t0 += kChunk, buf ^= 1) {
    // sb/sc[buf] were last read two chunks ago, before the previous
    // chunk's barrier, so writing them now needs no barrier of its own
#pragma unroll
    for (int i = 0; i < Stage<N>::kLoads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (EXACT && e < Stage<N>::kElems) {
        (&sb[buf][0][0])[e] = pb[i];
        (&sc[buf][0][0])[e] = pc[i];
      } else if (!EXACT && e < kChunk * n) {
        sb[buf][e / n][e % n] = pb[i];
        sc[buf][e / n][e % n] = pc[i];
      }
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      cdt[c] = pdt[c];
      cu[c] = pu[c];
    }
    // the next chunk's loads are in flight while this chunk computes
    if (t0 + kChunk < s)
      fetch<TX, TU, N>(dt, u, bm, cm, row, t0 + kChunk, s, di, n, ch,
                       active, pdt, pu, pb, pc);
    __syncthreads();
    const int steps = min(kChunk, s - t0);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c < steps) {
        if (CKPT && c % kCk == 0 && active) {
          // h before step t0 + c, state-major: a warp's 32 channels of
          // one state are 128 contiguous bytes
          float* hc = h_chk + ((size_t)blockIdx.y * ((s + kCk - 1) / kCk)
                               + (t0 + c) / kCk) * n * di + ch;
#pragma unroll
          for (int k = 0; k < N; ++k)
            if (EXACT || k < n) hc[(size_t)k * di] = h[k];
        }
        const float d = cdt[c];
        const float du = d * cu[c];
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int k = 0; k < N; k += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(&sb[buf][c][k]);
          const float4 c4 = *reinterpret_cast<const float4*>(&sc[buf][c][k]);
          h[k + 0] = ex2(d * a2[k + 0]) * h[k + 0] + du * b4.x;
          h[k + 1] = ex2(d * a2[k + 1]) * h[k + 1] + du * b4.y;
          h[k + 2] = ex2(d * a2[k + 2]) * h[k + 2] + du * b4.z;
          h[k + 3] = ex2(d * a2[k + 3]) * h[k + 3] + du * b4.w;
          acc0 = fmaf(h[k + 0], c4.x, acc0);
          acc1 = fmaf(h[k + 1], c4.y, acc1);
          acc0 = fmaf(h[k + 2], c4.z, acc0);
          acc1 = fmaf(h[k + 3], c4.w, acc1);
        }
        if (active) y[(row + t0 + c) * di + ch] = acc0 + acc1;
      }
    }
  }
  if (active) {
    float* hf = h_final + ((size_t)blockIdx.y * di + ch) * n;
    if (EXACT) {
#pragma unroll
      for (int k = 0; k < N; k += 4)
        *reinterpret_cast<float4*>(hf + k) =
            make_float4(h[k], h[k + 1], h[k + 2], h[k + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (k < n) hf[k] = h[k];
    }
  }
}

// n above 64: one thread a (batch, channel) recurrence as above, its n
// states in its row of h_final (global memory; L1 and L2 hold them) and
// B_t, C_t read from global memory (the same for every thread of a
// batch row, so cached). Same arithmetic, state by state in order.
template <typename TX, typename TU>
__global__ void __launch_bounds__(kThreads)
selective_scan_wide_kernel(const TX* __restrict__ dt,
                           const TX* __restrict__ bm,
                           const TX* __restrict__ cm,
                           const TU* __restrict__ u,
                           const float* __restrict__ a_mat,
                           float* __restrict__ y, float* __restrict__ h_final,
                           int s, int di, int n) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= di) return;
  const size_t row = (size_t)blockIdx.y * s;
  float* h = h_final + ((size_t)blockIdx.y * di + ch) * n;
  const float* a = a_mat + (size_t)ch * n;
  for (int k = 0; k < n; ++k) h[k] = 0.f;
  for (int t = 0; t < s; ++t) {
    const size_t o = (row + t) * di + ch;
    const float d = to_f32(dt[o]);
    const float du = d * to_f32(u[o]);
    const TX* bt = bm + (row + t) * n;
    const TX* ct = cm + (row + t) * n;
    float acc0 = 0.f, acc1 = 0.f;
    for (int k = 0; k < n; ++k) {
      const float hk =
          ex2(d * (a[k] * kLog2e)) * h[k] + du * to_f32(bt[k]);
      h[k] = hk;
      if (k & 1)
        acc1 = fmaf(hk, to_f32(ct[k]), acc1);
      else
        acc0 = fmaf(hk, to_f32(ct[k]), acc0);
    }
    y[o] = acc0 + acc1;
  }
}

template <typename TX, typename TU, int N, bool EXACT>
cudaError_t launch(const void* dt, const void* bm, const void* cm,
                   const void* u, const void* a, void* y, void* h_final,
                   void* h_chk, int b, int s, int di, int n,
                   cudaStream_t stream) {
  dim3 grid((di + kThreads - 1) / kThreads, b);
  const TX *pdt = static_cast<const TX*>(dt),
           *pbm = static_cast<const TX*>(bm),
           *pcm = static_cast<const TX*>(cm);
  const TU* pu = static_cast<const TU*>(u);
  const float* pa = static_cast<const float*>(a);
  float *py = static_cast<float*>(y), *ph = static_cast<float*>(h_final),
        *pc = static_cast<float*>(h_chk);
  // checkpoints only under grad, where n <= 16 (N <= 32)
  if constexpr (N <= 32) {
    if (pc != nullptr) {
      selective_scan_kernel<TX, TU, N, EXACT, true>
          <<<grid, kThreads, 0, stream>>>(pdt, pbm, pcm, pu, pa, py, ph, pc,
                                          s, di, n);
      return cudaGetLastError();
    }
  }
  selective_scan_kernel<TX, TU, N, EXACT, false>
      <<<grid, kThreads, 0, stream>>>(pdt, pbm, pcm, pu, pa, py, ph, pc, s,
                                      di, n);
  return cudaGetLastError();
}

template <typename TX, typename TU>
cudaError_t by_state(const void* dt, const void* bm, const void* cm,
                     const void* u, const void* a, void* y, void* h_final,
                     void* h_chk, int b, int s, int di, int n,
                     cudaStream_t stream) {
  switch (n) {
    case 4:
      return launch<TX, TU, 4, true>(dt, bm, cm, u, a, y, h_final,
                                     h_chk, b, s, di, n, stream);
    case 8:
      return launch<TX, TU, 8, true>(dt, bm, cm, u, a, y, h_final,
                                     h_chk, b, s, di, n, stream);
    case 16:
      return launch<TX, TU, 16, true>(dt, bm, cm, u, a, y, h_final,
                                      h_chk, b, s, di, n, stream);
    default:
      break;
  }
  if (n <= 32)
    return launch<TX, TU, 32, false>(dt, bm, cm, u, a, y, h_final,
                                     h_chk, b, s, di, n, stream);
  if (n <= 64)
    return launch<TX, TU, 64, false>(dt, bm, cm, u, a, y, h_final,
                                     h_chk, b, s, di, n, stream);
  dim3 grid((di + kThreads - 1) / kThreads, b);
  selective_scan_wide_kernel<TX, TU><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(dt), static_cast<const TX*>(bm),
      static_cast<const TX*>(cm), static_cast<const TU*>(u),
      static_cast<const float*>(a), static_cast<float*>(y),
      static_cast<float*>(h_final), s, di, n);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t by_u(const void* dt, const void* bm, const void* cm,
                 const void* u, const void* a, void* y, void* h_final,
                 void* h_chk, int b, int s, int di, int n, int u_dtype,
                 cudaStream_t stream) {
  if (u_dtype == 0)
    return by_state<TX, float>(dt, bm, cm, u, a, y, h_final, h_chk, b, s,
                               di, n, stream);
  if (u_dtype == 1)
    return by_state<TX, __nv_bfloat16>(dt, bm, cm, u, a, y, h_final, h_chk,
                                       b, s, di, n, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x_dtype (dt, B, C alike) and u_dtype: 0 = float32, 1 = bfloat16; A is
// float32. dt, u (b, s, di), B, C (b, s, n), A (di, n), y (b, s, di),
// h_final (b, di, n), all contiguous; any n >= 1. h_chk: null, or (under
// grad; n <= 16) the backward's checkpoints, (b, ceil(s / 4), n, di)
// f32. Returns the launch's cudaError_t.
extern "C" int repro_selective_scan(const void* dt, const void* bm,
                                    const void* cm, const void* u,
                                    const void* a, void* y, void* h_final,
                                    void* h_chk, int b, int s, int di, int n,
                                    int x_dtype, int u_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || s <= 0 || di <= 0 || n <= 0 || b > 65535 ||
      (h_chk != nullptr && n > 16))
    return cudaErrorInvalidValue;
  if (x_dtype == 0)
    return by_u<float>(dt, bm, cm, u, a, y, h_final, h_chk, b, s, di, n,
                       u_dtype, st);
  if (x_dtype == 1)
    return by_u<__nv_bfloat16>(dt, bm, cm, u, a, y, h_final, h_chk, b, s,
                               di, n, u_dtype, st);
  return cudaErrorInvalidValue;
}
