// Mamba S6 selective scan, backward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/selective_scan.py::selective_scan, its
// gradient. The TPU has no backward kernel: the JAX package
// differentiates its plain scan (src/repro/models/mamba.py::ssm_scan).
// The plain counterpart here is autograd through
// kernels/ref.py::selective_scan_ref.
//
// For each batch row b and channel d of dt, u (b, s, di), B, C (b, s, n)
// and A (di, n), from h_0 = 0, with a_t = exp(dt_t A) (the forward's
// decay, ex2 of dt_t * round(A log2 e)):
//   h_t = a_t o h_{t-1} + dt_t u_t B_t,   y_t = h_t . C_t,
// and the cotangents dy (b, s, di) and dh (b, di, n) of y and of h_s,
// G_t = dL/dh_t = a_{t+1} o G_{t+1} + dy_t C_t is carried back from
// G_s = dh + dy_s C_s, and
//   d(dt)_t = sum_k G_t[k] (A[k] a_t[k] h_{t-1}[k] + u_t B_t[k])
//   du_t    = dt_t sum_k G_t[k] B_t[k]
//   dB_t[k] = sum over d of G_t[k] dt_t u_t
//   dC_t[k] = sum over d of dy_t h_t[k]
//   dA[d,k] = sum over b and t of G_t[k] dt_t a_t[k] h_{t-1}[k].
// h_{t-1} is needed on the way back. The forward kernel
// (selective_scan.cu), under grad, writes h before every 4th step
// (recurrence_bwd.cuh); this kernel recomputes a group of 4 steps from
// it, never dividing by a decay (which underflows to 0 at large dt |A|).
//
// What bounds it on this card: at jamba's training shape (dt/u (4, 512,
// 16384), B/C (4, 512, 16), A (16384, 16)) in f32 it reads dt, u, dy
// (134.2 MB each), B, C, A and dh and writes d(dt), du (134.2 MB each),
// dB, dC and dA: 677 MB, 0.202 ms at 3.35 TB/s, above its 2 b s di n
// exponentials (the recomputed and the walked decay) on the
// special-function units (~0.26 ms at 16 a clock an SM and 1.98 GHz: the
// forward's floor twice).
//
// The design, the simple one (speed is later work): a thread a (batch,
// channel) recurrence as in the forward, its n states (4, 8 or 16 in
// registers; any n up to 16 runs at 16 with the states past n masked),
// its row of A, G and its dA sums in registers; 128 channels of one
// batch row a block. Steps are staged 16 at a time, last first (B_t and
// C_t, the same for every channel, in shared memory); each group of 4
// steps, last first, is recomputed from its checkpoint into registers
// (5 states of n) and walked back. dB and dC are sums over the 16,384
// channels: a step's 2n terms of a thread go through a halving
// butterfly over the warp (each lane ends with one whole warp sum), the
// warps' sums are added in shared memory in a fixed order once per 16
// steps into a per-block partial, and a second pass adds the blocks'
// partials in order; dA's sum over the batch rows is a second pass over
// per-row partials too. No float atomics: two runs give the same bits.
// State dims above 16 are refused (no config has them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence_bwd.cuh"

namespace {

using recurrence::add_lanes;
using recurrence::halve_sum;

constexpr int kThreads = 128;  // channels of one batch row a block
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 16;     // steps staged at once
constexpr int kCk = recurrence::kScanCheckpoint;  // steps a recomputed group
constexpr float kLog2e = 1.44269504088896341f;
static_assert(kStage % kCk == 0, "whole groups in a stage");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// grid: (ceil(di / 128), b). EXACT: n == N; otherwise n < N = 16 and the
// states n..15 are masked (A, B, C, dh zero: they stay 0 and add
// nothing).
template <typename TX, typename TU, int N, bool EXACT>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const TX* __restrict__ dt,
                          const TX* __restrict__ bm,
                          const TX* __restrict__ cm,
                          const TU* __restrict__ u,
                          const float* __restrict__ a_mat,
                          const float* __restrict__ h_chk,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh_final,
                          float* __restrict__ ddt, float* __restrict__ d_u,
                          float* __restrict__ dbc_part,
                          float* __restrict__ da_part, int s, int di,
                          int n_arg) {
  constexpr int NV = 2 * N;       // a step's dB and dC terms of a thread
  constexpr int R = 32 / NV > 1 ? 32 / NV : 1;  // lanes holding one sum
  static_assert(NV <= 32, "a warp's lanes hold the step's 2n sums");
  __shared__ __align__(16) float sb[kStage][N];
  __shared__ __align__(16) float sc[kStage][N];
  // each warp's sums of a step: dB[0..N), dC[N..2N)
  __shared__ float part[kStage][kWarps][NV];

  const int n = EXACT ? N : n_arg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool active = ch < di;
  const int bi = blockIdx.y, nb = gridDim.y;
  const size_t row = (size_t)bi * s;  // (batch, t = 0)
  const int nck = (s + kCk - 1) / kCk;

  float a2[N], am[N], gf[N], da[N];
  const size_t hrow = ((size_t)bi * di + ch) * n;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const bool in = active && (EXACT || k < n);
    am[k] = in ? a_mat[(size_t)ch * n + k] : 0.f;
    a2[k] = am[k] * kLog2e;  // as the forward rounds it
    gf[k] = in ? dh_final[hrow + k] : 0.f;  // dL/dh_t from later steps
    da[k] = 0.f;
  }

  for (int t0 = ((s - 1) / kStage) * kStage; t0 >= 0; t0 -= kStage) {
    const int steps = min(kStage, s - t0);
    for (int e = threadIdx.x; e < kStage * N; e += kThreads) {
      const int c = e / N, k = e % N;
      const bool in = c < steps && (EXACT || k < n);
      const size_t o = (row + t0 + c) * n + k;
      sb[c][k] = in ? to_f32(bm[o]) : 0.f;
      sc[c][k] = in ? to_f32(cm[o]) : 0.f;
    }
    __syncthreads();
    for (int c0 = ((steps - 1) / kCk) * kCk; c0 >= 0; c0 -= kCk) {
      float pdt[kCk], pu[kCk], pdy[kCk];
#pragma unroll
      for (int q = 0; q < kCk; ++q) {
        const bool in = active && c0 + q < steps;
        const size_t o = (row + t0 + c0 + q) * di + ch;
        pdt[q] = in ? to_f32(dt[o]) : 0.f;
        pu[q] = in ? to_f32(u[o]) : 0.f;
        pdy[q] = in ? dy[o] : 0.f;
      }
      // hist[q]: h before step c0 + q; hist[kCk]: after the group
      float hist[kCk + 1][N];
      const float* hc = h_chk + (((size_t)bi * nck + (t0 + c0) / kCk) * di
                                 + ch) * n;
#pragma unroll
      for (int k = 0; k < N; ++k)
        hist[0][k] = active && (EXACT || k < n) ? hc[k] : 0.f;
#pragma unroll
      for (int q = 0; q < kCk; ++q) {
        const float d = pdt[q], du = d * pu[q];
#pragma unroll
        for (int k = 0; k < N; ++k)
          hist[q + 1][k] = ex2(d * a2[k]) * hist[q][k] + du * sb[c0 + q][k];
      }
#pragma unroll
      for (int q = kCk - 1; q >= 0; --q) {
        const int c = c0 + q;
        if (c >= steps) continue;  // the same for every thread
        const float d = pdt[q], uu = pu[q], yy = pdy[q], du = d * uu;
        float v[NV];
        float sdt = 0.f, sdu = 0.f;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float bk = sb[c][k], ck = sc[c][k];
          const float a = ex2(d * a2[k]);
          const float hp = hist[q][k];
          const float g = fmaf(yy, ck, gf[k]);  // G_t
          v[k] = g * du;
          v[N + k] = yy * hist[q + 1][k];
          sdu = fmaf(g, bk, sdu);
          sdt = fmaf(g, fmaf(am[k] * a, hp, uu * bk), sdt);
          da[k] = fmaf(g * d, a * hp, da[k]);
          gf[k] = a * g;
        }
        if (active) {
          const size_t o = (row + t0 + c) * di + ch;
          ddt[o] = sdt;
          d_u[o] = sdu * d;
        }
        halve_sum<NV, 16, R>(v, lane);
        add_lanes<R / 2>(v[0]);
        if ((lane & (R - 1)) == 0) part[c][warp][lane / R] = v[0];
      }
    }
    __syncthreads();
    // this block's sums over its channels: (2, b, s, n) of the block
    for (int e = threadIdx.x; e < steps * NV; e += kThreads) {
      const int c = e / NV, idx = e % NV, which = idx / N, k = idx % N;
      float acc = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) acc += part[c][wi][idx];
      if (EXACT || k < n)
        dbc_part[((((size_t)blockIdx.x * 2 + which) * nb + bi) * s + t0 + c)
                     * n + k] = acc;
    }
    __syncthreads();  // before the next stage is written over these
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (EXACT || k < n) da_part[hrow + k] = da[k];
  }
}

template <typename TX, typename TU, int N, bool EXACT>
cudaError_t launch(const void* dt, const void* bm, const void* cm,
                   const void* u, const void* a, const void* h_chk,
                   const void* dy, const void* dh, void* ddt, void* d_u,
                   void* dbc_part, void* da_part, int b, int s, int di,
                   int n, cudaStream_t stream) {
  dim3 grid((di + kThreads - 1) / kThreads, b);
  selective_scan_bwd_kernel<TX, TU, N, EXACT>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const TX*>(dt), static_cast<const TX*>(bm),
          static_cast<const TX*>(cm), static_cast<const TU*>(u),
          static_cast<const float*>(a), static_cast<const float*>(h_chk),
          static_cast<const float*>(dy), static_cast<const float*>(dh),
          static_cast<float*>(ddt), static_cast<float*>(d_u),
          static_cast<float*>(dbc_part), static_cast<float*>(da_part), s,
          di, n);
  return cudaGetLastError();
}

template <typename TX, typename TU>
cudaError_t by_state(const void* dt, const void* bm, const void* cm,
                     const void* u, const void* a, const void* h_chk,
                     const void* dy, const void* dh, void* ddt, void* d_u,
                     void* dbc_part, void* da_part, int b, int s, int di,
                     int n, cudaStream_t st) {
  if (n == 4)
    return launch<TX, TU, 4, true>(dt, bm, cm, u, a, h_chk, dy, dh, ddt,
                                   d_u, dbc_part, da_part, b, s, di, n, st);
  if (n == 8)
    return launch<TX, TU, 8, true>(dt, bm, cm, u, a, h_chk, dy, dh, ddt,
                                   d_u, dbc_part, da_part, b, s, di, n, st);
  if (n == 16)
    return launch<TX, TU, 16, true>(dt, bm, cm, u, a, h_chk, dy, dh, ddt,
                                    d_u, dbc_part, da_part, b, s, di, n, st);
  return launch<TX, TU, 16, false>(dt, bm, cm, u, a, h_chk, dy, dh, ddt,
                                   d_u, dbc_part, da_part, b, s, di, n, st);
}

template <typename TX>
cudaError_t by_u(const void* dt, const void* bm, const void* cm,
                 const void* u, const void* a, const void* h_chk,
                 const void* dy, const void* dh, void* ddt, void* d_u,
                 void* dbc_part, void* da_part, int b, int s, int di, int n,
                 int u_dtype, cudaStream_t st) {
  if (u_dtype == 0)
    return by_state<TX, float>(dt, bm, cm, u, a, h_chk, dy, dh, ddt, d_u,
                               dbc_part, da_part, b, s, di, n, st);
  if (u_dtype == 1)
    return by_state<TX, __nv_bfloat16>(dt, bm, cm, u, a, h_chk, dy, dh, ddt,
                                       d_u, dbc_part, da_part, b, s, di, n,
                                       st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x_dtype (dt, B, C alike) and u_dtype: 0 = float32, 1 = bfloat16; A,
// h_chk (the forward's checkpoints, (b, ceil(s / 4), di, n)), dy (b, s,
// di), dh (b, di, n) and every output float32. ddt, du (b, s, di);
// dbc_part (ceil(di / 128), 2, b, s, n) and da_part (b, di, n) scratch;
// dbc (2, b, s, n): dB then dC, the sums of dbc_part over the channel
// blocks; da (di, n), the sum of da_part over the batch. 1 <= n <= 16.
// Returns the first failed launch's cudaError_t.
extern "C" int repro_selective_scan_bwd(
    const void* dt, const void* bm, const void* cm, const void* u,
    const void* a, const void* h_chk, const void* dy, const void* dh,
    void* ddt, void* d_u, void* dbc_part, void* da_part, void* dbc,
    void* da, int b, int s, int di, int n, int x_dtype, int u_dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || s <= 0 || di <= 0 || n <= 0 || n > 16 || b > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == 0)
    err = by_u<float>(dt, bm, cm, u, a, h_chk, dy, dh, ddt, d_u, dbc_part,
                      da_part, b, s, di, n, u_dtype, st);
  else if (x_dtype == 1)
    err = by_u<__nv_bfloat16>(dt, bm, cm, u, a, h_chk, dy, dh, ddt, d_u,
                              dbc_part, da_part, b, s, di, n, u_dtype, st);
  if (err != cudaSuccess) return err;
  const int nblk = (di + kThreads - 1) / kThreads;
  err = recurrence::sum_parts(static_cast<const float*>(dbc_part),
                              static_cast<float*>(dbc), nblk,
                              (int64_t)2 * b * s * n, st);
  if (err != cudaSuccess) return err;
  return recurrence::sum_parts(static_cast<const float*>(da_part),
                               static_cast<float*>(da), b, (int64_t)di * n,
                               st);
}
