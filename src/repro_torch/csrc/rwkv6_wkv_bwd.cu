// RWKV-6 WKV recurrence, backward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rwkv6_wkv.py::rwkv6_wkv, its gradient. The
// TPU has no backward kernel: the JAX package differentiates its plain
// recurrence (src/repro/models/rwkv.py::wkv_scan, a `lax.scan`). The
// plain counterpart here is autograd through kernels/ref.py::rwkv6_ref.
//
// For each (batch, head) pair of r, k, v, w (b, h, s, dh), bonus u (h,
// dh), from S_0 = 0 (S[j, i]: key row j, value column i):
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
// and the cotangents dy (b, h, s, dh) and dS (b, h, dh, dh) of y and of
// S_s, G_t = dL/dS_t is carried back from G_s = dS with
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,
// and with vdy_t = v_t . dy_t, beta_t = sum_j r_t[j] u[j] k_t[j]:
//   dr_t = S_{t-1} dy_t + u o k_t vdy_t
//   dk_t = G_t v_t + u o r_t vdy_t
//   dv_t = G_t^T k_t + beta_t dy_t
//   dw_t = rowsum(G_t o S_{t-1})
//   du   = sum over b and t of r_t o k_t vdy_t.
// dw needs S_{t-1} on the way back. The forward kernel (rwkv6_wkv.cu),
// under grad, writes S before every 8th step (recurrence_bwd.cuh); this
// kernel recomputes the states of a chunk of 8 from it, never dividing
// by w (a decay near 0 would blow the division up; a product of decays
// underflows f32 in a chunked form).
//
// What bounds it on this card: at rwkv6-7b's shape (4, 64, 511, 64) in
// f32 it reads r, k, v, w, dy and writes dr, dk, dv, dw (each 33.5 MB)
// and reads dS: 305.6 MB, 0.091 ms at 3.35 TB/s; it does ~12 dh^2 flops
// a (pair, step) (the recomputed update, the G update, four products
// with a vector), 6.4 GFLOP, 0.096 ms at 67 TFLOP/s of f32 FMAs: the
// operations bound it.
//
// The design, the simple one (speed is later work): one block a pair,
// DH * DH / 8 threads at a compiled width DH (32 or 64; any dh up to 64
// runs in the next wider one with the rows and columns past dh zero).
// Thread (j, cg) holds row j of S and G at the 8 value columns
// [8 cg, 8 cg + 8); the DH / 8 threads of a row are neighbouring lanes.
// The chunks are walked last to first. A chunk's r, k, w, v and dy are
// staged in shared memory, with vdy_t and beta_t (a warp's dot products);
// then its two halves of 4 steps, last first: the states of the half are
// recomputed from the chunk's checkpoint into registers (the second
// half's first 4 steps again without keeping them: 12 state updates for
// 8 steps, and 32 registers of history instead of 64) and walked back.
// A step's sums over the columns (dr, dk, dw) are a thread's 8 terms
// and a shuffle tree over the row's lanes; dv's sum over the rows is a
// halving butterfly over the warp's rows, each warp's sums put in shared
// memory and added over the warps in a fixed order once a chunk. du's
// sum over t is a thread's register, its sum over the batch a second
// pass over per-pair partials (no atomics: two runs give the same bits).
// Head dims above 64 are refused (no config has them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence_bwd.cuh"

namespace {

using recurrence::halve_sum;
using recurrence::halved_first;

constexpr int kCk = recurrence::kWkvCheckpoint;  // steps a chunk
constexpr int kHalf = kCk / 2;                   // steps a walked half
constexpr int kEl = 8;                           // value columns a thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int DH>
struct Bwd {
  static constexpr int kCg = DH / kEl;     // lanes of a row
  static constexpr int kNt = DH * kCg;     // threads
  static constexpr int kNw = kNt / 32;     // warps
  static constexpr int kRw = 32 / kCg;     // rows a warp
  static constexpr int kNv = kEl / kRw;    // dv sums a lane ends with
  static_assert(kNt % 32 == 0 && kRw <= kEl && kNv >= 1, "tile");
};

// grid: (b * h); block: Bwd<DH>::kNt threads. EXACT: dh == DH.
template <typename T, int DH, bool EXACT>
__global__ void __launch_bounds__(Bwd<DH>::kNt)
rwkv6_wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ s_chk,
                     const float* __restrict__ dy,
                     const float* __restrict__ ds, float* __restrict__ dr,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_part,
                     int h, int s, int dh_arg) {
  using B = Bwd<DH>;
  constexpr int CG = B::kCg, NT = B::kNt, NW = B::kNw, NV = B::kNv;
  const int dh = EXACT ? DH : dh_arg;
  // a chunk's r, k, w, v, dy (zero past dh and past s)
  __shared__ __align__(16) float xs[5][kCk][DH];
  __shared__ float vdy[kCk], beta[kCk];
  // dv's sums over each warp's rows, a step and column
  __shared__ __align__(16) float dvp[kCk][NW][DH];
  __shared__ float us[DH];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid % CG, j = tid / CG, i0 = cg * kEl;
  const int pair = blockIdx.x;
  const size_t base = (size_t)pair * s * dh;
  const int nck = (s + kCk - 1) / kCk;
  const bool row_in = j < dh;
  for (int e = tid; e < DH; e += NT)
    us[e] = e < dh ? u[(size_t)(pair % h) * dh + e] : 0.f;
  const float uj = row_in ? u[(size_t)(pair % h) * dh + j] : 0.f;

  // G at this thread's row and columns, from dS
  float g[kEl];
  const float* dsp = ds + (size_t)pair * dh * dh + (size_t)j * dh;
#pragma unroll
  for (int e = 0; e < kEl; ++e)
    g[e] = row_in && i0 + e < dh ? dsp[i0 + e] : 0.f;
  float du_acc = 0.f;
  // the dv sums a lane holds after the butterfly: columns i0 + first + q
  const int first = halved_first<kEl, 16, CG>(lane);

  // the state update of staged step c, on this thread's row and columns
  auto advance = [&](float (&st)[kEl], int c) {
    const float wj = xs[2][c][j], kj = xs[1][c][j];
#pragma unroll
    for (int e = 0; e < kEl; ++e)
      st[e] = fmaf(wj, st[e], kj * xs[3][c][i0 + e]);
  };

  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kCk;
    const int n = min(kCk, s - t0);
    for (int e = tid; e < 5 * kCk * DH; e += NT) {
      const int q = e / (kCk * DH), cc = (e / DH) % kCk, jj = e % DH;
      float val = 0.f;
      if (jj < dh && cc < n) {
        const size_t o = base + (size_t)(t0 + cc) * dh + jj;
        val = q == 0   ? to_f32(r[o])
              : q == 1 ? to_f32(k[o])
              : q == 2 ? to_f32(w[o])
              : q == 3 ? to_f32(v[o])
                       : dy[o];
      }
      xs[q][cc][jj] = val;
    }
    __syncthreads();
    for (int cc = warp; cc < kCk; cc += NW) {
      float a = 0.f, bt = 0.f;
      for (int jj = lane; jj < DH; jj += 32) {
        a = fmaf(xs[3][cc][jj], xs[4][cc][jj], a);
        bt = fmaf(xs[0][cc][jj] * us[jj], xs[1][cc][jj], bt);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        bt += __shfl_xor_sync(0xffffffffu, bt, off);
      }
      if (lane == 0) {
        vdy[cc] = a;
        beta[cc] = bt;
      }
    }
    __syncthreads();

    const float* sc = s_chk + ((size_t)pair * nck + c) * dh * dh
                      + (size_t)j * dh;
    for (int half = kCk / kHalf - 1; half >= 0; --half) {
      const int c0 = half * kHalf;
      if (c0 >= n) continue;  // the same for every thread
      float st[kEl];
#pragma unroll
      for (int e = 0; e < kEl; ++e)
        st[e] = row_in && i0 + e < dh ? sc[i0 + e] : 0.f;
      for (int cc = 0; cc < c0; ++cc) advance(st, cc);
      float hist[kHalf][kEl];  // S before each step of the half
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
#pragma unroll
        for (int e = 0; e < kEl; ++e) hist[q][e] = st[e];
        if (c0 + q < n) advance(st, c0 + q);
      }
#pragma unroll
      for (int q = kHalf - 1; q >= 0; --q) {
        const int cc = c0 + q;
        if (cc >= n) continue;  // the same for every thread
        const float rj = xs[0][cc][j], kj = xs[1][cc][j],
                    wj = xs[2][cc][j];
        float pr = 0.f, pk = 0.f, pw = 0.f, pv[kEl];
#pragma unroll
        for (int e = 0; e < kEl; ++e) {
          const float vi = xs[3][cc][i0 + e], yi = xs[4][cc][i0 + e];
          pr = fmaf(hist[q][e], yi, pr);
          pk = fmaf(g[e], vi, pk);
          pw = fmaf(g[e], hist[q][e], pw);
          pv[e] = g[e] * kj;
          g[e] = fmaf(wj, g[e], rj * yi);  // G_{t-1}
        }
#pragma unroll
        for (int off = CG / 2; off > 0; off /= 2) {
          pr += __shfl_xor_sync(0xffffffffu, pr, off);
          pk += __shfl_xor_sync(0xffffffffu, pk, off);
          pw += __shfl_xor_sync(0xffffffffu, pw, off);
        }
        if (cg == 0 && row_in) {
          const size_t o = base + (size_t)(t0 + cc) * dh + j;
          dr[o] = fmaf(uj * kj, vdy[cc], pr);
          dk[o] = fmaf(uj * rj, vdy[cc], pk);
          dw[o] = pw;
          du_acc = fmaf(rj * kj, vdy[cc], du_acc);
        }
        halve_sum<kEl, 16, CG>(pv, lane);
#pragma unroll
        for (int qq = 0; qq < NV; ++qq)
          dvp[cc][warp][i0 + first + qq] = pv[qq];
      }
    }
    __syncthreads();
    for (int e = tid; e < n * DH; e += NT) {
      const int cc = e / DH, i = e % DH;
      float acc = 0.f;
#pragma unroll 4
      for (int wi = 0; wi < NW; ++wi) acc += dvp[cc][wi][i];
      if (i < dh)
        dv[base + (size_t)(t0 + cc) * dh + i] =
            fmaf(beta[cc], xs[4][cc][i], acc);
    }
    __syncthreads();  // before the next chunk is staged over these
  }
  if (cg == 0 && row_in) du_part[(size_t)pair * dh + j] = du_acc;
}

template <typename T, int DH, bool EXACT>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s_chk,
                   const void* dy, const void* ds, void* dr, void* dk,
                   void* dv, void* dw, void* du_part, int b, int h, int s,
                   int dh, cudaStream_t stream) {
  rwkv6_wkv_bwd_kernel<T, DH, EXACT>
      <<<(unsigned)(b * h), Bwd<DH>::kNt, 0, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(w),
          static_cast<const float*>(u), static_cast<const float*>(s_chk),
          static_cast<const float*>(dy), static_cast<const float*>(ds),
          static_cast<float*>(dr), static_cast<float*>(dk),
          static_cast<float*>(dv), static_cast<float*>(dw),
          static_cast<float*>(du_part), h, s, dh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s_chk,
                     const void* dy, const void* ds, void* dr, void* dk,
                     void* dv, void* dw, void* du_part, int b, int h, int s,
                     int dh, cudaStream_t st) {
  if (dh == 32)
    return launch<T, 32, true>(r, k, v, w, u, s_chk, dy, ds, dr, dk, dv,
                               dw, du_part, b, h, s, dh, st);
  if (dh == 64)
    return launch<T, 64, true>(r, k, v, w, u, s_chk, dy, ds, dr, dk, dv,
                               dw, du_part, b, h, s, dh, st);
  if (dh < 32)
    return launch<T, 32, false>(r, k, v, w, u, s_chk, dy, ds, dr, dk, dv,
                                dw, du_part, b, h, s, dh, st);
  return launch<T, 64, false>(r, k, v, w, u, s_chk, dy, ds, dr, dk, dv, dw,
                              du_part, b, h, s, dh, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w alike); u, s_chk (the
// forward's checkpoints, (b, h, ceil(s / 8), dh, dh)), dy, ds and every
// output float32. dr, dk, dv, dw (b, h, s, dh); du_part (b, h, dh)
// scratch; du (h, dh), the sum of du_part over the batch. 1 <= dh <= 64.
// Returns the first failed launch's cudaError_t.
extern "C" int repro_rwkv6_wkv_bwd(const void* r, const void* k,
                                   const void* v, const void* w,
                                   const void* u, const void* s_chk,
                                   const void* dy, const void* ds, void* dr,
                                   void* dk, void* dv, void* dw,
                                   void* du_part, void* du, int b, int h,
                                   int s, int dh, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || h <= 0 || s <= 0 || dh <= 0 || dh > 64 ||
      (int64_t)b * h > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = dispatch<float>(r, k, v, w, u, s_chk, dy, ds, dr, dk, dv, dw,
                          du_part, b, h, s, dh, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(r, k, v, w, u, s_chk, dy, ds, dr, dk, dv,
                                  dw, du_part, b, h, s, dh, st);
  if (err != cudaSuccess) return err;
  return recurrence::sum_parts(static_cast<const float*>(du_part),
                               static_cast<float*>(du), b,
                               (int64_t)h * dh, st);
}
