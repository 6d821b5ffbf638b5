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
// (recurrence_bwd.cuh), state-major (b, ceil(s / 4), n, di); this
// kernel recomputes a group of 4 steps from it, never dividing by a
// decay (which underflows to 0 at large dt |A|).
//
// What bounds it on this card: at jamba's training shape (dt/u (4, 512,
// 16384), B/C (4, 512, 16), A (16384, 16)) in f32 it reads dt, u, dy
// (134.2 MB each), B, C, A and dh and writes d(dt), du (134.2 MB each),
// dB, dC and dA: 677 MB, 0.202 ms at 3.35 TB/s. It also reads the
// forward's checkpoints, 537 MB, so this design's own byte floor is
// 1,215 MB, ~0.36 ms. Its exponentials (7 for 4 steps of a state, below)
// are ~0.22 ms on the special-function units at 16 a clock an SM and
// 1.98 GHz.
//
// The first design (a thread a (batch, channel) with all 16
// states, 128-thread blocks) needed 255 registers a thread, 8 warps an
// SM; it summed dB and dC with a 31-shuffle butterfly a step (two
// selects a shuffle), loaded each group's dt, u, dy and checkpoint when
// the group began, and the forward wrote the checkpoints a thread's 16
// states at a time, so each store of a warp touched 32 sectors.
//
// The design: a thread a (batch, channel) with its n states, 128
// channels of one batch row a block, two blocks (8 warps) an SM: at up
// to 255 registers (ptxas gives ~220) nothing spills, and the 512
// blocks of jamba's shape run in two even waves. A thread keeps its row
// of A (pre-scaled by log2 e, as the forward rounds it), G, its dA sums
// and a group's states in registers. Groups of 4 steps are walked last
// to first: the group's h is recomputed from its checkpoint (h after
// the group's last step is the later group's checkpoint, so 3 updates
// for 4 steps; at the sequence's end 4), then walked back; a_t G_t is
// carried, so the dA and d(dt) terms take one product more, not two.
// d(dt) and du are sums over the thread's own states (the even and the
// odd states apart; d(dt)'s A term is log2-scaled A times ln 2). dB and
// dC are sums over the 16,384 channels: each thread writes its step's
// 2n terms into a row of its warp's stash in shared memory, and lane o
// adds column o over the warp's 32 channels (the even and the odd rows
// apart): 2n loads and adds a lane where a shuffle butterfly takes
// 2n - 1 shuffles, their selects and adds. The block's 4 warps' sums are
// added in a fixed order once per 16 steps into a per-block partial, and
// a second pass adds the blocks' partials in order; dA's sum over the
// batch rows is a second pass over per-row partials too. No float
// atomics: two runs give the same bits. A group's dt, u, dy and
// checkpoint states (state-major: 128 contiguous bytes a warp and
// state) are copied into shared-memory slots with `cp.async` while the
// group before it is walked: each warp copies its own channels, 16
// bytes a copy (f32 with di a multiple of 4; otherwise one value at a
// time, bf16 loaded and stored), into three slot buffers in turn, so
// the later group's checkpoint, h after this group, is still there. B
// and C of 16 steps, the same for every channel, are staged for the
// block.
//
// Measured no faster while this design was built (throwaway variants,
// not kept): a channel's states split over two lanes (8 each, 16 warps
// an SM) with a shuffle butterfly for dB and dC; two channels a lane
// pair, each lane half their states, dB and dC added over the two
// channels before a stash of half the rows; three blocks an SM (the
// registers then spill, and 512 blocks fill 1.3 waves); the recompute's
// decays kept in shared memory for the walk; the stash summed one step
// late from three stashes in turn; 16-byte column loads with the du and
// dy weights applied by the summing lane. Leaving the checkpoint or the
// dt, u, dy loads out changed nothing: the bytes do not bound it.
//
// State dims up to 16 run at a compiled 4, 8 or 16 (others at 16 with
// the states past n masked: A, B, C, dh zero). State dims above 16 are
// refused (no config has them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "recurrence_bwd.cuh"

namespace {

constexpr int kThreads = 128;  // channels of one batch row a block
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 16;                   // steps of B, C staged at once
constexpr int kCk = recurrence::kScanCheckpoint;  // steps a recomputed group
constexpr int kRow = 36;  // a stash row: 2n <= 32 values, padded for float4
constexpr float kLog2e = 1.44269504088896341f;
constexpr float kLn2 = 0.693147180559945309f;
static_assert(kStage % kCk == 0, "whole groups in a stage");

// A 4-byte asynchronous copy from device to shared memory (`cp.async`,
// through L1), or zeros where `full` is false (`gmem` must still be a
// valid address); a 16-byte one (around L1); a group's commit and the
// wait for all but the newest N groups.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(full ? 4 : 0)
               : "memory");
}

// the same, 16 bytes (both addresses 16-byte aligned)
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// one value into a thread's shared slot: an asynchronous copy for f32, a
// load and a store for bf16; zero where `in` is false (`src` valid)
template <typename T>
__device__ __forceinline__ void put(float* slot, const T* src, bool in) {
  if constexpr (std::is_same<T, float>::value)
    cp_async4(slot, src, in);
  else
    *slot = in ? to_f32(*src) : 0.f;
}

template <int N>
struct Scan {
  static constexpr int kSlot = 3 * kCk + N;  // a group's values a thread
  static constexpr int kBufs = 3;  // groups in flight: walked, next, last
  static constexpr int kLoads = (kStage * N + kThreads - 1) / kThreads;
  // shared memory, in floats: three groups' slots, B and C of a stage,
  // a warp's stash of a step's dB and dC terms, each warp's sums of a
  // stage's steps
  static constexpr int kFloats = kBufs * kSlot * kThreads + 2 * kStage * N
                                 + kWarps * 32 * kRow
                                 + kStage * kWarps * 2 * N;
};

// grid: (ceil(di / 128), b); block: 128 threads, Scan<N>::kFloats floats
// of dynamic shared memory. EXACT: n == N; otherwise n < N = 16 and the
// states n..15 are masked (A, B, C, dh zero: they stay 0 and add
// nothing).
template <typename TX, typename TU, int N, bool EXACT>
__global__ void __launch_bounds__(kThreads, 2)
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
  using S = Scan<N>;
  constexpr int SLOT = S::kSlot;
  static_assert(N % 4 == 0 && 2 * N <= 32, "a warp's lanes hold the sums");
  extern __shared__ __align__(16) float smem[];
  float* slots = smem;                             // [3][SLOT][kThreads]
  float* sb = slots + S::kBufs * SLOT * kThreads;  // [kStage][N]
  float* sc = sb + kStage * N;                     // [kStage][N]
  float* stash = sc + kStage * N;             // [kWarps][32][kRow]
  float* part = stash + kWarps * 32 * kRow;   // [kStage][kWarps][2N]

  const int n = EXACT ? N : n_arg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = blockIdx.x * kThreads + tid;
  const bool active = ch < di;
  const int bi = blockIdx.y, nb = gridDim.y;
  const size_t row = (size_t)bi * s;  // (batch, t = 0)
  const int nck = (s + kCk - 1) / kCk;

  float a2[N], gf[N], da[N];
  const size_t hrow = ((size_t)bi * di + ch) * n;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const bool in = active && (EXACT || k < n);
    a2[k] = in ? a_mat[(size_t)ch * n + k] * kLog2e : 0.f;
    gf[k] = in ? dh_final[hrow + k] : 0.f;  // dL/dh_t from later steps
    da[k] = 0.f;
  }

  // group gi's dt, u, dy (kCk steps each) and its checkpoint's states
  // (state-major: state k of the warp's 32 channels is 128 bytes) into
  // slot buffer gi % 3, [value][channel], as one committed copy group.
  // With f32 inputs and di a multiple of 4 each warp copies its own 32
  // channels' rows, 16 bytes a copy (3 + n / 4 copies a lane); otherwise
  // each thread copies its channel's values one at a time. Either way a
  // warp reads only what it copied (after its lanes' __syncwarp).
  const int wch = blockIdx.x * kThreads + warp * 32;  // the warp's first
  const bool vec =
      std::is_same<TX, float>::value && std::is_same<TU, float>::value &&
      di % 4 == 0 &&
      ((uintptr_t)dt | (uintptr_t)u | (uintptr_t)dy | (uintptr_t)h_chk) %
              16 == 0;
  auto fetch_group = [&](int gi) {
    const int t0 = gi * kCk;
    const size_t chk0 = ((size_t)bi * nck + gi) * n * di;
    if (vec) {
      float* sl = slots + (gi % S::kBufs) * SLOT * kThreads + warp * 32;
      const int q = lane / 8, c4 = (lane % 8) * 4;  // a row's 8 chunks
      const bool in = wch + c4 < di && t0 + q < s;
      const size_t o = in ? (row + t0 + q) * di + wch + c4 : 0;
      cp_async16(sl + q * kThreads + c4,
                             reinterpret_cast<const float*>(dt) + o, in);
      cp_async16(sl + (kCk + q) * kThreads + c4,
                             reinterpret_cast<const float*>(u) + o, in);
      cp_async16(sl + (2 * kCk + q) * kThreads + c4, dy + o, in);
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        const int k = q + 4 * i;
        const bool kin = wch + c4 < di && (EXACT || k < n);
        cp_async16(
            sl + (3 * kCk + k) * kThreads + c4,
            kin ? h_chk + chk0 + (size_t)k * di + wch + c4 : h_chk, kin);
      }
    } else {
      float* sl = slots + (gi % S::kBufs) * SLOT * kThreads + tid;
#pragma unroll
      for (int q = 0; q < kCk; ++q) {
        const bool in = active && t0 + q < s;
        const size_t o = in ? (row + t0 + q) * di + ch : 0;
        put(sl + q * kThreads, dt + o, in);
        put(sl + (kCk + q) * kThreads, u + o, in);
        put(sl + (2 * kCk + q) * kThreads, dy + o, in);
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const bool in = active && (EXACT || k < n);
        put(sl + (3 * kCk + k) * kThreads,
            in ? h_chk + chk0 + (size_t)k * di + ch : h_chk, in);
      }
    }
    cp_async_commit();
  };
  // B and C of the stage from t0, this thread's share, into registers
  float pb[S::kLoads], pc[S::kLoads];
  auto fetch_bc = [&](int t0) {
#pragma unroll
    for (int i = 0; i < S::kLoads; ++i) {
      const int e = tid + i * kThreads, c = e / N, k = e % N;
      const bool in = e < kStage * N && t0 + c < s && (EXACT || k < n);
      const size_t o = (row + t0 + c) * n + k;
      pb[i] = in ? to_f32(bm[o]) : 0.f;
      pc[i] = in ? to_f32(cm[o]) : 0.f;
    }
  };
  // The stash: a step's 2n terms of the warp's 32 channels, lane c's in
  // row c; lane o adds column o, the even and the odd rows apart.
  float* my_row = stash + (warp * 32 + lane) * kRow;
  const float* my_col = stash + warp * 32 * kRow + lane;

  const int last = ((s - 1) / kStage) * kStage;
  fetch_bc(last);
  fetch_group(nck - 1);
  for (int t0 = last; t0 >= 0; t0 -= kStage) {
    const int steps = min(kStage, s - t0);
    // sb / sc were last read before the previous stage's second barrier
#pragma unroll
    for (int i = 0; i < S::kLoads; ++i) {
      const int e = tid + i * kThreads;
      if (e < kStage * N) {
        sb[e] = pb[i];
        sc[e] = pc[i];
      }
    }
    if (t0 > 0) fetch_bc(t0 - kStage);
    __syncthreads();
    for (int c0 = ((steps - 1) / kCk) * kCk; c0 >= 0; c0 -= kCk) {
      const int gi = (t0 + c0) / kCk;
      // the group before this one is copied while this one is walked
      if (gi > 0)
        fetch_group(gi - 1);
      else
        cp_async_commit();  // an empty group keeps the count
      cp_async_wait<1>();
      __syncwarp();  // the lanes' copies of this group, seen by the warp
      const float* sl = slots + (gi % S::kBufs) * SLOT * kThreads + tid;
      // the later group's checkpoint, h after this group (still in its
      // slots: the copies in flight go to the third buffer)
      const float* later =
          slots + ((gi + 1) % S::kBufs) * SLOT * kThreads + tid;
      const int gs = min(kCk, s - (t0 + c0));
      const bool tail = t0 + c0 + kCk >= s;  // the sequence's last group
      // hist[q]: h before step c0 + q; hist[kCk]: after the group
      float hist[kCk + 1][N];
#pragma unroll
      for (int k = 0; k < N; ++k) hist[0][k] = sl[(3 * kCk + k) * kThreads];
#pragma unroll
      for (int q = 0; q < kCk; ++q) {
        if (tail ? q < gs : q + 1 < kCk) {
          const float d = sl[q * kThreads];
          const float du = d * sl[(kCk + q) * kThreads];
#pragma unroll
          for (int k = 0; k < N; k += 4) {
            const float4 b4 =
                *reinterpret_cast<const float4*>(sb + (c0 + q) * N + k);
            hist[q + 1][k] = ex2(d * a2[k]) * hist[q][k] + du * b4.x;
            hist[q + 1][k + 1] =
                ex2(d * a2[k + 1]) * hist[q][k + 1] + du * b4.y;
            hist[q + 1][k + 2] =
                ex2(d * a2[k + 2]) * hist[q][k + 2] + du * b4.z;
            hist[q + 1][k + 3] =
                ex2(d * a2[k + 3]) * hist[q][k + 3] + du * b4.w;
          }
        }
      }
      if (!tail) {
#pragma unroll
        for (int k = 0; k < N; ++k)
          hist[kCk][k] = later[(3 * kCk + k) * kThreads];
      }
#pragma unroll
      for (int q = kCk - 1; q >= 0; --q) {
        if (q >= gs) continue;  // the same for every thread
        const int c = c0 + q;
        const float d = sl[q * kThreads], uu = sl[(kCk + q) * kThreads];
        const float yy = sl[(2 * kCk + q) * kThreads], du = d * uu;
        // sums over the states, even and odd states apart
        float sdu[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll
        for (int k = 0; k < N; k += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(sb + c * N + k);
          const float4 c4 = *reinterpret_cast<const float4*>(sc + c * N + k);
          const float bk[4] = {b4.x, b4.y, b4.z, b4.w};
          const float ck[4] = {c4.x, c4.y, c4.z, c4.w};
          float vb[4], vc[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kk = k + j;
            const float a = ex2(d * a2[kk]);
            const float g = fmaf(yy, ck[j], gf[kk]);  // G_t
            gf[kk] = a * g;                           // a_t G_t
            const float gahp = gf[kk] * hist[q][kk];
            sdu[j & 1] = fmaf(g, bk[j], sdu[j & 1]);
            s1[j & 1] = fmaf(gahp, a2[kk], s1[j & 1]);
            da[kk] = fmaf(gahp, d, da[kk]);
            vb[j] = g * du;                    // dB
            vc[j] = yy * hist[q + 1][kk];      // dC
          }
          *reinterpret_cast<float4*>(my_row + k) =
              make_float4(vb[0], vb[1], vb[2], vb[3]);
          *reinterpret_cast<float4*>(my_row + N + k) =
              make_float4(vc[0], vc[1], vc[2], vc[3]);
        }
        if (active) {
          const size_t o = (row + t0 + c) * di + ch;
          const float su = sdu[0] + sdu[1];
          ddt[o] = fmaf(s1[0] + s1[1], kLn2, uu * su);
          d_u[o] = su * d;
        }
        __syncwarp();  // this step's terms, seen by the warp
        if (lane < 2 * N) {
          float acc[2] = {0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 32; ++r) acc[r & 1] += my_col[r * kRow];
          part[(c * kWarps + warp) * 2 * N + lane] = acc[0] + acc[1];
        }
        __syncwarp();  // read before the next step writes the stash
      }
    }
    __syncthreads();
    // this block's sums over its channels: (2, b, s, n) of the block
    for (int e = threadIdx.x; e < steps * 2 * N; e += kThreads) {
      const int c = e / (2 * N), idx = e % (2 * N), which = idx / N,
                k = idx % N;
      float acc = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi)
        acc += part[(c * kWarps + wi) * 2 * N + idx];
      if (EXACT || k < n)
        dbc_part[((((size_t)blockIdx.x * 2 + which) * nb + bi) * s + t0 + c)
                     * n + k] = acc;
    }
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
  constexpr size_t bytes = Scan<N>::kFloats * sizeof(float);
  auto kernel = selective_scan_bwd_kernel<TX, TU, N, EXACT>;
  // above 48 KB a block's shared memory must be asked for (per device)
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid((di + kThreads - 1) / kThreads, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const TX*>(dt), static_cast<const TX*>(bm),
      static_cast<const TX*>(cm), static_cast<const TU*>(u),
      static_cast<const float*>(a), static_cast<const float*>(h_chk),
      static_cast<const float*>(dy), static_cast<const float*>(dh),
      static_cast<float*>(ddt), static_cast<float*>(d_u),
      static_cast<float*>(dbc_part), static_cast<float*>(da_part), s, di,
      n);
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
// h_chk (the forward's checkpoints, (b, ceil(s / 4), n, di)), dy (b, s,
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
