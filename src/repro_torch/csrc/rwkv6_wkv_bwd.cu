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
// operations bound it. This design also reads the forward's checkpoints
// (268 MB at that shape), so its own byte floor is ~0.17 ms.
//
// The first design (a block of 512 threads a pair, a thread one
// key row at 8 value columns, its history in registers) ran at 13.7x the
// bound: 95 registers a thread left one block, 16 warps, an SM and two
// waves of 256 pairs on 132 SMs; every step paid ~24 shuffles against 40
// FMAs a thread, and each chunk's loads waited for nothing to overlap.
//
// The design: one block of DH * DH / 16 threads a pair (256 at DH 64),
// two blocks an SM, so the 256 pairs of rwkv6-7b's shape run in one
// wave. Thread (rg, cg) owns a 2-row x 8-column tile of G, rows
// [2 rg, 2 rg + 2) and columns [8 cg, 8 cg + 8), in registers for the
// whole walk; the DH / 8 threads of a row group are neighbouring lanes.
// A chunk's S history is recomputed from its checkpoint into shared
// memory, not registers (a half's states in float4 slots only their
// thread reads; the state walked first stays in registers, so 3 slots,
// 48 KB): the second half first (S_4..S_7 after 7 updates), then the
// first (S_0..S_3 after 3), 10 updates for 8 steps. Per step and
// element the walk is six f32 operations: S dy, G v, G S and G k
// products and the G update's two. A thread's 16 elements make its
// partial sums 2-row and 8-column wide, so a step's cross-lane work is
// small: dr, dk and dw halve over the row group's lanes once (6 values
// -> 3) and add over the rest; dv adds each quad of rows as (row 0 +
// row 2) + (row 1 + row 3), a lane pair trading half its columns, and
// the quads in order; du is one register a row over the steps, last
// first. These are the first design's orders, so at DH 64 every
// gradient is the first design's bit for bit: a 10-step rwkv6-7b run
// is chaotic enough that another rounding of dv and du ended it above
// its first loss. dr, dk, dw land in shared memory a chunk at a time;
// the block adds the bonus terms (u o k vdy, u o r vdy, beta dy) and
// writes the chunk coalesced. The chunks are walked last to first; the
// next chunk's r, k, w, v, dy are loaded into registers while this one
// is walked, and stored into the other of two shared buffers (two
// barriers a chunk). du's sum over the batch is a second pass over
// per-pair partials: no float atomics, two runs give the same bits.
//
// Not taken: splitting a pair's value columns over a thread-block
// cluster. S and G evolve column by column, but every column tile needs
// all of r, k, w, so the tiles' staging repeats them, and dr, dk, dw
// become partials summed through distributed shared memory; the pair's
// history would then have to live in registers to fit 8 blocks an SM.
// A block a pair gets the one wave without either.
//
// Any dh up to 64 runs in the next wider compiled width (32 or 64) with
// the rows and columns past dh zero. Head dims above 64 are refused (no
// config has them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence_bwd.cuh"

namespace {

using recurrence::add_lanes;
using recurrence::halve_sum;

constexpr int kCk = recurrence::kWkvCheckpoint;  // steps a chunk
constexpr int kHalf = kCk / 2;                   // steps a walked half
constexpr int kJT = 2;                           // key rows a thread
constexpr int kCT = 8;                           // value columns a thread
constexpr int kEl = kJT * kCT;                   // elements a thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int DH>
struct Bwd {
  static constexpr int kCg = DH / kCT;     // column groups, a row's lanes
  static constexpr int kRg = DH / kJT;     // row groups
  static constexpr int kNt = kCg * kRg;    // threads
  static constexpr int kNw = kNt / 32;     // warps
  static constexpr int kRgw = 32 / kCg;    // row groups a warp
  static constexpr int kNq = DH / 4;       // quads of rows
  // a staged row of DH values, a 4-float pad after each 32 so that the 8
  // column groups' float4 loads fall in different banks
  static constexpr int kRow = DH + DH / 32 * 4;
  static constexpr int kSteps = kNt / DH;  // steps one staging pass covers
  static constexpr int kPer = 5 * kCk / kSteps;  // staged values a thread
  // shared memory, in floats: two buffers of a chunk's r, k, w, v, dy;
  // a half's history (3 states: the fourth stays in registers); dr, dk,
  // dw of a chunk; dv's sums a quad of rows; vdy and beta a step; u
  static constexpr int kStage = 5 * kCk * kRow;
  static constexpr int kHist = (kHalf - 1) * kEl * kNt;
  static constexpr int kPart = 3 * kCk * DH;
  static constexpr int kDvp = kCk * kNq * DH;
  static constexpr int kFloats =
      2 * kStage + kHist + kPart + kDvp + 2 * kCk + DH;
  static constexpr int kBlocksPerSm = DH == 64 ? 2 : 8;
  static_assert(kNt % 32 == 0 && kRgw * kCg == 32 && kRgw % 2 == 0 &&
                    kNt % DH == 0 && kCk % kSteps == 0 &&
                    (kCk / kSteps) * kSteps == kCk,
                "tile");
};

// padded column index within a staged row
__device__ __forceinline__ int col(int i) { return i + (i >> 5) * 4; }

// grid: (b * h); block: Bwd<DH>::kNt threads, Bwd<DH>::kFloats floats of
// dynamic shared memory. EXACT: dh == DH.
template <typename T, int DH, bool EXACT>
__global__ void __launch_bounds__(Bwd<DH>::kNt, Bwd<DH>::kBlocksPerSm)
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
  constexpr int CG = B::kCg, NT = B::kNt, NW = B::kNw, NQ = B::kNq;
  constexpr int ROW = B::kRow, STEPS = B::kSteps, PER = B::kPer;
  const int dh = EXACT ? DH : dh_arg;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                       // [2][5][kCk][ROW]
  float4* hist = reinterpret_cast<float4*>(stage + 2 * B::kStage);
  //   [kHalf - 1][kEl / 4][NT]: slot (q, c4) of thread tid
  float* part = stage + 2 * B::kStage + B::kHist;  // [kCk][3][DH]
  float* dvp = part + B::kPart;              // [kCk][NQ][DH]
  float* vdy = dvp + B::kDvp;                // [kCk]
  float* beta = vdy + kCk;                   // [kCk]
  float* us = beta + kCk;                    // [DH]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane % CG, rg = warp * B::kRgw + lane / CG;
  const int j0 = rg * kJT, i0 = cg * kCT;
  const int pair = blockIdx.x;
  const size_t base = (size_t)pair * s * dh;
  const int nck = (s + kCk - 1) / kCk;
  for (int e = tid; e < DH; e += NT)
    us[e] = e < dh ? u[(size_t)(pair % h) * dh + e] : 0.f;

  // this thread's tile of a (dh, dh) matrix at `src` (dS, a checkpoint)
  auto load_tile = [&](float (&x)[kJT][kCT], const float* src) {
#pragma unroll
    for (int jj = 0; jj < kJT; ++jj)
#pragma unroll
      for (int e = 0; e < kCT; ++e)
        x[jj][e] = EXACT || (j0 + jj < dh && i0 + e < dh)
                       ? src[(size_t)(j0 + jj) * dh + i0 + e]
                       : 0.f;
  };

  // G at this thread's rows and columns, from dS
  float g[kJT][kCT];
  load_tile(g, ds + (size_t)pair * dh * dh);

  // Staging: thread tid loads column jj = tid % DH of the staged rows
  // tid / DH + STEPS m of a chunk (coalesced: a pair's steps are
  // contiguous rows of dh); staged row q * kCk + cc is array q (r, k, w,
  // v, dy) at step cc.
  const int sj = tid % DH, sq = tid / DH;
  float pre[PER];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int rr = sq + STEPS * m, q = (STEPS * m) / kCk, cc = rr % kCk;
      const bool in = sj < dh && t0 + cc < s;
      const size_t o = base + (size_t)(t0 + cc) * dh + sj;
      float x = 0.f;
      if (in) {
        x = q == 0   ? to_f32(r[o])
            : q == 1 ? to_f32(k[o])
            : q == 2 ? to_f32(w[o])
            : q == 3 ? to_f32(v[o])
                     : dy[o];
      }
      pre[m] = x;
    }
  };
  auto stage_row = [&](int buf, int q, int cc) {
    return stage + ((buf * 5 + q) * kCk + cc) * ROW;
  };

  // a staged step's values for this thread: 2 rows of r, k or w; 8
  // columns of v or dy
  auto rows = [&](float (&x)[kJT], const float* row) {
    const float2 a = *reinterpret_cast<const float2*>(row + col(j0));
    x[0] = a.x;
    x[1] = a.y;
  };
  auto cols = [&](float (&x)[kCT], const float* row) {
    const float4 a = *reinterpret_cast<const float4*>(row + col(i0));
    const float4 b = *reinterpret_cast<const float4*>(row + col(i0) + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  };
  // S <- diag(w) S + k v^T at staged step cc, on this thread's tile (the
  // forward kernel's arithmetic: the same states bit for bit)
  auto advance = [&](float (&st)[kJT][kCT], int buf, int cc) {
    float kk[kJT], ww[kJT], vv[kCT];
    rows(kk, stage_row(buf, 1, cc));
    rows(ww, stage_row(buf, 2, cc));
    cols(vv, stage_row(buf, 3, cc));
#pragma unroll
    for (int jj = 0; jj < kJT; ++jj)
#pragma unroll
      for (int e = 0; e < kCT; ++e)
        st[jj][e] = fmaf(ww[jj], st[jj][e], kk[jj] * vv[e]);
  };
  auto put = [&](int q, const float (&st)[kJT][kCT]) {
#pragma unroll
    for (int c4 = 0; c4 < kEl / 4; ++c4) {
      const int jj = c4 / 2, e = (c4 % 2) * 4;
      hist[(q * (kEl / 4) + c4) * NT + tid] =
          make_float4(st[jj][e], st[jj][e + 1], st[jj][e + 2], st[jj][e + 3]);
    }
  };
  auto get = [&](int q, float (&st)[kJT][kCT]) {
#pragma unroll
    for (int c4 = 0; c4 < kEl / 4; ++c4) {
      const int jj = c4 / 2, e = (c4 % 2) * 4;
      const float4 a = hist[(q * (kEl / 4) + c4) * NT + tid];
      st[jj][e] = a.x; st[jj][e + 1] = a.y; st[jj][e + 2] = a.z;
      st[jj][e + 3] = a.w;
    }
  };

  // dv's quad of rows: this thread's two and those of the lane at
  // lane ^ CG; this lane keeps the quad's sums of half its columns
  const bool dv_up = (lane & CG) != 0;
  const int quad = rg / 2, qcol = i0 + (dv_up ? kCT / 2 : 0);
  // after the dr / dk / dw butterfly, lane cg holds row j0 + (1 if its
  // top column-group bit is set); the lanes with the other bits 0 write
  const int prow = j0 + ((cg & (CG / 2)) ? 1 : 0);
  const bool pwriter = (cg & (CG / 2 - 1)) == 0;
  float du_acc = 0.f;  // row sj (threads sq == 0), the steps last first

  fetch((nck - 1) * kCk);
  int buf = 0;
  for (int c = nck - 1; c >= 0; --c, buf ^= 1) {
    const int t0 = c * kCk;
    const int n = min(kCk, s - t0);
    // stage[buf] was last read before the previous chunk's second
    // barrier, so writing it now needs no barrier of its own
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int rr = sq + STEPS * m;
      stage_row(buf, (STEPS * m) / kCk, rr % kCk)[col(sj)] = pre[m];
    }
    // the previous chunk's loads are in flight while this one is walked
    if (c > 0) fetch(t0 - kCk);
    float chk[kJT][kCT];
    load_tile(chk, s_chk + ((size_t)pair * nck + c) * dh * dh);
    __syncthreads();
    for (int cc = warp; cc < kCk; cc += NW) {
      float a = 0.f, bt = 0.f;
      for (int jj = lane; jj < DH; jj += 32) {
        const int p = col(jj);
        a = fmaf(stage_row(buf, 3, cc)[p], stage_row(buf, 4, cc)[p], a);
        bt = fmaf(stage_row(buf, 0, cc)[p] * us[jj],
                  stage_row(buf, 1, cc)[p], bt);
      }
      add_lanes<16>(a);
      add_lanes<16>(bt);
      if (lane == 0) {
        vdy[cc] = a;
        beta[cc] = bt;
      }
    }

#pragma unroll 1
    for (int half = kCk / kHalf - 1; half >= 0; --half) {
      const int c0 = half * kHalf;
      if (c0 >= n) continue;  // the same for every thread
      // S before steps c0 .. c0 + 3 of the chunk into this thread's
      // slots, but for the two that stay in registers: the second half's
      // last state (walked first) and the first half's checkpoint (walked
      // last)
      float st[kJT][kCT];
#pragma unroll
      for (int jj = 0; jj < kJT; ++jj)
#pragma unroll
        for (int e = 0; e < kCT; ++e) st[jj][e] = chk[jj][e];
#pragma unroll
      for (int cc = 0; cc < c0; ++cc) advance(st, buf, cc);
      const int nq = min(kHalf, n - c0);
      // the second half's states 0..2 in slots 0..2, the first half's
      // 1..3 in slots 0..2
      const int slot0 = half > 0 ? 0 : -1;
      if (half > 0 && nq > 1) put(0, st);
#pragma unroll
      for (int q = 1; q < kHalf; ++q) {
        if (q < nq) {
          advance(st, buf, c0 + q - 1);
          if (half == 0 || q + 1 < nq) put(q + slot0, st);
        }
      }
#pragma unroll
      for (int q = kHalf - 1; q >= 0; --q) {
        if (q >= nq) continue;  // the same for every thread
        const int cc = c0 + q;
        float sp[kJT][kCT];
        if (half > 0 && q == nq - 1) {
#pragma unroll
          for (int jj = 0; jj < kJT; ++jj)
#pragma unroll
            for (int e = 0; e < kCT; ++e) sp[jj][e] = st[jj][e];
        } else if (half == 0 && q == 0) {
#pragma unroll
          for (int jj = 0; jj < kJT; ++jj)
#pragma unroll
            for (int e = 0; e < kCT; ++e) sp[jj][e] = chk[jj][e];
        } else {
          get(q + slot0, sp);
        }
        float rr[kJT], kk[kJT], ww[kJT], vv[kCT], yy[kCT];
        rows(rr, stage_row(buf, 0, cc));
        rows(kk, stage_row(buf, 1, cc));
        rows(ww, stage_row(buf, 2, cc));
        cols(vv, stage_row(buf, 3, cc));
        cols(yy, stage_row(buf, 4, cc));
        // [dr, dk, dw] of row j0, then of row j0 + 1; dv's row products
        float p3[2 * 3], pv[kJT][kCT];
#pragma unroll
        for (int jj = 0; jj < kJT; ++jj) {
          float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
          for (int e = 0; e < kCT; ++e) {
            const float gg = g[jj][e], sv = sp[jj][e];
            pr = fmaf(sv, yy[e], pr);
            pk = fmaf(gg, vv[e], pk);
            pw = fmaf(gg, sv, pw);
            pv[jj][e] = gg * kk[jj];
            g[jj][e] = fmaf(ww[jj], gg, rr[jj] * yy[e]);  // G_{t-1}
          }
          p3[3 * jj] = pr;
          p3[3 * jj + 1] = pk;
          p3[3 * jj + 2] = pw;
        }
        // over the row group's CG lanes: halve on the top bit (each lane
        // keeps one row's three sums), then add over the rest
        halve_sum<6, CG / 2, CG / 2>(p3, lane);
        add_lanes<CG / 4>(p3[0]);
        add_lanes<CG / 4>(p3[1]);
        add_lanes<CG / 4>(p3[2]);
        if (pwriter) {
          float* pp = part + cc * 3 * DH + prow;
          pp[0] = p3[0];
          pp[DH] = p3[1];
          pp[2 * DH] = p3[2];
        }
        // dv over the quad: (row 0 + row 2) + (row 1 + row 3), the
        // lanes trading the other half of their columns; rounded adds,
        // never fused with the products (the first design's sums, bit
        // for bit)
        float qs[kCT / 2];
#pragma unroll
        for (int e = 0; e < kCT / 2; ++e) {
          const int lo = e, hi = e + kCT / 2;
          const float r0 = __shfl_xor_sync(
              0xffffffffu, dv_up ? pv[0][lo] : pv[0][hi], CG);
          const float r1 = __shfl_xor_sync(
              0xffffffffu, dv_up ? pv[1][lo] : pv[1][hi], CG);
          const float k0 = dv_up ? pv[0][hi] : pv[0][lo];
          const float k1 = dv_up ? pv[1][hi] : pv[1][lo];
          qs[e] = __fadd_rn(__fadd_rn(k0, r0), __fadd_rn(k1, r1));
        }
        *reinterpret_cast<float4*>(dvp + (cc * NQ + quad) * DH + qcol) =
            make_float4(qs[0], qs[1], qs[2], qs[3]);
      }
    }
    __syncthreads();
    // the chunk's outputs: column sums over the warps in order and the
    // bonus terms; thread tid takes row / column sj of the steps
    // sq + STEPS m (the same rows it staged)
#pragma unroll
    for (int m = 0; m < kCk / STEPS; ++m) {
      const int cc = sq + STEPS * m;
      if (cc >= n) continue;
      const size_t o = base + (size_t)(t0 + cc) * dh + sj;
      float acc = 0.f;
#pragma unroll
      for (int qd = 0; qd < NQ; ++qd) acc += dvp[(cc * NQ + qd) * DH + sj];
      const float rj = stage_row(buf, 0, cc)[col(sj)];
      const float kj = stage_row(buf, 1, cc)[col(sj)];
      const float yj = stage_row(buf, 4, cc)[col(sj)];
      const float* pp = part + cc * 3 * DH + sj;
      const float uj = us[sj];
      if (EXACT || sj < dh) {
        dv[o] = fmaf(beta[cc], yj, acc);
        dr[o] = fmaf(uj * kj, vdy[cc], pp[0]);
        dk[o] = fmaf(uj * rj, vdy[cc], pp[DH]);
        dw[o] = pp[2 * DH];
      }
    }
    // du over the chunk's steps, last first, one thread a row
    if (sq == 0) {
      for (int cc = n - 1; cc >= 0; --cc)
        du_acc = fmaf(stage_row(buf, 0, cc)[col(sj)] *
                          stage_row(buf, 1, cc)[col(sj)],
                      vdy[cc], du_acc);
    }
  }
  if (tid < dh) du_part[(size_t)pair * dh + tid] = du_acc;
}

template <typename T, int DH, bool EXACT>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s_chk,
                   const void* dy, const void* ds, void* dr, void* dk,
                   void* dv, void* dw, void* du_part, int b, int h, int s,
                   int dh, cudaStream_t stream) {
  constexpr size_t bytes = Bwd<DH>::kFloats * sizeof(float);
  auto kernel = rwkv6_wkv_bwd_kernel<T, DH, EXACT>;
  // above 48 KB a block's shared memory must be asked for (per device)
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<(unsigned)(b * h), Bwd<DH>::kNt, bytes, stream>>>(
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
