// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rwkv6_wkv.py::rwkv6_wkv (the Pallas TPU
// kernel, body `_kernel`). Same function, for every (batch, head) pair
// of r, k, v, w (b, h, s, dh) and bonus u (h, dh), from S = 0:
//   y_t[i] = sum_j r_t[j] * (S[j,i] + u[j] * k_t[j] * v_t[i])
//   S[j,i] = w_t[j] * S[j,i] + k_t[j] * v_t[i]
// Outputs y (b, h, s, dh) f32 and S_final (b, h, dh, dh) f32 in the
// [key_dim j, val_dim i] layout of src/repro/models/rwkv.py. Inputs are
// f32 or bf16 (all four alike), u is f32, all arithmetic is f32. Any
// head dim dh >= 1 and any length s >= 1.
//
// What bounds it on this card: each input element is read once and each
// output written once; at rwkv6-7b's prefill shape (4, 64, 511, 64) in
// f32 that is 171.6 MB, 0.0512 ms at 3.35 TB/s, against 2.68 GFLOP of
// state update and read-out, 0.040 ms at 67 TFLOP/s of f32 FMAs: bytes
// bound it on paper. The recurrence is sequential in time, so a step's
// dh^2 terms of a pair are all the parallel work there is: at that shape
// 256 pairs, two an SM. Each term needs r_j, k_j and w_j of its key row;
// the first design (PR 12: a thread a value column, every row) read
// those three, and u_j, from shared memory for every term (one 16-byte
// broadcast a term), which held it at ~3x the byte bound.
//
// What the design does: a thread owns a tile of the state, JT key rows
// by CT value columns, in registers for the whole sequence, so each row
// value it loads serves CT terms and each column value JT terms. The
// RG = dh / JT threads that share a column block sit in neighbouring
// lanes and add their partial read-outs with a shuffle tree a step (the
// compiler interleaves the shuffles with the state updates). The bonus
// is a scalar a step: y_t[i] = sum_j r_j S[j,i] + beta_t v_t[i] with
// beta_t = sum_j r_j u_j k_j, each thread adding its rows' part of beta
// to its partial read-out before the tree, so a term costs three
// instructions (k_j v_i, the read-out FMA, the decay FMA), not four.
// Time steps are staged kChunk at a time in double-buffered shared
// memory (each row group's JT values padded so the row groups' 16-byte
// loads fall in different banks); each thread loads its share of the
// next chunk into registers while the block computes the current one.
// At dh 64 the tile is 8 x 4 (8 lanes a column block, 128 threads a
// pair): a step is ~150 instructions a warp, and with 8 warps an SM
// (two a scheduler) the steps run at ~2/3 of the issue rate; the kernel
// is at ~2.3x the byte bound, held by issue and the stalls two warps a
// scheduler cannot cover. Other tiles (16 x 4, 8 x 8, 4 x 4, 16 x 2),
// partial read-outs summed a chunk later in shared memory instead of
// the tree, the next step's loads issued a step ahead, and other chunk
// lengths all measured slower (PERF.md).
//
// Any length works: no chunk has to divide s. Any dh: 32 and 64 are
// compiled; any dh up to 64 runs in the next wider one, the rows and
// columns past dh loaded as zero (so those states stay 0 and add
// nothing) and never stored; dh above 64 takes a plain kernel, a thread
// a value column, its state column in S_final's rows (global memory,
// cached).
//
// Under grad (s_chk not null) the kernel also writes the state before
// every kChunk-th step, S_{8c}, to s_chk (b, h, ceil(s / 8), dh, dh) f32,
// from which the backward kernel (rwkv6_wkv_bwd.cu) recomputes the states
// between: one state a staged chunk, 1/8 of the steps' state traffic,
// written from registers the chunk loop holds anyway. The writes are a
// template parameter (CKPT): serving runs a kernel without them (a null
// test a chunk cost 1.6% at rwkv6's shape, measured in turns). Head dims
// above 64 have no backward kernel and take no s_chk.
//
// Not done: a chunked tensor-core form. The bound is bytes, so tensor
// cores cannot lower it, and a chunk's cumulative decay products
// underflow f32 (0.45^64 is ~1e-22).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence_bwd.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr int kChunk = 8;  // time steps staged in shared memory at once
static_assert(kChunk == recurrence::kWkvCheckpoint,
              "a checkpoint at the start of every staged chunk");

// component i (known at compile time) of a float4
__device__ __forceinline__ float part(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// The state tile a thread owns at a compiled width DH: kRG row groups
// (the lanes of a column block), kCT value columns.
template <int DH>
struct Tile;
template <>
struct Tile<32> {
  static constexpr int kRG = 4, kCT = 4;
};
template <>
struct Tile<64> {
  static constexpr int kRG = 8, kCT = 4;
};

// Adds the N partial sums `v` of this lane over the lanes that differ in
// bits OFF, OFF / 2, ..., 1 of g (a butterfly; N <= 2 OFF): while N > 1
// each level keeps half the values (the upper half where the lane's bit
// is set) and adds the partner's, so the lane ends with one whole sum in
// v[0] (which of its N: `first_sum`).
template <int N, int OFF>
__device__ __forceinline__ void reduce_rows(float* v, int g) {
  if constexpr (OFF > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (g & OFF) != 0;
#pragma unroll
      for (int q = 0; q < H; ++q) {
        const float send = up ? v[q] : v[q + H];
        const float keep = up ? v[q + H] : v[q];
        v[q] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      reduce_rows<H, OFF / 2>(v, g);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      reduce_rows<1, OFF / 2>(v, g);
    }
  }
}

// Which of its N sums `reduce_rows<N, RG / 2>` leaves in lane g.
template <int N, int RG>
__device__ __forceinline__ int first_sum(int g) {
  int col = 0;
#pragma unroll
  for (int off = RG / 2, half = N / 2; off > 0 && half > 0;
       off /= 2, half /= 2)
    if (g & off) col += half;
  return col;
}

// grid: (b * h); a block of NT = RG * DH / CT threads a (batch, head)
// pair. Thread (g, cg) = (tid % RG, tid / RG) owns S[j, i] for the key
// rows j in [g JT, (g + 1) JT) and the value columns i in
// [cg CT, (cg + 1) CT). Rows and columns past dh are zero and never
// stored. EXACT: dh == DH, every stride and bound a constant (measured
// 7% faster at rwkv6's shape than the same kernel with dh at run time).
// CKPT: write s_chk.
template <typename T, int DH, bool EXACT, bool CKPT>
__global__ void __launch_bounds__(Tile<DH>::kRG * DH / Tile<DH>::kCT)
rwkv6_wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, float* __restrict__ y,
                 float* __restrict__ s_final, float* __restrict__ s_chk,
                 int h, int s, int dh_arg) {
  const int dh = EXACT ? DH : dh_arg;
  constexpr int RG = Tile<DH>::kRG, CT = Tile<DH>::kCT;
  constexpr int JT = DH / RG;       // key rows a thread
  constexpr int NT = RG * DH / CT;  // threads a pair
  constexpr int LDG = JT + 4;       // a row group's values, padded
  constexpr int RKW = RG * LDG;     // one step of r, k or w
  constexpr int STEP = 3 * RKW + DH;  // r, k, w, then v
  constexpr int SPQ = NT / DH;      // steps one staging pass covers
  constexpr int PER = kChunk / SPQ;  // staging passes a chunk
  constexpr int NQ = 3 * JT / 4 + CT / 4;  // float4 a thread reads a step
  static_assert(DH % RG == 0 && JT % 4 == 0 && CT % 4 == 0 &&
                    DH % CT == 0 && CT <= RG && NT % 32 == 0 &&
                    NT % DH == 0 &&
                    kChunk % SPQ == 0 && (RG & (RG - 1)) == 0 &&
                    (CT & (CT - 1)) == 0,
                "tile shape");
  __shared__ __align__(16) float stage[2][kChunk][STEP];

  const int tid = threadIdx.x;
  const int g = tid % RG, cg = tid / RG;
  const int pair = blockIdx.x;
  const size_t base = (size_t)pair * s * dh;

  float uu[JT];
#pragma unroll
  for (int jj = 0; jj < JT; ++jj) {
    const int j = g * JT + jj;
    uu[jj] = j < dh ? u[(size_t)(pair % h) * dh + j] : 0.f;
  }
  float st[JT][CT];
#pragma unroll
  for (int jj = 0; jj < JT; ++jj)
#pragma unroll
    for (int c = 0; c < CT; ++c) st[jj][c] = 0.f;

  // Staging: this thread loads channel j of steps tq, tq + SPQ, .. of a
  // chunk (coalesced: the pair's steps are contiguous rows of dh), and
  // stores it at `at` in a staged step's r, k and w and at j in its v.
  const int j = tid % DH, tq = tid / DH;
  const int at = (j / JT) * LDG + j % JT;
  const size_t first = base + (size_t)tq * dh + j;
  const size_t pass = (size_t)SPQ * dh;  // elements between passes
  float pre[4][PER];
  auto fetch = [&](int t0) {
    const size_t o = first + (size_t)t0 * dh;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const bool in = j < dh && t0 + tq + SPQ * q < s;
      const size_t oq = o + q * pass;
      pre[0][q] = in ? to_f32(r[oq]) : 0.f;
      pre[1][q] = in ? to_f32(k[oq]) : 0.f;
      pre[2][q] = in ? to_f32(w[oq]) : 0.f;
      pre[3][q] = in ? to_f32(v[oq]) : 0.f;
    }
  };
  // a step's values for this thread: r, k and w of its rows, v of its
  // columns
  auto load_step = [&](float4 (&x)[NQ], const float* sp) {
#pragma unroll
    for (int q = 0; q < JT / 4; ++q) {
      x[q] = *reinterpret_cast<const float4*>(sp + g * LDG + 4 * q);
      x[JT / 4 + q] =
          *reinterpret_cast<const float4*>(sp + RKW + g * LDG + 4 * q);
      x[JT / 2 + q] =
          *reinterpret_cast<const float4*>(sp + 2 * RKW + g * LDG + 4 * q);
    }
#pragma unroll
    for (int q = 0; q < CT / 4; ++q)
      x[3 * JT / 4 + q] =
          *reinterpret_cast<const float4*>(sp + 3 * RKW + cg * CT + 4 * q);
  };
  const int col = cg * CT + first_sum<CT, RG>(g);
  // the lanes that differ in g's low bits, below the levels that halved
  // the sums, hold the same sum: the one with them 0 writes it
  const bool writer = col < dh && (g & (RG / CT - 1)) == 0;
  // one step: the read-out of this thread's rows and columns plus its
  // part of the bonus, summed over the row groups, and the state update
  auto step = [&](const float4 (&x)[NQ], int t) {
    float rr[JT], kk[JT], ww[JT], vv[CT];
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) {
      rr[jj] = part(x[jj / 4], jj % 4);
      kk[jj] = part(x[JT / 4 + jj / 4], jj % 4);
      ww[jj] = part(x[JT / 2 + jj / 4], jj % 4);
    }
#pragma unroll
    for (int ci = 0; ci < CT; ++ci)
      vv[ci] = part(x[3 * JT / 4 + ci / 4], ci % 4);
    float acc[CT];
#pragma unroll
    for (int ci = 0; ci < CT; ++ci) acc[ci] = 0.f;
    float beta = 0.f;
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) {
      beta = fmaf(rr[jj] * uu[jj], kk[jj], beta);
#pragma unroll
      for (int ci = 0; ci < CT; ++ci) {
        float& sji = st[jj][ci];
        const float kv = kk[jj] * vv[ci];
        acc[ci] = fmaf(rr[jj], sji, acc[ci]);
        sji = fmaf(ww[jj], sji, kv);
      }
    }
#pragma unroll
    for (int ci = 0; ci < CT; ++ci) acc[ci] = fmaf(beta, vv[ci], acc[ci]);
    reduce_rows<CT, RG / 2>(acc, g);
    if (writer) y[base + (size_t)t * dh + col] = acc[0];
  };

  // this thread's tile of the state, at the checkpoint before step t0
  auto checkpoint = [&](int t0) {
    float* sc = s_chk + ((size_t)pair * ((s + kChunk - 1) / kChunk)
                         + t0 / kChunk) * dh * dh;
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) {
      const int jr = g * JT + jj;
#pragma unroll
      for (int ci = 0; ci < CT; ++ci) {
        const int i = cg * CT + ci;
        if (jr < dh && i < dh) sc[(size_t)jr * dh + i] = st[jj][ci];
      }
    }
  };

  fetch(0);
  int buf = 0;
  for (int t0 = 0; t0 < s; t0 += kChunk, buf ^= 1) {
    if (CKPT) checkpoint(t0);
    // stage[buf] was last read two chunks ago, before the previous
    // chunk's barrier, so writing it now needs no barrier of its own
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      float* sp = stage[buf][tq + SPQ * q];
      sp[at] = pre[0][q];
      sp[RKW + at] = pre[1][q];
      sp[2 * RKW + at] = pre[2][q];
      sp[3 * RKW + j] = pre[3][q];
    }
    // the next chunk's loads are in flight while this chunk computes
    fetch(t0 + kChunk);
    __syncthreads();
    const int n = min(kChunk, s - t0);
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      float4 x[NQ];
      load_step(x, stage[buf][c]);
      step(x, t0 + c);
    }
  }
  float* sf = s_final + (size_t)pair * dh * dh;
#pragma unroll
  for (int jj = 0; jj < JT; ++jj) {
    const int jr = g * JT + jj;
#pragma unroll
    for (int ci = 0; ci < CT; ++ci) {
      const int i = cg * CT + ci;
      if (jr < dh && i < dh) sf[(size_t)jr * dh + i] = st[jj][ci];
    }
  }
}

// dh above 64: a thread a value column i, its state column S[:, i] in
// S_final's rows (global memory; L1 and L2 hold it), r, k, w read from
// global memory (the same for every thread of the pair, so cached). The
// same arithmetic as above, beta summed by the thread in row order.
template <typename T>
__global__ void __launch_bounds__(128)
rwkv6_wkv_wide_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ w,
                      const float* __restrict__ u, float* __restrict__ y,
                      float* __restrict__ s_final, int h, int s, int dh) {
  const int i = blockIdx.y * 128 + threadIdx.x;
  const int pair = blockIdx.x;
  if (i >= dh) return;
  const size_t base = (size_t)pair * s * dh;
  float* sc = s_final + (size_t)pair * dh * dh + i;  // S[j, i] at sc[j dh]
  const float* uh = u + (size_t)(pair % h) * dh;
  for (int j = 0; j < dh; ++j) sc[(size_t)j * dh] = 0.f;
  for (int t = 0; t < s; ++t) {
    const size_t o = base + (size_t)t * dh;
    const float vi = to_f32(v[o + i]);
    float acc = 0.f, bt = 0.f;
    for (int j = 0; j < dh; ++j) {
      const float rj = to_f32(r[o + j]), kj = to_f32(k[o + j]);
      const float sji = sc[(size_t)j * dh];
      acc = fmaf(rj, sji, acc);
      bt = fmaf(rj * uh[j], kj, bt);
      sc[(size_t)j * dh] = fmaf(to_f32(w[o + j]), sji, kj * vi);
    }
    y[o + i] = fmaf(bt, vi, acc);
  }
}

template <typename T, int DH, bool EXACT>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* y, void* s_final,
                   void* s_chk, int b, int h, int s, int dh,
                   cudaStream_t stream) {
  constexpr int threads = Tile<DH>::kRG * DH / Tile<DH>::kCT;
  const T *pr = static_cast<const T*>(r), *pk = static_cast<const T*>(k),
          *pv = static_cast<const T*>(v), *pw = static_cast<const T*>(w);
  const float* pu = static_cast<const float*>(u);
  float *py = static_cast<float*>(y), *ps = static_cast<float*>(s_final),
        *pc = static_cast<float*>(s_chk);
  if (pc != nullptr)
    rwkv6_wkv_kernel<T, DH, EXACT, true>
        <<<(unsigned)(b * h), threads, 0, stream>>>(pr, pk, pv, pw, pu, py,
                                                    ps, pc, h, s, dh);
  else
    rwkv6_wkv_kernel<T, DH, EXACT, false>
        <<<(unsigned)(b * h), threads, 0, stream>>>(pr, pk, pv, pw, pu, py,
                                                    ps, pc, h, s, dh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* y, void* s_final,
                     void* s_chk, int b, int h, int s, int dh,
                     cudaStream_t stream) {
  if (dh == 32)
    return launch<T, 32, true>(r, k, v, w, u, y, s_final, s_chk, b, h,
                               s, dh, stream);
  if (dh == 64)
    return launch<T, 64, true>(r, k, v, w, u, y, s_final, s_chk, b, h,
                               s, dh, stream);
  if (dh < 32)
    return launch<T, 32, false>(r, k, v, w, u, y, s_final, s_chk, b, h,
                                s, dh, stream);
  if (dh < 64)
    return launch<T, 64, false>(r, k, v, w, u, y, s_final, s_chk, b, h,
                                s, dh, stream);
  // pairs on grid.x (up to 2^31 - 1), column blocks on grid.y
  dim3 grid(b * h, (dh + 127) / 128);
  rwkv6_wkv_wide_kernel<T><<<grid, 128, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(s_final), h, s, dh);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w alike; u is float32).
// Any dh >= 1. s_chk: null, or (under grad; dh <= 64) the backward's
// checkpoints, (b, h, ceil(s / 8), dh, dh) f32. Returns the launch's
// cudaError_t.
extern "C" int repro_rwkv6_wkv(const void* r, const void* k, const void* v,
                               const void* w, const void* u, void* y,
                               void* s_final, void* s_chk, int b, int h,
                               int s, int dh, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || h <= 0 || s <= 0 || dh <= 0 ||
      (int64_t)b * h > 0x7fffffffLL || (s_chk != nullptr && dh > 64))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, y, s_final, s_chk, b, h, s, dh,
                           st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, y, s_final, s_chk, b, h,
                                   s, dh, st);
  return cudaErrorInvalidValue;
}
