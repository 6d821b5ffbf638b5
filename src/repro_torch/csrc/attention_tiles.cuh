// Tile building blocks shared by the attention forward
// (flash_attention.cu) and its tensor-core backward
// (flash_attention_bwd.cu): which key tiles a query tile walks, the
// staging of a tile into padded shared memory, and the two warp-level
// products on `mma.sync` (`mma_tf32.cuh`), scores (A B^T over the head
// dim) and the weighted sum (P V over a tile's keys). Both kernels run
// blocks of kTileThreads threads, 16 rows of A a warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace attn {

constexpr int kTileThreads = 128;

// The key tiles [t_lo, t_hi) of BK keys that the query tile starting at
// row q0 walks: those some row of it can see.
__host__ __device__ __forceinline__ void key_tiles(int q0, int bq, int sq,
                                                   int sk, int causal,
                                                   int window, int bk,
                                                   int& t_lo, int& t_hi) {
  // plain comparisons: this runs on the host too
  const int q_last = (q0 + bq < sq ? q0 + bq : sq) - 1;
  int lo = window && q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  int hi = causal && q_last + 1 < sk ? q_last + 1 : sk;
  const int last_lo = q_last - window + 1 > 0 ? q_last - window + 1 : 0;
  if (window && last_lo >= hi) {
    lo = 0;   // the last row sees no key: walk them all, as the
    hi = sk;  // reference's softmax over -1e30 everywhere does
  }
  t_lo = lo / bk;
  t_hi = (hi + bk - 1) / bk;
}

// `rows` rows of dh elements from row `row0` of src into a padded
// shared tile of DH columns, zero-filled from row `limit` on and from
// column dh on. Rows whose bytes are a multiple of 16 go by `cp.async`
// (dh a multiple of 16 bytes' elements keeps every row 16-byte
// aligned); others element by element, synchronously.
template <int DH, int LD, typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int row0, int rows, int limit,
                                      int dh) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int CPR = DH / V;        // chunks a row
  if (dh % V == 0) {
    for (int i = threadIdx.x; i < rows * CPR; i += kTileThreads) {
      const int r = i / CPR;
      const int c = (i % CPR) * V;
      const bool in = row0 + r < limit && c < dh;
      mma::cp_async16(dst + r * LD + c,
                      in ? src + (int64_t)(row0 + r) * dh + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DH; i += kTileThreads) {
      const int r = i / DH;
      const int c = i % DH;
      if (row0 + r < limit && c < dh)
        dst[r * LD + c] = src[(int64_t)(row0 + r) * dh + c];
      else
        mma::store(dst + r * LD + c, 0.f);
    }
  }
}

// s (16 x 8 NT per warp) = a (16 rows at a_s) . b (8 NT rows at b_s)^T
// over DH columns, a scaled by `scale` in f32 before the split (the
// forward's q * scale)
template <int DH, int NT, int LD>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* a_s,
                                       const float* b_s, int g, int t,
                                       float scale) {
#pragma unroll
  for (int kk = 0; kk < DH; kk += 8) {
    float a[4];
    mma::load_a_tf32(a, a_s + kk, LD, g, t, scale);
    const mma::Split<4> as = mma::split(a);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float b[2];
      mma::load_b_tf32_nk(b, b_s + j * 8 * LD + kk, LD, g, t);
      mma::mma_3xtf32(s[j], as, mma::split(b));
    }
  }
}

// bf16: a . b^T of the bf16 values is exact in f32; the f32 result is
// scaled
template <int DH, int NT, int LD>
__device__ __forceinline__ void scores(float (&s)[NT][4],
                                       const __nv_bfloat16* a_s,
                                       const __nv_bfloat16* b_s, int g,
                                       int t, float scale) {
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    uint32_t a[4];
    mma::load_a_bf16(a, a_s + kk, LD, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b[2];
      mma::load_b_bf16_nk(b, b_s + j * 8 * LD + kk, LD, g, t);
      mma::mma_bf16(s[j], a, b);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= scale;
}

// acc (16 x DH per warp) += p (16 x 8 NT, the score fragments' layout)
// . v (8 NT rows at v_s, DH columns). The tensor cores round each sum
// they return toward zero, so the tile's products go into a fresh
// fragment for every 8 columns of the output, added to acc in f32 (to
// nearest): the truncation then grows with a tile's 3 NT sums, not with
// all the sums of a long row (at sk 4096, 1,536 sums into one
// accumulator put a peaked softmax's output 2x past 2e-5 in the CPU
// emulation of tests/test_torch_tf32x3.py). SAFE splits P and V with
// the inf-safe `split<true>` (the forward's second pass), otherwise
// with the NaN-only split.
template <bool SAFE, int DT, int NT, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[DT][4],
                                           const float (&p)[NT][4],
                                           const float* v_s, int g, int t) {
  // A's column t is row 8j + 2t of v and its column t + 4 row 8j + 2t +
  // 1: the score fragment's own layout, so no shuffle; V's B rows follow
  mma::Split<4> ps[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float a[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
    ps[j] = mma::split<SAFE>(a);
  }
  const float* vr = v_s + 2 * t * LD + g;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* vj = vr + 8 * j * LD + 8 * n;
      const float b[2] = {vj[0], vj[LD]};
      mma::mma_3xtf32(part, ps[j], mma::split<SAFE>(b));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// bf16: P rounded to bf16; the output's rounding to bf16 (2^-9) dwarfs
// the truncation, so the products go straight into acc
template <bool SAFE, int DT, int NT, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[DT][4],
                                           const float (&p)[NT][4],
                                           const __nv_bfloat16* v_s, int g,
                                           int t) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    const uint32_t a[4] = {mma::pack_bf16(p[2 * j][0], p[2 * j][1]),
                           mma::pack_bf16(p[2 * j][2], p[2 * j][3]),
                           mma::pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           mma::pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      uint32_t b[2];
      mma::load_b_bf16_kn(b, v_s + 16 * j * LD + 8 * n, LD, g, t);
      mma::mma_bf16(acc[n], a, b);
    }
  }
}

}  // namespace attn
