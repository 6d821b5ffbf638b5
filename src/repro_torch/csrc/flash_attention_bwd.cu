// Flash attention backward for Hopper (sm_90a), f32 or bf16 in, f32 math.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, its
// gradient: dq, dk and dv of the Pallas TPU kernel's function (the JAX
// package differentiates it through its plain version, `attention_ref`;
// the TPU has no backward kernel), for the forward's contract: q
// pre-scaled by `scale` in f32, optional causal mask (q_pos >= k_pos)
// and sliding window (q_pos - k_pos < window, 0 = off), masked scores
// set to -1e30 (a row that sees no key averages every key, as the
// reference's softmax gives), GQA through kv head `ih / group` (dk and
// dv summed over the group's query heads), any head dim 1..512. The
// plain counterpart is the VJP of `kernels/ref.py::attention_ref`.
//
// With P = softmax(mask(q k^T * scale)) and dO the output's cotangent:
//   dV = P^T dO,  dP = dO V^T,  D = rowsum(dO o O) = rowsum(P o dP),
//   dS = P o (dP - D) where the mask lets the score through, else 0,
//   dQ = scale dS K,  dK = dS^T (q * scale).
//
// What bounds it on this card: at granite's training shape (q (4, 24,
// 512, 64), k/v (4, 8, 512, 64), causal) five products of 2 s s dh over
// the causal pairs, 8.1 GFLOP, against 31 MB read and written: the
// operations, 0.049 ms at the 165 TFLOP/s of f32-accurate 3xTF32 on the
// tensor cores. On the split-NN tower's path ((512, 4, 8, 16),
// bidirectional) the bytes, and below them launch latency.
//
// Two routes, chosen at the forward's gate:
//
// * sq > 16, dh <= 128, 16-byte aligned operands: the tensor cores
//   (`mma.sync` from mma_tf32.cuh, m16n8k8 in 3xTF32 for f32, m16n8k16
//   for bf16, whose P and dS are rounded to bf16 before their products;
//   the tiles' staging and products of attention_tiles.cuh). The
//   forward writes each row's log-sum-exp under grad, so P = exp(S -
//   lse) needs no statistics pass. Two kernels, in order, and with GQA
//   a third:
//   - `attention_bwd_dq_mma_kernel`, one block of 4 warps a (batch,
//     head) and 64 query rows (16 a warp), the forward's tile: q, dO
//     and O staged once, and a prologue forms D = rowsum(dO o O) of its
//     rows (for the second kernel too); then over the key tiles the
//     forward walks (32 keys, double-buffered by `cp.async`): S = (q
//     scale) K^T, P, dP = dO V^T, dS = P o (dP - D) where the mask lets
//     the score through, and dQ += dS K, whose products go into a fresh
//     fragment a tile added in f32 (the tensor cores truncate each sum);
//     dq = scale dQ. The three products are taken again here rather than
//     adding dQ by float atomics from the other kernel.
//   - `attention_bwd_dkv_mma_kernel`, one block of 4 warps a (batch,
//     query head) and 64 keys (16 a warp): K and V staged once; then
//     every query tile (32 rows, double-buffered with its log-sum-exps
//     and D) whose walk takes this key tile: S^T = K (q scale)^T and
//     dP^T = V dO^T with the warp's keys as rows, P^T, dS^T, dV += P^T
//     dO and dK += dS^T q in fresh fragments a step; dk = scale dK.
//     With GQA each head's share goes to f32 scratch, and
//     `attention_bwd_group_sum_kernel` adds the group's shares in
//     order: a block of a whole group would give a causal grid's first
//     key tile group times the mean block's work in a grid of one wave.
//   Both kernels' tiles leave 3 blocks an SM at dh 64 in f32 (70 KB of
//   shared memory, at most 168 registers). In f32 the products split
//   their operands more cheaply than the forward (`split3`), since the
//   splits and not the tensor cores bound the inner loops.
//   A row that sees no key (a window shorter than sq - sk allows one)
//   averages every key in the reference; its lse, -1e30 + log(sk),
//   rounds to -1e30 in f32, so the dK / dV kernel knows such a row by
//   position and gives each of its keys the weight 1 / sk (its dS is 0
//   everywhere). Masked scores get dS = 0 and weight 0; keys past sk
//   and query rows past sq (lse +inf) none. Tiles are skipped exactly
//   where the forward's `key_tiles` skips them. Special values are not
//   carried through: a NaN comes out NaN where it meets a product, an
//   inf of v or k may give NaN where the plain VJP gives +-inf (its
//   gradients are NaN in those rows and columns in either case).
// * otherwise (the split-NN tower's 8 tokens, MLA's head dim 192): f32
//   FMAs on staged tiles, which recompute the softmax statistics (this
//   route ignores the lse), two kernels in order:
//   - `attention_bwd_dq_kernel`, one block a (batch, head) and a query
//     tile of B rows. It stages q * scale and dO, forms D from dO and
//     the forward's output, walks the key tiles that some row of the
//     tile can see (all of them where a row sees no key) once for each
//     row's max and denominator (an online softmax, as the forward's),
//     writes them and D for the second kernel, then walks them again:
//     recompute P, dP = dO V^T, dS, and dQ += dS K. dQ is the block's
//     own.
//   - `attention_bwd_dkv_kernel`, one block a (batch, kv head) and a key
//     tile of B keys. It stages K and V once and walks every query head
//     of the group and every query tile that can see the key tile,
//     recomputing P from the first kernel's row statistics: dV += P^T
//     dO and dK += dS^T (q * scale). Each block owns its keys' dK and
//     dV, so the group's sum is a loop in the block, not a race between
//     blocks.
//   Tiles are skipped exactly where the forward skips them: a (query
//   tile, key tile) pair in which no pair of positions is visible adds
//   exp(-1e30 - m) = 0 to every row's softmax, unless a row of the
//   query tile sees no key at all (then every tile is walked, as in the
//   forward). A block has 256 threads as 16 x 16; a thread holds the
//   (ty + 16 i, tx + 16 j) entries of a B x B score tile and the (ty +
//   16 i, tx + 16 j) entries of a B x DH accumulator. Staged rows are
//   padded by one float, so a column read by neighbouring threads
//   spreads over the banks. B is 64 for head dims up to 128, 32 to 256,
//   16 to 512 (a block's staged tiles then stay near 130-170 KB), and 16
//   wherever sq <= 16 (the split-NN tower's 8 tokens: a 64-row tile
//   would compute 8x the rows).
//
// No float atomics in either route: every sum is taken in f32 in a
// fixed order (the row statistics and dQ over the key tiles, dK and dV
// over the group's heads and query tiles), so two runs give the same
// bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "mma_tf32.cuh"

namespace {

using mma::store;
using mma::to_f32;

constexpr int kThreads = 256;      // 16 x 16
constexpr float kNegInf = -1e30f;  // the reference's masked score
constexpr int kMaxDh = 512;

// B: the tile's rows and keys; 64 for head dims up to 128, 32 to 256, 16
// to 512, and 16 for queries of 16 rows or fewer (the split-NN tower's 8
// tokens, VFL x LLM's 16), whose rows a 64-row tile would mostly waste
constexpr int wide_tile(int dh) {
  return dh <= 128 ? 64 : (dh <= 256 ? 32 : 16);
}

template <int DH, int BT>
struct Tile {
  static constexpr int B = BT;
  static constexpr int R = B / 16;   // score rows (and columns) a thread
  static constexpr int CD = DH / 16; // head dims of a row a thread holds
  static constexpr int LD = DH + 1;  // a staged row of q, dO, k or v
  static constexpr int LP = B + 1;   // a staged row of P or dS
  // dq kernel: q, dO, k, v tiles and dS
  static constexpr int kDqSmem = (4 * B * LD + B * LP) * 4;
  // dkv kernel: k, v, q, dO tiles, P, dS and three row statistics
  static constexpr int kDkvSmem = (4 * B * LD + 2 * B * LP + 3 * B) * 4;
};

__device__ __forceinline__ bool visible(int qi, int ki, int causal,
                                        int window) {
  return (!causal || ki <= qi) && (window <= 0 || qi - ki < window);
}

// Whether query rows [i0, i1) and keys [j0, j1) hold a visible pair, or
// a row of the query tile sees no key (and so averages every key).
__device__ __forceinline__ bool tile_active(int i0, int i1, int j0, int j1,
                                            int causal, int window,
                                            int sk) {
  int lo = i0 - (j1 - 1), hi = (i1 - 1) - j0;  // q_pos - k_pos spans
  if (causal) lo = max(lo, 0);
  if (window > 0) hi = min(hi, window - 1);
  if (lo <= hi) return true;
  return window > 0 && i1 - 1 >= sk + window - 1;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// rows x dh of `src` (row stride dh) into a B x DH tile times `mul`,
// zero past the rows and the head dim
template <int DH, int BT, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int rows,
                                      int dh, float mul) {
  using Tl = Tile<DH, BT>;
  for (int e = threadIdx.x; e < Tl::B * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    dst[r * Tl::LD + d] =
        r < rows && d < dh ? to_f32(src[(int64_t)r * dh + d]) * mul : 0.f;
  }
}

// s[i][j] = a[ty + 16 i] . b[tx + 16 j] over the tiles' DH columns
template <int DH, int BT>
__device__ __forceinline__ void products(const float* a, const float* b,
                                         float (&s)[Tile<DH, BT>::R]
                                                   [Tile<DH, BT>::R],
                                         int ty, int tx) {
  using Tl = Tile<DH, BT>;
#pragma unroll
  for (int i = 0; i < Tl::R; ++i)
#pragma unroll
    for (int j = 0; j < Tl::R; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float av[Tl::R], bv[Tl::R];
#pragma unroll
    for (int i = 0; i < Tl::R; ++i) av[i] = a[(ty + 16 * i) * Tl::LD + d];
#pragma unroll
    for (int j = 0; j < Tl::R; ++j) bv[j] = b[(tx + 16 * j) * Tl::LD + d];
#pragma unroll
    for (int i = 0; i < Tl::R; ++i)
#pragma unroll
      for (int j = 0; j < Tl::R; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// stats: [3][b * h * sq] f32, each row's max, 1 / denominator and D
template <int DH, int BT, typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        float* __restrict__ stats, int h, int kvh, int sq,
                        int sk, int dh, int causal, int window, float scale,
                        int64_t n_rows) {
  using Tl = Tile<DH, BT>;
  constexpr int B = Tl::B, R = Tl::R, CD = Tl::CD, LD = Tl::LD,
                LP = Tl::LP;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + B * LD;
  float* ks = dos + B * LD;
  float* vs = ks + B * LD;
  float* dss = vs + B * LD;

  const int bh = blockIdx.x, bi = bh / h, head = bh % h;
  const int kh = head / (h / kvh);
  const int i0 = blockIdx.y * B, rows = min(B, sq - i0), i1 = i0 + rows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t qoff = ((int64_t)bh * sq + i0) * dh;
  const int64_t kvoff = ((int64_t)bi * kvh + kh) * sk * dh;

  stage<DH, BT>(qs, q + qoff, rows, dh, scale);
  stage<DH, BT>(dos, dout + qoff, rows, dh, 1.f);
  // D = rowsum(dO o O), a row over the 16 lanes of its ty
  float dr[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    float acc = 0.f;
    if (r < rows)
      for (int d = tx; d < dh; d += 16)
        acc = fmaf(to_f32(dout[qoff + (int64_t)r * dh + d]),
                   to_f32(o[qoff + (int64_t)r * dh + d]), acc);
    dr[i] = sum16(acc);
  }

  // pass 1: each row's max and denominator over the keys it can see
  const int k_tiles = (sk + B - 1) / B;
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  float s[R][R], dp[R][R];
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int j0 = kt * B, cols = min(B, sk - j0);
    if (!tile_active(i0, i1, j0, j0 + cols, causal, window, sk)) continue;
    __syncthreads();
    stage<DH, BT>(ks, k + kvoff + (int64_t)j0 * dh, cols, dh, 1.f);
    __syncthreads();
    products<DH, BT>(qs, ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = i0 + ty + 16 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j;
        if (c < cols) {
          if (!visible(qi, j0 + c, causal, window)) s[i][j] = kNegInf;
          tmax = fmaxf(tmax, s[i][j]);
        }
      }
      // the tile's key j0 is a column of every row: mn is finite
      const float mn = fmaxf(m[i], max16(tmax));
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (tx + 16 * j < cols) part += expf(s[i][j] - mn);
      l[i] = l[i] * expf(m[i] - mn) + sum16(part);
      m[i] = mn;
    }
  }
  float linv[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    linv[i] = 1.f / l[i];
    const int r = ty + 16 * i;
    if (tx == 0 && r < rows) {
      const int64_t row = (int64_t)bh * sq + i0 + r;
      stats[row] = m[i];
      stats[n_rows + row] = linv[i];
      stats[2 * n_rows + row] = dr[i];
    }
  }

  // pass 2: dQ = scale dS K over the same key tiles
  float acc[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jd = 0; jd < CD; ++jd) acc[i][jd] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int j0 = kt * B, cols = min(B, sk - j0);
    if (!tile_active(i0, i1, j0, j0 + cols, causal, window, sk)) continue;
    __syncthreads();
    stage<DH, BT>(ks, k + kvoff + (int64_t)j0 * dh, cols, dh, 1.f);
    stage<DH, BT>(vs, v + kvoff + (int64_t)j0 * dh, cols, dh, 1.f);
    __syncthreads();
    products<DH, BT>(qs, ks, s, ty, tx);
    products<DH, BT>(dos, vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = i0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (c < cols && visible(qi, j0 + c, causal, window)) {
          const float p = expf(s[i][j] - m[i]) * linv[i];
          ds = p * (dp[i][j] - dr[i]);
        }
        dss[(ty + 16 * i) * LP + c] = ds;
      }
    }
    __syncthreads();
    for (int c = 0; c < cols; ++c) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float w = dss[(ty + 16 * i) * LP + c];
#pragma unroll
        for (int jd = 0; jd < CD; ++jd)
          acc[i][jd] = fmaf(w, ks[c * LD + tx + 16 * jd], acc[i][jd]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int jd = 0; jd < CD; ++jd) {
      const int d = tx + 16 * jd;
      if (d < dh) store(dq + qoff + (int64_t)r * dh + d, acc[i][jd] * scale);
    }
  }
}

template <int DH, int BT, typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const T* __restrict__ dout,
                         const float* __restrict__ stats,
                         T* __restrict__ dk, T* __restrict__ dv, int h,
                         int kvh, int sq, int sk, int dh, int causal,
                         int window, float scale, int64_t n_rows) {
  using Tl = Tile<DH, BT>;
  constexpr int B = Tl::B, R = Tl::R, CD = Tl::CD, LD = Tl::LD,
                LP = Tl::LP;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + B * LD;
  float* qs = vs + B * LD;
  float* dos = qs + B * LD;
  float* ps = dos + B * LD;
  float* dss = ps + B * LP;
  float* rm = dss + B * LP;
  float* rl = rm + B;
  float* rd = rl + B;

  const int bk = blockIdx.x, bi = bk / kvh, kh = bk % kvh;
  const int group = h / kvh;
  const int j0 = blockIdx.y * B, cols = min(B, sk - j0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t kvoff = ((int64_t)bk * sk + j0) * dh;

  stage<DH, BT>(ks, k + kvoff, cols, dh, 1.f);
  stage<DH, BT>(vs, v + kvoff, cols, dh, 1.f);
  float acc_k[R][CD], acc_v[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jd = 0; jd < CD; ++jd) acc_k[i][jd] = acc_v[i][jd] = 0.f;

  const int q_tiles = (sq + B - 1) / B;
  float s[R][R], dp[R][R];
  for (int g = 0; g < group; ++g) {
    const int bh = bi * h + kh * group + g;
    for (int qt = 0; qt < q_tiles; ++qt) {
      const int i0 = qt * B, rows = min(B, sq - i0);
      if (!tile_active(i0, i0 + rows, j0, j0 + cols, causal, window, sk))
        continue;
      __syncthreads();
      const int64_t qoff = ((int64_t)bh * sq + i0) * dh;
      stage<DH, BT>(qs, q + qoff, rows, dh, scale);
      stage<DH, BT>(dos, dout + qoff, rows, dh, 1.f);
      for (int r = threadIdx.x; r < B; r += kThreads) {
        const int64_t row = (int64_t)bh * sq + i0 + r;
        // a padding row gets weight 0: P = exp(.) * 0
        rm[r] = r < rows ? stats[row] : 0.f;
        rl[r] = r < rows ? stats[n_rows + row] : 0.f;
        rd[r] = r < rows ? stats[2 * n_rows + row] : 0.f;
      }
      __syncthreads();
      products<DH, BT>(qs, ks, s, ty, tx);
      products<DH, BT>(dos, vs, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i, qi = i0 + r;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int c = tx + 16 * j;
          float p = 0.f, ds = 0.f;
          if (r < rows && c < cols) {
            const bool vis = visible(qi, j0 + c, causal, window);
            p = expf((vis ? s[i][j] : kNegInf) - rm[r]) * rl[r];
            if (vis) ds = p * (dp[i][j] - rd[r]);
          }
          ps[r * LP + c] = p;
          dss[r * LP + c] = ds;
        }
      }
      __syncthreads();
      for (int r = 0; r < rows; ++r) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float pw = ps[r * LP + ty + 16 * i];
          const float dw = dss[r * LP + ty + 16 * i];
#pragma unroll
          for (int jd = 0; jd < CD; ++jd) {
            const int d = tx + 16 * jd;
            acc_v[i][jd] = fmaf(pw, dos[r * LD + d], acc_v[i][jd]);
            acc_k[i][jd] = fmaf(dw, qs[r * LD + d], acc_k[i][jd]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = ty + 16 * i;
    if (c >= cols) continue;
#pragma unroll
    for (int jd = 0; jd < CD; ++jd) {
      const int d = tx + 16 * jd;
      if (d < dh) {
        store(dk + kvoff + (int64_t)c * dh + d, acc_k[i][jd]);
        store(dv + kvoff + (int64_t)c * dh + d, acc_v[i][jd]);
      }
    }
  }
}

template <int DH, int BT, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* stats, int b, int h, int kvh, int sq,
                   int sk, int dh, int causal, int window, float scale,
                   cudaStream_t stream) {
  using Tl = Tile<DH, BT>;
  static bool done_dq[64] = {}, done_dkv[64] = {};
  cudaError_t err = mma::allow_smem(attention_bwd_dq_kernel<DH, BT, T>,
                                    Tl::kDqSmem, done_dq);
  if (err != cudaSuccess) return err;
  err = mma::allow_smem(attention_bwd_dkv_kernel<DH, BT, T>, Tl::kDkvSmem,
                        done_dkv);
  if (err != cudaSuccess) return err;
  const int q_tiles = (sq + Tl::B - 1) / Tl::B;
  const int k_tiles = (sk + Tl::B - 1) / Tl::B;
  if (q_tiles > 65535 || k_tiles > 65535) return cudaErrorInvalidValue;
  const int64_t n_rows = (int64_t)b * h * sq;
  attention_bwd_dq_kernel<DH, BT, T>
      <<<dim3(b * h, q_tiles), kThreads, Tl::kDqSmem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(o),
          static_cast<const T*>(dout), static_cast<T*>(dq), stats, h, kvh,
          sq, sk, dh, causal, window, scale, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<DH, BT, T>
      <<<dim3(b * kvh, k_tiles), kThreads, Tl::kDkvSmem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), stats,
          static_cast<T*>(dk), static_cast<T*>(dv), h, kvh, sq, sk, dh,
          causal, window, scale, n_rows);
  return cudaGetLastError();
}

// Each dh runs in the narrowest compiled width DH >= dh, its columns past
// dh zero (so they add nothing to a product) and never stored.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, void* dq, void* dk,
                     void* dv, float* stats, int b, int h, int kvh, int sq,
                     int sk, int dh, int causal, int window, float scale,
                     cudaStream_t st) {
#define REPRO_ATT_BWD(DH)                                                  \
  if (dh <= DH) {                                                          \
    if (sq <= 16)                                                          \
      return launch<DH, 16, T>(q, k, v, o, dout, dq, dk, dv, stats, b, h,  \
                               kvh, sq, sk, dh, causal, window, scale, st); \
    return launch<DH, wide_tile(DH), T>(q, k, v, o, dout, dq, dk, dv,      \
                                        stats, b, h, kvh, sq, sk, dh,      \
                                        causal, window, scale, st);        \
  }
  REPRO_ATT_BWD(16);
  REPRO_ATT_BWD(32);
  REPRO_ATT_BWD(64);
  REPRO_ATT_BWD(128);
  REPRO_ATT_BWD(256);
  REPRO_ATT_BWD(kMaxDh);
#undef REPRO_ATT_BWD
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------ tensor-core route
// sq > 16 and dh <= 128 with 16-byte aligned operands (the forward's
// tensor-core gate): `attention_bwd_dq_mma_kernel`, then
// `attention_bwd_dkv_mma_kernel`, both 4 warps on `mma.sync`.
constexpr int kTcThreads = attn::kTileThreads;  // 4 warps
constexpr int kMaxMmaDh = 128;

template <int DH, typename T>
struct MmaBwdTile {
  static constexpr int kLd = DH + 16 / static_cast<int>(sizeof(T));
  // dQ kernel: 64 query rows a block (16 a warp), key tiles of BK
  static constexpr int kBQ = 64;
  static constexpr int kBK = 32;
  static constexpr int kDqSmem =
      (2 * kBQ + 4 * kBK) * kLd * static_cast<int>(sizeof(T));
  // the prologue stages O in the key ring's second slot
  static_assert(2 * kBK >= kBQ, "O's tile must fit a slot of the ring");
  // dK / dV kernel: 64 keys a block (16 a warp), query tiles of BQKV
  static constexpr int kBKV = 64;
  static constexpr int kBQKV = 32;
  static constexpr int kDkvSmem =
      (2 * kBKV + 4 * kBQKV) * kLd * static_cast<int>(sizeof(T)) +
      4 * kBQKV * static_cast<int>(sizeof(float));
  static_assert(DH % 16 == 0, "head dim must be whole k-steps");
  // blocks of the larger kernel that an SM's shared memory holds (up to
  // 3: 12 warps an SM hide more of the loads' and products' latency),
  // which bounds the registers a thread may take
  static constexpr int kSmemMax = kDqSmem > kDkvSmem ? kDqSmem : kDkvSmem;
  static constexpr int kFit = (228 * 1024) / (kSmemMax + 1024);
  static constexpr int kBlocks = kFit > 3 ? 3 : (kFit < 1 ? 1 : kFit);
};

// The backward's f32 products: attention_tiles.cuh's `scores` and
// `accumulate` with a cheaper 3xTF32 split. The inner loops split every
// operand they load, and at 7 instructions an element (the forward's
// split, which keeps NaN and rounds both parts) the splits and not the
// tensor cores set the pace; here big is x rounded to TF32 by an integer
// add and mask and small = x - big, exact in f32, whose 13 low bits the
// tensor cores drop: 3 instructions, x - big - small below 2^-21 |x|
// (2^-23 with small rounded). A NaN still comes out NaN (it lands in
// small); an inf gives NaN, as the route's header says.
template <int N>
__device__ __forceinline__ mma::Split<N> split3(const float (&x)[N]) {
  mma::Split<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s.big[i] = mma::round_tf32(x[i]);
    s.small[i] = __float_as_uint(x[i] - __uint_as_float(s.big[i]));
  }
  return s;
}

// `asm volatile` keeps the `mma`s in program order, and each of a
// product's three passes waits for the one before it in the same
// accumulator; so each pass is issued for every independent accumulator
// before the next (the same sums in the same order as mma_3xtf32's).
template <int DH, int NT, int LD>
__device__ __forceinline__ void bscores(float (&s)[NT][4], const float* a_s,
                                        const float* b_s, int g, int t,
                                        float scale) {
#pragma unroll
  for (int kk = 0; kk < DH; kk += 8) {
    float a[4];
    mma::load_a_tf32(a, a_s + kk, LD, g, t, scale);
    const mma::Split<4> as = split3(a);
    mma::Split<2> bs[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float b[2];
      mma::load_b_tf32_nk(b, b_s + j * 8 * LD + kk, LD, g, t);
      bs[j] = split3(b);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) mma::mma_tf32(s[j], as.small, bs[j].big);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma::mma_tf32(s[j], as.big, bs[j].small);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma::mma_tf32(s[j], as.big, bs[j].big);
  }
}

template <int DH, int NT, int LD>
__device__ __forceinline__ void bscores(float (&s)[NT][4],
                                        const __nv_bfloat16* a_s,
                                        const __nv_bfloat16* b_s, int g,
                                        int t, float scale) {
  attn::scores<DH, NT, LD>(s, a_s, b_s, g, t, scale);
}

// fresh partials a call, NG output column tiles at a time
template <int DT, int NT, int LD>
__device__ __forceinline__ void baccumulate(float (&acc)[DT][4],
                                            const float (&p)[NT][4],
                                            const float* v_s, int g, int t) {
  constexpr int NG = DT % 4 == 0 ? 4 : 2;
  mma::Split<4> ps[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float a[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
    ps[j] = split3(a);
  }
  const float* vr = v_s + 2 * t * LD + g;
#pragma unroll
  for (int n0 = 0; n0 < DT; n0 += NG) {
    float part[NG][4];
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mma::Split<2> bs[NG];
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const float* vj = vr + 8 * j * LD + 8 * (n0 + i);
        const float b[2] = {vj[0], vj[LD]};
        bs[i] = split3(b);
      }
#pragma unroll
      for (int i = 0; i < NG; ++i)
        mma::mma_tf32(part[i], ps[j].small, bs[i].big);
#pragma unroll
      for (int i = 0; i < NG; ++i)
        mma::mma_tf32(part[i], ps[j].big, bs[i].small);
#pragma unroll
      for (int i = 0; i < NG; ++i)
        mma::mma_tf32(part[i], ps[j].big, bs[i].big);
    }
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + i][e] += part[i][e];
  }
}

template <int DT, int NT, int LD>
__device__ __forceinline__ void baccumulate(float (&acc)[DT][4],
                                            const float (&p)[NT][4],
                                            const __nv_bfloat16* v_s, int g,
                                            int t) {
  attn::accumulate<false, DT, NT, LD>(acc, p, v_s, g, t);
}

// dq = scale dS K over the key tiles the forward walks. grid: (b * h,
// query tiles), blockIdx.y = 0 the last query tile. Also writes D =
// rowsum(dO o O) of its rows to `dvec`, for the dK / dV kernel after it.
template <int DH, typename T>
__global__ void __launch_bounds__(kTcThreads, (MmaBwdTile<DH, T>::kBlocks))
attention_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ o,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ dvec, T* __restrict__ dq,
                            int h, int kvh, int sq, int sk, int dh,
                            int causal, int window, float scale) {
  using Tl = MmaBwdTile<DH, T>;
  constexpr int BQ = Tl::kBQ, BK = Tl::kBK, LD = Tl::kLd;
  constexpr int NT = BK / 8;   // 8-key column tiles of the scores
  constexpr int DT = DH / 8;   // 8-dim column tiles of dq
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* qs = reinterpret_cast<T*>(tc_smem);  // [BQ][LD]
  T* dos = qs + BQ * LD;                // [BQ][LD]
  T* ring = dos + BQ * LD;              // [2][K, V][BK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int pair = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = pair / h;
  const int kh = (pair % h) / (h / kvh);
  const int64_t qoff = (int64_t)pair * sq * dh;
  const int64_t kv_off = ((int64_t)b * kvh + kh) * sk * dh;
  const T* kg = k + kv_off;
  const T* vg = v + kv_off;
  const int q_last = min(q0 + BQ, sq) - 1;
  int t_lo, t_hi;
  attn::key_tiles(q0, BQ, sq, sk, causal, window, BK, t_lo, t_hi);

  // q, dO, and O in the ring's second slot (free until the key loop's
  // first prefetch), then the first key tile in its first slot
  T* os = ring + 2 * BK * LD;
  attn::stage<DH, LD>(qs, q + qoff, q0, BQ, sq, dh);
  attn::stage<DH, LD>(dos, dout + qoff, q0, BQ, sq, dh);
  attn::stage<DH, LD>(os, o + qoff, q0, BQ, sq, dh);
  mma::cp_async_commit();
  attn::stage<DH, LD>(ring, kg, t_lo * BK, BK, sk, dh);
  attn::stage<DH, LD>(ring + BK * LD, vg, t_lo * BK, BK, sk, dh);
  mma::cp_async_commit();

  const int wrow = warp * 16;
  const int row_g = q0 + wrow + g;
  // rows g and g + 8 of the warp: the log-sum-exp (+inf past sq, so that
  // P = 0 there) and D
  float lr[2], dr[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_g + 8 * r;
    lr[r] = qi < sq ? lse[(int64_t)pair * sq + qi] : INFINITY;
  }
  mma::cp_async_wait<1>();  // q, dO and O have landed
  __syncthreads();
  // D of the warp's 16 rows, a row over the warp's lanes: each lane's
  // columns in order, then a butterfly (the same order every run; rows
  // past sq are zero)
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = wrow + i;
    float part = 0.f;
#pragma unroll
    for (int d = lane; d < DH; d += 32)
      part = fmaf(to_f32(dos[r * LD + d]), to_f32(os[r * LD + d]), part);
#pragma unroll
    for (int off = 16; off; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (i == g) dr[0] = part;
    if (i == g + 8) dr[1] = part;
    if (lane == 0 && q0 + r < sq) dvec[(int64_t)pair * sq + q0 + r] = part;
  }
  __syncthreads();  // O's slot is the key loop's to fill

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int buf = (kt - t_lo) & 1;
    const int k0 = kt * BK;
    // the other buffer was last read before the previous iteration's
    // closing barrier
    if (kt + 1 < t_hi) {
      T* next = ring + (buf ^ 1) * 2 * BK * LD;
      attn::stage<DH, LD>(next, kg, k0 + BK, BK, sk, dh);
      attn::stage<DH, LD>(next + BK * LD, vg, k0 + BK, BK, sk, dh);
    }
    mma::cp_async_commit();   // an empty group on the last tile
    mma::cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const T* kb = ring + buf * 2 * BK * LD;
    const T* vb = kb + BK * LD;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    bscores<DH, NT, LD>(s, qs + wrow * LD, kb, g, t, scale);
    bscores<DH, NT, LD>(dp, dos + wrow * LD, vb, g, t, 1.f);
    // the mask, where some key of the tile is hidden from some row: dS =
    // 0 there (and past sk)
    const bool whole = k0 + BK <= sk && (!causal || k0 + BK - 1 <= q0) &&
                       (!window || q_last - k0 < window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float ds = expf(s[j][e] - lr[r]) * (dp[j][e] - dr[r]);
        if (!whole) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const int qi = row_g + 8 * r;
          if (kp >= sk || (causal && kp > qi) ||
              (window && qi - kp >= window))
            ds = 0.f;
        }
        s[j][e] = ds;
      }
    baccumulate<DT, NT, LD>(acc, s, kb, g, t);
    __syncthreads();
  }

  T* dqg = dq + qoff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_g + 8 * r;
    if (qi >= sq) continue;
    T* row = dqg + (int64_t)qi * dh + 2 * t;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const float x0 = acc[n][2 * r] * scale, x1 = acc[n][2 * r + 1] * scale;
      const int col = 8 * n + 2 * t;
      if (dh % 2 == 0 && col + 1 < dh) {
        mma::store2(row + 8 * n, x0, x1);
      } else {
        if (col < dh) store(row + 8 * n, x0);
        if (col + 1 < dh) store(row + 8 * n + 1, x1);
      }
    }
  }
}

// dk = scale dS^T q and dv = P^T dO of one key tile and one query
// head, summed over the query tiles that walk the key tile in order.
// grid: (b * h, key tiles), key tile 0 first (under a causal mask the
// longest). Reads the dQ kernel's D. Where the kv group has one head the
// block writes dk and dv; otherwise each head's share goes to f32
// scratch (pk, pv: (b, h, sk, dh)), which
// `attention_bwd_group_sum_kernel` adds over the group in order: blocks
// of a whole group would leave a causal grid's key tile 0 with group
// times the work of the mean block, one wave long.
template <int DH, typename T>
__global__ void __launch_bounds__(kTcThreads, (MmaBwdTile<DH, T>::kBlocks))
attention_bwd_dkv_mma_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dvec,
                             T* __restrict__ dk, T* __restrict__ dv,
                             float* __restrict__ pk, float* __restrict__ pv,
                             int h, int kvh, int sq, int sk, int dh,
                             int causal, int window, float scale) {
  using Tl = MmaBwdTile<DH, T>;
  constexpr int BKV = Tl::kBKV, BQ = Tl::kBQKV, LD = Tl::kLd;
  constexpr int NQ = BQ / 8;   // 8-query column tiles of S^T
  constexpr int DT = DH / 8;   // 8-dim column tiles of dk and dv
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* ks = reinterpret_cast<T*>(tc_smem);  // [BKV][LD]
  T* vs = ks + BKV * LD;                // [BKV][LD]
  T* qs = vs + BKV * LD;                // [2][BQ][LD]
  T* dos = qs + 2 * BQ * LD;            // [2][BQ][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ]
  float* dd = ls + 2 * BQ;                                  // [2][BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t bh = blockIdx.x;
  const int b = blockIdx.x / h;
  const int kh = (blockIdx.x % h) / (h / kvh);
  const int kt = blockIdx.y, k0 = kt * BKV;
  const int64_t kv_off = ((int64_t)b * kvh + kh) * sk * dh;
  const int q_tiles = (sq + BQ - 1) / BQ;
  const int wrow = warp * 16;

  attn::stage<DH, LD>(ks, k + kv_off, k0, BKV, sk, dh);
  attn::stage<DH, LD>(vs, v + kv_off, k0, BKV, sk, dh);

  // whether query tile qt walks this key tile (the forward's rule at
  // these tiles), and the first such tile from qt on
  auto walks = [&](int qt) {
    int lo, hi;
    attn::key_tiles(qt * BQ, BQ, sq, sk, causal, window, BKV, lo, hi);
    return kt >= lo && kt < hi;
  };
  auto next_qt = [&](int qt) {
    while (qt < q_tiles && !walks(qt)) ++qt;
    return qt;
  };
  // a step's q and dO tiles, log-sum-exps (+inf past sq: P = 0) and D
  auto load = [&](int slot, int qt) {
    const int i0 = qt * BQ;
    attn::stage<DH, LD>(qs + slot * BQ * LD, q + bh * sq * dh, i0, BQ, sq,
                        dh);
    attn::stage<DH, LD>(dos + slot * BQ * LD, dout + bh * sq * dh, i0, BQ,
                        sq, dh);
    for (int r = threadIdx.x; r < BQ; r += kTcThreads) {
      const int qi = i0 + r;
      ls[slot * BQ + r] = qi < sq ? lse[bh * sq + qi] : INFINITY;
      dd[slot * BQ + r] = qi < sq ? dvec[bh * sq + qi] : 0.f;
    }
  };
  int qt = next_qt(0);
  if (qt < q_tiles) load(0, qt);
  mma::cp_async_commit();

  float acc_k[DT][4], acc_v[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const float inv_sk = 1.f / static_cast<float>(sk);
  for (int step = 0; qt < q_tiles; ++step) {
    const int buf = step & 1;
    const int nqt = next_qt(qt + 1);
    // the other slot was last read before the previous step's closing
    // barrier
    if (nqt < q_tiles) load(buf ^ 1, nqt);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // this step's copies (and K, V) have landed
    __syncthreads();

    const int q0 = qt * BQ, q_last = min(q0 + BQ, sq) - 1;
    const T* qb = qs + buf * BQ * LD;
    const T* db = dos + buf * BQ * LD;
    const float* lb = ls + buf * BQ;
    const float* ddb = dd + buf * BQ;
    // S^T and dP^T: the warp's 16 keys x the tile's BQ queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    bscores<DH, NQ, LD>(s, ks + wrow * LD, qb, g, t, scale);
    bscores<DH, NQ, LD>(dp, vs + wrow * LD, db, g, t, 1.f);
    const bool whole = k0 + BKV <= sk && (!causal || k0 + BKV - 1 <= q0) &&
                       (!window || q_last - k0 < window);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);  // the query in the tile
        float p = expf(s[j][e] - lb[c]);
        float ds = p * (dp[j][e] - ddb[c]);
        if (!whole) {
          const int kp = k0 + wrow + g + 8 * (e >> 1);
          const int qi = q0 + c;
          if (kp >= sk) {
            p = ds = 0.f;
          } else if ((causal && kp > qi) || (window && qi - kp >= window)) {
            // a hidden key: weight 0, or 1 / sk in a row that sees no
            // key (all its scores are -1e30 and its lse rounds to -1e30
            // in f32, so exp(S - lse) would give 1)
            p = window && qi < sq && qi - (sk - 1) >= window ? inv_sk : 0.f;
            ds = 0.f;
          }
        }
        s[j][e] = p;
        dp[j][e] = ds;
      }
    baccumulate<DT, NQ, LD>(acc_v, s, db, g, t);
    baccumulate<DT, NQ, LD>(acc_k, dp, qb, g, t);
    __syncthreads();
    qt = nqt;
  }
  mma::cp_async_wait<0>();  // K and V, where no query tile walked them

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + wrow + g + 8 * r;
    if (kp >= sk) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const float x[4] = {acc_k[n][2 * r] * scale,
                          acc_k[n][2 * r + 1] * scale, acc_v[n][2 * r],
                          acc_v[n][2 * r + 1]};
      const int col = 8 * n + 2 * t;
      if (pk != nullptr) {
        const int64_t at = (bh * sk + kp) * dh + col;
        if (dh % 2 == 0 && col + 1 < dh) {
          mma::store2(pk + at, x[0], x[1]);
          mma::store2(pv + at, x[2], x[3]);
        } else {
          if (col < dh) pk[at] = x[0], pv[at] = x[2];
          if (col + 1 < dh) pk[at + 1] = x[1], pv[at + 1] = x[3];
        }
        continue;
      }
      T* krow = dk + kv_off + (int64_t)kp * dh + col;
      T* vrow = dv + kv_off + (int64_t)kp * dh + col;
      if (dh % 2 == 0 && col + 1 < dh) {
        mma::store2(krow, x[0], x[1]);
        mma::store2(vrow, x[2], x[3]);
      } else {
        if (col < dh) store(krow, x[0]), store(vrow, x[2]);
        if (col + 1 < dh) store(krow + 1, x[1]), store(vrow + 1, x[3]);
      }
    }
  }
}

// dk and dv of a GQA group: each head's share from the dK / dV kernel's
// scratch, added over the group's heads in order. One thread an element
// of dk and of dv; memory bounds it (at granite's training shape 25 MB
// read, 8 MB written).
template <typename T>
__global__ void __launch_bounds__(256)
attention_bwd_group_sum_kernel(const float* __restrict__ pk,
                               const float* __restrict__ pv,
                               T* __restrict__ dk, T* __restrict__ dv,
                               int group, int64_t per_head, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t src = (i / per_head) * group * per_head + i % per_head;
    float sk_ = 0.f, sv = 0.f;
    for (int j = 0; j < group; ++j) {
      sk_ += pk[src + j * per_head];
      sv += pv[src + j * per_head];
    }
    store(dk + i, sk_);
    store(dv + i, sv);
  }
}

template <int DH, typename T>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* dvec, float* part, void* dq, void* dk,
                       void* dv, int b, int h, int kvh, int sq, int sk,
                       int dh, int causal, int window, float scale,
                       cudaStream_t stream) {
  using Tl = MmaBwdTile<DH, T>;
  static bool done_dq[64] = {}, done_dkv[64] = {};
  cudaError_t err = mma::allow_smem(attention_bwd_dq_mma_kernel<DH, T>,
                                    Tl::kDqSmem, done_dq);
  if (err != cudaSuccess) return err;
  err = mma::allow_smem(attention_bwd_dkv_mma_kernel<DH, T>, Tl::kDkvSmem,
                        done_dkv);
  if (err != cudaSuccess) return err;
  const int q_tiles = (sq + Tl::kBQ - 1) / Tl::kBQ;
  const int k_tiles = (sk + Tl::kBKV - 1) / Tl::kBKV;
  if (q_tiles > 65535 || k_tiles > 65535) return cudaErrorInvalidValue;
  attention_bwd_dq_mma_kernel<DH, T>
      <<<dim3(b * h, q_tiles), kTcThreads, Tl::kDqSmem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(o),
          static_cast<const T*>(dout), lse, dvec, static_cast<T*>(dq), h,
          kvh, sq, sk, dh, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // one head a block: the group's shares to scratch where it has more
  const int group = h / kvh;
  const int64_t per_head = (int64_t)sk * dh;
  float* pk = group > 1 ? part : nullptr;
  float* pv = group > 1 ? part + (int64_t)b * h * per_head : nullptr;
  attention_bwd_dkv_mma_kernel<DH, T>
      <<<dim3(b * h, k_tiles), kTcThreads, Tl::kDkvSmem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, dvec,
          static_cast<T*>(dk), static_cast<T*>(dv), pk, pv, h, kvh, sq, sk,
          dh, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || group == 1) return err;
  const int64_t n = (int64_t)b * kvh * per_head;
  const int64_t blocks = (n + 255) / 256;
  attention_bwd_group_sum_kernel<T>
      <<<blocks < 1056 ? blocks : 1056, 256, 0, stream>>>(
          pk, pv, static_cast<T*>(dk), static_cast<T*>(dv), group, per_head,
          n);
  return cudaGetLastError();
}

// Each dh runs in the narrowest compiled width DH >= dh (16, 32, 64, 80,
// 128: the forward's), its columns past dh zero and never stored.
template <typename T>
cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         float* dvec, float* part, void* dq, void* dk,
                         void* dv, int b, int h, int kvh, int sq, int sk,
                         int dh, int causal, int window, float scale,
                         cudaStream_t st) {
#define REPRO_ATT_BWD_MMA(DH)                                              \
  if (dh <= DH)                                                            \
  return launch_mma<DH, T>(q, k, v, o, dout, lse, dvec, part, dq, dk, dv,  \
                           b, h, kvh, sq, sk, dh, causal, window, scale, st)
  REPRO_ATT_BWD_MMA(16);
  REPRO_ATT_BWD_MMA(32);
  REPRO_ATT_BWD_MMA(64);
  REPRO_ATT_BWD_MMA(80);
  REPRO_ATT_BWD_MMA(kMaxMmaDh);
#undef REPRO_ATT_BWD_MMA
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, o, dout, dq: (b, h, sq, dh); k, v,
// dk, dv: (b, kvh, sk, dh); all contiguous. stats: 3 * b * h * sq f32 of
// scratch. Returns the launches' cudaError_t.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats, int b,
    int h, int kvh, int sq, int sk, int dh, int dtype, int causal,
    int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || h <= 0 || kvh <= 0 || h % kvh || sq <= 0 || sk <= 0 ||
      dh <= 0 || dh > kMaxDh)
    return cudaErrorInvalidValue;
  float* ws = static_cast<float*>(stats);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, dout, dq, dk, dv, ws, b, h, kvh, sq,
                           sk, dh, causal, window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, ws, b, h,
                                   kvh, sq, sk, dh, causal, window, scale,
                                   st);
  return cudaErrorInvalidValue;
}

// The tensor-core route (sq > 16, dh <= 128, 16-byte aligned operands;
// the forward's gate). lse: the forward's b * h * sq log-sum-exps; dvec:
// b * h * sq f32 of scratch for D; part: where h > kvh, 2 * b * h * sk *
// dh f32 of scratch for each head's share of dk and dv (else unused).
// Other arguments as above.
extern "C" int repro_flash_attention_bwd_mma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dvec, void* part, void* dq,
    void* dk, void* dv, int b, int h, int kvh, int sq, int sk, int dh,
    int dtype, int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || h <= 0 || kvh <= 0 || h % kvh || sq <= 16 || sk <= 0 ||
      dh <= 0 || dh > kMaxMmaDh)
    return cudaErrorInvalidValue;
  if (h > kvh && part == nullptr) return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(dvec);
  float* pt = static_cast<float*>(part);
  if (dtype == 0)
    return dispatch_mma<float>(q, k, v, o, dout, l, d, pt, dq, dk, dv, b, h,
                               kvh, sq, sk, dh, causal, window, scale, st);
  if (dtype == 1)
    return dispatch_mma<__nv_bfloat16>(q, k, v, o, dout, l, d, pt, dq, dk,
                                       dv, b, h, kvh, sq, sk, dh, causal,
                                       window, scale, st);
  return cudaErrorInvalidValue;
}
