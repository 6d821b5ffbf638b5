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
// tensor cores (0.12 ms at the 67 TFLOP/s of the f32 FMAs this kernel
// runs).
//
// The design is the simple one, f32 FMAs on staged tiles, no tensor
// cores (a later redesign's work). The forward writes no log-sum-exp,
// so the backward recomputes it: two kernels on the stream, in order.
//
// * `attention_bwd_dq_kernel`, one block a (batch, head) and a query
//   tile of B rows. It stages q * scale and dO, forms D from dO and the
//   forward's output, walks the key tiles that some row of the tile can
//   see (all of them where a row sees no key) once for each row's max
//   and denominator (an online softmax, as the forward's), writes them
//   and D for the second kernel, then walks them again: recompute P,
//   dP = dO V^T, dS, and dQ += dS K. dQ is the block's own.
// * `attention_bwd_dkv_kernel`, one block a (batch, kv head) and a key
//   tile of B keys. It stages K and V once and walks every query head
//   of the group and every query tile that can see the key tile,
//   recomputing P from the first kernel's row statistics: dV += P^T dO
//   and dK += dS^T (q * scale). Each block owns its keys' dK and dV, so
//   the group's sum is a loop in the block, not a race between blocks.
//
// Tiles are skipped exactly where the forward skips them: a (query
// tile, key tile) pair in which no pair of positions is visible adds
// exp(-1e30 - m) = 0 to every row's softmax, unless a row of the query
// tile sees no key at all (then every tile is walked, as in the
// forward). A block has 256 threads as 16 x 16; a thread holds the
// (ty + 16 i, tx + 16 j) entries of a B x B score tile and the (ty +
// 16 i, tx + 16 j) entries of a B x DH accumulator. Staged rows are
// padded by one float, so a column read by neighbouring threads spreads
// over the banks. B is 64 for head dims up to 128, 32 to 256, 16 to 512
// (a block's staged tiles then stay near 130-170 KB). Every sum is taken
// in f32 in a fixed order: the row statistics over the key tiles, dQ
// over the key tiles, dK and dV over the group's heads and query tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using mma::store;
using mma::to_f32;

constexpr int kThreads = 256;      // 16 x 16
constexpr float kNegInf = -1e30f;  // the reference's masked score
constexpr int kMaxDh = 512;

template <int DH>
struct Tile {
  static constexpr int B = DH <= 128 ? 64 : (DH <= 256 ? 32 : 16);
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
template <int DH, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int rows,
                                      int dh, float mul) {
  using Tl = Tile<DH>;
  for (int e = threadIdx.x; e < Tl::B * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    dst[r * Tl::LD + d] =
        r < rows && d < dh ? to_f32(src[(int64_t)r * dh + d]) * mul : 0.f;
  }
}

// s[i][j] = a[ty + 16 i] . b[tx + 16 j] over the tiles' DH columns
template <int DH>
__device__ __forceinline__ void products(const float* a, const float* b,
                                         float (&s)[Tile<DH>::R]
                                                   [Tile<DH>::R],
                                         int ty, int tx) {
  using Tl = Tile<DH>;
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
template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        float* __restrict__ stats, int h, int kvh, int sq,
                        int sk, int dh, int causal, int window, float scale,
                        int64_t n_rows) {
  using Tl = Tile<DH>;
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

  stage<DH>(qs, q + qoff, rows, dh, scale);
  stage<DH>(dos, dout + qoff, rows, dh, 1.f);
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
    stage<DH>(ks, k + kvoff + (int64_t)j0 * dh, cols, dh, 1.f);
    __syncthreads();
    products<DH>(qs, ks, s, ty, tx);
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
    stage<DH>(ks, k + kvoff + (int64_t)j0 * dh, cols, dh, 1.f);
    stage<DH>(vs, v + kvoff + (int64_t)j0 * dh, cols, dh, 1.f);
    __syncthreads();
    products<DH>(qs, ks, s, ty, tx);
    products<DH>(dos, vs, dp, ty, tx);
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

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const T* __restrict__ dout,
                         const float* __restrict__ stats,
                         T* __restrict__ dk, T* __restrict__ dv, int h,
                         int kvh, int sq, int sk, int dh, int causal,
                         int window, float scale, int64_t n_rows) {
  using Tl = Tile<DH>;
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

  stage<DH>(ks, k + kvoff, cols, dh, 1.f);
  stage<DH>(vs, v + kvoff, cols, dh, 1.f);
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
      stage<DH>(qs, q + qoff, rows, dh, scale);
      stage<DH>(dos, dout + qoff, rows, dh, 1.f);
      for (int r = threadIdx.x; r < B; r += kThreads) {
        const int64_t row = (int64_t)bh * sq + i0 + r;
        // a padding row gets weight 0: P = exp(.) * 0
        rm[r] = r < rows ? stats[row] : 0.f;
        rl[r] = r < rows ? stats[n_rows + row] : 0.f;
        rd[r] = r < rows ? stats[2 * n_rows + row] : 0.f;
      }
      __syncthreads();
      products<DH>(qs, ks, s, ty, tx);
      products<DH>(dos, vs, dp, ty, tx);
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

template <int DH, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* stats, int b, int h, int kvh, int sq,
                   int sk, int dh, int causal, int window, float scale,
                   cudaStream_t stream) {
  using Tl = Tile<DH>;
  static bool done_dq[64] = {}, done_dkv[64] = {};
  cudaError_t err = mma::allow_smem(attention_bwd_dq_kernel<DH, T>,
                                    Tl::kDqSmem, done_dq);
  if (err != cudaSuccess) return err;
  err = mma::allow_smem(attention_bwd_dkv_kernel<DH, T>, Tl::kDkvSmem,
                        done_dkv);
  if (err != cudaSuccess) return err;
  const int q_tiles = (sq + Tl::B - 1) / Tl::B;
  const int k_tiles = (sk + Tl::B - 1) / Tl::B;
  if (q_tiles > 65535 || k_tiles > 65535) return cudaErrorInvalidValue;
  const int64_t n_rows = (int64_t)b * h * sq;
  attention_bwd_dq_kernel<DH, T>
      <<<dim3(b * h, q_tiles), kThreads, Tl::kDqSmem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(o),
          static_cast<const T*>(dout), static_cast<T*>(dq), stats, h, kvh,
          sq, sk, dh, causal, window, scale, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<DH, T>
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
  if (dh <= DH)                                                            \
  return launch<DH, T>(q, k, v, o, dout, dq, dk, dv, stats, b, h, kvh, sq, \
                       sk, dh, causal, window, scale, st)
  REPRO_ATT_BWD(32);
  REPRO_ATT_BWD(64);
  REPRO_ATT_BWD(128);
  REPRO_ATT_BWD(256);
  REPRO_ATT_BWD(kMaxDh);
#undef REPRO_ATT_BWD
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
