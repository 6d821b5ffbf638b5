// Flash attention forward for Hopper (sm_90a), f32 or bf16 in, f32 math.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel, body `_kernel`). Same function: q pre-scaled by
// `scale` in f32, optional causal mask (q_pos >= k_pos) and sliding
// window (q_pos - k_pos < window, 0 = off), masked scores set to -1e30
// (not -inf, so a row whose every key is masked comes out as the plain
// average of v, as the reference's softmax gives), online softmax with
// the denominator clamped at 1e-30, GQA through kv head `ih / group`,
// output cast to q's dtype.
//
// Asked for (`repro_flash_attention_lse`, under grad), each kernel also
// writes each row's log-sum-exp of its masked, scaled scores, m + log(l)
// from the running max and denominator it already keeps, for the
// backward's tensor-core route; `o` is computed the same way, to the
// bit, whether or not it is asked for.
//
// What bounds it on this card: at the zoo's prefill shapes the products
// q.k and p.v. jamba's (4, 64, 512, 128) causal call is 17.2 GFLOP over
// the causal pairs against 84 MB: operations bound it, at 0.104 ms on
// the tensor cores in 3xTF32 (495 / 3 TFLOP/s). On the split-NN tower's
// path, q, k, v of (R, 4, 8, 16) f32, non-causal: 4 MiB moved for 8.4
// MFLOP at R = 512, so memory, and below that launch latency, bound it.
//
// What the design does about it, two kernels chosen by shape:
//
// * sq > 16 (every prefill): `attention_mma_kernel`. A block of 4 warps
//   owns one (batch, head) and a 64-row query tile, 16 rows a warp;
//   query tiles are launched last tile first, so the long causal tiles
//   do not leave a tail. The key loop runs only over the key tiles that
//   some row of the query tile can see: it stops at the diagonal tile
//   when causal and starts at the first tile inside the window, and
//   only tiles that are not wholly visible apply the mask (tiles wholly
//   masked would add exp(-1e30 - m) = 0 exactly, so skipping them
//   changes nothing where v is finite; where a row sees no key at all,
//   which a window shorter than sq - sk allows, the block walks every
//   tile so that the row averages v as the reference does). The
//   reference multiplies a masked key's weight 0 by its v, so an inf or
//   a NaN of v at a key that no row of a query tile sees makes that
//   column NaN in every row of the tile; the key loop gives that for
//   the masked keys of the tiles it walks, and a fix-up kernel
//   (`hidden_keys_kernel`, one block a (batch, kv head, key tile), v
//   read once: 4.2 MB at granite's prefill) gives it for the tiles a
//   query tile skips. It scans its tile for a non-finite v, and where
//   it finds one it stores NaN in those columns of every query tile
//   that skipped the tile. It is launched as this kernel's programmatic
//   dependent (`griddepcontrol`): this kernel lets it start once all its
//   blocks run, so the scan runs in the last wave's idle SMs, and a
//   fix-up block waits for this kernel's grid to finish before it
//   writes, or exits, so that its stores land after the tile's own.
//   Q's tile is staged once; K and V tiles of BK keys x dh go through a
//   double-buffered `cp.async` ring in dynamic shared memory, rows
//   padded by 16 bytes so that the fragment loads are free of bank
//   conflicts. Both products run on
//   `mma.sync` (`mma_tf32.cuh`): f32 as m16n8k8 TF32 with the 3xTF32
//   split (f32 accuracy, which one TF32 pass would not give), bf16 as
//   m16n8k16. The online softmax (running max, denominator, rescale of
//   the accumulator) works on the accumulator fragments in registers; a
//   row's max takes two shuffles within the quad that holds it, its
//   denominator is summed per lane and reduced once at the end. p.v
//   takes P straight from the score fragments: in f32 the key order of
//   each 8-key step is permuted alike in P and V (A's column t is key
//   2t, column t + 4 key 2t + 1), in bf16 the m16n8k16 layouts already
//   agree. In f32 each key tile's p.v goes into a fresh fragment added
//   to the accumulator in f32, since the tensor cores truncate their
//   sums (a long row would otherwise pile up 3 sk / 8 truncations); a
//   block whose output holds a NaN or an inf runs its key loop again
//   with the inf-safe split of P and V, so that an inf in v gives the
//   reference's +-inf and not the NaN-only split's NaN. The
//   f32 path scales q before the split, as the contract says;
//   the bf16 path scales the f32 scores (q.k of bf16 values is exact in
//   f32, so this is q * scale in f32 up to rounding, where scaling q
//   first would round it to bf16). BK is 64 keys, 32 for f32 at dh 128
//   (two blocks an SM either way).
// * sq <= 16 (split-NN's 8 tokens) or an operand not 16-byte aligned:
//   `attention_simt_kernel`, f32 FMAs. One query row is owned by
//   DH / DPL neighbouring lanes, a power of two, each holding DPL dims
//   of q and of the output accumulator in registers, so a block of 128
//   threads packs several (batch, head) pairs when the sequence is short
//   (16 pairs of 8 rows on the path) instead of idling lanes. It stages
//   BK keys of k and v per pair in shared memory, BK = 8 where sk <= 8
//   (split-NN's 8 keys fill it) and 16 otherwise, reduces the dot
//   product across the row's lanes with shuffles and folds the tile into
//   the running max / denominator / accumulator. A 64-row MMA tile would
//   compute 8x the rows there.
//
// Key positions past sk are masked in both (-inf, weight exactly 0; the
// MMA kernel's copies zero-fill their k and v), so no length has to
// divide a tile.
//
// Any head dim 1 <= dh <= 512 runs, as the Pallas kernel takes any: the
// widths 16, 32, 64, 80 and 128 are compiled for both kernels, and any
// other dh up to 128 runs in the next wider one with its q, k and v
// columns past dh loaded as zero (they add nothing to q.k or p.v; the
// wrapper's scale is the real dh's) and its output columns past dh not
// stored. Rows whose bytes are not a multiple of 16 (dh 8 in bf16 is,
// dh 6 in f32 is not) are staged element by element instead of by
// `cp.async`. dh above 128 (MLA's qk head dim of 192) takes the SIMT
// kernel at 192, 256 or 512: the tensor-core kernel keeps the whole
// 16 x dh output block of a warp in registers, 242 of them at 128 in
// f32 already, and would spill there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "mma_tf32.cuh"

namespace {

using attn::accumulate;
using attn::key_tiles;
using attn::scores;
using attn::stage;
using mma::store;
using mma::to_f32;

constexpr int kThreads = 128;      // threads per block, both kernels
static_assert(kThreads == attn::kTileThreads, "the tiles' staging loops");
constexpr float kNegInf = -1e30f;

// ------------------------------------------------------------ SIMT path
constexpr int kSmemFloats = 8192;  // 32 KiB: k and v tiles of all pairs

// One block: `pairs` consecutive (batch, head) pairs x `qt` query rows.
// DPL: head dims held by one lane; BK: keys a shared-memory tile.
// EXACT: dh == DH; otherwise the dims past dh are masked.
template <int DH, int DPL, int BK, bool EXACT, typename T>
__global__ void __launch_bounds__(kThreads)
attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse,
                      int n_pairs, int h, int kvh, int sq, int sk,
                      int dh_arg, int causal, int window, float scale,
                      int pairs, int qt) {
  const int dh = EXACT ? DH : dh_arg;
  constexpr int LANES = DH / DPL;  // lanes per query row
  static_assert(DH % DPL == 0 && (LANES & (LANES - 1)) == 0 &&
                    LANES <= 32,
                "a row's lanes must be a power of two within a warp");
  __shared__ float ks[kSmemFloats / 2];
  __shared__ float vs[kSmemFloats / 2];

  const int tid = threadIdx.x;
  const int slot = tid / LANES;
  const int d0 = (tid % LANES) * DPL;
  const int lp = slot / qt;                       // local pair
  const int qi = blockIdx.y * qt + slot % qt;     // query position
  const int pair = blockIdx.x * pairs + lp;
  const bool active = lp < pairs && pair < n_pairs && qi < sq;
  const int group = h / kvh;

  float qr[DPL];
  float acc[DPL];
  float m = kNegInf;
  float l = 0.f;
  if (active) {
    const T* qrow = q + ((int64_t)pair * sq + qi) * dh + d0;
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      qr[d] = d0 + d < dh ? to_f32(qrow[d]) * scale : 0.f;
  } else {
#pragma unroll
    for (int d = 0; d < DPL; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc[d] = 0.f;

  const int tile_elems = BK * DH;                  // per pair
  const int n_tiles = (sk + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    // stage this key tile of every pair of the block (zeros past sk)
    for (int e = tid; e < pairs * tile_elems; e += kThreads) {
      const int p = e / tile_elems;
      const int j = (e % tile_elems) / DH;
      const int d = e % DH;
      const int gp = blockIdx.x * pairs + p;
      float kv = 0.f, vv = 0.f;
      if (gp < n_pairs && k0 + j < sk && d < dh) {
        const int b = gp / h;
        const int kh = (gp % h) / group;
        const int64_t off = (((int64_t)b * kvh + kh) * sk + k0 + j) * dh + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[e] = kv;
      vs[e] = vv;
    }
    __syncthreads();

    const float* kt = ks + (active ? lp : 0) * tile_elems;
    const float* vt = vs + (active ? lp : 0) * tile_elems;
    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        part = fmaf(qr[d], kt[j * DH + d0 + d], part);
      // the row's lanes are neighbours: xor offsets stay inside them
#pragma unroll
      for (int off = LANES / 2; off > 0; off /= 2)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int kp = k0 + j;
      bool keep = true;
      if (causal) keep = keep && qi >= kp;
      if (window) keep = keep && qi - kp < window;
      s[j] = kp >= sk ? -INFINITY : (keep ? part : kNegInf);
    }
    float mt = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) mt = fmaxf(mt, s[j]);
    const float alpha = expf(m - mt);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - mt);
      l += p;
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        acc[d] = fmaf(p, vt[j * DH + d0 + d], acc[d]);
    }
    m = mt;
    __syncthreads();
  }

  if (active) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + ((int64_t)pair * sq + qi) * dh + d0;
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      if (d0 + d < dh) store(orow + d, acc[d] / denom);
    // every lane of the row holds its m and l
    if (lse != nullptr && d0 == 0)
      lse[(int64_t)pair * sq + qi] = m + logf(l);
  }
}

template <int DH, int DPL, int BK, bool EXACT, typename T>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* o, float* lse, int b, int h, int kvh,
                        int sq, int sk, int dh, int causal, int window,
                        float scale, cudaStream_t stream) {
  constexpr int LANES = DH / DPL;
  constexpr int slots = kThreads / LANES;          // query rows per block
  // pairs whose k and v tiles fit the shared buffers together
  constexpr int max_pairs = (kSmemFloats / 2) / (BK * DH);
  int qt = 1;
  while (qt < sq && qt < slots) qt *= 2;
  int pairs = slots / qt;
  if (pairs > max_pairs) pairs = max_pairs;
  const int n_pairs = b * h;
  dim3 grid((n_pairs + pairs - 1) / pairs, (sq + qt - 1) / qt);
  attention_simt_kernel<DH, DPL, BK, EXACT, T>
      <<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n_pairs, h, kvh,
      sq, sk, dh, causal, window, scale, pairs, qt);
  return cudaGetLastError();
}

template <int DH, int DPL, bool EXACT, typename T>
cudaError_t simt(const void* q, const void* k, const void* v, void* o,
                 float* lse, int b, int h, int kvh, int sq, int sk, int dh,
                 int causal, int window, float scale, cudaStream_t stream) {
  // a 16-key tile of one pair must fit its half of the shared buffers
  if constexpr (16 * DH > kSmemFloats / 2) {
    return launch_simt<DH, DPL, 8, EXACT, T>(q, k, v, o, lse, b, h, kvh, sq,
                                             sk, dh, causal, window, scale,
                                             stream);
  } else {
    if (sk <= 8)
      return launch_simt<DH, DPL, 8, EXACT, T>(q, k, v, o, lse, b, h, kvh,
                                               sq, sk, dh, causal, window,
                                               scale, stream);
    return launch_simt<DH, DPL, 16, EXACT, T>(q, k, v, o, lse, b, h, kvh,
                                              sq, sk, dh, causal, window,
                                              scale, stream);
  }
}

// ------------------------------------------------------- tensor-core path
template <int DH, typename T>
struct MmaTile {
  static constexpr int kBQ = 64;  // query rows a block, 16 a warp
  static constexpr int kBK = (sizeof(T) == 4 && DH > 80) ? 32 : 64;
  static constexpr int kLd = DH + 16 / static_cast<int>(sizeof(T));
  static constexpr int kSmemBytes =
      (kBQ + 4 * kBK) * kLd * static_cast<int>(sizeof(T));
  static_assert(DH % 16 == 0 || (DH % 8 == 0 && sizeof(T) == 4),
                "head dim must be whole k-steps");
};

// grid: (b * h, query tiles); blockIdx.y = 0 is the last query tile.
// EXACT: dh == DH; otherwise the dims past dh are masked.
template <int DH, bool EXACT, typename T>
__global__ void __launch_bounds__(kThreads, 2)
attention_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int h, int kvh, int sq,
                     int sk, int dh_arg, int causal, int window,
                     float scale) {
  // a fix-up kernel launched after this one (its programmatic dependent)
  // may start once every block of this grid has reached here
  asm volatile("griddepcontrol.launch_dependents;");
  const int dh = EXACT ? DH : dh_arg;
  using Tile = MmaTile<DH, T>;
  constexpr int BQ = Tile::kBQ, BK = Tile::kBK, LD = Tile::kLd;
  constexpr int NT = BK / 8;   // 8-key column tiles of the scores
  constexpr int DT = DH / 8;   // 8-dim column tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);   // [BQ][LD]
  T* ks = qs + BQ * LD;                 // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;             // [2][BK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int pair = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = pair / h;
  const int kh = (pair % h) / (h / kvh);
  const T* qg = q + (int64_t)pair * sq * dh;
  const int64_t kv_off = ((int64_t)b * kvh + kh) * sk * dh;
  const T* kg = k + kv_off;
  const T* vg = v + kv_off;

  // the key tiles some row of [q0, q_last] can see
  const int q_last = min(q0 + BQ, sq) - 1;
  int t_lo, t_hi;
  key_tiles(q0, BQ, sq, sk, causal, window, BK, t_lo, t_hi);

  stage<DH, LD>(qs, qg, q0, BQ, sq, dh);
  mma::cp_async_commit();

  float acc[DT][4];
  float m[2];  // rows g and g + 8 of the warp
  float l[2];  // this lane's share of each sum
  const int wrow = warp * 16;
  const int row_g = q0 + wrow + g;

  // The key loop, from the first tile; SAFE takes p.v with the inf-safe
  // split. It ends on a barrier, so a second pass may restage K and V.
  auto key_loop = [&](auto safe) {
    constexpr bool SAFE = decltype(safe)::value;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
    stage<DH, LD>(ks, kg, t_lo * BK, BK, sk, dh);
    stage<DH, LD>(vs, vg, t_lo * BK, BK, sk, dh);
    mma::cp_async_commit();
    for (int kt = t_lo; kt < t_hi; ++kt) {
      const int buf = (kt - t_lo) & 1;
      const int k0 = kt * BK;
      // the other buffer was last read before the previous iteration's
      // closing barrier, so the next tile may land in it now
      if (kt + 1 < t_hi) {
        stage<DH, LD>(ks + (buf ^ 1) * BK * LD, kg, k0 + BK, BK, sk, dh);
        stage<DH, LD>(vs + (buf ^ 1) * BK * LD, vg, k0 + BK, BK, sk, dh);
      }
      mma::cp_async_commit();  // an empty group on the last tile
      mma::cp_async_wait<1>();  // this tile's copies (and q's) have landed
      __syncthreads();

      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      scores<DH, NT, LD>(s, qs + wrow * LD, ks + buf * BK * LD, g, t,
                         scale);

      // the mask, where some key of the tile is hidden from some row
      const bool whole = k0 + BK <= sk && (!causal || k0 + BK - 1 <= q0) &&
                         (!window || q_last - k0 < window);
      if (!whole) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + 2 * t + (e & 1);
            const int qi = row_g + (e >> 1) * 8;
            if (kp >= sk)
              s[j][e] = -INFINITY;
            else if ((causal && kp > qi) || (window && qi - kp >= window))
              s[j][e] = kNegInf;
          }
      }

      // online softmax on the fragments: row r's values are s[j][2r..2r+1]
      // of the four lanes of a quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = m[r];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mt = fmaxf(mt, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float alpha = expf(m[r] - mt);
        m[r] = mt;
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          s[j][2 * r] = expf(s[j][2 * r] - mt);
          s[j][2 * r + 1] = expf(s[j][2 * r + 1] - mt);
          l[r] += s[j][2 * r] + s[j][2 * r + 1];
        }
      }
      accumulate<SAFE, DT, NT, LD>(acc, s, vs + buf * BK * LD, g, t);
      __syncthreads();
    }
  };
  key_loop(std::false_type{});
  // f32: an inf in v (or a value that rounds to inf in TF32) makes the
  // NaN-only split's p.v NaN where the reference gives +-inf (inf * 0 in
  // big_p * small_v), and leaves a non-finite output in those rows
  // either way, as does any NaN or inf the reference also gives. A block
  // holding one takes the key loop again with the inf-safe split: the
  // grouped matmul's scheme, which redoes a stage at a time, here with
  // the whole loop as the stage, since a vote a fragment inside the loop
  // measured 13-18% slower at the zoo's prefill shapes (PERF.md).
  if constexpr (sizeof(T) == 4) {
    bool special = false;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) special |= !isfinite(acc[n][e]);
    if (__syncthreads_or(special)) key_loop(std::true_type{});
  }

  T* og = o + (int64_t)pair * sq * dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int qi = row_g + 8 * r;
    if (lse != nullptr && t == 0 && qi < sq)
      lse[(int64_t)pair * sq + qi] = m[r] + logf(sum);
    if (qi < sq) {
      T* orow = og + (int64_t)qi * dh + 2 * t;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const float x0 = acc[n][2 * r] * inv, x1 = acc[n][2 * r + 1] * inv;
        const int col = 8 * n + 2 * t;
        if (dh == DH || (dh % 2 == 0 && col + 1 < dh)) {
          mma::store2(orow + 8 * n, x0, x1);  // an even dh keeps pairs
        } else {                              // aligned
          if (col < dh) store(orow + 8 * n, x0);
          if (col + 1 < dh) store(orow + 8 * n + 1, x1);
        }
      }
    }
  }
}

// Non-zero where an element of a 32-bit word of v is an inf or a NaN
// (every exponent bit set): one element of f32, two of bf16.
__device__ __forceinline__ uint32_t nonfinite_bits(uint32_t w, float*) {
  return (w & 0x7F800000u) == 0x7F800000u;
}
__device__ __forceinline__ uint32_t nonfinite_bits(uint32_t w,
                                                   __nv_bfloat16*) {
  return ((w & 0x7F80u) == 0x7F80u) |
         (((w & 0x7F800000u) == 0x7F800000u) << 1);
}

// Words of a key tile's column mask (dh <= 128) and 16-byte loads a
// thread of the fix-up kernel issues at most: a tile of 64 keys x 80
// dims in f32, the largest, is 1,280 words over 128 threads.
constexpr int kMaskWords = 4;
constexpr int kMaxLoads = 10;

// The fix-up of a causal or windowed tensor-core call, the attention
// kernel's programmatic dependent. grid: (b * kvh, key tiles of BK). A
// block reads its key tile of v once (rows are contiguous, so as one run
// of 16-byte words where rows are whole words: dh a multiple of 4 in
// f32, of 8 in bf16; else element by element), each thread issuing all
// its loads before it looks at any, since memory bounds the scan. Where
// the tile holds an inf or a NaN, the block reads it again for the
// columns, waits for the attention kernel's grid, and stores NaN in
// those columns of every query tile of BQ rows that skipped the tile, in
// each head of the kv group. Every block waits for that grid before it
// ends, so that this kernel ends after the attention kernel.
template <int BQ, int BK, typename T>
__global__ void __launch_bounds__(kThreads)
hidden_keys_kernel(const T* __restrict__ v, T* __restrict__ o, int h,
                   int kvh, int sq, int sk, int dh, int causal,
                   int window) {
  __shared__ uint32_t words[kMaskWords];
  if (threadIdx.x < kMaskWords) words[threadIdx.x] = 0;
  const int kt = blockIdx.y;
  const int k0 = kt * BK;
  const int n = min(BK, sk - k0) * dh;  // the tile's elements
  const T* src = v + ((int64_t)blockIdx.x * sk + k0) * dh;
  constexpr int V = 16 / sizeof(T);    // elements a 16-byte word
  uint32_t any = 0;
  if (dh % V == 0) {
    uint4 raw[kMaxLoads];
#pragma unroll
    for (int j = 0; j < kMaxLoads; ++j) {
      const int e = (j * kThreads + threadIdx.x) * V;
      raw[j] = e < n ? *reinterpret_cast<const uint4*>(src + e)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kMaxLoads; ++j)
      any |= nonfinite_bits(raw[j].x, static_cast<T*>(nullptr)) |
             nonfinite_bits(raw[j].y, static_cast<T*>(nullptr)) |
             nonfinite_bits(raw[j].z, static_cast<T*>(nullptr)) |
             nonfinite_bits(raw[j].w, static_cast<T*>(nullptr));
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads)
      any |= !isfinite(to_f32(src[e]));
  }
  const bool found = __syncthreads_or(any);
  if (found) {
    for (int e = threadIdx.x; e < n; e += kThreads) {
      if (!isfinite(to_f32(src[e]))) {
        const int c = e % dh;
        atomicOr(&words[c / 32], 1u << (c % 32));
      }
    }
  }
  // the attention kernel's grid has finished and its stores are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (!found) return;
  __syncthreads();
  const float nan = __int_as_float(0x7fc00000);
  const int b = blockIdx.x / kvh, kh = blockIdx.x % kvh;
  const int group = h / kvh;
  for (int q0 = 0; q0 < sq; q0 += BQ) {
    int t_lo, t_hi;
    key_tiles(q0, BQ, sq, sk, causal, window, BK, t_lo, t_hi);
    if (kt >= t_lo && kt < t_hi) continue;  // the query tile walked it
    const int rows = min(BQ, sq - q0);
    for (int i = threadIdx.x; i < group * rows * dh; i += kThreads) {
      const int c = i % dh;
      if (!((words[c / 32] >> (c % 32)) & 1u)) continue;
      const int head = kh * group + i / (rows * dh);
      const int r = q0 + (i / dh) % rows;
      store(o + (((int64_t)b * h + head) * sq + r) * dh + c, nan);
    }
  }
}

template <int DH, bool EXACT, typename T>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int b, int h, int kvh, int sq, int sk,
                       int dh, int causal, int window, float scale,
                       cudaStream_t stream) {
  using Tile = MmaTile<DH, T>;
  constexpr int BQ = Tile::kBQ, BK = Tile::kBK;
  static_assert(BK * DH * sizeof(T) <= 16 * kThreads * kMaxLoads,
                "the fix-up's loads must cover a key tile");
  static bool done[64] = {};
  cudaError_t err = mma::allow_smem(attention_mma_kernel<DH, EXACT, T>,
                                    Tile::kSmemBytes, done);
  if (err != cudaSuccess) return err;
  const int q_tiles = (sq + BQ - 1) / BQ;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid(b * h, q_tiles);
  attention_mma_kernel<DH, EXACT, T>
      <<<grid, kThreads, Tile::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, h, kvh, sq, sk,
      dh, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the fix-up runs only where some query tile skips a key tile
  const int k_tiles = (sk + BK - 1) / BK;
  bool skips = false;
  for (int i = 0; i < q_tiles && !skips; ++i) {
    int t_lo, t_hi;
    key_tiles(i * BQ, BQ, sq, sk, causal, window, BK, t_lo, t_hi);
    skips = t_lo > 0 || t_hi < k_tiles;
  }
  if (!skips) return cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * kvh, k_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, hidden_keys_kernel<BQ, BK, T>,
                            static_cast<const T*>(v), static_cast<T*>(o), h,
                            kvh, sq, sk, dh, causal, window);
}

// the widest head dim of the tensor-core kernel; wider heads take the
// SIMT kernel (its accumulator at 192 or 256 would not fit registers)
constexpr int kMaxMmaDh = 128;
constexpr int kMaxDh = 512;

// 0 = SIMT, 1 = tensor cores (3xTF32 for f32, bf16 MMA for bf16)
int variant(const void* q, const void* k, const void* v, int sq, int dh) {
  const bool aligned = (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(v) % 16 == 0);
  return sq > 16 && dh <= kMaxMmaDh && aligned ? 1 : 0;
}

template <int DH, int DPL, bool EXACT, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int h, int kvh, int sq, int sk, int dh,
                   int causal, int window, float scale, cudaStream_t stream) {
  if constexpr (DH <= kMaxMmaDh) {
    if (variant(q, k, v, sq, dh))
      return launch_mma<DH, EXACT, T>(q, k, v, o, lse, b, h, kvh, sq, sk,
                                      dh, causal, window, scale, stream);
  }
  return simt<DH, DPL, EXACT, T>(q, k, v, o, lse, b, h, kvh, sq, sk, dh,
                                 causal, window, scale, stream);
}

// Each dh runs in the narrowest compiled width DH >= dh, its columns
// past dh zero (so they add nothing to q.k or p.v) and never stored.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int b, int h, int kvh, int sq, int sk,
                     int dh, int causal, int window, float scale,
                     cudaStream_t stream) {
#define REPRO_ATT(DH, DPL, EXACT)                                          \
  return launch<DH, DPL, EXACT, T>(q, k, v, o, lse, b, h, kvh, sq, sk, dh, \
                                   causal, window, scale, stream)
#define REPRO_ATT_WIDTH(DH, DPL)                                           \
  if (dh == DH) REPRO_ATT(DH, DPL, true);                                  \
  if (dh < DH) REPRO_ATT(DH, DPL, false)
  REPRO_ATT_WIDTH(16, 16);
  REPRO_ATT_WIDTH(32, 16);
  REPRO_ATT_WIDTH(64, 16);
  REPRO_ATT_WIDTH(80, 20);
  REPRO_ATT_WIDTH(128, 16);
  if (dh <= 192) REPRO_ATT(192, 12, false);
  if (dh <= 256) REPRO_ATT(256, 16, false);
  REPRO_ATT(kMaxDh, 32, false);
#undef REPRO_ATT_WIDTH
#undef REPRO_ATT
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: null, or b * h * sq f32 that
// get each row's log-sum-exp of its masked, scaled scores, m + log(l)
// (-1e30 in f32 for a row that sees no key: the backward knows such rows
// by position). `o` is the same to the bit either way. Returns the
// launch's cudaError_t.
extern "C" int repro_flash_attention_lse(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int b, int h, int kvh, int sq,
                                         int sk, int dh, int dtype,
                                         int causal, int window,
                                         float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (b <= 0 || h <= 0 || kvh <= 0 || h % kvh || sq <= 0 || sk <= 0 ||
      dh <= 0 || dh > kMaxDh)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, l, b, h, kvh, sq, sk, dh, causal,
                           window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, l, b, h, kvh, sq, sk, dh,
                                   causal, window, scale, st);
  return cudaErrorInvalidValue;
}

// The kernel a call with these operands runs: 0 = SIMT (sq <= 16, dh
// above 128, or an operand not 16-byte aligned), 1 = tensor cores.
extern "C" int repro_flash_attention_variant(const void* q, const void* k,
                                             const void* v, int sq,
                                             int dh) {
  return variant(q, k, v, sq, dh);
}
