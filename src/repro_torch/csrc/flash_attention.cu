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
// What bounds it on this card: on the split-NN tower's path the call is
// q, k, v of (R, 4, 8, 16) f32, non-causal: 4 MiB moved for 8.4 MFLOP at
// R = 512, so memory, and below that launch latency, bound it; the
// matrix units have nothing to chew on (an 8x8 score tile per head).
//
// What the design does about it: it is written again from what it
// computes, not from the Pallas grid. Blocks run over (b*h, q-tiles);
// one query row is owned by DH / DPL neighbouring lanes, a power of two,
// each holding DPL dims of q and of the output accumulator in registers
// (16 dims a lane; 20 at head dim 80, whose row takes 4 lanes, since 5
// would break the xor-shuffle reduction), so a block of 128 threads
// packs several (batch, head) pairs when the sequence is short (16
// pairs of 8 rows on the path) instead of idling lanes. Each block
// stages BK keys of k and v per (batch, head) pair in shared
// memory, scores them with f32 FMAs (no TF32: the f32 tolerance is
// 2e-5), reduces the dot product across the row's lanes with shuffles,
// and folds the tile into the running max / denominator / accumulator.
// Key positions past sk are masked here (-inf, weight exactly 0), so no
// length has to divide a tile. Tensor-core (wgmma) and TMA versions are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads per block
constexpr int kBK = 16;         // keys per shared-memory tile
constexpr int kSmemFloats = 8192;  // 32 KiB: k and v tiles of all pairs
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One block: `pairs` consecutive (batch, head) pairs x `qt` query rows.
// DPL: head dims held by one lane.
template <int DH, int DPL, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int n_pairs, int h, int kvh, int sq, int sk,
                       int causal, int window, float scale, int pairs,
                       int qt) {
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
    const T* qrow = q + ((int64_t)pair * sq + qi) * DH + d0;
#pragma unroll
    for (int d = 0; d < DPL; ++d) qr[d] = to_f32(qrow[d]) * scale;
  } else {
#pragma unroll
    for (int d = 0; d < DPL; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc[d] = 0.f;

  const int tile_elems = kBK * DH;                 // per pair
  const int n_tiles = (sk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    // stage this key tile of every pair of the block (zeros past sk)
    for (int e = tid; e < pairs * tile_elems; e += kThreads) {
      const int p = e / tile_elems;
      const int j = (e % tile_elems) / DH;
      const int d = e % DH;
      const int gp = blockIdx.x * pairs + p;
      float kv = 0.f, vv = 0.f;
      if (gp < n_pairs && k0 + j < sk) {
        const int b = gp / h;
        const int kh = (gp % h) / group;
        const int64_t off = (((int64_t)b * kvh + kh) * sk + k0 + j) * DH + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[e] = kv;
      vs[e] = vv;
    }
    __syncthreads();

    const float* kt = ks + (active ? lp : 0) * tile_elems;
    const float* vt = vs + (active ? lp : 0) * tile_elems;
    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
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
    for (int j = 0; j < kBK; ++j) mt = fmaxf(mt, s[j]);
    const float alpha = expf(m - mt);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
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
    T* orow = o + ((int64_t)pair * sq + qi) * DH + d0;
#pragma unroll
    for (int d = 0; d < DPL; ++d) store(orow + d, acc[d] / denom);
  }
}

template <int DH, int DPL, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int h, int kvh, int sq, int sk, int causal,
                   int window, float scale, cudaStream_t stream) {
  constexpr int LANES = DH / DPL;
  constexpr int slots = kThreads / LANES;          // query rows per block
  // pairs whose k and v tiles fit the shared buffers together
  constexpr int max_pairs = (kSmemFloats / 2) / (kBK * DH);
  int qt = 1;
  while (qt < sq && qt < slots) qt *= 2;
  int pairs = slots / qt;
  if (pairs > max_pairs) pairs = max_pairs;
  const int n_pairs = b * h;
  dim3 grid((n_pairs + pairs - 1) / pairs, (sq + qt - 1) / qt);
  flash_attention_kernel<DH, DPL, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_pairs, h, kvh, sq,
      sk, causal, window, scale, pairs, qt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int b, int h, int kvh, int sq, int sk, int dh,
                     int causal, int window, float scale,
                     cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<16, 16, T>(q, k, v, o, b, h, kvh, sq, sk, causal,
                               window, scale, stream);
    case 32:
      return launch<32, 16, T>(q, k, v, o, b, h, kvh, sq, sk, causal,
                               window, scale, stream);
    case 64:
      return launch<64, 16, T>(q, k, v, o, b, h, kvh, sq, sk, causal,
                               window, scale, stream);
    case 80:
      return launch<80, 20, T>(q, k, v, o, b, h, kvh, sq, sk, causal,
                               window, scale, stream);
    case 128:
      return launch<128, 16, T>(q, k, v, o, b, h, kvh, sq, sk, causal,
                                window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int b, int h,
                                     int kvh, int sq, int sk, int dh,
                                     int dtype, int causal, int window,
                                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || h <= 0 || kvh <= 0 || h % kvh || sq <= 0 || sk <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, b, h, kvh, sq, sk, dh, causal,
                           window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, h, kvh, sq, sk, dh,
                                   causal, window, scale, st);
  return cudaErrorInvalidValue;
}
