// Tensor-core building blocks shared by flash_attention.cu and
// moe_gmm.cu: the 3xTF32 split of an f32 value, warp-level `mma.sync`
// products (m16n8k8 TF32, m16n8k16 bf16; f32 accumulators), their
// fragment loads from shared memory, and `cp.async` staging.
//
// Why 3xTF32: TF32 keeps 10 mantissa bits, about three decimal digits,
// which the f32 tolerances (2e-5 for attention, 2e-4 for the grouped
// matmul) do not allow. Each f32 operand x is split as
//   big   = cvt.rna.tf32(x)          (the top 11 significant bits)
//   small = cvt.rna.tf32(x - big)    (the next 11)
// and a product a * b is taken as small_a * big_b + big_a * small_b +
// big_a * big_b, three tensor-core passes summed in f32: only small_a *
// small_b (about 2^-22 of the product) and x's bits below the 22nd are
// lost, close to f32's own rounding. `mma.sync` and not `wgmma`: `wgmma`
// reads TF32 operands from shared memory only K-major, and the
// attention's V and the grouped matmul's w are MN-major; `mma.sync`
// fragments are loaded by the threads, so any layout works.
//
// Fragment layouts (PTX ISA, "mma.m16n8k8" and "mma.m16n8k16"), lane =
// 4 * g + t with g = lane / 4 (0..7) and t = lane % 4:
//   m16n8k8 TF32  A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t),
//                                        a2 (g, t + 4), a3 (g + 8, t + 4)
//                 B (8 x 8, k x n):      b0 (t, g), b1 (t + 4, g)
//   m16n8k16 bf16 A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                              a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//                 B (16 x 8):  b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)
//   C/D (16 x 8, f32, both):   c0 (g, 2t), c1 (g, 2t + 1),
//                              c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mma {

// ---------------------------------------------------------------- split
// x = big + small + (what lies below TF32's reach twice over), both
// rounded as cvt.rna.tf32.f32 rounds: to nearest, ties away from zero,
// at the 13 low mantissa bits. Done as an integer add and mask, which
// gives the instruction's bits for every finite x below the values that
// round up to inf, and measured cheaper than `cvt` on the card in both
// kernels' inner loops.
//
// A NaN would not survive the add and mask (the carry out of a full
// mantissa, as in GPU arithmetic's canonical NaN 0x7FFFFFFF, runs into
// the sign bit and leaves -0): a NaN x gets the canonical NaN as big,
// whose top mantissa bits the tensor cores read as NaN, and small comes
// out -0 (x - big is NaN, which the rounding leaves as -0).
//
// kInfSafe (the grouped matmul) also gives the plain product's +-inf
// for an inf operand. An inf big would meet small_b = 0, common for
// values exact in TF32, as inf * 0 = NaN; so an inf x gets big = the
// largest finite TF32 of its sign (0x7F7FE000) and small = inf - big,
// the inf, and a finite x within half a TF32 ulp of FLT_MAX, which would
// round to inf, gets that big and small = x - big truncated to TF32,
// finite: rounded, it can come out 2^117, and big + small = 2^128, which
// the tensor cores return as inf where the other operand is 1 (measured
// on the card; attention's top weight is exactly 1). A product's
// three passes then carry the inf in small_a * big_b (inf of the right
// sign, or NaN where b is 0, as inf * 0 is), while big_a * big_b and
// big_a * small_b are finite or an inf of the same sign. Only where the
// other operand is above ~2^12 in magnitude can big_a * small_b
// overflow with small_b's own sign and meet the inf as a NaN. The
// grouped matmul splits with `split_finite`, which notes such a value,
// and takes a stage again with this split only where a warp's
// fragments held one. Attention splits with the NaN-only split and
// takes a block's whole key loop again with this split for p.v where
// the block's output holds a non-finite value; its q.k keeps the
// NaN-only split: an inf in q or k makes an infinite score, which
// `attention_ref` turns into a NaN too where it is +inf (inf - inf in
// the softmax).
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// The smallest magnitude that rounds up to inf in TF32; NaN, inf and
// everything from here up need `split<true>`.
__device__ __forceinline__ float rounds_to_inf() {
  return __uint_as_float(0x7F7FF000u);
}

template <int N>
struct Split {
  uint32_t big[N];
  uint32_t small[N];
};

template <bool kInfSafe = false, int N>
__device__ __forceinline__ Split<N> split(const float (&x)[N]) {
  Split<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s.big[i] = isnan(x[i]) ? 0x7FFFFFFFu : round_tf32(x[i]);
    const bool clamp = kInfSafe && isinf(__uint_as_float(s.big[i]));
    if (clamp) s.big[i] = (__float_as_uint(x[i]) & 0x80000000u) | 0x7F7FE000u;
    const float rest = x[i] - __uint_as_float(s.big[i]);
    s.small[i] = clamp ? __float_as_uint(rest) & 0xFFFFE000u : round_tf32(rest);
  }
  return s;
}

// The split of finite values below `rounds_to_inf()`; sets `special`
// where some x is not one (a NaN, an inf, or a value that rounds to
// inf), whose split the caller then takes again with `split<true>`.
template <int N>
__device__ __forceinline__ Split<N> split_finite(const float (&x)[N],
                                                 bool& special) {
  Split<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    special |= !(fabsf(x[i]) < rounds_to_inf());
    s.big[i] = round_tf32(x[i]);
    s.small[i] = round_tf32(x[i] - __uint_as_float(s.big[i]));
  }
  return s;
}

// ------------------------------------------------------------- products
// d += a * b, one m16n8k8 TF32 pass
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b at f32 accuracy: the three passes of the 3xTF32 split, the
// small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Split<4>& a,
                                           const Split<2>& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// d += a * b, one m16n8k16 bf16 pass (a: 4 and b: 2 pairs of bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// two bf16 of shared memory (not 4-byte aligned together) as a pair
__device__ __forceinline__ uint32_t pair_bf16(const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  return static_cast<uint32_t>(
             *reinterpret_cast<const unsigned short*>(lo)) |
         (static_cast<uint32_t>(
              *reinterpret_cast<const unsigned short*>(hi))
          << 16);
}

// ------------------------------------------------------ fragment loads
// `p` points at the fragment's (row 0, col 0) in shared memory, `ld` is
// the row stride in elements; g and t as above.

// A of m16n8k8, 16 x 8 of a row-major f32 tile, times `scale`
__device__ __forceinline__ void load_a_tf32(float (&a)[4], const float* p,
                                            int ld, int g, int t,
                                            float scale = 1.f) {
  a[0] = p[g * ld + t] * scale;
  a[1] = p[(g + 8) * ld + t] * scale;
  a[2] = p[g * ld + t + 4] * scale;
  a[3] = p[(g + 8) * ld + t + 4] * scale;
}

// B of m16n8k8 (8 x 8, k x n) from a tile stored n-major ([n][k]: the
// keys of attention's K)
__device__ __forceinline__ void load_b_tf32_nk(float (&b)[2], const float* p,
                                               int ld, int g, int t) {
  b[0] = p[g * ld + t];
  b[1] = p[g * ld + t + 4];
}

// B of m16n8k8 from a tile stored k-major ([k][n]: the grouped matmul's
// w), rows t and t + 4
__device__ __forceinline__ void load_b_tf32_kn(float (&b)[2], const float* p,
                                               int ld, int g, int t) {
  b[0] = p[t * ld + g];
  b[1] = p[(t + 4) * ld + g];
}

// A of m16n8k16 from a row-major bf16 tile
__device__ __forceinline__ void load_a_bf16(uint32_t (&a)[4],
                                            const __nv_bfloat16* p, int ld,
                                            int g, int t) {
  a[0] = *reinterpret_cast<const uint32_t*>(p + g * ld + 2 * t);
  a[1] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * ld + 2 * t);
  a[2] = *reinterpret_cast<const uint32_t*>(p + g * ld + 2 * t + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * ld + 2 * t + 8);
}

// B of m16n8k16 from a bf16 tile stored n-major ([n][k])
__device__ __forceinline__ void load_b_bf16_nk(uint32_t (&b)[2],
                                               const __nv_bfloat16* p,
                                               int ld, int g, int t) {
  b[0] = *reinterpret_cast<const uint32_t*>(p + g * ld + 2 * t);
  b[1] = *reinterpret_cast<const uint32_t*>(p + g * ld + 2 * t + 8);
}

// B of m16n8k16 from a bf16 tile stored k-major ([k][n])
__device__ __forceinline__ void load_b_bf16_kn(uint32_t (&b)[2],
                                               const __nv_bfloat16* p,
                                               int ld, int g, int t) {
  b[0] = pair_bf16(p + 2 * t * ld + g, p + (2 * t + 1) * ld + g);
  b[1] = pair_bf16(p + (2 * t + 8) * ld + g, p + (2 * t + 9) * ld + g);
}

// ------------------------------------------------------------- launches
// Lets `kernel` take `bytes` (above 48 KB) of dynamic shared memory, once
// per device; `done` is the caller's per-device record for this kernel.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// --------------------------------------------------------------- copies
// 16 bytes from global to shared memory, asynchronously; with `full`
// false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------- conversions
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// two neighbours of a row (8-byte or 4-byte aligned)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

}  // namespace mma
