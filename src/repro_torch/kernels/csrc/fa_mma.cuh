// Tensor-core pieces of the three flash-attention kernels (fa_fwd.cu,
// fa_bwd_dq.cu, fa_bwd_dkv.cu) and the two SSD kernels (ssd_fwd.cu,
// ssd_bwd.cu): the error-compensated 3xTF32 product on mma.sync.m16n8k8,
// and cp.async staging of row tiles into padded shared memory.
//
// 3xTF32.  An f32 operand x is split into big = cvt.rna.tf32(x) and
// small = cvt.rna.tf32(x - big); the product a·b is taken as
// big_a·small_b + small_a·big_b + big_a·big_b, each a TF32 tensor-core
// product accumulated in f32.  The dropped small_a·small_b is ~2^-22 of
// |a·b|, so the result is as accurate as an f32 FMA chain.  A value loaded
// from bf16 is exactly a TF32 value (small == 0): its small products are
// skipped (the kSmall flags).  Values computed in the kernel (P, dS)
// always take all three products.
//
// Fragments of mma.m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product's k order is free as long as A and B agree on it.  Feeding an
// accumulator tile straight back as the A operand of the next product
// (P·V, dS·K, Pᵀ·dO, dSᵀ·Q) therefore needs no shuffle: logical column t
// is taken as key 2t and column t + 4 as key 2t + 1, so a = (c0, c2, c1,
// c3), and the B operand reads rows 2t and 2t + 1 of its tile
// (fa_frag_b_rows).
//
// Shared-memory rows are padded by 16 bytes (FaPad: 4 floats or 8 bf16), a
// row stride of 4 words mod 32 for every head dim here: the A/B reads
// (row g, column t) and (row 2t, column g) of a warp then hit 32 distinct
// banks (bf16: 16 distinct words, two lanes per word).
#pragma once

#include <cstdint>
#include <type_traits>

#include "fa_common.cuh"

template <typename T> struct FaPad { static constexpr int value = 16 / sizeof(T); };

// cvt.rna.tf32.f32 on finite x: round the magnitude to 10 mantissa bits,
// to nearest with ties away from zero, as integer arithmetic on the f32
// bits (two instructions; the PTX conversion adds an inf/NaN guard).  The
// TF32 value as an f32 bit pattern.
__device__ __forceinline__ uint32_t fa_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// big (and, when kSmall, small) TF32 parts of x.  small is rounded the same
// way; its low 13 bits are left in place, since the tensor core ignores
// them.  Without kSmall, x must be a TF32 value already (a widened bf16):
// its bits are taken as they are.
template <bool kSmall>
__device__ __forceinline__ void fa_split(float x, uint32_t& big, uint32_t& small) {
  if constexpr (kSmall) {
    big = fa_tf32(x);
    small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
  } else {
    big = __float_as_uint(x);
    small = 0u;
  }
}

// 2^x on the MUFU unit (ex2.approx.ftz: relative error ~2^-22, results
// below 2^-126 flushed to 0).
__device__ __forceinline__ float fa_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float FA_LOG2E = 1.4426950408889634f;
constexpr float FA_LN2 = 0.6931471805599453f;

// c += a·b, one TF32 tensor-core product with f32 accumulation.
__device__ __forceinline__ void fa_mma(float (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b at f32 accuracy: the small products first, then big·big.
template <bool kASmall, bool kBSmall>
__device__ __forceinline__ void fa_mma3(float (&c)[4], const uint32_t (&ab)[4],
                                        const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                        const uint32_t (&bs)[2]) {
  if constexpr (kBSmall) fa_mma(c, ab, bs);
  if constexpr (kASmall) fa_mma(c, as, bb);
  fa_mma(c, ab, bb);
}

// A fragment of rows [0, 16) x columns [0, 8) of a row-major tile with row
// stride LD (the caller offsets `tile` to the fragment's corner).
template <bool kSmall, int LD, typename T>
__device__ __forceinline__ void fa_frag_a(const T* tile, int g, int t, uint32_t (&big)[4],
                                          uint32_t (&small)[4]) {
  const T* r = tile + g * LD + t;
  fa_split<kSmall>(fa_to_float(r[0]), big[0], small[0]);
  fa_split<kSmall>(fa_to_float(r[8 * LD]), big[1], small[1]);
  fa_split<kSmall>(fa_to_float(r[4]), big[2], small[2]);
  fa_split<kSmall>(fa_to_float(r[8 * LD + 4]), big[3], small[3]);
}

// A fragment, as fa_frag_a, of a tile already split in shared memory:
// {big, small} pairs with row stride LD2 (LD2 = 4 mod 16 keeps the 64-bit
// reads free of bank conflicts).
template <int LD2>
__device__ __forceinline__ void fa_frag_a_split(const uint2* tile, int g, int t,
                                                uint32_t (&big)[4], uint32_t (&small)[4]) {
  const uint2* r = tile + g * LD2 + t;
  const uint2 a0 = r[0], a1 = r[8 * LD2], a2 = r[4], a3 = r[8 * LD2 + 4];
  big[0] = a0.x, big[1] = a1.x, big[2] = a2.x, big[3] = a3.x;
  small[0] = a0.y, small[1] = a1.y, small[2] = a2.y, small[3] = a3.y;
}

// B fragment whose column n is row n of a row-major tile (k along the row):
// the Kᵀ of S = Q·Kᵀ, the Qᵀ of Sᵀ = K·Qᵀ.
template <bool kSmall, int LD, typename T>
__device__ __forceinline__ void fa_frag_bt(const T* tile, int g, int t, uint32_t (&big)[2],
                                           uint32_t (&small)[2]) {
  const T* r = tile + g * LD + t;
  fa_split<kSmall>(fa_to_float(r[0]), big[0], small[0]);
  fa_split<kSmall>(fa_to_float(r[4]), big[1], small[1]);
}

// B fragment of a row-major tile (k down the rows) in the permuted k order
// of an accumulator fed back as A: rows 2t and 2t + 1, column g.
template <bool kSmall, int LD, typename T>
__device__ __forceinline__ void fa_frag_b_rows(const T* tile, int g, int t, uint32_t (&big)[2],
                                               uint32_t (&small)[2]) {
  const T* r = tile + 2 * t * LD + g;
  fa_split<kSmall>(fa_to_float(r[0]), big[0], small[0]);
  fa_split<kSmall>(fa_to_float(r[LD]), big[1], small[1]);
}

// A fragment of rows [0, 16) of a row-major tile in the permuted k order:
// columns 2t and 2t + 1, to pair with fa_frag_b_rows on the B side.
template <bool kSmall, int LD, typename T>
__device__ __forceinline__ void fa_frag_a_pairs(const T* tile, int g, int t, uint32_t (&big)[4],
                                                uint32_t (&small)[4]) {
  const T* r = tile + g * LD + 2 * t;
  fa_split<kSmall>(fa_to_float(r[0]), big[0], small[0]);
  fa_split<kSmall>(fa_to_float(r[8 * LD]), big[1], small[1]);
  fa_split<kSmall>(fa_to_float(r[1]), big[2], small[2]);
  fa_split<kSmall>(fa_to_float(r[8 * LD + 1]), big[3], small[3]);
}

// A fragment of the transpose of a row-major f32 tile (A row m = tile
// column m, k down the tile's rows) in the permuted k order, to pair with
// fa_frag_b_rows: tile rows 2t and 2t + 1, scaled by s0 and s1, columns g
// and g + 8.  With a row stride of 4 words mod 16 (FaPad) the reads
// (row 2t, column g) of a warp hit 32 distinct banks; rows t and t + 4, as
// the unpermuted order would read, would conflict two ways.
template <int LD>
__device__ __forceinline__ void fa_frag_at_rows(const float* tile, int g, int t, float s0,
                                                float s1, uint32_t (&big)[4],
                                                uint32_t (&small)[4]) {
  const float* r = tile + 2 * t * LD + g;
  fa_split<true>(r[0] * s0, big[0], small[0]);
  fa_split<true>(r[8] * s0, big[1], small[1]);
  fa_split<true>(r[LD] * s1, big[2], small[2]);
  fa_split<true>(r[LD + 8] * s1, big[3], small[3]);
}

// An accumulator tile as the A operand of the next product (see above).
__device__ __forceinline__ void fa_frag_acc(const float (&c)[4], uint32_t (&big)[4],
                                            uint32_t (&small)[4]) {
  fa_split<true>(c[0], big[0], small[0]);
  fa_split<true>(c[2], big[1], small[1]);
  fa_split<true>(c[1], big[2], small[2]);
  fa_split<true>(c[3], big[3], small[3]);
}

// ---------------------------------------------------------------------------
// cp.async staging
// ---------------------------------------------------------------------------

// 16 bytes global -> shared; zeros when !ok (nothing is read then).
__device__ __forceinline__ void fa_cp16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero when !ok.
__device__ __forceinline__ void fa_cp4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void fa_cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void fa_cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy rows [r0, r0 + R) of a (n_rows, HD) row-major matrix into shared
// [R][LD], zeros past n_rows; 16-byte chunks over the CTA's NT threads.
template <typename T, int HD, int LD, int R, int NT>
__device__ __forceinline__ void fa_cp_rows(T* dst, const T* src, int r0, int n_rows) {
  constexpr int E = 16 / sizeof(T), C = HD / E;  // elements per chunk, chunks per row
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = i / C, c = i % C;
    const bool ok = r0 + r < n_rows;
    fa_cp16(dst + r * LD + c * E, ok ? src + (size_t)(r0 + r) * HD + c * E : src, ok);
  }
}

// Copy R per-row floats (lse or delta) from row r0 on; zeros past n_rows.
template <int R, int NT>
__device__ __forceinline__ void fa_cp_vals(float* dst, const float* src, int r0, int n_rows) {
  for (int r = threadIdx.x; r < R; r += NT) {
    const bool ok = r0 + r < n_rows;
    fa_cp4(dst + r, ok ? src + r0 + r : src, ok);
  }
}

// Two neighbouring elements of an output row.
__device__ __forceinline__ void fa_store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void fa_store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Whether a pointer that cp.async tiles read is not 16-byte aligned.
__host__ __forceinline__ bool fa_misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}
