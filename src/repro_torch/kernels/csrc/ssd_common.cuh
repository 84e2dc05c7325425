// Shared pieces of the two Mamba2 SSD kernels (ssd_fwd.cu, ssd_bwd.cu):
// the parameter block, the warp layout, staging of row tiles (cp.async,
// split planes, L1 prefetch), the 3xTF32 products on split planes, warp
// scans and a block sum.
//
// Layout everywhere (float32, contiguous): x, y, dy (B, T, H, P); dt (B, T, H);
// A (H,); B, C (B, T, G, N), head h reading group h / (H / G); states
// (B, H, nc, N, P), the state entering each chunk of Q steps (T = nc * Q).
//
// One CTA of 8 warps owns one (batch, head) and walks its chunks in order
// (the forward) or in reverse (the backward), which replaces the TPU
// kernels' sequential chunk grid axis (src/repro/kernels/ssd.py:100, :229).
// Inside a chunk both kernels hold a block of 128 rows (warp w owns rows
// 16w..16w+15 and all columns) and stream the partner rows in steps of 32,
// each step staged once as planes of big and small TF32 parts that all
// eight warps read (fa_mma.cuh has the product, the split and the fragment
// layouts).  Widths are padded with zero columns to N = 128 and P = 64 at
// pitches of 132 and 68 words (4 mod 16), and rows past Q are zero, so
// every N <= 128, P <= 64 runs the same code.
#pragma once

#include <cuda_runtime.h>

#include "fa_mma.cuh"

constexpr int kSsdThreads = 256;
constexpr int kMaxN = 128;                // largest state size N
constexpr int kMaxP = 64;                 // head dim P
constexpr size_t kMaxSmemBytes = 232448;  // H100: 227 KiB per block
constexpr int kWarps = kSsdThreads / 32;
constexpr int kBlk = 16 * kWarps;                  // rows of the held block
constexpr int kStep = 32;                          // rows of a streamed step
constexpr int kLdN = kMaxN + FaPad<float>::value;  // 132
constexpr int kLdP = kMaxP + FaPad<float>::value;  // 68
constexpr int kKN = kMaxN / 8;                     // 8-steps (or n-tiles) over N
constexpr int kKP = kMaxP / 8;                     // 8-steps (or n-tiles) over P
constexpr int kJS = kStep / 8;                     // n-tiles (or 8-steps) of a step
constexpr int kPlN = kStep * kLdN;                 // words of one plane of a streamed N-wide step
constexpr int kPlP = kStep * kLdP;                 // words of one plane of a streamed P-wide step
static_assert(kMaxN == 16 * kWarps, "warp w owns state rows 16w..16w+15");
static_assert(kMaxN % 16 == 0 && kMaxP % 16 == 0, "halves of 8-column tiles");

struct SsdParams {
  int B, T, H, P, G, N, Q, nc;
};

// Whether the (B, T, H, P, G, N, Q) problem is one the kernels take.
inline bool ssd_params_ok(const SsdParams& p) {
  return p.B > 0 && p.T > 0 && p.H > 0 && p.P > 0 && p.G > 0 && p.N > 0 && p.Q > 0 &&
         p.P <= kMaxP && p.N <= kMaxN && p.H % p.G == 0 && p.T % p.Q == 0;
}

// In-place inclusive prefix sum of a[0, n), by warp 0 (the others return at
// once; the caller synchronises before and after).
__device__ __forceinline__ void ssd_prefix_sum(float* a, int n) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float carry = 0.f;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    float v = i < n ? a[i] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    if (i < n) a[i] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// In-place inclusive suffix sum a[i] <- sum_{k >= i} a[k], by warp 0.
__device__ __forceinline__ void ssd_suffix_sum(float* a, int n) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float carry = 0.f;
  for (int top = n; top > 0; top -= 32) {
    const int i = top - 32 + lane;
    float v = i >= 0 ? a[i] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, v, o);
      if (lane + o < 32) v += u;
    }
    v += carry;
    if (i >= 0) a[i] = v;
    carry = __shfl_sync(0xffffffffu, v, 0);
  }
}

// Sum of v over the CTA, returned to every thread.  `red` holds >= 9 floats.
__device__ __forceinline__ float ssd_block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kSsdThreads / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[kSsdThreads / 32] = t;
  }
  __syncthreads();
  const float r = red[kSsdThreads / 32];
  __syncthreads();
  return r;
}

// acc[j] += A Bt^T for the warp's 16 rows of A (row-major f32, k over K,
// split at the read) and rows [8j, 8j + 8) of Bt (row-major, k along the
// row) staged as split planes (big at Bt, small PL words on).
template <int K, int NJ, int LDA, int LDB, int PL>
__device__ __forceinline__ void mma_abt_planes(float (&acc)[NJ][4], const float* A,
                                               const uint32_t* Bt, int g, int tq) {
#pragma unroll
  for (int ks = 0; ks < K / 8; ++ks) {
    uint32_t ab[4], as[4];
    fa_frag_a<true, LDA>(A + ks * 8, g, tq, ab, as);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint32_t* r = Bt + (8 * j + g) * LDB + ks * 8 + tq;
      const uint32_t bb[2] = {r[0], r[4]}, bs[2] = {r[PL], r[PL + 4]};
      fa_mma3<true, true>(acc[j], ab, as, bb, bs);
    }
  }
}

// out[n] += F R for F the warp's 16 x 8KJ accumulator tiles f (fed back as
// the A operand, k permuted) and R rows [0, 8KJ) of a row-major tile staged
// as split planes (fa_frag_b_rows' reads); each group of four n-tiles'
// products in fresh registers, joined by a rounded add.
template <int KJ, int NN, int LDR, int PL>
__device__ __forceinline__ void mma_acc_rows(float (&out)[NN][4], const float (&f)[KJ][4],
                                             const uint32_t* R, int g, int tq) {
  constexpr int kG = 4;
  static_assert(NN % kG == 0, "n-tiles in groups of four");
  uint32_t fb[KJ][4], fs[KJ][4];
#pragma unroll
  for (int k = 0; k < KJ; ++k) fa_frag_acc(f[k], fb[k], fs[k]);
#pragma unroll
  for (int n0 = 0; n0 < NN; n0 += kG) {
    float part[kG][4];
#pragma unroll
    for (int u = 0; u < kG; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[u][i] = 0.f;
#pragma unroll
    for (int k = 0; k < KJ; ++k)
#pragma unroll
      for (int u = 0; u < kG; ++u) {
        const uint32_t* r = R + (k * 8 + 2 * tq) * LDR + (n0 + u) * 8 + g;
        const uint32_t bb[2] = {r[0], r[LDR]}, bs[2] = {r[PL], r[PL + LDR]};
        fa_mma3<true, true>(part[u], fb[k], fs[k], bb, bs);
      }
#pragma unroll
    for (int u = 0; u < kG; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) out[n0 + u][i] += part[u][i];
  }
}

// cp.async of rows [r0, r0 + R) of a chunk (row r at src + r * stride,
// ncol floats) into dst with pitch ld, W columns: zeros past ncol and past
// row nvalid.  All of a thread's copies are in flight until fa_cp_wait.
template <int R, int W>
__device__ __forceinline__ void cp_rows(float* dst, int ld, const float* __restrict__ src,
                                        size_t stride, int r0, int nvalid, int ncol) {
  for (int idx = threadIdx.x; idx < R * W; idx += kSsdThreads) {
    const int r = idx / W, col = idx % W;
    const bool ok = r0 + r < nvalid && col < ncol;
    fa_cp4(dst + r * ld + col, ok ? src + (size_t)(r0 + r) * stride + col : src, ok);
  }
}

// Ask L1 for rows [r0, r0 + R) of a chunk ahead of their load, one prefetch
// per 128 bytes.
template <int R>
__device__ __forceinline__ void prefetch_rows(const float* __restrict__ src, size_t stride,
                                              int r0, int nvalid, int ncol) {
  const int per_row = (ncol + 31) / 32;
  for (int i = threadIdx.x; i < R * per_row; i += kSsdThreads) {
    const int r = i / per_row, col = i % per_row * 32;
    if (r0 + r < nvalid)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(src + (size_t)(r0 + r) * stride + col));
  }
}

// Rows as cp_rows reads them, loaded and split into planes: the big TF32
// part of each value at dst, the small one PL words on.
template <int R, int W, int PL>
__device__ __forceinline__ void load_split(uint32_t* dst, int ld, const float* __restrict__ src,
                                           size_t stride, int r0, int nvalid, int ncol) {
#pragma unroll 8
  for (int idx = threadIdx.x; idx < R * W; idx += kSsdThreads) {
    const int r = idx / W, col = idx % W;
    const float v = r0 + r < nvalid && col < ncol ? src[(size_t)(r0 + r) * stride + col] : 0.f;
    fa_split<true>(v, dst[r * ld + col], dst[PL + r * ld + col]);
  }
}
