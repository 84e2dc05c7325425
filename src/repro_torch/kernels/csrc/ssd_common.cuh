// Shared pieces of the two Mamba2 SSD kernels (ssd_fwd.cu, ssd_bwd.cu):
// the parameter block, the thread layout of a 64 x 64 tile, tile loads,
// warp scans and a block sum.
//
// Layout everywhere (float32, contiguous): x, y, dy (B, T, H, P); dt (B, T, H);
// A (H,); B, C (B, T, G, N), head h reading group h / (H / G); states
// (B, H, nc, N, P), the state entering each chunk of Q steps (T = nc * Q).
//
// One CTA of 256 threads owns one (batch, head) and walks its chunks in
// order (the forward) or in reverse (the backward), which replaces the TPU
// kernels' sequential chunk grid axis (src/repro/kernels/ssd.py:100, :229).
// The forward (SIMT): inside a chunk, the (Q, Q) decay/score tile does not
// fit in shared memory at Q = 256 (256 KiB), so it is walked in 64 x 64
// sub-tiles, s-block <= t-block only.  The thread (ty, tx) = (tid / 16,
// tid % 16) of a tile owns rows ty + 16 i and columns tx + 16 j: rows are
// broadcast reads within a half-warp, columns hit distinct banks (its row
// pitches are odd).  The backward runs on the tensor cores with its own
// layout and 16-byte row pads (ssd_bwd.cu).
#pragma once

#include <cuda_runtime.h>

constexpr int kSsdThreads = 256;
constexpr int kTile = 64;                 // rows of a t- or s-block
constexpr int kLdT = kTile + 1;           // pitch of a 64 x 64 tile in shared memory
constexpr int kRows = kTile / 16;         // tile rows per thread
constexpr int kMaxN = 128;                // largest state size N
constexpr int kMaxP = 64;                 // head dim P
constexpr int kColsN = kMaxN / 16;        // columns over N per thread
constexpr int kColsP = kMaxP / 16;        // columns over P per thread
constexpr size_t kMaxSmemBytes = 232448;  // H100: 227 KiB per block

struct SsdParams {
  int B, T, H, P, G, N, Q, nc;
};

// Whether the (B, T, H, P, G, N, Q) problem is one the kernels take.
inline bool ssd_params_ok(const SsdParams& p) {
  return p.B > 0 && p.T > 0 && p.H > 0 && p.P > 0 && p.G > 0 && p.N > 0 && p.Q > 0 &&
         p.P <= kMaxP && p.N <= kMaxN && p.H % p.G == 0 && p.T % p.Q == 0;
}

// Copy rows [r0, r0 + 64) of a chunk (row r at src + r * stride, `ncol`
// floats each) into dst with pitch `ld`, times scale[r] if given; rows at or
// past `nvalid` are zero.
__device__ __forceinline__ void ssd_load_rows(float* dst, int ld, const float* __restrict__ src,
                                              size_t stride, int r0, int nvalid, int ncol,
                                              const float* scale = nullptr) {
  for (int idx = threadIdx.x; idx < kTile * ncol; idx += kSsdThreads) {
    const int r = idx / ncol, col = idx - r * ncol;
    float v = 0.f;
    if (r0 + r < nvalid) {
      v = src[(size_t)(r0 + r) * stride + col];
      if (scale) v *= scale[r0 + r];
    }
    dst[r * ld + col] = v;
  }
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
