// Shared pieces of the three flash-attention kernels (fa_fwd.cu,
// fa_bwd_dq.cu, fa_bwd_dkv.cu): element conversion, the mask of one
// (query, key) pair, the whole-tile skip predicate and the parameter block;
// then the SIMT row helpers of fa_bwd_dq.cu (the tensor-core pieces of the
// other two are in fa_mma.cuh).
//
// Layout everywhere: q, o, do (B, H, S, HD) and k, v (B, Hkv, Skv, HD),
// contiguous; lse and delta (B, H, S) float32.  Arithmetic is float32 for
// float32 and bfloat16 inputs alike.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FA_NEG_INF (-1e30f)  // lse of a fully-masked row (NEG_INF in the reference)

struct FaParams {
  int B, H, Hkv, S, Skv;
  int causal;   // 1: key kpos is visible to query qpos only if kpos <= qpos (top-left)
  int window;   // > 0: also kpos > qpos - window; <= 0: no window
  float cap;    // > 0: logits soft-capped as cap * tanh(s / cap); <= 0: none
  float scale;  // 1 / sqrt(HD)
};

enum FaDtype { FA_F32 = 0, FA_BF16 = 1 };

__device__ __forceinline__ float fa_to_float(float x) { return x; }
__device__ __forceinline__ float fa_to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Whether query qpos may attend to key kpos (padding, causal, window).
__device__ __forceinline__ bool fa_visible(const FaParams& p, int qpos, int kpos) {
  if (qpos >= p.S || kpos >= p.Skv) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

// False iff the causal/window structure masks every pair of the tile
// [q0, q0 + nq) x [k0, k0 + nk) (the reference's _tile_relevant).
__device__ __forceinline__ bool fa_tile_relevant(const FaParams& p, int q0, int nq, int k0, int nk) {
  if (p.causal && k0 > q0 + nq - 1) return false;
  if (p.window > 0 && k0 + nk - 1 <= q0 - p.window) return false;
  return true;
}

// Logit z of one pair from its raw dot product (scale, then soft-cap).
__device__ __forceinline__ float fa_logit(const FaParams& p, float dot) {
  float s = dot * p.scale;
  if (p.cap > 0.f) s = p.cap * tanhf(s / p.cap);
  return s;
}

// The SIMT pieces of the dq kernel.  Four consecutive lanes share one
// query row: lane `sub` of the four owns the HD/4 dims
// {16c + 4sub + i : c < HD/16, i < 4}, so the four lanes' float4 reads of
// one shared-memory row hit distinct banks.  A dot product over HD is each
// lane's partial sum, completed by two xor-shuffles; the four lanes end with
// bitwise-equal sums.  Every lane of a warp must reach each shuffle.
constexpr int FA_TPR = 4;

__device__ __forceinline__ float fa_row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// This lane's partial dot of its dims `a` with the float row `row`.
template <int HD>
__device__ __forceinline__ float fa_dot(const float* a, const float* row, int sub) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    const float4 b = *reinterpret_cast<const float4*>(row + 16 * c + 4 * sub);
    s = fmaf(a[4 * c], b.x, s);
    s = fmaf(a[4 * c + 1], b.y, s);
    s = fmaf(a[4 * c + 2], b.z, s);
    s = fmaf(a[4 * c + 3], b.w, s);
  }
  return s;
}

// acc += w * (this lane's dims of the float row `row`).
template <int HD>
__device__ __forceinline__ void fa_axpy(float* acc, float w, const float* row, int sub) {
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    const float4 b = *reinterpret_cast<const float4*>(row + 16 * c + 4 * sub);
    acc[4 * c] = fmaf(w, b.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, b.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, b.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, b.w, acc[4 * c + 3]);
  }
}

// Index within a row of this lane's i-th dim (i < HD / 4).
__device__ __forceinline__ int fa_dim(int i, int sub) { return 16 * (i / 4) + 4 * sub + i % 4; }

// This lane's dims of global row `src` as float (zeros when !ok).
template <typename T, int HD>
__device__ __forceinline__ void fa_load_lane(float* dst, const T* src, int sub, bool ok) {
#pragma unroll
  for (int i = 0; i < HD / FA_TPR; ++i) dst[i] = ok ? fa_to_float(src[fa_dim(i, sub)]) : 0.f;
}

// Stage rows [r0, r0 + R) of a (rows, HD) matrix into shared memory
// [R][HD] as float, zero past n_rows.  Coalesced: consecutive threads,
// consecutive elements.
template <typename T, int HD, int R, int NT>
__device__ __forceinline__ void fa_stage(float* dst, const T* src, int r0, int n_rows) {
  for (int idx = threadIdx.x; idx < R * HD; idx += NT) {
    const int r = idx / HD;
    dst[idx] = (r0 + r < n_rows) ? fa_to_float(src[(size_t)(r0 + r) * HD + idx % HD]) : 0.f;
  }
}
