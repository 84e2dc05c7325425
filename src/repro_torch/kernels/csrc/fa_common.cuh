// Shared pieces of the three flash-attention kernels (fa_fwd.cu,
// fa_bwd_dq.cu, fa_bwd_dkv.cu): element conversion, the mask of one
// (query, key) pair, the whole-tile skip predicate, the soft-capped logit
// and the parameter block.  Their tensor-core pieces are in fa_mma.cuh.
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
