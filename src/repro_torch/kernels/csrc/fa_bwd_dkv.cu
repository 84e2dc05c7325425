// Flash-attention backward, dk and dv, for Hopper (sm_90a), float32 math.
//
// Replaces: src/repro/kernels/flash_attention.py `_fa_bwd_dkv_kernel` (the
// second Pallas call of `flash_attention_bwd_bhsd`, grid (B, Hkv, nk, group,
// nq)).  Same function:
//   dk_j = scale * sum_i dS_ij q_i,  dv_j = sum_i p_ij dO_i,
// summed over the GQA group's query heads and all query rows, recomputing p
// and dS from (q, k, v, dO, lse, delta) as the dq kernel does, with causal,
// window, soft-cap, ragged S / Skv and the whole-tile skip.  dk, dv float32.
//
// What bounds it on the H100: operations (8*hd flops per visible pair on the
// CUDA cores, float32, TF32 off).  Its parallelism is the number of key
// rows, B * Hkv * Skv, a third of the dq kernel's query rows at GQA 9:3:
// at the device half's B=2 few warps are resident to hide latency.
//
// Design: one CTA of 128 threads per (32-key tile, kv head, batch); four
// lanes own one key row, each a quarter of its dims of k_j, v_j and the
// dk/dv accumulators in registers (four lanes per row keep registers low
// and multiply the resident warps by four).  The CTA loops over the group's
// query heads x query tiles (the TPU grid's sequential (group, nq) axes),
// staging q, dO, lse and delta tiles in shared memory, read as float4.  One
// CTA owns its dk/dv rows outright, so there are no atomics.
#include "fa_common.cuh"

namespace {

template <int HD> struct DkvTile {
  static constexpr int BKV = 32;                  // key rows per CTA
  static constexpr int BQ = HD <= 64 ? 64 : 32;   // query rows per staged tile
  static constexpr int NT = BKV * FA_TPR;         // threads per CTA
};

template <typename T, int HD>
__global__ void __launch_bounds__(DkvTile<HD>::NT)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, FaParams p) {
  constexpr int BKV = DkvTile<HD>::BKV, BQ = DkvTile<HD>::BQ, NT = DkvTile<HD>::NT;
  constexpr int ND = HD / FA_TPR;
  __shared__ __align__(16) float qs[BQ * HD];
  __shared__ __align__(16) float dos[BQ * HD];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int kh = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.Hkv;
  const int k0 = blockIdx.x * BKV;
  const int sub = threadIdx.x % FA_TPR;
  const int kpos = k0 + threadIdx.x / FA_TPR;
  const bool row_ok = kpos < p.Skv;
  const size_t krow = ((size_t)b * p.Hkv + kh) * p.Skv + kpos;

  float kr[ND], vr[ND], dk_acc[ND], dv_acc[ND];
  fa_load_lane<T, HD>(kr, k + krow * HD, sub, row_ok);
  fa_load_lane<T, HD>(vr, v + krow * HD, sub, row_ok);
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  for (int g = 0; g < group; ++g) {
    const size_t hrow = ((size_t)b * p.H + kh * group + g) * p.S;  // first row of head h
    for (int q0 = 0; q0 < p.S; q0 += BQ) {
      if (!fa_tile_relevant(p, q0, BQ, k0, BKV)) continue;  // uniform over the CTA
      __syncthreads();  // the previous tile is fully consumed
      fa_stage<T, HD, BQ, NT>(qs, q + hrow * HD, q0, p.S);
      fa_stage<T, HD, BQ, NT>(dos, dout + hrow * HD, q0, p.S);
      fa_stage_rows<BQ, NT>(lse_s, lse + hrow, q0, p.S);
      fa_stage_rows<BQ, NT>(delta_s, delta + hrow, q0, p.S);
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        const float* qi = qs + i * HD;
        const float* doi = dos + i * HD;
        const float dot = fa_row_sum(fa_dot<HD>(kr, qi, sub));
        const float dp = fa_row_sum(fa_dot<HD>(vr, doi, sub));
        if (!fa_visible(p, q0 + i, kpos)) continue;
        const float z = fa_logit(p, dot);
        const float pj = expf(z - lse_s[i]);
        float ds = pj * (dp - delta_s[i]);
        if (p.cap > 0.f) {
          const float t = z / p.cap;
          ds *= 1.f - t * t;
        }
        fa_axpy<HD>(dv_acc, pj, doi, sub);
        fa_axpy<HD>(dk_acc, ds, qi, sub);
      }
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    dk[krow * HD + fa_dim(i, sub)] = dk_acc[i] * p.scale;
    dv[krow * HD + fa_dim(i, sub)] = dv_acc[i];
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, float* dk, float* dv, const FaParams& p, cudaStream_t stream) {
  const dim3 grid((p.Skv + DkvTile<HD>::BKV - 1) / DkvTile<HD>::BKV, p.Hkv, p.B);
  fa_bwd_dkv_kernel<T, HD><<<grid, DkvTile<HD>::NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dk, dv, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, float* dk, float* dv, const FaParams& p,
              cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dk, dv, p, stream);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, p, stream);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, p, stream);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/dout (B, H, S, hd), k/v (B, Hkv, Skv, hd) of `dtype`; lse, delta (B, H, S)
// float32; dk, dv (B, Hkv, Skv, hd) float32.  Launches on `stream` without
// synchronising; returns the launch's cudaGetLastError().
extern "C" int fa_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dk, void* dv, int dtype,
                          int hd, int B, int H, int Hkv, int S, int Skv, int causal, int window,
                          float cap, float scale, void* stream) {
  const FaParams p{B, H, Hkv, S, Skv, causal, window, cap, scale};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* a = static_cast<float*>(dk);
  float* c = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == FA_F32) return launch_hd<float>(hd, q, k, v, dout, l, dl, a, c, p, st);
  if (dtype == FA_BF16) return launch_hd<__nv_bfloat16>(hd, q, k, v, dout, l, dl, a, c, p, st);
  return (int)cudaErrorInvalidValue;
}
