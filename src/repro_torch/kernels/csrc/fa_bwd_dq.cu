// Flash-attention backward, dq, for Hopper (sm_90a), float32 arithmetic.
//
// Replaces: src/repro/kernels/flash_attention.py `_fa_bwd_dq_kernel` (the
// first Pallas call of `flash_attention_bwd_bhsd`).  Same function:
//   dq_i = scale * sum_j dS_ij k_j,  dS = p (dO v^T - delta) (1 - (z/cap)^2),
//   p = exp(z - lse) on visible pairs, z = softcap(scale q k^T),
// recomputed from (q, k, v, dO, lse, delta) without materialising the
// (S x Skv) scores, with GQA, causal, window, soft-cap, ragged S / Skv and
// the whole-tile skip.  dq is float32.
//
// What bounds it on the H100: operations.  Each visible pair costs 6*hd
// flops (q k^T, dO v^T, dS k) on the CUDA cores (float32 math, TF32 off);
// the bytes (q, k, v, dO, lse, delta in, dq out) are tens of megabytes.
//
// Design: the forward's grid and lane layout, one CTA of 256 threads per
// (64-row query tile, head, batch); four lanes own one query row, each a
// quarter of its dims of q, dO and the dq accumulator in registers, with
// the row's lse and delta.  The kv tiles are staged in shared memory as
// float and read as float4.  No reduction crosses CTAs, so no atomics.
#include "fa_common.cuh"

namespace {

constexpr int kDqBQ = 64;                  // query rows per CTA
constexpr int kDqThreads = kDqBQ * FA_TPR;

template <int HD> struct DqTile { static constexpr int BK = HD <= 64 ? 64 : 32; };

template <typename T, int HD>
__global__ void __launch_bounds__(kDqThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq, FaParams p) {
  constexpr int BK = DqTile<HD>::BK, ND = HD / FA_TPR;
  __shared__ __align__(16) float ks[BK * HD];
  __shared__ __align__(16) float vs[BK * HD];

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * kDqBQ;
  const int sub = threadIdx.x % FA_TPR;
  const int qpos = q0 + threadIdx.x / FA_TPR;
  const bool row_ok = qpos < p.S;
  const size_t row = ((size_t)b * p.H + h) * p.S + qpos;
  const size_t kv_off = ((size_t)b * p.Hkv + kh) * (size_t)p.Skv * HD;

  float qr[ND], dor[ND], acc[ND];
  fa_load_lane<T, HD>(qr, q + row * HD, sub, row_ok);
  fa_load_lane<T, HD>(dor, dout + row * HD, sub, row_ok);
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  const float lse_i = row_ok ? lse[row] : 0.f;
  const float delta_i = row_ok ? delta[row] : 0.f;

  for (int k0 = 0; k0 < p.Skv; k0 += BK) {
    if (!fa_tile_relevant(p, q0, kDqBQ, k0, BK)) continue;  // uniform over the CTA
    __syncthreads();
    fa_stage<T, HD, BK, kDqThreads>(ks, k + kv_off, k0, p.Skv);
    fa_stage<T, HD, BK, kDqThreads>(vs, v + kv_off, k0, p.Skv);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float* kr = ks + j * HD;
      const float dot = fa_row_sum(fa_dot<HD>(qr, kr, sub));
      const float dp = fa_row_sum(fa_dot<HD>(dor, vs + j * HD, sub));
      if (!fa_visible(p, qpos, k0 + j)) continue;
      const float z = fa_logit(p, dot);
      float ds = expf(z - lse_i) * (dp - delta_i);
      if (p.cap > 0.f) {
        const float t = z / p.cap;
        ds *= 1.f - t * t;
      }
      fa_axpy<HD>(acc, ds, kr, sub);
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int i = 0; i < ND; ++i) dq[row * HD + fa_dim(i, sub)] = acc[i] * p.scale;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, float* dq, const FaParams& p, cudaStream_t stream) {
  const dim3 grid((p.S + kDqBQ - 1) / kDqBQ, p.H, p.B);
  fa_bwd_dq_kernel<T, HD><<<grid, kDqThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dq, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, float* dq, const FaParams& p,
              cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dq, p, stream);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, dq, p, stream);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dq, p, stream);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dq, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/dout (B, H, S, hd), k/v (B, Hkv, Skv, hd) of `dtype`; lse, delta (B, H, S)
// and dq (B, H, S, hd) float32.  Launches on `stream` without synchronising;
// returns the launch's cudaGetLastError().
extern "C" int fa_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, int dtype, int hd, int B,
                         int H, int Hkv, int S, int Skv, int causal, int window, float cap,
                         float scale, void* stream) {
  const FaParams p{B, H, Hkv, S, Skv, causal, window, cap, scale};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* o = static_cast<float*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == FA_F32) return launch_hd<float>(hd, q, k, v, dout, l, dl, o, p, st);
  if (dtype == FA_BF16) return launch_hd<__nv_bfloat16>(hd, q, k, v, dout, l, dl, o, p, st);
  return (int)cudaErrorInvalidValue;
}
