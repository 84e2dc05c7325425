// Flash-attention forward for Hopper (sm_90a), float32 arithmetic.
//
// Replaces: src/repro/kernels/flash_attention.py `_fa_kernel` (the Pallas
// TPU kernel launched by `flash_attention_fwd_bhsd`).  Same function: online
// softmax attention with GQA (query head h reads kv head h / (H / Hkv)), a
// top-left causal mask (kpos <= qpos), a sliding window (kpos > qpos -
// window), tanh soft-capping, ragged S / Skv, and a skip of tiles that the
// causal/window structure masks entirely.  Emits out (q's dtype) and the
// per-row lse (float32); a fully-masked row gives out 0 and lse -1e30.
//
// What bounds it on the H100: operations.  At the main path's shape
// (S = 1024, hd 64, causal) each (q, k) pair costs 4*hd flops against
// 2*hd*4 bytes of K/V that every query tile re-reads from L2, so the work
// sits far above the card's ridge point; without tensor cores (float32
// math, TF32 off) the ceiling is the 67 TFLOP/s of the CUDA cores.
//
// Design: one CTA of 256 threads per (64-row query tile, head, batch); four
// lanes own one query row, each a quarter of its dims, and keep that part
// of the q row and of the output accumulator in registers, with the row's
// running max m and sum l (the TPU kernel's VMEM scratch and sequential kv
// grid axis become a loop inside the CTA).  Splitting the row four ways
// keeps registers low (no spills up to hd 128) and gives four times the
// warps of one thread per row, which the device half's B=2 shapes need to
// fill the card.  K and V tiles are staged in shared memory as float and
// read as float4, the same row by every row group of a warp.  The online-
// softmax rescale runs once per 16 keys.  Tensor cores (wgmma), TMA and a
// multi-stage pipeline are later work.
#include "fa_common.cuh"

namespace {

constexpr int kFwdBQ = 64;                  // query rows per CTA
constexpr int kFwdThreads = kFwdBQ * FA_TPR;
constexpr int kFwdKC = 16;                  // keys per online-softmax rescale

template <int HD> struct FwdTile { static constexpr int BK = HD <= 64 ? 64 : 32; };

template <typename T, int HD>
__global__ void __launch_bounds__(kFwdThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, float* __restrict__ lse, FaParams p) {
  constexpr int BK = FwdTile<HD>::BK, ND = HD / FA_TPR;
  __shared__ __align__(16) float ks[BK * HD];
  __shared__ __align__(16) float vs[BK * HD];

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * kFwdBQ;
  const int sub = threadIdx.x % FA_TPR;
  const int qpos = q0 + threadIdx.x / FA_TPR;
  const bool row_ok = qpos < p.S;
  const size_t row = ((size_t)b * p.H + h) * p.S + qpos;
  const size_t kv_off = ((size_t)b * p.Hkv + kh) * (size_t)p.Skv * HD;

  float qr[ND], acc[ND];
  fa_load_lane<T, HD>(qr, q + row * HD, sub, row_ok);
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  float m = FA_NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < p.Skv; k0 += BK) {
    if (!fa_tile_relevant(p, q0, kFwdBQ, k0, BK)) continue;  // uniform over the CTA
    __syncthreads();  // the previous tile is fully consumed
    fa_stage<T, HD, BK, kFwdThreads>(ks, k + kv_off, k0, p.Skv);
    fa_stage<T, HD, BK, kFwdThreads>(vs, v + kv_off, k0, p.Skv);
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < BK; j0 += kFwdKC) {
      float s[kFwdKC];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kFwdKC; ++jj) {
        const float dot = fa_row_sum(fa_dot<HD>(qr, ks + (j0 + jj) * HD, sub));
        if (fa_visible(p, qpos, k0 + j0 + jj)) {
          s[jj] = fa_logit(p, dot);
          mx = fmaxf(mx, s[jj]);
        } else {
          s[jj] = -INFINITY;  // exp(-inf - mx) == 0: masked keys add nothing
        }
      }
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kFwdKC; ++jj) {
        const float pj = expf(s[jj] - mx);
        l += pj;
        fa_axpy<HD>(acc, pj, vs + (j0 + jj) * HD, sub);
      }
      m = mx;
    }
  }

  if (!row_ok) return;
  const bool any = l > 0.f;
#pragma unroll
  for (int i = 0; i < ND; ++i)
    out[row * HD + fa_dim(i, sub)] = fa_from_float<T>(any ? acc[i] / l : 0.f);
  if (sub == 0) lse[row] = any ? m + logf(l) : FA_NEG_INF;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, const FaParams& p,
           cudaStream_t stream) {
  const dim3 grid((p.S + kFwdBQ - 1) / kFwdBQ, p.H, p.B);
  fa_fwd_kernel<T, HD><<<grid, kFwdThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out, float* lse,
              const FaParams& p, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, lse, p, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, p, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, p, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, S, hd), k/v (B, Hkv, Skv, hd) of `dtype`; out like q; lse (B, H, S)
// float32.  Launches on `stream` without synchronising; returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported dtype or hd).
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                      int dtype, int hd, int B, int H, int Hkv, int S, int Skv, int causal,
                      int window, float cap, float scale, void* stream) {
  const FaParams p{B, H, Hkv, S, Skv, causal, window, cap, scale};
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == FA_F32) return launch_hd<float>(hd, q, k, v, out, l, p, st);
  if (dtype == FA_BF16) return launch_hd<__nv_bfloat16>(hd, q, k, v, out, l, p, st);
  return (int)cudaErrorInvalidValue;
}
