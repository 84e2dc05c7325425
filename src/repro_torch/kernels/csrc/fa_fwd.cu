// Flash-attention forward for Hopper (sm_90a): 3xTF32 tensor-core products
// at float32 accuracy.
//
// Replaces: src/repro/kernels/flash_attention.py `_fa_kernel` (the Pallas
// TPU kernel launched by `flash_attention_fwd_bhsd`).  Same function: online
// softmax attention with GQA (query head h reads kv head h / (H / Hkv)), a
// top-left causal mask (kpos <= qpos), a sliding window (kpos > qpos -
// window), tanh soft-capping, ragged S / Skv, and a skip of tiles that the
// causal/window structure masks entirely.  Emits out (q's dtype) and the
// per-row lse (float32); a fully-masked row gives out 0 and lse -1e30.
//
// What bounds it on the H100: operations, 4*hd flops per visible pair.  At
// the main path's B=8, S=1024, 9:3 heads, hd 64, causal (37,785,600 visible
// pairs) the least time is 0.1444 ms with the products on the CUDA cores
// (67 TFLOP/s) and 0.0586 ms as 3xTF32 on the tensor cores (three TF32
// products of 495 TFLOP/s per f32 product); the bytes take 0.0151 ms.
//
// Design (FlashAttention-2 layout; fa_mma.cuh has the product, the split
// and the fragment layouts):
// - Every product is mma.sync.m16n8k8 TF32 with the 3xTF32 split (big·small
//   + small·big + big·big, f32 accumulation); a bf16 operand has no small
//   part, so its small products are skipped.
// - One CTA of 4 warps per (64-row query tile, head, batch); each warp owns
//   16 query rows.  CTAs run the longest (latest) query tiles first.
// - The warp keeps its Q fragments, split into big and small, in registers
//   for the whole kv loop (hd <= 64).  At hd 128 that would leave no room
//   for the output accumulators without spills, so the Q tile rides into
//   shared memory with the first kv tile and is split per use.
// - S = Q·Kᵀ sits in mma accumulators (16 x BK per warp).  The online
//   softmax works on them in log2 units (ex2): the row max takes two quad
//   shuffles once per kv tile, the row sum stays a per-lane partial until
//   the end.  P feeds P·V as the A operand straight from the accumulators
//   (keys permuted within each 8-key step, fa_mma.cuh): no shuffle, no
//   shared-memory bounce.
// - The soft-cap and the per-element mask branch once per tile; the mask
//   applies only where a warp's tile crosses the causal diagonal, a window
//   edge or the ragged end.
// - K and V tiles (BK = 64 keys for hd <= 64, 32 for hd 128) move into
//   shared memory with cp.async, double-buffered: tile j + 1 is in flight
//   while tile j is multiplied.  Rows are padded by 16 bytes (4 floats, 8
//   bf16), so every fragment read is free of bank conflicts.
// - At hd 64, f32: 198 registers (ptxas) and 2 stages x (K, V) x 64 x 68
//   floats = 69,632 bytes of shared memory per CTA.  The registers allow
//   two CTAs per SM (shared memory would allow three), 264 per wave: B=8
//   has 1,152 CTAs (4.4 waves), B=2 288 (1.1; the last are the shortest
//   query tiles).
// - Each CTA owns its rows' out and lse; no atomics, fixed reduction order.
#include "fa_mma.cuh"

namespace {

constexpr int kFwdWarps = 4;
constexpr int kFwdBQ = 16 * kFwdWarps;  // query rows per CTA
constexpr int kFwdThreads = 32 * kFwdWarps;

template <typename T, int HD> struct FwdTile {
  static constexpr int BK = HD <= 64 ? 64 : 32;  // keys per kv tile
  static constexpr int LD = HD + FaPad<T>::value;
  static constexpr int KS = HD / 8;   // k-steps of Q·Kᵀ, n-tiles of P·V
  static constexpr int NB = BK / 8;   // n-tiles of Q·Kᵀ, k-steps of P·V
  static constexpr bool kQReg = HD <= 64;  // Q split in registers; else staged in shared
  static constexpr int kSmem =  // stages x (K, V), and Q at hd 128
      (2 * 2 * BK * LD + (kQReg ? 0 : kFwdBQ * LD)) * (int)sizeof(T);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kFwdThreads, 1)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, float* __restrict__ lse, FaParams p) {
  using Tile = FwdTile<T, HD>;
  constexpr int BK = Tile::BK, LD = Tile::LD, KS = Tile::KS, NB = Tile::NB;
  constexpr bool kF32 = std::is_same_v<T, float>;  // operands loaded as f32 have a small part
  extern __shared__ __align__(16) unsigned char fa_smem[];
  T* k_s = reinterpret_cast<T*>(fa_smem);  // [2][BK][LD]
  T* v_s = k_s + 2 * BK * LD;              // [2][BK][LD]
  T* q_s = v_s + 2 * BK * LD;              // [kFwdBQ][LD], hd 128 only

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdBQ;
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int r0 = q0 + 16 * warp;  // the warp's first query row
  const size_t head = (size_t)b * p.H + h;
  const size_t kv_off = ((size_t)b * p.Hkv + kh) * (size_t)p.Skv * HD;
  const T* kg = k + kv_off;
  const T* vg = v + kv_off;

  // The relevant kv tiles form one range [j_lo, j_hi] (causal cuts a
  // suffix, the window a prefix).
  const int nk = (p.Skv + BK - 1) / BK;
  int j_lo = nk, j_hi = -1;
  for (int j = 0; j < nk; ++j)
    if (fa_tile_relevant(p, q0, kFwdBQ, j * BK, BK)) {
      j_lo = min(j_lo, j);
      j_hi = j;
    }
  auto issue = [&](int j, int stage) {
    fa_cp_rows<T, HD, LD, BK, kFwdThreads>(k_s + stage * BK * LD, kg, j * BK, p.Skv);
    fa_cp_rows<T, HD, LD, BK, kFwdThreads>(v_s + stage * BK * LD, vg, j * BK, p.Skv);
    fa_cp_commit();
  };
  const T* qh = q + head * p.S * HD;
  if (j_lo <= j_hi) {
    if constexpr (!Tile::kQReg) fa_cp_rows<T, HD, LD, kFwdBQ, kFwdThreads>(q_s, qh, q0, p.S);
    issue(j_lo, 0);  // Q rides in the first group
  }

  // Q fragments of the warp's 16 rows (zeros past S), one per k-step, split
  // once for the whole kv loop.
  uint32_t qb[Tile::kQReg ? KS : 1][4], qsm[Tile::kQReg ? KS : 1][4];
  if constexpr (Tile::kQReg) {
    const bool ok0 = r0 + g < p.S, ok1 = r0 + g + 8 < p.S;
    const T* row0 = qh + (size_t)(r0 + g) * HD + t;
    const T* row1 = row0 + 8 * HD;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      fa_split<kF32>(ok0 ? fa_to_float(row0[8 * s]) : 0.f, qb[s][0], qsm[s][0]);
      fa_split<kF32>(ok1 ? fa_to_float(row1[8 * s]) : 0.f, qb[s][1], qsm[s][1]);
      fa_split<kF32>(ok0 ? fa_to_float(row0[8 * s + 4]) : 0.f, qb[s][2], qsm[s][2]);
      fa_split<kF32>(ok1 ? fa_to_float(row1[8 * s + 4]) : 0.f, qb[s][3], qsm[s][3]);
    }
  }

  float o[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.f, 0.f};  // rows g, g + 8; m in log2 units
  const float scale2 = p.scale * FA_LOG2E;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int stage = (j - j_lo) & 1;
    if (j < j_hi) {
      issue(j + 1, stage ^ 1);
      fa_cp_wait<1>();
    } else {
      fa_cp_wait<0>();
    }
    __syncthreads();  // tile j has landed for every thread
    const T* kt = k_s + stage * BK * LD;
    const T* vt = v_s + stage * BK * LD;
    const int k0 = j * BK;

    // S = Q·Kᵀ
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ab[4], as[4];
      if constexpr (Tile::kQReg) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ab[i] = qb[ks][i];
          as[i] = qsm[ks][i];
        }
      } else {
        fa_frag_a<kF32, LD>(q_s + 16 * warp * LD + ks * 8, g, t, ab, as);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        uint32_t bb[2], bs[2];
        fa_frag_bt<kF32, LD>(kt + n * 8 * LD + ks * 8, g, t, bb, bs);
        fa_mma3<kF32, kF32>(s[n], ab, as, bb, bs);
      }
    }

    // Logits (in log2 units), masks and the online softmax on the
    // accumulators.  The cap and the mask branch once per tile.
    if (p.cap > 0.f) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = fa_logit(p, s[n][i]) * FA_LOG2E;
    } else {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] *= scale2;
    }
    const bool unmasked = k0 + BK <= p.Skv && (!p.causal || k0 + BK - 1 <= r0) &&
                          (p.window <= 0 || k0 > r0 + 15 - p.window);
    if (!unmasked) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!fa_visible(p, r0 + g + 8 * (i >> 1), k0 + 8 * n + 2 * t + (i & 1)))
            s[n][i] = -INFINITY;  // 2^(-inf - mx) == 0: masked keys add nothing
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = fa_exp2(m[r] - mx[r]);
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = fa_exp2(s[n][i] - mx[i >> 1]);
        l[i >> 1] += s[n][i];
      }

    // O += P·V, P straight from the accumulators.
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      uint32_t ab[4], as[4];
      fa_frag_acc(s[kk], ab, as);
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        uint32_t bb[2], bs[2];
        fa_frag_b_rows<kF32, LD>(vt + kk * 8 * LD + n * 8, g, t, bb, bs);
        fa_mma3<true, kF32>(o[n], ab, as, bb, bs);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + g + 8 * r;
    if (row >= p.S) continue;
    const bool any = l[r] > 0.f;
    T* orow = out + (head * p.S + row) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < KS; ++n)
      fa_store2(orow + 8 * n, any ? o[n][2 * r] / l[r] : 0.f, any ? o[n][2 * r + 1] / l[r] : 0.f);
    if (t == 0) lse[head * p.S + row] = any ? m[r] * FA_LN2 + logf(l[r]) : FA_NEG_INF;
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, const FaParams& p,
           cudaStream_t stream) {
  constexpr int smem = FwdTile<T, HD>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.S + kFwdBQ - 1) / kFwdBQ, p.H, p.B);
  fa_fwd_kernel<T, HD><<<grid, kFwdThreads, smem, stream>>>(
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
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported dtype or hd,
// cudaErrorMisalignedAddress when k or v is not 16-byte aligned).
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                      int dtype, int hd, int B, int H, int Hkv, int S, int Skv, int causal,
                      int window, float cap, float scale, void* stream) {
  const FaParams p{B, H, Hkv, S, Skv, causal, window, cap, scale};
  if (fa_misaligned(k) || fa_misaligned(v)) return (int)cudaErrorMisalignedAddress;
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == FA_F32) return launch_hd<float>(hd, q, k, v, out, l, p, st);
  if (dtype == FA_BF16) return launch_hd<__nv_bfloat16>(hd, q, k, v, out, l, p, st);
  return (int)cudaErrorInvalidValue;
}
