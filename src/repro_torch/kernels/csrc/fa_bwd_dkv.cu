// Flash-attention backward, dk and dv, for Hopper (sm_90a): 3xTF32
// tensor-core products at float32 accuracy.
//
// Replaces: src/repro/kernels/flash_attention.py `_fa_bwd_dkv_kernel` (the
// second Pallas call of `flash_attention_bwd_bhsd`, grid (B, Hkv, nk, group,
// nq)).  Same function:
//   dk_j = scale * sum_i dS_ij q_i,  dv_j = sum_i p_ij dO_i,
// summed over the GQA group's query heads and all query rows, recomputing p
// and dS from (q, k, v, dO, lse, delta) as the dq kernel does, with causal,
// window, soft-cap, ragged S / Skv and the whole-tile skip.  dk, dv float32.
//
// What bounds it on the H100: operations, 8*hd flops per visible pair
// (K·Qᵀ, V·dOᵀ, Pᵀ·dO, dSᵀ·Q).  At the main path's B=8, S=1024, 9:3 heads,
// hd 64, causal the least time is 0.2887 ms on the CUDA cores (67 TFLOP/s)
// and 0.1173 ms as 3xTF32 on the tensor cores; the bytes take 0.0190 ms.
//
// Design (fa_mma.cuh has the product, the split and the fragment layouts):
// - Every product is mma.sync.m16n8k8 TF32 with the 3xTF32 split (big·small
//   + small·big + big·big, f32 accumulation); a bf16 operand has no small
//   part, so its small products are skipped.
// - One CTA of 4 warps per (32-key tile, kv head, batch).  Warp w owns the
//   16 keys of block w % 2 and the half w / 2 of every staged query tile;
//   it holds its keys' dk and dv (16 x hd each) in registers.  The CTA
//   loops over the group's query heads x the relevant query tiles.
// - K and V are split into {big, small} once, into shared memory, while
//   the first query tile is in flight.
// - Per query tile: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ in accumulators; Pᵀ =
//   exp(softcap(scale·Sᵀ) - lse) (ex2) and dSᵀ = Pᵀ (dPᵀ - delta)
//   (1 - (z/cap)^2), masked; then dv += Pᵀ·dO and dk += dSᵀ·Q with Pᵀ and
//   dSᵀ fed straight from the accumulators as A operands (queries permuted
//   within each 8-step, fa_mma.cuh).  Each tile's dv and dk products
//   accumulate in fresh registers and join the running sums by a rounded
//   f32 add: the tensor core's accumulation does not round to nearest, and
//   over a group's thousands of query rows its error builds up.
// - Q and dO tiles (64 rows; 32 at hd 128) and their lse and delta move
//   into shared memory with cp.async, double-buffered: the next (head,
//   query tile) is in flight while the current one is multiplied.  Rows are
//   padded by 16 bytes, so fragment reads are free of bank conflicts.
// - The soft-cap and the per-element mask branch once per tile; the mask
//   applies only where a warp's tile crosses the diagonal, a window edge or
//   a ragged end.
// - At the end the two query halves of a key block are summed in a fixed
//   order (half 1 hands its sums to half 0 through shared memory), so each
//   CTA owns its dk/dv rows outright: no atomics, deterministic.
// - Why 32 keys: at 64 keys per CTA the device half's B=2 has
//   B·Hkv·Skv/64 = 96 CTAs for 132 SMs; at 32 it has 192 (768 warps), and
//   the server half's B=8 has 768.  At hd 64, f32: 222 registers (ptxas)
//   and 105,472 bytes of shared memory per CTA (split K, V 34,816; Q, dO
//   2 x 2 x 64 x 68 floats = 69,632; lse, delta 1,024); both allow two
//   CTAs per SM, 264 per wave: B=2 fits in one wave (0.7), B=8 takes 2.9.
#include "fa_mma.cuh"

namespace {

constexpr int kDkvWarps = 4;
constexpr int kDkvThreads = 32 * kDkvWarps;

template <typename T, int HD> struct DkvTile {
  static constexpr int BKV = 32;                 // keys per CTA: two blocks of 16
  static constexpr int BQ = HD <= 64 ? 64 : 32;  // query rows per staged tile
  static constexpr int QW = BQ / 2;              // query rows per warp
  static constexpr int LD = HD + FaPad<T>::value;
  static constexpr int KS = HD / 8;  // k-steps of K·Qᵀ, n-tiles of Pᵀ·dO
  static constexpr int NQ = QW / 8;  // n-tiles of K·Qᵀ, k-steps of Pᵀ·dO
  static constexpr int LD2 = HD + 4;        // row stride of the split K, V ({big, small})
  static constexpr int kKV = 2 * BKV * LD2;  // K, V {big, small} pairs
  static constexpr int kQ = BQ * LD;         // elements of one staged Q (or dO) tile
  static constexpr int kSmem = kKV * 8 + 2 * 2 * kQ * (int)sizeof(T) + 2 * 2 * BQ * 4;
  static constexpr int LR = HD + 8;  // row stride of the final fold's floats
  static_assert(2 * 2 * 16 * LR * 4 <= 2 * 2 * kQ * (int)sizeof(T),
                "the fold of the two query halves reuses the Q/dO stages");
};

template <typename T, int HD>
__global__ void __launch_bounds__(kDkvThreads, 1)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, FaParams p) {
  using Tile = DkvTile<T, HD>;
  constexpr int BKV = Tile::BKV, BQ = Tile::BQ, QW = Tile::QW, LD = Tile::LD;
  constexpr int KS = Tile::KS, NQ = Tile::NQ, kQ = Tile::kQ, NT = kDkvThreads;
  constexpr bool kF32 = std::is_same_v<T, float>;  // operands loaded as f32 have a small part
  extern __shared__ __align__(16) unsigned char fa_smem[];
  uint2* k_s = reinterpret_cast<uint2*>(fa_smem);          // [BKV][LD2] {big, small}
  uint2* v_s = k_s + BKV * Tile::LD2;                       // [BKV][LD2]
  T* q_s = reinterpret_cast<T*>(k_s + Tile::kKV);           // [2][BQ][LD]
  T* do_s = q_s + 2 * kQ;                                   // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kQ);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                             // [2][BQ]

  const int kh = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.Hkv;
  const int k0 = blockIdx.x * BKV;
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int kb = warp % 2, half = warp / 2;
  const int kw = k0 + 16 * kb;  // the warp's first key
  const size_t kv_off = ((size_t)b * p.Hkv + kh) * (size_t)p.Skv * HD;

  // The relevant query tiles form one range [t_lo, t_lo + nrel) for every
  // head of the group (causal cuts a prefix, the window a suffix).
  const int nq = (p.S + BQ - 1) / BQ;
  int t_lo = nq, t_hi = -1;
  for (int i = 0; i < nq; ++i)
    if (fa_tile_relevant(p, i * BQ, BQ, k0, BKV)) {
      t_lo = min(t_lo, i);
      t_hi = i;
    }
  const int nrel = max(t_hi - t_lo + 1, 0), n_it = group * nrel;
  auto head_row = [&](int it) { return ((size_t)b * p.H + kh * group + it / nrel) * p.S; };
  auto issue = [&](int it, int stage) {
    const size_t hrow = head_row(it);
    const int q0 = (t_lo + it % nrel) * BQ;
    fa_cp_rows<T, HD, LD, BQ, NT>(q_s + stage * kQ, q + hrow * HD, q0, p.S);
    fa_cp_rows<T, HD, LD, BQ, NT>(do_s + stage * kQ, dout + hrow * HD, q0, p.S);
    fa_cp_vals<BQ, NT>(lse_s + stage * BQ, lse + hrow, q0, p.S);
    fa_cp_vals<BQ, NT>(dl_s + stage * BQ, delta + hrow, q0, p.S);
    fa_cp_commit();
  };
  if (n_it > 0) issue(0, 0);
  // K and V, split once into {big, small} while the first tile is in flight
  // (zeros past Skv).
  for (int i = threadIdx.x; i < BKV * HD; i += NT) {
    const int r = i / HD, c = i % HD;
    const bool ok = k0 + r < p.Skv;
    const size_t at = kv_off + (size_t)(k0 + r) * HD + c;
    uint2 kk, vv;
    fa_split<kF32>(ok ? fa_to_float(k[at]) : 0.f, kk.x, kk.y);
    fa_split<kF32>(ok ? fa_to_float(v[at]) : 0.f, vv.x, vv.y);
    k_s[r * Tile::LD2 + c] = kk;
    v_s[r * Tile::LD2 + c] = vv;
  }

  float dk_acc[KS][4], dv_acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dk_acc[n][i] = 0.f;
      dv_acc[n][i] = 0.f;
    }
  const uint2* kt = k_s + 16 * kb * Tile::LD2;
  const uint2* vt = v_s + 16 * kb * Tile::LD2;
  const float scale2 = p.scale * FA_LOG2E;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) {
      issue(it + 1, stage ^ 1);
      fa_cp_wait<1>();
    } else {
      fa_cp_wait<0>();
    }
    __syncthreads();  // this stage (and the split K, V) is there for every thread
    const int qw = (t_lo + it % nrel) * BQ + half * QW;  // the warp's first query
    const T* qt = q_s + stage * kQ + half * QW * LD;
    const T* dot = do_s + stage * kQ + half * QW * LD;
    const float* lse_w = lse_s + stage * BQ + half * QW;
    const float* dl_w = dl_s + stage * BQ + half * QW;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = 0.f;
        dp[n][i] = 0.f;
      }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kab[4], kas[4], vab[4], vas[4];
      fa_frag_a_split<Tile::LD2>(kt + ks * 8, g, t, kab, kas);
      fa_frag_a_split<Tile::LD2>(vt + ks * 8, g, t, vab, vas);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        uint32_t bb[2], bs[2];
        fa_frag_bt<kF32, LD>(qt + n * 8 * LD + ks * 8, g, t, bb, bs);
        fa_mma3<kF32, kF32>(s[n], kab, kas, bb, bs);
        fa_frag_bt<kF32, LD>(dot + n * 8 * LD + ks * 8, g, t, bb, bs);
        fa_mma3<kF32, kF32>(dp[n], vab, vas, bb, bs);
      }
    }

    // Pᵀ and dSᵀ in place of Sᵀ and dPᵀ; the cap and the mask branch once
    // per tile.
    if (p.cap > 0.f) {
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = 8 * n + 2 * t + (i & 1);  // query within the warp's rows
          const float z = fa_logit(p, s[n][i]), c = z / p.cap;
          s[n][i] = fa_exp2(z * FA_LOG2E - lse_w[qi] * FA_LOG2E);
          dp[n][i] = s[n][i] * (dp[n][i] - dl_w[qi]) * (1.f - c * c);
        }
    } else {
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = 8 * n + 2 * t + (i & 1);
          s[n][i] = fa_exp2(s[n][i] * scale2 - lse_w[qi] * FA_LOG2E);
          dp[n][i] = s[n][i] * (dp[n][i] - dl_w[qi]);
        }
    }
    const bool unmasked = qw + QW <= p.S && kw + 16 <= p.Skv &&
                          (!p.causal || kw + 15 <= qw) &&
                          (p.window <= 0 || kw > qw + QW - 1 - p.window);
    if (!unmasked) {
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!fa_visible(p, qw + 8 * n + 2 * t + (i & 1), kw + g + 8 * (i >> 1))) {
            s[n][i] = 0.f;
            dp[n][i] = 0.f;
          }
    }

    // dv += Pᵀ·dO, then dk += dSᵀ·Q, Pᵀ and dSᵀ straight from the
    // accumulators.  Each tile's product goes to a fresh accumulator and
    // then into the running sum by a rounded f32 add: the tensor core's own
    // accumulation does not round to nearest, and over a group's thousands
    // of query rows its error would build up (10x larger at MQA).
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      float part[KS][4];
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        uint32_t ab[4], as[4];
        fa_frag_acc(pass == 0 ? s[kk] : dp[kk], ab, as);
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          uint32_t bb[2], bs[2];
          fa_frag_b_rows<kF32, LD>((pass == 0 ? dot : qt) + kk * 8 * LD + n * 8, g, t, bb, bs);
          fa_mma3<true, kF32>(part[n], ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (pass == 0)
            dv_acc[n][i] += part[n][i];
          else
            dk_acc[n][i] += part[n][i];
        }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Fold the two query halves of each key block, half 1 into half 0.
  __syncthreads();
  constexpr int LR = Tile::LR;
  float* fold = reinterpret_cast<float*>(q_s) + kb * 2 * 16 * LR;  // [dk, dv][16][LR]
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (g + 8 * r) * LR + 8 * n + 2 * t;
        fa_store2(fold + at, dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
        fa_store2(fold + 16 * LR + at, dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
      }
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= p.Skv) continue;
    float* dk_row = dk + kv_off + (size_t)key * HD + 2 * t;
    float* dv_row = dv + kv_off + (size_t)key * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int at = (g + 8 * r) * LR + 8 * n + 2 * t;
      fa_store2(dk_row + 8 * n, (dk_acc[n][2 * r] + fold[at]) * p.scale,
                (dk_acc[n][2 * r + 1] + fold[at + 1]) * p.scale);
      fa_store2(dv_row + 8 * n, dv_acc[n][2 * r] + fold[16 * LR + at],
                dv_acc[n][2 * r + 1] + fold[16 * LR + at + 1]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, float* dk, float* dv, const FaParams& p, cudaStream_t stream) {
  constexpr int smem = DkvTile<T, HD>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Skv + DkvTile<T, HD>::BKV - 1) / DkvTile<T, HD>::BKV, p.Hkv, p.B);
  fa_bwd_dkv_kernel<T, HD><<<grid, kDkvThreads, smem, stream>>>(
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
// synchronising; returns the launch's cudaGetLastError()
// (cudaErrorMisalignedAddress when q, k, v or dout is not 16-byte aligned).
extern "C" int fa_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dk, void* dv, int dtype,
                          int hd, int B, int H, int Hkv, int S, int Skv, int causal, int window,
                          float cap, float scale, void* stream) {
  const FaParams p{B, H, Hkv, S, Skv, causal, window, cap, scale};
  if (fa_misaligned(q) || fa_misaligned(k) || fa_misaligned(v) || fa_misaligned(dout))
    return (int)cudaErrorMisalignedAddress;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* a = static_cast<float*>(dk);
  float* c = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == FA_F32) return launch_hd<float>(hd, q, k, v, dout, l, dl, a, c, p, st);
  if (dtype == FA_BF16) return launch_hd<__nv_bfloat16>(hd, q, k, v, dout, l, dl, a, c, p, st);
  return (int)cudaErrorInvalidValue;
}
