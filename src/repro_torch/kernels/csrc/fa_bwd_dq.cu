// Flash-attention backward, dq, for Hopper (sm_90a): 3xTF32 tensor-core
// products at float32 accuracy.
//
// Replaces: src/repro/kernels/flash_attention.py `_fa_bwd_dq_kernel` (the
// first Pallas call of `flash_attention_bwd_bhsd`).  Same function:
//   dq_i = scale * sum_j dS_ij k_j,  dS = p (dO v^T - delta) (1 - (z/cap)^2),
//   p = exp(z - lse) on visible pairs, z = softcap(scale q k^T),
// recomputed from (q, k, v, dO, lse, delta) without materialising the
// (S x Skv) scores, with GQA, causal, window, soft-cap, ragged S / Skv and
// the whole-tile skip.  dq is float32.
//
// What bounds it on the H100: operations, 6*hd flops per visible pair (Q·Kᵀ,
// dO·Vᵀ, dS·K).  At the main path's B=8, S=1024, 9:3 heads, hd 64, causal
// the least time is 0.2166 ms on the CUDA cores and 0.0879 ms as 3xTF32 on
// the tensor cores; the bytes take 0.0208 ms.
//
// Design (fa_fwd.cu's layout; fa_mma.cuh has the product, the split and
// the fragment layouts):
// - Every product is mma.sync.m16n8k8 TF32 with the 3xTF32 split (big·small
//   + small·big + big·big, f32 accumulation); a bf16 operand has no small
//   part, so its small products are skipped.  dS is computed here and always
//   takes all three.
// - One CTA of 4 warps per (64-row query tile, head, batch); each warp owns
//   16 query rows.  CTAs run the longest (latest) query tiles first.
// - The warp keeps its Q and dO fragments, split into big and small, in
//   registers for the whole kv loop (hd <= 64).  At hd 128 they would not
//   fit, so the Q and dO tiles ride into shared memory with the first kv
//   tile and are split per use.
// - lse and delta are given, so no online softmax: each 32-key step is
//   S = Q·Kᵀ and dP = dO·Vᵀ in accumulators (16 x 32 per warp), then dS on
//   those registers in log2 units (ex2), then dq += dS·K with dS fed
//   straight back as the A operand (keys permuted within each 8-key block,
//   fa_mma.cuh).  A step that the causal/window structure masks for all of
//   the warp's rows is skipped; the soft-cap and the per-element mask
//   branch once per step, the mask only where the step crosses the
//   diagonal, a window edge or the ragged end.
// - K and V tiles (64 keys at hd <= 64, 32 at hd 128) move into shared
//   memory with cp.async, double-buffered, rows padded by 16 bytes; each
//   warp splits a fragment as it reads it (K twice, as Kᵀ and as K, and V
//   once: twelve splits of every element per CTA).  Splitting each landed
//   tile once into shared-memory planes of big and small parts was slower
//   on the H100 (PERF.md): it saves the split's integer work but reads two
//   words of shared memory per element where this reads one, and a 16-row
//   warp tile uses each word it reads in one product only.
// - Each kv tile's dS·K goes to fresh accumulators and joins the running
//   dq by a rounded f32 add (the tensor core's accumulation does not round
//   to nearest, and dq sums over up to Skv keys).  The running dq lives in
//   shared memory, one slot per lane and element, which frees 32 registers
//   at hd 64 for Q and dO.
// - Steps of 32 keys give each warp eight independent accumulator chains
//   for S and dP; 8- and 16-key steps were slower (PERF.md).
//   At hd 64, f32: 246 registers (ptxas), no spill, and 2 stages x (K, V)
//   x 64 x 68 floats + 16 KiB of running dq = 86,016 bytes of shared memory
//   per CTA; two CTAs per SM, 264 per wave: B=8 has 1,152 CTAs (4.4 waves),
//   B=2 288.
// - Each CTA owns its dq rows: no atomics, fixed summation order.
#include "fa_mma.cuh"

namespace {

constexpr int kDqWarps = 4;
constexpr int kDqBQ = 16 * kDqWarps;  // query rows per CTA
constexpr int kDqThreads = 32 * kDqWarps;

template <typename T, int HD> struct DqTile {
  static constexpr int BK = HD <= 64 ? 64 : 32;  // keys per kv tile
  static constexpr int NB = 4;         // 8-key blocks per step: n-tiles of Q·Kᵀ, k-steps of dS·K
  static constexpr int STEP = 8 * NB;  // keys per step
  static constexpr int LD = HD + FaPad<T>::value;  // row stride of the staged tiles
  static constexpr int KS = HD / 8;  // k-steps of Q·Kᵀ, n-tiles of dS·K
  static constexpr bool kQReg = HD <= 64;  // Q, dO split in registers; else staged in shared
  static constexpr int kSmem =  // stages x (K, V), Q and dO at hd 128, running dq
      2 * 2 * BK * LD * (int)sizeof(T) + (kQReg ? 0 : 2 * kDqBQ * LD * (int)sizeof(T)) +
      kDqBQ * HD * 4;
  static_assert(BK % STEP == 0, "a kv tile is a whole number of steps");
};

template <typename T, int HD>
__global__ void __launch_bounds__(kDqThreads, 1)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq, FaParams p) {
  using Tile = DqTile<T, HD>;
  constexpr int BK = Tile::BK, NB = Tile::NB, STEP = Tile::STEP, LD = Tile::LD, KS = Tile::KS;
  constexpr bool kF32 = std::is_same_v<T, float>;  // operands loaded as f32 have a small part
  extern __shared__ __align__(16) unsigned char fa_smem[];
  T* k_s = reinterpret_cast<T*>(fa_smem);                            // [2][BK][LD]
  T* v_s = k_s + 2 * BK * LD;                                        // [2][BK][LD]
  T* q_s = v_s + 2 * BK * LD;                                        // [kDqBQ][LD], hd 128
  T* do_s = q_s + (Tile::kQReg ? 0 : kDqBQ * LD);                    // [kDqBQ][LD], hd 128
  float* dq_s = reinterpret_cast<float*>(do_s + (Tile::kQReg ? 0 : kDqBQ * LD));

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp;  // the warp's first query row
  const size_t head = (size_t)b * p.H + h;
  const size_t kv_off = ((size_t)b * p.Hkv + kh) * (size_t)p.Skv * HD;
  const T* kg = k + kv_off;
  const T* vg = v + kv_off;
  const T* qh = q + head * p.S * HD;
  const T* doh = dout + head * p.S * HD;

  // The relevant kv tiles form one range [j_lo, j_hi] (causal cuts a
  // suffix, the window a prefix).
  const int nk = (p.Skv + BK - 1) / BK;
  int j_lo = nk, j_hi = -1;
  for (int j = 0; j < nk; ++j)
    if (fa_tile_relevant(p, q0, kDqBQ, j * BK, BK)) {
      j_lo = min(j_lo, j);
      j_hi = j;
    }
  auto issue = [&](int j, int stage) {
    fa_cp_rows<T, HD, LD, BK, kDqThreads>(k_s + stage * BK * LD, kg, j * BK, p.Skv);
    fa_cp_rows<T, HD, LD, BK, kDqThreads>(v_s + stage * BK * LD, vg, j * BK, p.Skv);
    fa_cp_commit();
  };
  if (j_lo <= j_hi) {
    if constexpr (!Tile::kQReg) {
      fa_cp_rows<T, HD, LD, kDqBQ, kDqThreads>(q_s, qh, q0, p.S);
      fa_cp_rows<T, HD, LD, kDqBQ, kDqThreads>(do_s, doh, q0, p.S);
    }
    issue(j_lo, 0);  // Q and dO ride in the first group
  }

  // Q and dO fragments of the warp's 16 rows (zeros past S), one per
  // k-step, split once for the whole kv loop.
  constexpr int QR = Tile::kQReg ? KS : 1;
  uint32_t qb[QR][4], qsm[QR][4], db[QR][4], dsm[QR][4];
  if constexpr (Tile::kQReg) {
    const bool ok0 = r0 + g < p.S, ok1 = r0 + g + 8 < p.S;
    const size_t at0 = (size_t)(r0 + g) * HD + t, at1 = at0 + 8 * HD;
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // columns 8s + t and 8s + t + 4
        const int col = 8 * s + 4 * c;
        fa_split<kF32>(ok0 ? fa_to_float(qh[at0 + col]) : 0.f, qb[s][2 * c], qsm[s][2 * c]);
        fa_split<kF32>(ok1 ? fa_to_float(qh[at1 + col]) : 0.f, qb[s][2 * c + 1],
                       qsm[s][2 * c + 1]);
        fa_split<kF32>(ok0 ? fa_to_float(doh[at0 + col]) : 0.f, db[s][2 * c], dsm[s][2 * c]);
        fa_split<kF32>(ok1 ? fa_to_float(doh[at1 + col]) : 0.f, db[s][2 * c + 1],
                       dsm[s][2 * c + 1]);
      }
  }
  // lse (in log2 units) and delta of rows g and g + 8.
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    lse2[r] = row < p.S ? lse[head * p.S + row] * FA_LOG2E : 0.f;
    dl[r] = row < p.S ? delta[head * p.S + row] : 0.f;
  }
  // The running dq: slot (n, i) of this lane at dq_w[(4 n + i) * 32].
  float* dq_w = dq_s + warp * KS * 4 * 32 + lane;
#pragma unroll
  for (int i = 0; i < KS * 4; ++i) dq_w[i * 32] = 0.f;
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

    float part[KS][4];  // this tile's dS·K
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[n][i] = 0.f;

#pragma unroll 1
    for (int st = 0; st < BK / STEP; ++st) {
      const int s0 = k0 + st * STEP;  // the step's first key
      if (r0 >= p.S || s0 >= p.Skv || !fa_tile_relevant(p, r0, 16, s0, STEP)) continue;

      // S = Q·Kᵀ and dP = dO·Vᵀ
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] = 0.f;
          dp[n][i] = 0.f;
        }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qab[4], qas[4], dab[4], das[4];
        if constexpr (Tile::kQReg) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            qab[i] = qb[ks][i], qas[i] = qsm[ks][i];
            dab[i] = db[ks][i], das[i] = dsm[ks][i];
          }
        } else {
          fa_frag_a<kF32, LD>(q_s + 16 * warp * LD + ks * 8, g, t, qab, qas);
          fa_frag_a<kF32, LD>(do_s + 16 * warp * LD + ks * 8, g, t, dab, das);
        }
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const int row = st * STEP + 8 * n;  // key row of the tile
          uint32_t kbb[2], kbs[2], vbb[2], vbs[2];
          fa_frag_bt<kF32, LD>(kt + row * LD + ks * 8, g, t, kbb, kbs);
          fa_frag_bt<kF32, LD>(vt + row * LD + ks * 8, g, t, vbb, vbs);
          fa_mma3<kF32, kF32>(s[n], qab, qas, kbb, kbs);
          fa_mma3<kF32, kF32>(dp[n], dab, das, vbb, vbs);
        }
      }

      // dS in place of dP; the cap and the mask branch once per step.
      if (p.cap > 0.f) {
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float z = fa_logit(p, s[n][i]), c = z / p.cap;
            dp[n][i] = fa_exp2(z * FA_LOG2E - lse2[i >> 1]) * (dp[n][i] - dl[i >> 1]) *
                       (1.f - c * c);
          }
      } else {
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dp[n][i] = fa_exp2(s[n][i] * scale2 - lse2[i >> 1]) * (dp[n][i] - dl[i >> 1]);
      }
      const bool unmasked = s0 + STEP <= p.Skv && (!p.causal || s0 + STEP - 1 <= r0) &&
                            (p.window <= 0 || s0 > r0 + 15 - p.window);
      if (!unmasked) {
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (!fa_visible(p, r0 + g + 8 * (i >> 1), s0 + 8 * n + 2 * t + (i & 1)))
              dp[n][i] = 0.f;  // a select: p of a masked pair may be inf
      }

      // part += dS·K, dS straight from the accumulators.
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        uint32_t ab[4], as[4];
        fa_frag_acc(dp[kk], ab, as);
        const int row = st * STEP + 8 * kk;
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          uint32_t bb[2], bs[2];
          fa_frag_b_rows<kF32, LD>(kt + row * LD + n * 8, g, t, bb, bs);
          fa_mma3<true, kF32>(part[n], ab, as, bb, bs);
        }
      }
    }

    // The tile's product joins the running dq by a rounded f32 add.
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dq_w[(4 * n + i) * 32] += part[n][i];
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= p.S) continue;
    float* orow = dq + (head * p.S + row) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < KS; ++n)
      fa_store2(orow + 8 * n, dq_w[(4 * n + 2 * r) * 32] * p.scale,
                dq_w[(4 * n + 2 * r + 1) * 32] * p.scale);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, float* dq, const FaParams& p, cudaStream_t stream) {
  constexpr int smem = DqTile<T, HD>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.S + kDqBQ - 1) / kDqBQ, p.H, p.B);
  fa_bwd_dq_kernel<T, HD><<<grid, kDqThreads, smem, stream>>>(
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
// returns the launch's cudaGetLastError() (cudaErrorMisalignedAddress when
// q, k, v or dout is not 16-byte aligned).
extern "C" int fa_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, int dtype, int hd, int B,
                         int H, int Hkv, int S, int Skv, int causal, int window, float cap,
                         float scale, void* stream) {
  const FaParams p{B, H, Hkv, S, Skv, causal, window, cap, scale};
  if (fa_misaligned(q) || fa_misaligned(k) || fa_misaligned(v) || fa_misaligned(dout))
    return (int)cudaErrorMisalignedAddress;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* o = static_cast<float*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == FA_F32) return launch_hd<float>(hd, q, k, v, dout, l, dl, o, p, st);
  if (dtype == FA_BF16) return launch_hd<__nv_bfloat16>(hd, q, k, v, dout, l, dl, o, p, st);
  return (int)cudaErrorInvalidValue;
}
