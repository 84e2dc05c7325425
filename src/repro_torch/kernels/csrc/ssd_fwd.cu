// Mamba2 SSD chunked-scan forward for Hopper (sm_90a): 3xTF32 tensor-core
// products at float32 accuracy.
//
// Replaces: src/repro/kernels/ssd.py `_ssd_kernel` (the Pallas TPU kernel
// launched by `ssd_fwd_chunked_pallas`).  Same function: per (batch, head)
// and chunk of Q steps, with L the cumulative log-decay dt * A, xb = dt x,
// S = C B^T and w_s = e^{L_Q - L_s},
//   y_t   = sum_{s <= t} S_ts e^{L_t - L_s} xb_s + e^{L_t} C_t h_prev
//   h_new = e^{L_Q} h_prev + (B . w)^T xb,
// emitting y and each chunk's entry state h_prev (the backward's residual).
// The decay e^{L_t - L_s} is computed only where s <= t, so no inf arises
// at any decay.
//
// What bounds it on the H100: operations.  Per chunk (N + P) multiply-adds
// for each pair s <= t and 2 Q N P for the inter-chunk term and the state
// update, as 3xTF32 on the tensor cores (chip_smoke.py `_ssd_bounds`, which
// counts S once per group).  This design does about 1.8x that per (batch,
// head, chunk) at the main shape: S once per head, over whole 16 x 32 warp
// tiles on the diagonal.
//
// Design (fa_mma.cuh has the product, the split and the fragment layouts;
// ssd_common.cuh the layout, staging and products both SSD kernels share):
// - Every product is mma.sync.m16n8k8 TF32 with the 3xTF32 split (big·small
//   + small·big + big·big, f32 accumulation).  Every operand is an f32
//   value, so every product takes all three.
// - One CTA of 8 warps per (head, batch) walks the chunks in order with h
//   (N x P) in shared memory: the TPU kernel's VMEM carry and sequential
//   chunk grid.
// - Within a chunk the t-rows come in held blocks of 128 rows of C; warp w
//   owns rows 16w..16w+15 and all P columns of y.  The block streams the
//   s-rows <= it in steps of 32 (B_s and xb_s), and per step takes
//   S = C_t B_s^T (k over N) into fresh accumulators, masks it on the
//   fragment to M = S e^{L_t - L_s} [s <= t], then Y += M xb_s with M fed
//   straight back as the A operand (s permuted within each 8-step,
//   fa_frag_b_rows' reads on the B side).  A warp skips a step whose 32
//   columns all lie past its rows; the masked tile never goes through
//   shared memory.
// - Then the inter-chunk term Y += e^{L_t} (C_t h_prev), k over N, in two
//   halves of 32 columns: h read down its rows in the permuted order
//   (fa_frag_b_rows: rows 2t and 2t + 1, 32 banks) and C in the paired
//   order (fa_frag_a_pairs, whose reads conflict two ways).  That beat
//   unpermuted reads of h at a pitch of 72 words (8 mod 32, conflict-free
//   on both sides) in paired timings on the card (scratch builds, not
//   kept).
// - The state update rides on the steps of the chunk's last t-block, which
//   stream every s in [0, Q): warp w owns h rows n = 16w..16w+15 and adds
//   hn += B_s^T (w xb)_s, k over s, with B_s read transposed from its planes
//   (rows 2t and 2t + 1, columns g and g + 8: 32 banks) and w_s xb_s staged
//   as a third pair of planes in that block only.  After the inter-chunk
//   term and a barrier that ends every read of h_prev, each lane writes its
//   elements of h = e^{L_Q} h_prev + hn.
// - Staging.  The held block moves in by cp.async under the first step's
//   load.  A streamed step is loaded, scaled (dt, and dt w), split once
//   into planes of big and small TF32 parts and read as such by all eight
//   warps; the next step's rows are prefetched into L1 while this one is
//   multiplied.  The entry state goes to `states` once per chunk,
//   coalesced, from shared memory.
// - Shared memory at Q = 256: h 128 x 68, the held block 128 x 132, the
//   step's planes 2 x 32 x (132 + 68 + 68), 3 Q floats: 174,080 bytes, one
//   CTA per SM.  Widths are padded to N = 128 and P = 64 with zero columns,
//   and rows past Q are zero, so every N <= 128, P <= 64 and Q <= 5120
//   (shared memory) runs the same code.
// - The decay is e^{L_t - L_s} on the MUFU unit (__expf): its error is far
//   below that of L_t - L_s itself, rounded in float32 at |L| ~ 1e3.
// - Each step's products go to fresh accumulators and join the running sums
//   (Y, hn) by a rounded f32 add: the tensor core's own accumulation does
//   not round to nearest.  Every sum runs in a fixed order, with no
//   atomics, so two calls on the same inputs are bit-identical.
// - ptxas (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3): 255 registers,
//   no stack, no spill.  Shared memory holds the SM to one CTA, so the
//   registers cost no occupancy.
#include "ssd_common.cuh"

namespace {

constexpr size_t kFixedFloats =
    (size_t)kMaxN * kLdP + (size_t)kBlk * kLdN + 2 * (size_t)(kPlN + 2 * kPlP);

// acc[j] += A B for the warp's 16 rows of A (row-major, k over K) and
// columns [8j, 8j + 8) of B (row-major, k down its rows), k permuted within
// each 8-step on both sides.
template <int K, int NJ, int LDA, int LDB>
__device__ __forceinline__ void mma_ab(float (&acc)[NJ][4], const float* A, const float* B,
                                       int g, int tq) {
#pragma unroll
  for (int ks = 0; ks < K / 8; ++ks) {
    uint32_t ab[4], as[4];
    fa_frag_a_pairs<true, LDA>(A + ks * 8, g, tq, ab, as);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t bb[2], bs[2];
      fa_frag_b_rows<true, LDB>(B + ks * 8 * LDB + j * 8, g, tq, bb, bs);
      fa_mma3<true, true>(acc[j], ab, as, bb, bs);
    }
  }
}

// out[n] += At^T R over one step (k over its kStep rows): At^T's 16 rows
// are columns [0, 16) of At, and R is P-wide; both are staged as split
// planes (k permuted: rows 2t and 2t + 1).  Each group of four n-tiles'
// products in fresh registers, joined by a rounded add.
template <int LDA, int PLA>
__device__ __forceinline__ void mma_atb_planes(float (&out)[kKP][4], const uint32_t* At,
                                               const uint32_t* R, int g, int tq) {
  constexpr int kG = 4;
#pragma unroll
  for (int n0 = 0; n0 < kKP; n0 += kG) {
    float part[kG][4];
#pragma unroll
    for (int u = 0; u < kG; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[u][i] = 0.f;
#pragma unroll
    for (int k = 0; k < kJS; ++k) {
      const uint32_t* a = At + (k * 8 + 2 * tq) * LDA + g;
      const uint32_t ab[4] = {a[0], a[8], a[LDA], a[LDA + 8]};
      const uint32_t as[4] = {a[PLA], a[PLA + 8], a[PLA + LDA], a[PLA + LDA + 8]};
#pragma unroll
      for (int u = 0; u < kG; ++u) {
        const uint32_t* r = R + (k * 8 + 2 * tq) * kLdP + (n0 + u) * 8 + g;
        const uint32_t bb[2] = {r[0], r[kLdP]}, bs[2] = {r[kPlP], r[kPlP + kLdP]};
        fa_mma3<true, true>(part[u], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int u = 0; u < kG; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) out[n0 + u][i] += part[u][i];
  }
}

// Rows [r0, r0 + kStep) of x (row r at src + r * stride, ncol floats) times
// dt, split into planes at xb (big) and kPlP words on (small); when xw is
// given, times dt w too, into planes at xw.  Zeros past ncol and past row
// nvalid.
__device__ __forceinline__ void load_x_split(uint32_t* xb, uint32_t* xw,
                                             const float* __restrict__ src, size_t stride,
                                             int r0, int nvalid, int ncol, const float* dtv,
                                             const float* dtw) {
#pragma unroll 8
  for (int idx = threadIdx.x; idx < kStep * kMaxP; idx += kSsdThreads) {
    const int r = idx / kMaxP, col = idx % kMaxP, s = r0 + r, k = r * kLdP + col;
    const bool ok = s < nvalid && col < ncol;
    const float v = ok ? src[(size_t)s * stride + col] : 0.f;
    fa_split<true>(ok ? v * dtv[s] : 0.f, xb[k], xb[kPlP + k]);
    if (xw) fa_split<true>(ok ? v * dtw[s] : 0.f, xw[k], xw[kPlP + k]);
  }
}

__global__ void __launch_bounds__(kSsdThreads, 1)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ states, SsdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (p.H / p.G);
  const int N = p.N, P = p.P, Q = p.Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int r0 = 16 * warp;        // the warp's first row of the held block, and of h
  float* hs = smem;                // kMaxN x kLdP: the carried state h
  float* hN = hs + kMaxN * kLdP;   // kBlk x kLdN: the held C block
  // the step's B_s, dt x and (last t-block) dt w x, each as split planes
  uint32_t* sN = reinterpret_cast<uint32_t*>(hN + kBlk * kLdN);  // 2 x kStep x kLdN
  uint32_t* sP = sN + 2 * kPlN;                                  // 2 x kStep x kLdP
  uint32_t* sW = sP + 2 * kPlP;                                  // 2 x kStep x kLdP
  float* Lc = reinterpret_cast<float*>(sW + 2 * kPlP);  // Q: cumulative log-decay
  float* dtv = Lc + Q;             // Q: dt
  float* dtw = dtv + Q;            // Q: dt_s w_s
  const float a = A[h];
  const size_t x_stride = (size_t)p.H * P, bc_stride = (size_t)p.G * N;

  for (int i = threadIdx.x; i < kMaxN * kLdP; i += kSsdThreads) hs[i] = 0.f;

  for (int c = 0; c < p.nc; ++c) {
    const size_t step0 = (size_t)b * p.T + (size_t)c * Q;  // (b, first step of the chunk)
    const float* xc = x + (step0 * p.H + h) * P;
    const float* Bc = Bm + (step0 * p.G + grp) * N;
    const float* Cc = Cm + (step0 * p.G + grp) * N;
    float* st = states + (((size_t)b * p.H + h) * p.nc + c) * (size_t)N * P;
    __syncthreads();  // the previous chunk is done with every buffer, and h is final
    for (int i = threadIdx.x; i < Q; i += kSsdThreads) {
      const float d = dt[(step0 + i) * p.H + h];
      dtv[i] = d;
      Lc[i] = d * a;
    }
    // the state entering this chunk: the backward's residual
    for (int i = threadIdx.x; i < N * P; i += kSsdThreads) st[i] = hs[(i / P) * kLdP + i % P];
    __syncthreads();
    ssd_prefix_sum(Lc, Q);
    __syncthreads();
    const float Ltot = Lc[Q - 1];
    for (int i = threadIdx.x; i < Q; i += kSsdThreads) dtw[i] = dtv[i] * expf(Ltot - Lc[i]);

    for (int t0 = 0; t0 < Q; t0 += kBlk) {
      const bool last = t0 + kBlk >= Q;  // its steps stream every s: the state update rides on them
      __syncthreads();  // hN is free (and dtw is written)
      cp_rows<kBlk, kMaxN>(hN, kLdN, Cc, bc_stride, t0, Q, N);
      fa_cp_commit();
      const int tw = t0 + r0;  // the warp's first t
      const bool live = tw < Q;
      float Lt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) Lt[r] = tw + g + 8 * r < Q ? Lc[tw + g + 8 * r] : 0.f;
      float Y[kKP][4], hn[kKP][4];
#pragma unroll
      for (int n = 0; n < kKP; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) Y[n][i] = hn[n][i] = 0.f;
      const int s_end = min(t0 + kBlk, Q);
      for (int s0 = 0; s0 < s_end; s0 += kStep) {
        __syncthreads();  // the step planes are free
        load_split<kStep, kMaxN, kPlN>(sN, kLdN, Bc, bc_stride, s0, Q, N);
        load_x_split(sP, last ? sW : nullptr, xc, x_stride, s0, Q, P, dtv, dtw);
        fa_cp_wait<0>();  // the held block
        __syncthreads();
        prefetch_rows<kStep>(Bc, bc_stride, s0 + kStep, s_end, N);
        prefetch_rows<kStep>(xc, x_stride, s0 + kStep, s_end, P);
        if (live && s0 <= tw + 15) {  // some s of the step is at or before the rows
          float S[kJS][4];
#pragma unroll
          for (int j = 0; j < kJS; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) S[j][i] = 0.f;
          mma_abt_planes<kMaxN, kJS, kLdN, kLdN, kPlN>(S, hN + r0 * kLdN, sN, g, tq);  // C_t B_s^T
#pragma unroll
          for (int j = 0; j < kJS; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = i >> 1, t = tw + g + 8 * r, s = s0 + 8 * j + 2 * tq + (i & 1);
              // the decay only where s <= t: e^{L_t - L_s} <= 1, never inf
              S[j][i] = t < Q && s <= t ? S[j][i] * __expf(Lt[r] - Lc[s]) : 0.f;
            }
          mma_acc_rows<kJS, kKP, kLdP, kPlP>(Y, S, sP, g, tq);  // Y += M xb_s
        }
        if (last) mma_atb_planes<kLdN, kPlN>(hn, sN + r0, sW, g, tq);  // hn += B_s^T (w xb)_s
      }

      if (live) {  // inter-chunk term: Y += e^{L_t} (C_t h_prev)
        float el[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) el[r] = tw + g + 8 * r < Q ? expf(Lt[r]) : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float part[kKP / 2][4];
#pragma unroll
          for (int n = 0; n < kKP / 2; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
          mma_ab<kMaxN, kKP / 2, kLdN, kLdP>(part, hN + r0 * kLdN, hs + half * (kMaxP / 2), g,
                                             tq);
#pragma unroll
          for (int n = 0; n < kKP / 2; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) Y[half * (kKP / 2) + n][i] += el[i >> 1] * part[n][i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = tw + g + 8 * r;
          if (t >= Q) continue;
          float* yrow = y + ((step0 + t) * p.H + h) * P;
#pragma unroll
          for (int n = 0; n < kKP; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (8 * n + 2 * tq + e < P) yrow[8 * n + 2 * tq + e] = Y[n][2 * r + e];
        }
      }

      if (last) {  // h = e^{L_Q} h_prev + hn; warp w owns h rows 16w..16w+15
        __syncthreads();  // every read of h_prev is done
        const float eL = expf(Ltot);
#pragma unroll
        for (int n = 0; n < kKP; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* hv = hs + (r0 + g + 8 * (i >> 1)) * kLdP + 8 * n + 2 * tq + (i & 1);
            *hv = eL * *hv + hn[n][i];
          }
      }
    }
  }
}

}  // namespace

// x (B, T, H, P), dt (B, T, H), A (H,), Bm/Cm (B, T, G, N), all float32
// and contiguous; y like x; states (B, H, T / Q, N, P).  Launches on
// `stream` without synchronising; returns the launch's cudaGetLastError()
// (cudaErrorInvalidValue for sizes the kernel does not take).
extern "C" int ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, void* y, void* states, int B, int T, int H, int P,
                       int G, int N, int Q, void* stream) {
  const SsdParams p{B, T, H, P, G, N, Q, Q > 0 ? T / Q : 0};
  if (!ssd_params_ok(p)) return (int)cudaErrorInvalidValue;
  const size_t smem = (kFixedFloats + 3 * (size_t)Q) * sizeof(float);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(ssd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_kernel<<<dim3(H, B), kSsdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(states), p);
  return (int)cudaGetLastError();
}
