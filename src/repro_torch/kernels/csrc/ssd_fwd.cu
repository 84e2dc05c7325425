// Mamba2 SSD chunked-scan forward for Hopper (sm_90a), float32.
//
// Replaces: src/repro/kernels/ssd.py `_ssd_kernel` (the Pallas TPU kernel
// launched by `ssd_fwd_chunked_pallas`).  Same function: per (batch, head)
// and chunk of Q steps, with L the cumulative log-decay dt * A,
//   y_t   = sum_{s <= t} (C_t . B_s) e^{L_t - L_s} dt_s x_s + e^{L_t} C_t . h_prev
//   h_new = e^{L_Q} h_prev + sum_s e^{L_Q - L_s} B_s (dt_s x_s)^T,
// emitting y and each chunk's entry state h_prev (the backward's residual).
// The decay e^{L_t - L_s} is computed only where s <= t, so no inf arises
// at any decay.
//
// What bounds it on the H100: operations.  Per chunk the intra-chunk term
// costs (N + P) multiply-adds for each of the Q (Q + 1) / 2 pairs s <= t,
// and the inter-chunk term and the state update Q N P each, against
// (2P + 2N + 1) floats of input and output per step: at the main path's
// shape (Q 256, N 128, P 64) that is far above the card's ridge point, and
// with float32 math (TF32 off) the ceiling is the 67 TFLOP/s of the CUDA
// cores.
//
// Design: one CTA of 256 threads per (head, batch) loops over the chunks in
// order, keeping h (N x P) in shared memory: the TPU kernel's VMEM carry and
// sequential chunk grid axis.  Within a chunk it walks 64-row t-blocks;
// for each, the s-blocks <= it: a 64 x 64 score tile C B^T in registers (4 x 4
// per thread), masked by the decay into shared memory, then multiplied into
// the t-block's (64, P) output held in registers.  Shared memory holds h, one
// C and one B tile (64 x N), the dt-scaled x tile, the masked score tile and
// L: about 131 KiB at the main shape, so one CTA per SM.  With G = 1 all H
// heads share B and C, and every head recomputes C B^T, as the TPU kernel
// does; computing it once per (batch, chunk) and sharing it across heads,
// tensor cores (TF32 is off, so 3xTF32 or wgmma in bf16 for a later cell) and
// more CTAs per SM are later work.
#include "ssd_common.cuh"

namespace {

__host__ __device__ inline size_t fwd_smem_floats(int N, int P, int Q) {
  return (size_t)N * P + 2 * (size_t)kTile * (N + 1) + (size_t)kTile * P +
         (size_t)kTile * kLdT + 2 * (size_t)Q;
}

__global__ void __launch_bounds__(kSsdThreads, 1)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ states, SsdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int N = p.N, P = p.P, Q = p.Q, ldN = N + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* hs = smem;                  // N x P: the carried state
  float* Cs = hs + N * P;            // 64 x ldN: C rows of the t-block
  float* Bs = Cs + kTile * ldN;      // 64 x ldN: B rows of the s-block
  float* Xs = Bs + kTile * ldN;      // 64 x P: dt * x rows of the s-block
  float* Ms = Xs + kTile * P;        // 64 x kLdT: masked scores of one tile
  float* Lc = Ms + kTile * kLdT;     // Q: cumulative log-decay of the chunk
  float* dtv = Lc + Q;               // Q: dt of the chunk
  const float a = A[h];
  const size_t x_stride = (size_t)p.H * P, bc_stride = (size_t)p.G * N;
  const int nT = (Q + kTile - 1) / kTile;

  for (int i = threadIdx.x; i < N * P; i += kSsdThreads) hs[i] = 0.f;

  for (int c = 0; c < p.nc; ++c) {
    const size_t step0 = (size_t)b * p.T + (size_t)c * Q;  // (b, first step of the chunk)
    const float* xc = x + (step0 * p.H + h) * P;
    const float* Bc = Bm + (step0 * p.G + g) * N;
    const float* Cc = Cm + (step0 * p.G + g) * N;
    __syncthreads();  // the previous chunk is done with Lc, dtv and hs
    for (int i = threadIdx.x; i < Q; i += kSsdThreads) {
      const float d = dt[(step0 + i) * p.H + h];
      dtv[i] = d;
      Lc[i] = d * a;
    }
    __syncthreads();
    ssd_prefix_sum(Lc, Q);
    __syncthreads();
    const float Ltot = Lc[Q - 1];

    // the state entering this chunk: the backward's residual
    float* st = states + (((size_t)b * p.H + h) * p.nc + c) * (size_t)N * P;
    for (int i = threadIdx.x; i < N * P; i += kSsdThreads) st[i] = hs[i];

    for (int tb = 0; tb < nT; ++tb) {
      const int t0 = tb * kTile;
      __syncthreads();  // Cs is free
      ssd_load_rows(Cs, ldN, Cc, bc_stride, t0, Q, N);
      __syncthreads();

      // inter-chunk term: e^{L_t} C_t . h_prev
      float acc[kRows][kColsP];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kColsP; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kRows], hv[kColsP];
#pragma unroll
        for (int i = 0; i < kRows; ++i) cv[i] = Cs[(ty + 16 * i) * ldN + n];
#pragma unroll
        for (int j = 0; j < kColsP; ++j) hv[j] = tx + 16 * j < P ? hs[n * P + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kColsP; ++j) acc[i][j] += cv[i] * hv[j];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int t = t0 + ty + 16 * i;
        const float el = t < Q ? expf(Lc[t]) : 0.f;
#pragma unroll
        for (int j = 0; j < kColsP; ++j) acc[i][j] *= el;
      }

      // intra-chunk term over the s-blocks <= this t-block
      for (int sb = 0; sb <= tb; ++sb) {
        const int s0 = sb * kTile;
        __syncthreads();  // Bs, Xs and Ms are free
        ssd_load_rows(Bs, ldN, Bc, bc_stride, s0, Q, N);
        ssd_load_rows(Xs, P, xc, x_stride, s0, Q, P, dtv);
        __syncthreads();
        float sc[kRows][kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kRows; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[kRows], bv[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) cv[i] = Cs[(ty + 16 * i) * ldN + n];
#pragma unroll
          for (int j = 0; j < kRows; ++j) bv[j] = Bs[(tx + 16 * j) * ldN + n];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kRows; ++j) sc[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int t = t0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const int s = s0 + tx + 16 * j;
            // the decay only where s <= t: e^{L_t - L_s} <= 1, never inf
            const float m = (t < Q && s <= t) ? sc[i][j] * expf(Lc[t] - Lc[s]) : 0.f;
            Ms[(ty + 16 * i) * kLdT + tx + 16 * j] = m;
          }
        }
        __syncthreads();
        for (int s = 0; s < kTile; ++s) {
          float mv[kRows], xv[kColsP];
#pragma unroll
          for (int i = 0; i < kRows; ++i) mv[i] = Ms[(ty + 16 * i) * kLdT + s];
#pragma unroll
          for (int j = 0; j < kColsP; ++j) xv[j] = tx + 16 * j < P ? Xs[s * P + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kColsP; ++j) acc[i][j] += mv[i] * xv[j];
        }
      }

#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= Q) continue;
        float* yrow = y + ((step0 + t) * p.H + h) * P;
#pragma unroll
        for (int j = 0; j < kColsP; ++j)
          if (tx + 16 * j < P) yrow[tx + 16 * j] = acc[i][j];
      }
    }

    // state update: h = e^{L_Q} h + sum_s e^{L_Q - L_s} B_s (dt_s x_s)^T;
    // thread owns h[n][p] for n = ty + 16 i, p = tx + 16 j
    float hn[kColsN][kColsP];
#pragma unroll
    for (int i = 0; i < kColsN; ++i)
#pragma unroll
      for (int j = 0; j < kColsP; ++j) hn[i][j] = 0.f;
    for (int sb = 0; sb < nT; ++sb) {
      const int s0 = sb * kTile;
      __syncthreads();
      ssd_load_rows(Bs, ldN, Bc, bc_stride, s0, Q, N);
      ssd_load_rows(Xs, P, xc, x_stride, s0, Q, P, dtv);
      __syncthreads();
      const int ns = min(kTile, Q - s0);
      for (int s = 0; s < ns; ++s) {
        const float w = expf(Ltot - Lc[s0 + s]);
        float bv[kColsN], xv[kColsP];
#pragma unroll
        for (int i = 0; i < kColsN; ++i) bv[i] = ty + 16 * i < N ? Bs[s * ldN + ty + 16 * i] * w : 0.f;
#pragma unroll
        for (int j = 0; j < kColsP; ++j) xv[j] = tx + 16 * j < P ? Xs[s * P + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < kColsN; ++i)
#pragma unroll
          for (int j = 0; j < kColsP; ++j) hn[i][j] += bv[i] * xv[j];
      }
    }
    __syncthreads();  // every read of h_prev is done
    const float eL = expf(Ltot);
#pragma unroll
    for (int i = 0; i < kColsN; ++i) {
      const int n = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kColsP; ++j) {
        const int pp = tx + 16 * j;
        if (n < N && pp < P) hs[n * P + pp] = eL * hs[n * P + pp] + hn[i][j];
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
  const size_t smem = fwd_smem_floats(N, P, Q) * sizeof(float);
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
