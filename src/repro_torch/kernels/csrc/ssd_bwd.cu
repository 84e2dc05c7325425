// Mamba2 SSD reverse-scan backward for Hopper (sm_90a), float32.
//
// Replaces: src/repro/kernels/ssd.py `_ssd_bwd_kernel` (the Pallas TPU kernel
// launched by `ssd_bwd_chunked_pallas`).  Same function: walking the chunks
// of one (batch, head) in reverse, carrying dh = dLoss/dh (N x P) from the
// chunks after, it recomputes the chunk's decay and score tiles from
// (x, dt, A, B, C) and the forward's entry state h_prev, and emits dx, ddt,
// dB and dC per head and dA per (batch, head).  The wrapper sums dA over the
// batch and dB/dC over each group's heads (ssd.py:268-271).  With
// M = (C B^T) . decay, xb = dt x, L = cumsum(dt A) and w_s = e^{L_Q - L_s}:
//   dM    = dy xb^T,  dxb = M^T dy + w . (B dh),  ds = dM . decay
//   dC    = ds B + e^{L} (dy h_prev^T),  dB = ds^T C + w . (xb dh^T)
//   dL_t  = rowsum_t(ds . S) - colsum_t(ds . S) + e^{L_t} C_t . (h_prev dy_t)
//           - w_t (B_t . (xb_t dh^T)),
//   dL_Q  = e^{L_Q} <dh, h_prev> + sum_s w_s (B_s . (xb_s dh^T)),
//   dla_s = sum_{t >= s} dL_t + dL_Q  (ssd.py:197),
//   ddt   = dla A + <dxb, x>,  dA += <dla, dt>,  dx = dt dxb,
//   dh   <- (C e^{L})^T dy + e^{L_Q} dh.
// The decay is computed only where s <= t.
//
// What bounds it on the H100: operations, as for the forward: per chunk
// 3N + 2P multiply-adds for each pair s <= t and 4 Q N P for the
// state terms, on float32 CUDA cores (TF32 off).
//
// Design: one CTA of 256 threads per (head, batch) walks the chunks in
// reverse with dh and h_prev (N x P each) in shared memory: the TPU kernel's
// VMEM carry and reversed chunk grid.  The (Q, Q) tiles are walked in
// 64 x 64 sub-tiles twice, since what one (t, s) tile gives is summed over t
// for the s rows (dx, dB, column sums of dL) and over s for the t rows (dC,
// row sums): pass B holds an s-block and runs over the t-blocks >= it,
// pass A holds a t-block and runs over the s-blocks <= it; each recomputes
// the scores, which costs a second C B^T (a later redesign point, with the
// per-head recompute of C B^T when G = 1 and tensor cores).  Every sum
// over threads is a shuffle or a fixed-order tree: the result does not
// depend on scheduling.  Shared memory is about 200 KiB at the main shape.
#include "ssd_common.cuh"

namespace {

__host__ __device__ inline size_t bwd_smem_floats(int N, int P, int Q) {
  return 2 * (size_t)N * (P + 1) + 2 * (size_t)kTile * (N + 1) + 2 * (size_t)kTile * (P + 1) +
         2 * (size_t)kTile * kLdT + 5 * (size_t)Q + 32;
}

// The (t, s) tile's scores S = C_t . B_s and dM = dy_t . xb_s for the thread's
// rows t = t0 + ty + 16 i and columns s = s0 + tx + 16 j, with the masked
// decay D; returns S in sc and ds = dM D in dm.
__device__ __forceinline__ void score_tile(const float* Cs, const float* Bs, const float* Ys,
                                           const float* Xs, const float* Lc, const float* dtv,
                                           int ldN, int ldP, int N, int P, int Q, int t0, int s0,
                                           int tx, int ty, float (&sc)[kRows][kRows],
                                           float (&dm)[kRows][kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kRows; ++j) sc[i][j] = dm[i][j] = 0.f;
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
  for (int pp = 0; pp < P; ++pp) {
    float yv[kRows], xv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) yv[i] = Ys[(ty + 16 * i) * ldP + pp];
#pragma unroll
    for (int j = 0; j < kRows; ++j) xv[j] = Xs[(tx + 16 * j) * ldP + pp];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) dm[i][j] += yv[i] * xv[j];
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = t0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int s = s0 + tx + 16 * j;
      // the decay only where s <= t: e^{L_t - L_s} <= 1, never inf
      dm[i][j] = (t < Q && s <= t) ? dm[i][j] * dtv[s] * expf(Lc[t] - Lc[s]) : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kSsdThreads, 1)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ states,
               const float* __restrict__ dy, float* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dBh, float* __restrict__ dCh, float* __restrict__ dAbh,
               SsdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int N = p.N, P = p.P, Q = p.Q, ldN = N + 1, ldP = P + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* dhs = smem;                 // N x ldP: dh carried from the later chunks
  float* hps = dhs + N * ldP;        // N x ldP: this chunk's entry state
  float* Cs = hps + N * ldP;         // 64 x ldN: C rows of a t-block
  float* Bs = Cs + kTile * ldN;      // 64 x ldN: B rows of an s-block
  float* Ys = Bs + kTile * ldN;      // 64 x ldP: dy rows of a t-block
  float* Xs = Ys + kTile * ldP;      // 64 x ldP: x rows of an s-block
  float* Ps = Xs + kTile * ldP;      // 64 x kLdT: S . D of a tile (and scratch)
  float* Ds = Ps + kTile * kLdT;     // 64 x kLdT: ds = dM . D of a tile
  float* Lc = Ds + kTile * kLdT;     // Q: cumulative log-decay
  float* dtv = Lc + Q;               // Q: dt
  float* dLc = dtv + Q;              // Q: dLoss/dL_t, then its suffix sums
  float* rdot = dLc + Q;             // Q: <dxb_s, x_s>
  float* dww = rdot + Q;             // Q: w_s (B_s . (xb_s dh^T))
  float* red = dww + Q;              // 32: block-sum scratch
  const float a = A[h];
  const size_t x_stride = (size_t)p.H * P, bc_stride = (size_t)p.G * N;
  const int nT = (Q + kTile - 1) / kTile;
  float dA_acc = 0.f;

  for (int i = threadIdx.x; i < N * ldP; i += kSsdThreads) dhs[i] = 0.f;

  for (int c = p.nc - 1; c >= 0; --c) {
    const size_t step0 = (size_t)b * p.T + (size_t)c * Q;
    const float* xc = x + (step0 * p.H + h) * P;
    const float* dyc = dy + (step0 * p.H + h) * P;
    const float* Bc = Bm + (step0 * p.G + g) * N;
    const float* Cc = Cm + (step0 * p.G + g) * N;
    const float* st = states + (((size_t)b * p.H + h) * p.nc + c) * (size_t)N * P;
    __syncthreads();  // the later chunk is done with every buffer
    for (int i = threadIdx.x; i < Q; i += kSsdThreads) {
      const float d = dt[(step0 + i) * p.H + h];
      dtv[i] = d;
      Lc[i] = d * a;
    }
    for (int i = threadIdx.x; i < N * P; i += kSsdThreads) hps[(i / P) * ldP + i % P] = st[i];
    __syncthreads();
    ssd_prefix_sum(Lc, Q);
    __syncthreads();
    const float Ltot = Lc[Q - 1], eLtot = expf(Ltot);

    // ---- pass B: per s-block, sums over t >= s, and the state terms ----
    for (int sb = 0; sb < nT; ++sb) {
      const int s0 = sb * kTile;
      __syncthreads();
      ssd_load_rows(Bs, ldN, Bc, bc_stride, s0, Q, N);
      ssd_load_rows(Xs, ldP, xc, x_stride, s0, Q, P);
      float dB[kRows][kColsN], dxb[kRows][kColsP], cs[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        cs[i] = 0.f;
#pragma unroll
        for (int j = 0; j < kColsN; ++j) dB[i][j] = 0.f;
#pragma unroll
        for (int j = 0; j < kColsP; ++j) dxb[i][j] = 0.f;
      }
      for (int tb = sb; tb < nT; ++tb) {
        const int t0 = tb * kTile;
        __syncthreads();  // Cs, Ys, Ps and Ds are free
        ssd_load_rows(Cs, ldN, Cc, bc_stride, t0, Q, N);
        ssd_load_rows(Ys, ldP, dyc, x_stride, t0, Q, P);
        __syncthreads();
        float sc[kRows][kRows], ds[kRows][kRows];
        score_tile(Cs, Bs, Ys, Xs, Lc, dtv, ldN, ldP, N, P, Q, t0, s0, tx, ty, sc, ds);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const int t = t0 + ty + 16 * i, s = s0 + tx + 16 * j;
            const float d = (t < Q && s <= t) ? expf(Lc[t] - Lc[s]) : 0.f;
            Ps[(ty + 16 * i) * kLdT + tx + 16 * j] = sc[i][j] * d;
            Ds[(ty + 16 * i) * kLdT + tx + 16 * j] = ds[i][j];
            cs[j] += ds[i][j] * sc[i][j];  // column j of dL's ds . S
          }
        __syncthreads();
        // rows s = s0 + ty + 16 i: dB += ds^T C, dxb += (S . D)^T dy
        for (int t = 0; t < kTile; ++t) {
          float pv[kRows], dv[kRows], cv[kColsN], yv[kColsP];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            pv[i] = Ps[t * kLdT + ty + 16 * i];
            dv[i] = Ds[t * kLdT + ty + 16 * i];
          }
#pragma unroll
          for (int j = 0; j < kColsN; ++j) cv[j] = tx + 16 * j < N ? Cs[t * ldN + tx + 16 * j] : 0.f;
#pragma unroll
          for (int j = 0; j < kColsP; ++j) yv[j] = tx + 16 * j < P ? Ys[t * ldP + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
#pragma unroll
            for (int j = 0; j < kColsN; ++j) dB[i][j] += dv[i] * cv[j];
#pragma unroll
            for (int j = 0; j < kColsP; ++j) dxb[i][j] += pv[i] * yv[j];
          }
        }
      }

      // state terms of the s rows: h = e^{L_Q} h_prev + (B . w)^T xb
      float w[kRows], dts[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int s = s0 + ty + 16 * i;
        w[i] = s < Q ? expf(Ltot - Lc[s]) : 0.f;
        dts[i] = s < Q ? dtv[s] : 0.f;
      }
      {  // dxb += w . (B dh)
        float bdh[kRows][kColsP];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kColsP; ++j) bdh[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float bv[kRows], hv[kColsP];
#pragma unroll
          for (int i = 0; i < kRows; ++i) bv[i] = Bs[(ty + 16 * i) * ldN + n];
#pragma unroll
          for (int j = 0; j < kColsP; ++j) hv[j] = tx + 16 * j < P ? dhs[n * ldP + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kColsP; ++j) bdh[i][j] += bv[i] * hv[j];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kColsP; ++j) dxb[i][j] += w[i] * bdh[i][j];
      }
      float dwp[kRows];
      {  // dBw = xb dh^T; dB += w . dBw; dw = <dBw, B>
        float dBw[kRows][kColsN];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kColsN; ++j) dBw[i][j] = 0.f;
        for (int pp = 0; pp < P; ++pp) {
          float xv[kRows], hv[kColsN];
#pragma unroll
          for (int i = 0; i < kRows; ++i) xv[i] = Xs[(ty + 16 * i) * ldP + pp];
#pragma unroll
          for (int j = 0; j < kColsN; ++j) hv[j] = tx + 16 * j < N ? dhs[(tx + 16 * j) * ldP + pp] : 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kColsN; ++j) dBw[i][j] += xv[i] * hv[j];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          dwp[i] = 0.f;
#pragma unroll
          for (int j = 0; j < kColsN; ++j) {
            const float v = dBw[i][j] * dts[i];
            dB[i][j] += w[i] * v;
            if (tx + 16 * j < N) dwp[i] += v * Bs[(ty + 16 * i) * ldN + tx + 16 * j];
          }
        }
      }
      // write dx and dB; <dxb, x> and w . dw per row
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int s = s0 + ty + 16 * i;
        float rd = 0.f;
#pragma unroll
        for (int j = 0; j < kColsP; ++j)
          if (tx + 16 * j < P) rd += dxb[i][j] * Xs[(ty + 16 * i) * ldP + tx + 16 * j];
        rd = ssd_row_sum(rd);
        const float dw = ssd_row_sum(dwp[i]);
        if (s >= Q) continue;
        if (tx == 0) {
          rdot[s] = rd;
          dww[s] = dw * w[i];
        }
        float* dxrow = dx + ((step0 + s) * p.H + h) * P;
#pragma unroll
        for (int j = 0; j < kColsP; ++j)
          if (tx + 16 * j < P) dxrow[tx + 16 * j] = dxb[i][j] * dts[i];
        float* dbrow = dBh + ((step0 + s) * p.H + h) * N;
#pragma unroll
        for (int j = 0; j < kColsN; ++j)
          if (tx + 16 * j < N) dbrow[tx + 16 * j] = dB[i][j];
      }
      // column sums of ds . S over the 16 thread rows, in a fixed order
      __syncthreads();  // every read of Ps is done
#pragma unroll
      for (int j = 0; j < kRows; ++j) Ps[ty * kLdT + tx + 16 * j] = cs[j];
      __syncthreads();
      if (threadIdx.x < kTile && s0 + threadIdx.x < Q) {
        float col = 0.f;
        for (int r = 0; r < 16; ++r) col += Ps[r * kLdT + threadIdx.x];
        dLc[s0 + threadIdx.x] = -col - dww[s0 + threadIdx.x];
      }
    }

    // dL_Q = e^{L_Q} <dh, h_prev> + sum_s dww_s, from dh before it moves on
    __syncthreads();
    float part = 0.f, part_w = 0.f;
    for (int i = threadIdx.x; i < N * P; i += kSsdThreads) {
      const int k = (i / P) * ldP + i % P;
      part += dhs[k] * hps[k];
    }
    for (int s = threadIdx.x; s < Q; s += kSsdThreads) part_w += dww[s];
    const float dLtot = eLtot * ssd_block_sum(part, red) + ssd_block_sum(part_w, red);

    // ---- pass A: per t-block, sums over s <= t, and dh_prev ----
    float dhp[kColsN][kColsP];  // (C e^{L})^T dy for n = ty + 16 i, p = tx + 16 j
#pragma unroll
    for (int i = 0; i < kColsN; ++i)
#pragma unroll
      for (int j = 0; j < kColsP; ++j) dhp[i][j] = 0.f;
    for (int tb = 0; tb < nT; ++tb) {
      const int t0 = tb * kTile;
      __syncthreads();
      ssd_load_rows(Cs, ldN, Cc, bc_stride, t0, Q, N);
      ssd_load_rows(Ys, ldP, dyc, x_stride, t0, Q, P);
      float dC[kRows][kColsN], rs[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        rs[i] = 0.f;
#pragma unroll
        for (int j = 0; j < kColsN; ++j) dC[i][j] = 0.f;
      }
      for (int sb = 0; sb <= tb; ++sb) {
        const int s0 = sb * kTile;
        __syncthreads();  // Bs, Xs and Ds are free
        ssd_load_rows(Bs, ldN, Bc, bc_stride, s0, Q, N);
        ssd_load_rows(Xs, ldP, xc, x_stride, s0, Q, P);
        __syncthreads();
        float sc[kRows][kRows], ds[kRows][kRows];
        score_tile(Cs, Bs, Ys, Xs, Lc, dtv, ldN, ldP, N, P, Q, t0, s0, tx, ty, sc, ds);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            Ds[(ty + 16 * i) * kLdT + tx + 16 * j] = ds[i][j];
            rs[i] += ds[i][j] * sc[i][j];  // row i of dL's ds . S
          }
        __syncthreads();
        // rows t = t0 + ty + 16 i: dC += ds B
        for (int s = 0; s < kTile; ++s) {
          float dv[kRows], bv[kColsN];
#pragma unroll
          for (int i = 0; i < kRows; ++i) dv[i] = Ds[(ty + 16 * i) * kLdT + s];
#pragma unroll
          for (int j = 0; j < kColsN; ++j) bv[j] = tx + 16 * j < N ? Bs[s * ldN + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kColsN; ++j) dC[i][j] += dv[i] * bv[j];
        }
      }
      // inter-chunk terms of the t rows: dyh = dy h_prev^T
      float el[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int t = t0 + ty + 16 * i;
        el[i] = t < Q ? expf(Lc[t]) : 0.f;
      }
      float ip[kRows];
      {
        float dyh[kRows][kColsN];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kColsN; ++j) dyh[i][j] = 0.f;
        for (int pp = 0; pp < P; ++pp) {
          float yv[kRows], hv[kColsN];
#pragma unroll
          for (int i = 0; i < kRows; ++i) yv[i] = Ys[(ty + 16 * i) * ldP + pp];
#pragma unroll
          for (int j = 0; j < kColsN; ++j) hv[j] = tx + 16 * j < N ? hps[(tx + 16 * j) * ldP + pp] : 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kColsN; ++j) dyh[i][j] += yv[i] * hv[j];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          ip[i] = 0.f;
#pragma unroll
          for (int j = 0; j < kColsN; ++j) {
            dC[i][j] += dyh[i][j] * el[i];
            if (tx + 16 * j < N) ip[i] += dyh[i][j] * Cs[(ty + 16 * i) * ldN + tx + 16 * j];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int t = t0 + ty + 16 * i;
        const float rsum = ssd_row_sum(rs[i]), isum = ssd_row_sum(ip[i]);
        if (t >= Q) continue;
        if (tx == 0) dLc[t] += rsum + isum * el[i];  // t's only writer in pass A
        float* dcrow = dCh + ((step0 + t) * p.H + h) * N;
#pragma unroll
        for (int j = 0; j < kColsN; ++j)
          if (tx + 16 * j < N) dcrow[tx + 16 * j] = dC[i][j];
      }
      // dh_prev += (C e^{L})^T dy over this t-block
      const int nt = min(kTile, Q - t0);
      for (int t = 0; t < nt; ++t) {
        const float e = expf(Lc[t0 + t]);
        float cv[kColsN], yv[kColsP];
#pragma unroll
        for (int i = 0; i < kColsN; ++i) cv[i] = ty + 16 * i < N ? Cs[t * ldN + ty + 16 * i] * e : 0.f;
#pragma unroll
        for (int j = 0; j < kColsP; ++j) yv[j] = tx + 16 * j < P ? Ys[t * ldP + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < kColsN; ++i)
#pragma unroll
          for (int j = 0; j < kColsP; ++j) dhp[i][j] += cv[i] * yv[j];
      }
    }

    // dh <- (C e^{L})^T dy + e^{L_Q} dh (each thread its own elements)
#pragma unroll
    for (int i = 0; i < kColsN; ++i) {
      const int n = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kColsP; ++j) {
        const int pp = tx + 16 * j;
        if (n < N && pp < P) dhs[n * ldP + pp] = dhp[i][j] + eLtot * dhs[n * ldP + pp];
      }
    }
    // dla_s = sum_{t >= s} dL_t + dL_Q;  ddt = dla A + <dxb, x>;  dA += <dla, dt>
    __syncthreads();
    ssd_suffix_sum(dLc, Q);
    __syncthreads();
    float dAp = 0.f;
    for (int s = threadIdx.x; s < Q; s += kSsdThreads) {
      const float dla = dLc[s] + dLtot;
      ddt[(step0 + s) * p.H + h] = dla * a + rdot[s];
      dAp += dla * dtv[s];
    }
    dA_acc += ssd_block_sum(dAp, red);
  }
  if (threadIdx.x == 0) dAbh[b * p.H + h] = dA_acc;
}

}  // namespace

// x, dy (B, T, H, P), dt (B, T, H), A (H,), Bm/Cm (B, T, G, N), states
// (B, H, T / Q, N, P) from ssd_fwd, all float32 and contiguous.  Writes dx
// like x, ddt like dt, dBh/dCh (B, T, H, N) per head and dAbh (B, H).
// Launches on `stream` without synchronising; returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for sizes it does not take).
extern "C" int ssd_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* states, const void* dy, void* dx, void* ddt,
                       void* dBh, void* dCh, void* dAbh, int B, int T, int H, int P, int G, int N,
                       int Q, void* stream) {
  const SsdParams p{B, T, H, P, G, N, Q, Q > 0 ? T / Q : 0};
  if (!ssd_params_ok(p)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_floats(N, P, Q) * sizeof(float);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_kernel<<<dim3(H, B), kSsdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(states), static_cast<const float*>(dy), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dBh), static_cast<float*>(dCh),
      static_cast<float*>(dAbh), p);
  return (int)cudaGetLastError();
}
