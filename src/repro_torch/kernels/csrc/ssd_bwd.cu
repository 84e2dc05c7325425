// Mamba2 SSD reverse-scan backward for Hopper (sm_90a): 3xTF32 tensor-core
// products at float32 accuracy.
//
// Replaces: src/repro/kernels/ssd.py `_ssd_bwd_kernel` (the Pallas TPU kernel
// launched by `ssd_bwd_chunked_pallas`).  Same function: walking the chunks
// of one (batch, head) in reverse, carrying dh = dLoss/dh (N x P) from the
// chunks after, it recomputes the chunk's decay and score tiles from
// (x, dt, A, B, C) and the forward's entry state h_prev, and emits dx, ddt,
// dB and dC per head and dA per (batch, head).  The wrapper sums dA over the
// batch and dB/dC over each group's heads (ssd.py:268-271).  With
// S = C B^T, D = e^{L_t - L_s} [s <= t], xb = dt x, L = cumsum(dt A) and
// w_s = e^{L_Q - L_s}:
//   dM    = dy xb^T,  dxb = (S.D)^T dy + w . (B dh),  ds = dM . D
//   dC    = ds B + e^{L} (dy h_prev^T),  dB = ds^T C + w . (xb dh^T)
//   dL_t  = rowsum_t(ds . S) - colsum_t(ds . S) + e^{L_t} C_t . (h_prev dy_t)
//           - w_t (B_t . (xb_t dh^T)),
//   dL_Q  = e^{L_Q} <dh, h_prev> + sum_s w_s (B_s . (xb_s dh^T)),
//   dla_s = sum_{t >= s} dL_t + dL_Q  (ssd.py:197),
//   ddt   = dla A + <dxb, x>,  dA += <dla, dt>,  dx = dt dxb,
//   dh   <- (C e^{L})^T dy + e^{L_Q} dh.
// The decay is computed only where s <= t.
//
// What bounds it on the H100: operations.  Per chunk 3N + 2P multiply-adds
// for each pair s <= t and 4 Q N P for the state terms, as 3xTF32 on the
// tensor cores (chip_smoke.py `_ssd_bounds`).  This design does about 1.6x
// that per (batch, head, chunk): S and dM in both passes, over whole 16 x 32
// warp tiles on the diagonal, and S once per head.
//
// Design (fa_mma.cuh has the product, the split and the fragment layouts):
// - Every product is mma.sync.m16n8k8 TF32 with the 3xTF32 split (big·small
//   + small·big + big·big, f32 accumulation).  Every operand is an f32
//   value, so every product takes all three.
// - One CTA of 8 warps per (head, batch) walks the chunks in reverse with dh
//   (N x P) in shared memory: the TPU kernel's VMEM carry and reversed
//   chunk grid.  Within a chunk, pass B then pass A.
// - Pass B (as fa_bwd_dkv.cu holds keys) holds a block of 128 s-rows of B
//   and x; warp w owns rows 16w..16w+15 and all columns.  It streams the
//   t-rows >= the block in steps of 32 (C, dy), and per step takes
//   S^T = B_s C_t^T (k over N) and dM^T = x_s dy_t^T (k over P) into
//   accumulators; then, on the fragments, ds^T = dM^T dt_s D^T and
//   (S.D)^T, with the column part of dL (sum over t of ds . S) as a row sum
//   of the fragment; then dB_s += ds^T C_t and dxb_s += (S.D)^T dy_t with
//   both accumulators fed straight back as A operands (t permuted within
//   each 8-step, fa_frag_b_rows on the B side).  A step whose 32 columns
//   all lie before a warp's rows is skipped by that warp.  Then the state
//   terms of its rows: dBw = xb_s dh^T (k over P), dB += w dBw, dw =
//   <dBw, B>; dxb += w (B_s dh) (k over N, B_s read in the permuted order,
//   fa_frag_a_pairs).
// - Pass A (as fa_bwd_dq.cu holds queries) holds 128 t-rows of C and dy;
//   warp w owns 16 of them.  It streams the s-rows <= the block in steps of
//   32 (B, x): S = C_t B_s^T, dM = dy_t x_s^T, ds = dM dt_s D and the row
//   part of dL, then dC_t += ds B_s with ds as the A operand.  Then the
//   inter-chunk terms: dyh = dy_t h_prev^T (k over P), dC += e^{L} dyh, ip
//   = <dyh, C>; and dh += (C_t e^{L})^T dy_t over the block: warp w owns dh
//   rows n = 16w..16w+15, k runs over t, and the A operand is C read
//   transposed (fa_frag_at_rows: tile rows 2t and 2t + 1, columns g and
//   g + 8, scaled by e^{L_t}).
// - Staging.  The held block moves in by cp.async (all of a thread's loads
//   in flight at once) under the first step's load.  A streamed step is
//   loaded, split once into planes of big and small TF32 parts, and read as
//   such by all eight warps, so its B fragments take no split work; the
//   next step's rows are prefetched into L1 while this one is multiplied.
//   h_prev is read by pass A's tail only, and goes over the step planes
//   there.
// - Shared memory: rows padded by 16 bytes (FaPad), pitches 132 (N-wide)
//   and 68 (P-wide) words, 4 mod 16: the row reads (g, t) of fa_frag_a and
//   fa_frag_bt, the permuted row pairs (2t, g) of fa_frag_b_rows (here on
//   the split planes too) and the transposed reads (2t, g) of
//   fa_frag_at_rows hit 32 distinct banks.  The one read with two-way
//   conflicts is fa_frag_a_pairs' (g, 2t) on B_s in dxb += w (B_s dh), four
//   loads per 8-step against sixteen conflict-free ones of dh.  Widths are
//   padded to N = 128 and P = 64 with zero columns, and rows past Q are
//   zero, so every N <= 128, P <= 64 and Q <= 2195 (shared memory) runs the
//   same code.  At Q = 256: dh 128 x 68, the held block 128 x (132 + 68),
//   the step's planes 2 x 32 x (132 + 68), 5 Q + 32 floats: 193,664 bytes,
//   one CTA per SM.
// - The decay is e^{L_t - L_s} on the MUFU unit (__expf): its error is far
//   below that of L_t - L_s itself, rounded in float32 at |L| ~ 1e3.
// - Each step's products go to fresh accumulators and join the running sums
//   (dB, dxb, dC, dh) by a rounded f32 add: the tensor core's own
//   accumulation does not round to nearest.  Every sum over threads is a
//   quad shuffle, a per-lane add or a fixed-order tree; no atomics, so the
//   result does not depend on scheduling.
// - ptxas (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3): 255 registers,
//   48 bytes of stack, 56 bytes of spill stores and 124 of spill loads.
//   Fewer registers would free none of the SM for a second CTA (shared
//   memory holds it to one), so the kernel takes all 255.
#include "fa_mma.cuh"
#include "ssd_common.cuh"

namespace {

constexpr size_t kFixedFloats =
    (size_t)kMaxN * kLdP + (size_t)kBlk * (kLdN + kLdP) + 2 * (size_t)(kPlN + kPlP) + 32;
static_assert(kMaxN * kLdP <= 2 * (kPlN + kPlP), "h_prev fits over the step planes");

// acc[j] += A Bt^T for the warp's 16 rows of A (row-major, k over K) and
// rows [8j, 8j + 8) of Bt (row-major, k along the row).
template <int K, int NJ, int LDA, int LDB>
__device__ __forceinline__ void mma_abt(float (&acc)[NJ][4], const float* A, const float* Bt,
                                        int g, int tq) {
#pragma unroll
  for (int ks = 0; ks < K / 8; ++ks) {
    uint32_t ab[4], as[4];
    fa_frag_a<true, LDA>(A + ks * 8, g, tq, ab, as);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t bb[2], bs[2];
      fa_frag_bt<true, LDB>(Bt + j * 8 * LDB + ks * 8, g, tq, bb, bs);
      fa_mma3<true, true>(acc[j], ab, as, bb, bs);
    }
  }
}

// Sum over the four lanes of a quad (the lanes that share a fragment row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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
  const int grp = h / (p.H / p.G);
  const int N = p.N, P = p.P, Q = p.Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int r0 = 16 * warp;          // the warp's first row of the held block
  float* dhs = smem;                 // kMaxN x kLdP: dh carried from the later chunks
  float* hN = dhs + kMaxN * kLdP;    // kBlk x kLdN: held B (pass B) or C (pass A)
  float* hP = hN + kBlk * kLdN;      // kBlk x kLdP: held x (pass B) or dy (pass A)
  // streamed C (pass B) or B (pass A), then dy or x, each as split planes
  uint32_t* sN = reinterpret_cast<uint32_t*>(hP + kBlk * kLdP);  // 2 x kStep x kLdN
  uint32_t* sP = sN + 2 * kPlN;                                  // 2 x kStep x kLdP
  float* hps = reinterpret_cast<float*>(sN);  // kMaxN x kLdP: h_prev, in pass A's tail
  float* red = reinterpret_cast<float*>(sP + 2 * kPlP);  // 32: block-sum scratch
  float* Lc = red + 32;              // Q: cumulative log-decay
  float* dtv = Lc + Q;               // Q: dt
  float* dLc = dtv + Q;              // Q: dLoss/dL_t, then its suffix sums
  float* rdot = dLc + Q;             // Q: <dxb_s, x_s>
  float* dww = rdot + Q;             // Q: w_s (B_s . (xb_s dh^T))
  const float a = A[h];
  const size_t x_stride = (size_t)p.H * P, bc_stride = (size_t)p.G * N;
  float dA_acc = 0.f;

  for (int i = threadIdx.x; i < kMaxN * kLdP; i += kSsdThreads) dhs[i] = 0.f;

  for (int c = p.nc - 1; c >= 0; --c) {
    const size_t step0 = (size_t)b * p.T + (size_t)c * Q;
    const float* xc = x + (step0 * p.H + h) * P;
    const float* dyc = dy + (step0 * p.H + h) * P;
    const float* Bc = Bm + (step0 * p.G + grp) * N;
    const float* Cc = Cm + (step0 * p.G + grp) * N;
    const float* st = states + (((size_t)b * p.H + h) * p.nc + c) * (size_t)N * P;
    __syncthreads();  // the later chunk is done with every buffer
    for (int i = threadIdx.x; i < Q; i += kSsdThreads) {
      const float d = dt[(step0 + i) * p.H + h];
      dtv[i] = d;
      Lc[i] = d * a;
    }
    __syncthreads();
    ssd_prefix_sum(Lc, Q);
    __syncthreads();
    const float Ltot = Lc[Q - 1], eLtot = expf(Ltot);

    // ---- pass B: per s-block, sums over t >= s, and the state terms ----
    for (int s0 = 0; s0 < Q; s0 += kBlk) {
      __syncthreads();  // hN, hP are free
      cp_rows<kBlk, kMaxN>(hN, kLdN, Bc, bc_stride, s0, Q, N);
      cp_rows<kBlk, kMaxP>(hP, kLdP, xc, x_stride, s0, Q, P);
      fa_cp_commit();
      const int sw = s0 + r0;  // the warp's first s
      const bool live = sw < Q;
      float Ls[2], dts[2], cs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = sw + g + 8 * r;
        Ls[r] = s < Q ? Lc[s] : 0.f;
        dts[r] = s < Q ? dtv[s] : 0.f;
      }
      float dB[kKN][4], dxb[kKP][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int n = 0; n < kKN; ++n) dB[n][i] = 0.f;
#pragma unroll
        for (int n = 0; n < kKP; ++n) dxb[n][i] = 0.f;
      }
      for (int t0 = s0; t0 < Q; t0 += kStep) {
        __syncthreads();  // sN, sP are free
        load_split<kStep, kMaxN, kPlN>(sN, kLdN, Cc, bc_stride, t0, Q, N);
        load_split<kStep, kMaxP, kPlP>(sP, kLdP, dyc, x_stride, t0, Q, P);
        fa_cp_wait<0>();  // the held block
        __syncthreads();
        prefetch_rows<kStep>(Cc, bc_stride, t0 + kStep, Q, N);
        prefetch_rows<kStep>(dyc, x_stride, t0 + kStep, Q, P);
        if (!live || t0 + kStep <= sw) continue;  // every t of the step is before the rows
        float S[kJS][4], dM[kJS][4];
#pragma unroll
        for (int j = 0; j < kJS; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) S[j][i] = dM[j][i] = 0.f;
        // S^T = B_s C_t^T and x_s dy_t^T
        mma_abt_planes<kMaxN, kJS, kLdN, kLdN, kPlN>(S, hN + r0 * kLdN, sN, g, tq);
        mma_abt_planes<kMaxP, kJS, kLdP, kLdP, kPlP>(dM, hP + r0 * kLdP, sP, g, tq);
#pragma unroll
        for (int j = 0; j < kJS; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = i >> 1, s = sw + g + 8 * r, t = t0 + 8 * j + 2 * tq + (i & 1);
            // the decay only where s <= t: e^{L_t - L_s} <= 1, never inf
            const float d = t < Q && s <= t ? __expf(Lc[t] - Ls[r]) : 0.f;
            const float ds = dM[j][i] * dts[r] * d;
            cs[r] += ds * S[j][i];  // column s of dL's ds . S
            dM[j][i] = ds;
            S[j][i] *= d;
          }
        mma_acc_rows<kJS, kKN, kLdN, kPlN>(dB, dM, sN, g, tq);  // dB_s += ds^T C_t
        mma_acc_rows<kJS, kKP, kLdP, kPlP>(dxb, S, sP, g, tq);  // dxb_s += (S.D)^T dy_t
      }
      if (!live) continue;

      // state terms of the s rows: h = e^{L_Q} h_prev + (B . w)^T xb
      float w[2], dwp[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) w[r] = sw + g + 8 * r < Q ? expf(Ltot - Ls[r]) : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // dBw = xb dh^T; dB += w . dBw; dw = <dBw, B>
        float part[kKN / 2][4];
#pragma unroll
        for (int n = 0; n < kKN / 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
        mma_abt<kMaxP, kKN / 2, kLdP, kLdP>(part, hP + r0 * kLdP, dhs + half * (kMaxN / 2) * kLdP,
                                            g, tq);
#pragma unroll
        for (int n = 0; n < kKN / 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = i >> 1, col = half * (kMaxN / 2) + 8 * n + 2 * tq + (i & 1);
            const float v = part[n][i] * dts[r];
            dB[half * (kKN / 2) + n][i] += w[r] * v;
            dwp[r] += v * hN[(r0 + g + 8 * r) * kLdN + col];
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = sw + g + 8 * r;
        if (s >= Q) continue;
        float* dbrow = dBh + ((step0 + s) * p.H + h) * N;
#pragma unroll
        for (int n = 0; n < kKN; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * n + 2 * tq + e < N) dbrow[8 * n + 2 * tq + e] = dB[n][2 * r + e];
      }
      {  // dxb += w . (B dh)
        float part[kKP][4];
#pragma unroll
        for (int n = 0; n < kKP; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kKN; ++ks) {
          uint32_t ab[4], as[4];
          fa_frag_a_pairs<true, kLdN>(hN + r0 * kLdN + ks * 8, g, tq, ab, as);
#pragma unroll
          for (int n = 0; n < kKP; ++n) {
            uint32_t bb[2], bs[2];
            fa_frag_b_rows<true, kLdP>(dhs + ks * 8 * kLdP + n * 8, g, tq, bb, bs);
            fa_mma3<true, true>(part[n], ab, as, bb, bs);
          }
        }
#pragma unroll
        for (int n = 0; n < kKP; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) dxb[n][i] += w[i >> 1] * part[n][i];
      }
      // write dx; <dxb, x>, w . dw and dL's column part per row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = sw + g + 8 * r;
        float rd = 0.f;
#pragma unroll
        for (int n = 0; n < kKP; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            rd += dxb[n][2 * r + e] * hP[(r0 + g + 8 * r) * kLdP + 8 * n + 2 * tq + e];
        rd = quad_sum(rd);
        const float dw = quad_sum(dwp[r]) * w[r], csum = quad_sum(cs[r]);
        if (s >= Q) continue;
        if (tq == 0) {
          rdot[s] = rd;
          dww[s] = dw;
          dLc[s] = -csum - dw;
        }
        float* dxrow = dx + ((step0 + s) * p.H + h) * P;
#pragma unroll
        for (int n = 0; n < kKP; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * n + 2 * tq + e < P) dxrow[8 * n + 2 * tq + e] = dxb[n][2 * r + e] * dts[r];
      }
    }

    // dL_Q = e^{L_Q} <dh, h_prev> + sum_s dww_s, from dh before it moves on
    __syncthreads();
    float part_h = 0.f, part_w = 0.f;
    for (int i = threadIdx.x; i < N * P; i += kSsdThreads) {
      const int k = (i / P) * kLdP + i % P;
      part_h += dhs[k] * st[i];
    }
    for (int s = threadIdx.x; s < Q; s += kSsdThreads) part_w += dww[s];
    const float dLtot = eLtot * ssd_block_sum(part_h, red) + ssd_block_sum(part_w, red);
    // dh <- e^{L_Q} dh; pass A adds (C e^{L})^T dy block by block
    for (int i = threadIdx.x; i < kMaxN * kLdP; i += kSsdThreads) dhs[i] *= eLtot;

    // ---- pass A: per t-block, sums over s <= t, the inter-chunk terms and dh ----
    for (int t0 = 0; t0 < Q; t0 += kBlk) {
      __syncthreads();  // hN, hP are free (and dhs is scaled)
      cp_rows<kBlk, kMaxN>(hN, kLdN, Cc, bc_stride, t0, Q, N);
      cp_rows<kBlk, kMaxP>(hP, kLdP, dyc, x_stride, t0, Q, P);
      fa_cp_commit();
      const int tw = t0 + r0;  // the warp's first t
      const bool live = tw < Q;
      float Lt[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) Lt[r] = tw + g + 8 * r < Q ? Lc[tw + g + 8 * r] : 0.f;
      float dC[kKN][4];
#pragma unroll
      for (int n = 0; n < kKN; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dC[n][i] = 0.f;
      const int s_end = min(t0 + kBlk, Q);
      for (int s0 = 0; s0 < s_end; s0 += kStep) {
        __syncthreads();  // sN, sP are free
        load_split<kStep, kMaxN, kPlN>(sN, kLdN, Bc, bc_stride, s0, Q, N);
        load_split<kStep, kMaxP, kPlP>(sP, kLdP, xc, x_stride, s0, Q, P);
        fa_cp_wait<0>();  // the held block
        __syncthreads();
        prefetch_rows<kStep>(Bc, bc_stride, s0 + kStep, s_end, N);
        prefetch_rows<kStep>(xc, x_stride, s0 + kStep, s_end, P);
        if (!live || s0 > tw + 15) continue;  // every s of the step is after the rows
        float S[kJS][4], dM[kJS][4];
#pragma unroll
        for (int j = 0; j < kJS; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) S[j][i] = dM[j][i] = 0.f;
        // S = C_t B_s^T and dy_t x_s^T
        mma_abt_planes<kMaxN, kJS, kLdN, kLdN, kPlN>(S, hN + r0 * kLdN, sN, g, tq);
        mma_abt_planes<kMaxP, kJS, kLdP, kLdP, kPlP>(dM, hP + r0 * kLdP, sP, g, tq);
#pragma unroll
        for (int j = 0; j < kJS; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = i >> 1, t = tw + g + 8 * r, s = s0 + 8 * j + 2 * tq + (i & 1);
            const float ds = t < Q && s <= t ? dM[j][i] * dtv[s] * __expf(Lt[r] - Lc[s]) : 0.f;
            rs[r] += ds * S[j][i];  // row t of dL's ds . S
            dM[j][i] = ds;
          }
        mma_acc_rows<kJS, kKN, kLdN, kPlN>(dC, dM, sN, g, tq);  // dC_t += ds B_s
      }
      __syncthreads();  // the step planes are free: h_prev goes there
      cp_rows<kMaxN, kMaxP>(hps, kLdP, st, P, 0, N, P);
      fa_cp_commit();
      fa_cp_wait<0>();
      __syncthreads();
      if (live) {  // inter-chunk terms of the t rows: dyh = dy h_prev^T
        float el[2], ip[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) el[r] = tw + g + 8 * r < Q ? expf(Lt[r]) : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float part[kKN / 2][4];
#pragma unroll
          for (int n = 0; n < kKN / 2; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
          mma_abt<kMaxP, kKN / 2, kLdP, kLdP>(part, hP + r0 * kLdP,
                                              hps + half * (kMaxN / 2) * kLdP, g, tq);
#pragma unroll
          for (int n = 0; n < kKN / 2; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = i >> 1, col = half * (kMaxN / 2) + 8 * n + 2 * tq + (i & 1);
              dC[half * (kKN / 2) + n][i] += part[n][i] * el[r];
              ip[r] += part[n][i] * hN[(r0 + g + 8 * r) * kLdN + col];
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = tw + g + 8 * r;
          const float rsum = quad_sum(rs[r]), isum = quad_sum(ip[r]);
          if (t >= Q) continue;
          if (tq == 0) dLc[t] += rsum + isum * el[r];  // t's only writer in pass A
          float* dcrow = dCh + ((step0 + t) * p.H + h) * N;
#pragma unroll
          for (int n = 0; n < kKN; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (8 * n + 2 * tq + e < N) dcrow[8 * n + 2 * tq + e] = dC[n][2 * r + e];
        }
      }
      {  // dh += (C e^{L})^T dy over this block; warp w owns dh rows 16w..16w+15
        const int nrows = min(kBlk, Q - t0);
        float part[kKP][4];
#pragma unroll
        for (int n = 0; n < kKP; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kBlk / 8; ++ks) {
          if (8 * ks >= nrows) break;
          const int ta = t0 + 8 * ks + 2 * tq;
          const float e0 = ta < Q ? expf(Lc[ta]) : 0.f, e1 = ta + 1 < Q ? expf(Lc[ta + 1]) : 0.f;
          uint32_t ab[4], as[4];
          fa_frag_at_rows<kLdN>(hN + 8 * ks * kLdN + r0, g, tq, e0, e1, ab, as);
#pragma unroll
          for (int n = 0; n < kKP; ++n) {
            uint32_t bb[2], bs[2];
            fa_frag_b_rows<true, kLdP>(hP + 8 * ks * kLdP + n * 8, g, tq, bb, bs);
            fa_mma3<true, true>(part[n], ab, as, bb, bs);
          }
        }
#pragma unroll
        for (int n = 0; n < kKP; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dhs[(r0 + g + 8 * (i >> 1)) * kLdP + 8 * n + 2 * tq + (i & 1)] += part[n][i];
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
  const size_t smem = (kFixedFloats + 5 * (size_t)Q) * sizeof(float);
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
