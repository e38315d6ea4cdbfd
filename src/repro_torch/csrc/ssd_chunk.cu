// Mamba-2 SSD chunk-local terms for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py::ssd_chunk_padded
// (body _ssd_chunk_kernel).  Per (head row bh, chunk n) of L positions, with
// ell the inclusive cumsum of a·dt over the chunk:
//   y_intra = (C·Bᵀ ⊙ exp(ell_t - ell_s) [s <= t]) @ (dt ⊙ x)       (L x P)
//   state   = (B ⊙ exp(ell_L - ell) ⊙ dt)ᵀ @ x                       (S x P)
//   c_dec   = C ⊙ exp(ell)                                            (L x S)
//   decay   = exp(ell_L)
// The inter-chunk recurrence and y_inter stay torch ops (kernels/ssd/ops.py).
// One block per (bh, chunk) on both routes; the gate is exponentiated only
// for s <= t (the masked half would overflow).  B and C are per group: head
// row bh reads group row bh / heads_per_group, so zamba2's 80 heads per
// group read one copy instead of 80.  All inputs are read through their
// strides (the last dim contiguous); the outputs are contiguous.  T must be
// a multiple of L (the caller pads with dt = 0).  The route is chosen in
// Python before the launch (kernels/ssd/kernel.py::route), one C entry each:
//
// - mma route (ssd_chunk_mma_launch: L % 16 == 0, P and S multiples of 8, x,
//   B and C rows 16-byte aligned).  What bounds it: per (bh, chunk)
//   L²·(S + P) + 2·L·S·P operations over the causal half on L·(P + 2 S) +
//   2 L inputs; run three times on the TF32 tensor cores (495 TFLOP/s) that
//   is below the bytes every launch moves (x, y and c_dec; 0.18 ms at the
//   main path's shape), so the function is bound by bytes.  Design: all
//   three products run on mma.sync.m16n8k8 TF32 in 3xTF32 form, each fp32
//   operand split into hi = rna(v) and lo = rna(v - hi), hi·lo' + lo·hi'
//   accumulated before hi·hi' into fp32 (within fp32 rounding of plain
//   fp32; single TF32 is not used anywhere).  A block of 4 warps stages x,
//   B and C once with 16-byte cp.async into rows padded by 4 floats (~104
//   KB at L = 128, P = S = 64, so two blocks share an SM and one block's
//   loads overlap the other's products); ell is a warp-level scan.  A warp
//   owns two 16-row strips of t, i and L/16 - 1 - i (balanced: 9 of the 36
//   causal 16 x 16 tiles each at L = 128) and computes C·Bᵀ only for
//   s < 16(i + 1), 32 columns at a time; the tile is gated (exp(ell_t -
//   ell_s)·dt_s, in the fragment) and fed from registers as the A operand
//   of W·x, k permuted within each 8-wide slab (slot q <- column 2q, slot
//   q + 4 <- column 2q + 1), so no L x L tile exists.  The state product
//   gives each warp 16 rows of S, its A operand read column-wise from the B
//   tile with the same permutation (bank-conflict free at row pitches of 4
//   mod 8).  Each of the three passes of a 3xTF32 product runs over all of
//   a warp's output tiles, so consecutive mmas are independent.  What holds
//   it back now is instruction throughput: the hi/lo splits (four integer
//   and float ops per operand value, each x value split again by every
//   product that reads it), not the tensor cores.
// - simt route (ssd_chunk_launch: every other shape).  IEEE fp32 FMAs on
//   the CUDA cores (67 TFLOP/s; bound by operations at ~16 per byte).  The
//   x, B and C tiles and the full L x L weight tile in shared memory (~167
//   KB at the main path's shape); 16 x 16 threads each own an 8 x 8 block
//   of every product, so a shared-memory load feeds eight FMAs.  ell is one
//   thread's sequential sum.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int MAX_DIM = 128;   // L, P and S: 8 rows or columns per thread

struct SsdArgs {
  const float *x, *dt, *a, *b, *c;
  float *y, *states, *cdec, *decay;
  long long sx0, sx1, sdt0, sdt1, sb0, sb1, sc0, sc1;
  int t, p, s, L, nc, hpg;
};

__host__ __device__ inline long long smem_floats(int L, int p, int s) {
  return (long long)L * p + 2LL * L * (s + 1) + (long long)L * (L + 1) + 3LL * L;
}

__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel(SsdArgs g) {
  extern __shared__ float smem[];
  const int L = g.L, P = g.p, S = g.s, S1 = S + 1, L1 = L + 1;
  float* xs = smem;            // [L][P]
  float* bs = xs + L * P;      // [L][S1]
  float* cs = bs + L * S1;     // [L][S1]
  float* w = cs + L * S1;      // [L][L1]  gated C·Bᵀ, zero above the diagonal
  float* dts = w + L * L1;     // [L]
  float* ell = dts + L;        // [L]
  float* wdt = ell + L;        // [L]     exp(ell_L - ell_s)·dt_s

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x, n = blockIdx.y, t0 = n * L, grp = bh / g.hpg;
  const float* xp = g.x + bh * g.sx0 + t0 * g.sx1;
  const float* dtp = g.dt + bh * g.sdt0 + t0 * g.sdt1;
  const float* bp = g.b + grp * g.sb0 + t0 * g.sb1;
  const float* cp = g.c + grp * g.sc0 + t0 * g.sc1;
  for (int e = tid; e < L * P; e += THREADS) xs[e] = xp[(e / P) * g.sx1 + e % P];
  for (int e = tid; e < L * S; e += THREADS) {
    const int i = e / S, j = e % S;
    bs[i * S1 + j] = bp[i * g.sb1 + j];
    cs[i * S1 + j] = cp[i * g.sc1 + j];
  }
  for (int i = tid; i < L; i += THREADS) dts[i] = dtp[i * g.sdt1];
  __syncthreads();
  if (tid == 0) {
    const float a = g.a[bh];
    float acc = 0.f;
    for (int i = 0; i < L; ++i) {
      acc = __fadd_rn(acc, __fmul_rn(a, dts[i]));
      ell[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < L; i += THREADS) wdt[i] = expf(ell[L - 1] - ell[i]) * dts[i];

  {  // w[t][s] = (C_t · B_s) exp(ell_t - ell_s), s <= t: rows ty + 16 r, cols tx + 16 c
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    for (int k = 0; k < S; ++k) {
      float cv[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) cv[r] = ty + 16 * r < L ? cs[(ty + 16 * r) * S1 + k] : 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) bv[c] = tx + 16 * c < L ? bs[(tx + 16 * c) * S1 + k] : 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int t = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int s = tx + 16 * c;
        if (t < L && s < L) w[t * L1 + s] = s <= t ? acc[r][c] * expf(ell[t] - ell[s]) : 0.f;
      }
    }
  }
  __syncthreads();

  {  // y_intra[t][p] = Σ_s w[t][s] (dt_s x_s[p]): rows ty + 16 r, cols tx + 16 c
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    for (int s = 0; s < L; ++s) {
      const float d_s = dts[s];
      float wv[8], xv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) wv[r] = ty + 16 * r < L ? w[(ty + 16 * r) * L1 + s] : 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) xv[c] = tx + 16 * c < P ? xs[s * P + tx + 16 * c] * d_s : 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(wv[r], xv[c], acc[r][c]);
    }
    float* yp = g.y + ((long long)bh * g.t + t0) * P;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (ty + 16 * r < L && tx + 16 * c < P) yp[(ty + 16 * r) * P + tx + 16 * c] = acc[r][c];
  }

  {  // state[i][p] = Σ_s (B_s[i] wdt_s) x_s[p]: rows ty + 16 r, cols tx + 16 c
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    for (int s = 0; s < L; ++s) {
      const float ws = wdt[s];
      float bv[8], xv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) bv[r] = ty + 16 * r < S ? bs[s * S1 + ty + 16 * r] * ws : 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) xv[c] = tx + 16 * c < P ? xs[s * P + tx + 16 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(bv[r], xv[c], acc[r][c]);
    }
    float* sp = g.states + ((long long)bh * g.nc + n) * S * P;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (ty + 16 * r < S && tx + 16 * c < P) sp[(ty + 16 * r) * P + tx + 16 * c] = acc[r][c];
  }

  float* cdp = g.cdec + ((long long)bh * g.t + t0) * S;
  for (int e = tid; e < L * S; e += THREADS) {
    const int i = e / S, j = e % S;
    cdp[e] = cs[i * S1 + j] * expf(ell[i]);
  }
  if (tid == 0) g.decay[(long long)bh * g.nc + n] = expf(ell[L - 1]);
}

// ---------------------------------------------------------------------------
// mma route: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

namespace mma {
constexpr int WARPS = 4, THREADS = 32 * WARPS;

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// x [L][P + 4], B [L][round16(S) + 4], C [L][S + 4], dt, ell, wdt [L]
__host__ __device__ inline long long smem_floats(int L, int p, int s) {
  return (long long)L * ((p + 4) + (round16(s) + 4) + (s + 4)) + 3LL * L;
}

using tf32x3::cp_async16;
using tf32x3::mma_tf32;
using tf32x3::split;
using tf32x3::split_a;

// d[n] += a·b[n] in 3xTF32 for the N tiles with n < live: the cross terms
// hi·lo' + lo·hi' first, then hi·hi'.  Each pass runs over all tiles, so
// consecutive mmas are independent (a warp runs its instructions in order,
// and an mma that waits on the one before it stalls the warp for its whole
// latency)
template <int N>
__device__ __forceinline__ void mma3(float (*d)[4], const unsigned* ahi, const unsigned* alo,
                                     unsigned (*bhi)[2], unsigned (*blo)[2],
                                     int live) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < live) mma_tf32(d[n], ahi, blo[n][0], blo[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < live) mma_tf32(d[n], alo, bhi[n][0], bhi[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < live) mma_tf32(d[n], ahi, bhi[n][0], bhi[n][1]);
}

// o[pn] += A · x[rows s, s + 1][8 pn + gq] for the n8 tiles of P: the B
// fragment of k slots q and q + 4 is rows s = s0 + 2q and s + 1 of x (the
// permutation the A operand was built with)
template <int PT>
__device__ __forceinline__ void times_x(float (*o)[4], const unsigned* ahi, const unsigned* alo,
                                        const float* x0, int XP, int P) {
  unsigned bhi[PT][2], blo[PT][2];
#pragma unroll
  for (int pn = 0; pn < PT; ++pn) {
    if (8 * pn < P) {
      split(x0[8 * pn], bhi[pn][0], blo[pn][0]);
      split(x0[XP + 8 * pn], bhi[pn][1], blo[pn][1]);
    }
  }
  mma3<PT>(o, ahi, alo, bhi, blo, P / 8);
}

// w = rows r0 .. r0 + 15 of C times columns s0 .. s0 + 8 tiles - 1 of Bᵀ
// (tiles n8 tiles: 2 or 4), over k = 0 .. S: one split C fragment serves
// every tile
__device__ __forceinline__ void c_times_b(float (*w)[4], const float* cs, const float* bs,
                                          int CP, int BP, int S, int r0, int s0, int tiles,
                                          int gq, int q) {
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j][0] = w[j][1] = w[j][2] = w[j][3] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < S; k0 += 8) {
    unsigned ahi[4], alo[4];
    const float* c0 = cs + (r0 + gq) * CP + k0 + q;
    split_a(c0[0], c0[8 * CP], c0[4], c0[8 * CP + 4], ahi, alo);
    unsigned bhi[4][2], blo[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < tiles) {
        const float* b0 = bs + (s0 + 8 * j + gq) * BP + k0 + q;
        split(b0[0], bhi[j][0], blo[j][0]);
        split(b0[4], bhi[j][1], blo[j][1]);
      }
    }
    mma3<4>(w, ahi, alo, bhi, blo, tiles);
  }
}

// PT: n8 tiles of P a warp holds (P <= 8 PT)
template <int PT>
__global__ void __launch_bounds__(THREADS, 2) ssd_mma_kernel(SsdArgs g) {
  extern __shared__ __align__(16) float smem[];
  const int L = g.L, P = g.p, S = g.s, SP = round16(S);
  const int XP = P + 4, BP = SP + 4, CP = S + 4;   // row pitches, 4 mod 8
  float* xs = smem;             // [L][XP]
  float* bs = xs + L * XP;      // [L][BP], columns S..SP-1 zero
  float* cs = bs + L * BP;      // [L][CP]
  float* dts = cs + L * CP;     // [L]
  float* ell = dts + L;         // [L]
  float* wdt = ell + L;         // [L]   exp(ell_L - ell_s)·dt_s

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, q = lane % 4;
  const int bh = blockIdx.x, n = blockIdx.y, t0 = n * L, grp = bh / g.hpg;
  const float* xp = g.x + bh * g.sx0 + t0 * g.sx1;
  const float* dtp = g.dt + bh * g.sdt0 + t0 * g.sdt1;
  const float* bp = g.b + grp * g.sb0 + t0 * g.sb1;
  const float* cp = g.c + grp * g.sc0 + t0 * g.sc1;

  {  // stage x, B and C, 16 bytes per thread and step, rows in order
    const int xr = P / 4, sr = S / 4;
    for (int e = tid; e < L * xr; e += THREADS) {
      const int i = e / xr, j = 4 * (e % xr);
      cp_async16(xs + i * XP + j, xp + i * g.sx1 + j);
    }
    for (int e = tid; e < L * sr; e += THREADS) {
      const int i = e / sr, j = 4 * (e % sr);
      cp_async16(bs + i * BP + j, bp + i * g.sb1 + j);
      cp_async16(cs + i * CP + j, cp + i * g.sc1 + j);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int e = tid; e < L * (SP - S); e += THREADS)
      bs[(e / (SP - S)) * BP + S + e % (SP - S)] = 0.f;
    for (int i = tid; i < L; i += THREADS) dts[i] = dtp[i * g.sdt1];
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {  // ell: each lane sums its run of L/32, then a scan over the lanes
    const float a = g.a[bh];
    const int per = (L + 31) / 32;  // <= 4
    float part[4], run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = lane * per + k;
      if (k < per && i < L) run = __fadd_rn(run, __fmul_rn(a, dts[i]));
      part[k] = run;
    }
    float tot = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, tot, o);
      if (lane >= o) tot = __fadd_rn(u, tot);
    }
    float before = __shfl_up_sync(0xffffffffu, tot, 1);
    if (lane == 0) before = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = lane * per + k;
      if (k < per && i < L) ell[i] = __fadd_rn(before, part[k]);
    }
    __syncwarp();
    const float last = ell[L - 1];
    for (int i = lane; i < L; i += 32) wdt[i] = expf(last - ell[i]) * dts[i];
  }
  __syncthreads();

  {  // c_dec = C ⊙ exp(ell), 16-byte stores
    float* cdp = g.cdec + ((long long)bh * g.t + t0) * S;
    const int sr = S / 4;
    for (int e = tid; e < L * sr; e += THREADS) {
      const int i = e / sr, j = 4 * (e % sr);
      const float f = expf(ell[i]);
      float4 v = *reinterpret_cast<const float4*>(cs + i * CP + j);
      v.x *= f; v.y *= f; v.z *= f; v.w *= f;
      *reinterpret_cast<float4*>(cdp + i * S + j) = v;
    }
    if (tid == 0) g.decay[(long long)bh * g.nc + n] = expf(ell[L - 1]);
  }

  // y_intra: strips warp and L/16 - 1 - warp (rows 16 i .. 16 i + 15)
  const int strips = L / 16;
  for (int pass = 0; pass < 2; ++pass) {
    const int i = pass == 0 ? warp : strips - 1 - warp;
    if (pass == 0 ? i > strips - 1 - warp : i <= warp) continue;
    const int r0 = 16 * i;
    const float ell_r[2] = {ell[r0 + gq], ell[r0 + gq + 8]};
    float o[PT][4] = {};
    // columns s0 .. s0 + 31 of C·Bᵀ at a time (16 where the strip's causal
    // part ends): rows r0 + gq (+8), columns s0 + 8j + 2q (+1)
    for (int s0 = 0; s0 <= r0; s0 += 32) {
      const bool wide = s0 + 16 <= r0;
      float w[4][4];
      c_times_b(w, cs, bs, CP, BP, S, r0, s0, wide ? 4 : 2, gq, q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < 2 || wide) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // the gate, only where s <= t
            const int t = r0 + gq + 8 * (e / 2), s = s0 + 8 * j + 2 * q + e % 2;
            w[j][e] = s <= t ? w[j][e] * expf(ell_r[e / 2] - ell[s]) * dts[s] : 0.f;
          }
          // the accumulator as the A operand: slot q <- column 2q, q + 4 <- 2q + 1
          unsigned ahi[4], alo[4];
          split_a(w[j][0], w[j][2], w[j][1], w[j][3], ahi, alo);
          times_x<PT>(o, ahi, alo, xs + (s0 + 8 * j + 2 * q) * XP + gq, XP, P);
        }
      }
    }
    float* yp = g.y + ((long long)bh * g.t + t0 + r0 + gq) * P + 2 * q;
#pragma unroll
    for (int pn = 0; pn < PT; ++pn) {
      if (8 * pn < P) {
        *reinterpret_cast<float2*>(yp + 8 * pn) = make_float2(o[pn][0], o[pn][1]);
        *reinterpret_cast<float2*>(yp + 8 * P + 8 * pn) = make_float2(o[pn][2], o[pn][3]);
      }
    }
  }

  // states: rows 16 m .. 16 m + 15 of S per warp, k over s in slabs of 8
  for (int i0 = 16 * warp; i0 < SP; i0 += 16 * WARPS) {
    float o[PT][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < L; k0 += 8) {
      const int s = k0 + 2 * q;   // slot q <- row s, q + 4 <- row s + 1
      const float w0 = wdt[s], w1 = wdt[s + 1];
      const float* b0 = bs + s * BP + i0 + gq;
      unsigned ahi[4], alo[4];
      split_a(b0[0] * w0, b0[8] * w0, b0[BP] * w1, b0[BP + 8] * w1, ahi, alo);
      times_x<PT>(o, ahi, alo, xs + s * XP + gq, XP, P);
    }
    float* sp = g.states + (((long long)bh * g.nc + n) * S + i0 + gq) * P + 2 * q;
#pragma unroll
    for (int pn = 0; pn < PT; ++pn) {
      if (8 * pn < P) {
        if (i0 + gq < S)
          *reinterpret_cast<float2*>(sp + 8 * pn) = make_float2(o[pn][0], o[pn][1]);
        if (i0 + gq + 8 < S)
          *reinterpret_cast<float2*>(sp + 8 * P + 8 * pn) = make_float2(o[pn][2], o[pn][3]);
      }
    }
  }
}

}  // namespace mma

SsdArgs args_of(const void* x, const void* dt, const void* a, const void* b, const void* c,
                void* y, void* states, void* cdec, void* decay, const long long* strides,
                int t, int p, int s, int L, int heads_per_group) {
  SsdArgs g;
  g.x = (const float*)x; g.dt = (const float*)dt; g.a = (const float*)a;
  g.b = (const float*)b; g.c = (const float*)c;
  g.y = (float*)y; g.states = (float*)states; g.cdec = (float*)cdec; g.decay = (float*)decay;
  g.sx0 = strides[0]; g.sx1 = strides[1];
  g.sdt0 = strides[2]; g.sdt1 = strides[3];
  g.sb0 = strides[4]; g.sb1 = strides[5];
  g.sc0 = strides[6]; g.sc1 = strides[7];
  g.t = t; g.p = p; g.s = s; g.L = L; g.nc = t / L; g.hpg = heads_per_group;
  return g;
}

bool shape_ok(int bh, int t, int p, int s, int L, int heads_per_group) {
  return bh > 0 && t > 0 && L > 0 && L <= MAX_DIM && p > 0 && p <= MAX_DIM && s > 0 &&
         s <= MAX_DIM && t % L == 0 && t / L <= 65535 && heads_per_group > 0 &&
         bh % heads_per_group == 0;
}

}  // namespace

// strides: 8 element strides, (row, t) of x, dt, b and c in that order;
// y (bh, t, p), states (bh, t / L, s, p), cdec (bh, t, s) and decay
// (bh, t / L) are contiguous f32.  The simt route.
extern "C" int ssd_chunk_launch(const void* x, const void* dt, const void* a, const void* b,
                                const void* c, void* y, void* states, void* cdec, void* decay,
                                const long long* strides, int bh, int t, int p, int s, int L,
                                int heads_per_group, void* stream) {
  if (!shape_ok(bh, t, p, s, L, heads_per_group)) return (int)cudaErrorInvalidValue;
  const SsdArgs g = args_of(x, dt, a, b, c, y, states, cdec, decay, strides, t, p, s, L,
                            heads_per_group);
  const size_t bytes = sizeof(float) * (size_t)smem_floats(L, p, s);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_kernel<<<dim3(bh, g.nc), THREADS, bytes, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// The mma route, with the arguments of ssd_chunk_launch: L a multiple of 16,
// P and S multiples of 8; x, b and c 16-byte aligned, with row and batch
// strides (of dims longer than 1) multiples of 4 floats.
extern "C" int ssd_chunk_mma_launch(const void* x, const void* dt, const void* a, const void* b,
                                    const void* c, void* y, void* states, void* cdec,
                                    void* decay, const long long* strides, int bh, int t, int p,
                                    int s, int L, int heads_per_group, void* stream) {
  if (!shape_ok(bh, t, p, s, L, heads_per_group) || L % 16 != 0 || p % 8 != 0 || s % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int bg = bh / heads_per_group;
  const bool aligned =
      ((unsigned long long)x | (unsigned long long)b | (unsigned long long)c) % 16 == 0 &&
      (bh == 1 || strides[0] % 4 == 0) && strides[1] % 4 == 0 &&
      (bg == 1 || strides[4] % 4 == 0) && strides[5] % 4 == 0 &&
      (bg == 1 || strides[6] % 4 == 0) && strides[7] % 4 == 0;
  if (!aligned) return (int)cudaErrorInvalidValue;
  const SsdArgs g = args_of(x, dt, a, b, c, y, states, cdec, decay, strides, t, p, s, L,
                            heads_per_group);
  const size_t bytes = sizeof(float) * (size_t)mma::smem_floats(L, p, s);
  void (*kernel)(SsdArgs) = p <= 64 ? mma::ssd_mma_kernel<8> : mma::ssd_mma_kernel<16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(bh, g.nc), mma::THREADS, bytes, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
