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
//
// What bounds it: per (bh, chunk) it does 2·L²·S + 2·L²·P + 2·L·S·P
// operations on (L·(P + 2 S) + 2 L) inputs, ~16 operations per byte at
// L = 128, P = S = 64: bound by fp32 operations (IEEE fp32 throughout, no
// TF32; 67 TFLOP/s on the CUDA cores).  One block per (bh, chunk) keeps the
// x, B and C tiles and the L x L weight tile in shared memory (~167 KB at
// the main path's shape, above the 48 KB default, so the launch raises the
// limit); 16 x 16 threads each own an 8 x 8 block of every product, so a
// shared-memory load feeds eight FMAs.  The gate is exponentiated only for
// s <= t (the masked half would overflow).  ell is one thread's sequential
// sum, as torch.cumsum adds on the CPU.
//
// B and C are per group: head row bh reads group row bh / heads_per_group,
// so zamba2's 80 heads per group read one copy instead of 80.  All inputs
// are read through their strides (the last dim contiguous); the outputs are
// contiguous.  T must be a multiple of L (the caller pads with dt = 0).

#include <cuda_runtime.h>
#include <math.h>

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

}  // namespace

// strides: 8 element strides, (row, t) of x, dt, b and c in that order;
// y (bh, t, p), states (bh, t / L, s, p), cdec (bh, t, s) and decay
// (bh, t / L) are contiguous f32
extern "C" int ssd_chunk_launch(const void* x, const void* dt, const void* a, const void* b,
                                const void* c, void* y, void* states, void* cdec, void* decay,
                                const long long* strides, int bh, int t, int p, int s, int L,
                                int heads_per_group, void* stream) {
  if (bh <= 0 || t <= 0 || L <= 0 || L > MAX_DIM || p <= 0 || p > MAX_DIM || s <= 0 ||
      s > MAX_DIM || t % L != 0 || t / L > 65535 || heads_per_group <= 0 ||
      bh % heads_per_group != 0)
    return (int)cudaErrorInvalidValue;
  SsdArgs g;
  g.x = (const float*)x; g.dt = (const float*)dt; g.a = (const float*)a;
  g.b = (const float*)b; g.c = (const float*)c;
  g.y = (float*)y; g.states = (float*)states; g.cdec = (float*)cdec; g.decay = (float*)decay;
  g.sx0 = strides[0]; g.sx1 = strides[1];
  g.sdt0 = strides[2]; g.sdt1 = strides[3];
  g.sb0 = strides[4]; g.sb1 = strides[5];
  g.sc0 = strides[6]; g.sc1 = strides[7];
  g.t = t; g.p = p; g.s = s; g.L = L; g.nc = t / L; g.hpg = heads_per_group;
  const size_t bytes = sizeof(float) * (size_t)smem_floats(L, p, s);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_kernel<<<dim3(bh, g.nc), THREADS, bytes, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
