// Blocked GEMM on stacked ds-array block tensors, for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/matmul/kernel.py:
// stacked_matmul (body _stacked_matmul_kernel) and its 2-D form
// matmul_padded (body _matmul_kernel), which is the gi = gj = gk = 1 case.
//
// Computes C[i, j] = sum over (kg, kb) of A[i, kg, :, kb] * B[kg, j, kb, :]
// for A viewed as (gi, gk, bn, bk), B as (gk, gj, bk, bm), C as the
// contiguous (gi, gj, bn, bm) tensor: the whole grid-k x block-k reduction
// goes into one fp32 accumulator per C element.  A and B are read through
// the strides the caller passes, so Aᵀ (transpose_a: A stored as
// (gk, gi, bk, bn)) and permuted views are read in place, with no copy.
//
// What bounds it: the main path's products are compute-bound (the 8192²
// product does 2·8192³ operations on 0.8 GB; the 8M x 100 Gram does
// 1.6e11 operations on 3.2 GB, a ratio of ~50 flop/byte), so the limit is
// the fp32 FMA rate of the CUDA cores.  This first version does not use
// tensor cores (wgmma) or TMA; it is a 128x128 output tile per block of 256
// threads, each thread an 8x8 register micro-tile fed from shared memory in
// steps of BK = 8, which gives 64 FMAs per 16 shared-memory loads.  Edge
// tiles are masked in the loads and the store, so any (bn, bk, bm) works.
//
// When few output tiles exist (the Gram: one 100x100 tile over K = 8.1M),
// the K steps are split over blockIdx.y into an fp32 workspace and summed
// by a second kernel in a fixed order, so results do not change from run
// to run (no atomics).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;   // output tile rows
constexpr int BN = 128;   // output tile cols
constexpr int BK = 8;     // K step
constexpr int THREADS = 256;
constexpr int TM = 8;     // rows per thread: ty + 16 * u
constexpr int TN = 8;     // cols per thread: tx + 16 * v

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Geometry {
  int gi, gj, gk, bn, bk, bm;
  long long sa[4];   // strides of A viewed as (gi, gk, bn, bk)
  long long sb[4];   // strides of B as (gk, gj, bk, bm)
  int splits;
  long long out_elems;   // gi * gj * bn * bm
};

template <typename TI, typename TO, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
stacked_matmul_kernel(const TI* __restrict__ A, const TI* __restrict__ B,
                      TO* __restrict__ C, float* __restrict__ W, Geometry g) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // this block's output tile: (i, j, tile row, tile col)
  const int tiles_c = (g.bm + BN - 1) / BN;
  const int tiles_r = (g.bn + BM - 1) / BM;
  long long t = blockIdx.x;
  const int tc = (int)(t % tiles_c); t /= tiles_c;
  const int tr = (int)(t % tiles_r); t /= tiles_r;
  const int j = (int)(t % g.gj);
  const int i = (int)(t / g.gj);
  const int r0 = tr * BM, c0 = tc * BN;

  // K steps of BK that never straddle a block: step s covers block kg,
  // in-block offsets [kb0, kb0 + BK); this split owns [s_begin, s_end)
  const int spb = (g.bk + BK - 1) / BK;
  const long long total = (long long)g.gk * spb;
  const int split = blockIdx.y;
  const long long s_begin = total * split / g.splits;
  const long long s_end = total * (split + 1) / g.splits;

  // which dim the loads walk fastest: the one with unit stride
  const bool a_k_fast = g.sa[3] == 1;
  const bool b_k_fast = g.sb[2] == 1 && g.sb[3] != 1;

  float acc[TM][TN];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[u][v] = 0.f;

  const TI* Ai = A + (long long)i * g.sa[0];
  const TI* Bj = B + (long long)j * g.sb[1];

  for (long long s = s_begin; s < s_end; ++s) {
    const int kg = (int)(s / spb);
    const int kb0 = (int)(s - (long long)kg * spb) * BK;
    const TI* Ak = Ai + (long long)kg * g.sa[1];
    const TI* Bk = Bj + (long long)kg * g.sb[0];
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = a_k_fast ? e / BK : e % BM;
      const int kk = a_k_fast ? e % BK : e / BM;
      const int gr = r0 + r, gkk = kb0 + kk;
      float v = 0.f;
      if (gr < g.bn && gkk < g.bk)
        v = to_float(Ak[(long long)gr * g.sa[2] + (long long)gkk * g.sa[3]]);
      As[kk][r] = v;
    }
#pragma unroll
    for (int l = 0; l < (BN * BK) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int c = b_k_fast ? e / BK : e % BN;
      const int kk = b_k_fast ? e % BK : e / BN;
      const int gc = c0 + c, gkk = kb0 + kk;
      float v = 0.f;
      if (gc < g.bm && gkk < g.bk)
        v = to_float(Bk[(long long)gkk * g.sb[2] + (long long)gc * g.sb[3]]);
      Bs[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int u = 0; u < TM; ++u) av[u] = As[kk][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < TN; ++v) bv[v] = Bs[kk][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    __syncthreads();
  }

  const long long base = ((long long)i * g.gj + j) * g.bn * g.bm;
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int gr = r0 + ty + 16 * u;
    if (gr >= g.bn) continue;
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      const int gc = c0 + tx + 16 * v;
      if (gc >= g.bm) continue;
      const long long off = base + (long long)gr * g.bm + gc;
      if (SPLIT)
        W[(long long)split * g.out_elems + off] = acc[u][v];
      else
        C[off] = from_float<TO>(acc[u][v]);
    }
  }
}

// C[e] = sum over p = 0 .. splits-1 of W[p][e], in that order.
template <typename TO>
__global__ void splitk_reduce_kernel(const float* __restrict__ W, TO* __restrict__ C,
                                     long long n, int splits) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += W[(long long)p * n + e];
    C[e] = from_float<TO>(s);
  }
}

template <typename TO>
cudaError_t launch_reduce(const float* W, void* C, long long n, int splits, cudaStream_t st) {
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 65535 ? want : 65535);
  splitk_reduce_kernel<TO><<<blocks, threads, 0, st>>>(W, (TO*)C, n, splits);
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t launch_direct(const void* a, const void* b, void* c, const Geometry& g,
                          dim3 grid, cudaStream_t st) {
  stacked_matmul_kernel<TI, TO, false><<<grid, THREADS, 0, st>>>(
      (const TI*)a, (const TI*)b, (TO*)c, nullptr, g);
  return cudaGetLastError();
}

// dtype codes shared with kernels/matmul/kernel.py: 0 f32, 1 f16, 2 bf16
template <typename TI>
cudaError_t launch_typed(const void* a, const void* b, void* c, void* w, int out_code,
                         const Geometry& g, dim3 grid, cudaStream_t st) {
  if (g.splits > 1) {
    stacked_matmul_kernel<TI, float, true><<<grid, THREADS, 0, st>>>(
        (const TI*)a, (const TI*)b, nullptr, (float*)w, g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    switch (out_code) {
      case 0: return launch_reduce<float>((const float*)w, c, g.out_elems, g.splits, st);
      case 1: return launch_reduce<__half>((const float*)w, c, g.out_elems, g.splits, st);
      case 2: return launch_reduce<__nv_bfloat16>((const float*)w, c, g.out_elems, g.splits, st);
    }
    return cudaErrorInvalidValue;
  }
  switch (out_code) {
    case 0: return launch_direct<TI, float>(a, b, c, g, grid, st);
    case 1: return launch_direct<TI, __half>(a, b, c, g, grid, st);
    case 2: return launch_direct<TI, __nv_bfloat16>(a, b, c, g, grid, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int stacked_matmul_launch(const void* a, const void* b, void* c, void* w,
                                     int in_code, int out_code, int gi, int gj, int gk,
                                     int bn, int bk, int bm, long long sa0, long long sa1,
                                     long long sa2, long long sa3, long long sb0,
                                     long long sb1, long long sb2, long long sb3,
                                     int splits, void* stream) {
  if (gi <= 0 || gj <= 0 || gk <= 0 || bn <= 0 || bk <= 0 || bm <= 0 || splits < 1 ||
      splits > 65535 || (splits > 1 && w == nullptr))
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.gi = gi; g.gj = gj; g.gk = gk; g.bn = bn; g.bk = bk; g.bm = bm;
  g.sa[0] = sa0; g.sa[1] = sa1; g.sa[2] = sa2; g.sa[3] = sa3;
  g.sb[0] = sb0; g.sb[1] = sb1; g.sb[2] = sb2; g.sb[3] = sb3;
  g.splits = splits;
  g.out_elems = (long long)gi * gj * bn * bm;
  const long long tiles = (long long)gi * gj * ((bn + BM - 1) / BM) * ((bm + BN - 1) / BN);
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)splits);
  cudaStream_t st = (cudaStream_t)stream;
  switch (in_code) {
    case 0: return (int)launch_typed<float>(a, b, c, w, out_code, g, grid, st);
    case 1: return (int)launch_typed<__half>(a, b, c, w, out_code, g, grid, st);
    case 2: return (int)launch_typed<__nv_bfloat16>(a, b, c, w, out_code, g, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}
