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
// product does 2·8192³ operations on 0.4-0.8 GB; the 8M x 100 Gram 1.6e11
// on 3.2 GB), so the limit is the arithmetic rate of the route:
//
// - wgmma route (bf16/f16 operands whose views TMA can read: one of the
//   last two dims unit-stride, every other stride a multiple of 16 bytes, a
//   16-byte-aligned base).  The tensor cores, 989 TFLOP/s.  A 128 x 128
//   output tile per block of three warpgroups: one thread of the producer
//   warpgroup issues TMA loads of (A, B) tiles of depth 64 into a ring of 4
//   stages, each with its own full/empty mbarrier pair; two consumer
//   warpgroups each run wgmma.m64n128k16 on 64 of the rows, fp32
//   accumulators in registers, releasing a stage as soon as the products
//   that read it retire.  Each
//   operand is encoded as a rank-4 tensor map over its own (block-k, block
//   row, grid, grid) dims and strides, so a tile that overhangs a ragged
//   block reads zeros (TMA's fill), never the next block.  K-major tiles
//   and MN-major tiles (row-major B, the transpose_a A) are both loaded
//   with the 128-byte swizzle and read through the descriptors' transpose
//   bits.  The epilogue rounds to the output type and stores with masks.
// - SIMT route (every fp32 operand; 16-bit operands TMA cannot read, such
//   as blocks with bk = 70).  IEEE fp32 FMAs on the CUDA cores, 67 TFLOP/s;
//   no TF32.  A 128 x 128 tile per block of 256 threads, each an 8 x 8
//   register micro-tile, K steps of 16 staged by cp.async into a ring of 3
//   stages with one barrier per step.  fp32 operands are copied 16 bytes at
//   a time along whichever of their last two dims is contiguous (with zero
//   fill at the ragged edge) when the strides allow it, else 4 bytes at a
//   time; 16-bit operands are widened to fp32 on the way in.  A shared tile
//   keeps the operand's contiguous dim innermost: an MN-major tile is read
//   as float4 pairs (rows 4·ty..4·ty+3 and 64 further), a K-major tile
//   (rows padded to 20 floats) as float2 runs along K.
//
// Both routes cover the K steps of one block at a time (a step never
// straddles two blocks).  When few output tiles exist (the Gram: one
// 100x100 tile over K = 8.1M) the K steps are split over blockIdx.y into an
// fp32 workspace and summed by a second kernel in a fixed order, so results
// do not change from run to run (no atomics).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// dtype codes shared with kernels/matmul/kernel.py: 0 f32, 1 f16, 2 bf16
__device__ __forceinline__ void store_out(void* C, long long off, float v, int code) {
  if (code == 0)
    ((float*)C)[off] = v;
  else if (code == 1)
    ((__half*)C)[off] = __float2half_rn(v);
  else
    ((__nv_bfloat16*)C)[off] = __float2bfloat16_rn(v);
}

struct Geometry {
  int gi, gj, gk, bn, bk, bm;
  long long sa[4];   // strides of A viewed as (gi, gk, bn, bk), in elements
  long long sb[4];   // strides of B as (gk, gj, bk, bm)
  int splits;
  long long out_elems;   // gi * gj * bn * bm
};

// the output tile (i, j, tile row, tile col) of block x, the tile col fastest
struct Tile {
  int i, j, r0, c0;
};

__device__ __forceinline__ Tile tile_of(const Geometry& g, int bm_tile, int bn_tile) {
  const int tiles_c = (g.bm + bn_tile - 1) / bn_tile;
  const int tiles_r = (g.bn + bm_tile - 1) / bm_tile;
  long long t = blockIdx.x;
  Tile o;
  o.c0 = (int)(t % tiles_c) * bn_tile; t /= tiles_c;
  o.r0 = (int)(t % tiles_r) * bm_tile; t /= tiles_r;
  o.j = (int)(t % g.gj);
  o.i = (int)(t / g.gj);
  return o;
}

// ---------------------------------------------------------------------------
// SIMT route
// ---------------------------------------------------------------------------

namespace simt {
constexpr int BM = 128, BN = 128, BK = 16, STAGES = 3, THREADS = 256;
constexpr int KP = BK + 4;               // row stride of a K-major tile (floats)
constexpr int TILE = BM * KP;            // floats of one operand tile (either layout)
constexpr int STAGE = 2 * TILE;
constexpr size_t SMEM_BYTES = sizeof(float) * STAGES * STAGE;
}  // namespace simt

__device__ __forceinline__ void cp_async(float* dst, const void* src, int bytes, int src_bytes) {
  const uint32_t d = hopper::smem_u32(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One operand's 128 x 16 tile (128 along M or N, 16 along K) into shared
// memory: element (mn, k) of the tile is src[(mn0 + mn)·s_mn + (k0 + k)·s_k],
// zero where mn0 + mn >= n_mn or k0 + k >= n_k.  KM: the tile is stored
// [mn][KP] (K innermost), else [k][128] (MN innermost).  vec (fp32 only):
// the innermost dim has unit stride and every 4-float run is 16-byte
// aligned, so it is copied 16 bytes at a time.
template <typename TI, bool KM>
__device__ __forceinline__ void load_tile(float* dst, const TI* src, long long s_mn,
                                          long long s_k, int mn0, int n_mn, int k0, int n_k,
                                          bool vec, int tid) {
  using namespace simt;
  if constexpr (sizeof(TI) == 4) {
    if (vec) {
#pragma unroll
      for (int l = 0; l < (BM * BK / 4) / THREADS; ++l) {
        const int c = tid + l * THREADS;
        int mn, k, valid;
        if (KM) {
          mn = c >> 2; k = (c & 3) * 4;
          valid = mn0 + mn < n_mn ? min(max(n_k - (k0 + k), 0), 4) : 0;
        } else {
          k = c >> 5; mn = (c & 31) * 4;
          valid = k0 + k < n_k ? min(max(n_mn - (mn0 + mn), 0), 4) : 0;
        }
        const float* p = valid ? (const float*)src + (long long)(mn0 + mn) * s_mn +
                                     (long long)(k0 + k) * s_k
                               : (const float*)src;
        cp_async(dst + (KM ? mn * KP + k : k * BM + mn), p, 16, valid * 4);
      }
      return;
    }
  }
#pragma unroll
  for (int l = 0; l < (BM * BK) / THREADS; ++l) {
    const int e = tid + l * THREADS;
    const int mn = KM ? e >> 4 : e & (BM - 1);
    const int k = KM ? e & (BK - 1) : e >> 7;
    const bool ok = mn0 + mn < n_mn && k0 + k < n_k;
    const TI* p = ok ? src + (long long)(mn0 + mn) * s_mn + (long long)(k0 + k) * s_k : src;
    float* d = dst + (KM ? mn * KP + k : k * BM + mn);
    if constexpr (sizeof(TI) == 4)
      cp_async(d, p, 4, ok ? 4 : 0);
    else
      *d = ok ? to_float(*p) : 0.f;
  }
}

// the 8 rows (or cols) that thread t owns in a 128-wide tile
template <bool KM> __device__ __forceinline__ int owned(int t, int u) {
  return KM ? t + 16 * u : 4 * t + (u & 3) + 64 * (u >> 2);
}

// frag[kk][u] = element (owned(t, u), k0 + kk) of a tile, kk = 0, 1
template <bool KM>
__device__ __forceinline__ void read_frag(float (&f)[2][8], const float* tile, int t, int k0) {
  using namespace simt;
  if (KM) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float2 x = *(const float2*)(tile + owned<true>(t, u) * KP + k0);
      f[0][u] = x.x;
      f[1][u] = x.y;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float4 x = *(const float4*)(tile + (k0 + kk) * BM + 4 * t);
      const float4 y = *(const float4*)(tile + (k0 + kk) * BM + 64 + 4 * t);
      f[kk][0] = x.x; f[kk][1] = x.y; f[kk][2] = x.z; f[kk][3] = x.w;
      f[kk][4] = y.x; f[kk][5] = y.y; f[kk][6] = y.z; f[kk][7] = y.w;
    }
  }
}

// AK: A's tile is K-major (its bk dim has unit stride, or neither has);
// BK_: B's tile is K-major.  a_vec / b_vec: 16-byte copies (fp32 only).
template <typename TI, bool AK, bool BK_>
__global__ void __launch_bounds__(simt::THREADS, 1)
simt_kernel(const TI* __restrict__ A, const TI* __restrict__ B, void* __restrict__ C,
            float* __restrict__ W, Geometry g, int out_code, bool a_vec, bool b_vec) {
  using namespace simt;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const Tile tl = tile_of(g, BM, BN);

  const int spb = (g.bk + BK - 1) / BK;
  const long long total = (long long)g.gk * spb;
  const int split = blockIdx.y;
  const long long s_begin = total * split / g.splits;
  const long long n = total * (split + 1) / g.splits - s_begin;

  const TI* Ai = A + (long long)tl.i * g.sa[0];
  const TI* Bj = B + (long long)tl.j * g.sb[1];
  auto load = [&](int stage, long long s) {
    const int kg = (int)(s / spb);
    const int kb0 = (int)(s - (long long)kg * spb) * BK;
    float* st = smem + stage * STAGE;
    load_tile<TI, AK>(st, Ai + (long long)kg * g.sa[1], g.sa[2], g.sa[3], tl.r0, g.bn, kb0,
                      g.bk, a_vec, tid);
    load_tile<TI, BK_>(st + TILE, Bj + (long long)kg * g.sb[0], g.sb[3], g.sb[2], tl.c0, g.bm,
                       kb0, g.bk, b_vec, tid);
  };

  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n) load(p, s_begin + p);
    cp_async_commit();
  }
  for (long long it = 0; it < n; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // step it has landed; every thread is done with step it - 1
    if (it + STAGES - 1 < n) load((int)((it + STAGES - 1) % STAGES), s_begin + it + STAGES - 1);
    cp_async_commit();
    const float* st = smem + (int)(it % STAGES) * STAGE;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 2) {
      float a[2][8], b[2][8];
      read_frag<AK>(a, st, ty, k0);
      read_frag<BK_>(b, st + TILE, tx, k0);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(a[kk][u], b[kk][v], acc[u][v]);
    }
  }

  const long long base = ((long long)tl.i * g.gj + tl.j) * g.bn * g.bm;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int gr = tl.r0 + owned<AK>(ty, u);
    if (gr >= g.bn) continue;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int gc = tl.c0 + owned<BK_>(tx, v);
      if (gc >= g.bm) continue;
      const long long off = base + (long long)gr * g.bm + gc;
      if (W != nullptr)
        W[(long long)split * g.out_elems + off] = acc[u][v];
      else
        store_out(C, off, acc[u][v], out_code);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma route
// ---------------------------------------------------------------------------

namespace tc {
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4, THREADS = 384;
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int CHUNK = 64 * BK * 2;       // one 64-wide MN chunk of an MN-major tile
constexpr size_t SMEM_BYTES = STAGES * STAGE_BYTES + 1024;   // + alignment slack
}  // namespace tc

// AK / BK_: the operand's tile is K-major (else MN-major, two 64-wide
// chunks).  F16: f16 inputs, else bf16.
template <bool F16, bool AK, bool BK_>
__global__ void __launch_bounds__(tc::THREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
             void* __restrict__ C, float* __restrict__ W, Geometry g, int out_code) {
  using namespace tc;
  using hopper::make_desc;
  extern __shared__ uint8_t raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  uint8_t* base = raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / 128;
  const Tile tl = tile_of(g, BM, BN);

  const int spb = (g.bk + BK - 1) / BK;
  const long long total = (long long)g.gk * spb;
  const int split = blockIdx.y;
  const long long s_begin = total * split / g.splits;
  const int n = (int)(total * (split + 1) / g.splits - s_begin);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {   // producer
    if (tid == 256) {
      hopper::prefetch_map(&ma);
      hopper::prefetch_map(&mb);
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) hopper::mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
        uint8_t* a_s = base + st * STAGE_BYTES;
        uint8_t* b_s = a_s + A_BYTES;
        hopper::mbar_expect_tx(&full[st], STAGE_BYTES);
        const long long s = s_begin + it;
        const int kg = (int)(s / spb), kb0 = (int)(s % spb) * BK;
        if (AK) {
          hopper::tma_load_4d(a_s, &ma, &full[st], kb0, tl.r0, kg, tl.i);
        } else {
          hopper::tma_load_4d(a_s, &ma, &full[st], tl.r0, kb0, kg, tl.i);
          hopper::tma_load_4d(a_s + CHUNK, &ma, &full[st], tl.r0 + 64, kb0, kg, tl.i);
        }
        if (BK_) {
          hopper::tma_load_4d(b_s, &mb, &full[st], kb0, tl.c0, tl.j, kg);
        } else {
          hopper::tma_load_4d(b_s, &mb, &full[st], tl.c0, kb0, tl.j, kg);
          hopper::tma_load_4d(b_s + CHUNK, &mb, &full[st], tl.c0 + 64, kb0, tl.j, kg);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows r0 + 64·wg .. + 63 of the tile
  float acc[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = 0.f;
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES;
    hopper::mbar_wait(&full[st], (it / STAGES) & 1);
    const uint32_t a_s = hopper::smem_u32(base + st * STAGE_BYTES) + wg * CHUNK;
    const uint32_t b_s = hopper::smem_u32(base + st * STAGE_BYTES) + A_BYTES;
    hopper::fence_regs<64>(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // K-major: the next 16 of K are 32 bytes on in each 128-byte row;
      // MN-major: 16 rows (2048 bytes) on, and the MN chunks CHUNK apart
      const uint64_t da = AK ? make_desc(a_s + kk * 32, 0, 1024, hopper::SWIZZLE_128B)
                             : make_desc(a_s + kk * 2048, CHUNK, 1024, hopper::SWIZZLE_128B);
      const uint64_t db = BK_ ? make_desc(b_s + kk * 32, 0, 1024, hopper::SWIZZLE_128B)
                              : make_desc(b_s + kk * 2048, CHUNK, 1024, hopper::SWIZZLE_128B);
      hopper::Wgmma<BN>::template ss<AK ? 0 : 1, BK_ ? 0 : 1, F16>(acc, da, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();   // the products of step it - 1 have retired
    hopper::fence_regs<64>(acc);
    if (it > 0 && tid % 128 == 0) hopper::mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs<64>(acc);

  // accumulator fragment: register 4·jn + 2·h + e holds row
  // 16·warp + lane/4 + 8·h, column 8·jn + 2·(lane % 4) + e of the 64 x 128
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = tl.r0 + wg * 64 + warp * 16 + lane / 4;
  const int col0 = tl.c0 + 2 * (lane % 4);
  const long long base_off = ((long long)tl.i * g.gj + tl.j) * g.bn * g.bm;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + 8 * h;
    if (gr >= g.bn) continue;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gc = col0 + 8 * jn + e;
        if (gc >= g.bm) continue;
        const long long off = base_off + (long long)gr * g.bm + gc;
        const float v = acc[4 * jn + 2 * h + e];
        if (W != nullptr)
          W[(long long)split * g.out_elems + off] = v;
        else
          store_out(C, off, v, out_code);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// split-K reduction and launchers
// ---------------------------------------------------------------------------

// C[e] = sum over p = 0 .. splits-1 of W[p][e], in that order.
__global__ void splitk_reduce_kernel(const float* __restrict__ W, void* __restrict__ C,
                                     long long n, int splits, int out_code) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += W[(long long)p * n + e];
    store_out(C, e, s, out_code);
  }
}

cudaError_t launch_reduce(const float* W, void* C, long long n, int splits, int out_code,
                          cudaStream_t st) {
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 65535 ? want : 65535);
  splitk_reduce_kernel<<<blocks, threads, 0, st>>>(W, C, n, splits, out_code);
  return cudaGetLastError();
}

bool check_geometry(Geometry& g, int gi, int gj, int gk, int bn, int bk, int bm, int splits,
                    const void* w, int tile_m, int tile_n, dim3* grid) {
  if (gi <= 0 || gj <= 0 || gk <= 0 || bn <= 0 || bk <= 0 || bm <= 0 || splits < 1 ||
      splits > 65535 || (splits > 1 && w == nullptr))
    return false;
  g.gi = gi; g.gj = gj; g.gk = gk; g.bn = bn; g.bk = bk; g.bm = bm;
  g.splits = splits;
  g.out_elems = (long long)gi * gj * bn * bm;
  const long long tiles =
      (long long)gi * gj * ((bn + tile_m - 1) / tile_m) * ((bm + tile_n - 1) / tile_n);
  if (tiles > 2147483647LL) return false;
  *grid = dim3((unsigned)tiles, (unsigned)splits);
  return true;
}

template <typename TI, bool AK, bool BK_>
cudaError_t launch_simt(const void* a, const void* b, void* c, void* w, int out_code,
                        const Geometry& g, dim3 grid, bool a_vec, bool b_vec, cudaStream_t st) {
  auto kern = simt_kernel<TI, AK, BK_>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)simt::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kern<<<grid, simt::THREADS, simt::SMEM_BYTES, st>>>((const TI*)a, (const TI*)b, c,
                                                       g.splits > 1 ? (float*)w : nullptr, g,
                                                       out_code, a_vec, b_vec);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t dispatch_simt(const void* a, const void* b, void* c, void* w, int out_code,
                          const Geometry& g, dim3 grid, cudaStream_t st) {
  // a tile is K-major when its bk dim has unit stride, or when neither
  // of its last two dims does
  const bool ak = g.sa[3] == 1 || g.sa[2] != 1;
  const bool bk = g.sb[2] == 1 || g.sb[3] != 1;
  // 16-byte copies: fp32, a 16-byte-aligned base, the tile's inner dim of
  // unit stride and every other stride of a used dim a multiple of 4
  auto vec = [](const void* p, const long long* s, int inner, int outer, int dim0, int dim1) {
    return ((unsigned long long)p % 16 == 0) && s[inner] == 1 && s[outer] % 4 == 0 &&
           (dim0 == 1 || s[0] % 4 == 0) && (dim1 == 1 || s[1] % 4 == 0);
  };
  const bool f32 = sizeof(TI) == 4;
  const bool a_vec = f32 && vec(a, g.sa, ak ? 3 : 2, ak ? 2 : 3, g.gi, g.gk);
  const bool b_vec = f32 && vec(b, g.sb, bk ? 2 : 3, bk ? 3 : 2, g.gk, g.gj);
  if (ak && bk) return launch_simt<TI, true, true>(a, b, c, w, out_code, g, grid, a_vec, b_vec, st);
  if (ak) return launch_simt<TI, true, false>(a, b, c, w, out_code, g, grid, a_vec, b_vec, st);
  if (bk) return launch_simt<TI, false, true>(a, b, c, w, out_code, g, grid, a_vec, b_vec, st);
  return launch_simt<TI, false, false>(a, b, c, w, out_code, g, grid, a_vec, b_vec, st);
}

template <bool F16, bool AK, bool BK_>
cudaError_t launch_wgmma(const CUtensorMap& ma, const CUtensorMap& mb, void* c, void* w,
                         int out_code, const Geometry& g, dim3 grid, cudaStream_t st) {
  auto kern = wgmma_kernel<F16, AK, BK_>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)tc::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kern<<<grid, tc::THREADS, tc::SMEM_BYTES, st>>>(ma, mb, c, g.splits > 1 ? (float*)w : nullptr,
                                                   g, out_code);
  return cudaGetLastError();
}

template <bool F16>
cudaError_t dispatch_wgmma(const CUtensorMap& ma, bool ak, const CUtensorMap& mb, bool bk,
                           void* c, void* w, int out_code, const Geometry& g, dim3 grid,
                           cudaStream_t st) {
  if (ak && bk) return launch_wgmma<F16, true, true>(ma, mb, c, w, out_code, g, grid, st);
  if (ak) return launch_wgmma<F16, true, false>(ma, mb, c, w, out_code, g, grid, st);
  if (bk) return launch_wgmma<F16, false, true>(ma, mb, c, w, out_code, g, grid, st);
  return launch_wgmma<F16, false, false>(ma, mb, c, w, out_code, g, grid, st);
}

cudaError_t finish(const Geometry& g, void* c, void* w, int out_code, cudaError_t err,
                   cudaStream_t st) {
  if (err != cudaSuccess || g.splits == 1) return err;
  return launch_reduce((const float*)w, c, g.out_elems, g.splits, out_code, st);
}

}  // namespace

// The SIMT route: any strides, f32/f16/bf16 inputs (in_code), any output
// type (out_code).
extern "C" int stacked_matmul_launch(const void* a, const void* b, void* c, void* w,
                                     int in_code, int out_code, int gi, int gj, int gk,
                                     int bn, int bk, int bm, long long sa0, long long sa1,
                                     long long sa2, long long sa3, long long sb0,
                                     long long sb1, long long sb2, long long sb3,
                                     int splits, void* stream) {
  Geometry g;
  dim3 grid;
  if (!check_geometry(g, gi, gj, gk, bn, bk, bm, splits, w, simt::BM, simt::BN, &grid) ||
      out_code < 0 || out_code > 2)
    return (int)cudaErrorInvalidValue;
  g.sa[0] = sa0; g.sa[1] = sa1; g.sa[2] = sa2; g.sa[3] = sa3;
  g.sb[0] = sb0; g.sb[1] = sb1; g.sb[2] = sb2; g.sb[3] = sb3;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (in_code) {
    case 0: err = dispatch_simt<float>(a, b, c, w, out_code, g, grid, st); break;
    case 1: err = dispatch_simt<__half>(a, b, c, w, out_code, g, grid, st); break;
    case 2: err = dispatch_simt<__nv_bfloat16>(a, b, c, w, out_code, g, grid, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)finish(g, c, w, out_code, err, st);
}

// The wgmma route: f16 (in_code 1) or bf16 (2) inputs.  a_map / b_map are
// the planner's rank-4 TMA descriptions (kernels/matmul/kernel.py::plan):
// dims innermost first, the byte strides of dims 1..3, the box (inner,
// outer); *_kmajor says which of the operand's dims is innermost.
extern "C" int stacked_matmul_wgmma_launch(const void* a, const void* b, void* c, void* w,
                                           int in_code, int out_code, int gi, int gj, int gk,
                                           int bn, int bk, int bm, const long long* a_map,
                                           int a_kmajor, const long long* b_map,
                                           int b_kmajor, int splits, void* stream) {
  Geometry g;
  dim3 grid;
  if (!check_geometry(g, gi, gj, gk, bn, bk, bm, splits, w, tc::BM, tc::BN, &grid) ||
      out_code < 0 || out_code > 2 || (in_code != 1 && in_code != 2))
    return (int)cudaErrorInvalidValue;
  // the boxes the kernel's shared-memory layout expects
  const long long* maps[2] = {a_map, b_map};
  const int kmaj[2] = {a_kmajor, b_kmajor};
  for (int o = 0; o < 2; ++o)
    if (maps[o][7] != (kmaj[o] ? tc::BK : 64) || maps[o][8] != (kmaj[o] ? 128 : tc::BK))
      return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const bool f16 = in_code == 1;
  cudaError_t err = hopper::encode_4d(&ma, a, f16, a_map, a_map + 4, (int)a_map[7],
                                      (int)a_map[8], CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  err = hopper::encode_4d(&mb, b, f16, b_map, b_map + 4, (int)b_map[7], (int)b_map[8],
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = f16 ? dispatch_wgmma<true>(ma, a_kmajor, mb, b_kmajor, c, w, out_code, g, grid, st)
            : dispatch_wgmma<false>(ma, a_kmajor, mb, b_kmajor, c, w, out_code, g, grid, st);
  return (int)finish(g, c, w, out_code, err, st);
}
