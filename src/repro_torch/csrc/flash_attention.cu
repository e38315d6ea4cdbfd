// Fused attention (FlashAttention-style online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_padded (body _attn_kernel): o = softmax(mask(cap(q·kᵀ ·
// sm_scale))) · v per (batch, q head), with GQA (q head h reads kv head
// h / (Hq / Hkv)), keys hidden at positions >= kv_len, the causal mask with
// q_offset (query i sits at position i + q_offset), a sliding window
// (q_pos - k_pos < window), tanh soft-capping, fp32 m / l / acc, P rounded to
// V's dtype before P·V, and rows that see no key returning 0.
//
// What bounds it: at the main path's shape (B = 2, H = 32, T = 4096, D = 80,
// causal, bf16) one call does 4·B·H·T²·D / 2 = 1.7e11 operations and moves
// 8 MB per tensor, so it is bound by operations.  Three kernels, chosen
// before the launch by kernels/flash_attention/kernel.py::route:
//
// - attn_wgmma_kernel (bf16/f16, D a multiple of 16 up to 256, q/k/v views
//   that TMA can read): the tensor cores, 989 TFLOP/s.  A block holds
//   consumer warpgroups of 64 query rows each (3 up to D = 80, 2 up to
//   D = 128, else 1: as many as the registers hold) and one producer warp
//   that loads the Q tile once and keeps TMA loads of 64-key
//   K/V tiles in flight in a ring of 2-4 stages (full/empty mbarriers per
//   stage).  A consumer runs S = Q·Kᵀ as SS wgmmas (m64n64k16, D/16 of
//   them), each tile's issued with the previous tile's P·V; the online
//   softmax on the accumulator
//   fragment (a row's max reduced across the 4 lanes that hold it, its sum
//   kept per lane and reduced once at the end); P rounded to V's dtype and
//   fed from registers as the A operand of RS wgmmas for O += P·V
//   (m64nDk16).  Only the tiles that the diagonal, the window or kv_len cut
//   are masked.  D is loaded as 16-wide boxes with the 32-byte swizzle
//   (K-major for Q and K, MN-major for V), not 64-wide ones: D = 80 is then
//   exactly five boxes, where 64-wide boxes would pad it to 128 and waste
//   37 % of P·V.  Kernels exist for D/16 in {2, 3, 4, 5, 6, 8, 10, 12, 16};
//   another D runs on the next one, its extra chunks zeroed once.
// - attn_tile_kernel (fp32, other D, views TMA cannot read): fp32 FMAs on
//   the CUDA cores (67 TFLOP/s).  Everything of a (b, h, 64-query) tile
//   stays on chip: the Q tile, one 64-key K/V tile at a time and the P tile
//   in shared memory (as fp32), the 64 x D output accumulator, the running
//   max and sum in registers; 16 x 16 threads each own a 4 x 4 block of
//   scores and a 4 x D/16 block of the output.
// - attn_rows_kernel (decode, Tq <= 8): one block per query row, one key
//   per thread, so no dead query rows are computed.
//
// The TPU's sequential KV grid axis becomes the loop over K/V tiles inside
// the block, which skips the tiles that the causal, window or kv_len masks
// hide from every row of the tile.
//
// Layouts: q, k, v and o are read and written through their (b, h, t)
// strides, the last dim contiguous, so permuted (B, T, H, D) views need no
// copy.  D is taken as given, up to 256 (the tile kernel is instantiated for
// D <= 64, 80, 128, 256 and masks the rest).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;   // tile kernel: 16 x 16
constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per K/V tile
constexpr int PS = BK + 1;     // row stride of the P tile (odd: no bank conflicts)
constexpr int ROW_THREADS = 128;  // rows kernel: one key per thread
constexpr int LOADS = 4;       // K and V loads a thread keeps in flight per tile
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq[3], sk[3], sv[3], so[3];  // strides of (b, h, t), in elements
  int hq, hkv, tq, tk, d, causal, window, q_offset, kv_len;
  float sm_scale, softcap;
};

template <typename T> __device__ inline float to_f(T v);
template <> __device__ inline float to_f<float>(float v) { return v; }
template <> __device__ inline float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ inline float to_f<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ inline T from_f(float v);
template <> __device__ inline float from_f<float>(float v) { return v; }
template <> __device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ inline __half from_f<__half>(float v) { return __float2half(v); }

// p rounded to the value type, as the TPU kernel casts P before P·V
template <typename T> __device__ inline float round_to(float v) { return to_f<T>(from_f<T>(v)); }

__device__ inline float score(float dot, const AttnArgs& a) {
  float s = dot * a.sm_scale;
  if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
  return s;
}

__device__ inline bool visible(int qpos, int kpos, const AttnArgs& a) {
  bool ok = kpos < a.kv_len;
  if (a.causal) ok = ok && qpos >= kpos;
  if (a.window > 0) ok = ok && (qpos - kpos) < a.window;
  return ok;
}

// [kbeg, kend): the keys that some query position in [qlo, qhi] can see
__device__ inline void key_range(int qlo, int qhi, const AttnArgs& a, int* kbeg, int* kend) {
  int e = a.kv_len;
  if (a.causal && qhi + 1 < e) e = qhi + 1;
  int b = 0;
  if (a.window > 0 && qlo - a.window + 1 > 0) b = qlo - a.window + 1;
  *kbeg = b;
  *kend = e;
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS) attn_tile_kernel(AttnArgs a) {
  constexpr int DP = 16 * NC;   // D rounded up to the thread layout
  constexpr int DQ = DP + 1;    // odd row stride of Q and K
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][DQ]
  float* ks = qs + BQ * DQ;     // [BK][DQ]
  float* vs = ks + BK * DQ;     // [BK][DP]
  float* ps = vs + BK * DP;     // [BQ][PS]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest (causal) tiles first
  const int h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int q0 = qt * BQ, d = a.d;
  const T* qp = (const T*)a.q + bb * a.sq[0] + h * a.sq[1];
  const T* kp = (const T*)a.k + bb * a.sk[0] + hk * a.sk[1];
  const T* vp = (const T*)a.v + bb * a.sv[0] + hk * a.sv[1];
  T* op = (T*)a.o + bb * a.so[0] + h * a.so[1];

  for (int e = tid; e < BQ * DP; e += THREADS) {
    const int i = e / DP, c = e % DP;
    qs[i * DQ + c] = (q0 + i < a.tq && c < d) ? to_f(qp[(q0 + i) * a.sq[2] + c]) : 0.f;
  }
  const int qlast = (q0 + BQ < a.tq ? q0 + BQ : a.tq) - 1;
  int kbeg, kend;
  key_range(q0 + a.q_offset, qlast + a.q_offset, a, &kbeg, &kend);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = kbeg / BK * BK; k0 < kend; k0 += BK) {
    __syncthreads();   // the previous K/V/P tiles are read (and Q is staged)
    // each thread issues LOADS K and V loads before it stores any
    for (int e0 = tid; e0 < BK * DP; e0 += LOADS * THREADS) {
      float kv[LOADS], vv[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int e = e0 + u * THREADS, j = e / DP, c = e % DP;
        const bool ok = e < BK * DP && k0 + j < a.tk && c < d;
        kv[u] = ok ? to_f(kp[(k0 + j) * a.sk[2] + c]) : 0.f;
        vv[u] = ok ? to_f(vp[(k0 + j) * a.sv[2] + c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int e = e0 + u * THREADS, j = e / DP, c = e % DP;
        if (e < BK * DP) {
          ks[j * DQ + c] = kv[u];
          vs[j * DP + c] = vv[u];
        }
      }
    }
    __syncthreads();

    // scores: rows ty + 16 r, keys tx + 16 c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int e = 0; e < d; ++e) {
      float qa[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = qs[(ty + 16 * r) * DQ + e];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = ks[(tx + 16 * c) * DQ + e];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
    }

    // online softmax: a row's 64 scores live in the 16 lanes of one half-warp
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty + 16 * r + a.q_offset;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ok[c] = visible(qpos, k0 + tx + 16 * c, a);
        s[r][c] = ok[c] ? score(s[r][c], a) : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        rs += p;
        ps[(ty + 16 * r) * PS + tx + 16 * c] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(FULL, rs, off);
      l[r] = alpha * l[r] + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    // acc += P · V: rows ty + 16 r, features tx + 16 c
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = ps[(ty + 16 * r) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[j * DP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= a.tq) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) op[row * a.so[2] + col] = from_f<T>(acc[r][c] / safe);
    }
  }
}

// block-wide max or sum of one value per thread, in a fixed order
template <bool MAX>
__device__ inline float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(FULL, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  __syncthreads();   // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < ROW_THREADS / 32; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// one block per (query row, head, batch): thread j scores key k0 + j, then
// thread c accumulates output features c and c + ROW_THREADS
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS) attn_rows_kernel(AttnArgs a) {
  __shared__ float qrow[256];
  __shared__ float pbuf[ROW_THREADS];
  __shared__ float red[ROW_THREADS / 32];
  const int tid = threadIdx.x, i = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / (a.hq / a.hkv), d = a.d;
  const T* qp = (const T*)a.q + bb * a.sq[0] + h * a.sq[1] + i * a.sq[2];
  const T* kp = (const T*)a.k + bb * a.sk[0] + hk * a.sk[1];
  const T* vp = (const T*)a.v + bb * a.sv[0] + hk * a.sv[1];
  T* op = (T*)a.o + bb * a.so[0] + h * a.so[1] + i * a.so[2];
  for (int c = tid; c < d; c += ROW_THREADS) qrow[c] = to_f(qp[c]);
  const int qpos = i + a.q_offset;
  int kbeg, kend;
  key_range(qpos, qpos, a, &kbeg, &kend);

  float m = NEG_INF, l = 0.f, acc0 = 0.f, acc1 = 0.f;
  for (int k0 = kbeg / ROW_THREADS * ROW_THREADS; k0 < kend; k0 += ROW_THREADS) {
    __syncthreads();   // qrow is staged; the previous P tile is read
    const int j = k0 + tid;
    const bool ok = j < a.tk && visible(qpos, j, a);
    float s = NEG_INF;
    if (ok) {
      const T* kr = kp + j * a.sk[2];
      float dot = 0.f;
      for (int c = 0; c < d; ++c) dot = fmaf(qrow[c], to_f(kr[c]), dot);
      s = score(dot, a);
    }
    const float m_new = fmaxf(m, block_reduce<true>(s, red));
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(s - m_new) : 0.f;
    pbuf[tid] = round_to<T>(p);
    l = alpha * l + block_reduce<false>(p, red);
    m = m_new;
    acc0 *= alpha;
    acc1 *= alpha;
    const int nj = a.tk - k0 < ROW_THREADS ? a.tk - k0 : ROW_THREADS;
    for (int jj = 0; jj < nj; ++jj) {   // pbuf is visible: block_reduce synced
      const float pj = pbuf[jj];
      const T* vr = vp + (k0 + jj) * a.sv[2];
      if (tid < d) acc0 = fmaf(pj, to_f(vr[tid]), acc0);
      if (tid + ROW_THREADS < d) acc1 = fmaf(pj, to_f(vr[tid + ROW_THREADS]), acc1);
    }
  }
  const float safe = l > 0.f ? l : 1.f;
  if (tid < d) op[tid] = from_f<T>(acc0 / safe);
  if (tid + ROW_THREADS < d) op[tid + ROW_THREADS] = from_f<T>(acc1 / safe);
}

// ---------------------------------------------------------------------------
// tensor cores: bf16/f16, D a multiple of 16
// ---------------------------------------------------------------------------

namespace fa {
constexpr int BKV = 64;          // keys per K/V tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr int KV_CHUNK = BKV * 32;   // bytes of one 16-wide chunk of a K or V tile
// consumer warpgroups of 64 query rows each, as many as the registers a
// thread gets hold the O accumulator.  Registers are shared per quarter of
// the SM, one warp of each warpgroup in each: 3 warpgroups and the
// producer warp put 4 warps in one quarter and leave 128 registers a
// thread, 2 leave 168, 1 leaves 255
template <int NC> __host__ __device__ constexpr int consumers() {
  return NC <= 5 ? 3 : NC <= 8 ? 2 : 1;
}
template <int NC> __host__ __device__ constexpr int threads() { return 128 * consumers<NC>() + 32; }
template <int NC> __host__ __device__ constexpr int rows() { return 64 * consumers<NC>(); }
// K/V stages: as many as shared memory holds, up to 4 (<= 225 KB)
template <int NC> __host__ __device__ constexpr int stages() {
  return NC <= 8 ? 4 : NC <= 12 ? 3 : 2;
}
template <int NC> __host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)NC * rows<NC>() * 32 + (size_t)stages<NC>() * 2 * NC * KV_CHUNK + 1024;
}
}  // namespace fa

__device__ __forceinline__ uint32_t pack2(float lo, float hi, bool f16) {
  uint32_t r;
  if (f16) {
    __half2 h = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&h);
  }
  return r;
}

// NC = D_pad / 16 chunks; the tensor maps are rank 4 over (d, t, h, b) with
// boxes of 16 x 64·CW (Q) and 16 x 64 (K, V), 32-byte swizzle.
template <typename T, int NC>
__global__ void __launch_bounds__(fa::threads<NC>(), 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, AttnArgs a) {
  using hopper::make_desc;
  constexpr bool F16 = std::is_same<T, __half>::value;
  constexpr int ST = fa::stages<NC>(), CW = fa::consumers<NC>();
  constexpr int BQ = fa::rows<NC>(), THREADS = fa::threads<NC>();
  constexpr int DP = 16 * NC;
  constexpr int Q_CHUNK = BQ * 32;   // bytes of one 16-wide chunk of the Q tile
  constexpr int Q_BYTES = NC * Q_CHUNK, KV_BYTES = NC * fa::KV_CHUNK;
  extern __shared__ uint8_t raw[];
  __shared__ __align__(8) uint64_t q_full, full[ST], empty[ST];
  uint8_t* qs = raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
  uint8_t* kvs = qs + Q_BYTES;   // stage s: K at kvs + 2·s·KV_BYTES, V KV_BYTES on

  const int tid = threadIdx.x, wg = tid / 128;
  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest (causal) tiles first
  const int h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int q0 = qt * BQ;
  const int nc = a.d / 16;   // chunks that hold D; chunks nc..NC-1 stay zero

  // the K/V tiles some row of the block sees
  const int qlast = min(q0 + BQ, a.tq) - 1;
  int kbeg, kend;
  key_range(q0 + a.q_offset, qlast + a.q_offset, a, &kbeg, &kend);
  const int k_first = kbeg / fa::BKV * fa::BKV;
  const int nt = kend > k_first ? (kend - k_first + fa::BKV - 1) / fa::BKV : 0;

  if (nc < NC) {   // zero the padding chunks of Q and of every K/V stage
    for (int e = tid; e < (NC - nc) * Q_CHUNK / 16; e += THREADS)
      reinterpret_cast<uint4*>(qs + nc * Q_CHUNK)[e] = make_uint4(0, 0, 0, 0);
    for (int s = 0; s < 2 * ST; ++s)
      for (int e = tid; e < (NC - nc) * fa::KV_CHUNK / 16; e += THREADS)
        reinterpret_cast<uint4*>(kvs + s * KV_BYTES + nc * fa::KV_CHUNK)[e] =
            make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (tid == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CW);   // one arrival per consumer warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CW) {   // the producer warp
    if (tid == 128 * CW) {
      hopper::prefetch_map(&mq);
      hopper::prefetch_map(&mk);
      hopper::prefetch_map(&mv);
      hopper::mbar_expect_tx(&q_full, nc * Q_CHUNK);
      for (int c = 0; c < nc; ++c)
        hopper::tma_load_4d(qs + c * Q_CHUNK, &mq, &q_full, 16 * c, q0, h, bb);
      for (int it = 0; it < nt; ++it) {
        const int st = it % ST;
        if (it >= ST) hopper::mbar_wait(&empty[st], ((it / ST) - 1) & 1);
        uint8_t* ks = kvs + 2 * st * KV_BYTES;
        hopper::mbar_expect_tx(&full[st], 2 * nc * fa::KV_CHUNK);
        const int k0 = k_first + it * fa::BKV;
        for (int c = 0; c < nc; ++c) {
          hopper::tma_load_4d(ks + c * fa::KV_CHUNK, &mk, &full[st], 16 * c, k0, hk, bb);
          hopper::tma_load_4d(ks + KV_BYTES + c * fa::KV_CHUNK, &mv, &full[st], 16 * c, k0, hk, bb);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64·wg .. + 63
  const int warp = (tid % 128) / 32, lane = tid % 32, quad = lane % 4;
  const int qw0 = q0 + 64 * wg;
  const int row = qw0 + warp * 16 + lane / 4;   // and row + 8
  int kb_w = 0, ke_w = 0;                       // the keys these rows see
  if (qw0 < a.tq)
    key_range(qw0 + a.q_offset, min(qw0 + 63, a.tq - 1) + a.q_offset, a, &kb_w, &ke_w);
  const int qmin = qw0 + a.q_offset, qmax = qw0 + 63 + a.q_offset;

  // o is not zeroed: the first P·V overwrites it (scale_d = 0)
  float o[DP / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint32_t q_addr = hopper::smem_u32(qs) + wg * 64 * 32;
  hopper::mbar_wait(&q_full, 0);

  // the tiles these rows see are [t_lo, t_hi); the others are waited for
  // and released at once, so both warpgroups pass every stage in step
  int t_lo = 0, t_hi = 0;
  if (ke_w > kb_w) {
    t_lo = (kb_w - k_first) / fa::BKV;
    t_hi = min(nt, (ke_w - k_first + fa::BKV - 1) / fa::BKV);
  }
  auto wait_tile = [&](int it) { hopper::mbar_wait(&full[it % ST], (it / ST) & 1); };
  auto release = [&](int it) {
    if (tid % 128 == 0) hopper::mbar_arrive(&empty[it % ST]);
  };
  auto k_addr = [&](int it) { return hopper::smem_u32(kvs + 2 * (it % ST) * KV_BYTES); };
  // S = Q·Kᵀ of tile it into s (overwritten): register 4·jn + 2·hh + e holds
  // row `row + 8·hh`, key k0 + 8·jn + 2·quad + e
  auto issue_s = [&](float (&s)[fa::BKV / 2], int it) {
    hopper::fence_regs<fa::BKV / 2>(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
      hopper::Wgmma<fa::BKV>::template ss<0, 0, F16>(
          s, make_desc(q_addr + c * Q_CHUNK, 0, 256, hopper::SWIZZLE_32B),
          make_desc(k_addr(it) + c * fa::KV_CHUNK, 0, 256, hopper::SWIZZLE_32B), c > 0);
    hopper::wgmma_commit();
  };
  // one tile: S(it) has been issued; it retires with P·V of tile it - 1,
  // which frees that tile's stage; the softmax of tile it; then P·V of tile
  // it and Q·Kᵀ of tile it + 1 (into s) go to the tensor cores together
  auto step = [&](float (&s)[fa::BKV / 2], int it) {
    hopper::wgmma_wait<0>();
    hopper::fence_regs<fa::BKV / 2>(s);
    hopper::fence_regs<DP / 2>(o);
    if (it > t_lo) release(it - 1);
    const int k0 = k_first + it * fa::BKV;
    // masks only where the diagonal, the window or kv_len cut the tile
    const bool cut = k0 + fa::BKV > a.kv_len || (a.causal && k0 + fa::BKV - 1 > qmin) ||
                     (a.window > 0 && qmax - k0 >= a.window);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qpos = row + 8 * hh + a.q_offset;
      // four partial maxima and sums: short dependency chains
      float mx4[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF}, rs4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int jn = 0; jn < fa::BKV / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * jn + 2 * hh + e;
          float v = score(s[r], a) * fa::LOG2E;
          if (cut && !visible(qpos, k0 + 8 * jn + 2 * quad + e, a)) v = NEG_INF;
          s[r] = v;
          mx4[(2 * jn + e) % 4] = fmaxf(mx4[(2 * jn + e) % 4], v);
        }
      float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = exp2f(m[hh] - m_new);
#pragma unroll
      for (int jn = 0; jn < fa::BKV / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * jn + 2 * hh + e;
          const float p = s[r] > 0.5f * NEG_INF ? exp2f(s[r] - m_new) : 0.f;
          rs4[(2 * jn + e) % 4] += p;
          s[r] = p;
        }
      // this lane's share of the row sum
      l[hh] = alpha * l[hh] + ((rs4[0] + rs4[1]) + (rs4[2] + rs4[3]));
      m[hh] = m_new;
      if (it > t_lo) {
#pragma unroll
        for (int jn = 0; jn < DP / 8; ++jn) {
          o[4 * jn + 2 * hh] *= alpha;
          o[4 * jn + 2 * hh + 1] *= alpha;
        }
      }
    }
    // P rounded to V's type, as the A fragments of 4 slices of 16 keys
    uint32_t pf[fa::BKV / 4];
#pragma unroll
    for (int kk = 0; kk < fa::BKV / 16; ++kk) {
      pf[4 * kk + 0] = pack2(s[8 * kk + 0], s[8 * kk + 1], F16);
      pf[4 * kk + 1] = pack2(s[8 * kk + 2], s[8 * kk + 3], F16);
      pf[4 * kk + 2] = pack2(s[8 * kk + 4], s[8 * kk + 5], F16);
      pf[4 * kk + 3] = pack2(s[8 * kk + 6], s[8 * kk + 7], F16);
    }
    // O += P·V: V is MN-major (D innermost), 16 keys = 512 bytes on
    const uint32_t v_addr = k_addr(it) + KV_BYTES;
    hopper::fence_regs<DP / 2>(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < fa::BKV / 16; ++kk)
      hopper::Wgmma<DP>::template rs<1, F16>(
          o, pf + 4 * kk, make_desc(v_addr + kk * 512, fa::KV_CHUNK, 256, hopper::SWIZZLE_32B),
          it > t_lo || kk > 0);
    hopper::wgmma_commit();
    if (it + 1 < t_hi) {
      wait_tile(it + 1);
      issue_s(s, it + 1);
    }
  };

  for (int it = 0; it < t_lo; ++it) {
    wait_tile(it);
    release(it);
  }
  if (t_lo < t_hi) {
    float s[fa::BKV / 2];
    wait_tile(t_lo);
    issue_s(s, t_lo);
    for (int it = t_lo; it < t_hi; ++it) step(s, it);
    hopper::wgmma_wait<0>();
    hopper::fence_regs<DP / 2>(o);
    release(t_hi - 1);
  }
  for (int it = t_hi; it < nt; ++it) {
    wait_tile(it);
    release(it);
  }

  T* op = (T*)a.o + bb * a.so[0] + h * a.so[1];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    const int r = row + 8 * hh;
    if (r >= a.tq) continue;
#pragma unroll
    for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jn + 2 * quad + e;
        // a row that sees no key (its o never written) returns 0
        const float v = sum > 0.f ? o[4 * jn + 2 * hh + e] / sum : 0.f;
        if (col < a.d) op[r * a.so[2] + col] = from_f<T>(v);
      }
  }
}

template <typename T, int NC>
cudaError_t launch_wgmma_nc(const AttnArgs& a, int b, const long long* dims_q,
                            const long long* dims_kv, cudaStream_t st) {
  constexpr bool F16 = std::is_same<T, __half>::value;
  CUtensorMap mq, mk, mv;
  const long long* strides[3] = {a.sq, a.sk, a.sv};
  const void* ptrs[3] = {a.q, a.k, a.v};
  CUtensorMap* maps[3] = {&mq, &mk, &mv};
  for (int i = 0; i < 3; ++i) {
    // byte strides of (t, h, b): the element strides are given as (b, h, t)
    const long long sb[3] = {strides[i][2] * 2, strides[i][1] * 2, strides[i][0] * 2};
    cudaError_t err = hopper::encode_4d(maps[i], ptrs[i], F16, i == 0 ? dims_q : dims_kv, sb, 16,
                                        i == 0 ? fa::rows<NC>() : fa::BKV,
                                        CU_TENSOR_MAP_SWIZZLE_32B);
    if (err != cudaSuccess) return err;
  }
  const size_t bytes = fa::smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(attn_wgmma_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tq + fa::rows<NC>() - 1) / fa::rows<NC>(), a.hq, b);
  attn_wgmma_kernel<T, NC><<<grid, fa::threads<NC>(), bytes, st>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma(const AttnArgs& a, int b, cudaStream_t st) {
  const long long dims_q[4] = {a.d, a.tq, a.hq, b};
  const long long dims_kv[4] = {a.d, a.tk, a.hkv, b};
  const int nc = a.d / 16;
  if (nc <= 2) return launch_wgmma_nc<T, 2>(a, b, dims_q, dims_kv, st);
  if (nc <= 3) return launch_wgmma_nc<T, 3>(a, b, dims_q, dims_kv, st);
  if (nc <= 4) return launch_wgmma_nc<T, 4>(a, b, dims_q, dims_kv, st);
  if (nc <= 5) return launch_wgmma_nc<T, 5>(a, b, dims_q, dims_kv, st);
  if (nc <= 6) return launch_wgmma_nc<T, 6>(a, b, dims_q, dims_kv, st);
  if (nc <= 8) return launch_wgmma_nc<T, 8>(a, b, dims_q, dims_kv, st);
  if (nc <= 10) return launch_wgmma_nc<T, 10>(a, b, dims_q, dims_kv, st);
  if (nc <= 12) return launch_wgmma_nc<T, 12>(a, b, dims_q, dims_kv, st);
  return launch_wgmma_nc<T, 16>(a, b, dims_q, dims_kv, st);
}

template <typename T, int NC>
cudaError_t launch_tile(const AttnArgs& a, int b, cudaStream_t st) {
  constexpr int DP = 16 * NC, DQ = DP + 1;
  const size_t bytes = sizeof(float) * (size_t)(BQ * DQ + BK * DQ + BK * DP + BQ * PS);
  cudaError_t err = cudaFuncSetAttribute(attn_tile_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tq + BQ - 1) / BQ, a.hq, b);
  attn_tile_kernel<T, NC><<<grid, THREADS, bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const AttnArgs& a, int b, cudaStream_t st) {
  if (a.tq <= 8) {
    attn_rows_kernel<T><<<dim3(a.tq, a.hq, b), ROW_THREADS, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (a.d <= 64) return launch_tile<T, 4>(a, b, st);
  if (a.d <= 80) return launch_tile<T, 5>(a, b, st);
  if (a.d <= 128) return launch_tile<T, 8>(a, b, st);
  return launch_tile<T, 16>(a, b, st);
}

}  // namespace

// strides: 12 element strides, (b, h, t) of q, k, v and o in that order;
// dtype: 0 f32, 1 bf16, 2 f16 (all four tensors).  flash_attention_launch
// runs the SIMT kernels (attn_rows_kernel for tq <= 8, else
// attn_tile_kernel); flash_attention_wgmma_launch runs attn_wgmma_kernel
// (bf16/f16, d a multiple of 16, q/k/v strides and bases that TMA can
// read: kernels/flash_attention/kernel.py::route checks them).
#define ATTN_PARAMS                                                                          \
  const void *q, const void *k, const void *v, void *o, const long long *strides, int b,     \
      int hq, int hkv, int tq, int tk, int d, int causal, int window, int q_offset,          \
      int kv_len, float sm_scale, float softcap, int dtype, void *stream

static bool pack_args(AttnArgs* a, ATTN_PARAMS) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || tq <= 0 || tk <= 0 || d <= 0 ||
      d > 256 || kv_len < 0 || kv_len > tk || window < 0 || b > 65535 || hq > 65535)
    return false;
  a->q = q; a->k = k; a->v = v; a->o = o;
  for (int i = 0; i < 3; ++i) {
    a->sq[i] = strides[i];
    a->sk[i] = strides[3 + i];
    a->sv[i] = strides[6 + i];
    a->so[i] = strides[9 + i];
  }
  a->hq = hq; a->hkv = hkv; a->tq = tq; a->tk = tk; a->d = d;
  a->causal = causal; a->window = window; a->q_offset = q_offset; a->kv_len = kv_len;
  a->sm_scale = sm_scale; a->softcap = softcap;
  return true;
}

#define ATTN_ARGS \
  q, k, v, o, strides, b, hq, hkv, tq, tk, d, causal, window, q_offset, kv_len, sm_scale, \
      softcap, dtype, stream

extern "C" int flash_attention_launch(ATTN_PARAMS) {
  AttnArgs a;
  if (!pack_args(&a, ATTN_ARGS)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch<float>(a, b, st);
    case 1: return (int)launch<__nv_bfloat16>(a, b, st);
    case 2: return (int)launch<__half>(a, b, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_wgmma_launch(ATTN_PARAMS) {
  AttnArgs a;
  if (!pack_args(&a, ATTN_ARGS) || d % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 1: return (int)launch_wgmma<__nv_bfloat16>(a, b, st);
    case 2: return (int)launch_wgmma<__half>(a, b, st);
  }
  return (int)cudaErrorInvalidValue;
}
