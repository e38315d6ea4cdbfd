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
// 8 MB per tensor, so it is bound by operations.  This first version runs
// them as fp32 FMAs on the CUDA cores (67 TFLOP/s on the data sheet, against
// 989 TFLOP/s of bf16 tensor cores: wgmma is later work).  Its design keeps
// everything of a (b, h, 64-query) tile on chip: the Q tile, one 64-key K/V
// tile at a time and the P tile in shared memory (as fp32), and the 64 x D
// output accumulator, the running max and sum in registers; 16 x 16 threads
// each own a 4 x 4 block of scores and a 4 x D/16 block of the output, so a
// shared-memory load feeds several FMAs.  The TPU's sequential KV grid axis
// becomes the loop over K/V tiles inside the block, which skips the tiles
// that the causal, window or kv_len masks hide from every row of the tile.
//
// Short queries (decode: Tq = 1) take attn_rows_kernel instead: one block
// per query row, one key per thread, so no dead query rows are computed.
//
// Layouts: q, k, v and o are read and written through their (b, h, t)
// strides, the last dim contiguous, so permuted (B, T, H, D) views need no
// copy.  D is taken as given, up to 256 (the tile kernel is instantiated for
// D <= 64, 80, 128, 256 and masks the rest).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

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
// dtype: 0 f32, 1 bf16, 2 f16 (all four tensors)
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const long long* strides, int b, int hq, int hkv, int tq,
                                      int tk, int d, int causal, int window, int q_offset,
                                      int kv_len, float sm_scale, float softcap, int dtype,
                                      void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || tq <= 0 || tk <= 0 || d <= 0 ||
      d > 256 || kv_len < 0 || kv_len > tk || window < 0 || b > 65535 || hq > 65535)
    return (int)cudaErrorInvalidValue;
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  a.hq = hq; a.hkv = hkv; a.tq = tq; a.tk = tk; a.d = d;
  a.causal = causal; a.window = window; a.q_offset = q_offset; a.kv_len = kv_len;
  a.sm_scale = sm_scale; a.softcap = softcap;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(a, b, st); break;
    case 1: err = launch<__nv_bfloat16>(a, b, st); break;
    case 2: err = launch<__half>(a, b, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
