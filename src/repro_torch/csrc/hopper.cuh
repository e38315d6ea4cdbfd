// Hopper (sm_90a) building blocks shared by the tensor-core kernels:
// tensor maps for TMA (16-bit rank 4, f32 rank 2; encoded on the host
// through the driver's cuTensorMapEncodeTiled, fetched from the runtime so
// nothing links libcuda), mbarriers, TMA loads and 1-D bulk copies, wgmma
// shared-memory descriptors and the wgmma instructions themselves (SS: both
// operands from shared memory; RS: A from registers).
//
// Shared-memory layouts that the descriptors describe (T = 16-bit type):
// - K-major tile, 128-byte swizzle: rows of 64 T (128 B) at a stride of
//   128 B, 8-row groups 1024 B apart (SBO); a K step of 16 T adds 32 B to
//   the start address.
// - MN-major tile, 128-byte swizzle: per 64-wide MN chunk, K rows of 128 B,
//   8-row groups 1024 B apart (SBO), chunks LBO apart; a K step of 16 adds
//   16 rows (2048 B).
// - 32-byte swizzle (attention): the same with 16-wide chunks (32 B rows,
//   8-row groups 256 B apart).
// The swizzle of a descriptor must equal the swizzle its tensor map wrote.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A rank-4 tiled map over a 16-bit tensor: dims innermost first (dims[0] has
// unit stride), byte strides of dims 1..3, a box of (box0, box1, 1, 1).
// Out-of-bounds elements of a box read as zero.  A dim of size 1 takes the
// packed stride (its stride is never used, and may be anything).
static cudaError_t encode_4d(CUtensorMap* map, const void* base, bool f16,
                             const long long dims[4], const long long strides[3],
                             int box0, int box1, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t gdim[4], gstride[3];
  long long packed = dims[0] * 2;
  for (int i = 0; i < 4; ++i) gdim[i] = (cuuint64_t)dims[i];
  for (int i = 0; i < 3; ++i) {
    packed = (packed + 15) / 16 * 16;
    gstride[i] = (cuuint64_t)(dims[i + 1] == 1 ? packed : strides[i]);
    packed = (long long)gstride[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)box0, (cuuint32_t)box1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  CUresult r = fn(map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  4, const_cast<void*>(base), gdim, gstride, box, estride,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A rank-2 tiled map over an f32 matrix: `rows` rows of `cols` floats, `ld`
// floats apart (a multiple of 4), a box of box0 floats x box1 rows, no
// swizzle.  Out-of-bounds elements of a box read as zero.
static cudaError_t encode_2d_f32(CUtensorMap* map, const void* base, long long cols,
                                 long long rows, long long ld, int box0, int box1) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t gdim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t gstride[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box0, (cuuint32_t)box1};
  const cuuint32_t estride[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), gdim,
                  gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spins until the phase of parity `parity` has completed; a wait that
// outlasts 2^30 polls (seconds, where a healthy wait takes microseconds)
// traps, so a broken pipeline fails its launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one box of a rank-4 map into shared memory; completion counts its bytes
// on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// one box of a rank-2 map into shared memory (128-byte aligned)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16; both ends 16-byte aligned)
// into shared memory; completion counts them on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---------------------------------------------------------------------------
// device: warpgroups and wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma
template <int R> __device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

constexpr int SWIZZLE_128B = 1, SWIZZLE_32B = 3;   // descriptor layout types

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)swizzle << 62;
  return d;
}

// accumulator placeholders "%0".."%127", in chunks of 8 (16 output columns)
#define HW_P0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HW_P1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define HW_P2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define HW_P3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define HW_P4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define HW_P5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define HW_P6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define HW_P7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define HW_P8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define HW_P9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define HW_P10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define HW_P11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define HW_P12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define HW_P13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define HW_P14 "%112, %113, %114, %115, %116, %117, %118, %119"
#define HW_P15 "%120, %121, %122, %123, %124, %125, %126, %127"
#define HW_L1 HW_P0
#define HW_L2 HW_L1 ", " HW_P1
#define HW_L3 HW_L2 ", " HW_P2
#define HW_L4 HW_L3 ", " HW_P3
#define HW_L5 HW_L4 ", " HW_P4
#define HW_L6 HW_L5 ", " HW_P5
#define HW_L7 HW_L6 ", " HW_P6
#define HW_L8 HW_L7 ", " HW_P7
#define HW_L9 HW_L8 ", " HW_P8
#define HW_L10 HW_L9 ", " HW_P9
#define HW_L11 HW_L10 ", " HW_P10
#define HW_L12 HW_L11 ", " HW_P11
#define HW_L13 HW_L12 ", " HW_P12
#define HW_L14 HW_L13 ", " HW_P13
#define HW_L15 HW_L14 ", " HW_P14
#define HW_L16 HW_L15 ", " HW_P15
#define HW_O(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),       \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HW_OL1 HW_O(0)
#define HW_OL2 HW_OL1, HW_O(8)
#define HW_OL3 HW_OL2, HW_O(16)
#define HW_OL4 HW_OL3, HW_O(24)
#define HW_OL5 HW_OL4, HW_O(32)
#define HW_OL6 HW_OL5, HW_O(40)
#define HW_OL7 HW_OL6, HW_O(48)
#define HW_OL8 HW_OL7, HW_O(56)
#define HW_OL9 HW_OL8, HW_O(64)
#define HW_OL10 HW_OL9, HW_O(72)
#define HW_OL11 HW_OL10, HW_O(80)
#define HW_OL12 HW_OL11, HW_O(88)
#define HW_OL13 HW_OL12, HW_O(96)
#define HW_OL14 HW_OL13, HW_O(104)
#define HW_OL15 HW_OL14, HW_O(112)
#define HW_OL16 HW_OL15, HW_O(120)

// D (64 x N fp32, N/2 registers a thread) += A (64 x 16) · B (16 x N).
// ss: A and B from shared memory (descriptors); TA / TB = 1 reads an
// MN-major operand; scale_d = 0 overwrites D instead of adding to it, which
// spares zeroing D first (zeroed accumulators made ptxas serialize every
// wgmma of the attention kernel).  rs: A from four registers of packed
// 16-bit pairs (the accumulator layout of a 64 x 16 slice); TB and scale_d
// as for ss.  F16 picks f16 over bf16 inputs.  HW_DEFINE(N, C, R..R+8)
// defines N = 16·C, whose inputs follow its R = 8·C accumulator operands:
// the widths the kernels use (the GEMM's 128, attention's 64-key S and its
// D/16 in {2, 3, 4, 5, 6, 8, 10, 12, 16}).
template <int N> struct Wgmma;

#define HW_SS(N, C, TYPE, R0, R1, R2, R3, R4, R5, R6)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #R2 ", 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TYPE " {" HW_L##C     \
               "}, %" #R0 ", %" #R1 ", p, %" #R3 ", %" #R4 ", %" #R5 ", %" #R6 ";\n}\n" \
               : HW_OL##C                                                              \
               : "l"(da), "l"(db), "r"(scale_d), "n"(1), "n"(1), "n"(TA), "n"(TB))
#define HW_RS(N, C, TYPE, R0, R1, R2, R3, R4, R5, R6, R7, R8)                           \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #R5 ", 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TYPE " {" HW_L##C     \
               "}, {%" #R0 ", %" #R1 ", %" #R2 ", %" #R3 "}, %" #R4 ", p, %" #R6        \
               ", %" #R7 ", %" #R8 ";\n}\n"                                            \
               : HW_OL##C                                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(1), \
                 "n"(1), "n"(TB))
#define HW_DEFINE(N, C, R0, R1, R2, R3, R4, R5, R6, R7, R8)                             \
  template <> struct Wgmma<N> {                                                         \
    template <int TA, int TB, bool F16>                                                 \
    static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db,       \
                                              int scale_d = 1) {                        \
      if constexpr (F16)                                                                \
        HW_SS(N, C, "f16.f16", R0, R1, R2, R3, R4, R5, R6);                             \
      else                                                                              \
        HW_SS(N, C, "bf16.bf16", R0, R1, R2, R3, R4, R5, R6);                           \
    }                                                                                   \
    template <int TB, bool F16>                                                         \
    static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, \
                                              int scale_d = 1) {                        \
      if constexpr (F16)                                                                \
        HW_RS(N, C, "f16.f16", R0, R1, R2, R3, R4, R5, R6, R7, R8);                     \
      else                                                                              \
        HW_RS(N, C, "bf16.bf16", R0, R1, R2, R3, R4, R5, R6, R7, R8);                   \
    }                                                                                   \
  };

HW_DEFINE(32, 2, 16, 17, 18, 19, 20, 21, 22, 23, 24)
HW_DEFINE(48, 3, 24, 25, 26, 27, 28, 29, 30, 31, 32)
HW_DEFINE(64, 4, 32, 33, 34, 35, 36, 37, 38, 39, 40)
HW_DEFINE(80, 5, 40, 41, 42, 43, 44, 45, 46, 47, 48)
HW_DEFINE(96, 6, 48, 49, 50, 51, 52, 53, 54, 55, 56)
HW_DEFINE(128, 8, 64, 65, 66, 67, 68, 69, 70, 71, 72)
HW_DEFINE(160, 10, 80, 81, 82, 83, 84, 85, 86, 87, 88)
HW_DEFINE(192, 12, 96, 97, 98, 99, 100, 101, 102, 103, 104)
HW_DEFINE(256, 16, 128, 129, 130, 131, 132, 133, 134, 135, 136)

}  // namespace hopper
