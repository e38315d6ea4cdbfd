// Fused K-means assignment step on the stacked ds-array tensor, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/kmeans/kernel.py::
// kmeans_assign_padded (body _kmeans_kernel): for every sample row,
// ||x||² - 2 x·cᵀ + ||c||² against the whole center table, the argmin label
// (first minimum, as jnp.argmin; -1 for rows >= n), and per-cluster sums of
// the assigned rows with their counts.
//
// Samples are read straight from the (gn, gm, bn, bm) block tensor: row r,
// feature j lives at [r / bn, j / bm, r % bn, j % bm].  d = gm * bm is the
// padded feature count (pad columns are zero in both x and the centers).
//
// The TPU kernel carries its sums across a sequential grid; here blocks run
// in no order.  So the grid is sized to the card, each block walks many row
// tiles and keeps one (k, d+1) partial, and kmeans_reduce_kernel adds the
// per-block partials in block order.  No float atomics anywhere: the results
// are the same bits from run to run.  Where the partial does not fit on
// chip, the assignment kernel writes labels only and a sums pass
// (kmeans_sums_kernel) adds the rows in order per (column slice, row group).
//
// Two routes, chosen in Python before the launch (kernels/kmeans/kernel.py::
// route), one C entry each:
//
// - mma route (kmeans_assign_mma_launch: k <= 128, gm == 1, bm % 4 == 0,
//   x 16-byte aligned).  What bounds it: at the ds-array fit's shape (8 M
//   rows, d = 100, k = 64) one call reads 3.2 GB (0.97 ms at 3.35 TB/s) and
//   runs 2·n·k·d = 1.0e11 products three times on the TF32 tensor cores
//   (0.62 ms at 495 TFLOP/s): bound by bytes.  Design: distances in 3xTF32
//   on mma.sync.m16n8k8 (tf32x3.cuh), a warp owning 16 rows x all centers
//   in registers over the whole feature loop; each x value split once, by
//   the warp that owns its row, for every center tile; the centers split
//   once per call by a pre-pass into a {hi, hi, lo, lo} table laid out k
//   slab by k slab (one 16-byte load per B fragment, compile-time offsets,
//   no bank conflicts) beside ||c||², which each lane then keeps in
//   registers; the argmin a sequential first minimum per lane, then
//   shuffles.  Persistent blocks of 8 warps walk 128-row tiles, each stage
//   one TMA box (the block tensor read as n_pad rows of bm floats, which
//   needs gm == 1), issued by one thread on an mbarrier, into rows at a
//   pitch of 8 (mod 16) floats.  Two forms: resident (k <= 64, d <= 128:
//   the table stays in shared memory, the whole row is one stage, and the
//   block's sums are fused on the CUDA cores, in row order into registers:
//   warp w owns the labels c ≡ w (mod 8) and each lane 4 features; two
//   blocks an SM, one x tile each, so one block's sums overlap the other's
//   mmas) and streamed (wider rows: table slabs of 56 features staged beside
//   the x slabs, the next stage in flight, labels only, then the sums
//   pass).  Both add each distance in the same order, so they give the same
//   labels.
// - simt route (kmeans_assign_launch: every other shape, and the forced
//   comparisons).  IEEE fp32 FMAs on the CUDA cores (67 TFLOP/s: 1.6 ms of
//   operations at the fit's shape, bound by operations).  The center table
//   (as quads, so one 16-byte broadcast load feeds four FMAs), the block's
//   partial and a tile of up to 256 rows in shared memory; each row of the
//   tile served by 256 / tile_rows threads.  Any k and d: the host picks the
//   layout (kernels/kmeans/kernel.py::launch_plan): a center table that does
//   not fit is staged in chunks with a running best per row; rows too wide
//   for whole-row tiles take the D-tiled kernel, which stages rows and
//   centers d_slice features at a time.  Each thread owns columns of the
//   partial and adds the tile's rows in row order.

#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int THREADS = 256;   // the largest tile: one row per thread
constexpr int GROUP = 8;       // centers per pass over a row: two quads
constexpr long long SUMS_SMEM_BYTES = 96 << 10;   // sums pass: 2 blocks per SM
constexpr int LOADS = 8;       // D-tiled staging: global loads a thread keeps in flight

struct KGeom {
  int gm, bn, bm, n, k, kpad, d, dx, chunk, tile_rows, num_tiles;
  long long n_pad;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// shared memory layout, in floats: a chunk of the center table as quads
// [chunk/4][d][4], ||c||² of every center [kpad], the (k, d+1) partial when
// it lives on chip (column d holds the counts), the sample tile
// [tile_rows][dx], tile_rows int labels, then THREADS (distance, label)
// pairs for combining the threads of one row
__host__ __device__ inline long long smem_floats(int k, int d, int dx, int tile_rows,
                                                 int chunk, bool smem_partial) {
  return (long long)chunk * d + round_up(k, GROUP) +
         (smem_partial ? (long long)k * (d + 1) : 0) + (long long)tile_rows * dx +
         tile_rows + 2 * THREADS;
}

// centers [c0, c0 + chunk) as quads; centers >= k are zero
__device__ inline void stage_centers(const float* __restrict__ centers, float* cq, int c0,
                                     int chunk, int k, int d) {
  for (int e = threadIdx.x; e < chunk * d; e += THREADS) {
    const int q = e / (4 * d), rem = e - q * 4 * d, j = rem / 4, u = rem % 4;
    const int c = c0 + q * 4 + u;
    cq[e] = c < k ? centers[(long long)c * d + j] : 0.f;
  }
}

template <bool SMEM_PARTIAL>
__global__ void __launch_bounds__(THREADS)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ centers,
                     int* __restrict__ labels, float* __restrict__ partials, KGeom g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int k = g.k, d = g.d, dx = g.dx, d1 = d + 1, chunk = g.chunk, R = g.tile_rows;
  const float4* cq = smem4;                          // [chunk / 4][d]
  float* csq = smem + (long long)chunk * d;          // [kpad]
  float* ss = csq + g.kpad;                          // [k][d + 1] if SMEM_PARTIAL
  float* xs = ss + (SMEM_PARTIAL ? (long long)k * d1 : 0);   // [R][dx]
  int* lab = reinterpret_cast<int*>(xs + (long long)R * dx);  // [R]
  float* pair_d = reinterpret_cast<float*>(lab + R);         // [THREADS]
  int* pair_l = reinterpret_cast<int*>(pair_d + THREADS);    // [THREADS]

  const int tid = threadIdx.x;
  for (int c = tid; c < g.kpad; c += THREADS) {
    float s = 0.f;
    for (int j = 0; c < k && j < d; ++j) {
      const float v = centers[(long long)c * d + j];
      s = fmaf(v, v, s);
    }
    csq[c] = s;
  }
  // each thread zeroes, and later adds into, only the columns it owns
  for (int j = tid; SMEM_PARTIAL && j < d1; j += THREADS)
    for (int c = 0; c < k; ++c) ss[(long long)c * d1 + j] = 0.f;
  const bool one_chunk = chunk >= g.kpad;
  if (one_chunk) stage_centers(centers, smem, 0, chunk, k, d);
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, nwarps = THREADS / 32;
  const int r_own = tid % R, grp = tid / R, G = THREADS / R;
  const long long blk = (long long)g.bn * g.bm;
  for (int t = blockIdx.x; t < g.num_tiles; t += gridDim.x) {
    const long long row0 = (long long)t * R;
    const long long left = g.n_pad - row0;
    const int rows = (int)(left < R ? left : R);

    // stage the tile: one warp per row, lanes along the features
    for (int r = warp; r < rows; r += nwarps) {
      const long long gr = row0 + r;
      const long long bi = gr / g.bn;
      const long long bo = gr - bi * g.bn;
      const float* src = x + bi * g.gm * blk + bo * g.bm;
      for (int j = lane; j < d; j += 32) {
        const int jb = j / g.bm, jo = j - jb * g.bm;
        xs[r * dx + j] = src[jb * blk + jo];
      }
    }
    __syncthreads();

    // distances and argmin: thread (r_own, grp) takes groups grp, grp + G, ...
    // of each chunk (dx is odd: the rows of a warp hit distinct banks)
    const bool active = r_own < rows;
    const float* xr = xs + r_own * dx;
    float xsq = 0.f;
    for (int j = 0; active && j < d; ++j) xsq = fmaf(xr[j], xr[j], xsq);
    float best = INFINITY;
    int bl = 0;
    for (int c0 = 0; c0 < g.kpad; c0 += chunk) {
      if (!one_chunk) {
        __syncthreads();                      // the previous chunk is read
        stage_centers(centers, smem, c0, chunk, k, d);
        __syncthreads();
      }
      const int groups = (g.kpad - c0 < chunk ? g.kpad - c0 : chunk) / GROUP;
      for (int q8 = grp; active && q8 < groups; q8 += G) {
        float acc[GROUP];
#pragma unroll
        for (int u = 0; u < GROUP; ++u) acc[u] = 0.f;
        const float4* ca = cq + (long long)(2 * q8) * d;
        const float4* cb = ca + d;
        for (int j = 0; j < d; ++j) {
          const float xv = xr[j];
          const float4 a4 = ca[j], b4 = cb[j];
          acc[0] = fmaf(xv, a4.x, acc[0]);
          acc[1] = fmaf(xv, a4.y, acc[1]);
          acc[2] = fmaf(xv, a4.z, acc[2]);
          acc[3] = fmaf(xv, a4.w, acc[3]);
          acc[4] = fmaf(xv, b4.x, acc[4]);
          acc[5] = fmaf(xv, b4.y, acc[5]);
          acc[6] = fmaf(xv, b4.z, acc[6]);
          acc[7] = fmaf(xv, b4.w, acc[7]);
        }
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const int c = c0 + q8 * GROUP + u;
          if (c < k) {
            const float dist = (xsq - 2.0f * acc[u]) + csq[c];
            if (dist < best) { best = dist; bl = c; }
          }
        }
      }
    }
    if (G > 1) {  // the row's first minimum over its G threads
      pair_d[tid] = best;
      pair_l[tid] = bl;
      __syncthreads();
      for (int h = 1; grp == 0 && h < G; ++h) {
        const float dh = pair_d[h * R + r_own];
        const int lh = pair_l[h * R + r_own];
        if (dh < best || (dh == best && lh < bl)) { best = dh; bl = lh; }
      }
    }
    if (grp == 0 && active) {
      const long long gr = row0 + r_own;
      const int label = gr < g.n ? bl : -1;
      lab[r_own] = label;
      labels[gr] = label;
    }
    __syncthreads();

    // partial sums: each thread owns columns and adds rows in order
    for (int j = tid; SMEM_PARTIAL && j < d1; j += THREADS) {
      for (int r = 0; r < rows; ++r) {
        const int label = lab[r];
        if (label >= 0) ss[(long long)label * d1 + j] += j < d ? xs[r * dx + j] : 1.0f;
      }
    }
    __syncthreads();
  }

  if (SMEM_PARTIAL) {
    float* out = partials + (long long)blockIdx.x * k * d1;
    for (int e = tid; e < k * d1; e += THREADS) out[e] = ss[e];
  }
}

// shared memory of the D-tiled layout, in floats: a slice of a chunk of
// centers as quads [chunk/4][d_slice][4], the slice of the row tile
// [tile_rows][d_slice | 1], ||c||² of the chunk [chunk] and THREADS
// (distance, label) pairs
__host__ __device__ inline long long dtiled_smem_floats(int tile_rows, int chunk, int ds) {
  return (long long)chunk * ds + (long long)tile_rows * (ds | 1) + chunk + 2 * THREADS;
}

// features [j0, j0 + w) of centers [c0, c0 + chunk) as quads [chunk/4][w][4];
// centers >= k are zero.  Threads walk the features of LOADS centers at a
// time (coalesced, no division), issuing their loads before any store.
__device__ inline void stage_center_slice(const float* __restrict__ centers, float* cq, int c0,
                                          int chunk, int k, int d, int j0, int w) {
  for (int j = threadIdx.x; j < w; j += THREADS) {
    for (int cc = 0; cc < chunk; cc += LOADS) {
      float v[LOADS];
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int c = c0 + cc + i;
        v[i] = cc + i < chunk && c < k ? centers[(long long)c * d + j0 + j] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
        if (cc + i < chunk) cq[((cc + i) / 4 * w + j) * 4 + (cc + i) % 4] = v[i];
    }
  }
}

// The D-tiled layout, for rows of any width.  Per tile and chunk of
// centers, the rows and the centers are staged d_slice features at a time;
// each thread keeps its group of 8 distance sums, the row's ||x||² and (for
// one center) ||c||² in registers across the slices, adding the features in
// order, so every distance is the same fp32 sum as in the whole-row kernel
// and the labels do not depend on the layout.  A chunk is at most one group
// of 8 centers per thread of a row (chunk <= 8 * THREADS / tile_rows).  It
// writes labels only; the sums pass follows.
__global__ void __launch_bounds__(THREADS)
kmeans_assign_dtiled_kernel(const float* __restrict__ x, const float* __restrict__ centers,
                            int* __restrict__ labels, KGeom g, int ds) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int k = g.k, d = g.d, chunk = g.chunk, R = g.tile_rows, dsx = ds | 1;
  const float4* cq = smem4;                                  // [chunk / 4][w]
  float* xs = smem + (long long)chunk * ds;                  // [R][dsx]
  float* csq = xs + (long long)R * dsx;                      // [chunk]
  float* pair_d = csq + chunk;                               // [THREADS]
  int* pair_l = reinterpret_cast<int*>(pair_d + THREADS);    // [THREADS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = THREADS / 32;
  const int r_own = tid % R, grp = tid / R, G = THREADS / R;
  const long long blk = (long long)g.bn * g.bm;
  for (int t = blockIdx.x; t < g.num_tiles; t += gridDim.x) {
    const long long row0 = (long long)t * R;
    const long long left = g.n_pad - row0;
    const int rows = (int)(left < R ? left : R);
    const bool active = r_own < rows;
    const float* xr = xs + r_own * dsx;
    float xsq = 0.f;
    float best = INFINITY;
    int bl = 0;
    for (int c0 = 0; c0 < g.kpad; c0 += chunk) {
      const int groups = (g.kpad - c0 < chunk ? g.kpad - c0 : chunk) / GROUP;
      const bool mine = active && grp < groups;
      float acc[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; ++u) acc[u] = 0.f;
      float csum = 0.f;                       // ||c||² of center c0 + tid
      for (int j0 = 0; j0 < d; j0 += ds) {
        const int w = d - j0 < ds ? d - j0 : ds;
        __syncthreads();                      // the previous slice is read
        for (int r = warp; r < rows; r += nwarps) {   // a warp per row
          const long long gr = row0 + r;
          const long long bi = gr / g.bn;
          const long long bo = gr - bi * g.bn;
          const float* src = x + bi * g.gm * blk + bo * g.bm;
          int jb = (j0 + lane) / g.bm, jo = j0 + lane - jb * g.bm;   // feature j0 + jj
          for (int jj0 = lane; jj0 < w; jj0 += 32 * LOADS) {
            float v[LOADS];
#pragma unroll
            for (int u = 0; u < LOADS; ++u) {
              v[u] = jj0 + 32 * u < w ? src[jb * blk + jo] : 0.f;
              for (jo += 32; jo >= g.bm; jo -= g.bm) ++jb;
            }
#pragma unroll
            for (int u = 0; u < LOADS; ++u)
              if (jj0 + 32 * u < w) xs[r * dsx + jj0 + 32 * u] = v[u];
          }
        }
        stage_center_slice(centers, smem, c0, chunk, k, d, j0, w);
        __syncthreads();
        if (c0 == 0 && active)
          for (int jj = 0; jj < w; ++jj) xsq = fmaf(xr[jj], xr[jj], xsq);
        if (tid < chunk) {
          const float* cc = smem + (long long)(tid / 4) * 4 * w + tid % 4;
          for (int jj = 0; jj < w; ++jj) csum = fmaf(cc[4 * jj], cc[4 * jj], csum);
        }
        if (mine) {
          const float4* ca = cq + (long long)(2 * grp) * w;
          const float4* cb = ca + w;
          for (int jj = 0; jj < w; ++jj) {
            const float xv = xr[jj];
            const float4 a4 = ca[jj], b4 = cb[jj];
            acc[0] = fmaf(xv, a4.x, acc[0]);
            acc[1] = fmaf(xv, a4.y, acc[1]);
            acc[2] = fmaf(xv, a4.z, acc[2]);
            acc[3] = fmaf(xv, a4.w, acc[3]);
            acc[4] = fmaf(xv, b4.x, acc[4]);
            acc[5] = fmaf(xv, b4.y, acc[5]);
            acc[6] = fmaf(xv, b4.z, acc[6]);
            acc[7] = fmaf(xv, b4.w, acc[7]);
          }
        }
      }
      if (tid < chunk) csq[tid] = csum;
      __syncthreads();
      if (mine) {
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const int c = c0 + grp * GROUP + u;
          if (c < k) {
            const float dist = (xsq - 2.0f * acc[u]) + csq[grp * GROUP + u];
            if (dist < best) { best = dist; bl = c; }
          }
        }
      }
    }
    if (G > 1) {  // the row's first minimum over its G threads
      pair_d[tid] = best;
      pair_l[tid] = bl;
      __syncthreads();
      for (int h = 1; grp == 0 && h < G; ++h) {
        const float dh = pair_d[h * R + r_own];
        const int lh = pair_l[h * R + r_own];
        if (dh < best || (dh == best && lh < bl)) { best = dh; bl = lh; }
      }
    }
    if (grp == 0 && active) {
      const long long gr = row0 + r_own;
      labels[gr] = gr < g.n ? bl : -1;
    }
  }
}

// The sums pass of the layouts whose (k, d+1) partial does not fit on chip.
// Block (cs, rg) owns columns [cs·cols, cs·cols + cols) of the partial and
// the rows [rg·rows_per, (rg + 1)·rows_per) of the samples; each thread owns
// one column and adds those rows in row order into the block's slice of the
// partial, kept in shared memory when k·cols floats fit (else in place in
// its global slice), then writes it to partials[rg]; the reduce kernel adds
// the row groups in order.  Each thread loads LOADS rows' labels and values
// before it adds any, so that many loads are in flight.
template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
kmeans_sums_kernel(const float* __restrict__ x, const int* __restrict__ labels,
                   float* __restrict__ partials, KGeom g, int cols, long long rows_per) {
  extern __shared__ float sp[];   // [k][cols] if SMEM
  const int k = g.k, d = g.d, d1 = d + 1, tid = threadIdx.x;
  const int j = blockIdx.x * cols + tid;
  if (tid >= cols || j >= d1) return;   // no block-wide sync below
  float* out = partials + (long long)blockIdx.y * k * d1 + j;
  float* part = SMEM ? sp + tid : out;
  const long long stride = SMEM ? cols : d1;
  for (int c = 0; c < k; ++c) part[c * stride] = 0.f;
  const long long r0 = blockIdx.y * rows_per;
  const long long r1 = r0 + rows_per < g.n ? r0 + rows_per : g.n;
  const long long blk = (long long)g.bn * g.bm;
  const int jb = j / g.bm, jo = j - jb * g.bm;
  long long bi = r0 / g.bn, bo = r0 - bi * g.bn;
  for (long long r = r0; r < r1; r += LOADS) {
    int lab[LOADS];
    float v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const bool in = r + u < r1;
      lab[u] = in ? labels[r + u] : -1;
      v[u] = in && j < d ? x[(bi * g.gm + jb) * blk + bo * g.bm + jo] : 1.0f;
      if (++bo == g.bn) {
        bo = 0;
        ++bi;
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
      if (lab[u] >= 0) part[lab[u] * stride] += v[u];
  }
  if (SMEM)
    for (int c = 0; c < k; ++c) out[(long long)c * d1] = sp[c * cols + tid];
}

// sums/counts = the per-block partials added in block order
__global__ void kmeans_reduce_kernel(const float* __restrict__ partials,
                                     float* __restrict__ sums, float* __restrict__ counts,
                                     int k, int d, int nblocks) {
  const int d1 = d + 1;
  const long long per = (long long)k * d1;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < per;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < nblocks; ++p) s += partials[(long long)p * per + e];
    const int c = (int)(e / d1), j = (int)(e % d1);
    if (j < d)
      sums[(long long)c * d + j] = s;
    else
      counts[c] = s;
  }
}

int odd_stride(int d) { return d | 1; }

// ---------------------------------------------------------------------------
// mma route: 3xTF32 distances (and the fused sums) on the tensor cores
// ---------------------------------------------------------------------------

namespace mma {
using tf32x3::mma_tf32;
using tf32x3::split;
using tf32x3::split_a;

constexpr int WARPS = 8, THREADS = 32 * WARPS, ROWS = 16 * WARPS;   // a warp: 16 rows
constexpr int SLAB = 56;         // features per stage of the streamed form (≡ 8 mod 16)
constexpr int K_RESIDENT = 64;   // centers of the resident form (its sums: 4 m16 tiles)
constexpr int K_MAX = 128;       // centers of the route: one pass of accumulators
constexpr int D_RESIDENT = 128;  // padded features of the resident form (a chunk per lane)
constexpr unsigned FULL = 0xffffffffu;

// centers of the split table: 8 NT, NT = 8 n8 tiles up to 64 centers, 16
// above
__host__ __device__ inline int table_centers(int k) { return k <= 64 ? 64 : 128; }

struct MGeom {
  const float* x;
  const float* table;   // [d/8 k slabs][table_centers][4 lanes q][hi, hi, lo, lo]
  const float* csq;     // [table_centers]
  int* labels;
  float* partials;
  int gm, bn, bm, n, k, d;
  int F;        // features per stage: round8(d) (resident) or SLAB (streamed)
  int nslab;    // stages per row tile
  int px;       // shared-memory row pitch of x, floats
  long long n_pad;
  int num_tiles;
};

// x rows at a pitch ≡ 8 (mod 16) floats: the float2 A-fragment loads (a
// half-warp reads 4 rows x 8 floats) hit 32 distinct banks
__host__ __device__ inline int pitch_x(int f) { return f % 16 == 8 ? f : f + 8; }

// The resident form runs two blocks an SM (one block's sums overlap the
// other's mmas; 128 registers a thread) with one x buffer each; the
// streamed form one block an SM, with two (the next stage in flight).

// shared memory in floats, after up to 128 bytes that align the start
// (TMA writes 128-byte-aligned boxes).  Resident: the split table (d/8 k
// slabs of 16 floats per center), counts [64] (int), labels [R] (int),
// then its x tile [R][px].  Streamed: two stages of an x slab [R][px] and
// the SLAB/8 table slabs beside it.  Every part a multiple of 128 bytes.
__host__ __device__ inline long long smem_floats(int k, int d, bool resident) {
  const int cp = table_centers(k);
  if (resident) {
    const int f = round_up(d, 8), px = pitch_x(f);
    return 32 + (long long)(f / 8) * cp * 16 + K_RESIDENT + ROWS + (long long)ROWS * px;
  }
  return 32 + 2 * ((long long)ROWS * pitch_x(SLAB) + (long long)(SLAB / 8) * cp * 16);
}

// The split center table and ||c||², one warp per center.  Per k slab (8
// features), center and lane quad q, a float4 {hi, hi, lo, lo} of features
// 8·ks + 2q and + 1: one lane's B fragment for one n8 tile in one 16-byte
// load, and the 8 centers of a tile 16 floats apart (a quarter-warp reads
// 128 contiguous bytes).  Zero past k and d.  ||c||² in fp32 over the
// lanes, combined in a fixed order.
__global__ void kmeans_split_centers_kernel(const float* __restrict__ centers,
                                            float* __restrict__ table, float* __restrict__ csq,
                                            int k, int d, int cp, int kslabs) {
  const int c = blockIdx.x, lane = threadIdx.x;
  float s = 0.f;
  for (int p = lane; p < 4 * kslabs; p += 32) {
    const int j = 2 * p;
    const float v0 = c < k && j < d ? centers[(long long)c * d + j] : 0.f;
    const float v1 = c < k && j + 1 < d ? centers[(long long)c * d + j + 1] : 0.f;
    unsigned h0, l0, h1, l1;
    split(v0, h0, l0);
    split(v1, h1, l1);
    *reinterpret_cast<float4*>(table + ((long long)(p / 4) * cp + c) * 16 + 4 * (p % 4)) =
        make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                    __uint_as_float(l1));
    s = fmaf(v1, v1, fmaf(v0, v0, s));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) csq[c] = s;
}

// acc[nt] += x(rows rw0 ..) · c(centers 8 nt ..)ᵀ over kslabs k slabs of
// 8 staged features, in 3xTF32; xsq += the squares of the same values in
// fp32.  k permuted within a slab (slot q <- feature 2q, q + 4 <- 2q + 1),
// so a lane reads 2 adjacent features of x and one float4 of the table per
// tile.  Each x value is split once, for all NT tiles; the B fragments are
// held four tiles at a time (16 registers: two blocks fit an SM).
template <int NT, int UNROLL>
__device__ __forceinline__ void dist_slab(float (&acc)[NT][4], float (&xsq)[2], const float* xs,
                                          int px, const float* cs, int kslabs, int rw0, int gq,
                                          int q) {
  const float* xr = xs + (rw0 + gq) * px + 2 * q;
  const float* cb = cs + gq * 16 + 4 * q;
#pragma unroll UNROLL
  for (int ks = 0; ks < kslabs; ++ks, xr += 8, cb += NT * 128) {
    const float2 v0 = *reinterpret_cast<const float2*>(xr);
    const float2 v1 = *reinterpret_cast<const float2*>(xr + 8 * px);
    xsq[0] = fmaf(v0.y, v0.y, fmaf(v0.x, v0.x, xsq[0]));
    xsq[1] = fmaf(v1.y, v1.y, fmaf(v1.x, v1.x, xsq[1]));
    unsigned ahi[4], alo[4];
    split_a(v0.x, v1.x, v0.y, v1.y, ahi, alo);
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += 4) {
      unsigned bhi[4][2], blo[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 b = *reinterpret_cast<const float4*>(cb + (n0 + i) * 128);
        bhi[i][0] = __float_as_uint(b.x);
        bhi[i][1] = __float_as_uint(b.y);
        blo[i][0] = __float_as_uint(b.z);
        blo[i][1] = __float_as_uint(b.w);
      }
      // the cross terms first, then hi·hi'; each pass over the four tiles,
      // so consecutive mmas are independent
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_tf32(acc[n0 + i], ahi, blo[i][0], blo[i][1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_tf32(acc[n0 + i], alo, bhi[i][0], bhi[i][1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_tf32(acc[n0 + i], ahi, bhi[i][0], bhi[i][1]);
    }
  }
}

// Labels of the warp's rows from the finished accumulators: (||x||² -
// 2 x·c) + ||c||² for a lane's 2·NT centers (||c||² read once per tile,
// all loads issued together) in index order, the first minimum; then over
// the four lanes of a row by shuffles, by distance and then index; -1 for
// rows >= n.  The resident form also keeps them in shared memory (-1 past
// the last row) and counts them.  Zeroes acc and xsq for the next tile.
template <int NT, bool RESIDENT>
__device__ __forceinline__ void assign_rows(float (&acc)[NT][4], float (&xsq)[2], const MGeom& g,
                                            long long row0, int rw0, int* lab, int* cnt, int gq,
                                            int q) {
  float csq[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    csq[nt][0] = __ldg(g.csq + 8 * nt + 2 * q);
    csq[nt][1] = __ldg(g.csq + 8 * nt + 2 * q + 1);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x2 = xsq[h];
    x2 += __shfl_xor_sync(FULL, x2, 1);
    x2 += __shfl_xor_sync(FULL, x2, 2);
    float best = INFINITY;
    int bl = 0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * nt + 2 * q + e;
        const float dist = (x2 - 2.0f * acc[nt][2 * h + e]) + csq[nt][e];
        if (c < g.k && dist < best) {
          best = dist;
          bl = c;
        }
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float ob = __shfl_xor_sync(FULL, best, o);
      const int ol = __shfl_xor_sync(FULL, bl, o);
      if (ob < best || (ob == best && ol < bl)) {
        best = ob;
        bl = ol;
      }
    }
    const int r = rw0 + 8 * h + gq;
    const long long gr = row0 + r;
    if (q == 0) {
      const int label = gr < g.n ? bl : -1;
      if (gr < g.n_pad) g.labels[gr] = label;
      if (RESIDENT) {
        lab[r] = label;
        if (label >= 0) atomicAdd(cnt + label, 1);   // integers: any order, same count
      }
    }
  }
  xsq[0] = xsq[1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

// The block's sums on the CUDA cores, in row order, in registers: warp w owns
// the labels c ≡ w (mod WARPS) (8 of them: k <= 64) and lane l the
// features l + 32u (d <= 128), so the block's sums sit in 64 registers a
// lane over all its tiles.  Each of the warp's rows is added, in row order,
// to its label's registers (a warp-uniform switch picks them): every sum
// gets its rows in row order, the order of the simt route's column adds.
constexpr int RS_LABELS = K_RESIDENT / WARPS, RS_COLS = D_RESIDENT / 32;   // 8, 4
static_assert(RS_LABELS == 8 && RS_COLS == 4, "sums_regs' switch and adds");

__device__ __forceinline__ void sums_regs(float (&sacc)[RS_LABELS][RS_COLS], const float* xs,
                                          const int* lab, const MGeom& g, int R, int warp,
                                          int lane) {
  for (int s = 0; s < R; s += 32) {
    const int l = lab[s + lane];
    unsigned m = __ballot_sync(FULL, l >= 0 && l % WARPS == warp);
    while (m) {
      const int i = __ffs(m) - 1;
      m &= m - 1;
      const int li = __shfl_sync(FULL, l, i) / WARPS;
      const float* xr = xs + (s + i) * g.px + lane;
      float v[RS_COLS];
#pragma unroll
      for (int u = 0; u < RS_COLS; ++u) v[u] = lane + 32 * u < g.d ? xr[32 * u] : 0.f;
      switch (li) {
#define KMEANS_ADD_ROW(c)  \
  case c:                  \
    sacc[c][0] += v[0];    \
    sacc[c][1] += v[1];    \
    sacc[c][2] += v[2];    \
    sacc[c][3] += v[3];    \
    break;
        KMEANS_ADD_ROW(0) KMEANS_ADD_ROW(1) KMEANS_ADD_ROW(2) KMEANS_ADD_ROW(3)
        KMEANS_ADD_ROW(4) KMEANS_ADD_ROW(5) KMEANS_ADD_ROW(6) KMEANS_ADD_ROW(7)
#undef KMEANS_ADD_ROW
      }
    }
  }
}

// Persistent blocks of 8 warps walk row tiles of R = 128 rows (block b:
// tiles b, b + grid, ...); warp w owns rows 16·w .. 16·w + 15 of each (one
// m16 tile) and all 8·NT table centers.  A stage is one (tile, feature
// slab): the x slab and, streamed, the table's k slabs for those
// features.  Streamed, with two buffers, stage u + 1 is in flight while
// stage u computes; resident, with one, the SM's other block computes.
// Stage u lands on mbarrier bars[u % STAGES]: one TMA box of x per stage
// (the block tensor read as rows; columns past d zero-filled by the copy)
// and a bulk copy of the table's slabs, both issued by one thread.  The
// accumulators and ||x||² persist over a tile's slabs, so the resident and
// the streamed forms add every distance in the same order: the same
// labels.  RESIDENT: the whole row is one slab, the table is staged once,
// the block's sums stay in registers and its counts in shared memory; it
// writes them to partials[block] at the end.  Streamed: labels only.
template <int NT, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, RESIDENT ? 2 : 1)
kmeans_mma_kernel(const __grid_constant__ CUtensorMap xmap, MGeom g) {
  extern __shared__ __align__(16) float smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];   // the stages, the resident table
  constexpr int R = ROWS, CP = 8 * NT;
  constexpr int STAGES = RESIDENT ? 1 : 2;
  const int k = g.k, kslabs = g.F / 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, q = lane % 4;
  const int rw0 = warp * 16;
  float* smem = smem_raw + ((128 - hopper::smem_u32(smem_raw) % 128) % 128) / 4;
  float *cs_res = nullptr, *stage;
  int *cnt = nullptr, *lab = nullptr;
  int stage_floats;
  if (RESIDENT) {
    cs_res = smem;
    cnt = reinterpret_cast<int*>(cs_res + kslabs * CP * 16);
    lab = cnt + K_RESIDENT;
    stage = reinterpret_cast<float*>(lab + R);
    stage_floats = R * g.px;
  } else {
    stage = smem;
    stage_floats = R * g.px + (SLAB / 8) * CP * 16;
  }
  if (tid == 0) {   // one arrival each, with the bytes
    hopper::mbar_init(&bars[0], 1);
    hopper::mbar_init(&bars[1], 1);
    hopper::mbar_init(&bars[2], 1);
    hopper::fence_barrier_init();
  }
  if (RESIDENT)
    for (int c = tid; c < K_RESIDENT; c += THREADS) cnt[c] = 0;
  __syncthreads();
  if (RESIDENT && tid == 0) {
    const uint32_t bytes = (uint32_t)kslabs * CP * 16 * 4;
    hopper::mbar_expect_tx(&bars[2], bytes);
    hopper::bulk_load(cs_res, g.table, bytes, &bars[2]);
  }

  const int b = blockIdx.x;
  const int tiles = b < g.num_tiles ? (g.num_tiles - 1 - b) / (int)gridDim.x + 1 : 0;
  const int units = tiles * g.nslab;
  // stage (tile t of the block's, feature slab sl) into buffer buf
  auto stage_unit = [&](int t, int sl, int buf) {
    const long long row0 = (long long)(b + t * (int)gridDim.x) * R;
    const int j0 = sl * g.F;
    float* xs = stage + buf * stage_floats;
    const uint32_t tbytes = RESIDENT ? 0u : (uint32_t)(SLAB / 8) * CP * 16 * 4;
    if (tid == 0) {
      hopper::mbar_expect_tx(&bars[buf], tbytes + (uint32_t)R * g.px * 4);
      hopper::tma_load_2d(xs, &xmap, &bars[buf], j0, (int)row0);
      if (!RESIDENT)
        hopper::bulk_load(xs + R * g.px, g.table + (long long)(j0 / 8) * CP * 16, tbytes,
                          &bars[buf]);
    }
  };

  float acc[NT][4], xsq[2] = {0.f, 0.f}, sacc[RS_LABELS][RS_COLS];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int i = 0; i < RS_LABELS; ++i)
#pragma unroll
    for (int u = 0; u < RS_COLS; ++u) sacc[i][u] = 0.f;
  if (units > 0) stage_unit(0, 0, 0);
  if (RESIDENT) hopper::mbar_wait(&bars[2], 0);
  for (int u = 0, t = 0, sl = 0; u < units; ++u) {
    const int buf = u % STAGES;
    const bool last = sl == g.nslab - 1;   // the tile's last slab
    // the buffer's last reader passed the barrier at the end of u - 1
    if (STAGES == 2 && u + 1 < units) stage_unit(last ? t + 1 : t, last ? 0 : sl + 1, buf ^ 1);
    if (STAGES == 1 && u > 0) stage_unit(t, sl, 0);
    hopper::mbar_wait(&bars[buf], (u / STAGES) & 1);
    const float* xs = stage + buf * stage_floats;
    dist_slab<NT, STAGES>(acc, xsq, xs, g.px, RESIDENT ? cs_res : xs + R * g.px, kslabs, rw0,
                          gq, q);
    if (last) {
      const long long row0 = (long long)(b + t * (int)gridDim.x) * R;
      assign_rows<NT, RESIDENT>(acc, xsq, g, row0, rw0, lab, cnt, gq, q);
      if (RESIDENT) {
        __syncthreads();   // every row's label
        sums_regs(sacc, xs, lab, g, R, warp, lane);
      }
    }
    __syncthreads();
    if (last) {
      ++t;
      sl = 0;
    } else {
      ++sl;
    }
  }
  if (RESIDENT) {
    const int d1 = g.d + 1;
    float* out = g.partials + (long long)b * k * d1;
#pragma unroll
    for (int i = 0; i < RS_LABELS; ++i) {
      const int c = WARPS * i + warp;
#pragma unroll
      for (int u = 0; u < RS_COLS; ++u)
        if (c < k && lane + 32 * u < g.d) out[c * d1 + lane + 32 * u] = sacc[i][u];
    }
    for (int c = tid; c < k; c += THREADS) out[c * d1 + g.d] = (float)cnt[c];
  }
}

// one launch of kmeans_mma_kernel<...>
template <int NT, bool RESIDENT>
cudaError_t launch(const CUtensorMap& xmap, const MGeom& g, int blocks, size_t bytes,
                   cudaStream_t st) {
  auto fn = kmeans_mma_kernel<NT, RESIDENT>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  fn<<<blocks, THREADS, bytes, st>>>(xmap, g);
  return cudaGetLastError();
}

cudaError_t dispatch(const CUtensorMap& xmap, const MGeom& g, bool resident, int blocks,
                     size_t bytes, cudaStream_t st) {
  if (resident) return launch<8, true>(xmap, g, blocks, bytes, st);
  return table_centers(g.k) > 64 ? launch<16, false>(xmap, g, blocks, bytes, st)
                                  : launch<8, false>(xmap, g, blocks, bytes, st);
}

}  // namespace mma


// the sums pass: the widest column slice whose k x cols partial stays under
// SUMS_SMEM_BYTES; past the card's limit, the partial stays global.  One
// (k, d+1) partial per row group, nblocks groups
cudaError_t launch_sums_pass(const void* x, const void* labels, void* partials, const KGeom& g,
                             int n, int k, int nblocks, cudaStream_t st) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int cols = THREADS;
  while (cols > 32 && 4LL * k * cols > SUMS_SMEM_BYTES) cols /= 2;
  const bool on_chip = 4LL * k * cols <= limit;
  if (!on_chip) cols = THREADS;
  const size_t sbytes = on_chip ? 4 * (size_t)k * cols : 0;
  const void* sfn = on_chip ? (const void*)kmeans_sums_kernel<true>
                            : (const void*)kmeans_sums_kernel<false>;
  err = cudaFuncSetAttribute(sfn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sbytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.d + 1 + cols - 1) / cols, nblocks);
  const long long rows_per = ((long long)n + nblocks - 1) / nblocks;
  if (on_chip)
    kmeans_sums_kernel<true><<<grid, THREADS, sbytes, st>>>(
        (const float*)x, (const int*)labels, (float*)partials, g, cols, rows_per);
  else
    kmeans_sums_kernel<false><<<grid, THREADS, 0, st>>>(
        (const float*)x, (const int*)labels, (float*)partials, g, cols, rows_per);
  return cudaGetLastError();
}

// sums/counts = the nblocks (k, d+1) partials added in order
cudaError_t launch_reduce(const void* partials, void* sums, void* counts, int k, int d,
                          int nblocks, cudaStream_t st) {
  const long long per = (long long)k * (d + 1);
  const int threads = 256;
  const long long want = (per + threads - 1) / threads;
  kmeans_reduce_kernel<<<(int)(want < 65535 ? want : 65535), threads, 0, st>>>(
      (const float*)partials, (float*)sums, (float*)counts, k, d, nblocks);
  return cudaGetLastError();
}

}  // namespace

// d_slice > 0: the D-tiled layout (its sums always take the sums pass)
extern "C" long long kmeans_assign_smem_bytes(int k, int d, int tile_rows, int chunk,
                                              int smem_partial, int d_slice) {
  if (d_slice > 0) return dtiled_smem_floats(tile_rows, chunk, d_slice) * 4;
  return smem_floats(k, d, odd_stride(d), tile_rows, chunk, smem_partial != 0) * 4;
}

extern "C" int kmeans_assign_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  return v;
}

// partials: (nblocks, k, d+1) f32 scratch, one (k, d+1) partial per block of
// the assignment kernel (smem_partial) or per row group of the sums pass
// (the other layouts, whose assignment kernel runs label_blocks blocks).
// d_slice > 0 takes the D-tiled kernel.
extern "C" int kmeans_assign_launch(const void* x, const void* centers, void* labels,
                                    void* partials, void* sums, void* counts, int gn, int gm,
                                    int bn, int bm, int n, int k, int tile_rows, int chunk,
                                    int smem_partial, int d_slice, int label_blocks, int nblocks,
                                    void* stream) {
  if (gn <= 0 || gm <= 0 || bn <= 0 || bm <= 0 || k <= 0 || n < 0 || tile_rows < 32 ||
      tile_rows > THREADS || THREADS % tile_rows != 0 || chunk < GROUP || chunk % GROUP != 0 ||
      nblocks <= 0 || label_blocks <= 0 || d_slice < 0 ||
      (d_slice > 0 && (smem_partial || chunk > GROUP * (THREADS / tile_rows))))
    return (int)cudaErrorInvalidValue;
  KGeom g;
  g.gm = gm; g.bn = bn; g.bm = bm; g.n = n; g.k = k;
  g.kpad = round_up(k, GROUP);
  g.d = gm * bm;
  g.dx = odd_stride(g.d);
  g.chunk = chunk < g.kpad ? chunk : g.kpad;
  g.tile_rows = tile_rows;
  g.n_pad = (long long)gn * bn;
  g.num_tiles = (int)((g.n_pad + tile_rows - 1) / tile_rows);
  const long long bytes =
      d_slice > 0 ? dtiled_smem_floats(tile_rows, g.chunk, d_slice) * 4
                  : smem_floats(k, g.d, g.dx, tile_rows, g.chunk, smem_partial != 0) * 4;
  const void* fn = d_slice > 0    ? (const void*)kmeans_assign_dtiled_kernel
                   : smem_partial ? (const void*)kmeans_assign_kernel<true>
                                  : (const void*)kmeans_assign_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (d_slice > 0)
    kmeans_assign_dtiled_kernel<<<label_blocks, THREADS, (size_t)bytes, st>>>(
        (const float*)x, (const float*)centers, (int*)labels, g, d_slice);
  else if (smem_partial)
    kmeans_assign_kernel<true><<<nblocks, THREADS, (size_t)bytes, st>>>(
        (const float*)x, (const float*)centers, (int*)labels, (float*)partials, g);
  else
    kmeans_assign_kernel<false><<<label_blocks, THREADS, (size_t)bytes, st>>>(
        (const float*)x, (const float*)centers, (int*)labels, (float*)partials, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!smem_partial) {
    err = launch_sums_pass(x, labels, partials, g, n, k, nblocks, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_reduce(partials, sums, counts, k, g.d, nblocks, st);
}

// The mma route: kmeans_assign_mma_launch's shared memory (resident != 0:
// the resident form) and the floats of its table scratch (the split center
// table, then ||c||²)
extern "C" long long kmeans_assign_mma_smem_bytes(int k, int d, int resident) {
  return mma::smem_floats(k, d, resident != 0) * 4;
}

// blocks of the mma launch over n_pad rows on a card of `sms` SMs (one a
// partial in the resident form): two an SM resident, one streamed, at most
// one a tile
extern "C" int kmeans_assign_mma_blocks(long long n_pad, int resident, int sms) {
  const long long tiles = (n_pad + mma::ROWS - 1) / mma::ROWS;
  const long long per = (resident ? 2LL : 1LL) * sms;
  return (int)(tiles < per ? tiles : per);
}

extern "C" long long kmeans_assign_mma_table_floats(int k, int d) {
  const long long cp = mma::table_centers(k);
  return round_up(d, mma::SLAB) / 8 * cp * 16 + cp;
}

// The mma route, with the arguments of kmeans_assign_launch and: table, a
// 16-byte-aligned f32 scratch of kmeans_assign_mma_table_floats; resident
// != 0 (k <= 64, round8(bm) <= 128, nblocks == label_blocks: one partial
// per block) fuses the sums; else the streamed form writes labels and the
// sums pass follows (nblocks row groups).  gm == 1 (TMA reads the block
// tensor as rows), bm % 4 == 0, k <= 128, x 16-byte aligned.
extern "C" int kmeans_assign_mma_launch(const void* x, const void* centers, void* labels,
                                        void* partials, void* sums, void* counts, void* table,
                                        int gn, int gm, int bn, int bm, int n, int k,
                                        int resident, int label_blocks, int nblocks,
                                        void* stream) {
  const int d = gm * bm;
  if (gn <= 0 || gm != 1 || bn <= 0 || bm <= 0 || bm % 4 != 0 || k <= 0 || k > mma::K_MAX ||
      n < 0 || (long long)n > (long long)gn * bn || label_blocks <= 0 || nblocks <= 0 ||
      ((unsigned long long)x | (unsigned long long)table) % 16 != 0 ||
      (resident && (k > mma::K_RESIDENT || round_up(d, 8) > mma::D_RESIDENT ||
                    nblocks != label_blocks)))
    return (int)cudaErrorInvalidValue;
  const int cp = mma::table_centers(k), rows = mma::ROWS;
  const int kslabs = round_up(d, mma::SLAB) / 8;
  mma::MGeom g;
  g.x = (const float*)x;
  g.table = (const float*)table;
  g.csq = g.table + (long long)kslabs * cp * 16;
  g.labels = (int*)labels;
  g.partials = (float*)partials;
  g.gm = gm; g.bn = bn; g.bm = bm; g.n = n; g.k = k; g.d = d;
  g.F = resident ? round_up(d, 8) : mma::SLAB;
  g.nslab = (d + g.F - 1) / g.F;
  g.px = mma::pitch_x(g.F);
  g.n_pad = (long long)gn * bn;
  g.num_tiles = (int)((g.n_pad + rows - 1) / rows);
  cudaStream_t st = (cudaStream_t)stream;
  mma::kmeans_split_centers_kernel<<<cp, 32, 0, st>>>(
      (const float*)centers, (float*)table, (float*)g.csq, k, d, cp, kslabs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = (size_t)mma::smem_floats(k, d, resident != 0) * 4;
  // the block tensor as n_pad rows of bm floats: TMA boxes of px x rows
  CUtensorMap xmap = {};
  err = hopper::encode_2d_f32(&xmap, x, bm, g.n_pad, bm, g.px, rows);
  if (err != cudaSuccess) return (int)err;
  err = mma::dispatch(xmap, g, resident != 0, label_blocks, bytes, st);
  if (err != cudaSuccess) return (int)err;
  if (!resident) {
    KGeom kg = {};
    kg.gm = gm; kg.bn = bn; kg.bm = bm; kg.n = n; kg.k = k; kg.d = d;
    err = launch_sums_pass(x, labels, partials, kg, n, k, nblocks, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_reduce(partials, sums, counts, k, d, nblocks, st);
}
