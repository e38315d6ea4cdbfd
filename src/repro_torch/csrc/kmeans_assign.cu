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
// What bounds it: at the main path's shape (8M rows, d = 100, k = 64) one
// call reads 3.2 GB and does 2·n·k·d = 1.0e11 fp32 operations, ~1 ms of
// memory time and ~1.5 ms of CUDA-core FMA time, so it is compute-bound.
// The design keeps everything but the samples on chip: the center table
// (as quads, so one 16-byte broadcast load feeds four FMAs), the block's
// partial sums and counts, and a tile of up to 256 sample rows all live in
// shared memory; each row of the tile is served by 256 / tile_rows threads,
// each taking every (256 / tile_rows)-th group of 8 centers.
//
// Any k and d: the host picks the layout (kernels/kmeans/kernel.py::
// launch_plan).  A center table that does not fit is staged in chunks of
// `chunk` centers per tile, with a running best per row across chunks.
// Rows too wide for whole-row tiles take the D-tiled kernel below, which
// stages rows and centers `d_slice` features at a time.
//
// The TPU kernel carries its sums across a sequential grid; here blocks run
// in no order.  So the grid is sized to the card (a small multiple of the
// SM count), each block walks many row tiles and keeps one (k, d+1) partial
// in shared memory, and a second kernel sums the per-block partials in a
// fixed order.  Within a block each thread owns columns of the partial and
// adds the tile's rows in row order, so no atomics are used and the results
// do not change from run to run (nor with the layout: every distance is
// summed in one order).  Where the (k, d+1) partial does not fit on chip,
// the assignment kernel writes labels only, and a sums pass
// (kmeans_sums_kernel) adds the rows in order per (column slice, row group)
// with its slice of the partial on chip.

#include <cuda_runtime.h>
#include <math.h>

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
    // the sums pass: the widest column slice whose k x cols partial stays
    // under SUMS_SMEM_BYTES; past the card's limit, the partial stays global
    int dev = 0, limit = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    int cols = THREADS;
    while (cols > 32 && 4LL * k * cols > SUMS_SMEM_BYTES) cols /= 2;
    const bool on_chip = 4LL * k * cols <= limit;
    if (!on_chip) cols = THREADS;
    const size_t sbytes = on_chip ? 4 * (size_t)k * cols : 0;
    const void* sfn = on_chip ? (const void*)kmeans_sums_kernel<true>
                              : (const void*)kmeans_sums_kernel<false>;
    err = cudaFuncSetAttribute(sfn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sbytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((g.d + 1 + cols - 1) / cols, nblocks);
    const long long rows_per = ((long long)n + nblocks - 1) / nblocks;
    if (on_chip)
      kmeans_sums_kernel<true><<<grid, THREADS, sbytes, st>>>(
          (const float*)x, (const int*)labels, (float*)partials, g, cols, rows_per);
    else
      kmeans_sums_kernel<false><<<grid, THREADS, 0, st>>>(
          (const float*)x, (const int*)labels, (float*)partials, g, cols, rows_per);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long per = (long long)k * (g.d + 1);
  const int threads = 256;
  const long long want = (per + threads - 1) / threads;
  kmeans_reduce_kernel<<<(int)(want < 65535 ? want : 65535), threads, 0, st>>>(
      (const float*)partials, (float*)sums, (float*)counts, k, g.d, nblocks);
  return (int)cudaGetLastError();
}
