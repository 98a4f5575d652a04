// Proposal-matching kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel instancesegmentation_tpu/ops/matching.py:
// match_proposals_pallas.  That kernel holds the whole [P, G] IoU matrix in
// VMEM as one block and computes, per row, the max, the first argmax and
// the labels, and, for the low-quality rescue, the per-column maxima.
//
// What bounds it on the card.  Bytes: it reads the matrix and writes two
// small vectors, and does a few comparisons per element.  At [2000, 64]
// that is 512 KB, well under a microsecond of HBM time, so in practice the
// launch latency bounds it.
//
// The rule on NaN is the JAX function's (jnp.max and jnp.argmax): a row's
// max is NaN if the row holds a NaN, and its argmax is then the first NaN's
// index (else the first index of the max); a column's max gt_best is NaN if
// the column holds one.  A NaN best gives the label IGNORE (both threshold
// tests fail), and a NaN gt_best rescues nobody (gt_best > 0 fails).  The
// helpers nan_max and better() below carry the rule; fmaxf and a bare `>`
// would drop the NaN.
//
// The cluster form (match_cluster_kernel), one launch, with the rescue.  A
// single thread-block cluster of K CTAs (1 for small P, up to 16 with the
// non-portable attribute) splits the rows into K blocks.  Each CTA copies
// its rows into shared memory where they fit (a padded row stride keeps
// the rows a warp reads at once in other banks), then (a) runs each row on
// a segment of 4-32 lanes (a power of two, ~16 columns per lane; a warp
// takes 32 / L rows at once; a whole warp per row where the rows are read
// from L2): the max and first argmax under the NaN rule, `matched` and the
// base label; (b) folds its rows into a partial column max in shared
// memory.  After a cluster barrier each CTA reduces the K partials through
// distributed shared memory into its own gt_best, runs the rescue test on
// its own rows (from shared memory, else a second read from L2) and writes
// the labels; a second barrier keeps every CTA's partials alive until all
// have read them.  No atomics, no global scratch; only comparisons, so the
// result is bit-equal to the plain version and deterministic.
//
// The two-pass form (column_max_kernel, then match_rows_kernel): the
// per-column maxima in a pass of their own through a global scratch, then a
// warp per row.  It stays as the cluster form's independent check, for a G
// whose partials do not fit in shared memory, and without the rescue, where
// it is its one row pass (faster on the card than the cluster kernel: no
// staging, no cluster, a warp per row over all SMs).
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC; bound with ctypes through
// match_proposals_launch, match_proposals_cluster_launch and
// match_proposals_max_cluster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MP_FULL_MASK 0xffffffffu
#define MP_COL_WARPS 32
#define MP_ROW_WARPS 8
#define MP_THREADS 512
#define MP_WARPS (MP_THREADS / 32)
#define MP_MAX_CLUSTER 16
#define MP_SMEM_LIMIT 232448

// max that keeps a NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// Is (v, i) a better (max, first argmax) candidate than (best, arg)?  A NaN
// beats every number; among NaNs, or equal numbers, the smaller index wins.
// arg == none: no candidate yet.
__device__ __forceinline__ bool better(float v, int i, float best, int arg, int none) {
  if (arg == none) return i != none;
  if (i == none) return false;
  const bool vn = v != v, bn = best != best;
  if (vn != bn) return vn;
  if (vn || v == best) return i < arg;
  return v > best;
}

__device__ __forceinline__ int base_label(float best, float high, float low) {
  return best >= high ? 1 : (best < low ? 0 : -1);  // NaN: -1
}

// the warp's (max, first argmax) of one row of g values at x
__device__ __forceinline__ void row_best(const float* x, int g, int lane, float* best_out,
                                         int* arg_out) {
  float best = -INFINITY;
  int arg = g;  // no column seen yet
  for (int col = lane; col < g; col += 32) {
    const float v = x[col];
    if (better(v, col, best, arg, g)) {
      best = v;
      arg = col;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(MP_FULL_MASK, best, off);
    const int oa = __shfl_down_sync(MP_FULL_MASK, arg, off);
    if (better(ob, oa, best, arg, g)) {
      best = ob;
      arg = oa;
    }
  }
  *best_out = best;
  *arg_out = arg;
}

// ---------------------------------------------------------------------------
// The two-pass form
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32 * MP_COL_WARPS)
column_max_kernel(const float* __restrict__ iou, float* __restrict__ gt_best, int p, int g) {
  __shared__ float part[MP_COL_WARPS][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float m = -INFINITY;
  if (col < g)
    for (int row = warp; row < p; row += MP_COL_WARPS) m = nan_max(m, iou[(size_t)row * g + col]);
  part[warp][lane] = m;
  __syncthreads();
  if (warp == 0 && col < g) {
    for (int w2 = 1; w2 < MP_COL_WARPS; ++w2) m = nan_max(m, part[w2][lane]);
    gt_best[col] = m;
  }
}

__global__ void __launch_bounds__(32 * MP_ROW_WARPS)
match_rows_kernel(const float* __restrict__ iou, const float* __restrict__ gt_best,
                  long long* __restrict__ matched, int* __restrict__ labels, int p, int g,
                  float high, float low, int allow_low_quality) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * MP_ROW_WARPS + (threadIdx.x >> 5);
  if (row >= p) return;  // uniform across the warp
  const float* x = iou + (size_t)row * g;
  float best;
  int arg;
  row_best(x, g, lane, &best, &arg);
  bool hit = false;
  if (allow_low_quality)
    for (int col = lane; col < g; col += 32) {
      const float gb = gt_best[col];
      hit = hit || (x[col] == gb && gb > 0.f);
    }
  hit = __any_sync(MP_FULL_MASK, hit);
  if (lane == 0) {
    matched[row] = arg;
    labels[row] = hit ? 1 : base_label(best, high, low);
  }
}

// iou [p, g] f32 row-major, gt_best [g] f32 scratch, matched [p] int64,
// labels [p] int32.  p, g >= 1.  Returns a cudaError_t (0 on success).
extern "C" int match_proposals_launch(const void* iou, void* gt_best, void* matched, void* labels,
                                      int p, int g, float high, float low, int allow_low_quality,
                                      void* stream) {
  if (p < 1 || g < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(iou);
  float* gb = static_cast<float*>(gt_best);
  if (allow_low_quality) {
    column_max_kernel<<<(g + 31) / 32, 32 * MP_COL_WARPS, 0, s>>>(x, gb, p, g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  match_rows_kernel<<<(p + MP_ROW_WARPS - 1) / MP_ROW_WARPS, 32 * MP_ROW_WARPS, 0, s>>>(
      x, gb, static_cast<long long*>(matched), static_cast<int*>(labels), p, g, high, low,
      allow_low_quality);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The cluster form
// ---------------------------------------------------------------------------

// Lanes that share a row in the cluster form's row passes: a power of two,
// at least 4, about g / 16 (each lane scans ~16 columns), at most 32.
__host__ __device__ inline int row_lanes(int g) {
  int l = 4;
  while (l < 32 && 16 * l < g) l *= 2;
  return l;
}

// Row stride of the staged rows, in floats: g + 4 where rows stay 16-byte
// aligned (a 16-byte copy per thread), else g + 1; either way the lanes of
// neighbouring rows fall in other banks.
__host__ __device__ inline int staged_stride(int g) { return (g & 3) == 0 ? g + 4 : g + 1; }

// Shared memory of a cluster CTA, in floats: the partial column max [g],
// gt_best [g], the column pass's group partials [MP_THREADS], the base
// labels [rows_per_cta rounded to 4], then the rows [rows_per_cta,
// staged_stride(g)] where they are staged.
__host__ __device__ inline long long cluster_smem_floats(int g, int rows_per_cta, int rows_in_smem) {
  const long long fixed = 2LL * g + MP_THREADS + ((rows_per_cta + 3LL) & ~3LL);
  return fixed + (rows_in_smem ? (long long)rows_per_cta * staged_stride(g) : 0);
}

// The (max, first argmax) of the row at x by the L lanes of its segment
// (lane l of the segment scans columns l, l + L, ...; then a shuffle tree
// within the segment).  Every lane of the warp takes part in the shuffles;
// a lane whose row is past the CTA's rows passes valid = false.
__device__ __forceinline__ void segment_best(const float* x, int g, int sl, int L, bool valid,
                                             float* best_out, int* arg_out) {
  float best = -INFINITY;
  int arg = g;
  if (valid)
    for (int col = sl; col < g; col += L) {
      const float v = x[col];
      if (better(v, col, best, arg, g)) {
        best = v;
        arg = col;
      }
    }
  for (int off = L >> 1; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(MP_FULL_MASK, best, off, L);
    const int oa = __shfl_down_sync(MP_FULL_MASK, arg, off, L);
    if (better(ob, oa, best, arg, g)) {
      best = ob;
      arg = oa;
    }
  }
  *best_out = best;
  *arg_out = arg;
}

__global__ void __launch_bounds__(MP_THREADS)
match_cluster_kernel(const float* __restrict__ iou, long long* __restrict__ matched,
                     int* __restrict__ labels, int p, int g, float high, float low,
                     int rows_per_cta, int rows_in_smem) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * rows_per_cta;  // one cluster: blockIdx.x is the rank
  const int nr = max(0, min(p - r0, rows_per_cta));
  float* colpart = sm;
  float* gtb = colpart + g;
  float* part = gtb + g;
  int* base = reinterpret_cast<int*>(part + MP_THREADS);
  float* staged = reinterpret_cast<float*>(base + ((rows_per_cta + 3) & ~3));
  const float* x = iou + (size_t)r0 * g;

  // the CTA's rows into shared memory (read twice with the rescue): 16-byte
  // cp.async copies, all in flight at once, where the rows allow
  const float* src = x;
  int stride = g;
  if (rows_in_smem) {
    stride = staged_stride(g);
    if ((g & 3) == 0 && (reinterpret_cast<size_t>(x) & 15) == 0) {
      const uint32_t dst = (uint32_t)__cvta_generic_to_shared(staged);
      const int q = g >> 2;  // 16-byte pieces per row
      for (int e = tid; e < nr * q; e += MP_THREADS) {
        const int row = e / q, k = e - row * q;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         dst + 4u * (uint32_t)(row * stride + 4 * k)),
                     "l"(x + (size_t)row * g + 4 * k)
                     : "memory");
      }
      asm volatile("cp.async.commit_group;\n cp.async.wait_all;\n" ::: "memory");
    } else {
      for (int e = tid; e < nr * g; e += MP_THREADS) {
        const int row = e / g;
        staged[row * stride + (e - row * g)] = x[e];
      }
    }
    __syncthreads();
    src = staged;
  }

  // (a) rows by segments of L lanes (a whole warp per row where the rows
  // are read from L2: fewer loads in a row per lane): max, first argmax,
  // base label
  const int L = src == x ? 32 : row_lanes(g), seg = lane / L, sl = lane - seg * L;
  const int per_warp = 32 / L;
  for (int row0 = warp * per_warp; row0 < nr; row0 += MP_WARPS * per_warp) {
    const int row = row0 + seg;
    float best;
    int arg;
    segment_best(src + (size_t)row * stride, g, sl, L, row < nr, &best, &arg);
    if (sl == 0 && row < nr) {
      matched[r0 + row] = arg;
      base[row] = base_label(best, high, low);
    }
  }

  // (b) the partial column max of the CTA's rows: `groups` groups of threads
  // over the rows, `cols` threads over the columns, folded in order
  const int cols = min((g + 31) & ~31, MP_THREADS), groups = MP_THREADS / cols;
  const int col0 = tid % cols, grp = tid / cols;
  if (grp < groups) {
    for (int col = col0; col < g; col += cols) {
      float m = -INFINITY;
      for (int row = grp; row < nr; row += groups) m = nan_max(m, src[(size_t)row * stride + col]);
      if (groups == 1)
        colpart[col] = m;
      else
        part[grp * cols + col0] = m;
    }
  }
  __syncthreads();
  if (groups > 1 && tid < g) {
    float m = part[tid];
    for (int k = 1; k < groups; ++k) m = nan_max(m, part[k * cols + tid]);
    colpart[tid] = m;
  }
  cluster.sync();  // every CTA's partials are complete

  // gt_best: the cluster's partials through distributed shared memory, in
  // rank order
  for (int col = tid; col < g; col += MP_THREADS) {
    float v[MP_MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < MP_MAX_CLUSTER; ++k)  // the remote loads first, all in flight
      v[k] = k < csize ? cluster.map_shared_rank(colpart, k)[col] : -INFINITY;
    float m = v[0];
#pragma unroll
    for (int k = 1; k < MP_MAX_CLUSTER; ++k) m = nan_max(m, v[k]);
    gtb[col] = m;
  }
  // this CTA has read every partial it needs; it waits for the others before
  // it exits, so that its own partials stay readable
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  // the rescue on the CTA's own rows, by the same segments
  for (int row0 = warp * per_warp; row0 < nr; row0 += MP_WARPS * per_warp) {
    const int row = row0 + seg;
    bool hit = false;
    if (row < nr) {
      const float* xr = src + (size_t)row * stride;
      for (int col = sl; col < g; col += L) {
        const float gb = gtb[col];
        hit = hit || (xr[col] == gb && gb > 0.f);
      }
    }
    for (int off = L >> 1; off > 0; off >>= 1)
      hit = __shfl_down_sync(MP_FULL_MASK, (int)hit, off, L) || hit;
    if (sl == 0 && row < nr) labels[r0 + row] = hit ? 1 : base[row];
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The kernel's attributes are set once, to the most shared memory a plan
// takes, so that a call does not pay for them (one process, one device).
static cudaError_t set_attributes() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady) {
    done = cudaFuncSetAttribute(match_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                MP_SMEM_LIMIT);
    if (done == cudaSuccess)
      done = cudaFuncSetAttribute(match_cluster_kernel,
                                  cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return done;
}

static cudaError_t cluster_config(int cluster, size_t smem, cudaLaunchConfig_t* cfg,
                                  cudaLaunchAttribute* attr) {
  const cudaError_t err = set_attributes();
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3(cluster);
  cfg->blockDim = dim3(MP_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The largest cluster (16, else 8) of which one can be resident with
// `smem` bytes per CTA; 0 when none can.
extern "C" int match_proposals_max_cluster(int smem) {
  for (int cluster = MP_MAX_CLUSTER; cluster >= 8; cluster /= 2) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    if (cluster_config(cluster, (size_t)smem, &cfg, &attr) != cudaSuccess) continue;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, (const void*)match_cluster_kernel, &cfg) ==
            cudaSuccess &&
        clusters >= 1)
      return cluster;
  }
  cudaGetLastError();  // clear a refused attribute
  return 0;
}

// iou [p, g] f32 row-major, matched [p] int64, labels [p] int32, with the
// low-quality rescue; one cluster of `cluster` CTAs (1-16) of rows_per_cta
// rows each (cluster * rows_per_cta >= p), the rows staged in shared memory
// when rows_in_smem.  Returns a cudaError_t (0 on success).
extern "C" int match_proposals_cluster_launch(const void* iou, void* matched, void* labels, int p,
                                              int g, float high, float low, int cluster,
                                              int rows_per_cta, int rows_in_smem, void* stream) {
  if (p < 1 || g < 1 || cluster < 1 || cluster > MP_MAX_CLUSTER || rows_per_cta < 1 ||
      (long long)cluster * rows_per_cta < p)
    return (int)cudaErrorInvalidValue;
  const long long smem = 4 * cluster_smem_floats(g, rows_per_cta, rows_in_smem);
  if (smem > MP_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(cluster, (size_t)smem, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, match_cluster_kernel, static_cast<const float*>(iou),
                           static_cast<long long*>(matched), static_cast<int*>(labels), p, g,
                           high, low, rows_per_cta, rows_in_smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
