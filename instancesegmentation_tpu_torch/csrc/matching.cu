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
// launch latency of its two passes bounds it.
//
// What the design does about it.  The per-column maxima gt_best[G] reduce
// across all P rows, so across blocks, which on the card needs a pass of
// its own: the first kernel gives each block 32 columns (one per lane,
// coalesced rows) and its warps a share of the rows, then folds the warps'
// maxima in shared memory; no float atomics.  The second kernel gives one
// warp to each row: the row max, the first argmax (the smallest index
// among ties, which is jnp.argmax's rule), the labels and the rescue test
// any(iou[p, g] == gt_best[g] and gt_best[g] > 0).  Both kernels only
// compare and never add, so they are bit-equal to the plain version.  The
// first pass is skipped when the rescue is off.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC; bound with ctypes through match_proposals_launch.

#include <cuda_runtime.h>
#include <math.h>

#define MP_FULL_MASK 0xffffffffu
#define MP_COL_WARPS 32
#define MP_ROW_WARPS 8

__global__ void __launch_bounds__(32 * MP_COL_WARPS)
column_max_kernel(const float* __restrict__ iou, float* __restrict__ gt_best, int p, int g) {
  __shared__ float part[MP_COL_WARPS][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float m = -INFINITY;
  if (col < g)
    for (int row = warp; row < p; row += MP_COL_WARPS) m = fmaxf(m, iou[(size_t)row * g + col]);
  part[warp][lane] = m;
  __syncthreads();
  if (warp == 0 && col < g) {
    for (int w2 = 1; w2 < MP_COL_WARPS; ++w2) m = fmaxf(m, part[w2][lane]);
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
  float best = -INFINITY;
  int arg = g;  // no column seen yet
  bool hit = false;
  for (int col = lane; col < g; col += 32) {
    const float v = x[col];
    if (arg == g || v > best) {
      best = v;
      arg = col;
    }
    if (allow_low_quality) {
      const float gb = gt_best[col];
      hit = hit || (v == gb && gb > 0.f);
    }
  }
  // (max, first index) across the warp
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(MP_FULL_MASK, best, off);
    const int oa = __shfl_down_sync(MP_FULL_MASK, arg, off);
    if (oa != g && (arg == g || ob > best || (ob == best && oa < arg))) {
      best = ob;
      arg = oa;
    }
  }
  hit = __any_sync(MP_FULL_MASK, hit);
  if (lane == 0) {
    int label = best >= high ? 1 : (best < low ? 0 : -1);
    if (hit) label = 1;
    matched[row] = arg;
    labels[row] = label;
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
