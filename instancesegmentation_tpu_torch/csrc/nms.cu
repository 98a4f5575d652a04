// Greedy NMS kernel for Hopper (sm_90a): one block per image.
//
// Replaces the Pallas TPU kernel instancesegmentation_tpu/ops/nms.py:
// nms_pallas.  That kernel takes an N x N float32 suppression matrix built
// by XLA (IoU > thr of the score-sorted boxes) and scans it row by row in
// VMEM: when box i is still alive, it kills every later box of row i.
//
// What bounds it on the card.  The work depends on the data: one IoU per
// (kept box i, later box j) pair, a few dozen float32 operations each, and
// N serial steps, since whether box i suppresses anything depends on every
// step before it.  The operation and byte counts are small (N = 1024: at
// most ~0.5 M IoUs, 16 KB of boxes), so the serial chain of steps, each a
// block-wide barrier, bounds the time, not the card's rates.
//
// What the design does about it.  No N x N matrix is built (64 MB of
// float32 at N = 4096): the block keeps the sorted boxes in shared memory
// (global memory above the opt-in limit) and the alive set as a bitmask of
// 32-bit words.  Steps whose box is already dead cost one shared-memory
// read and no barrier; an alive step spreads the IoUs of the later boxes
// over the block, one warp per 32-box word, which clears its word's killed
// bits with one ballot and no atomics, followed by one barrier.  The
// survivors are compacted in score order from a prefix count of the words.
//
// Keeps must be identical to the plain version's, not close: a pair on
// the threshold flips a keep if one bit of its IoU differs.  So the IoU is
// written with round-to-nearest intrinsics (no FMA contraction) in the
// operation order of ops/nms.py:box_iou.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC; bound with ctypes through nms_launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define NMS_MAX_THREADS 512
#define NMS_FULL_MASK 0xffffffffu

// IoU of two xyxy boxes, in the operation order of box_iou
__device__ __forceinline__ float box_iou(const float4 a, const float4 b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float area_a = __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.f), fmaxf(__fsub_rn(a.w, a.y), 0.f));
  const float area_b = __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.f;
}

// Shared memory: alive[nwords] | prefix[nwords + 1] | pad to 16 B | boxes[n] (optional)
__host__ __device__ inline int words_bytes(int nwords) { return ((2 * nwords + 1) * 4 + 15) & ~15; }

__global__ void __launch_bounds__(NMS_MAX_THREADS)
nms_kernel(const float4* __restrict__ sboxes, const float* __restrict__ sscores,
           const long long* __restrict__ order, long long* __restrict__ indices,
           uint8_t* __restrict__ valid, int n, int k, float iou_thr, float score_thr,
           int boxes_in_smem) {
  extern __shared__ uint4 smem_raw[];
  const int nwords = (n + 31) >> 5;
  volatile unsigned* alive = reinterpret_cast<unsigned*>(smem_raw);
  unsigned* prefix = reinterpret_cast<unsigned*>(smem_raw) + nwords;
  const int img = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const float4* gbox = sboxes + (size_t)img * n;
  const float* sc = sscores + (size_t)img * n;

  const float4* bx = gbox;
  if (boxes_in_smem) {
    float4* sbox = reinterpret_cast<float4*>(reinterpret_cast<char*>(smem_raw) + words_bytes(nwords));
    for (int e = threadIdx.x; e < n; e += blockDim.x) sbox[e] = gbox[e];
    bx = sbox;
  }
  // the alive set starts as score > score_threshold
  for (int w = warp; w < nwords; w += nwarps) {
    const int j = (w << 5) + lane;
    const unsigned m = __ballot_sync(NMS_FULL_MASK, j < n && sc[j] > score_thr);
    if (lane == 0) alive[w] = m;
  }
  __syncthreads();

  // the greedy walk in score order; the branch is uniform across the block:
  // every thread reads bit i after the same barrier, and a step clears only
  // bits above its own i
  for (int i = 0; i < n; ++i) {
    if (!((alive[i >> 5] >> (i & 31)) & 1u)) continue;
    const float4 bi = bx[i];
    for (int w = ((i + 1) >> 5) + warp; w < nwords; w += nwarps) {
      const unsigned word = alive[w];
      const int j = (w << 5) + lane;
      const bool kill = j > i && j < n && ((word >> lane) & 1u) && box_iou(bi, bx[j]) > iou_thr;
      const unsigned m = __ballot_sync(NMS_FULL_MASK, kill);
      if (lane == 0 && m) alive[w] = word & ~m;  // this warp owns word w in this step
    }
    __syncthreads();
  }

  // exclusive prefix of the words' popcounts (warp 0), total in prefix[nwords]
  if (warp == 0) {
    unsigned carry = 0;
    for (int base = 0; base < nwords; base += 32) {
      const int w = base + lane;
      const unsigned c = w < nwords ? __popc(alive[w]) : 0u;
      unsigned s = c;
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(NMS_FULL_MASK, s, off);
        if (lane >= off) s += t;
      }
      if (w < nwords) prefix[w] = carry + s - c;
      carry += __shfl_sync(NMS_FULL_MASK, s, 31);
    }
    if (lane == 0) prefix[nwords] = carry;
  }
  __syncthreads();

  long long* out_idx = indices + (size_t)img * k;
  uint8_t* out_valid = valid + (size_t)img * k;
  const long long* ord = order + (size_t)img * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const unsigned word = alive[j >> 5];
    const unsigned bit = 1u << (j & 31);
    if (word & bit) {
      const int pos = (int)(prefix[j >> 5] + __popc(word & (bit - 1u)));
      if (pos < k) {
        out_idx[pos] = ord[j];
        out_valid[pos] = 1;
      }
    }
  }
  for (int p = (int)prefix[nwords] + threadIdx.x; p < k; p += blockDim.x) {
    out_idx[p] = -1;
    out_valid[p] = 0;
  }
}

// sboxes [b, n, 4] f32 and sscores [b, n] f32 sorted by descending score,
// order [b, n] int64 (the sort's permutation); writes indices [b, k] int64
// and valid [b, k] bool.  b, n, k >= 1.  Returns a cudaError_t (0 on success).
extern "C" int nms_launch(const void* sboxes, const void* sscores, const void* order,
                          void* indices, void* valid, int b, int n, int k, float iou_thr,
                          float score_thr, void* stream) {
  if (b < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int nwords = (n + 31) >> 5;
  const size_t with_boxes = (size_t)words_bytes(nwords) + (size_t)16 * n;
  const int boxes_in_smem = with_boxes <= (size_t)optin;
  const size_t smem = boxes_in_smem ? with_boxes : (size_t)words_bytes(nwords);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = nwords * 32;
  threads = threads < 64 ? 64 : (threads > NMS_MAX_THREADS ? NMS_MAX_THREADS : threads);
  nms_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(sboxes), static_cast<const float*>(sscores),
      static_cast<const long long*>(order), static_cast<long long*>(indices),
      static_cast<uint8_t*>(valid), n, k, iou_thr, score_thr, boxes_in_smem);
  return (int)cudaGetLastError();
}
