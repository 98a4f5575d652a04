// Greedy NMS kernel for Hopper (sm_90a): one launch for the sort, the
// suppression bitmask, the greedy walk and the compaction; one thread-block
// cluster per image.
//
// Replaces the Pallas TPU kernel instancesegmentation_tpu/ops/nms.py:
// nms_pallas.  That kernel takes an N x N float32 suppression matrix built
// by XLA (IoU > thr of the score-sorted boxes, XLA doing the sort) and scans
// it row by row in VMEM: when box i is still alive, it kills every later box
// of row i.
//
// What bounds it on the card.  The IoUs: N (N - 1) / 2 pairs of a few dozen
// float32 operations each (0.5 M pairs at N = 1024); the bytes are small
// (16 KB of boxes).  Then the walk, which is serial in the boxes: whether box
// i suppresses anything depends on every box before it.  A design that
// spends one block barrier per box is bound by that chain, and one that
// computes the IoUs on one SM by that SM's rate.
//
// What the design does about it.
//   A. The sort, in shared memory: a bitonic network over (score, index)
//      pairs, padded to a power of two with NaN sentinels of index >= N that
//      sort last.  The order is a total one (a number before a NaN, score
//      descending by value, so -0.0 == +0.0, then index ascending), which is
//      what the plain version's stable argsort of -scores gives.  Every CTA of
//      the cluster sorts its own copy, so they need no exchange.
//   B. The suppression bitmask, row i over the words of j > i of IoU > thr,
//      built by all CTAs of the cluster at once (a thread per (row, word), or
//      per part of one at small N; a warp reads the boxes of a word from a
//      few addresses), into CTA 0's shared memory through distributed shared
//      memory while it fits (N <= ~1,250), else into a global scratch of
//      N x N/8 bytes per image.  Up to 8 CTAs per image spread the IoUs over
//      8 SMs.
//   C. The greedy walk, in CTA 0, by one warp, 32 boxes at a time: the
//      diagonal words of the 32 boxes (their bits for the later boxes of the
//      same word) resolve the word in registers (a box whose bit is clear in
//      `dead` ORs its diagonal word in), so each box's own word reflects
//      every earlier OR; then the kept rows are ORed into `removed`
//      lane-parallel over the later words, by independent loads.  No block
//      barrier per box.  From a global scratch the block first copies the
//      word's 32 rows into shared memory, in column windows of `win` words
//      (the launch plan's; the diagonal word comes first), and ORs the kept
//      rows in window by window.  Only removed[] and prefix[] (~N/4 bytes)
//      stay in shared memory at every N, so the kernel takes any N up to
//      ~900,000 boxes; the global mask (N^2/8 bytes) runs out of device
//      memory first.
//   D. The compaction: a prefix count of the alive words, the first K
//      survivors in score order, -1 / False padding.  The score threshold
//      seeds `removed`.
//
// Up to NMS_SORT_LIMIT boxes the kernel sorts; above it the wrapper sorts
// with torch and passes the sorted boxes and the permutation, and phase A is
// skipped.
//
// Keeps must be identical to the plain version's, not close: a pair on
// the threshold flips a keep if one bit of its IoU differs.  So the IoU is
// written with round-to-nearest intrinsics (no FMA contraction) in the
// operation order of ops/nms.py:box_iou.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC; bound with ctypes through nms_scratch_words
// and nms_launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NMS_MAX_THREADS 1024
#define NMS_MIN_THREADS 256
#define NMS_SORT_LIMIT 4096
#define NMS_MAX_CLUSTER 8
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

// the sort's total order: a number before a NaN, then descending score
// compared by value (-0.0 == +0.0), then ascending index
__device__ __forceinline__ bool ranks_before(float sa, int ia, float sb, int ib) {
  const bool na = isnan(sa), nb = isnan(sb);
  if (na != nb) return nb;
  if (!na && sa != sb) return sa > sb;
  return ia < ib;
}

__host__ __device__ inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Shared memory: boxes[n] (optional) | keys[p] | idx[p] (when sorting) |
// mask[n][nwords] (while it fits) or stage[32][win] | removed[nwords] |
// prefix[nwords + 1]
struct Layout {
  size_t box, key, idx, mask, removed, prefix, total;
};

__host__ __device__ inline Layout smem_layout(int n, bool sort, bool boxes_in_smem,
                                              bool mask_in_smem, int win) {
  const size_t nwords = (size_t)((n + 31) >> 5);
  const size_t p = sort ? (size_t)next_pow2(n) : 0;
  Layout l;
  size_t off = 0;
  l.box = off;
  if (boxes_in_smem) off += (size_t)16 * n;
  l.key = off;
  off = align16(off + 4 * p);
  l.idx = off;
  off = align16(off + 4 * p);
  l.mask = off;
  off = align16(off + (mask_in_smem ? 4 * nwords * (size_t)n : (size_t)128 * win));
  l.removed = off;
  off = align16(off + 4 * nwords);
  l.prefix = off;
  off = align16(off + 4 * (nwords + 1));
  l.total = off;
  return l;
}

// Warp 0's share of the walk for word c (boxes 32c .. 32c + nrow - 1).  Word
// w of the word's row r is rows[r * rstride + w - base].  With `resolve`, the
// word is resolved first: box 32c + r is kept when its bit of `dead` is still
// clear, and then its diagonal word joins `dead`; every lane does the same
// from broadcast loads, eight at a time, and lane 0 stores the result in
// removed[c].  Then the kept rows are ORed into removed[w] for w in
// [w_lo, w_hi), lane-parallel, by independent loads.  Kept bits come from
// removed[c] when the word was resolved in an earlier window.
__device__ __forceinline__ void walk_window(const unsigned* rows, int rstride, int base, int c,
                                            int nrow, int w_lo, int w_hi, bool resolve,
                                            unsigned* removed, int lane) {
  unsigned dead = removed[c];
  if (resolve) {
    const unsigned* diag = rows + c - base;
#pragma unroll
    for (int r0 = 0; r0 < 32; r0 += 8) {
      unsigned d[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) d[q] = r0 + q < nrow ? diag[(r0 + q) * rstride] : 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (!((dead >> (r0 + q)) & 1u)) dead |= d[q];
    }
  }
  const unsigned kept = ~dead;
  for (int w = w_lo + lane; w < w_hi; w += 32) {
    const unsigned* col = rows + w - base;
    unsigned acc = removed[w];
#pragma unroll 8
    for (int r = 0; r < 32; ++r)
      if ((kept >> r) & 1u) acc |= col[r * rstride];
    removed[w] = acc;
  }
  if (resolve && lane == 0) removed[c] = dead;
  __syncwarp();
}

// One cluster per image.  order == nullptr: boxes [b, n, 4] and scores
// [b, n] in input order, sorted here (n <= NMS_SORT_LIMIT).  Otherwise they
// are sorted already and order [b, n] int64 is the permutation.
// mask_scratch == nullptr: the mask lives in CTA 0's shared memory, else in
// [b, n, nwords] of global memory, staged in windows of win words.
__global__ void __launch_bounds__(NMS_MAX_THREADS)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           const long long* __restrict__ order, long long* __restrict__ indices,
           uint8_t* __restrict__ valid, unsigned* mask_scratch, int n, int k, float iou_thr,
           float score_thr, int boxes_in_smem, int log_split, int win) {
  extern __shared__ uint4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const bool sort = order == nullptr;
  const bool staged = mask_scratch != nullptr;
  const int nwords = (n + 31) >> 5;
  const Layout lay = smem_layout(n, sort, boxes_in_smem, !staged, win);
  const int img = blockIdx.x / csize, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const float4* gbox = boxes + (size_t)img * n;
  const float* gsc = scores + (size_t)img * n;
  float* skey = reinterpret_cast<float*>(smem + lay.key);
  int* sidx = reinterpret_cast<int*>(smem + lay.idx);
  unsigned* local_mask = reinterpret_cast<unsigned*>(smem + lay.mask);  // or the stage
  unsigned* removed = reinterpret_cast<unsigned*>(smem + lay.removed);
  unsigned* prefix = reinterpret_cast<unsigned*>(smem + lay.prefix);

  // A. bitonic sort of (score, index), padded with NaN sentinels of index >= n
  if (sort) {
    const int p = next_pow2(n);
    for (int e = tid; e < p; e += nt) {
      skey[e] = e < n ? gsc[e] : __int_as_float(0x7fc00000);
      sidx[e] = e;
    }
    __syncthreads();
    for (int size = 2; size <= p; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const int s = __ffs(stride) - 1;
        for (int t = tid; t < (p >> 1); t += nt) {
          const int lo = ((t >> s) << (s + 1)) | (t & (stride - 1));  // bit `stride` clear
          const int hi = lo + stride;
          const float sl = skey[lo], sh = skey[hi];
          const int il = sidx[lo], ih = sidx[hi];
          // ascending runs where bit `size` of lo is clear (all of the last merge)
          if (ranks_before(sh, ih, sl, il) == ((lo & size) == 0)) {
            skey[lo] = sh;
            skey[hi] = sl;
            sidx[lo] = ih;
            sidx[hi] = il;
          }
        }
        // at strides <= 32 comparator t stays in elements 64 (t / 32) .. + 63,
        // the same for every t of a warp: stages there only meet the warp
        const int next = stride > 1 ? stride >> 1 : size;
        if (stride <= 32 && next <= 32)
          __syncwarp();
        else
          __syncthreads();
      }
    }
    __syncthreads();
  }

  // the boxes in score order
  const float4* bx = gbox;
  if (boxes_in_smem) {
    float4* sbox = reinterpret_cast<float4*>(smem + lay.box);
    for (int e = tid; e < n; e += nt) sbox[e] = gbox[sort ? sidx[e] : e];
    bx = sbox;
  }
  __syncthreads();
  cluster.sync();  // every CTA runs: CTA 0's shared memory may be written

  // B. mask words: item (i, w) for w >= i / 32, e = (w * 32 nwords + i) * split
  // + s; part s of the item takes boxes s * part .. of word w, and the split
  // lanes of an item, adjacent in one warp, OR their parts together.  A warp
  // is 32 / split rows of one word c against the same boxes of word w.
  unsigned* mask = staged ? mask_scratch + (size_t)img * n * nwords
                          : cluster.map_shared_rank(local_mask, 0);
  const int npad = nwords << 5, split = 1 << log_split, part = 32 >> log_split;
  // a multiple of 32 items, visited warp by warp: every lane of a warp
  // takes the same trips, so the shuffles below see the whole warp
  const long long items = ((long long)nwords * npad) << log_split;
  for (long long e = (long long)rank * nt + tid; e < items; e += (long long)csize * nt) {
    const int s = (int)(e & (split - 1));
    const long long item = e >> log_split;
    const int w = (int)(item / npad), i = (int)(item - (long long)w * npad);
    const bool live = i < n && w >= (i >> 5);
    unsigned word = 0u;
    if (live) {
      const float4 bi = bx[i];
      const int j0 = (w << 5) + s * part, jn = min(part, n - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const int j = j0 + jj;
        if (j > i && box_iou(bi, bx[j]) > iou_thr) word |= 1u << (s * part + jj);
      }
    }
    for (int off = 1; off < split; off <<= 1) word |= __shfl_xor_sync(NMS_FULL_MASK, word, off);
    if (live && s == 0) mask[(size_t)i * nwords + w] = word;
  }
  __threadfence();
  cluster.sync();  // the mask is complete
  if (rank != 0) return;

  // the alive set starts as score > score_threshold
  for (int w = warp; w < nwords; w += nwarps) {
    const int j = (w << 5) + lane;
    const float s = j < n ? (sort ? skey[j] : gsc[j]) : 0.f;
    const unsigned alive = __ballot_sync(NMS_FULL_MASK, j < n && s > score_thr);
    if (lane == 0) removed[w] = ~alive;
  }
  __syncthreads();

  // C. the greedy walk, 32 boxes (word c) at a time, by warp 0: from the
  // shared mask in one pass per word; from a global one, the word's rows
  // copied into the stage in column windows [w0, w0 + win), the first
  // holding the diagonal word c
  if (!staged) {
    for (int c = 0; c < nwords && warp == 0; ++c)
      walk_window(local_mask + (size_t)(c << 5) * nwords, nwords, 0, c, min(32, n - (c << 5)),
                  c + 1, nwords, true, removed, lane);
  } else {
    for (int c = 0; c < nwords; ++c) {
      for (int w0 = c; w0 < nwords; w0 += win) {
        const int span = min(win, nwords - w0);
        for (int e = tid; e < 32 * span; e += nt) {
          const int r = e / span, w = w0 + e - (e / span) * span;
          const int i = (c << 5) + r;
          local_mask[r * win + w - w0] = i < n ? __ldcg(mask + (size_t)i * nwords + w) : 0u;
        }
        __syncthreads();
        if (warp == 0)
          walk_window(local_mask, win, w0, c, min(32, n - (c << 5)), max(w0, c + 1), w0 + span,
                      w0 == c, removed, lane);
        __syncthreads();  // the stage is free for the next window
      }
    }
  }
  __syncthreads();

  // D. exclusive prefix of the alive words' popcounts (warp 0), total in prefix[nwords]
  if (warp == 0) {
    unsigned carry = 0;
    for (int base = 0; base < nwords; base += 32) {
      const int w = base + lane;
      const unsigned c = w < nwords ? __popc(~removed[w]) : 0u;
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
  const long long* ord = sort ? nullptr : order + (size_t)img * n;
  for (int j = tid; j < n; j += nt) {
    const unsigned word = ~removed[j >> 5];
    const unsigned bit = 1u << (j & 31);
    if (word & bit) {
      const int pos = (int)(prefix[j >> 5] + __popc(word & (bit - 1u)));
      if (pos < k) {
        out_idx[pos] = sort ? (long long)sidx[j] : ord[j];
        out_valid[pos] = 1;
      }
    }
  }
  for (int p = (int)prefix[nwords] + tid; p < k; p += nt) {
    out_idx[p] = -1;
    out_valid[p] = 0;
  }
}

struct Plan {
  bool boxes_in_smem, mask_in_smem;
  size_t smem;
  int cluster, threads, log_split, win;
};

// Where the launch keeps boxes and mask, the walk's window, its cluster and
// its block size: 0 on success, else a cudaError_t.  window > 0 forces the
// global mask and windows of at most that many words (the tests' small
// windows); 0 lets the plan choose.
static int make_plan(int n, bool sort, int window, Plan* plan) {
  if (n < 1 || (sort && n > NMS_SORT_LIMIT)) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // preference: boxes and mask in shared memory, then the mask only, then
  // the boxes only, then neither; sorting needs the boxes there (they fit).
  // A global mask is staged in the widest window that fits (all nwords
  // words when they do), at least 32 words, or the forced one.
  const int nwords = (n + 31) >> 5;
  const bool choices[4][2] = {{true, true}, {false, true}, {true, false}, {false, false}};
  for (int c = 0; c < 4; ++c) {
    if ((sort && !choices[c][0]) || (window > 0 && choices[c][1])) continue;
    int win = 0;
    if (!choices[c][1]) {
      const size_t rest = smem_layout(n, sort, choices[c][0], false, 0).total;
      const long long room = rest < (size_t)optin ? ((long long)optin - (long long)rest) / 128 : 0;
      win = (int)(room < nwords ? room : nwords);
      if (window > 0 && window < win) win = window;
      if (win < (window > 0 ? 1 : (nwords < 32 ? nwords : 32))) continue;
    }
    const size_t bytes = smem_layout(n, sort, choices[c][0], choices[c][1], win).total;
    if (bytes <= (size_t)optin) {
      plan->boxes_in_smem = choices[c][0];
      plan->mask_in_smem = choices[c][1];
      plan->win = win;
      plan->smem = bytes;
      // CTAs per image: 1 up to N = 64, 8 from N = 512
      plan->cluster = nwords <= 2 ? 1 : (nwords <= 4 ? 2 : (nwords <= 8 ? 4 : NMS_MAX_CLUSTER));
      const int p = next_pow2(n);
      plan->threads = !sort ? NMS_MAX_THREADS
                            : (p < NMS_MIN_THREADS ? NMS_MIN_THREADS
                                                   : (p > NMS_MAX_THREADS ? NMS_MAX_THREADS : p));
      // split each mask word over up to 8 lanes while the items are fewer
      // than the cluster's threads
      const long long items = (long long)nwords * nwords * 32;
      plan->log_split = 0;
      while (plan->log_split < 3 &&
             (items << (plan->log_split + 1)) <= (long long)plan->threads * plan->cluster)
        ++plan->log_split;
      return 0;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Words of global mask scratch per image that nms_launch needs for n
// boxes (0: the mask fits in shared memory); the negated cudaError_t when
// no launch can take n.  window as in make_plan.
extern "C" long long nms_scratch_words(int n, int sort, int window) {
  Plan plan;
  const int err = make_plan(n, sort != 0, window, &plan);
  if (err != 0) return -(long long)err;
  return plan.mask_in_smem ? 0 : (long long)n * ((n + 31) >> 5);
}

// boxes [b, n, 4] f32 and scores [b, n] f32: in input order when order is
// null (n <= NMS_SORT_LIMIT), else sorted by descending score with order
// [b, n] int64 their permutation.  mask_scratch: null, or [b, n * nwords]
// uint32 when nms_scratch_words says so (with the same window).  Writes
// indices [b, k] int64 and valid [b, k] bool.  b, n, k >= 1.  Returns a
// cudaError_t (0 on success).
extern "C" int nms_launch(const void* boxes, const void* scores, const void* order,
                          void* indices, void* valid, void* mask_scratch, int b, int n, int k,
                          float iou_thr, float score_thr, int window, void* stream) {
  if (b < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  Plan plan;
  const int perr = make_plan(n, order == nullptr, window, &plan);
  if (perr != 0) return perr;
  if (plan.mask_in_smem != (mask_scratch == nullptr) ||
      (long long)b * plan.cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = plan.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * plan.cluster);
  cfg.blockDim = dim3(plan.threads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nms_kernel, static_cast<const float4*>(boxes),
                           static_cast<const float*>(scores), static_cast<const long long*>(order),
                           static_cast<long long*>(indices), static_cast<uint8_t*>(valid),
                           static_cast<unsigned*>(mask_scratch), n, k, iou_thr, score_thr,
                           (int)plan.boxes_in_smem, plan.log_split, plan.win);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
