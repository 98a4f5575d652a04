// RoI-Align for Hopper (sm_90a), torchvision semantics, NHWC.
//
// Replaces the Pallas TPU kernel instancesegmentation_tpu/ops/roi_align.py:
// roi_align_pallas.  That kernel runs one program per ROI: the ROI's whole
// feature map is copied into VMEM channel-major, the averaged bilinear
// weights Wy [oh, H] and Wx^T [W, ow] are built, and out[c] =
// Wy . feat[c] . Wx^T runs on the matrix unit, channel by channel.
//
// What bounds it on the card.  Bytes: an output bin needs only the 2 x 2
// taps of its ratio^2 samples, so the least traffic is the feature pixels
// the samples touch, each read once, plus the output.  Neighbouring samples
// of a small ROI share taps, and so do ROIs that overlap: the taps a kernel
// reads come to several times the distinct pixels, and ROIs taken in a
// random order read a map larger than L2 from device memory several times
// over.  Arithmetic is a few FMAs per byte.
//
// The kernel (roi_align_kernel): one block per (ROI, output row), taps and
// weights in shared memory, threads over (ow, C) with C innermost (16-byte
// float32 or 8-byte bf16 loads where C % 4 == 0), four taps per sample read
// straight from global memory, so L1 catches the taps a block's samples
// share.  Output stores are streaming (st.global.cs), so the output does
// not push feature lines out of L2.
//
// The locality order (roi_order_kernel), a first small launch where the
// caller passes an `order` scratch: the ROIs sorted by (image, band of the
// map the box centre lies in), so that resident blocks work on one region
// of the map and its pixels stay in L2 between them.  ops/roi_align.py
// passes it from ORDER_MIN_ROIS ROIs on.
//
// The tap rule is that of ops/roi_align.py:_interp_weights: a sample centre
// counts only if -1 <= ctr <= size (written so that a NaN centre fails),
// and then weighs (1 - frac, frac) on floor(cc) and
// floor(cc) + 1 of its clamp cc to [0, size - 1]; a centre that does not
// count weighs 0.  A valid tap has w0 > 0, so w0 == 0 marks a sample that
// does not count.  The box index follows the JAX gather: i < 0 -> i + n,
// then a clamp to [0, n - 1].  The geometry is written with round-to-
// nearest intrinsics in the operation order of the plain version, so that
// sample positions (and their validity at the edges) agree with it.
// Inputs are float32 or bfloat16, arithmetic and the output float32.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC; bound with ctypes through roi_align_launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define RA_MAX_THREADS 256
#define RA_ORDER_THREADS 1024
#define RA_ORDER_BUCKETS 4096
#define RA_ORDER_BANDS 16  // bands of the map in the order's key, as ops/roi_align.py

struct Tap {
  int i0, i1;    // the two taps on this axis
  float w0, w1;  // their weights; w0 == 0 for a sample that does not count
};

__device__ __forceinline__ Tap make_tap(float start, float bin, int size, int o, int k, int ratio) {
  const float s = __fdiv_rn(__fadd_rn((float)k, 0.5f), (float)ratio);
  const float ctr = __fadd_rn(start, __fmul_rn(__fadd_rn((float)o, s), bin));
  Tap t = {0, 0, 0.f, 0.f};
  if (!(ctr >= -1.f && ctr <= (float)size)) return t;  // NaN fails too
  const float cc = fminf(fmaxf(ctr, 0.f), (float)(size - 1));
  t.i0 = (int)floorf(cc);
  t.i1 = min(t.i0 + 1, size - 1);
  t.w1 = __fsub_rn(cc, (float)t.i0);
  t.w0 = __fsub_rn(1.f, t.w1);
  return t;
}

// JAX's gather rule for a box index: a negative one wraps once, then clamps
__device__ __forceinline__ int image_of(int i, int n) {
  if (i < 0) i += n;
  return min(max(i, 0), n - 1);
}

struct Geometry {
  float x0, y0, bin_w, bin_h;
};

__device__ __forceinline__ Geometry roi_geometry(const float* b, float scale, int aligned, int oh,
                                                 int ow) {
  const float off = aligned ? 0.5f : 0.f;
  Geometry g;
  g.x0 = __fsub_rn(__fmul_rn(b[0], scale), off);
  g.y0 = __fsub_rn(__fmul_rn(b[1], scale), off);
  const float x1 = __fsub_rn(__fmul_rn(b[2], scale), off);
  const float y1 = __fsub_rn(__fmul_rn(b[3], scale), off);
  float roi_w = __fsub_rn(x1, g.x0), roi_h = __fsub_rn(y1, g.y0);
  if (!aligned) {
    roi_w = fmaxf(roi_w, 1.f);
    roi_h = fmaxf(roi_h, 1.f);
  }
  g.bin_w = __fdiv_rn(roi_w, (float)ow);
  g.bin_h = __fdiv_rn(roi_h, (float)oh);
  return g;
}

template <typename T, int V> struct Vec;
template <> struct Vec<float, 1> {
  __device__ static void load(const float* p, float* v) { v[0] = *p; }
};
template <> struct Vec<float, 4> {
  __device__ static void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};
template <> struct Vec<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* v) { v[0] = __bfloat162float(*p); }
};
template <> struct Vec<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
};

// ---------------------------------------------------------------------------
// The locality order
// ---------------------------------------------------------------------------

// ROI indices by (image, band of the map that holds the box centre), a
// counting sort in one CTA.  Within a bucket the order is the atomics' (it
// changes no output: each ROI writes only its own rows).
__global__ void __launch_bounds__(RA_ORDER_THREADS)
roi_order_kernel(const float* __restrict__ boxes, const int* __restrict__ box_idx,
                 int* __restrict__ order, int r, int n, int h, float scale) {
  constexpr int bands = RA_ORDER_BANDS;
  __shared__ int start[RA_ORDER_BUCKETS];
  __shared__ int warp_sums[RA_ORDER_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long nb = (long long)n * bands;
  const int buckets = nb < RA_ORDER_BUCKETS ? (int)nb : RA_ORDER_BUCKETS;
  auto key = [&](int i) {
    const float cy = __fmul_rn(__fmul_rn(__fadd_rn(boxes[4 * i + 1], boxes[4 * i + 3]), 0.5f),
                               scale);
    const float fb = cy * (float)bands / (float)h;
    const int band = !(fb >= 0.f) ? 0 : (fb >= (float)(bands - 1) ? bands - 1 : (int)fb);
    return (int)(((long long)image_of(box_idx[i], n) * bands + band) % buckets);
  };
  for (int i = tid; i < RA_ORDER_BUCKETS; i += RA_ORDER_THREADS) start[i] = 0;
  __syncthreads();
  for (int i = tid; i < r; i += RA_ORDER_THREADS) atomicAdd(&start[key(i)], 1);
  __syncthreads();
  // exclusive scan of the counts: PER consecutive buckets per thread
  constexpr int PER = RA_ORDER_BUCKETS / RA_ORDER_THREADS;
  int local[PER], sum = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    local[k] = start[tid * PER + k];
    sum += local[k];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int ws = warp_sums[lane], wincl = ws;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wincl, off);
      if (lane >= off) wincl += v;
    }
    warp_sums[lane] = wincl - ws;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    start[tid * PER + k] = run;
    run += local[k];
  }
  __syncthreads();
  for (int i = tid; i < r; i += RA_ORDER_THREADS) order[atomicAdd(&start[key(i)], 1)] = i;
}

// ---------------------------------------------------------------------------
// The gather
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(RA_MAX_THREADS)
roi_align_kernel(const T* __restrict__ feats, const float* __restrict__ boxes,
                 const int* __restrict__ box_idx, const int* __restrict__ order,
                 float* __restrict__ out, int n, int h, int w, int c, int oh, int ow, float scale,
                 int ratio, int aligned) {
  extern __shared__ Tap taps[];  // ratio y-taps, then ow * ratio x-taps
  const int q = blockIdx.x / oh, oy = blockIdx.x - q * oh;
  const int r = order != nullptr ? order[q] : q;
  const Geometry geo = roi_geometry(boxes + 4 * r, scale, aligned, oh, ow);
  Tap* ty = taps;
  Tap* tx = taps + ratio;
  for (int e = threadIdx.x; e < ratio * (ow + 1); e += blockDim.x) {
    if (e < ratio) {
      ty[e] = make_tap(geo.y0, geo.bin_h, h, oy, e, ratio);
    } else {
      const int k = e - ratio;
      tx[k] = make_tap(geo.x0, geo.bin_w, w, k / ratio, k % ratio, ratio);
    }
  }
  __syncthreads();

  const T* f = feats + (size_t)image_of(box_idx[r], n) * h * w * c;
  const float inv = 1.f / (float)(ratio * ratio);
  const int cg = c / V;
  float* o = out + ((size_t)r * oh + oy) * ow * c;
  for (int e = threadIdx.x; e < ow * cg; e += blockDim.x) {
    const int ox = e / cg, c0 = (e - ox * cg) * V;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int sy = 0; sy < ratio; ++sy) {
      const Tap ya = ty[sy];
      if (ya.w0 == 0.f) continue;
      const T* row0 = f + (size_t)ya.i0 * w * c + c0;
      const T* row1 = f + (size_t)ya.i1 * w * c + c0;
      for (int sx = 0; sx < ratio; ++sx) {
        const Tap xa = tx[ox * ratio + sx];
        if (xa.w0 == 0.f) continue;
        float p00[V], p01[V], p10[V], p11[V];
        Vec<T, V>::load(row0 + (size_t)xa.i0 * c, p00);
        Vec<T, V>::load(row0 + (size_t)xa.i1 * c, p01);
        Vec<T, V>::load(row1 + (size_t)xa.i0 * c, p10);
        Vec<T, V>::load(row1 + (size_t)xa.i1 * c, p11);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float top = xa.w0 * p00[v] + xa.w1 * p01[v];
          const float bot = xa.w0 * p10[v] + xa.w1 * p11[v];
          acc[v] += ya.w0 * top + ya.w1 * bot;
        }
      }
    }
    float* dst = o + (size_t)ox * c + c0;
    if constexpr (V == 4)
      __stcs(reinterpret_cast<float4*>(dst),
             make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv, acc[3] * inv));
    else
      __stcs(dst, acc[0] * inv);
  }
}

template <typename T, int V>
static int launch_direct(const void* feats, const void* boxes, const void* box_idx,
                         const int* order, void* out, int n, int h, int w, int c, int r, int oh,
                         int ow, float scale, int ratio, int aligned, cudaStream_t s) {
  int threads = ((ow * (c / V) + 31) / 32) * 32;
  threads = threads > RA_MAX_THREADS ? RA_MAX_THREADS : threads;
  const size_t smem = sizeof(Tap) * (size_t)ratio * (ow + 1);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  roi_align_kernel<T, V><<<r * oh, threads, smem, s>>>(
      static_cast<const T*>(feats), static_cast<const float*>(boxes),
      static_cast<const int*>(box_idx), order, static_cast<float*>(out), n, h, w, c, oh, ow,
      scale, ratio, aligned);
  return (int)cudaGetLastError();
}

// feats [n, h, w, c] (dtype 0 = float32, 1 = bfloat16), boxes [r, 4] f32,
// box_idx [r] int32, out [r, oh, ow, c] f32.  r, c >= 1, ratio >= 1.
// With a non-null int32 [r] scratch `order`, the locality order runs first
// and the gather takes the ROIs in its order.  Returns a cudaError_t (0 on
// success).
extern "C" int roi_align_launch(const void* feats, const void* boxes, const void* box_idx,
                                void* order, void* out, int n, int h, int w, int c, int r, int oh,
                                int ow, float scale, int ratio, int aligned, int dtype,
                                void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || r < 1 || oh < 1 || ow < 1 || ratio < 1 ||
      (long long)r * oh > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ord = static_cast<const int*>(order);
  if (order != nullptr) {
    roi_order_kernel<<<1, RA_ORDER_THREADS, 0, s>>>(static_cast<const float*>(boxes),
                                                    static_cast<const int*>(box_idx),
                                                    static_cast<int*>(order), r, n, h, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t elt = dtype == 0 ? 4 : 2;
  const bool vec4 = c % 4 == 0 && reinterpret_cast<size_t>(feats) % (4 * elt) == 0 &&
                    reinterpret_cast<size_t>(out) % 16 == 0;
  if (dtype == 0)
    return vec4 ? launch_direct<float, 4>(feats, boxes, box_idx, ord, out, n, h, w, c, r, oh, ow,
                                          scale, ratio, aligned, s)
                : launch_direct<float, 1>(feats, boxes, box_idx, ord, out, n, h, w, c, r, oh, ow,
                                          scale, ratio, aligned, s);
  return vec4 ? launch_direct<__nv_bfloat16, 4>(feats, boxes, box_idx, ord, out, n, h, w, c, r,
                                                oh, ow, scale, ratio, aligned, s)
              : launch_direct<__nv_bfloat16, 1>(feats, boxes, box_idx, ord, out, n, h, w, c, r,
                                                oh, ow, scale, ratio, aligned, s);
}
