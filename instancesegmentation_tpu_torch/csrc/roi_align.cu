// RoI-Align kernel for Hopper (sm_90a), torchvision semantics, NHWC.
//
// Replaces the Pallas TPU kernel instancesegmentation_tpu/ops/roi_align.py:
// roi_align_pallas.  That kernel runs one program per ROI: the ROI's whole
// feature map is copied into VMEM channel-major, the averaged bilinear
// weights Wy [oh, H] and Wx^T [W, ow] are built, and out[c] =
// Wy . feat[c] . Wx^T runs on the matrix unit, channel by channel.
//
// What bounds it on the card.  Bytes.  An output bin needs only the
// 2 x 2 taps of its ratio^2 samples, a few hundred bytes per output row,
// against a few MB per feature map: the dense products touch every pixel
// of the map for every ROI, ~H*W / (4 ratio^2 oh ow) times more reads and
// operations than the samples need.  The least traffic is the feature
// pixels the samples touch, each read once, plus the output.
//
// What the design does about it.  It samples the map directly.  One block
// per (ROI, output row): it first computes the taps and weights of the
// row's ratio y-samples and of all ow * ratio x-samples into shared memory
// (the rules of ops/roi_align.py:_interp_weights: a centre outside
// [-1, size] weighs 0, else it is clamped to [0, size-1]; taps floor(c) and
// floor(c)+1, the second clamped since its weight is 0 at the edge); then
// its threads run over (ow, C) with C innermost, so neighbouring threads
// read neighbouring channels of one pixel: 16-byte float32 (8-byte bf16)
// loads where C % 4 == 0.  Inputs are float32 or bfloat16, arithmetic and
// the output float32.  The taps of a ROI are read once per output row
// that uses them, from L2 where neighbouring rows share them.
//
// The geometry is written with round-to-nearest intrinsics in the
// operation order of the plain version, so that sample positions (and
// their validity at the edges) agree with it.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC; bound with ctypes through roi_align_launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define RA_MAX_THREADS 256

struct Tap {
  int i0, i1;    // the two taps on this axis
  float w0, w1;  // their weights, 0 for a sample outside [-1, size]
};

__device__ __forceinline__ Tap make_tap(float start, float bin, int size, int o, int k, int ratio) {
  const float s = __fdiv_rn(__fadd_rn((float)k, 0.5f), (float)ratio);
  const float ctr = __fadd_rn(start, __fmul_rn(__fadd_rn((float)o, s), bin));
  Tap t = {0, 0, 0.f, 0.f};
  if (ctr < -1.f || ctr > (float)size) return t;
  const float cc = fminf(fmaxf(ctr, 0.f), (float)(size - 1));
  t.i0 = (int)floorf(cc);
  t.i1 = min(t.i0 + 1, size - 1);
  t.w1 = __fsub_rn(cc, (float)t.i0);
  t.w0 = __fsub_rn(1.f, t.w1);
  return t;
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

template <typename T, int V>
__global__ void __launch_bounds__(RA_MAX_THREADS)
roi_align_kernel(const T* __restrict__ feats, const float* __restrict__ boxes,
                 const int* __restrict__ box_idx, float* __restrict__ out, int n, int h, int w,
                 int c, int oh, int ow, float scale, int ratio, int aligned) {
  extern __shared__ Tap taps[];  // ratio y-taps, then ow * ratio x-taps
  const int r = blockIdx.x / oh, oy = blockIdx.x - (blockIdx.x / oh) * oh;
  const float off = aligned ? 0.5f : 0.f;
  const float* b = boxes + 4 * r;
  const float x0 = __fsub_rn(__fmul_rn(b[0], scale), off);
  const float y0 = __fsub_rn(__fmul_rn(b[1], scale), off);
  const float x1 = __fsub_rn(__fmul_rn(b[2], scale), off);
  const float y1 = __fsub_rn(__fmul_rn(b[3], scale), off);
  float roi_w = __fsub_rn(x1, x0), roi_h = __fsub_rn(y1, y0);
  if (!aligned) {
    roi_w = fmaxf(roi_w, 1.f);
    roi_h = fmaxf(roi_h, 1.f);
  }
  const float bin_w = __fdiv_rn(roi_w, (float)ow), bin_h = __fdiv_rn(roi_h, (float)oh);
  Tap* ty = taps;
  Tap* tx = taps + ratio;
  for (int e = threadIdx.x; e < ratio * (ow + 1); e += blockDim.x) {
    if (e < ratio) {
      ty[e] = make_tap(y0, bin_h, h, oy, e, ratio);
    } else {
      const int q = e - ratio;
      tx[q] = make_tap(x0, bin_w, w, q / ratio, q % ratio, ratio);
    }
  }
  __syncthreads();

  const int img = min(max(box_idx[r], 0), n - 1);  // never read outside the batch
  const T* f = feats + (size_t)img * h * w * c;
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
      if (ya.w0 == 0.f && ya.w1 == 0.f) continue;
      const T* row0 = f + (size_t)ya.i0 * w * c + c0;
      const T* row1 = f + (size_t)ya.i1 * w * c + c0;
      for (int sx = 0; sx < ratio; ++sx) {
        const Tap xa = tx[ox * ratio + sx];
        if (xa.w0 == 0.f && xa.w1 == 0.f) continue;
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
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv, acc[3] * inv);
    } else {
      dst[0] = acc[0] * inv;
    }
  }
}

template <typename T, int V>
static int launch(const void* feats, const void* boxes, const void* box_idx, void* out, int n,
                  int h, int w, int c, int r, int oh, int ow, float scale, int ratio, int aligned,
                  cudaStream_t stream) {
  int threads = ((ow * (c / V) + 31) / 32) * 32;
  threads = threads > RA_MAX_THREADS ? RA_MAX_THREADS : threads;
  const size_t smem = sizeof(Tap) * (size_t)ratio * (ow + 1);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  roi_align_kernel<T, V><<<r * oh, threads, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const float*>(boxes),
      static_cast<const int*>(box_idx), static_cast<float*>(out), n, h, w, c, oh, ow, scale,
      ratio, aligned);
  return (int)cudaGetLastError();
}

// feats [n, h, w, c] (dtype 0 = float32, 1 = bfloat16), boxes [r, 4] f32,
// box_idx [r] int32, out [r, oh, ow, c] f32.  r, c >= 1, ratio >= 1.
// Returns a cudaError_t (0 on success).
extern "C" int roi_align_launch(const void* feats, const void* boxes, const void* box_idx,
                                void* out, int n, int h, int w, int c, int r, int oh, int ow,
                                float scale, int ratio, int aligned, int dtype, void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || r < 1 || oh < 1 || ow < 1 || ratio < 1 ||
      (long long)r * oh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t elt = dtype == 0 ? 4 : 2;
  const bool vec4 = c % 4 == 0 && reinterpret_cast<size_t>(feats) % (4 * elt) == 0 &&
                    reinterpret_cast<size_t>(out) % 16 == 0;
  if (dtype == 0)
    return vec4 ? launch<float, 4>(feats, boxes, box_idx, out, n, h, w, c, r, oh, ow, scale, ratio,
                                   aligned, s)
                : launch<float, 1>(feats, boxes, box_idx, out, n, h, w, c, r, oh, ow, scale, ratio,
                                   aligned, s);
  if (dtype == 1)
    return vec4 ? launch<__nv_bfloat16, 4>(feats, boxes, box_idx, out, n, h, w, c, r, oh, ow,
                                           scale, ratio, aligned, s)
                : launch<__nv_bfloat16, 1>(feats, boxes, box_idx, out, n, h, w, c, r, oh, ow,
                                           scale, ratio, aligned, s);
  return (int)cudaErrorInvalidValue;
}
