// The two-level rotated resampler for Hopper (sm_90a): the rotated crop warp
// of an RGB canvas and its instance mask, both passes of
// ops/warp.py:warp_image_rotated_2level, with the translation cut applied to
// the content first.
//
// Replaces the Pallas TPU kernels tools/rot_pallas_probe.py:
// warp_2level_pallas (two pallas_calls, with an XLA transpose of tmp between
// them) and warp_2level_pallas_fused (one program per sample, tmp of all
// channels in 64 MB of VMEM).  On the TPU each grid step builds a dense hat
// tile ([w, out_w] for pass 1, [h, out_h] for pass 2) in VMEM and contracts
// a residual-shifted block of rows with it on the matrix unit.
//
// What bounds it on the card.  Bytes: a hat column has 2 non-zero taps and
// the residual lerp 2 non-zero weights, so an output value needs 4 products
// per pass, a few hundred MFLOP per batch against ~170 MB of uint8 input and
// float32 output at 32 x 640 -> 480.  The dense hat products of the TPU
// design would spend out_w (or out_h) times more operations on zeros.
//
// What the design does about it.  Direct banded form on the CUDA cores: each
// thread computes one value of 4 channels (RGB + mask) from the positions of
// its taps, reading only the non-zero taps:
//   pass 1, tmp[b, y, v, :]  = sum_{x in hat(vpos)} hat * sum_{k in lerp(delta1(y))}
//                              lerp * content[b, y, x + k, :]
//   pass 2, out[b, u, v, :]  = cut(u, v) * sum_{y in hat(upos)} hat *
//                              sum_{k in lerp(delta2(v))} lerp * tmp[b, y + k, v, :]
// It reads the uint8 NHWC canvas and the uint8 mask directly, so the float
// [B, h, w, 4] concat and the channel-major transposes of the TPU version do
// not exist; tmp and out are NHWC float4 rows, so pass 2's loads and both
// passes' stores are coalesced 16-byte accesses.
//
// warp_2level (B4) is two launches: pass 1 over (v, y, b), pass 2 over
// (v, u, b); tmp [B, h, out_w, 4] float32 lives in device memory between them.
// warp_2level_fused (B5) is one launch.  tmp (4.9 MB per sample at 640 -> 480)
// does not fit in the 227 KB of shared memory of an SM, so it stays in a
// global scratch, and pass 2 of a sample needs every row pass 1 wrote for it:
// one thread-block cluster of 8 CTAs per sample runs pass 1, meets at a
// cluster barrier (after a device-scope fence), then runs pass 2 reading tmp
// through L2 (__ldcg).  No grid-wide barrier is needed, and each sample's tmp
// is written and read by the SMs of one cluster.
//
// Positions, hat and lerp weights and the cut tests use round-to-nearest
// intrinsics in the operation order of the plain version, so they are
// bit-equal to it; only the order of the final sums differs.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC; bound with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define W2_THREADS 128
#define W2_CLUSTER 8
#define W2_FUSED_THREADS 512
#define W2_NCOEF 16

// per-sample coefficients, the layout of ops/warp_2level.py:coefficients
struct Coefs {
  float ax, bx, cx, lox, hix, m00, m01, ky0, loy, hiy, a_y, b_y, a_x, b_x, canvas_h, canvas_w;
};

struct Geom {
  int h, w, out_h, out_w, block, d1, d2;
};

__device__ __forceinline__ Coefs load_coefs(const float* coefs, int b) {
  const float* c = coefs + (size_t)b * W2_NCOEF;
  Coefs k;
  k.ax = c[0]; k.bx = c[1]; k.cx = c[2]; k.lox = c[3]; k.hix = c[4];
  k.m00 = c[5]; k.m01 = c[6]; k.ky0 = c[7]; k.loy = c[8]; k.hiy = c[9];
  k.a_y = c[10]; k.b_y = c[11]; k.a_x = c[12]; k.b_x = c[13];
  k.canvas_h = c[14]; k.canvas_w = c[15];
  return k;
}

// bilinear hat weight max(0, 1 - |pos - tap|)
__device__ __forceinline__ float hat(float pos, float tap) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(pos, tap))));
}

// the residual lerp of row (pass 1) or column (pass 2) index i: its clipped
// offset delta = clip(slope * (i % block - rc), -d, d), whose two non-zero
// taps are k0 = floor(delta) and k0 + 1 (the latter weighs 0 at the band
// edge, where it leaves the band)
struct Lerp {
  int k0;
  float w0, w1;
};

__device__ __forceinline__ Lerp residual(float slope, int i, int block, int d) {
  const float rc = 0.5f * (float)(block - 1);
  const float r = __fsub_rn((float)(i % block), rc);
  const float delta = fminf(fmaxf(__fmul_rn(slope, r), -(float)d), (float)d);
  Lerp l;
  l.k0 = (int)floorf(delta);
  l.w0 = hat(delta, (float)l.k0);
  l.w1 = l.k0 + 1 <= d ? hat(delta, (float)(l.k0 + 1)) : 0.f;
  return l;
}

// the block centre of index i: (i / block) * block + rc
__device__ __forceinline__ float block_centre(int i, int block) {
  return __fadd_rn((float)((i / block) * block), 0.5f * (float)(block - 1));
}

// one content pixel (RGB, mask) as floats; zero outside the image and
// outside the translation cut on x (the row cut is tested by the caller)
__device__ __forceinline__ float4 content(const uint8_t* img_row, const uint8_t* mask_row, int x,
                                          int w, float lox, float hix) {
  if (x < 0 || x >= w || !((float)x >= lox && (float)x < hix)) return make_float4(0.f, 0.f, 0.f, 0.f);
  const uint8_t* p = img_row + 3 * (size_t)x;
  return make_float4((float)p[0], (float)p[1], (float)p[2], (float)mask_row[x]);
}

__device__ __forceinline__ float4 lerp2(const Lerp& l, float4 a, float4 b) {
  return make_float4(__fadd_rn(__fmul_rn(l.w0, a.x), __fmul_rn(l.w1, b.x)),
                     __fadd_rn(__fmul_rn(l.w0, a.y), __fmul_rn(l.w1, b.y)),
                     __fadd_rn(__fmul_rn(l.w0, a.z), __fmul_rn(l.w1, b.z)),
                     __fadd_rn(__fmul_rn(l.w0, a.w), __fmul_rn(l.w1, b.w)));
}

__device__ __forceinline__ void axpy(float4& acc, float a, float4 x) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(a, x.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(a, x.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(a, x.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(a, x.w));
}

// pass 1: tmp[b, y, v, :] (horizontal resample of canvas row y)
__device__ __forceinline__ float4 pass1_value(const uint8_t* image, const uint8_t* mask,
                                              const Coefs& k, const Geom& g, int b, int y, int v) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float hiy = fminf(k.hiy, (float)g.h);
  if (!((float)y >= k.loy && (float)y < hiy)) return acc;  // row cut: content is 0
  const float hix = fminf(k.hix, (float)g.w);
  const Lerp l = residual(k.bx, y, g.block, g.d1);
  const float vpos =
      __fadd_rn(__fadd_rn(__fmul_rn(k.ax, (float)v), __fmul_rn(k.bx, block_centre(y, g.block))), k.cx);
  const uint8_t* img_row = image + ((size_t)b * g.h + y) * g.w * 3;
  const uint8_t* mask_row = mask + ((size_t)b * g.h + y) * g.w;
  const int x0 = (int)floorf(vpos);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int x = x0 + t;
    if (x < 0 || x >= g.w) continue;
    const float hw = hat(vpos, (float)x);
    if (hw == 0.f) continue;
    const float4 a = content(img_row, mask_row, x + l.k0, g.w, k.lox, hix);
    const float4 c = content(img_row, mask_row, x + l.k0 + 1, g.w, k.lox, hix);
    axpy(acc, hw, lerp2(l, a, c));
  }
  return acc;
}

template <bool L2_ONLY>
__device__ __forceinline__ float4 load_tmp(const float4* p) {
  if constexpr (L2_ONLY) return __ldcg(p);
  return *p;
}

// pass 2: out[b, u, v, :] (vertical resample of tmp column v, then the
// rotation cut)
template <bool L2_ONLY>
__device__ __forceinline__ float4 pass2_value(const float4* tmp, const Coefs& k, const Geom& g,
                                              int b, int u, int v) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float pyu = __fadd_rn(__fmul_rn(k.a_y, (float)u), k.b_y);
  const float pxv = __fadd_rn(__fmul_rn(k.a_x, (float)v), k.b_x);
  if (!(pyu >= 0.f && pyu < k.canvas_h && pxv >= 0.f && pxv < k.canvas_w)) return acc;
  const Lerp l = residual(k.m01, v, g.block, g.d2);
  const float upos =
      __fadd_rn(__fadd_rn(__fmul_rn(k.m00, (float)u), __fmul_rn(k.m01, block_centre(v, g.block))), k.ky0);
  const float4* col = tmp + (size_t)b * g.h * g.out_w + v;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int y0 = (int)floorf(upos);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int y = y0 + t;
    if (y < 0 || y >= g.h) continue;
    const float hw = hat(upos, (float)y);
    if (hw == 0.f) continue;
    const int ya = y + l.k0, yb = ya + 1;
    const float4 a = (ya >= 0 && ya < g.h) ? load_tmp<L2_ONLY>(col + (size_t)ya * g.out_w) : zero;
    const float4 c = (yb >= 0 && yb < g.h) ? load_tmp<L2_ONLY>(col + (size_t)yb * g.out_w) : zero;
    axpy(acc, hw, lerp2(l, a, c));
  }
  return acc;
}

__global__ void __launch_bounds__(W2_THREADS)
warp_2level_pass1_kernel(const uint8_t* __restrict__ image, const uint8_t* __restrict__ mask,
                         const float* __restrict__ coefs, float4* __restrict__ tmp, Geom g) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x, y = blockIdx.y, b = blockIdx.z;
  if (v >= g.out_w) return;
  const Coefs k = load_coefs(coefs, b);
  tmp[((size_t)b * g.h + y) * g.out_w + v] = pass1_value(image, mask, k, g, b, y, v);
}

__global__ void __launch_bounds__(W2_THREADS)
warp_2level_pass2_kernel(const float4* __restrict__ tmp, const float* __restrict__ coefs,
                         float4* __restrict__ out, Geom g) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x, u = blockIdx.y, b = blockIdx.z;
  if (v >= g.out_w) return;
  const Coefs k = load_coefs(coefs, b);
  out[((size_t)b * g.out_h + u) * g.out_w + v] = pass2_value<false>(tmp, k, g, b, u, v);
}

// one cluster of W2_CLUSTER CTAs per sample: pass 1 into the sample's tmp,
// a cluster barrier, pass 2 from it
__global__ void __cluster_dims__(W2_CLUSTER, 1, 1) __launch_bounds__(W2_FUSED_THREADS)
warp_2level_fused_kernel(const uint8_t* __restrict__ image, const uint8_t* __restrict__ mask,
                         const float* __restrict__ coefs, float4* tmp,
                         float4* __restrict__ out, Geom g) {
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.x / W2_CLUSTER;
  const int first = (int)cluster.block_rank() * blockDim.x + threadIdx.x;
  const int stride = W2_CLUSTER * blockDim.x;
  const Coefs k = load_coefs(coefs, b);
  float4* tmp_b = tmp + (size_t)b * g.h * g.out_w;
  for (int e = first; e < g.h * g.out_w; e += stride) {
    const int y = e / g.out_w, v = e - (e / g.out_w) * g.out_w;
    tmp_b[e] = pass1_value(image, mask, k, g, b, y, v);
  }
  __threadfence();  // tmp is visible device-wide before the barrier
  cluster.sync();
  float4* out_b = out + (size_t)b * g.out_h * g.out_w;
  for (int e = first; e < g.out_h * g.out_w; e += stride) {
    const int u = e / g.out_w, v = e - (e / g.out_w) * g.out_w;
    out_b[e] = pass2_value<true>(tmp, k, g, b, u, v);
  }
}

static bool bad_geometry(int b, const Geom& g) {
  return b < 1 || b > 65535 || g.h < 1 || g.w < 1 || g.h > 65535 || g.out_h < 1 ||
         g.out_h > 65535 || g.out_w < 1 || g.block < 1 || g.d1 < 1 || g.d2 < 1 ||
         (long long)g.h * g.out_w > 0x7fffffffLL || (long long)g.out_h * g.out_w > 0x7fffffffLL;
}

// image [b, h, w, 3] uint8, mask [b, h, w] uint8, coefs [b, 16] float32,
// tmp [b, h, out_w, 4] float32.  Returns a cudaError_t (0 on success).
extern "C" int warp_2level_pass1(const void* image, const void* mask, const void* coefs, void* tmp,
                                 int b, int h, int w, int out_h, int out_w, int block, int d1, int d2,
                                 void* stream) {
  const Geom g = {h, w, out_h, out_w, block, d1, d2};
  if (bad_geometry(b, g)) return (int)cudaErrorInvalidValue;
  const dim3 grid((out_w + W2_THREADS - 1) / W2_THREADS, h, b);
  warp_2level_pass1_kernel<<<grid, W2_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(image), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(coefs), static_cast<float4*>(tmp), g);
  return (int)cudaGetLastError();
}

// tmp [b, h, out_w, 4] float32, coefs [b, 16], out [b, out_h, out_w, 4] float32.
extern "C" int warp_2level_pass2(const void* tmp, const void* coefs, void* out, int b, int h, int w,
                                 int out_h, int out_w, int block, int d1, int d2, void* stream) {
  const Geom g = {h, w, out_h, out_w, block, d1, d2};
  if (bad_geometry(b, g)) return (int)cudaErrorInvalidValue;
  const dim3 grid((out_w + W2_THREADS - 1) / W2_THREADS, out_h, b);
  warp_2level_pass2_kernel<<<grid, W2_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(tmp), static_cast<const float*>(coefs), static_cast<float4*>(out), g);
  return (int)cudaGetLastError();
}

// both passes in one launch; tmp is the global scratch of pass 1.
extern "C" int warp_2level_fused(const void* image, const void* mask, const void* coefs, void* tmp,
                                 void* out, int b, int h, int w, int out_h, int out_w, int block,
                                 int d1, int d2, void* stream) {
  const Geom g = {h, w, out_h, out_w, block, d1, d2};
  if (bad_geometry(b, g) || (long long)b * W2_CLUSTER > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  warp_2level_fused_kernel<<<b * W2_CLUSTER, W2_FUSED_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(image), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(coefs), static_cast<float4*>(tmp), static_cast<float4*>(out), g);
  return (int)cudaGetLastError();
}
