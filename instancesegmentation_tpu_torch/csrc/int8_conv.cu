// int8 post-training-quantised convolution for Hopper (sm_90a), NHWC.
//
// Counterpart of the JAX package's int8 conv (models/layers.py:_Int8Conv):
// XLA's s8 x s8 -> s32 conv there (layers.py:126-135) and the quantise /
// dequantise around it (layers.py:146-156). It is not a Pallas kernel; no
// library int8 call on the card takes every conv the model quantises
// (depthwise 3x3 with dilations 1, 2 and 4, grouped (5,1) and (1,5), input
// widths 3, 19, 35, 52, a 3x3 conv with 4 output channels).
//
// Two launches per conv:
//   1. int8_quantize_kernel: x (float32 or bfloat16, [P, C]) ->
//      q = clip(rint(x / s_in), -127, 127) as int8 [P, Cp], Cp = C rounded
//      up to a multiple of 4, the channels C..Cp-1 zero. The division is a
//      true division (__fdiv_rn) and the rounding half-to-even
//      (__float2int_rn), as jnp.round(x / s_in): multiplying by 1 / s_in
//      moves some values across a .5 boundary.
//   2. the direct conv with int32 accumulation and the dequantising
//      epilogue y = (float)acc * scale[c] + bias[c], scale = s_in * s_w
//      (computed by the wrapper in float32 as XLA compiles JAX's s_in * s_w),
//      then cast to the output type. The multiply and the add are
//      __fmul_rn / __fadd_rn, two roundings as in the plain version (nvcc
//      would contract them into one FMA), so the two are bit-equal; XLA on
//      the CPU does contract, so the JAX program may differ by one rounding
//      of the product. Output kind 2 writes the raw int32 accumulators.
//      - groups == 1: int8_conv_dense_kernel, one thread per output pixel
//        and COT output channels, __dp4a over 4 input channels at a time
//        (the zero channels of Cp pad the last word, so widths 3, 19, 35
//        need no scalar tail); the weights of the block's COT channels
//        ([COT][KH][KW][Cp/4] words) sit in shared memory, read by every
//        thread of the block at the same address (a broadcast).
//      - groups > 1 (depthwise, grouped): int8_conv_grouped_kernel, one
//        thread per output element, plain int32 MACs over the group's
//        input channels; consecutive threads take consecutive channels.
//   Zero padding reads as the quantised 0 (a tap outside the image adds
//   nothing).
//
// Exactness: |acc| <= K * 127^2 with K = KH * KW * Cin/groups <= 500 in the
// model, far inside int32, and below 2^24, so (float)acc is exact.
//
// What bounds it on the card: bytes. Reading the float input once and
// writing the output once takes longer than the multiply-adds on the int8
// tensor cores for every conv of the model (the stem at 480 px, batch 128:
// 1.2 GB of bf16 input against 59 G multiply-adds). This simple form is
// far from that bound: the quantised input makes a round trip through
// device memory, the dense kernel reads each pixel's words once per block
// of COT output channels, and the multiply-adds run on the SIMT cores
// (dp4a), not the tensor cores. Closing the gap (implicit-im2col tiles on
// the int8 tensor cores, the quantise fused into the producer) is later
// work.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC); bound with ctypes through int8_quantize_launch
// and int8_conv_launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define INT8_THREADS 128
#define INT8_MAX_BLOCKS 8192

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int quantize(float v, float s_in) {
  const int q = __float2int_rn(__fdiv_rn(v, s_in));
  return min(max(q, -127), 127);
}

// one thread per 4 output channels of one pixel: reads up to 4 inputs,
// writes one packed word
template <typename T>
__global__ void int8_quantize_kernel(const T* __restrict__ x, int* __restrict__ q, long long P,
                                     int C, int C4, float s_in) {
  const long long total = P * C4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / C4;
    const int c0 = (int)(i - p * C4) * 4;
    const T* xp = x + p * C;
    unsigned word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + k;
      const int v = c < C ? quantize(to_f32(xp[c]), s_in) : 0;
      word |= (unsigned)(v & 0xff) << (8 * k);
    }
    q[i] = (int)word;
  }
}

__device__ __forceinline__ void store_out(float* p, int acc, float scale, float bias) {
  *p = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, int acc, float scale, float bias) {
  *p = __float2bfloat16_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias));
}
__device__ __forceinline__ void store_out(int* p, int acc, float, float) { *p = acc; }

struct ConvGeom {
  int n, h, w, ho, wo, cout, kh, kw, sh, sw, ph, pw, dh, dw;
};

// groups == 1: xq [N, H, W, C4] words, wq [Cout, KH, KW, C4] words
template <int COT, typename OutT>
__global__ void __launch_bounds__(INT8_THREADS)
int8_conv_dense_kernel(const int* __restrict__ xq, const int* __restrict__ wq,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       OutT* __restrict__ out, ConvGeom g, int C4) {
  extern __shared__ int ws[];  // [COT][KH][KW][C4]
  const int co0 = blockIdx.y * COT;
  const int wsz = g.kh * g.kw * C4;
  for (int i = threadIdx.x; i < COT * wsz; i += blockDim.x) ws[i] = wq[(long long)co0 * wsz + i];
  __syncthreads();
  const long long P = (long long)g.n * g.ho * g.wo;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < P;
       p += (long long)gridDim.x * blockDim.x) {
    const int ow = (int)(p % g.wo);
    const long long t = p / g.wo;
    const int oh = (int)(t % g.ho);
    const long long n = t / g.ho;
    int acc[COT];
#pragma unroll
    for (int j = 0; j < COT; ++j) acc[j] = 0;
    for (int ky = 0; ky < g.kh; ++ky) {
      const int ih = oh * g.sh - g.ph + ky * g.dh;
      if (ih < 0 || ih >= g.h) continue;
      for (int kx = 0; kx < g.kw; ++kx) {
        const int iw = ow * g.sw - g.pw + kx * g.dw;
        if (iw < 0 || iw >= g.w) continue;
        const int* xp = xq + ((n * g.h + ih) * g.w + iw) * C4;
        const int* wp = ws + (ky * g.kw + kx) * C4;
        for (int c = 0; c < C4; ++c) {
          const int xv = __ldg(xp + c);
#pragma unroll
          for (int j = 0; j < COT; ++j) acc[j] = __dp4a(xv, wp[j * wsz + c], acc[j]);
        }
      }
    }
    OutT* op = out + p * g.cout + co0;
#pragma unroll
    for (int j = 0; j < COT; ++j) store_out(op + j, acc[j], scale[co0 + j], bias[co0 + j]);
  }
}

// groups > 1: xq [N, H, W, Cp] int8, wq [Cout, Cin/groups, KH, KW] int8
template <typename OutT>
__global__ void __launch_bounds__(INT8_THREADS)
int8_conv_grouped_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         OutT* __restrict__ out, ConvGeom g, int Cp, int cin_g, int cout_g) {
  const long long total = (long long)g.n * g.ho * g.wo * g.cout;
  const int taps = g.kh * g.kw;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int co = (int)(i % g.cout);
    const long long p = i / g.cout;
    const int ow = (int)(p % g.wo);
    const long long t = p / g.wo;
    const int oh = (int)(t % g.ho);
    const long long n = t / g.ho;
    const int cbase = (co / cout_g) * cin_g;
    const int8_t* wc = wq + (long long)co * cin_g * taps;
    int acc = 0;
    for (int ky = 0; ky < g.kh; ++ky) {
      const int ih = oh * g.sh - g.ph + ky * g.dh;
      if (ih < 0 || ih >= g.h) continue;
      for (int kx = 0; kx < g.kw; ++kx) {
        const int iw = ow * g.sw - g.pw + kx * g.dw;
        if (iw < 0 || iw >= g.w) continue;
        const int8_t* xp = xq + ((n * g.h + ih) * g.w + iw) * Cp + cbase;
        const int8_t* wp = wc + ky * g.kw + kx;
        for (int ci = 0; ci < cin_g; ++ci) acc += (int)xp[ci] * (int)__ldg(wp + ci * taps);
      }
    }
    store_out(out + i, acc, scale[co], bias[co]);
  }
}

static unsigned grid_for(long long work) {
  const long long blocks = (work + INT8_THREADS - 1) / INT8_THREADS;
  return (unsigned)(blocks < INT8_MAX_BLOCKS ? (blocks > 0 ? blocks : 1) : INT8_MAX_BLOCKS);
}

template <int COT, typename OutT>
static void launch_dense(const void* xq, const void* wq, const float* scale, const float* bias,
                         void* out, ConvGeom g, int C4, cudaStream_t stream) {
  const size_t smem = (size_t)COT * g.kh * g.kw * C4 * sizeof(int);
  dim3 grid(grid_for((long long)g.n * g.ho * g.wo), g.cout / COT);
  int8_conv_dense_kernel<COT, OutT><<<grid, INT8_THREADS, smem, stream>>>(
      (const int*)xq, (const int*)wq, scale, bias, (OutT*)out, g, C4);
}

template <typename OutT>
static void dispatch_dense(const void* xq, const void* wq, const float* scale, const float* bias,
                           void* out, ConvGeom g, int C4, cudaStream_t stream) {
  // the model's dense convs have 4, 16, 48 or 128 output channels
  if (g.cout % 16 == 0) launch_dense<16, OutT>(xq, wq, scale, bias, out, g, C4, stream);
  else if (g.cout % 4 == 0) launch_dense<4, OutT>(xq, wq, scale, bias, out, g, C4, stream);
  else launch_dense<1, OutT>(xq, wq, scale, bias, out, g, C4, stream);
}

template <typename OutT>
static void launch_grouped(const void* xq, const void* wq, const float* scale, const float* bias,
                           void* out, ConvGeom g, int Cp, int cin_g, int cout_g,
                           cudaStream_t stream) {
  int8_conv_grouped_kernel<OutT><<<grid_for((long long)g.n * g.ho * g.wo * g.cout),
                                   INT8_THREADS, 0, stream>>>(
      (const int8_t*)xq, (const int8_t*)wq, scale, bias, (OutT*)out, g, Cp, cin_g, cout_g);
}

extern "C" {

// x [P, C] float32 (x_bf16 == 0) or bfloat16 -> q [P, Cp] int8 (Cp = 4 * C4)
int int8_quantize_launch(const void* x, int x_bf16, void* q, long long P, int C, int C4,
                         float s_in, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = grid_for(P * C4);
  if (x_bf16)
    int8_quantize_kernel<__nv_bfloat16><<<grid, INT8_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (int*)q, P, C, C4, s_in);
  else
    int8_quantize_kernel<float><<<grid, INT8_THREADS, 0, s>>>((const float*)x, (int*)q, P, C,
                                                              C4, s_in);
  return (int)cudaGetLastError();
}

// out_kind: 0 float32, 1 bfloat16, 2 the int32 accumulators. groups == 1
// takes wq as [Cout, KH, KW, Cp] int8; groups > 1 as [Cout, Cin/groups, KH, KW].
int int8_conv_launch(const void* xq, const void* wq, const float* scale, const float* bias,
                     void* out, int out_kind, int n, int h, int w, int Cp, int ho, int wo,
                     int cout, int cin_g, int groups, int kh, int kw, int sh, int sw, int ph,
                     int pw, int dh, int dw, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const ConvGeom g{n, h, w, ho, wo, cout, kh, kw, sh, sw, ph, pw, dh, dw};
  if (groups == 1) {
    const int C4 = Cp / 4;
    if (out_kind == 0) dispatch_dense<float>(xq, wq, scale, bias, out, g, C4, s);
    else if (out_kind == 1) dispatch_dense<__nv_bfloat16>(xq, wq, scale, bias, out, g, C4, s);
    else dispatch_dense<int>(xq, wq, scale, bias, out, g, C4, s);
  } else {
    const int cout_g = cout / groups;
    if (out_kind == 0) launch_grouped<float>(xq, wq, scale, bias, out, g, Cp, cin_g, cout_g, s);
    else if (out_kind == 1)
      launch_grouped<__nv_bfloat16>(xq, wq, scale, bias, out, g, Cp, cin_g, cout_g, s);
    else launch_grouped<int>(xq, wq, scale, bias, out, g, Cp, cin_g, cout_g, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
