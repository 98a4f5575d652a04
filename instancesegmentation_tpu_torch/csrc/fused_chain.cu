// Fused bottleneck-chain kernel for Hopper (sm_90a), inference only.
//
// Replaces the Pallas TPU kernel instancesegmentation_tpu/ops/fused_chain.py:
// fused_chain (and, as a one-block chain, ops/fused_block.py:
// bottleneck3x3_fused).  It runs a chain of BN-folded residual bottleneck
// blocks -- 1x1 convs with bias + PReLU/ReLU, masked depthwise taps,
// residual adds with an optional 1x1 projection, and the concat with the
// chain input -- for one image per CTA, walking an instruction table that
// ops/fused_chain.py:compile_chain builds once per weight assignment.
//
// What bounds it on the card.  At the serving shapes the chain is mostly
// 1x1 products (s23 at 30x30x128: ~322 MFLOP per image against ~0.46 MB of
// bf16 chain I/O), so the bound is the tensor-core rate; this kernel does
// its products as float32 FMAs on the CUDA cores, so it is capped near the
// 67 TFLOP/s FP32 rate instead, and it is further limited by the traffic
// of its per-op intermediates.
//
// What the design does about it.  The TPU kernel keeps a whole
// [rows, C] tile in VMEM; one image's s23 activation is 461 KB in float32
// (922 KB for the 256-channel concat), above the 227 KB a block may hold in
// shared memory, and the chain's 10-px receptive-field halo per section rules
// out cheap spatial tiling at 30x30.  So each CTA owns one image, keeps its
// intermediates in a global float32 scratch (in L2 as far as it fits), stages
// each 1x1 weight matrix in shared memory, computes 4-pixel x 4-channel
// register tiles with float32 accumulation, and synchronises the block
// between ops.  The chain input is read once and the output written once, in
// the caller's dtype.  wgmma, TMA and shared-memory activation tiling are
// left for a later version.
//
// Depthwise taps follow the TPU kernel's rule: a tap at (dy, dx) reads
// in[y+dy, x+dx] when that coordinate is inside the image, zero otherwise.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC; bound with ctypes through fused_chain_launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// keep in step with ops/fused_chain.py
enum { OP_LOAD = 0, OP_STORE = 1, OP_MATMUL = 2, OP_DW = 3, OP_CONCAT = 4 };
enum { ACT_NONE = 0, ACT_PRELU = 1, ACT_RELU = 2 };
// row: op, src, dst, cin, cout, w_off, b_off, act, alpha_off, add, ntaps, taps_off
#define FC_ROW 12
#define FC_THREADS 512

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float act_apply(float v, int act, const float* __restrict__ alpha, int c) {
  if (act == ACT_PRELU) return v >= 0.f ? v : alpha[c] * v;
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  return v;
}

// dst[p, :co] = act(src[p, :ci] @ W[ci, co] + b [+ add[p, :co]])
__device__ void op_matmul(const float* __restrict__ src, float* __restrict__ dst,
                          const float* __restrict__ add, const float* __restrict__ wg,
                          const float* __restrict__ bias, const float* __restrict__ alpha,
                          int act, int ci, int co, int hw, float* smem) {
  for (int e = threadIdx.x; e < ci * co; e += blockDim.x) smem[e] = wg[e];
  __syncthreads();
  const int cg = co >> 2;
  const int tiles = ((hw + 3) >> 2) * cg;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int c0 = (t % cg) << 2;
    const int p0 = (t / cg) << 2;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
    const float* rows[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) rows[j] = src + (size_t)min(p0 + j, hw - 1) * ci;
    for (int k = 0; k < ci; k += 4) {
      float4 wv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wv[kk] = *reinterpret_cast<const float4*>(smem + (k + kk) * co + c0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(rows[j] + k);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[j][0] = fmaf(xs[kk], wv[kk].x, acc[j][0]);
          acc[j][1] = fmaf(xs[kk], wv[kk].y, acc[j][1]);
          acc[j][2] = fmaf(xs[kk], wv[kk].z, acc[j][2]);
          acc[j][3] = fmaf(xs[kk], wv[kk].w, acc[j][3]);
        }
      }
    }
    const float4 bv = *reinterpret_cast<const float4*>(bias + c0);
    const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + j;
      if (p >= hw) break;
      float v[4];
      float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
      if (add) av = *reinterpret_cast<const float4*>(add + (size_t)p * co + c0);
      const float as[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float s = acc[j][k] + bs[k];
        if (add) s += as[k];
        v[k] = act_apply(s, act, alpha, c0 + k);
      }
      *reinterpret_cast<float4*>(dst + (size_t)p * co + c0) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// dst[y, x, c] = act(b[c] + sum_t valid(y+dy_t, x+dx_t) * src[y+dy_t, x+dx_t, c] * w[t, c])
__device__ void op_dw(const float* __restrict__ src, float* __restrict__ dst,
                      const float* __restrict__ wg, const float* __restrict__ bias,
                      const float* __restrict__ alpha, int act, int c, int ntaps,
                      const int* __restrict__ taps, int h, int w) {
  const int c4n = c >> 2;
  const int total = h * w * c4n;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  const float4* w4 = reinterpret_cast<const float4*>(wg);
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c4 = e % c4n;
    const int p = e / c4n;
    const int y = p / w, x = p - (p / w) * w;
    float4 acc = reinterpret_cast<const float4*>(bias)[c4];
    for (int t = 0; t < ntaps; ++t) {
      const int yy = y + taps[2 * t], xx = x + taps[2 * t + 1];
      if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
        const float4 v = src4[(size_t)(yy * w + xx) * c4n + c4];
        const float4 k = w4[t * c4n + c4];
        acc.x = fmaf(v.x, k.x, acc.x);
        acc.y = fmaf(v.y, k.y, acc.y);
        acc.z = fmaf(v.z, k.z, acc.z);
        acc.w = fmaf(v.w, k.w, acc.w);
      }
    }
    const int c0 = c4 << 2;
    dst4[e] = make_float4(act_apply(acc.x, act, alpha, c0), act_apply(acc.y, act, alpha, c0 + 1),
                          act_apply(acc.z, act, alpha, c0 + 2), act_apply(acc.w, act, alpha, c0 + 3));
  }
}

template <typename T>
__global__ void __launch_bounds__(FC_THREADS)
fused_chain_kernel(const T* __restrict__ x, T* __restrict__ out, float* __restrict__ scratch,
                   const float* __restrict__ wts, const int* __restrict__ table, int n_instr,
                   int slots_off, int h, int w, long long per_image) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = blockIdx.x;
  const int hw = h * w;
  float* img = scratch + (size_t)n * per_image;
  const int* slot_base = table + slots_off;
#define SLOT(s) (img + (size_t)slot_base[(s)] * hw)

  for (int i = 0; i < n_instr; ++i) {
    const int* r = table + i * FC_ROW;
    const int op = r[0];
    const float* alpha = r[8] >= 0 ? wts + r[8] : nullptr;
    if (op == OP_LOAD) {
      const int c = r[4];
      const T* src = x + (size_t)n * hw * c;
      float* dst = SLOT(r[2]);
      for (int e = threadIdx.x; e < hw * c; e += blockDim.x) dst[e] = to_f32(src[e]);
    } else if (op == OP_STORE) {
      const int c = r[3];
      const float* src = SLOT(r[1]);
      T* dst = out + (size_t)n * hw * c;
      for (int e = threadIdx.x; e < hw * c; e += blockDim.x) dst[e] = from_f32<T>(src[e]);
    } else if (op == OP_MATMUL) {
      op_matmul(SLOT(r[1]), SLOT(r[2]), r[9] >= 0 ? SLOT(r[9]) : nullptr, wts + r[5], wts + r[6],
                alpha, r[7], r[3], r[4], hw, smem);
    } else if (op == OP_DW) {
      op_dw(SLOT(r[1]), SLOT(r[2]), wts + r[5], wts + r[6], alpha, r[7], r[3], r[10],
            table + r[11], h, w);
    } else if (op == OP_CONCAT) {
      const int ca = r[3], ct = r[4], cb = ct - ca;
      const float* a = SLOT(r[1]);
      const float* b = SLOT(r[9]);
      float* dst = SLOT(r[2]);
      for (int e = threadIdx.x; e < hw * ct; e += blockDim.x) {
        const int p = e / ct, ch = e - (e / ct) * ct;
        dst[e] = ch < ca ? a[(size_t)p * ca + ch] : b[(size_t)p * cb + ch - ca];
      }
    }
    __syncthreads();
  }
#undef SLOT
}

template <typename T>
static int launch(const void* x, void* out, void* scratch, const void* wts, const void* table,
                  int n_instr, int slots_off, int n, int h, int w, long long per_image,
                  int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_chain_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  fused_chain_kernel<T><<<n, FC_THREADS, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<float*>(scratch),
      static_cast<const float*>(wts), static_cast<const int*>(table), n_instr, slots_off, h, w,
      per_image);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int fused_chain_launch(const void* x, void* out, void* scratch, const void* wts,
                                  const void* table, int n_instr, int slots_off, int n, int h,
                                  int w, long long per_image, int dtype, int smem_bytes,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, out, scratch, wts, table, n_instr, slots_off, n, h, w, per_image,
                         smem_bytes, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, out, scratch, wts, table, n_instr, slots_off, n, h, w,
                                 per_image, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
