// Fused bottleneck-chain kernels for Hopper (sm_90a), inference only.
//
// Replace the Pallas TPU kernel instancesegmentation_tpu/ops/fused_chain.py:
// fused_chain (pallas_call at :413; and, as a one-block chain,
// ops/fused_block.py:bottleneck3x3_fused).  A chain of BN-folded residual
// bottleneck blocks: 1x1 convs with bias + PReLU/ReLU, masked depthwise taps
// (3x3 at dilation 1/2/4, (5,1), (1,5); a tap at (dy, dx) reads
// in[y+dy, x+dx] when that coordinate is inside the image, zero otherwise),
// residual adds with an optional 1x1 projection, and the concat with the
// chain input.  Three forms, chosen by ops/fused_chain.py:chain_form.
//
// The banded form (bf16 I/O; fused_chain_banded_kernel).
//   What bounds it: section 1 ([N,60,60,48], four 48->16->48 blocks) does
//   ~0.05 GFLOP per image against 0.69 MB of bf16 I/O: the bytes bound it.
//   Sections 2+3 ([N,30,30,128], eleven 128->48->128 blocks and a 256-deep
//   projection) do ~0.32 GFLOP per image against 0.46 MB: the tensor-core
//   rate bounds it.
//   What the design does: one thread-block cluster per image, each CTA
//   owning a band of whole image rows (ops/fused_chain.py:plan_banded picks
//   the smallest cluster whose band fits in 227 KB).  Every activation of the
//   chain lives in the CTAs' shared memory as bf16 [band_px, C] rows with an
//   odd count of 16-byte units per row (no ldmatrix bank conflicts), so the
//   chain input is read from device memory once (cp.async) and the output
//   written once; nothing else but the weights touches device memory.  The
//   1x1 convs run on the tensor cores (mma.sync m16n8k16, bf16 operands,
//   float32 accumulation, A by ldmatrix, each K-tile's fragments loaded one
//   step ahead) with a float32 epilogue (bias, residual in place, PReLU/ReLU,
//   round to bf16).  Their weights come packed in fragment order; each op's
//   parameters are staged into one of two shared-memory slots, op k+1's copy
//   in flight while op k runs.
//   The concat is a second K-segment and bottle3_1's projected residual one
//   product over [y | cur | xin].  Depthwise taps run on the CUDA cores in
//   float32; a tap in another CTA's band reads its shared memory through
//   distributed shared memory.  One cluster barrier before each depthwise
//   op orders its reads after the writes; the plan alternates buffers so
//   that no CTA overwrites rows another may still read before the next
//   barrier.  CTA barriers elsewhere; a last cluster barrier before exit.
//
// The banded float32 form (float32 I/O; fused_chain_banded_f32_kernel).
//   The exact float32 program of the TPU kernel (no TF32).  What bounds it:
//   every product and tap at the 67 TFLOP/s float32 rate of the CUDA cores,
//   ~0.71 ms per batch-128 forward at 480 px against ~0.1 ms of float32 I/O.
//   What the design does: the bf16 form's schedule, from the same planner,
//   over float32 rows (buffers twice the bytes, so clusters of 8 at s1 60^2
//   and 16 at s23 30^2): input read once, output written once, depthwise
//   taps across bands through distributed shared memory.  A 1x1 conv runs in
//   warp tiles of 16 TM rows x 2 TN columns, a thread's TM x TN outputs in
//   registers, both operands float4 loads from shared memory (TM + TN load
//   instructions for 4 TM TN FMAs a k-step), float32 FMAs in K order.  One
//   CTA per SM holds 12 warps, so a product over a narrow band (60 px at
//   s23) waits on load latency more than on the FMA rate; the plan picks TM
//   x TN per product and band (ops/fused_chain.py:_f32_tile).  Weights
//   stream in K-chunks of at most 32 KB through the two parameter slots (a
//   chunk's copy in flight while the one before it runs), the partial sums
//   of a chunked product kept in its output buffer, and the last chunk
//   applying bias, residual and PReLU/ReLU in float32.
//
// The SIMT form (specs no cluster can hold; fused_chain_kernel).  One CTA
// per image walks an instruction table that ops/fused_chain.py:compile_chain
// builds; its intermediates live in a global float32 scratch, the 1x1
// products are 4x4 register tiles of float32 FMAs and the block
// synchronises between ops.  It is the exact float32 form.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC; bound with ctypes through fused_chain_launch and
// fused_chain_banded_launch (both banded forms).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// The banded forms: one cluster per image, activations in shared memory
// ---------------------------------------------------------------------------

// keep in step with ops/fused_chain.py (plan_banded)
enum { FB_MM = 0, FB_DW = 1 };
enum { MM_FIRST = 1, MM_LAST = 2 };
#define FB_ROW 22
#define FB_HDR 16
#define FB_THREADS 384
#define FB_WARPS (FB_THREADS / 32)
#define FB_MAX_CLUSTER 16

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16_u32(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& a0, uint32_t& a1,
                                            uint32_t& a2, uint32_t& a3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
               : "r"(addr)
               : "memory");
}

// c[0..3] += A (16x16, row) * B (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// explicit shared-memory accesses by 32-bit address: .shared for this CTA,
// .shared::cluster (after mapa) for any CTA of the cluster
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ float2 lds_f2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void sts64(uint32_t a, uint2 v) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(a), "r"(v.x), "r"(v.y) : "memory");
}

__device__ __forceinline__ uint2 ldc64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared::cluster.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ float4 ldc128f(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128f(uint32_t a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

// the shared::cluster address of shared::cta address a in CTA `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
  uint32_t v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(v) : "r"(a), "r"(rank));
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(&v));
}

__device__ __forceinline__ float act_f(float v, int act, float alpha) {
  if (act == ACT_PRELU) return v >= 0.f ? v : alpha * v;
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  return v;
}

struct BandMM {  // shared::cta addresses
  int nseg;
  uint32_t seg[3];  // K-segments: buffer base, stride, channels
  int seg_stride[3], seg_ch[3];
  uint32_t dst, add;  // add == 0: no residual
  int dst_stride, add_stride;
  uint32_t wslot;  // B fragments, (k16, n8) tiles k-major; then bias[n], alpha[n]
  uint32_t bias, alpha;
  int act, px, n_tiles;  // n_tiles: n8 tiles of the whole output
};

// dst[p, :] = act(sum_s seg_s[p, :] @ W_s + b [+ add[p, :]]) for the CTA's px
// rows.  A unit of work is a 16-row tile and NT of the output's n8 tiles: its
// bias, slopes and residual are loaded first and each K-tile's fragments one
// step ahead of its products, so their latency overlaps.  dst is never a
// K-segment; a residual add may be dst itself (in place: each value is read
// and written by the same thread).
template <int NT>
__device__ void band_matmul(const BandMM& m) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n_mt = (m.px + 15) >> 4, n_units = n_mt * (m.n_tiles / NT);
  // K-tiles of the segments in order: [0, k0), [k0, k01), [k01, kts)
  const int k0 = m.seg_ch[0] >> 4;
  const int k01 = k0 + (m.nseg > 1 ? m.seg_ch[1] >> 4 : 0);
  const int kts = k01 + (m.nseg > 2 ? m.seg_ch[2] >> 4 : 0);
  const uint32_t b_step = m.n_tiles * 256u;
  for (int u = warp; u < n_units; u += FB_WARPS) {
    const int mt = u % n_mt, n0 = (u / n_mt) * NT;
    const int r0 = mt * 16 + g;
    float2 bv[NT], al[NT];
    uint32_t ad[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = (n0 + j) * 8 + 2 * q;
      bv[j] = lds_f2(m.bias + col * 4u);
      al[j] = m.act == ACT_PRELU ? lds_f2(m.alpha + col * 4u) : make_float2(0.f, 0.f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rr = min(r0 + hh * 8, m.px - 1);
        ad[j][hh] = m.add ? lds32(m.add + (uint32_t)(rr * m.add_stride + col) * 2u) : 0u;
      }
    }
    // rows past the band read its last row; their results are dropped
    const int arow = min(mt * 16 + (lane & 15), m.px - 1);
    const uint32_t acol = (uint32_t)(lane >> 4) * 16u;
    const uint32_t a_seg0 = m.seg[0] + (uint32_t)(arow * m.seg_stride[0]) * 2u + acol;
    const uint32_t a_seg1 = m.seg[1] + (uint32_t)(arow * m.seg_stride[1]) * 2u + acol;
    const uint32_t a_seg2 = m.seg[2] + (uint32_t)(arow * m.seg_stride[2]) * 2u + acol;
    const uint32_t bp = m.wslot + (uint32_t)(n0 * 32 + lane) * 8u;
    auto load = [&](int kt, uint32_t (&a)[4], uint2 (&b)[NT]) {
      const uint32_t at = kt < k0    ? a_seg0 + kt * 32u
                          : kt < k01 ? a_seg1 + (kt - k0) * 32u
                                     : a_seg2 + (kt - k01) * 32u;
      ldmatrix_x4(at, a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) b[j] = lds64(bp + kt * b_step + j * 256u);
    };
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    auto mma = [&](const uint32_t (&a)[4], const uint2 (&b)[NT]) {
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a[0], a[1], a[2], a[3], b[j].x, b[j].y);
    };
    uint32_t a0[4], a1[4];
    uint2 b0[NT], b1[NT];
    load(0, a0, b0);
    int kt = 0;
    for (; kt + 2 <= kts; kt += 2) {
      load(kt + 1, a1, b1);
      mma(a0, b0);
      if (kt + 2 < kts) load(kt + 2, a0, b0);
      mma(a1, b1);
    }
    if (kt < kts) mma(a0, b0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = (n0 + j) * 8 + 2 * q;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rr = r0 + hh * 8;
        if (rr < m.px) {
          float v0 = acc[j][2 * hh] + bv[j].x, v1 = acc[j][2 * hh + 1] + bv[j].y;
          if (m.add) {
            const float2 a = unpack_bf16(ad[j][hh]);
            v0 += a.x;
            v1 += a.y;
          }
          sts32(m.dst + (uint32_t)(rr * m.dst_stride + col) * 2u,
                pack_bf16(act_f(v0, m.act, al[j].x), act_f(v1, m.act, al[j].y)));
        }
      }
    }
  }
}

struct BandMM32 {  // pointers into this CTA's shared memory
  const float* src;  // row 0, column k_off of the chunk's K-segment
  int src_stride;    // floats
  int kc, n;         // the chunk's depth, the output's columns
  float* dst;
  int dst_stride;
  const float* add;  // nullptr: no residual
  int add_stride;
  const float* w;  // the chunk's weights [kc, n]; then bias[n], alpha[n] (last chunk)
  const float* bias;
  const float* alpha;
  int act, px, first, last;
};

// One K-chunk of dst[p, :] = act(src[p, :] @ W + b [+ add[p, :]]) in float32
// for the CTA's px rows, by warp tiles of 16 TM rows x 2 TN columns: lane
// (g, q) = (lane / 2, lane % 2) takes rows g + 16 i (i < TM) and columns
// 4q + 8j .. + 3 (j < TN / 4) of its warp's tile, TM x TN sums in
// registers.  A shared-memory load instruction costs about the same
// whatever the lanes share, so a k-step (4 k) is few of them: TM row float4s
// along k (the 8 lanes of a phase read 4 rows, 4 bank groups apart: odd
// 16-byte-unit strides) and TN weight float4s (contiguous across a phase)
// for 4 TM TN FMAs, all issued before the k-step's FMAs, the next k-step's
// rows while they run.  Sums run in K order from zero (first chunk) or from
// the partial sums dst holds; the last chunk adds bias and residual and
// applies the activation.  dst is never the chunk's K-segment, and a
// residual in place is read and written by the same thread.
template <int TM, int TN>
__device__ __forceinline__ void band_matmul_f32(const BandMM32& m) {
  constexpr int NJ = TN / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 1, q = lane & 1;
  const int row_tiles = (m.px + 16 * TM - 1) / (16 * TM), tiles = row_tiles * (m.n / (2 * TN));
  for (int t = warp; t < tiles; t += FB_WARPS) {
    const int r0 = (t % row_tiles) * 16 * TM + g, c0 = (t / row_tiles) * 2 * TN + 4 * q;
    const float* a[TM];
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      // rows past the band read its last row; their results are dropped
      const int r = min(r0 + 16 * i, m.px - 1);
      a[i] = m.src + r * m.src_stride;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 d = m.first ? make_float4(0.f, 0.f, 0.f, 0.f)
                                 : *reinterpret_cast<const float4*>(m.dst + r * m.dst_stride +
                                                                    c0 + 8 * j);
        acc[i][4 * j] = d.x;
        acc[i][4 * j + 1] = d.y;
        acc[i][4 * j + 2] = d.z;
        acc[i][4 * j + 3] = d.w;
      }
    }
    const float* wp = m.w + c0;
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = *reinterpret_cast<const float4*>(a[i]);
    for (int k = 0; k < m.kc; k += 4) {
      float4 wv[4][NJ];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          wv[kk][j] = *reinterpret_cast<const float4*>(wp + (k + kk) * m.n + 8 * j);
      float as[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        as[i][0] = av[i].x;
        as[i][1] = av[i].y;
        as[i][2] = av[i].z;
        as[i][3] = av[i].w;
      }
      if (k + 4 < m.kc) {
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = *reinterpret_cast<const float4*>(a[i] + k + 4);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            acc[i][4 * j] = fmaf(as[i][kk], wv[kk][j].x, acc[i][4 * j]);
            acc[i][4 * j + 1] = fmaf(as[i][kk], wv[kk][j].y, acc[i][4 * j + 1]);
            acc[i][4 * j + 2] = fmaf(as[i][kk], wv[kk][j].z, acc[i][4 * j + 2]);
            acc[i][4 * j + 3] = fmaf(as[i][kk], wv[kk][j].w, acc[i][4 * j + 3]);
          }
    }
    float bv[TN] = {}, al[TN] = {};
    if (m.last) {
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int col = c0 + (c & 3) + 8 * (c >> 2);
        bv[c] = m.bias[col];
        if (m.act == ACT_PRELU) al[c] = m.alpha[col];
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = r0 + 16 * i;
      if (r >= m.px) break;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[i][4 * j + e];
        if (m.last) {
          float4 ad = make_float4(0.f, 0.f, 0.f, 0.f);
          if (m.add)
            ad = *reinterpret_cast<const float4*>(m.add + r * m.add_stride + c0 + 8 * j);
          const float as4[4] = {ad.x, ad.y, ad.z, ad.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float t = v[e] + bv[4 * j + e];
            if (m.add) t += as4[e];
            v[e] = act_f(t, m.act, al[4 * j + e]);
          }
        }
        *reinterpret_cast<float4*>(m.dst + r * m.dst_stride + c0 + 8 * j) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// four channels of a buffer row: bf16 (8 bytes) or float32 (16 bytes), any
// CTA of the cluster (shared::cluster address) in, this CTA's out
template <typename T> struct Band4;
template <> struct Band4<bf16> {
  static __device__ __forceinline__ float4 load(uint32_t a) {
    const uint2 v = ldc64(a);
    const float2 lo = unpack_bf16(v.x), hi = unpack_bf16(v.y);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ void store(uint32_t a, float4 v) {
    sts64(a, make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w)));
  }
};
template <> struct Band4<float> {
  static __device__ __forceinline__ float4 load(uint32_t a) { return ldc128f(a); }
  static __device__ __forceinline__ void store(uint32_t a, float4 v) { sts128f(a, v); }
};

// dst[p, c] = act(b[c] + sum_t valid_t * src[y+dy_t, x+dx_t, c] * w[t, c]) for
// the CTA's band, 4 channels a thread (FB_THREADS is a multiple of c / 4, so
// a thread keeps its channels and their taps in registers, read from the
// op's parameter slot: taps [ntaps, c], bias, slopes, (dy, dx) pairs).  row_addr[y] is
// the shared::cluster address of image row y of the source: this CTA's
// shared memory or, for a row in another CTA's band, that CTA's (distributed
// shared memory).  Taps are clamped into the image and their loads issued
// together; a tap outside the image then counts zero.
template <int NTAPS, typename T>
__device__ void band_depthwise(uint32_t row_addr, int h, int w, int y0, int px, int src_stride,
                               uint32_t dst, int dst_stride, int c, uint32_t slot,
                               const int* row) {
  const int c4n = c >> 2;
  const int ch = (threadIdx.x % c4n) * 4;
  const int act = row[8];
  int dy[NTAPS], dx[NTAPS];
  float4 k[NTAPS];
#pragma unroll
  for (int t = 0; t < NTAPS; ++t) {
    const uint2 d = lds64(slot + row[5] + 8u * t);
    dy[t] = (int)d.x;
    dx[t] = (int)d.y;
    const uint4 kw = lds128(slot + row[6] + (uint32_t)(t * c + ch) * 4u);
    k[t] = make_float4(__uint_as_float(kw.x), __uint_as_float(kw.y), __uint_as_float(kw.z),
                       __uint_as_float(kw.w));
  }
  const uint4 bw = lds128(slot + row[7] + ch * 4u);
  const float4 b = make_float4(__uint_as_float(bw.x), __uint_as_float(bw.y),
                               __uint_as_float(bw.z), __uint_as_float(bw.w));
  float4 al = make_float4(0.f, 0.f, 0.f, 0.f);
  if (act == ACT_PRELU) {
    const uint4 aw = lds128(slot + row[9] + ch * 4u);
    al = make_float4(__uint_as_float(aw.x), __uint_as_float(aw.y), __uint_as_float(aw.z),
                     __uint_as_float(aw.w));
  }
  for (int p = threadIdx.x / c4n; p < px; p += FB_THREADS / c4n) {
    const int y = y0 + p / w, x = p - (p / w) * w;
    uint32_t ra[NTAPS];
    bool ok[NTAPS];
#pragma unroll
    for (int t = 0; t < NTAPS; ++t) {
      const int yy = y + dy[t], xx = x + dx[t];
      ok[t] = yy >= 0 && yy < h && xx >= 0 && xx < w;
      const int yc = min(max(yy, 0), h - 1), xc = min(max(xx, 0), w - 1);
      ra[t] = lds32(row_addr + 4u * yc) + (uint32_t)((xc * src_stride + ch) * sizeof(T));
    }
    float4 v[NTAPS];
#pragma unroll
    for (int t = 0; t < NTAPS; ++t) v[t] = Band4<T>::load(ra[t]);
    float4 acc = b;
#pragma unroll
    for (int t = 0; t < NTAPS; ++t) {
      if (!ok[t]) continue;
      acc.x = fmaf(v[t].x, k[t].x, acc.x);
      acc.y = fmaf(v[t].y, k[t].y, acc.y);
      acc.z = fmaf(v[t].z, k[t].z, acc.z);
      acc.w = fmaf(v[t].w, k[t].w, acc.w);
    }
    Band4<T>::store(dst + (uint32_t)((p * dst_stride + ch) * sizeof(T)),
                    make_float4(act_f(acc.x, act, al.x), act_f(acc.y, act, al.y),
                                act_f(acc.z, act, al.z), act_f(acc.w, act, al.w)));
  }
}

// stage op `row`'s parameter block into its shared-memory slot (cp.async)
__device__ __forceinline__ void stage_params(uint32_t sbase, const int* row,
                                             const uint4* __restrict__ params, int slot0,
                                             int slot1) {
  const uint32_t dst = sbase + (row[13] ? slot1 : slot0);
  const uint4* src = params + row[11];
  for (int i = threadIdx.x; i < row[12]; i += FB_THREADS) cp_async16_u32(dst + 16u * i, src + i);
}

// the body of both banded kernels, T = bf16 or float: grid n images x
// cluster CTAs, one cluster per image; table and params from
// ops/fused_chain.py:plan_banded
template <typename T>
__device__ __forceinline__ void banded_body(const T* __restrict__ x, T* __restrict__ out,
                                            const int* __restrict__ table,
                                            const uint4* __restrict__ params) {
  constexpr int PER16 = 16 / (int)sizeof(T);  // elements per 16-byte unit
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t sbase = smem_u32(smem);
  const int words = table[9];
  const int* tab = reinterpret_cast<const int*>(smem);  // the table, copied
  for (int i = threadIdx.x; i < words / 4; i += FB_THREADS)
    cp_async16_u32(sbase + 16u * i, reinterpret_cast<const uint4*>(table) + i);
  const int h = table[1], w = table[2], cl = table[3], rows_off = table[10];
  const int ops_off = table[11];
  const int slot0 = table[13], slot1 = table[14];
  const int rank = (int)cluster.block_rank();
  const int img = blockIdx.x / cl;
  const int y0 = table[rows_off + rank], y1 = table[rows_off + rank + 1];
  const int px = (y1 - y0) * w;

  // the chain input, rows y0..y1 of this image, read once; op 0's parameters
  {
    const int c_in = table[6], in_buf = table[4];
    const int c8n = c_in / PER16, st = table[FB_HDR + 2 * in_buf + 1];
    const T* src = x + ((size_t)img * h + y0) * w * c_in;
    const uint32_t dst = sbase + table[FB_HDR + 2 * in_buf];
    for (int e = threadIdx.x; e < px * c8n; e += FB_THREADS) {
      const int p = e / c8n, c8 = e - p * c8n;
      cp_async16_u32(dst + (uint32_t)((p * st + c8 * PER16) * sizeof(T)),
                     src + (size_t)p * c_in + c8 * PER16);
    }
  }
  stage_params(sbase, table + ops_off, params, slot0, slot1);
  cp_async_commit();
  const int n_ops = table[0];
  const int* bufs = tab + FB_HDR;  // (smem offset, stride) per buffer
  const int* s_row_lo = tab + rows_off;
  const int* s_row_rank = s_row_lo + cl + 1;
  uint32_t* s_row_addr = reinterpret_cast<uint32_t*>(smem + table[12]);
  cp_async_wait_all();
  __syncthreads();  // the table copy is read below

  for (int k = 0; k < n_ops; ++k) {
    const int* r = tab + ops_off + k * FB_ROW;
    // op k's parameters have landed and every warp is done with op k - 1; a
    // depthwise op also needs every CTA's source rows written, and nothing it
    // reads is overwritten before the next cluster barrier (the plan picks
    // buffers so)
    cp_async_wait_all();
    if (r[0] == FB_MM)
      __syncthreads();
    else
      cluster.sync();
    // op k + 1's parameters go into the other slot while op k runs
    if (k + 1 < n_ops) {
      stage_params(sbase, r + FB_ROW, params, slot0, slot1);
      cp_async_commit();
    }
    const uint32_t slot = sbase + (r[13] ? slot1 : slot0);
    if constexpr (sizeof(T) == 4) {
      if (r[0] == FB_MM) {
        float* smf = reinterpret_cast<float*>(smem);
        BandMM32 m;
        m.src = smf + bufs[2 * r[2]] / 4 + r[17];
        m.src_stride = bufs[2 * r[2] + 1];
        m.kc = r[3];
        m.n = r[8];
        m.dst = smf + bufs[2 * r[9]] / 4;
        m.dst_stride = bufs[2 * r[9] + 1];
        m.add = r[10] >= 0 ? smf + bufs[2 * r[10]] / 4 : nullptr;
        m.add_stride = r[10] >= 0 ? bufs[2 * r[10] + 1] : 0;
        m.w = smf + (r[13] ? slot1 : slot0) / 4;
        m.bias = m.w + r[14] / 4;
        m.alpha = m.w + r[16] / 4;
        m.act = r[15];
        m.px = px;
        m.first = r[20] & MM_FIRST;
        m.last = r[20] & MM_LAST;
        // rows x columns a thread takes
        const int tile = r[19] * 10 + r[21];
        if (tile == 48)
          band_matmul_f32<4, 8>(m);
        else if (tile == 44)
          band_matmul_f32<4, 4>(m);
        else if (tile == 28)
          band_matmul_f32<2, 8>(m);
        else if (tile == 24)
          band_matmul_f32<2, 4>(m);
        else if (tile == 18)
          band_matmul_f32<1, 8>(m);
        else
          band_matmul_f32<1, 4>(m);
        continue;
      }
    } else if (r[0] == FB_MM) {
      BandMM m;
      m.nseg = r[1];
#pragma unroll
      for (int sg = 0; sg < 3; ++sg) {
        const int bb = sg < m.nseg ? r[2 + 2 * sg] : 0;
        m.seg[sg] = sbase + bufs[2 * bb];
        m.seg_stride[sg] = bufs[2 * bb + 1];
        m.seg_ch[sg] = r[3 + 2 * sg];
      }
      m.dst = sbase + bufs[2 * r[9]];
      m.dst_stride = bufs[2 * r[9] + 1];
      m.add = r[10] >= 0 ? sbase + bufs[2 * r[10]] : 0u;
      m.add_stride = r[10] >= 0 ? bufs[2 * r[10] + 1] : 0;
      m.wslot = slot;
      m.bias = slot + r[14];
      m.alpha = slot + r[16];
      m.act = r[15];
      m.px = px;
      m.n_tiles = r[8] >> 3;
      if (r[19] == 4)  // n8 tiles per unit of work
        band_matmul<4>(m);
      else
        band_matmul<2>(m);
      continue;
    }
    {
      const uint32_t src = sbase + bufs[2 * r[1]];
      const int src_st = bufs[2 * r[1] + 1];
      for (int y = threadIdx.x; y < h; y += FB_THREADS) {
        const int owner = s_row_rank[y];
        const uint32_t row = src + (uint32_t)((y - s_row_lo[owner]) * w * src_st * sizeof(T));
        s_row_addr[y] = owner == rank ? row : mapa(row, owner);
      }
      __syncthreads();
      const uint32_t ra = smem_u32(s_row_addr);
      const uint32_t dst = sbase + bufs[2 * r[2]];
      const int dst_st = bufs[2 * r[2] + 1];
      if (r[4] == 9)
        band_depthwise<9, T>(ra, h, w, y0, px, src_st, dst, dst_st, r[3], slot, r);
      else if (r[4] == 5)
        band_depthwise<5, T>(ra, h, w, y0, px, src_st, dst, dst_st, r[3], slot, r);
      else
        __trap();
    }
  }
  __syncthreads();
  {
    const int c_out = tab[7], out_buf = tab[5];
    const int c8n = c_out / PER16, st = bufs[2 * out_buf + 1];
    const uint32_t src = sbase + bufs[2 * out_buf];
    T* dst = out + ((size_t)img * h + y0) * w * c_out;
    for (int e = threadIdx.x; e < px * c8n; e += FB_THREADS) {
      const int p = e / c8n, c8 = e - p * c8n;
      *reinterpret_cast<uint4*>(dst + (size_t)p * c_out + c8 * PER16) =
          lds128(src + (uint32_t)((p * st + c8 * PER16) * sizeof(T)));
    }
  }
  // other CTAs may still read this CTA's rows in the last depthwise op
  cluster.sync();
}

__global__ void __launch_bounds__(FB_THREADS, 1)
fused_chain_banded_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                          const int* __restrict__ table, const uint4* __restrict__ params) {
  banded_body<bf16>(x, out, table, params);
}

__global__ void __launch_bounds__(FB_THREADS, 1)
fused_chain_banded_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                              const int* __restrict__ table, const uint4* __restrict__ params) {
  banded_body<float>(x, out, table, params);
}

// dtype: 0 = float32, 1 = bfloat16 (as fused_chain_launch)
static const void* banded_kernel(int dtype) {
  if (dtype == 0) return (const void*)fused_chain_banded_f32_kernel;
  if (dtype == 1) return (const void*)fused_chain_banded_kernel;
  return nullptr;
}

static cudaError_t banded_config(const void* kernel, int cluster, int smem_bytes,
                                 cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->blockDim = dim3(FB_THREADS);
  cfg->dynamicSmemBytes = smem_bytes;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// x, out [n, h, w, c] of dtype (0 = float32, 1 = bfloat16); n clusters of
// `cluster` CTAs.  Returns a cudaError_t (0 on success).
extern "C" int fused_chain_banded_launch(const void* x, void* out, const void* table,
                                         const void* params, int n, int cluster,
                                         int smem_bytes, int dtype, void* stream) {
  const void* kernel = banded_kernel(dtype);
  if (kernel == nullptr || n < 1 || cluster < 1 || cluster > FB_MAX_CLUSTER ||
      (long long)n * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = banded_config(kernel, cluster, smem_bytes, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(n * cluster);
  cfg.stream = static_cast<cudaStream_t>(stream);
  void* args[] = {(void*)&x, (void*)&out, (void*)&table, (void*)&params};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// clusters of this size and shared memory that can be resident at once
extern "C" int fused_chain_banded_occupancy(int cluster, int smem_bytes, int dtype,
                                            int* clusters) {
  const void* kernel = banded_kernel(dtype);
  if (kernel == nullptr || cluster < 1 || cluster > FB_MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = banded_config(kernel, cluster, smem_bytes, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(cluster);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}
