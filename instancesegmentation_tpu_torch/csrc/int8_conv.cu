// int8 post-training-quantised convolution for Hopper (sm_90a), NHWC: one
// launch per conv, the quantise fused into the conv's own loads.
//
// Counterpart of the JAX package's int8 conv (models/layers.py:_Int8Conv):
// XLA's s8 x s8 -> s32 conv there (layers.py:126-135) and the quantise /
// dequantise around it (layers.py:146-156). It replaces no Pallas kernel; no
// library int8 call on the card takes every conv the model quantises
// (depthwise 3x3 with dilations 1, 2 and 4, grouped (5,1) and (1,5), input
// widths 3, 19, 35, 52, a 3x3 conv with 4 output channels).
//
// Arithmetic (bit-equal to ops/int8_conv.py:int8_conv_reference):
//   q = clip(rint(x / s_in), -127, 127): a true division (__fdiv_rn; a
//   multiplication by 1 / s_in moves some values across a .5 boundary),
//   rounded half to even (__float2int_rn); zero padding is the quantised 0;
//   the int32 accumulation is exact (|acc| <= K * 127^2 < 2^24 for K <= 1040,
//   so (float)acc is exact too); the epilogue is
//   __fadd_rn(__fmul_rn((float)acc, scale[c]), bias[c]), two roundings as in
//   the plain version (nvcc would contract them into one FMA), then the cast
//   to the output type. Output kind 2 writes the raw int32 accumulators.
//
// What bounds it on the card: bytes. Reading the float input once and
// writing the output once takes longer than the multiply-adds on the int8
// tensor cores for every conv of the model (the stem at 480 px, batch 128:
// 1.18 GB of bf16 input against 59 G multiply-adds). The design therefore
// moves each float once and keeps the int8 tensor out of device memory:
//
// - A block owns a tile of TH x TW output pixels of one image and every
//   output channel; the grid is persistent (as many blocks as the card
//   holds, 2 per SM at most, each taking tiles blockIdx.x, + gridDim.x,
//   ...; the plan sizes it from the card's SM count), so the weights
//   reach shared memory once per block. Per tile it reads the float input
//   and its halo once, 4 channels per thread at a time (one 8-byte bf16 or
//   16-byte float32 vector load where C % 4 == 0), two batches of 64 bytes
//   a thread in flight (32 for the 16 N tiles' kernels, whose accumulators
//   take the registers), one loading while the other is quantised in
//   registers, and stores one int8 word per 4 channels into shared memory
//   ([IR][IC][PP] words; channels past C and pixels outside the image are
//   0). No int8 tensor is written to device memory, and the conv is one
//   launch. A neighbour's halo is read again, mostly from L2; the plan
//   picks the tile of least estimated work (halo words, ragged pixels).
// - The quantise: x * (1 / s_in), clipped, rounded half to even by adding
//   1.5 * 2^23, with no division and no float-to-int conversion (both run
//   at a quarter of the rate); a value within 2^-12 of a .5 (or NaN)
//   takes the exact __fdiv_rn path instead, so the result is the true
//   division's (quantize4).
// - groups == 1 (int8_conv_dense_kernel): an implicit GEMM on the int8
//   tensor cores, mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. M is the
//   tile's pixels (16 per m-tile, TW a multiple of 16), N the output
//   channels padded to 8 * NT (4..128 in the model), K = KH * KW * Cp
//   ordered (ky, kx, c) with Cp = C rounded up to 4 and the whole of K
//   zero-padded to a multiple of 32 (the stem: 5 * 5 * 20 = 500 -> 512).
//   Every A register is one 32-bit shared-memory load: 4 consecutive k are 4
//   channels of one tap, one word of the tile, at the pixel's base plus the
//   word offset of (ky, kx, c4) (a table in shared memory). PP, the words per
//   pixel, is C4 rounded up until PP * sw = 4 (mod 8), so that the 8 pixels
//   of a fragment's rows fall in distinct banks. The weights are packed
//   once on the host (ops/int8_conv.py:pack_weights) in fragment order,
//   [K/32][NT][32 lanes][2 words]: a B fragment is one 8-byte load, shared
//   by the MT m-tiles a warp holds. A conv wider than 128 outputs runs in
//   slices of 128 channels (the WIDE instantiations, NT = 16, the weights
//   packed slice after slice): a slice is one more index of the persistent
//   grid's tiles, the slowest, so that a block reloads its weights only
//   where its slice changes; each slice loads and quantises its input tile
//   again (mostly from L2). Without WIDE the kernel is the one-slice form,
//   unchanged for the model's convs (4..128 outputs). mma.sync and not wgmma: N is only
//   4..128 and A is a gather from the quantised tile, which wgmma cannot
//   read (its A comes from registers in the warpgroup layout or from a
//   dense shared-memory matrix); the work is far below the tensor cores'
//   rate (the bound is bytes), so the simpler instruction costs nothing the
//   bound can see. The epilogue stages each m-tile's 16 pixels in shared
//   memory and writes them as up-to-16-byte coalesced stores.
// - groups > 1 (int8_conv_grouped_kernel): no reduction across channels, so
//   no tensor cores. A thread owns one word of 4 consecutive output channels
//   and a run of I8_RUN output pixels of one row; depthwise convs read one
//   packed word per tap and pixel and do int32 multiply-adds on its bytes
//   (weights [taps][cin_g][Cout/4] words in shared memory); other grouped
//   convs read bytes. Stores are one 4-channel vector per pixel.
//
// What binds it now (PERF.md): not bytes. The stem runs at 3.2x its bound
// (chip_smoke.py's device time). A block loads and quantises a tile, then
// convolves it, so the two phases add up rather than overlap; no per-phase
// profile of the card was taken. Warps specialised to load and to convolve
// (the MMA of one tile beside the loads of the next), a rolling window of
// rows (no halo loaded twice), and the quantise fused into the producer's
// epilogue are the next steps.
//
// The tile plan (TH, TW, IR, IC, PP, padded K and N, dynamic shared memory,
// the grid) is computed on the host by ops/int8_conv.py:plan; the launch
// checks it against this file's layout and sets
// cudaFuncAttributeMaxDynamicSharedMemorySize above 48 KB.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC); bound with ctypes through int8_conv_launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define I8_THREADS 256
#define I8_WARPS (I8_THREADS / 32)
#define I8_BLOCKS_PER_SM 2
#define I8_RUN 4
#define I8_GEOM_INTS 32
#define I8_PLAN_MISMATCH 1000
#define I8_MAX_DEVICES 16

// the launch's geometry and tile plan, in the order ops/int8_conv.py:plan
// passes them (I8_GEOM_INTS ints), then s_in
struct I8Geom {
  int form;                    // 0 dense, 1 grouped
  int n, h, w, c, c4;          // input [N, H, W, C]; C4 = ceil(C / 4) words
  int ho, wo, cout;            // output [N, Ho, Wo, Cout]
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int cin_g, cout_g;           // channels per group
  int th, tw;                  // a block's output tile
  int ir, ic, pp;              // its input tile: rows, columns, words per pixel
  int kp, np;                  // dense: padded K and N (all slices); grouped: taps, Cout/4 words
  int tiles_y, tiles_x;
  int pitch;                   // dense: bytes per staged pixel
  int smem;                    // dynamic shared memory, bytes
  int blocks;                  // the persistent grid (the plan's, for the card's SMs)
  int vec;                     // 4 channels load as one aligned vector
  float s_in;
};
static_assert(offsetof(I8Geom, s_in) == I8_GEOM_INTS * sizeof(int), "I8Geom: ints, then s_in");

__device__ __forceinline__ int quantize(float v, float s_in) {
  const int q = __float2int_rn(__fdiv_rn(v, s_in));
  return min(max(q, -127), 127);
}

__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// 1.5 * 2^23: y + I8_MAGIC rounds y half to even into the low mantissa bits,
// whose low byte is then rint(y) as a two's-complement byte
#define I8_MAGIC 12582912.0f

// floor(j / d) for 0 <= j < 2^22 and a small d, with inv = 1.0f / d: the
// product is within (j + 0.5) * 2^-23 / d of (j + 0.5) / d, which is at
// least 0.5 / d away from an integer
__device__ __forceinline__ int div_small(int j, float inv) {
  return __float2int_rz(__fmul_rn((float)j + 0.5f, inv));
}

// NaN-propagating min and max (PTX .NaN, sm_80 and later)
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float fmin_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Four values quantised into one word, channel 0 in the low byte. The fast
// path multiplies by rs = 1 / s_in, clips and rounds with I8_MAGIC (no
// division, no float-to-int conversion: both quarter-rate); it differs from
// rint(x / s_in) only where y = x * rs lies within 2^-14.4 of a .5 (|y| <
// 256: rs and the product each round once; beyond, both clip), so a value
// within 2^-12 of a .5, or a NaN, takes the exact division instead, alone
// (a warp pays one division for each such value of its lanes).
__device__ __forceinline__ unsigned quantize4(const float (&v)[4], float s_in, float rs) {
  int m[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float y = fmin_nan(fmax_nan(__fmul_rn(v[k], rs), -127.f), 127.f);
    const float r = __fadd_rn(y, I8_MAGIC);
    m[k] = __float_as_int(r);
    const float f = fabsf(__fsub_rn(y, __fsub_rn(r, I8_MAGIC)));
    if (!(f < 0.5f - 0x1p-12f)) m[k] = quantize(v[k], s_in);
  }
  return pack4(m[0], m[1], m[2], m[3]);
}

// 4 channels as loaded, held until they are quantised: float32 as float4,
// bfloat16 as their bits in a uint2; `words` is how many a thread keeps in
// flight per batch (64 bytes either way)
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using type = float4;
  static constexpr int words = 4;
};
template <>
struct Raw<__nv_bfloat16> {
  using type = uint2;
  static constexpr int words = 8;
};

__device__ __forceinline__ float4 load4(const float* __restrict__ x, int e, int c, int C,
                                        bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(x + e));
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = c + k < C ? __ldg(x + e + k) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint2 load4(const __nv_bfloat16* __restrict__ x, int e, int c, int C,
                                       bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint2*>(x + e));
  const unsigned short* b = reinterpret_cast<const unsigned short*>(x + e);
  unsigned h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = c + k < C ? __ldg(b + k) : 0u;
  return make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
}

__device__ __forceinline__ void unpack4(float4 r, float (&v)[4]) {
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void unpack4(uint2 r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x << 16); v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16); v[3] = __uint_as_float(r.y & 0xffff0000u);
}

// A thread's place in the tile loader's walk over the tile's words in
// (row, column, channel word) order: each word it takes is I8_THREADS
// words after its last, `step` apart in (rows, columns, words).
struct TileWalk {
  int r, col, c4;
};

// One batch of the walk: U words, their 4 channels each loaded into r[u]
// (0 outside the image or past C), their word in shared memory in 16-bit
// halves of dst (I8_NO_WORD past the tile; a tile has fewer than 2^16 - 1
// words). xn is image n's first element.
#define I8_NO_WORD 0xffffu
template <typename T, int U>
__device__ __forceinline__ void fetch(const T* __restrict__ xn, const I8Geom& g, int iy0, int ix0,
                                      const int (&step)[3], TileWalk& p,
                                      typename Raw<T>::type (&r)[U], unsigned (&dst)[U / 2]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in_tile = p.r < g.ir;
    const unsigned word = in_tile ? (p.r * g.ic + p.col) * g.pp + p.c4 : I8_NO_WORD;
    dst[u / 2] = u % 2 ? dst[u / 2] | word << 16 : word;
    const int iy = iy0 + p.r, ix = ix0 + p.col;
    r[u] = {};
    if (in_tile && (unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.w)
      r[u] = load4(xn, (iy * g.w + ix) * g.c + 4 * p.c4, 4 * p.c4, g.c, g.vec != 0);
    p.c4 += step[2];
    int carry = p.c4 >= g.c4;
    p.c4 -= carry ? g.c4 : 0;
    p.col += step[1] + carry;
    carry = p.col >= g.ic;
    p.col -= carry ? g.ic : 0;
    p.r += step[0] + carry;
  }
}

template <typename R, int U>
__device__ __forceinline__ void quantize_batch(unsigned* xs, const I8Geom& g, float rs,
                                               const R (&r)[U], const unsigned (&dst)[U / 2]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const unsigned word = dst[u / 2] >> (16 * (u % 2)) & 0xffffu;
    if (word != I8_NO_WORD) {
      float v[4];
      unpack4(r[u], v);
      xs[word] = quantize4(v, g.s_in, rs);
    }
  }
}

// The block's input tile, quantised: xs[(r * IC + col) * PP + c4] holds
// channels 4 c4 .. 4 c4 + 3 of input pixel (iy0 + r, ix0 + col) of image n.
// Two batches of U loads alternate, so that one is in flight while the
// other is quantised.
template <typename T, int U>
__device__ void load_tile(const T* __restrict__ x, unsigned* xs, const I8Geom& g, int n, int iy0,
                          int ix0) {
  const T* xn = x + (long long)n * g.h * g.w * g.c;
  const float rs = __frcp_rn(g.s_in);
  const int per_row = g.ic * g.c4, t = threadIdx.x;
  const int step[3] = {I8_THREADS / per_row, I8_THREADS % per_row / g.c4, I8_THREADS % g.c4};
  TileWalk p{t / per_row, t % per_row / g.c4, t % g.c4};
  typename Raw<T>::type ra[U], rb[U];
  unsigned da[U / 2], db[U / 2];
  fetch(xn, g, iy0, ix0, step, p, ra, da);
  while (true) {
    if (p.r >= g.ir) {
      quantize_batch(xs, g, rs, ra, da);
      break;
    }
    fetch(xn, g, iy0, ix0, step, p, rb, db);
    quantize_batch(xs, g, rs, ra, da);
    if (p.r >= g.ir) {
      quantize_batch(xs, g, rs, rb, db);
      break;
    }
    fetch(xn, g, iy0, ix0, step, p, ra, da);
    quantize_batch(xs, g, rs, rb, db);
  }
}

__device__ __forceinline__ float epilogue(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}
__device__ __forceinline__ void put(float* p, int acc, float s, float b) {
  *p = epilogue(acc, s, b);
}
__device__ __forceinline__ void put(__nv_bfloat16* p, int acc, float s, float b) {
  *p = __float2bfloat16_rn(epilogue(acc, s, b));
}
__device__ __forceinline__ void put(int* p, int acc, float, float) { *p = acc; }

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// copy `bytes` from shared to global memory in units of `unit` bytes (both
// addresses aligned to it), lanes on consecutive units
__device__ __forceinline__ void copy_unit(const unsigned char* src, unsigned char* dst,
                                          int unit) {
  if (unit == 16) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  else if (unit == 8) *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  else if (unit == 4) *reinterpret_cast<unsigned*>(dst) = *reinterpret_cast<const unsigned*>(src);
  else *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(src);
}

// Dense layout of dynamic shared memory, in bytes, for a slice of Ns = 8 NT
// output channels (Ns = Np up to 128 outputs, else 128):
//   [Kp * Ns]  B fragments [Kp / 32][NT][32][2 words]
//   [Kp]       word offsets of (ky, kx, c4) in the tile [Kp / 4] ints
//   [8 * Ns]   scale, bias [Ns] floats
//   [I8_WARPS * 16 * pitch]  each warp's staged m-tile
//   [IR * IC * PP * 4]       the quantised input tile
__host__ __device__ inline int dense_smem_bytes(int kp, int ns, int pitch, int ir, int ic,
                                                int pp) {
  return kp * ns + kp + 8 * ns + I8_WARPS * 16 * pitch + ir * ic * pp * 4;
}
#define I8_SLICE 128

// Two blocks per SM (128 registers a thread; ops/int8_conv.py:BLOCKS_PER_SM
// sizes the tiles' shared memory for as many): measured as fast as three at
// 80 registers, which spill. WIDE: slices of NS = 8 NT = 128 output channels
// (g.np a multiple of 128); otherwise one slice of all g.np channels.
template <typename T, typename OutT, int NT, int MT, bool WIDE>
__global__ void __launch_bounds__(I8_THREADS, I8_BLOCKS_PER_SM)
int8_conv_dense_kernel(const T* __restrict__ x, const uint4* __restrict__ wfrag,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       OutT* __restrict__ out, const I8Geom g) {
  constexpr int NS = 8 * NT;
  const int ns = WIDE ? NS : g.np;  // the channels shared memory holds
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* ws = reinterpret_cast<uint2*>(smem);
  int* woff = reinterpret_cast<int*>(smem + g.kp * ns);
  float* ssc = reinterpret_cast<float*>(smem + g.kp * ns + g.kp);
  float* sbi = ssc + ns;
  unsigned char* stage = reinterpret_cast<unsigned char*>(sbi + ns);
  unsigned* xs = reinterpret_cast<unsigned*>(stage + I8_WARPS * 16 * g.pitch);

  uint4* wdst = reinterpret_cast<uint4*>(ws);
  if (!WIDE)
    for (int i = threadIdx.x; i < g.kp * g.np / 16; i += I8_THREADS) wdst[i] = __ldg(wfrag + i);
  const int taps = g.kh * g.kw;
  for (int i = threadIdx.x; i < g.kp / 4; i += I8_THREADS) {
    const int tap = i / g.c4, c4 = i - tap * g.c4;
    woff[i] = tap < taps ? ((tap / g.kw) * g.dh * g.ic + (tap % g.kw) * g.dw) * g.pp + c4 : 0;
  }
  if (!WIDE) {
    for (int i = threadIdx.x; i < g.np; i += I8_THREADS) {
      ssc[i] = i < g.cout ? scale[i] : 0.f;
      sbi[i] = i < g.cout ? bias[i] : 0.f;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mtiles = g.th * g.tw / 16, ksteps = g.kp / 32;
  const float inv_tw = 1.f / (float)g.tw;
  unsigned char* st = stage + warp * 16 * g.pitch;
  const int bpp = g.cout * (int)sizeof(OutT);
  const int unit = bpp % 16 == 0 ? 16 : bpp % 8 == 0 ? 8 : bpp % 4 == 0 ? 4 : 2;
  const int upp = bpp / unit;
  const float inv_upp = 1.f / (float)upp;
  // WIDE: the slice's first channel and channels, and its copy unit, which
  // divides the pixel's bytes, the slice's and the slice's offset
  int c0 = 0, cn = 0, s_unit = 0, s_upp = 0;
  float s_inv_upp = 0.f;

  // persistent: the block takes tiles blockIdx.x, + gridDim.x, ... of
  // (slice, image, tile row, tile column)
  const int spatial = g.n * g.tiles_y * g.tiles_x;
  const int tiles = WIDE ? spatial * (g.np / NS) : spatial;
  int loaded = -1;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int slice = WIDE ? tile / spatial : 0;
    const int sp = WIDE ? tile - slice * spatial : tile;
    const int tx = sp % g.tiles_x;
    const int ty = sp / g.tiles_x % g.tiles_y;
    const int n = sp / g.tiles_x / g.tiles_y;
    const int oy0 = ty * g.th, ox0 = tx * g.tw;
    if (WIDE && slice != loaded) {  // the slice's weights, scale and bias (the last tile is read)
      const uint4* wsrc = wfrag + (long long)slice * (g.kp * NS / 16);
      for (int i = threadIdx.x; i < g.kp * NS / 16; i += I8_THREADS) wdst[i] = __ldg(wsrc + i);
      c0 = slice * NS;
      cn = min(NS, g.cout - c0);
      for (int i = threadIdx.x; i < NS; i += I8_THREADS) {
        ssc[i] = i < cn ? scale[c0 + i] : 0.f;
        sbi[i] = i < cn ? bias[c0 + i] : 0.f;
      }
      const int sbytes = cn * (int)sizeof(OutT);
      const int all = bpp | sbytes | c0 * (int)sizeof(OutT);
      s_unit = all % 16 == 0 ? 16 : all % 8 == 0 ? 8 : all % 4 == 0 ? 4 : 2;
      s_upp = sbytes / s_unit;
      s_inv_upp = 1.f / (float)s_upp;
      loaded = slice;
    }
    // 16 N tiles' 64 accumulators leave room for 4 words in flight a batch
    load_tile<T, (NT >= 16 ? 4 : Raw<T>::words)>(x, xs, g, n, oy0 * g.sh - g.ph,
                                                ox0 * g.sw - g.pw);
    __syncthreads();
    for (int m0 = warp * MT; m0 < mtiles; m0 += I8_WARPS * MT) {
      // the word of each fragment row's pixel: rows gid and gid + 8
      int base[MT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int mt = min(m0 + mi, mtiles - 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = mt * 16 + gid + 8 * h;
          const int r = div_small(p, inv_tw), cc = p - r * g.tw;
          base[mi][h] = (r * g.sh * g.ic + cc * g.sw) * g.pp;
        }
      }
      int acc[MT][NT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[mi][j][k] = 0;
      for (int ks = 0; ks < ksteps; ++ks) {
        const int o0 = woff[ks * 8 + tig], o1 = woff[ks * 8 + 4 + tig];
        unsigned a[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          a[mi][0] = xs[base[mi][0] + o0];
          a[mi][1] = xs[base[mi][1] + o0];
          a[mi][2] = xs[base[mi][0] + o1];
          a[mi][3] = xs[base[mi][1] + o1];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 b = ws[(ks * NT + j) * 32 + lane];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) mma_s8(acc[mi][j], a[mi], b);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int mt = m0 + mi;
        if (mt >= mtiles) break;
        // stage: thread (gid, tig) holds channels 8 j + 2 tig, +1 of pixels
        // gid and gid + 8
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int ch = 8 * j + 2 * tig + (k & 1), row = gid + 8 * (k >> 1);
            if (ch < (WIDE ? cn : g.cout))
              put(reinterpret_cast<OutT*>(st + row * g.pitch) + ch, acc[mi][j][k], ssc[ch],
                  sbi[ch]);
          }
        }
        __syncwarp();
        // the m-tile's 16 pixels are consecutive in one output row (TW % 16
        // == 0); the valid ones are a prefix, their slice's channels
        // contiguous within each pixel (the whole pixel with one slice)
        const int p0 = mt * 16;
        const int r = div_small(p0, inv_tw);
        const int oy = oy0 + r, ox = ox0 + (p0 - r * g.tw);
        const int valid = oy < g.ho ? min(16, g.wo - ox) : 0;
        if (WIDE) {
          unsigned char* dst = reinterpret_cast<unsigned char*>(
              out + (((long long)n * g.ho + oy) * g.wo + ox) * g.cout + c0);
          for (int i = lane; i < valid * s_upp; i += 32) {
            const int px = div_small(i, s_inv_upp), e = i - px * s_upp;
            copy_unit(st + px * g.pitch + e * s_unit, dst + px * bpp + e * s_unit, s_unit);
          }
        } else {
          unsigned char* dst = reinterpret_cast<unsigned char*>(
              out + (((long long)n * g.ho + oy) * g.wo + ox) * g.cout);
          for (int i = lane; i < valid * upp; i += 32) {
            const int px = div_small(i, inv_upp), e = i - px * upp;
            copy_unit(st + px * g.pitch + e * unit, dst + px * bpp + e * unit, unit);
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();  // the tile's words are read: the next tile may overwrite them
  }
}

// Grouped layout of dynamic shared memory, in bytes:
//   [taps * cin_g * CO4 * 4]  weights [KH * KW][cin_g][CO4] words
//   [32 * CO4]                scale, bias [4 * CO4] floats
//   [IR * IC * PP * 4]        the quantised input tile
__host__ __device__ inline int grouped_smem_bytes(int taps, int cin_g, int co4, int ir, int ic,
                                                  int pp) {
  return taps * cin_g * co4 * 4 + 32 * co4 + ir * ic * pp * 4;
}

__device__ __forceinline__ int sbyte(unsigned w, int k) { return (int)(signed char)(w >> (8 * k)); }

__device__ __forceinline__ void put4(float* p, const int (&a)[4], const float* s, const float* b) {
  *reinterpret_cast<float4*>(p) =
      make_float4(epilogue(a[0], s[0], b[0]), epilogue(a[1], s[1], b[1]),
                  epilogue(a[2], s[2], b[2]), epilogue(a[3], s[3], b[3]));
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, const int (&a)[4], const float* s,
                                     const float* b) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(epilogue(a[0], s[0], b[0]), epilogue(a[1], s[1], b[1]));
  __nv_bfloat162 hi = __floats2bfloat162_rn(epilogue(a[2], s[2], b[2]), epilogue(a[3], s[3], b[3]));
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void put4(int* p, const int (&a)[4], const float*, const float*) {
  *reinterpret_cast<int4*>(p) = make_int4(a[0], a[1], a[2], a[3]);
}

template <typename T, typename OutT, bool DW>
__global__ void __launch_bounds__(I8_THREADS, I8_BLOCKS_PER_SM)
int8_conv_grouped_kernel(const T* __restrict__ x, const unsigned* __restrict__ wg,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         OutT* __restrict__ out, const I8Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int taps = g.kp, co4 = g.np;
  unsigned* wsm = reinterpret_cast<unsigned*>(smem);
  float* ssc = reinterpret_cast<float*>(wsm + taps * g.cin_g * co4);
  float* sbi = ssc + 4 * co4;
  unsigned* xs = reinterpret_cast<unsigned*>(sbi + 4 * co4);

  for (int i = threadIdx.x; i < taps * g.cin_g * co4; i += I8_THREADS) wsm[i] = __ldg(wg + i);
  for (int i = threadIdx.x; i < 4 * co4; i += I8_THREADS) {
    ssc[i] = i < g.cout ? scale[i] : 0.f;
    sbi[i] = i < g.cout ? bias[i] : 0.f;
  }
  const signed char* xb = reinterpret_cast<const signed char*>(xs);
  const int runs = (g.tw + I8_RUN - 1) / I8_RUN;
  const int items = g.th * runs * co4;
  // persistent: the block takes tiles blockIdx.x, + gridDim.x, ...
  const int tiles = g.n * g.tiles_y * g.tiles_x;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % g.tiles_x;
    const int ty = tile / g.tiles_x % g.tiles_y;
    const int n = tile / g.tiles_x / g.tiles_y;
    const int oy0 = ty * g.th, ox0 = tx * g.tw;
    load_tile<T, Raw<T>::words>(x, xs, g, n, oy0 * g.sh - g.ph, ox0 * g.sw - g.pw);
    __syncthreads();
    for (int it = threadIdx.x; it < items; it += I8_THREADS) {
      const int cw = it % co4;
      const int rest = it / co4;
      const int run = rest % runs, r = rest / runs;
      const int oy = oy0 + r;
      if (oy >= g.ho) continue;
      const int ox_l = run * I8_RUN;
      int acc[I8_RUN][4];
#pragma unroll
      for (int q = 0; q < I8_RUN; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[q][k] = 0;
      for (int ky = 0; ky < g.kh; ++ky) {
        const int row = (r * g.sh + ky * g.dh) * g.ic;
        for (int kx = 0; kx < g.kw; ++kx) {
          const int tap = ky * g.kw + kx;
          if (DW) {
            const unsigned w = wsm[tap * co4 + cw];
            const int w0 = sbyte(w, 0), w1 = sbyte(w, 1), w2 = sbyte(w, 2), w3 = sbyte(w, 3);
#pragma unroll
            for (int q = 0; q < I8_RUN; ++q) {
              const int col = min(ox_l + q, g.tw - 1) * g.sw + kx * g.dw;
              const unsigned v = xs[(row + col) * g.pp + cw];
              acc[q][0] += sbyte(v, 0) * w0;
              acc[q][1] += sbyte(v, 1) * w1;
              acc[q][2] += sbyte(v, 2) * w2;
              acc[q][3] += sbyte(v, 3) * w3;
            }
          } else {
            for (int ci = 0; ci < g.cin_g; ++ci) {
              const unsigned w = wsm[(tap * g.cin_g + ci) * co4 + cw];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int co = 4 * cw + k;
                if (co >= g.cout) break;
                const int ch = (co / g.cout_g) * g.cin_g + ci;
                const int wk = sbyte(w, k);
#pragma unroll
                for (int q = 0; q < I8_RUN; ++q) {
                  const int col = min(ox_l + q, g.tw - 1) * g.sw + kx * g.dw;
                  acc[q][k] += (int)xb[(row + col) * g.pp * 4 + ch] * wk;
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < I8_RUN; ++q) {
        const int ox = ox0 + ox_l + q;
        if (ox_l + q >= g.tw || ox >= g.wo) break;
        OutT* p = out + (((long long)n * g.ho + oy) * g.wo + ox) * g.cout + 4 * cw;
        if (g.cout % 4 == 0) {
          put4(p, acc[q], ssc + 4 * cw, sbi + 4 * cw);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (4 * cw + k < g.cout) put(p + k, acc[q][k], ssc[4 * cw + k], sbi[4 * cw + k]);
        }
      }
    }
    __syncthreads();  // the tile's words are read: the next tile may overwrite them
  }
}

// opt in above the default 48 KB of dynamic shared memory, once per kernel,
// device and size (`granted`: the instantiation's own record)
template <typename K>
static cudaError_t prepare(K kernel, int smem, int (&granted)[I8_MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem <= 48 * 1024 || (dev < I8_MAX_DEVICES && smem <= granted[dev])) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < I8_MAX_DEVICES) granted[dev] = smem;
  return err;
}

template <typename T, typename OutT, int NT, int MT, bool WIDE = false>
static cudaError_t launch_dense(const void* x, const void* w, const float* scale,
                                const float* bias, void* out, const I8Geom& g, cudaStream_t s) {
  static int granted[I8_MAX_DEVICES] = {};
  auto kernel = int8_conv_dense_kernel<T, OutT, NT, MT, WIDE>;
  cudaError_t err = prepare(kernel, g.smem, granted);
  if (err != cudaSuccess) return err;
  kernel<<<g.blocks, I8_THREADS, g.smem, s>>>(
      (const T*)x, (const uint4*)w, scale, bias, (OutT*)out, g);
  return cudaGetLastError();
}

template <typename T, typename OutT>
static cudaError_t dispatch_dense(const void* x, const void* w, const float* scale,
                                  const float* bias, void* out, const I8Geom& g, cudaStream_t s) {
  // N = 8 NT output channels: the model's 4, 16, 48 and 128 take NT 1, 2, 6
  // and 16, wider convs NT 16 in slices of 128; MT m-tiles per warp share
  // each B fragment and word offset, as many as build without spills
  // (ops/int8_conv.py:DENSE_MT)
  if (g.np > I8_SLICE)
    return g.np % I8_SLICE ? cudaErrorInvalidValue
                           : launch_dense<T, OutT, 16, 1, true>(x, w, scale, bias, out, g, s);
  switch (g.np / 8) {
    case 1: return launch_dense<T, OutT, 1, 4>(x, w, scale, bias, out, g, s);
    case 2: return launch_dense<T, OutT, 2, 2>(x, w, scale, bias, out, g, s);
    case 6: return launch_dense<T, OutT, 6, 2>(x, w, scale, bias, out, g, s);
    case 16: return launch_dense<T, OutT, 16, 1>(x, w, scale, bias, out, g, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename OutT, bool DW>
static cudaError_t launch_grouped(const void* x, const void* w, const float* scale,
                                  const float* bias, void* out, const I8Geom& g, cudaStream_t s) {
  static int granted[I8_MAX_DEVICES] = {};
  auto kernel = int8_conv_grouped_kernel<T, OutT, DW>;
  cudaError_t err = prepare(kernel, g.smem, granted);
  if (err != cudaSuccess) return err;
  kernel<<<g.blocks, I8_THREADS, g.smem, s>>>(
      (const T*)x, (const unsigned*)w, scale, bias, (OutT*)out, g);
  return cudaGetLastError();
}

template <typename T, typename OutT>
static cudaError_t dispatch_grouped(const void* x, const void* w, const float* scale,
                                    const float* bias, void* out, const I8Geom& g,
                                    cudaStream_t s) {
  if (g.cin_g == 1 && g.cout_g == 1)  // depthwise: packed words
    return launch_grouped<T, OutT, true>(x, w, scale, bias, out, g, s);
  return launch_grouped<T, OutT, false>(x, w, scale, bias, out, g, s);
}

template <typename T>
static cudaError_t dispatch(const void* x, const void* w, const float* scale, const float* bias,
                            void* out, int out_kind, const I8Geom& g, cudaStream_t s) {
  if (g.form == 0) {
    if (out_kind == 0) return dispatch_dense<T, float>(x, w, scale, bias, out, g, s);
    if (out_kind == 1) return dispatch_dense<T, __nv_bfloat16>(x, w, scale, bias, out, g, s);
    return dispatch_dense<T, int>(x, w, scale, bias, out, g, s);
  }
  if (out_kind == 0) return dispatch_grouped<T, float>(x, w, scale, bias, out, g, s);
  if (out_kind == 1) return dispatch_grouped<T, __nv_bfloat16>(x, w, scale, bias, out, g, s);
  return dispatch_grouped<T, int>(x, w, scale, bias, out, g, s);
}

extern "C" {

// x [N, H, W, C] float32 (x_bf16 == 0) or bfloat16 -> out [N, Ho, Wo, Cout]
// (out_kind 0 float32, 1 bfloat16, 2 the int32 accumulators). w: the packed
// weights of ops/int8_conv.py:pack_weights; geom: I8_GEOM_INTS ints in
// I8Geom's order. Returns a CUDA error, or I8_PLAN_MISMATCH when the plan's
// shared memory differs from this file's layout.
int int8_conv_launch(const void* x, int x_bf16, const void* w, const float* scale,
                     const float* bias, void* out, int out_kind, const int* geom, float s_in,
                     void* stream) {
  I8Geom g;
  memcpy(&g, geom, I8_GEOM_INTS * sizeof(int));
  g.s_in = s_in;
  const int want = g.form == 0
                       ? dense_smem_bytes(g.kp, min(g.np, I8_SLICE), g.pitch, g.ir, g.ic, g.pp)
                       : grouped_smem_bytes(g.kp, g.cin_g, g.np, g.ir, g.ic, g.pp);
  if (want != g.smem || g.blocks < 1) return I8_PLAN_MISMATCH;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = x_bf16 ? dispatch<__nv_bfloat16>(x, w, scale, bias, out, out_kind, g, s)
                                 : dispatch<float>(x, w, scale, bias, out, out_kind, g, s);
  return (int)err;
}

}  // extern "C"
