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
// not exist; out is NHWC float4 rows, so its stores are coalesced 16-byte
// accesses.
//
// warp_2level (B4) is one tiled launch, and tmp never reaches device
// memory.  A CTA owns one sample and one output tile of tile_u x W2_TILE_V
// pixels.  Pass 2 of the tile reads tmp rows [floor(upos_min) - d2,
// floor(upos_max) + 2 + d2] of its columns only, where upos = m00 * u + m01 *
// block_centre(v) + ky0 is monotone in u and in v (each rounded product and
// sum keeps order), so its extremes lie at the tile's corners.  The CTA runs
// pass 1 for those rows (clipped to the canvas) and its columns into shared
// memory as float4, meets at a block barrier, then runs pass 2 from shared
// memory.  The host plan (ops/warp_2level.py:plan_tiles) sizes the tile and
// the shared rows from the bounds on theta and on the scale; a sample whose
// span outgrows them is split into sub-tiles along u inside the CTA, and a
// one-row sub-tile that still does not fit reads tmp values straight from
// pass1_value, so correctness never depends on a bound.  Only the uint8
// canvas and mask are read and the float32 output written: ~170 MB at
// 32 x 640 -> 480, where the two-launch form moved another ~314 MB of tmp.
//
// warp_2level_fused (B5) is one launch too, of the TPU kernel's other shape:
// tmp (4.9 MB per sample at 640 -> 480) stays in a global scratch, and pass 2
// of a sample needs every row pass 1 wrote for it: one thread-block cluster
// of 8 CTAs per sample runs pass 1, meets at a cluster barrier (after a
// device-scope fence), then runs pass 2 reading tmp through L2 (__ldcg).
// Both forms take tmp values from pass1_value and sum them in pass2_value's
// order, so their outputs are bit-equal.
//
// The per-sample coefficients (computed in the kernel from the warp's
// params), positions, hat and lerp weights and the cut tests use
// round-to-nearest intrinsics in the operation order of the plain version,
// so they are bit-equal to it; only the order of the final sums differs.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC; bound with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define W2_TILE_V 32
#define W2_TILED_THREADS 256
#define W2_CLUSTER 8
#define W2_FUSED_THREADS 512

// per-sample coefficients, the layout of ops/warp_2level.py:coefficients
struct Coefs {
  float ax, bx, cx, lox, hix, m00, m01, ky0, loy, hiy, a_y, b_y, a_x, b_x, canvas_h, canvas_w;
};

struct Geom {
  int h, w, out_h, out_w, block, d1, d2;
};

// torch.clamp_min(x, 0): NaN stays NaN, -0.0 stays -0.0
__device__ __forceinline__ float clamp_min0(float x) { return x < 0.f ? 0.f : x; }

// The coefficients of sample b from the RotWarpParams fields p [8, nb, 2]
// (scale, origin, cos_sin, center, t, src_lo, src_hi, canvas_hw), each a
// rounded float32 operation in the order of ops/warp.py:_affine_terms and
// ops/warp_2level.py:coefficients, so they equal the plain version's bits.
__device__ __forceinline__ Coefs sample_coefs(const float* __restrict__ p, int b, int nb) {
  const float* f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = p + ((size_t)i * nb + b) * 2;
  const float cth = f[2][0], sth = f[2][1], cy = f[3][0], cx = f[3][1];
  Coefs k;
  k.a_y = f[0][0];
  k.a_x = f[0][1];
  k.b_y = __fadd_rn(__fsub_rn(__fmul_rn(0.5f, k.a_y), 0.5f), f[1][0]);
  k.b_x = __fadd_rn(__fsub_rn(__fmul_rn(0.5f, k.a_x), 0.5f), f[1][1]);
  k.m00 = __fmul_rn(cth, k.a_y);
  k.m01 = __fmul_rn(-sth, k.a_x);
  const float m10 = __fmul_rn(sth, k.a_y), m11 = __fmul_rn(cth, k.a_x);
  const float dy = __fsub_rn(k.b_y, cy), dx = __fsub_rn(k.b_x, cx);
  k.ky0 = __fsub_rn(__fsub_rn(__fadd_rn(cy, __fmul_rn(cth, dy)), __fmul_rn(sth, dx)), f[4][0]);
  const float kx0 =
      __fsub_rn(__fadd_rn(__fadd_rn(cx, __fmul_rn(sth, dy)), __fmul_rn(cth, dx)), f[4][1]);
  k.ax = __fsub_rn(m11, __fdiv_rn(__fmul_rn(m10, k.m01), k.m00));
  k.bx = __fdiv_rn(m10, k.m00);
  k.cx = __fsub_rn(kx0, __fdiv_rn(__fmul_rn(m10, k.ky0), k.m00));
  k.lox = clamp_min0(f[5][1]);
  k.hix = f[6][1];
  k.loy = clamp_min0(f[5][0]);
  k.hiy = f[6][0];
  k.canvas_h = f[7][0];
  k.canvas_w = f[7][1];
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

// a uint8 as a float, exactly: (2^23 + b) - 2^23, an integer OR and a float
// subtraction instead of a conversion instruction
__device__ __forceinline__ float u8f(unsigned b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.f);
}

// one content pixel (RGB, mask) as floats; zero outside the image and
// outside the translation cut on x (the row cut is tested by the caller)
__device__ __forceinline__ float4 content(const uint8_t* img_row, const uint8_t* mask_row, int x,
                                          int w, float lox, float hix) {
  if (x < 0 || x >= w || !((float)x >= lox && (float)x < hix)) return make_float4(0.f, 0.f, 0.f, 0.f);
  const uint8_t* p = img_row + 3 * (size_t)x;
  return make_float4(u8f(p[0]), u8f(p[1]), u8f(p[2]), u8f(mask_row[x]));
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

// The two hat taps at pos: taps y0 = floor(pos) and y0 + 1 with their
// weights, used where the tap lies in [0, n) and weighs something.  Tap t
// lerps inputs (y0 + k0 + t, y0 + k0 + t + 1), so a value reads three
// inputs, each loaded once and only where a tap uses it.
struct Taps {
  int y0;
  float hw0, hw1;
  bool use0, use1;
};

__device__ __forceinline__ Taps taps(float pos, int n) {
  Taps t;
  t.y0 = (int)floorf(pos);
  const bool in0 = t.y0 >= 0 && t.y0 < n, in1 = t.y0 + 1 >= 0 && t.y0 + 1 < n;
  t.hw0 = in0 ? hat(pos, (float)t.y0) : 0.f;
  t.hw1 = in1 ? hat(pos, (float)(t.y0 + 1)) : 0.f;
  t.use0 = in0 && t.hw0 != 0.f;
  t.use1 = in1 && t.hw1 != 0.f;
  return t;
}

// sum over the used taps t of hw_t * lerp(in_{t}, in_{t+1})
__device__ __forceinline__ float4 tap_sum(const Taps& t, const Lerp& l, float4 in0, float4 in1,
                                          float4 in2) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t.use0) axpy(acc, t.hw0, lerp2(l, in0, in1));
  if (t.use1) axpy(acc, t.hw1, lerp2(l, in1, in2));
  return acc;
}

// pass 1's terms of canvas row y
struct Row1 {
  Lerp l;
  float bxc;   // bx * block_centre(y)
  int in_cut;  // inside the row cut (content is 0 outside)
};

#define W2_ROW_TERMS_BYTES 32
static_assert(sizeof(Row1) <= W2_ROW_TERMS_BYTES, "Row1 outgrows its table slot");

__device__ __forceinline__ Row1 pass1_row(const Coefs& k, const Geom& g, int y) {
  Row1 r;
  r.in_cut = (float)y >= k.loy && (float)y < fminf(k.hiy, (float)g.h);
  r.l = residual(k.bx, y, g.block, g.d1);
  r.bxc = __fmul_rn(k.bx, block_centre(y, g.block));
  return r;
}

// pass 1 of canvas row y (terms r) at the output column v whose ax * v is axv
__device__ __forceinline__ float4 pass1_at(const uint8_t* image, const uint8_t* mask,
                                           const Coefs& k, const Geom& g, int b, int y,
                                           const Row1& r, float axv) {
  if (!r.in_cut) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float hix = fminf(k.hix, (float)g.w);
  const float vpos = __fadd_rn(__fadd_rn(axv, r.bxc), k.cx);
  const uint8_t* img_row = image + ((size_t)b * g.h + y) * g.w * 3;
  const uint8_t* mask_row = mask + ((size_t)b * g.h + y) * g.w;
  const Taps t = taps(vpos, g.w);
  const int xa = t.y0 + r.l.k0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 p0 = t.use0 ? content(img_row, mask_row, xa, g.w, k.lox, hix) : zero;
  const float4 p1 = t.use0 || t.use1 ? content(img_row, mask_row, xa + 1, g.w, k.lox, hix) : zero;
  const float4 p2 = t.use1 ? content(img_row, mask_row, xa + 2, g.w, k.lox, hix) : zero;
  return tap_sum(t, r.l, p0, p1, p2);
}

// pass 1: tmp[b, y, v, :] (horizontal resample of canvas row y)
__device__ __forceinline__ float4 pass1_value(const uint8_t* image, const uint8_t* mask,
                                              const Coefs& k, const Geom& g, int b, int y, int v) {
  return pass1_at(image, mask, k, g, b, y, pass1_row(k, g, y), __fmul_rn(k.ax, (float)v));
}

// the position along the canvas rows of output pixel (u, v)'s block
// centre, the hat centre of pass 2
__device__ __forceinline__ float pass2_upos(const Coefs& k, const Geom& g, int u, int v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(k.m00, (float)u), __fmul_rn(k.m01, block_centre(v, g.block))),
                   k.ky0);
}

// pass 2's terms of output column v
struct Col2 {
  Lerp l;
  float m01c;  // m01 * block_centre(v)
  int in_cut;  // inside the rotation cut along v
};

__device__ __forceinline__ Col2 pass2_col(const Coefs& k, const Geom& g, int v) {
  Col2 c;
  const float pxv = __fadd_rn(__fmul_rn(k.a_x, (float)v), k.b_x);
  c.in_cut = pxv >= 0.f && pxv < k.canvas_w;
  c.l = residual(k.m01, v, g.block, g.d2);
  c.m01c = __fmul_rn(k.m01, block_centre(v, g.block));
  return c;
}

// pass 2 of output row u at the column of terms c (the rotation cut, then
// the vertical resample of tmp); rows(y) gives the column's tmp row y,
// 0 <= y < h
template <class Rows>
__device__ __forceinline__ float4 pass2_at(const Rows& rows, const Coefs& k, const Geom& g, int u,
                                           const Col2& c) {
  const float pyu = __fadd_rn(__fmul_rn(k.a_y, (float)u), k.b_y);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!(pyu >= 0.f && pyu < k.canvas_h && c.in_cut)) return zero;
  const float upos = __fadd_rn(__fadd_rn(__fmul_rn(k.m00, (float)u), c.m01c), k.ky0);
  const Taps t = taps(upos, g.h);
  const int ya = t.y0 + c.l.k0;
  const float4 r0 = t.use0 && ya >= 0 && ya < g.h ? rows(ya) : zero;
  const float4 r1 = (t.use0 || t.use1) && ya + 1 >= 0 && ya + 1 < g.h ? rows(ya + 1) : zero;
  const float4 r2 = t.use1 && ya + 2 >= 0 && ya + 2 < g.h ? rows(ya + 2) : zero;
  return tap_sum(t, c.l, r0, r1, r2);
}

// pass 2: out[b, u, v, :]; rows(y) gives tmp[b, y, v, :] for 0 <= y < h
template <class Rows>
__device__ __forceinline__ float4 pass2_value(const Rows& rows, const Coefs& k, const Geom& g, int u,
                                              int v) {
  return pass2_at(rows, k, g, u, pass2_col(k, g, v));
}

// the canvas rows [lo, hi] (clipped to it; empty when hi < lo) that pass 2
// of output rows [ua, ub) and columns [va, vb] reads: floor(upos) - d2 ..
// floor(upos) + 2 + d2, upos taken at the corners, where it is extreme
struct RowSpan {
  int lo, hi;
};

__device__ __forceinline__ RowSpan row_span(const Coefs& k, const Geom& g, int ua, int ub, int va,
                                            int vb) {
  const float p00 = pass2_upos(k, g, ua, va), p01 = pass2_upos(k, g, ua, vb);
  const float p10 = pass2_upos(k, g, ub - 1, va), p11 = pass2_upos(k, g, ub - 1, vb);
  // fminf / fmaxf pass over a NaN corner; all NaN gives the whole canvas
  const float lo = fminf(fminf(p00, p01), fminf(p10, p11));
  const float hi = fmaxf(fmaxf(p00, p01), fmaxf(p10, p11));
  const float flo = fmaxf(__fsub_rn(floorf(lo), (float)g.d2), 0.f);
  const float fhi = fminf(__fadd_rn(floorf(hi), (float)(2 + g.d2)), (float)(g.h - 1));
  RowSpan s;
  s.lo = (int)fminf(flo, (float)g.h);
  s.hi = (int)fmaxf(fhi, -1.f);
  return s;
}

// every sub-tile of su rows of [u0, u_end) reads at most cap_rows rows
__device__ __forceinline__ bool rows_fit(const Coefs& k, const Geom& g, int u0, int u_end, int su,
                                         int va, int vb, int cap_rows) {
  for (int ua = u0; ua < u_end; ua += su) {
    const RowSpan s = row_span(k, g, ua, min(ua + su, u_end), va, vb);
    if (s.hi - s.lo + 1 > cap_rows) return false;
  }
  return true;
}

// one CTA per (column tile, row tile, sample): pass 1 of the rows the tile
// reads into shared memory, a block barrier, pass 2 from shared memory.
// Thread t owns column t % W2_TILE_V of the tile in both passes, so the
// column's terms stay in registers; the rows' terms of pass 1 are a table.
__global__ void __launch_bounds__(W2_TILED_THREADS)
warp_2level_tiled_kernel(const uint8_t* __restrict__ image, const uint8_t* __restrict__ mask,
                         const float* __restrict__ params, float4* __restrict__ out, Geom g, int nb,
                         int tile_u, int cap_rows) {
  extern __shared__ float4 tmp_tile[];  // [cap_rows][W2_TILE_V], then Row1 [cap_rows]
  Row1* row_tab = reinterpret_cast<Row1*>(tmp_tile + (size_t)cap_rows * W2_TILE_V);
  const int b = blockIdx.z;
  const int v0 = blockIdx.x * W2_TILE_V, u0 = blockIdx.y * tile_u;
  const int nv = min(W2_TILE_V, g.out_w - v0), u_end = min(u0 + tile_u, g.out_h);
  const Coefs k = sample_coefs(params, b, nb);
  const int vb = v0 + nv - 1;
  const int c = threadIdx.x % W2_TILE_V, r0 = threadIdx.x / W2_TILE_V;
  const int rstep = W2_TILED_THREADS / W2_TILE_V;
  const int v = v0 + c;
  const bool mine = c < nv;
  const float axv = __fmul_rn(k.ax, (float)v);
  const Col2 col = pass2_col(k, g, v);
  // sub-tiles: the tile, halved along u until each one's rows fit (uniform)
  int su = u_end - u0;
  while (su > 1 && !rows_fit(k, g, u0, u_end, su, v0, vb, cap_rows)) su = (su + 1) >> 1;
  float4* out_b = out + (size_t)b * g.out_h * g.out_w;
  for (int ua = u0; ua < u_end; ua += su) {
    const int ub = min(ua + su, u_end);
    const RowSpan sp = row_span(k, g, ua, ub, v0, vb);
    const int nrows = sp.hi - sp.lo + 1;
    if (nrows > cap_rows) {
      // a one-row sub-tile beyond the plan: tmp values straight from pass 1
      if (r0 == 0 && mine)
        out_b[(size_t)ua * g.out_w + v] = pass2_at(
            [&](int y) { return pass1_value(image, mask, k, g, b, y, v); }, k, g, ua, col);
      continue;
    }
    __syncthreads();  // the previous sub-tile is done with tmp_tile and row_tab
    for (int r = threadIdx.x; r < nrows; r += W2_TILED_THREADS) row_tab[r] = pass1_row(k, g, sp.lo + r);
    __syncthreads();
    if (mine)
      for (int r = r0; r < nrows; r += rstep)
        tmp_tile[r * W2_TILE_V + c] = pass1_at(image, mask, k, g, b, sp.lo + r, row_tab[r], axv);
    __syncthreads();
    if (mine)
      for (int u = ua + r0; u < ub; u += rstep)
        out_b[(size_t)u * g.out_w + v] =
            pass2_at([&](int y) { return tmp_tile[(y - sp.lo) * W2_TILE_V + c]; }, k, g, u, col);
  }
}

// one cluster of W2_CLUSTER CTAs per sample: pass 1 into the sample's tmp,
// a cluster barrier, pass 2 from it
__global__ void __cluster_dims__(W2_CLUSTER, 1, 1) __launch_bounds__(W2_FUSED_THREADS)
warp_2level_fused_kernel(const uint8_t* __restrict__ image, const uint8_t* __restrict__ mask,
                         const float* __restrict__ params, float4* tmp,
                         float4* __restrict__ out, Geom g, int nb) {
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.x / W2_CLUSTER;
  const int first = (int)cluster.block_rank() * blockDim.x + threadIdx.x;
  const int stride = W2_CLUSTER * blockDim.x;
  const Coefs k = sample_coefs(params, b, nb);
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
    const float4* col = tmp_b + v;
    out_b[e] = pass2_value([&](int y) { return __ldcg(col + (size_t)y * g.out_w); }, k, g, u, v);
  }
}

static bool bad_geometry(int b, const Geom& g) {
  return b < 1 || b > 65535 || g.h < 1 || g.w < 1 || g.h > 65535 || g.out_h < 1 ||
         g.out_h > 65535 || g.out_w < 1 || g.block < 1 || g.d1 < 1 || g.d2 < 1 ||
         (long long)g.h * g.out_w > 0x7fffffffLL || (long long)g.out_h * g.out_w > 0x7fffffffLL;
}

// image [b, h, w, 3] uint8, mask [b, h, w] uint8, params [8, b, 2] float32
// (the RotWarpParams fields), out [b, out_h, out_w, 4] float32; tiles of tile_u x W2_TILE_V output pixels,
// cap_rows rows of tmp (and their pass-1 terms) in shared memory.  Returns a cudaError_t (0 on success).
extern "C" int warp_2level_tiled(const void* image, const void* mask, const void* params, void* out,
                                 int b, int h, int w, int out_h, int out_w, int block, int d1, int d2,
                                 int tile_u, int cap_rows, void* stream) {
  const Geom g = {h, w, out_h, out_w, block, d1, d2};
  if (bad_geometry(b, g) || tile_u < 1 || cap_rows < 1 || (out_h + tile_u - 1) / tile_u > 65535)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)cap_rows * (W2_TILE_V * sizeof(float4) + W2_ROW_TERMS_BYTES);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(warp_2level_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((out_w + W2_TILE_V - 1) / W2_TILE_V, (out_h + tile_u - 1) / tile_u, b);
  warp_2level_tiled_kernel<<<grid, W2_TILED_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(image), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(params), static_cast<float4*>(out), g, b, tile_u, cap_rows);
  return (int)cudaGetLastError();
}

// both passes in one launch; params as for warp_2level_tiled, tmp [b, h,
// out_w, 4] float32 the global scratch of pass 1.
extern "C" int warp_2level_fused(const void* image, const void* mask, const void* params, void* tmp,
                                 void* out, int b, int h, int w, int out_h, int out_w, int block,
                                 int d1, int d2, void* stream) {
  const Geom g = {h, w, out_h, out_w, block, d1, d2};
  if (bad_geometry(b, g) || (long long)b * W2_CLUSTER > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  warp_2level_fused_kernel<<<b * W2_CLUSTER, W2_FUSED_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(image), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(params), static_cast<float4*>(tmp), static_cast<float4*>(out), g, b);
  return (int)cudaGetLastError();
}
