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
// warp_2level_fused (B5, the sweep) is the port of
// warp_2level_pallas_fused, whose one program per sample keeps the tmp of all
// channels on chip (VMEM).  A sample's tmp is 4.9 MB at 640 -> 480, more
// than a CTA's 227 KB of shared memory or a 16-CTA cluster's ~3.6 MB, so the
// sweep keeps the TPU kernel's point, one program with tmp on chip, in the
// form the card holds: one CTA per sample and strip of 64 output columns
// sweeps down the output rows (256 CTAs at batch 32, two per SM; strips of
// 32 columns need four CTAs per SM to keep all 480 resident, and spill at
// the 64 registers that leaves them).  upos = m00 * u + m01 *
// centre(v) + ky0 rises with u when m00 > 0 (the pipeline's samples: a flip
// negates a_x only; a sample with m00 < 0 is swept from the last row up), so
// the tmp rows a chunk of chunk_u output rows reads form a band that only
// moves down the canvas: pass 1 computes each tmp value of the strip once
// into a ring of ring_rows x S float4 in shared memory, a row entering when
// the band's leading edge reaches it and leaving once its trailing edge has
// passed, and pass 2 reads the ring.  The canvas rows pass 1 will need next
// are staged by bulk copies (cp.async.bulk, completing on an mbarrier; the
// next chunk's rows while the current chunk computes: two stage buffers) as
// their windows [floor(min vpos) + k0, floor(max vpos) + k0 + 2] of RGB and
// mask bytes, so pass 1 reads bytes from shared memory rather than 12 byte
// gathers from device memory per value.  Nothing but the uint8 canvas and mask is read and the
// output written: ~170 MB at 32 x 640 -> 480, 0.0509 ms at 3.35 TB/s, the
// bound by bytes (the cluster form it replaces also wrote and reread a 157
// MB tmp).  The host plan (ops/warp_2level.py:plan_sweep) sizes the chunk,
// ring and stage from the bounds on theta and on the scale; whatever a
// sample does beyond them stays right: a chunk whose band outgrows the ring
// is halved, a one-row chunk that still does not fit reads tmp values
// straight from pass1_value, a canvas window wider than its stage buffer is
// read from device memory, and a band that moves back (NaN terms) is
// recomputed.
// Both forms take tmp values from pass1_value's arithmetic and sum them in
// pass2_value's order, so their outputs are bit-equal.
//
// The per-sample coefficients (computed in the kernel from the warp's
// params), positions, hat and lerp weights and the cut tests use
// round-to-nearest intrinsics in the operation order of the plain version,
// so they are bit-equal to it; only the order of the final sums differs.
//
// Built by ops/_build.py: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC; bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#define W2_TILE_V 32
#define W2_TILED_THREADS 256
#define W2_SWEEP_THREADS 256
#define W2_SWEEP_S 64
#define W2_SWEEP_BARRIER_BYTES 16

// per-sample coefficients, the layout of ops/warp_2level.py:coefficients
struct Coefs {
  float ax, bx, cx, lox, hix, m00, m01, ky0, loy, hiy, a_y, b_y, a_x, b_x, canvas_h, canvas_w;
};

struct Geom {
  int h, w, out_h, out_w, block, d1, d2;
};

// torch.clamp_min(x, 0): NaN stays NaN, -0.0 stays -0.0
__device__ __forceinline__ float clamp_min0(float x) { return x < 0.f ? 0.f : x; }

// The coefficients of one sample from its RotWarpParams fields, f[i] the
// sample's two floats of field i (scale, origin, cos_sin, center, t,
// src_lo, src_hi, canvas_hw), each a rounded float32 operation in the order
// of ops/warp.py:_affine_terms and ops/warp_2level.py:coefficients, so they
// equal the plain version's bits.
__device__ __forceinline__ Coefs field_coefs(const float* const* f) {
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

// sample b's coefficients from the params table p [8, nb, 2]
__device__ __forceinline__ Coefs sample_coefs(const float* __restrict__ p, int b, int nb) {
  const float* f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = p + ((size_t)i * nb + b) * 2;
  return field_coefs(f);
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

// one content pixel (RGB, mask) as floats, fetch(x) reading its bytes; zero
// outside the image and outside the translation cut on x (the row cut is
// tested by the caller)
template <class Fetch>
__device__ __forceinline__ float4 content(const Fetch& fetch, int x, int w, float lox, float hix) {
  if (x < 0 || x >= w || !((float)x >= lox && (float)x < hix)) return make_float4(0.f, 0.f, 0.f, 0.f);
  return fetch(x);
}

// pixel x of a canvas row as floats, from its RGB bytes and its mask byte
__device__ __forceinline__ float4 pixel4(const uint8_t* rgb, const uint8_t* m) {
  return make_float4(u8f(rgb[0]), u8f(rgb[1]), u8f(rgb[2]), u8f(m[0]));
}

// the same by the conversion instruction (I2FP, exact for a byte), one
// instruction a channel where u8f takes two
__device__ __forceinline__ float4 pixel4_cvt(const uint8_t* rgb, const uint8_t* m) {
  return make_float4((float)rgb[0], (float)rgb[1], (float)rgb[2], (float)m[0]);
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

// the canvas position of pass 1 of a row (terms r) at the column whose ax * v is axv
__device__ __forceinline__ float pass1_vpos(const Coefs& k, const Row1& r, float axv) {
  return __fadd_rn(__fadd_rn(axv, r.bxc), k.cx);
}

// pass 1 of a canvas row (terms r) at the output column v whose ax * v is
// axv, px(x) the row's content pixel x (zero outside the image and the
// translation cut)
template <class Px>
__device__ __forceinline__ float4 pass1_with(const Px& px, const Coefs& k, const Geom& g,
                                             const Row1& r, float axv) {
  if (!r.in_cut) return make_float4(0.f, 0.f, 0.f, 0.f);
  const Taps t = taps(pass1_vpos(k, r, axv), g.w);
  const int xa = t.y0 + r.l.k0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 p0 = t.use0 ? px(xa) : zero;
  const float4 p1 = t.use0 || t.use1 ? px(xa + 1) : zero;
  const float4 p2 = t.use1 ? px(xa + 2) : zero;
  return tap_sum(t, r.l, p0, p1, p2);
}

// pass 1 of canvas row y (terms r), its pixels read from device memory
__device__ __forceinline__ float4 pass1_at(const uint8_t* image, const uint8_t* mask,
                                           const Coefs& k, const Geom& g, int b, int y,
                                           const Row1& r, float axv) {
  const uint8_t* img_row = image + ((size_t)b * g.h + y) * g.w * 3;
  const uint8_t* mask_row = mask + ((size_t)b * g.h + y) * g.w;
  const float hix = fminf(k.hix, (float)g.w);
  auto fetch = [&](int x) { return pixel4(img_row + 3 * (size_t)x, mask_row + x); };
  return pass1_with([&](int x) { return content(fetch, x, g.w, k.lox, hix); }, k, g, r, axv);
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

// ... from the four corners' upos
__device__ __forceinline__ RowSpan corner_span(const Geom& g, float p00, float p01, float p10,
                                               float p11) {
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

__device__ __forceinline__ RowSpan row_span(const Coefs& k, const Geom& g, int ua, int ub, int va,
                                            int vb) {
  return corner_span(g, pass2_upos(k, g, ua, va), pass2_upos(k, g, ua, vb),
                     pass2_upos(k, g, ub - 1, va), pass2_upos(k, g, ub - 1, vb));
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

// -- the sweep (warp_2level_fused) --------------------------------------------

// the params fields, each [nb, 2] float32 and contiguous, in RotWarpParams order
struct Fields {
  const float* f[8];
};

// the host plan (ops/warp_2level.py:plan_sweep): output rows per chunk, rows
// of the tmp ring, canvas rows per stage buffer and the RGB and mask bytes
// (multiples of 16) staged per canvas row
struct SweepPlan {
  int chunk_u, ring_rows, stage_rows, stage_rgb, stage_mask;
};

// a staged canvas row: its pass-1 terms and its window [xa, xb] of pixels
// in the stage buffer, pixel xa's RGB at byte (shift & 15) of the row's RGB
// slot and its mask at byte (shift >> 4) of its mask slot; xa = -1: the
// window outgrew its slot, pass 1 reads the row from device memory; xb < xa:
// pass 1 reads no pixel of the row
struct StageRow {
  Row1 r;
  int xa, xb, shift;
};

static_assert(sizeof(StageRow) == 32, "StageRow is one 32-byte table slot, read as two int4");

// one step of the sweep: output rows [ia, ib) in sweep order, the canvas
// rows [lo, hi] their pass 2 reads, the rows [p0, p1) pass 1 adds to the
// ring for them; direct: a one-row step whose band outgrows the ring
struct Phase {
  int ia, ib, lo, hi, p0, p1;
  bool direct;
};

// the stage buffers' transaction barriers (mbarrier) and bulk copies (TMA)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive, after announcing `bytes` of copies that complete on the barrier
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the barrier's phase of parity `parity`; a barrier that never
// completes (a fault in the counts) traps rather than hangs the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (long long spin = 0; !mbar_try_wait(bar, parity); ++spin)
    if (spin > (1LL << 30)) __trap();
}

// generic-proxy accesses to shared memory before, async-proxy (TMA) writes after
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global src
// to shared dst, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the aligned 16-byte chunks [a0, a0 + n) of a tensor [t0, t1) into dst: one
// bulk copy (returns its bytes) where they lie inside the tensor, else byte
// by byte (only the bytes inside the tensor; at its unaligned ends)
__device__ __forceinline__ unsigned stage_bytes(uint8_t* dst, uintptr_t a0, unsigned n, uintptr_t t0,
                                                uintptr_t t1, uint64_t* bar) {
  if (a0 >= t0 && a0 + n <= t1) {
    bulk_copy(dst, reinterpret_cast<const void*>(a0), n, bar);
    return n;
  }
  for (unsigned q = 0; q < n; ++q)
    if (a0 + q >= t0 && a0 + q < t1) dst[q] = *reinterpret_cast<const uint8_t*>(a0 + q);
  return 0;
}

// pass 1 of a row from device memory: the path of a row whose window
// outgrew its stage slot (out of the plan's bounds only)
__device__ __noinline__ float4 pass1_unstaged(const uint8_t* image, const uint8_t* mask, Coefs k,
                                              Geom g, int b, int y, Row1 r, float axv) {
  return pass1_at(image, mask, k, g, b, y, r, axv);
}

// pass 2 of one output pixel with every tmp value straight from pass 1: a
// one-row step whose band outgrew the ring (out of the plan's bounds only)
__device__ __noinline__ float4 pass2_direct(const uint8_t* image, const uint8_t* mask, Coefs k,
                                            Geom g, int b, int u, int v, Col2 col) {
  return pass2_at([&](int y) { return pass1_value(image, mask, k, g, b, y, v); }, k, g, u, col);
}

// pass 2 at the column of terms c from the ring: pass2_at's arithmetic and
// order, tmp row y read from slot (y - base) mod R, whose rows 0 and 1 the
// ring mirrors at R and R + 1, so the three rows a pixel reads are col, col
// + S and col + 2S from one slot (col: the ring's column of this thread, S
// = W2_SWEEP_S)
__device__ __forceinline__ float4 pass2_ring(const float4* col, int base, int R, const Coefs& k,
                                             const Geom& g, int u, const Col2& c) {
  const float pyu = __fadd_rn(__fmul_rn(k.a_y, (float)u), k.b_y);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!(pyu >= 0.f && pyu < k.canvas_h && c.in_cut)) return zero;
  const float upos = __fadd_rn(__fadd_rn(__fmul_rn(k.m00, (float)u), c.m01c), k.ky0);
  const Taps t = taps(upos, g.h);
  const int ya = t.y0 + c.l.k0;
  const int s0 = ya - base >= R ? ya - base - R : ya - base;
  const float4* p = col + s0 * W2_SWEEP_S;
  const float4 r0 = t.use0 && ya >= 0 && ya < g.h ? p[0] : zero;
  const float4 r1 = (t.use0 || t.use1) && ya + 1 >= 0 && ya + 1 < g.h ? p[W2_SWEEP_S] : zero;
  const float4 r2 = t.use1 && ya + 2 >= 0 && ya + 2 < g.h ? p[2 * W2_SWEEP_S] : zero;
  return tap_sum(t, c.l, r0, r1, r2);
}

// One CTA per (strip of S = W2_SWEEP_S output columns, sample),
// W2_SWEEP_THREADS threads, two CTAs per SM:
// thread t owns column t % S of the strip in both passes (its terms stay in
// registers) and rows t / S, t / S + 256 / S, ... of each step.  A step
// (Phase): the threads of the last warps stage the next step's first canvas
// rows into the other stage buffer (a thread a row: its pass-1 terms and
// window in the table, the window's bytes by bulk copies that complete on
// the buffer's transaction barrier), every thread waits for this step's
// buffer, pass 1 of the step's new rows into the ring, a barrier, pass 2 of
// the step's output rows from the ring, a barrier.  Rows beyond one stage
// buffer (the first step, bands beyond the plan) are staged and waited for
// in place.  Shared memory: the two buffers' barriers (16 bytes), the ring
// [ring_rows + 2][S] float4 (its first two rows mirrored), then the two stage buffers, each the table
// StageRow [stage_rows], RGB [stage_rows][stage_rgb] and mask
// [stage_rows][stage_mask] bytes.
__global__ void __launch_bounds__(W2_SWEEP_THREADS, 2)
warp_2level_sweep_kernel(const uint8_t* __restrict__ image, const uint8_t* __restrict__ mask,
                         Fields fields, float4* __restrict__ out, Geom g, int nb, SweepPlan pl) {
  constexpr int S = W2_SWEEP_S, RSTEP = W2_SWEEP_THREADS / S;
  static_assert(W2_SWEEP_THREADS % S == 0 && S % 32 == 0, "a warp owns whole rows");
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float4* ring = reinterpret_cast<float4*>(smem + W2_SWEEP_BARRIER_BYTES);
  const int R = pl.ring_rows, Q = pl.stage_rows;
  uint8_t* const stage0 = smem + W2_SWEEP_BARRIER_BYTES + (size_t)(R + 2) * S * sizeof(float4);
  const size_t stage_bytes_per_buffer = (size_t)Q * (sizeof(StageRow) + pl.stage_rgb + pl.stage_mask);
  const int b = blockIdx.y, v0 = blockIdx.x * S;
  const int nv = min(S, g.out_w - v0), vb = v0 + nv - 1;
  const float* f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = fields.f[i] + (size_t)b * 2;
  const Coefs k = field_coefs(f);
  const int c = threadIdx.x % S, r0 = threadIdx.x / S;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int v = v0 + c;
  const bool mine = c < nv;
  const float axv = __fmul_rn(k.ax, (float)v);
  const Col2 col = pass2_col(k, g, v);
  // the translation cut on x as integers [x_lo, x_lo + x_n); a NaN lox
  // passes no pixel, a NaN hix is the canvas width (content()'s tests)
  int x_lo = 0, x_hi = 0;
  if (k.lox == k.lox) {
    x_lo = (int)fminf(fmaxf(ceilf(k.lox), 0.f), (float)g.w);
    x_hi = max(x_lo, (int)fmaxf(fminf(ceilf(fminf(k.hix, (float)g.w)), (float)g.w), 0.f));
  }
  const unsigned x_n = (unsigned)(x_hi - x_lo);
  // the strip's end columns: pass 1's ax * v, pass 2's m01 * centre(v)
  const float axv_a = __fmul_rn(k.ax, (float)v0), axv_b = __fmul_rn(k.ax, (float)vb);
  const float m01c_a = __fmul_rn(k.m01, block_centre(v0, g.block));
  const float m01c_b = __fmul_rn(k.m01, block_centre(vb, g.block));
  // sweep the output rows so that upos rises along the sweep
  const bool up = k.m00 < 0.f;
  const uintptr_t img0 = reinterpret_cast<uintptr_t>(image), msk0 = reinterpret_cast<uintptr_t>(mask);
  const uintptr_t img1 = img0 + (size_t)nb * g.h * g.w * 3, msk1 = msk0 + (size_t)nb * g.h * g.w;

  // the rows pass 2 of sweep rows [ia, ib) reads (row_span at the strip's corners)
  auto span = [&](int ia, int ib) {
    const int ua = up ? g.out_h - ib : ia, ub = up ? g.out_h - ia : ib;
    const float pa = __fmul_rn(k.m00, (float)ua), pb = __fmul_rn(k.m00, (float)(ub - 1));
    return corner_span(g, __fadd_rn(__fadd_rn(pa, m01c_a), k.ky0),
                       __fadd_rn(__fadd_rn(pa, m01c_b), k.ky0),
                       __fadd_rn(__fadd_rn(pb, m01c_a), k.ky0),
                       __fadd_rn(__fadd_rn(pb, m01c_b), k.ky0));
  };
  // the ring holds rows [lo_valid, front), row y in slot y % R
  int front = 0, lo_valid = 0;
  // the step that starts at sweep row ia, advancing front and lo_valid past it
  auto next_phase = [&](int ia) {
    Phase p = {ia, ia, 0, -1, front, front, false};
    if (ia >= g.out_h) return p;
    int su = min(pl.chunk_u, g.out_h - ia);
    RowSpan s = span(ia, ia + su);
    while (su > 1 && s.hi - s.lo + 1 > R) {
      su = (su + 1) >> 1;
      s = span(ia, ia + su);
    }
    p.ib = ia + su;
    p.lo = s.lo;
    p.hi = s.hi;
    if (s.hi < s.lo) return p;  // every row it would read lies off the canvas
    if (s.hi - s.lo + 1 > R) {
      p.direct = true;
      return p;
    }
    // a band below the ring's rows (it moved back) is recomputed; rows
    // between the front and a band ahead of it are never read
    if (s.lo < lo_valid || s.lo > front) front = lo_valid = s.lo;
    p.p0 = front;
    p.p1 = max(front, s.hi + 1);
    front = p.p1;
    lo_valid = max(lo_valid, front - R);
    return p;
  };
  // stage canvas rows [y0, y1) (at most Q) into buffer sb: thread 255 - r
  // writes row r's table entry and copies its windows (one bulk copy of RGB
  // and one of mask bytes), announcing their bytes on the buffer's barrier;
  // every thread arrives on it once
  auto stage = [&](int y0, int y1, int sb) {
    uint8_t* st = stage0 + sb * stage_bytes_per_buffer;
    const int r = W2_SWEEP_THREADS - 1 - (int)threadIdx.x;
    unsigned bytes = 0;
    if (r < y1 - y0) {
      fence_proxy_async();  // the buffer's earlier reads and byte writes come first
      const int y = y0 + r;
      StageRow e;
      e.r = pass1_row(k, g, y);
      e.xa = 0;
      e.xb = -1;
      e.shift = 0;
      if (e.r.in_cut) {
        // the pixels pass 1 of the strip can read: vpos is monotone in v,
        // so its extremes lie at the strip's end columns; a NaN end gives
        // the whole row, which then fits only a narrow canvas
        const float pa = pass1_vpos(k, e.r, axv_a), pb = pass1_vpos(k, e.r, axv_b);
        const float xa_f = __fadd_rn(floorf(fminf(pa, pb)), (float)e.r.l.k0);
        const float xb_f = __fadd_rn(floorf(fmaxf(pa, pb)), (float)(e.r.l.k0 + 2));
        const int xa = (int)fminf(fmaxf(xa_f, 0.f), (float)g.w);
        const int xb = (int)fmaxf(fminf(xb_f, (float)(g.w - 1)), -1.f);
        if (xa <= xb) {
          const size_t px = ((size_t)b * g.h + y) * g.w + xa, n = (size_t)(xb - xa + 1);
          const uintptr_t a_lo = img0 + 3 * px, m_lo = msk0 + px;
          const int sa = (int)(a_lo & 15), sm = (int)(m_lo & 15);
          e.xa = -1;
          if (sa + 3 * n <= (size_t)pl.stage_rgb && sm + n <= (size_t)pl.stage_mask) {
            e.xa = xa;
            e.xb = xb;
            e.shift = sa | sm << 4;
            uint8_t* rgb = st + (size_t)Q * sizeof(StageRow) + (size_t)r * pl.stage_rgb;
            uint8_t* msk = st + (size_t)Q * (sizeof(StageRow) + pl.stage_rgb) + (size_t)r * pl.stage_mask;
            bytes = stage_bytes(rgb, a_lo - sa, (unsigned)((sa + 3 * n + 15) & ~(size_t)15), img0, img1,
                                &bars[sb]) +
                    stage_bytes(msk, m_lo - sm, (unsigned)((sm + n + 15) & ~(size_t)15), msk0, msk1,
                                &bars[sb]);
          }
        }
      }
      reinterpret_cast<StageRow*>(st)[r] = e;
    }
    mbar_arrive_expect(&bars[sb], bytes);
  };
  // wait for buffer sb's rows (its table, copies and byte writes)
  unsigned parity = 0;
  auto stage_wait = [&](int sb) {
    mbar_wait(&bars[sb], (parity >> sb) & 1u);
    parity ^= 1u << sb;
  };

  if (threadIdx.x == 0) {
    mbar_init(&bars[0], W2_SWEEP_THREADS);
    mbar_init(&bars[1], W2_SWEEP_THREADS);
    mbar_init_fence();
  }
  __syncthreads();
  float4* out_b = out + (size_t)b * g.out_h * g.out_w;
  Phase cur = next_phase(0);
  stage(cur.p0, min(cur.p1, cur.p0 + Q), 0);
  for (int n = 0; cur.ia < g.out_h; ++n) {
    const int sb = n & 1;
    const uint8_t* st = stage0 + sb * stage_bytes_per_buffer;
    // the next step's first rows into the other buffer (last read by the
    // previous step's pass 1, before its barrier)
    const Phase nxt = next_phase(cur.ib);
    stage(nxt.p0, min(nxt.p1, nxt.p0 + Q), sb ^ 1);
    // ring slots of rows [lo, lo + R): y - base, less R past the ring's end
    const int base = cur.lo - cur.lo % R;
    stage_wait(sb);
    for (int y0 = cur.p0; y0 < cur.p1; y0 += Q) {
      const int y1 = min(cur.p1, y0 + Q);
      if (y0 != cur.p0) {  // rows past the first stage buffer of the step
        __syncthreads();
        stage(y0, y1, sb);
        stage_wait(sb);
      }
      const StageRow* tab = reinterpret_cast<const StageRow*>(st);
      const uint8_t* rgb = st + (size_t)Q * sizeof(StageRow);
      const uint8_t* msk = rgb + (size_t)Q * pl.stage_rgb;
      if (mine)
        for (int r = r0; r < y1 - y0; r += RSTEP) {
          StageRow e;  // two 16-byte loads
          const int4 e0 = reinterpret_cast<const int4*>(tab + r)[0];
          const int4 e1 = reinterpret_cast<const int4*>(tab + r)[1];
          memcpy(&e, &e0, 16);
          memcpy(reinterpret_cast<char*>(&e) + 16, &e1, 16);
          const int y = y0 + r;
          float4 val;
          if (e.xa >= 0) {
            // pixel x from the row's window; the translation cut on x as the
            // integers [x_lo, x_lo + x_n), the same pixels as content()'s
            // tests (for integer x, x >= lox iff x >= ceil(lox), x < hix iff
            // x < ceil(hix))
            const uint8_t* rgb_r = rgb + (size_t)r * pl.stage_rgb + (e.shift & 15) - 3 * e.xa;
            const uint8_t* msk_r = msk + (size_t)r * pl.stage_mask + (e.shift >> 4) - e.xa;
            val = pass1_with(
                [&](int x) {
                  return (unsigned)(x - x_lo) < x_n ? pixel4_cvt(rgb_r + 3 * x, msk_r + x)
                                                    : make_float4(0.f, 0.f, 0.f, 0.f);
                },
                k, g, e.r, axv);
          } else {
            val = pass1_unstaged(image, mask, k, g, b, y, e.r, axv);
          }
          const int slot = y - base >= R ? y - base - R : y - base;
          ring[slot * S + c] = val;
          if (slot < 2) ring[(slot + R) * S + c] = val;  // the mirror rows
        }
    }
    __syncthreads();  // the step's rows are in the ring
    if (cur.direct) {
      if (r0 == 0 && mine) {
        const int u = up ? g.out_h - 1 - cur.ia : cur.ia;
        out_b[(size_t)u * g.out_w + v] = pass2_direct(image, mask, k, g, b, u, v, col);
      }
    } else if (mine) {
      for (int i = cur.ia + r0; i < cur.ib; i += RSTEP) {
        const int u = up ? g.out_h - 1 - i : i;
        out_b[(size_t)u * g.out_w + v] = pass2_ring(ring + c, base, R, k, g, u, col);
      }
    }
    __syncthreads();  // pass 2 is done with the ring and this step's buffer
    cur = nxt;
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

// both passes in one launch, the sweep: image, mask and out as for
// warp_2level_tiled, f0 .. f7 the params fields ([b, 2] float32 each,
// contiguous); strips of W2_SWEEP_S output columns, laid out by the plan's
// chunk_u, ring_rows, stage_rows, stage_rgb and stage_mask.  Returns a
// cudaError_t (0 on success).
extern "C" int warp_2level_fused(const void* image, const void* mask, const void* f0, const void* f1,
                                 const void* f2, const void* f3, const void* f4, const void* f5,
                                 const void* f6, const void* f7, void* out, int b, int h, int w,
                                 int out_h, int out_w, int block, int d1, int d2, int chunk_u,
                                 int ring_rows, int stage_rows, int stage_rgb, int stage_mask,
                                 void* stream) {
  const Geom g = {h, w, out_h, out_w, block, d1, d2};
  if (bad_geometry(b, g) || (long long)w * 3 > 0x7fffffffLL || chunk_u < 1 || ring_rows < 1 ||
      stage_rows < 1 || stage_rgb < 16 || stage_rgb % 16 != 0 || stage_mask < 16 ||
      stage_mask % 16 != 0 || ring_rows > (1 << 20) || stage_rows > (1 << 20) ||
      stage_rgb > (1 << 20) || stage_mask > (1 << 20))
    return (int)cudaErrorInvalidValue;
  const Fields fields = {{static_cast<const float*>(f0), static_cast<const float*>(f1),
                          static_cast<const float*>(f2), static_cast<const float*>(f3),
                          static_cast<const float*>(f4), static_cast<const float*>(f5),
                          static_cast<const float*>(f6), static_cast<const float*>(f7)}};
  const SweepPlan pl = {chunk_u, ring_rows, stage_rows, stage_rgb, stage_mask};
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = W2_SWEEP_BARRIER_BYTES + (size_t)(ring_rows + 2) * W2_SWEEP_S * sizeof(float4) +
                      2 * (size_t)stage_rows * (sizeof(StageRow) + stage_rgb + stage_mask);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(warp_2level_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((out_w + W2_SWEEP_S - 1) / W2_SWEEP_S, b);
  warp_2level_sweep_kernel<<<grid, W2_SWEEP_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(image), static_cast<const uint8_t*>(mask), fields,
      static_cast<float4*>(out), g, b, pl);
  return (int)cudaGetLastError();
}
