// Baseline JPEG encoding with libjpeg's arithmetic, so that the bytes equal
// cv2.imencode(".jpg", img)'s with default parameters (libjpeg-turbo:
// quality 95, 4:2:0 for colour, standard Huffman tables, no restart
// markers), byte for byte.
//
// What is followed, and where it lives in libjpeg:
//   - RGB -> YCbCr through jccolor.c's fixed-point tables (SCALEBITS 16,
//     Cb and Cr rounded with ONE_HALF - 1);
//   - the edges: jcprepct.c and jcsample.c repeat the last column up to
//     whole blocks (for chroma, whole 16-pixel MCUs at full resolution) and
//     the last row up to an even row count, then up to whole iMCU rows;
//   - h2v2 downsampling with the bias 1, 2, 1, 2, ... along each output row
//     (jcsample.c);
//   - the accurate integer forward DCT (jfdctint.c: CONST_BITS 13,
//     PASS1_BITS 2), on samples less CENTERJSAMPLE;
//   - quantisation by reciprocal as jcdctmgr.c computes it for 16-bit
//     DCTELEMs (the SIMD build's), of divisors 8 * q, where q is the
//     Annex K table scaled as jpeg_set_quality(95, force_baseline) scales it;
//   - the dummy blocks of jccoefct.c at the right and bottom edges of an
//     interleaved scan: AC zero, DC that of the block before it;
//   - Huffman coding with the standard tables (jchuff.c), 0xFF stuffed with
//     0x00, the last byte padded with one bits;
//   - the markers of jcmarker.c: SOI, the JFIF APP0 (1.01, aspect 1:1), one
//     DQT per table, SOF0, one DHT per table, SOS, EOI.
// libjpeg-turbo's SIMD colour conversion, downsampling, DCT and
// quantisation compute these functions exactly, so the C code is the
// reference.
//
// jpeg_encode returns 0 with the file's length in *out_len, or 1 when the
// output buffer is too small (the caller retries with a larger one).
#include <cstdint>
#include <cstring>
#include <vector>

#include "jpeg_tables.h"

namespace {

using namespace jpeg_std;

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K tables in natural order (jcparam.c)
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
const int kQuality = 95;  // cv2's IMWRITE_JPEG_QUALITY default

struct Quant {
  uint8_t q[64];  // natural order
  uint16_t recip[64], corr[64];
  int shift[64];

  explicit Quant(const int *base) {
    // jpeg_quality_scaling and jpeg_add_quant_table (force_baseline)
    int scale = kQuality < 50 ? 5000 / kQuality : 200 - kQuality * 2;
    for (int i = 0; i < 64; i++) {
      long t = (base[i] * (long)scale + 50L) / 100L;
      if (t <= 0) t = 1;
      if (t > 255) t = 255;
      q[i] = (uint8_t)t;
      compute_reciprocal((uint16_t)(t << 3), i);
    }
  }

  // jcdctmgr.c compute_reciprocal with 16-bit DCTELEM
  void compute_reciprocal(uint16_t divisor, int i) {
    int b = 31 - __builtin_clz(divisor);
    int r = 16 + b;
    uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
    uint16_t c = divisor / 2;
    if (fr == 0) {
      fq >>= 1;
      r--;
    } else if (fr <= divisor / 2u) {
      c++;
    } else {
      fq++;
    }
    recip[i] = (uint16_t)fq;
    corr[i] = c;
    shift[i] = r;
  }

  void quantize(const int32_t *ws, int16_t *coef) const {
    for (int i = 0; i < 64; i++) {
      int32_t t = ws[i];
      bool neg = t < 0;
      if (neg) t = -t;
      uint32_t product = (uint32_t)(uint16_t)(t + corr[i]) * recip[i];
      int32_t v = (int32_t)(uint16_t)(product >> shift[i]);
      coef[i] = (int16_t)(neg ? -v : v);
    }
  }
};

// jfdctint.c jpeg_fdct_islow
const int kConstBits = 13, kPass1Bits = 2;
const int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
              F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
              F2562 = 20995, F3072 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

void fdct_islow(int32_t *data) {
  for (int pass = 0; pass < 2; pass++) {
    int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    int odd_shift = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
    for (int ctr = 0; ctr < 8; ctr++) {
      int32_t *d = data + ctr * stride;
      int32_t tmp0 = d[0 * step] + d[7 * step], tmp7 = d[0 * step] - d[7 * step];
      int32_t tmp1 = d[1 * step] + d[6 * step], tmp6 = d[1 * step] - d[6 * step];
      int32_t tmp2 = d[2 * step] + d[5 * step], tmp5 = d[2 * step] - d[5 * step];
      int32_t tmp3 = d[3 * step] + d[4 * step], tmp4 = d[3 * step] - d[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        d[0] = (int16_t)((tmp10 + tmp11) * (1 << kPass1Bits));
        d[4 * step] = (int16_t)((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        d[0] = (int16_t)descale(tmp10 + tmp11, kPass1Bits);
        d[4 * step] = (int16_t)descale(tmp10 - tmp11, kPass1Bits);
      }
      int32_t z1 = (tmp12 + tmp13) * F0541;
      d[2 * step] = (int16_t)descale(z1 + tmp13 * F0765, odd_shift);
      d[6 * step] = (int16_t)descale(z1 + tmp12 * -F1847, odd_shift);

      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      d[7 * step] = (int16_t)descale(tmp4 + z1 + z3, odd_shift);
      d[5 * step] = (int16_t)descale(tmp5 + z2 + z4, odd_shift);
      d[3 * step] = (int16_t)descale(tmp6 + z2 + z3, odd_shift);
      d[1 * step] = (int16_t)descale(tmp7 + z1 + z4, odd_shift);
    }
  }
}

struct Huff {
  uint16_t code[256];
  uint8_t size[256];

  // jchuff.c jpeg_make_c_derived_tbl
  Huff(const uint8_t *bits, const uint8_t *vals) {
    memset(size, 0, sizeof(size));
    int k = 0, c = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l - 1]; i++, k++) {
        code[vals[k]] = (uint16_t)c++;
        size[vals[k]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

struct Writer {
  uint8_t *out;
  int64_t cap, n = 0;
  uint64_t acc = 0;
  int bits = 0;
  bool overflow = false;

  void byte(uint8_t b) {
    if (n < cap) out[n] = b;
    else overflow = true;
    n++;
  }
  void word(int v) {
    byte((uint8_t)(v >> 8));
    byte((uint8_t)v);
  }
  void put(uint32_t v, int len) {
    acc = (acc << len) | (v & ((1u << len) - 1));
    bits += len;
    while (bits >= 8) {
      uint8_t b = (uint8_t)(acc >> (bits - 8));
      byte(b);
      if (b == 0xFF) byte(0);
      bits -= 8;
    }
  }
  void flush() {
    put(0x7F, 7);  // pad the last byte with one bits
    bits = 0;
    acc = 0;
  }
};

void encode_block(Writer &w, const int16_t *coef, int &last_dc, const Huff &dc, const Huff &ac) {
  int temp = coef[0] - last_dc, temp2 = temp;
  last_dc = coef[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = 0;
  while (temp) {
    nbits++;
    temp >>= 1;
  }
  w.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) w.put((uint32_t)temp2, nbits);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    temp = coef[kZigzag[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      w.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 1;
    while ((temp >>= 1)) nbits++;
    int i = (r << 4) + nbits;
    w.put(ac.code[i], ac.size[i]);
    w.put((uint32_t)temp2, nbits);
    r = 0;
  }
  if (r > 0) w.put(ac.code[0], ac.size[0]);
}

// one component's samples at its own resolution, padded as libjpeg pads them
struct Plane {
  int width, height;  // padded
  std::vector<uint8_t> px;
  uint8_t at(int y, int x) const { return px[(size_t)y * width + x]; }
};

// a full-resolution plane [h, w] with its last column repeated up to
// `width` and its last row up to `height`
Plane pad(const std::vector<uint8_t> &src, int h, int w, int height, int width) {
  Plane p{width, height, std::vector<uint8_t>((size_t)width * height)};
  for (int y = 0; y < height; y++) {
    const uint8_t *row = &src[(size_t)(y < h ? y : h - 1) * w];
    uint8_t *dst = &p.px[(size_t)y * width];
    memcpy(dst, row, w);
    memset(dst + w, row[w - 1], width - w);
  }
  return p;
}

// jcsample.c h2v2_downsample of a padded full-resolution plane; rows of
// the result past `rows` repeat its last one (jcprepct.c)
Plane downsample(const Plane &full, int rows, int height) {
  Plane p{full.width / 2, height, std::vector<uint8_t>((size_t)full.width / 2 * height)};
  for (int y = 0; y < height; y++) {
    int sy = y < rows ? y : rows - 1;
    int bias = 1;
    for (int x = 0; x < p.width; x++) {
      int s = full.at(2 * sy, 2 * x) + full.at(2 * sy, 2 * x + 1) + full.at(2 * sy + 1, 2 * x) +
              full.at(2 * sy + 1, 2 * x + 1);
      p.px[(size_t)y * p.width + x] = (uint8_t)((s + bias) >> 2);
      bias ^= 3;
    }
  }
  return p;
}

void forward_dct(const Plane &p, int by, int bx, const Quant &q, int16_t *coef) {
  int32_t ws[64];
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) ws[y * 8 + x] = (int32_t)p.at(by * 8 + y, bx * 8 + x) - 128;
  fdct_islow(ws);
  q.quantize(ws, coef);
}

void marker_dqt(Writer &w, int id, const Quant &q) {
  w.word(0xFFDB);
  w.word(67);
  w.byte((uint8_t)id);
  for (int k = 0; k < 64; k++) w.byte(q.q[kZigzag[k]]);
}

void marker_dht(Writer &w, int cls_id, const uint8_t *bits, const uint8_t *vals) {
  int n = 0;
  for (int i = 0; i < 16; i++) n += bits[i];
  w.word(0xFFC4);
  w.word(2 + 1 + 16 + n);
  w.byte((uint8_t)cls_id);
  for (int i = 0; i < 16; i++) w.byte(bits[i]);
  for (int i = 0; i < n; i++) w.byte(vals[i]);
}

}  // namespace

extern "C" int jpeg_encode(const uint8_t *pixels, int64_t h, int64_t w, int channels,
                           uint8_t *out, int64_t cap, int64_t *out_len) {
  const int H = (int)h, W = (int)w, nc = channels == 3 ? 3 : 1;
  const Quant luma(kLumaQuant), chroma(kChromaQuant);
  const Huff dc0(kDcLumaBits, kDcLumaVals), ac0(kAcLumaBits, kAcLumaVals);
  const Huff dc1(kDcChromaBits, kDcChromaVals), ac1(kAcChromaBits, kAcChromaVals);
  Writer wr{out, cap};

  // SOI, JFIF APP0
  static const uint8_t kApp0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                                  0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  for (uint8_t b : kApp0) wr.byte(b);
  marker_dqt(wr, 0, luma);
  if (nc == 3) marker_dqt(wr, 1, chroma);
  // SOF0
  wr.word(0xFFC0);
  wr.word(8 + 3 * nc);
  wr.byte(8);
  wr.word(H);
  wr.word(W);
  wr.byte((uint8_t)nc);
  for (int c = 0; c < nc; c++) {
    wr.byte((uint8_t)(c + 1));
    wr.byte(nc == 3 && c == 0 ? 0x22 : 0x11);
    wr.byte(c == 0 ? 0 : 1);
  }
  marker_dht(wr, 0x00, kDcLumaBits, kDcLumaVals);
  marker_dht(wr, 0x10, kAcLumaBits, kAcLumaVals);
  if (nc == 3) {
    marker_dht(wr, 0x01, kDcChromaBits, kDcChromaVals);
    marker_dht(wr, 0x11, kAcChromaBits, kAcChromaVals);
  }
  // SOS
  wr.word(0xFFDA);
  wr.word(6 + 2 * nc);
  wr.byte((uint8_t)nc);
  for (int c = 0; c < nc; c++) {
    wr.byte((uint8_t)(c + 1));
    wr.byte(c == 0 ? 0x00 : 0x11);
  }
  wr.byte(0);
  wr.byte(63);
  wr.byte(0);

  int16_t coef[64];
  if (nc == 1) {
    std::vector<uint8_t> gray(pixels, pixels + (size_t)H * W);
    int bw = (W + 7) / 8, bh = (H + 7) / 8;
    Plane p = pad(gray, H, W, bh * 8, bw * 8);
    int last_dc = 0;
    for (int by = 0; by < bh; by++)
      for (int bx = 0; bx < bw; bx++) {
        forward_dct(p, by, bx, luma, coef);
        encode_block(wr, coef, last_dc, dc0, ac0);
      }
  } else {
    // jccolor.c rgb_ycc_convert
    const int32_t ONE_HALF = 1 << 15, CBCR_OFFSET = 128 << 16;
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    const int32_t ry = fix(0.29900), gy = fix(0.58700), byy = fix(0.11400);
    const int32_t rcb = -fix(0.16874), gcb = -fix(0.33126), bcb = fix(0.5);
    const int32_t gcr = -fix(0.41869), bcr = -fix(0.08131);
    size_t n = (size_t)H * W;
    std::vector<uint8_t> Y(n), Cb(n), Cr(n);
    for (size_t i = 0; i < n; i++) {
      int32_t r = pixels[3 * i], g = pixels[3 * i + 1], b = pixels[3 * i + 2];
      Y[i] = (uint8_t)((ry * r + gy * g + byy * b + ONE_HALF) >> 16);
      Cb[i] = (uint8_t)((rcb * r + gcb * g + bcb * b + CBCR_OFFSET + ONE_HALF - 1) >> 16);
      Cr[i] = (uint8_t)((bcb * r + gcr * g + bcr * b + CBCR_OFFSET + ONE_HALF - 1) >> 16);
    }
    int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
    int ybw = (W + 7) / 8, ybh = (H + 7) / 8;  // Y's blocks that hold image
    int even = H + (H & 1);
    Plane py = pad(Y, H, W, mcuy * 16, mcux * 16);
    Plane pcb = downsample(pad(Cb, H, W, even, mcux * 16), even / 2, mcuy * 8);
    Plane pcr = downsample(pad(Cr, H, W, even, mcux * 16), even / 2, mcuy * 8);
    int dc[3] = {0, 0, 0};
    int16_t ymcu[4][64];
    for (int my = 0; my < mcuy; my++)
      for (int mx = 0; mx < mcux; mx++) {
        for (int k = 0; k < 4; k++) {
          int by = 2 * my + k / 2, bx = 2 * mx + k % 2;
          if (by < ybh && bx < ybw) {
            forward_dct(py, by, bx, luma, ymcu[k]);
          } else {  // a dummy block: AC zero, the DC of the block before it
            memset(ymcu[k], 0, sizeof(ymcu[k]));  // (a dummy row: of the row above's last)
            ymcu[k][0] = ymcu[by < ybh ? k - 1 : 1][0];
          }
        }
        for (int k = 0; k < 4; k++) encode_block(wr, ymcu[k], dc[0], dc0, ac0);
        forward_dct(pcb, my, mx, chroma, coef);
        encode_block(wr, coef, dc[1], dc1, ac1);
        forward_dct(pcr, my, mx, chroma, coef);
        encode_block(wr, coef, dc[2], dc1, ac1);
      }
  }
  wr.flush();
  wr.word(0xFFD9);
  *out_len = wr.n;
  return wr.overflow ? 1 : 0;
}
