// JPEG decoding with libjpeg's arithmetic, so that the pixels equal
// cv2.imread's (libjpeg-turbo 3, default decompression parameters, cv2's
// own CMYK conversion) bit for bit, for every JPEG form that cv2 decodes.
//
// What is decoded, and where it lives in libjpeg:
//   - frames: baseline and extended sequential (SOF0, SOF1), progressive
//     (SOF2), arithmetic-coded sequential and progressive (SOF9, SOF10) and
//     lossless (SOF3), 8-bit samples (lossless: 2 to 8 bits);
//   - Huffman decoding with libjpeg's reaction to running out of data
//     (jdhuff.c, jdphuff.c, jdlhuff.c): the MCU in which the data ends is
//     decoded with zero bits, later MCUs of the segment stay zero (gray; in a
//     lossless file, the predictor restarts); the standard tables stand in
//     for tables 0 and 1 when a file defines none (jstdhuff.c, Motion JPEG);
//   - arithmetic decoding (jdarith.c): the QM decoder and its 113 states,
//     the DC and AC statistics with the DAC marker's conditioning (defaults
//     L 0, U 1, Kx 5), DC and AC first and refine scans; behind a marker,
//     or the end of the file, the data reads as zeros;
//   - restart markers with jdmarker.c's resync rules;
//   - progressive scans: the quantisation tables latched at each
//     component's first scan, block smoothing of a file cut short;
//   - the accurate integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2)
//     clamped around CENTERJSAMPLE;
//   - lossless: predictors 1-7, the point transform, the first row and the
//     rows after a restart from 2^(P-Pt-1) (jddiffct.c, jdlossls.c);
//   - upsampling of any component to the largest sampling factors, each
//     as jdsample.c picks its method: h2v1 and h2v2 fancy (plain
//     replication when the component is at most two samples wide), h1v2
//     fancy, replication for every other whole-number ratio; a lossless
//     file replicates (libjpeg has no fancy upsampling at one sample per
//     unit); the edge rows and columns repeated as jdmainct.c does;
//   - colour as jdapimin.c's default_decompress_parms names it: YCbCr ->
//     RGB through jdcolor.c's fixed-point tables (SCALEBITS 16), RGB as it
//     is (gray: rgb_gray_convert), YCCK -> CMYK (ycck_cmyk_convert), then
//     CMYK -> RGB or gray as cv2's icvCvt_CMYK2BGR_8u_C4C3R and
//     icvCvt_CMYK2Gray_8u_C4C1R compute them.
//
// Gray output of a YCbCr file is the Y plane; colour output of a gray file
// repeats Y.  Orientation is left to the caller: jpeg_header reports where
// the first APP1 segment's TIFF block lies, as cv2 reads it.
//
// Return codes: 0 decoded; 1 cv2.imread gives None for the file, which
// raises FileNotFoundError in the reader: no image, headers cut or
// corrupt, and the forms libjpeg-turbo refuses (hierarchical frames SOF5-7
// and SOF13-15, the JPG marker, reserved markers, lossless arithmetic
// SOF11, 12-bit and 9-16-bit samples, 2 or 5 and more components, sampling
// ratios that are not whole numbers for a component the read needs, more
// than 10 blocks in an MCU, sides above 65500, colour conversions that
// lossless mode does not allow).  Code 2 (UnsupportedImage, a form cv2
// decodes and this decoder does not) is no longer returned.  A message goes
// into msg.
#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "jpeg_tables.h"

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for safety in decoder (libjpeg's jpeg_natural_order)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jaricom.c's jpeg_aritab (T.81 Table D.2): Qe, the next state after an
// LPS and after an MPS, and whether an LPS switches the MPS sense
struct QmState {
  uint16_t qe;
  uint8_t nl, nm, sw;
};
const QmState kQm[114] = {
    {0x5a1d, 1, 1, 1}, {0x2586, 14, 2, 0}, {0x1114, 16, 3, 0}, {0x080b, 18, 4, 0},
    {0x03d8, 20, 5, 0}, {0x01da, 23, 6, 0}, {0x00e5, 25, 7, 0}, {0x006f, 28, 8, 0},
    {0x0036, 30, 9, 0}, {0x001a, 33, 10, 0}, {0x000d, 35, 11, 0}, {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0}, {0x0001, 12, 13, 0}, {0x5a7f, 15, 15, 1}, {0x3f25, 36, 16, 0},
    {0x2cf2, 38, 17, 0}, {0x207c, 39, 18, 0}, {0x17b9, 40, 19, 0}, {0x1182, 42, 20, 0},
    {0x0cef, 43, 21, 0}, {0x09a1, 45, 22, 0}, {0x072f, 46, 23, 0}, {0x055c, 48, 24, 0},
    {0x0406, 49, 25, 0}, {0x0303, 51, 26, 0}, {0x0240, 52, 27, 0}, {0x01b1, 54, 28, 0},
    {0x0144, 56, 29, 0}, {0x00f5, 57, 30, 0}, {0x00b7, 59, 31, 0}, {0x008a, 60, 32, 0},
    {0x0068, 62, 33, 0}, {0x004e, 63, 34, 0}, {0x003b, 32, 35, 0}, {0x002c, 33, 9, 0},
    {0x5ae1, 37, 37, 1}, {0x484c, 64, 38, 0}, {0x3a0d, 65, 39, 0}, {0x2ef1, 67, 40, 0},
    {0x261f, 68, 41, 0}, {0x1f33, 69, 42, 0}, {0x19a8, 70, 43, 0}, {0x1518, 72, 44, 0},
    {0x1177, 73, 45, 0}, {0x0e74, 74, 46, 0}, {0x0bfb, 75, 47, 0}, {0x09f8, 77, 48, 0},
    {0x0861, 78, 49, 0}, {0x0706, 79, 50, 0}, {0x05cd, 48, 51, 0}, {0x04de, 50, 52, 0},
    {0x040f, 50, 53, 0}, {0x0363, 51, 54, 0}, {0x02d4, 52, 55, 0}, {0x025c, 53, 56, 0},
    {0x01f8, 54, 57, 0}, {0x01a4, 55, 58, 0}, {0x0160, 56, 59, 0}, {0x0125, 57, 60, 0},
    {0x00f6, 58, 61, 0}, {0x00cb, 59, 62, 0}, {0x00ab, 61, 63, 0}, {0x008f, 61, 32, 0},
    {0x5b12, 65, 65, 1}, {0x4d04, 80, 66, 0}, {0x412c, 81, 67, 0}, {0x37d8, 82, 68, 0},
    {0x2fe8, 83, 69, 0}, {0x293c, 84, 70, 0}, {0x2379, 86, 71, 0}, {0x1edf, 87, 72, 0},
    {0x1aa9, 87, 73, 0}, {0x174e, 72, 74, 0}, {0x1424, 72, 75, 0}, {0x119c, 74, 76, 0},
    {0x0f6b, 74, 77, 0}, {0x0d51, 75, 78, 0}, {0x0bb6, 77, 79, 0}, {0x0a40, 77, 48, 0},
    {0x5832, 80, 81, 1}, {0x4d1c, 88, 82, 0}, {0x438e, 89, 83, 0}, {0x3bdd, 90, 84, 0},
    {0x34ee, 91, 85, 0}, {0x2eae, 92, 86, 0}, {0x299a, 93, 87, 0}, {0x2516, 86, 71, 0},
    {0x5570, 88, 89, 1}, {0x4ca9, 95, 90, 0}, {0x44d9, 96, 91, 0}, {0x3e22, 97, 92, 0},
    {0x3824, 99, 93, 0}, {0x32b4, 99, 94, 0}, {0x2e17, 93, 86, 0}, {0x56a8, 95, 96, 1},
    {0x4f46, 101, 97, 0}, {0x47e5, 102, 98, 0}, {0x41cf, 103, 99, 0}, {0x3c3d, 104, 100, 0},
    {0x375e, 99, 93, 0}, {0x5231, 105, 102, 0}, {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0},
    {0x415e, 103, 99, 0}, {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1}, {0x5522, 112, 109, 0},
    {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0}};
const uint8_t kFixedBin = 113;  // the fixed 0.5 estimate (T.851)

struct Fail {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string &msg) { throw Fail{code, msg}; }

struct Huff {
  bool defined = false;
  int count = 0;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  // 9-bit lookahead: (length << 8) | symbol, length 0 when the code is longer
  uint16_t look[512];

  void set(const uint8_t *b16, const uint8_t *v, int n) {
    bits[0] = 0;
    std::memcpy(bits + 1, b16, 16);
    std::memcpy(vals, v, (size_t)n);
    count = n;
    defined = true;
  }

  // jdhuff.c jpeg_make_d_derived_tbl, run at the start of each scan that
  // uses the table: a DC symbol above 15 (16 in a lossless file) is an error
  void build(bool is_dc, bool lossless) {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      int i = bits[l];
      if (p + i > 256) fail(1, "bad Huffman table");
      while (i--) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    int numsymbols = p;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) {
        huffcode[p++] = code;
        code++;
      }
      if (code >= (1 << si)) fail(1, "bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 9; l++) {
      for (int i = 1; i <= bits[l]; i++, p++) {
        int lookbits = huffcode[p] << (9 - l);
        for (int ctr = 1 << (9 - l); ctr > 0; ctr--) look[lookbits++] = (uint16_t)((l << 8) | vals[p]);
      }
    }
    if (is_dc) {
      for (int i = 0; i < numsymbols; i++)
        if (vals[i] > (lossless ? 16 : 15)) fail(1, "bad Huffman table");
    }
  }
};

// how a component reaches the full size (jdsample.c's methods)
enum Up { FULLSIZE, H2V1_FANCY, H1V2_FANCY, H2V2_FANCY, REPLICATE };
// the colour space default_decompress_parms names
// (RAW: JCS_UNKNOWN, the components unconverted, for JPEG-in-TIFF)
enum Space { GRAY, YCC, RGB, CMYK, YCCK, RAW };

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;        // allocated units (whole MCUs)
  int wblocks = 0, hblocks = 0;  // units holding image samples
  int dw = 0, dh = 0;        // downsampled width and height
  bool needed = true;        // the read's colour conversion uses it
  Up up = FULLSIZE;
  int hr = 1, vr = 1;        // the ratios to the largest sampling factors
  bool latched = false;
  uint16_t q[64] = {0};  // all zero until latched: an unscanned component is gray
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
  std::vector<uint8_t> samples;  // lossless: dh * dw samples
  // progressive: the bits still unknown of each coefficient (zigzag index;
  // -1 none seen) now and before the component's latest scan (jdphuff.c)
  int coef_bits[64], prev_bits[64];
  int16_t *block(int by, int bx) { return &coef[((size_t)by * bw + bx) * 64]; }
};

// The entropy-coded data's bits, MSB first; libjpeg's reaction to a marker
// (or the end of the file, behind which it inserts EOI): the bits after it
// are zeros, and the first read that needs one sets `insufficient`.
struct Bits {
  const uint8_t *d;
  size_t n, pos;
  bool *past;  // set where a read goes past the end of the data
  uint64_t acc = 0;
  int nbits = 0;
  bool at_marker = false;
  bool insufficient = false;

  uint8_t at(size_t p) const {
    if (p < n) return d[p];
    *past = true;
    return ((p - n) & 1) ? 0xD9 : 0xFF;
  }

  void fill() {
    while (nbits <= 56 && !at_marker) {
      uint8_t c = at(pos);
      if (c == 0xFF) {
        size_t q = pos + 1;
        while (at(q) == 0xFF) q++;
        if (at(q) == 0) {
          pos = q + 1;
        } else {
          pos = q - 1;  // at the marker's last 0xFF
          at_marker = true;
          break;
        }
      } else {
        pos++;
      }
      acc |= (uint64_t)c << (56 - nbits);
      nbits += 8;
    }
  }
  inline void need(int n) {
    if (nbits < n) {
      fill();
      if (nbits < n) {
        insufficient = true;
        nbits = 64;  // zeros below the real bits
      }
    }
  }
  inline int get(int n) {
    if (n == 0) return 0;
    need(n);
    int v = (int)(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }
  inline int bit() { return get(1); }
  // jdhuff.c's HUFF_DECODE (HUFF_LOOKAHEAD 8), whose fills a memory
  // source must match: a fill below 8 bits, another below 9 for a longer
  // code, then one per bit below 1
  int decode(const Huff &t) {
    if (nbits < 8) fill();
    int nb = 1;
    if (nbits >= 8) {
      uint16_t e = t.look[acc >> 55];  // a code of at most 8 bits ignores the 9th
      int l = e >> 8;
      if (l && l <= 8) {
        acc <<= l;
        nbits -= l;
        return e & 0xFF;
      }
      nb = 9;
    }
    // jpeg_huff_decode: nb bits at once, then one bit at a time
    int code = get(nb);
    int l = nb;
    while (code > t.maxcode[l]) {
      code = (code << 1) | bit();
      l++;
    }
    if (l > 16) return 0;  // corrupt: libjpeg fakes a zero
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  void discard() {
    acc = 0;
    nbits = 0;
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + 1 - (1 << s) : r; }

// jdarith.c's decoder: the C and A registers and the bytes behind them;
// after a marker (or the end of the file) it reads zeros
struct Arith {
  const uint8_t *d;
  size_t n, pos;
  bool *past;  // set where a read goes past the end of the data
  int64_t c = 0, a = 0;
  int ct = -16;           // -16: two bytes to read first; -1: error, decode nothing more
  bool at_marker = false;  // pos is at the marker's last 0xFF

  uint8_t at(size_t p) const {
    if (p < n) return d[p];
    *past = true;
    return ((p - n) & 1) ? 0xD9 : 0xFF;
  }

  int byte() {
    if (at_marker) return 0;
    uint8_t v = at(pos++);
    if (v != 0xFF) return v;
    uint8_t m;
    do m = at(pos++); while (m == 0xFF);
    if (m == 0) return 0xFF;
    pos -= 2;
    at_marker = true;
    return 0;
  }

  int decode(uint8_t *st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // the two first bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    const QmState &q = kQm[sv & 0x7F];
    int64_t temp = a - q.qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < q.qe) {
        a = q.qe;
        *st = (uint8_t)((sv & 0x80) ^ q.nm);
      } else {
        a = q.qe;
        *st = (uint8_t)((sv & 0x80) ^ (q.nl | (q.sw << 7)));
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < q.qe) {
        *st = (uint8_t)((sv & 0x80) ^ (q.nl | (q.sw << 7)));
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ q.nm);
      }
    }
    return sv >> 7;
  }

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }
};

struct Decoder {
  const uint8_t *d;
  size_t n;  // the file's length
  size_t pos = 0;
  bool progressive = false, arith = false, lossless = false;
  bool frame = false;
  int precision = 8;
  int height = 0, width = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Space space = GRAY;
  int force = -1;  // a colour space the caller imposes (YCC or RAW), as libtiff does
  std::vector<Component> comps;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  uint8_t dc_l[16], dc_u[16], ac_k[16];  // arithmetic conditioning (DAC)
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int64_t exif_off = -1, exif_len = 0;
  bool any_app1 = false;
  bool frame_scanned = false;
  int scan_number = 0;
  int last_good_row = 0;  // the last iMCU row entered before the data ran out

  Decoder() {
    std::fill(dc_l, dc_l + 16, 0);
    std::fill(dc_u, dc_u + 16, 1);
    std::fill(ac_k, ac_k + 16, 5);
  }

  // libjpeg's stdio source inserts FF D9 at each read past the end, where
  // cv2's memory source suspends (past_end)
  mutable bool past_end = false;
  uint8_t at(size_t p) const {
    if (p < n) return d[p];
    past_end = true;
    return ((p - n) & 1) ? 0xD9 : 0xFF;
  }
  uint8_t byte() { return at(pos++); }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // next marker code after skipping anything that is not one
  int next_marker() {
    for (;;) {
      uint8_t c = byte();
      if (c != 0xFF) continue;
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void read_sof(int marker) {
    if (frame) fail(1, "duplicate SOF marker");
    progressive = marker == 0xC2 || marker == 0xCA;
    lossless = marker == 0xC3 || marker == 0xCB;
    arith = marker >= 0xC9;
    int len = u16();
    precision = byte();
    height = u16();
    width = u16();
    int nc = byte();
    if (height <= 0 || width <= 0 || nc <= 0) fail(1, "empty JPEG image");
    if (len != 8 + 3 * nc) fail(1, "bad SOF length");
    comps.resize(nc);
    for (auto &c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
    }
    frame = true;
  }

  // jdinput.c initial_setup, default_decompress_parms and what
  // jpeg_start_decompress refuses (jdcolor.c, jdsample.c) for the read
  void check_form(bool gray) {
    const int nc = (int)comps.size();
    if (height > 65500 || width > 65500) fail(1, "JPEG image wider or taller than 65500");
    if (lossless ? precision < 2 || precision > 8 : precision != 8)
      fail(1, std::to_string(precision) + "-bit JPEG: cv2 reads 8-bit samples only");
    if (lossless && arith) fail(1, "arithmetic-coded lossless JPEG (SOF11): libjpeg-turbo does not decode it");
    if (nc > 10) fail(1, "more than 10 components");
    hmax = vmax = 1;
    for (auto &c : comps) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail(1, "bad sampling factors");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (force >= 0) {  // libtiff's jpeg_color_space: YCbCr (3 components) or unknown
      if (force == YCC && nc != 3) fail(1, "YCbCr JPEG data without 3 components");
      space = (Space)force;
    } else if (nc == 1) {
      space = GRAY;
    } else if (nc == 3) {
      // JFIF means YCbCr, then Adobe's transform flag, then the component
      // ids, which a lossless file reads as RGB whatever they are
      bool rgb_ids = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
      if (jfif) space = YCC;
      else if (adobe) space = adobe_transform == 0 ? RGB : YCC;
      else space = lossless || rgb_ids ? RGB : YCC;
    } else if (nc == 4) {
      space = adobe && adobe_transform != 0 ? YCCK : CMYK;
    } else {
      fail(1, std::to_string(nc) + "-component JPEG: libjpeg-turbo has no colour conversion for it");
    }
    // lossless mode takes no conversion that loses information
    if (lossless && (space == YCC || space == YCCK || (gray ? space == RGB : space == GRAY)))
      fail(1, "lossless JPEG whose colour conversion libjpeg-turbo refuses in this read mode");
    const int unit = lossless ? 1 : 8;
    mcux = (width + unit * hmax - 1) / (unit * hmax);
    mcuy = (height + unit * vmax - 1) / (unit * vmax);
    for (size_t ci = 0; ci < comps.size(); ci++) {
      Component &c = comps[ci];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.wblocks = (c.dw + unit - 1) / unit;
      c.hblocks = (c.dh + unit - 1) / unit;
      c.needed = !(gray && (space == GRAY || space == YCC) && ci > 0);
      if (!c.needed) continue;
      const bool fancy = !lossless;
      if (c.h == hmax && c.v == vmax) c.up = FULLSIZE;
      else if (c.h * 2 == hmax && c.v == vmax) c.up = fancy && c.dw > 2 ? H2V1_FANCY : REPLICATE;
      else if (c.h == hmax && c.v * 2 == vmax && fancy) c.up = H1V2_FANCY;
      else if (c.h * 2 == hmax && c.v * 2 == vmax) c.up = fancy && c.dw > 2 ? H2V2_FANCY : REPLICATE;
      else if (hmax % c.h == 0 && vmax % c.v == 0) c.up = REPLICATE;
      else fail(1, "JPEG sampling ratio that is not a whole number: libjpeg-turbo does not upsample it");
      c.hr = hmax / c.h;
      c.vr = vmax / c.v;
    }
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int pq = byte();
      int tq = pq & 15, prec = pq >> 4;
      if (tq > 3) fail(1, "bad DQT table index");
      for (int i = 0; i < 64; i++) qt[tq][kNatural[i]] = (uint16_t)(prec ? u16() : byte());
      qt_defined[tq] = true;
      len -= 1 + 64 * (prec ? 2 : 1);
    }
    if (len != 0) fail(1, "bad DQT length");
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 16) {
      int index = byte();
      uint8_t bits[16], vals[256];
      int count = 0;
      for (int i = 0; i < 16; i++) {
        bits[i] = byte();
        count += bits[i];
      }
      len -= 1 + 16;
      if (count > 256 || count > len) fail(1, "bad Huffman table");
      for (int i = 0; i < count; i++) vals[i] = byte();
      len -= count;
      bool is_ac = index & 0x10;
      if (is_ac) index -= 0x10;
      if (index > 3) fail(1, "bad DHT table index");
      (is_ac ? ac : dc)[index].set(bits, vals, count);
    }
    if (len != 0) fail(1, "bad DHT length");
  }

  // jdmarker.c get_dac
  void read_dac() {
    int len = u16() - 2;
    while (len > 0) {
      int index = byte(), val = byte();
      len -= 2;
      if (index >= 32) fail(1, "bad DAC table index");
      if (index >= 16) {
        ac_k[index - 16] = (uint8_t)val;
      } else {
        dc_l[index] = (uint8_t)(val & 15);
        dc_u[index] = (uint8_t)(val >> 4);
        if (dc_l[index] > dc_u[index]) fail(1, "bad DAC value");
      }
    }
    if (len != 0) fail(1, "bad DAC length");
  }

  void read_app(int marker) {
    int len = u16();
    if (len < 2) fail(1, "bad marker length");
    size_t start = pos, body = (size_t)len - 2;
    uint8_t p[14] = {0};  // get_interesting_appn reads at most 14 bytes
    for (size_t i = 0; i < 14 && i < body; i++) p[i] = at(start + i);
    if (marker == 0xE0 && body >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
    if (marker == 0xEE && body >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    if (marker == 0xE1 && !any_app1 && !frame_scanned && start + body <= n) {
      any_app1 = true;  // cv2 reads the first APP1 segment, from its 7th byte
      if (body > 6) {
        exif_off = (int64_t)start + 6;
        exif_len = (int64_t)body - 6;
      }
    }
    pos = start + body;
  }

  void skip_segment() {
    int len = u16();
    if (len < 2) fail(1, "bad marker length");
    pos += (size_t)len - 2;
  }

  // markers up to the next SOS (true) or EOI (false), as jdmarker.c's
  // read_markers takes them
  bool read_markers() {
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) return false;
      if (m == 0xDA) return true;
      if (m == 0xD8) {
        if (frame_scanned || frame) fail(1, "unexpected SOI marker");
        continue;
      }
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // RSTn, TEM: no parameters
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA: case 0xCB:
          read_sof(m);
          continue;
        case 0xC5: case 0xC6: case 0xC7: case 0xC8: case 0xCD: case 0xCE: case 0xCF:
          fail(1, "hierarchical JPEG (or the JPG marker): libjpeg-turbo does not decode it");
        case 0xC4: read_dht(); continue;
        case 0xCC: read_dac(); continue;
        case 0xDB: read_dqt(); continue;
        case 0xDD:
          if (u16() != 4) fail(1, "bad DRI length");
          restart_interval = u16();
          continue;
        case 0xDC: case 0xFE: skip_segment(); continue;  // DNL, COM
        default: break;
      }
      if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
        continue;
      }
      // DHP, EXP, JPGn and the reserved markers end libjpeg's read
      fail(1, "unknown JPEG marker");
    }
  }

  // the header of the first scan: what jpeg_read_header needs
  void read_header(bool gray) {
    if (n < 3 || d[0] != 0xFF || d[1] != 0xD8) fail(1, "not a JPEG file");
    pos = 2;
    if (!read_markers()) fail(1, "no image in the JPEG file");
    if (!frame) fail(1, "SOS before SOF");
    check_form(gray);
  }

  // ---------------------------------------------------------------- scans
  struct Scan {
    std::vector<int> comp;  // component indices
    std::vector<int> td, ta;
    int ss = 0, se = 63, ah = 0, al = 0;
  };

  Huff &table(bool is_dc, int index) {
    if (index > 3) fail(1, "bad Huffman table index");
    Huff &t = (is_dc ? dc : ac)[index];
    if (!t.defined) {
      // jstdhuff.c: a missing table 0 or 1 is the standard one
      if (index == 0 && is_dc) t.set(jpeg_std::kDcLumaBits, jpeg_std::kDcLumaVals, 12);
      else if (index == 1 && is_dc) t.set(jpeg_std::kDcChromaBits, jpeg_std::kDcChromaVals, 12);
      else if (index == 0) t.set(jpeg_std::kAcLumaBits, jpeg_std::kAcLumaVals, 162);
      else if (index == 1) t.set(jpeg_std::kAcChromaBits, jpeg_std::kAcChromaVals, 162);
      else fail(1, "Huffman table not defined");
    }
    t.build(is_dc, lossless);
    return t;
  }

  Scan read_sos() {
    Scan s;
    int len = u16();
    int ns = byte();
    if (len != 6 + 2 * ns || ns < 1 || ns > 4) fail(1, "bad SOS length");
    std::vector<bool> taken(comps.size(), false);
    for (int i = 0; i < ns; i++) {
      int cid = byte(), t = byte();
      int ci = -1;
      for (size_t k = 0; k < comps.size() && k < 4 && ci < 0; k++)
        if (comps[k].id == cid && !taken[k]) ci = (int)k;
      if (ci < 0) fail(1, "bad component in SOS");
      taken[ci] = true;
      s.comp.push_back(ci);
      s.td.push_back(t >> 4);
      s.ta.push_back(t & 15);
    }
    s.ss = byte();
    s.se = byte();
    int a = byte();
    s.ah = a >> 4;
    s.al = a & 15;
    if (ns > 1) {
      int units = 0;
      for (int ci : s.comp) units += comps[ci].h * comps[ci].v;
      if (units > 10) fail(1, "more than 10 blocks in an MCU");
    }
    if (lossless) {
      if (s.ss < 1 || s.ss > 7 || s.se != 0 || s.ah != 0 || s.al >= precision)
        fail(1, "invalid lossless parameters");
      int per_row = ns > 1 ? mcux : comps[s.comp[0]].wblocks;
      if (restart_interval % per_row != 0) fail(1, "lossless restart interval is not whole MCU rows");
      for (size_t i = 0; i < s.comp.size(); i++) table(true, s.td[i]);
      scan_number++;
      return s;
    }
    if (!progressive) {  // libjpeg ignores (and warns about) other values here
      s.ss = 0;
      s.se = 63;
    } else {
      bool bad = false;
      if (s.ss == 0) {
        if (s.se != 0) bad = true;
      } else {
        if (s.ss > s.se || s.se > 63) bad = true;
        if (ns != 1) bad = true;
      }
      if (s.ah != 0 && s.al != s.ah - 1) bad = true;
      if (s.al > 13) bad = true;
      if (bad) fail(1, "invalid progressive parameters");
    }
    scan_number++;
    for (size_t i = 0; i < s.comp.size() && progressive; i++) {
      Component &c = comps[s.comp[i]];
      for (int k = std::min(s.ss, 1); k <= std::max(s.se, 9); k++)
        c.prev_bits[k] = scan_number > 1 ? c.coef_bits[k] : 0;
      for (int k = s.ss; k <= s.se; k++) c.coef_bits[k] = s.al;
    }
    for (size_t i = 0; i < s.comp.size(); i++) {
      Component &c = comps[s.comp[i]];
      if (!c.latched) {
        if (c.tq > 3 || !qt_defined[c.tq]) fail(1, "quantization table not defined");
        std::memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.latched = true;
      }
      if (arith) continue;  // conditioning tables 0-15 always exist
      bool need_dc = !progressive || (s.ss == 0 && s.ah == 0);
      bool need_ac = !progressive ? true : s.ss != 0;
      if (need_dc) table(true, s.td[i]);
      if (need_ac) table(false, s.ta[i]);
    }
    return s;
  }

  // position (its last 0xFF) and code of the first marker at or after p
  int find_marker(size_t &p) const {
    for (;;) {
      if (at(p) != 0xFF) {
        p++;
        continue;
      }
      size_t r = p + 1;
      while (at(r) == 0xFF) r++;
      if (at(r) != 0) {
        p = r - 1;
        return at(r);
      }
      p = r + 1;
    }
  }

  // jdmarker.c: read_restart_marker, with jpeg_resync_to_restart, from the
  // data position p; true when the restart marker was consumed (p after
  // it), false when a marker is left for later (p at its last 0xFF)
  bool restart_marker(size_t &p, int &next_rst) {
    int marker = find_marker(p);
    bool consumed = false;
    for (;;) {
      int desired = next_rst, action;
      if (marker < 0xC0) action = 2;
      else if (marker < 0xD0 || marker > 0xD7) action = 3;
      else if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7)) action = 3;
      else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7)) action = 2;
      else action = 1;
      if (action == 3) break;
      p += 2;  // past the marker
      if (action == 1) {
        consumed = true;
        break;
      }
      marker = find_marker(p);
    }
    next_rst = (next_rst + 1) & 7;
    return consumed;
  }

  void restart(Bits &br, int &next_rst) {
    br.discard();
    size_t p = br.pos;
    bool consumed = restart_marker(p, next_rst);
    br.pos = p;
    br.at_marker = !consumed;
    if (consumed) br.insufficient = false;
  }

  // The scan's MCUs in order (interleaved, or one component's blocks over
  // its own size): restart() where a restart interval ends, mcu(row) as
  // each MCU starts, then block(i, blk) for each of its blocks.
  template <class Restart, class Mcu, class Block>
  void walk(const Scan &s, Restart restart_fn, Mcu mcu_fn, Block block_fn) {
    const bool single = s.comp.size() == 1;
    const int units_x = single ? comps[s.comp[0]].wblocks : mcux;
    const int units_y = single ? comps[s.comp[0]].hblocks : mcuy;
    int restarts_to_go = restart_interval;
    for (int my = 0; my < units_y; my++) {
      for (int mx = 0; mx < units_x; mx++) {
        if (restart_interval) {
          if (restarts_to_go == 0) {
            restart_fn();
            restarts_to_go = restart_interval;
          }
        }
        mcu_fn(single ? my / comps[s.comp[0]].v : my);
        if (single) {
          block_fn(0, comps[s.comp[0]].block(my, mx));
        } else {
          for (size_t i = 0; i < s.comp.size(); i++) {
            Component &c = comps[s.comp[i]];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++) block_fn((int)i, c.block(my * c.v + v, mx * c.h + h));
          }
        }
        if (restart_interval) restarts_to_go--;
      }
    }
  }

  void decode_scan(const Scan &s) {
    Bits br;
    br.d = d;
    br.n = n;
    br.pos = pos;
    br.past = &past_end;
    int next_rst = 0;
    int last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0;
    const int p1 = 1 << s.al, m1 = -1 * (1 << s.al);
    enum { BASE, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE } kind;
    if (!progressive) kind = BASE;
    else if (s.ss == 0) kind = s.ah == 0 ? DC_FIRST : DC_REFINE;
    else kind = s.ah == 0 ? AC_FIRST : AC_REFINE;
    const Huff *dct[4], *act[4];
    for (size_t i = 0; i < s.comp.size(); i++) {
      dct[i] = &dc[s.td[i] & 3];
      act[i] = &ac[s.ta[i] & 3];
    }

    // libjpeg tests for the end of the data once per MCU: the MCU in which
    // the data ends is decoded to its end with zero bits
    bool skip = false;
    auto decode_block = [&](int ci_scan, int16_t *blk) {
      switch (kind) {
        case BASE: {
          if (skip) return;
          int t = br.decode(*dct[ci_scan]);
          int diff = t ? extend(br.get(t), t) : 0;
          last_dc[ci_scan] += diff;
          blk[0] = (int16_t)last_dc[ci_scan];
          const Huff &at = *act[ci_scan];
          for (int k = 1; k < 64; k++) {
            int rs = br.decode(at);
            int r = rs >> 4, sz = rs & 15;
            if (sz) {
              k += r;
              int v = extend(br.get(sz), sz);
              blk[kNatural[k]] = (int16_t)v;
            } else {
              if (r != 15) break;
              k += 15;
            }
          }
          return;
        }
        case DC_FIRST: {
          if (skip) return;
          int t = br.decode(*dct[ci_scan]);
          int diff = t ? extend(br.get(t), t) : 0;
          last_dc[ci_scan] += diff;
          blk[0] = (int16_t)(last_dc[ci_scan] * (1 << s.al));
          return;
        }
        case DC_REFINE: {
          if (br.bit()) blk[0] |= (int16_t)p1;
          return;
        }
        case AC_FIRST: {
          if (skip) return;
          if (eobrun > 0) {
            eobrun--;
            return;
          }
          const Huff &at = *act[ci_scan];
          for (int k = s.ss; k <= s.se; k++) {
            int rs = br.decode(at);
            int r = rs >> 4, sz = rs & 15;
            if (sz) {
              k += r;
              int v = extend(br.get(sz), sz);
              blk[kNatural[k]] = (int16_t)((unsigned)v << s.al);
            } else {
              if (r == 15) {
                k += 15;
              } else {
                eobrun = 1 << r;
                if (r) eobrun += br.get(r);
                eobrun--;
                break;
              }
            }
          }
          return;
        }
        case AC_REFINE: {
          if (skip) return;
          const Huff &at = *act[ci_scan];
          int k = s.ss;
          if (eobrun == 0) {
            for (; k <= s.se; k++) {
              int rs = br.decode(at);
              int r = rs >> 4, sz = rs & 15;
              int val = 0;
              if (sz) {
                val = br.bit() ? p1 : m1;
              } else if (r != 15) {
                eobrun = 1 << r;
                if (r) eobrun += br.get(r);
                break;
              }
              do {
                int16_t *c = blk + kNatural[k];
                if (*c != 0) {
                  if (br.bit()) {
                    if ((*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
                  }
                } else {
                  if (--r < 0) break;
                }
                k++;
              } while (k <= s.se);
              if (val) blk[kNatural[k]] = (int16_t)val;
            }
          }
          if (eobrun > 0) {
            for (; k <= s.se; k++) {
              int16_t *c = blk + kNatural[k];
              if (*c != 0) {
                if (br.bit()) {
                  if ((*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
                }
              }
            }
            eobrun--;
          }
          return;
        }
      }
    };

    walk(
        s,
        [&] {
          restart(br, next_rst);
          for (int &v : last_dc) v = 0;
          eobrun = 0;
        },
        [&](int row) {
          skip = br.insufficient;
          if (!skip) last_good_row = row;
        },
        decode_block);
    pos = br.pos;
  }

  // jdarith.c: the four progressive kinds and the sequential decode_mcu
  void decode_scan_arith(const Scan &s) {
    Arith ar;
    ar.d = d;
    ar.n = n;
    ar.pos = pos;
    ar.past = &past_end;
    int next_rst = 0;
    uint8_t dc_stats[16][64], ac_stats[16][256], fixed = kFixedBin;
    int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
    const bool dc_scan = !progressive || (s.ss == 0 && s.ah == 0);
    const bool ac_scan = !progressive || s.ss != 0;
    auto reset_stats = [&] {
      for (size_t i = 0; i < s.comp.size(); i++) {
        if (dc_scan) {
          std::memset(dc_stats[s.td[i]], 0, 64);
          last_dc[i] = dc_context[i] = 0;
        }
        if (ac_scan) std::memset(ac_stats[s.ta[i]], 0, 256);
      }
      ar.reset();
    };
    reset_stats();
    const int al = progressive ? s.al : 0;
    const int p1 = 1 << al, m1 = -1 * (1 << al);

    // F.1.4.4.1 / F.2.4.1: a DC difference
    auto decode_dc = [&](int i) {
      const int tbl = s.td[i];
      uint8_t *st = dc_stats[tbl] + dc_context[i];
      if (ar.decode(st) == 0) {
        dc_context[i] = 0;
        return 0;
      }
      int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m != 0) {
        st = dc_stats[tbl] + 20;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;  // magnitude overflow
            return 0;
          }
          st += 1;
        }
      }
      if (m < (int)((1L << dc_l[tbl]) >> 1)) dc_context[i] = 0;
      else if (m > (int)((1L << dc_u[tbl]) >> 1)) dc_context[i] = 12 + sign * 4;
      else dc_context[i] = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      return sign ? -v : v;
    };
    // F.2.4.2 / G.1.3.2: AC coefficients ss..se (sequential: 1..63)
    auto decode_ac = [&](int i, int16_t *blk, int ss, int se) {
      const int tbl = s.ta[i];
      for (int k = ss; k <= se; k++) {
        uint8_t *st = ac_stats[tbl] + 3 * (k - 1);
        if (ar.decode(st)) break;  // EOB
        while (ar.decode(st + 1) == 0) {
          st += 3;
          if (++k > se) {
            ar.ct = -1;  // spectral overflow
            return;
          }
        }
        int sign = ar.decode(&fixed);
        st += 2;
        int m = ar.decode(st);
        if (m != 0) {
          if (ar.decode(st)) {
            m <<= 1;
            st = ac_stats[tbl] + (k <= ac_k[tbl] ? 189 : 217);
            while (ar.decode(st)) {
              if ((m <<= 1) == 0x8000) {
                ar.ct = -1;  // magnitude overflow
                return;
              }
              st += 1;
            }
          }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
          if (ar.decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        blk[kNatural[k]] = (int16_t)((unsigned)v << al);
      }
    };
    auto decode_block = [&](int i, int16_t *blk) {
      if (ar.ct == -1) return;  // after an error the scan decodes nothing more
      if (!progressive) {
        int v = decode_dc(i);
        if (ar.ct == -1) return;
        last_dc[i] = (last_dc[i] + v) & 0xFFFF;
        blk[0] = (int16_t)(uint16_t)last_dc[i];
        decode_ac(i, blk, 1, 63);
      } else if (s.ss == 0 && s.ah == 0) {
        int v = decode_dc(i);
        if (ar.ct == -1) return;
        last_dc[i] = (last_dc[i] + v) & 0xFFFF;
        blk[0] = (int16_t)(uint16_t)((unsigned)last_dc[i] << s.al);
      } else if (s.ss == 0) {
        if (ar.decode(&fixed)) blk[0] = (int16_t)(blk[0] | p1);
      } else if (s.ah == 0) {
        decode_ac(i, blk, s.ss, s.se);
      } else {
        int kex = s.se;
        for (; kex > 0; kex--)
          if (blk[kNatural[kex]]) break;
        for (int k = s.ss; k <= s.se; k++) {
          uint8_t *st = ac_stats[s.ta[i]] + 3 * (k - 1);
          if (k > kex)
            if (ar.decode(st)) break;  // EOB
          for (;;) {
            int16_t *c = blk + kNatural[k];
            if (*c) {  // previously nonzero
              if (ar.decode(st + 2)) *c = (int16_t)(*c < 0 ? *c + m1 : *c + p1);
              break;
            }
            if (ar.decode(st + 1)) {  // newly nonzero
              *c = (int16_t)(ar.decode(&fixed) ? m1 : p1);
              break;
            }
            st += 3;
            if (++k > s.se) {
              ar.ct = -1;  // spectral overflow
              return;
            }
          }
        }
      }
    };

    walk(
        s,
        [&] {
          size_t p = ar.pos;
          bool consumed = restart_marker(p, next_rst);
          ar.pos = p;
          ar.at_marker = !consumed;
          reset_stats();
        },
        [&](int row) { last_good_row = row; },  // arithmetic data never runs out
        decode_block);
    pos = ar.pos;
  }

  // jdlhuff.c, jddiffct.c, jdlossls.c: one lossless scan, undifferenced
  // one iMCU row at a time into the components' samples
  void decode_scan_lossless(const Scan &s) {
    Bits br;
    br.d = d;
    br.n = n;
    br.pos = pos;
    br.past = &past_end;
    int next_rst = 0;
    const int ns = (int)s.comp.size();
    const bool single = ns == 1;
    const int per_row = single ? comps[s.comp[0]].wblocks : mcux;
    const int total_rows = (height + vmax - 1) / vmax;  // iMCU rows
    const Huff *tbl[4];
    std::vector<std::vector<int>> diff(ns), undiff(ns);  // rows of the iMCU row
    for (int i = 0; i < ns; i++) {
      const Component &c = comps[s.comp[i]];
      tbl[i] = &dc[s.td[i] & 3];
      diff[i].assign((size_t)c.v * c.bw, 0);
      undiff[i].assign((size_t)c.v * c.bw, 0);
    }
    bool first_row[10];
    std::fill(first_row, first_row + 10, true);
    const int initial = 1 << (precision - s.al - 1);
    int restart_rows_to_go = restart_interval / per_row;
    for (int row = 0; row < total_rows; row++) {
      const int mcu_rows = single ? (row < total_rows - 1 ? comps[s.comp[0]].v
                                                          : last_rows(comps[s.comp[0]]))
                                  : 1;
      for (int yoffset = 0; yoffset < mcu_rows; yoffset++) {
        if (restart_interval) {
          if (restart_rows_to_go == 0) {
            restart(br, next_rst);
            std::fill(first_row, first_row + 10, true);
            restart_rows_to_go = restart_interval / per_row;
          }
        }
        if (br.insufficient) {
          // out of data: this MCU row's differences are zero and the
          // predictors start again
          for (int i = 0; i < ns; i++) {
            const Component &c = comps[s.comp[i]];
            if (single) std::fill_n(&diff[i][(size_t)yoffset * c.bw], per_row, 0);
            else std::fill(diff[i].begin(), diff[i].end(), 0);
          }
          std::fill(first_row, first_row + 10, true);
        } else {
          for (int mx = 0; mx < per_row; mx++) {
            for (int i = 0; i < ns; i++) {
              const Component &c = comps[s.comp[i]];
              const int uh = single ? 1 : c.h, uv = single ? 1 : c.v;
              for (int yy = 0; yy < uv; yy++) {
                for (int xx = 0; xx < uh; xx++) {
                  int t = br.decode(*tbl[i]);
                  int v = 0;
                  if (t == 16) v = 32768;
                  else if (t) v = extend(br.get(t), t);
                  diff[i][(size_t)(single ? yoffset : yy) * c.bw + mx * uh + xx] = v;
                }
              }
            }
          }
        }
        if (restart_interval) restart_rows_to_go--;
      }
      for (int i = 0; i < ns; i++) {
        Component &c = comps[s.comp[i]];
        const int ci = s.comp[i];
        const int rows = row == total_rows - 1 ? last_rows(c) : c.v;
        const int w = c.wblocks;
        for (int r = 0, pr = c.v - 1; r < rows; pr = r, r++) {
          const int *dr = &diff[i][(size_t)r * c.bw];
          int *ur = &undiff[i][(size_t)r * c.bw];
          const int *up = &undiff[i][(size_t)pr * c.bw];
          if (first_row[ci]) {
            int ra = (dr[0] + initial) & 0xFFFF;
            ur[0] = ra;
            for (int x = 1; x < w; x++) ur[x] = ra = (dr[x] + ra) & 0xFFFF;
            first_row[ci] = false;
          } else {
            int64_t rb = up[0], ra = (dr[0] + rb) & 0xFFFF, rc;
            ur[0] = (int)ra;
            for (int x = 1; x < w; x++) {
              rc = rb;
              rb = up[x];
              int64_t pred;
              switch (s.ss) {
                case 1: pred = ra; break;
                case 2: pred = rb; break;
                case 3: pred = rc; break;
                case 4: pred = ra + rb - rc; break;
                case 5: pred = ra + ((rb - rc) >> 1); break;
                case 6: pred = rb + ((ra - rc) >> 1); break;
                default: pred = (ra + rb) >> 1; break;
              }
              ur[x] = (int)(ra = (dr[x] + pred) & 0xFFFF);
            }
          }
          const int y = row * c.v + r;
          if (y < c.dh) {
            uint8_t *o = &c.samples[(size_t)y * c.dw];
            for (int x = 0; x < c.dw; x++) o[x] = (uint8_t)(ur[x] << s.al);
          }
        }
      }
    }
    pos = br.pos;
  }

  static int last_rows(const Component &c) {
    int r = c.hblocks % c.v;
    return r ? r : c.v;
  }

  void decode_all() {
    for (auto &c : comps) {
      if (lossless) {
        c.samples.assign((size_t)c.dw * c.dh, 0);
        continue;
      }
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      std::fill(c.prev_bits, c.prev_bits + 64, 0);
    }
    // pos is just after the first SOS marker
    for (;;) {
      Scan s = read_sos();
      frame_scanned = true;
      if (lossless) decode_scan_lossless(s);
      else if (arith) decode_scan_arith(s);
      else decode_scan(s);
      if (!progressive && s.comp.size() == comps.size()) break;
      // between scans: tables, restart intervals, the next SOS or EOI
      if (!read_markers()) break;
    }
  }
};

// ----------------------------------------------------------------- pixels
// The accurate integer IDCT (jidctint.c) as libjpeg-turbo's AVX2 code runs
// it (jidctint-avx2.asm), which is what cv2 runs on x86-64.  On the values
// a valid file gives, this is jidctint.c to the bit; where cut or corrupt
// data drives it out of range, it follows the SIMD code: 16-bit dequantised
// coefficients (vpmullw), 16-bit sums in0 +- in4 and z3, z4 (vpaddw), pass 1
// saturated to 16 bits (vpackssdw), the output saturated to [0, 255], and
// the DC-only shortcut taken for the whole block at once.
namespace idct {
const int32_t CB = 13, P1 = 2;
const int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
              F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int16_t w16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int32_t add(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
inline int32_t sub(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
inline int32_t mul(int32_t a, int32_t b) { return (int32_t)((uint32_t)a * (uint32_t)b); }
inline int16_t sat16(int32_t x) { return (int16_t)(x < -32768 ? -32768 : x > 32767 ? 32767 : x); }
inline int32_t descale(int32_t x, int n) { return add(x, 1 << (n - 1)) >> n; }

// one 8-point transform of in[0..7] (16-bit), descaled by `shift`, 16-bit
// saturated into out[0..7]
inline void dodct(const int16_t *in, int32_t *out, int shift) {
  int32_t tmp3 = add(mul(in[2], F0541 + F0765), mul(in[6], F0541));
  int32_t tmp2 = add(mul(in[2], F0541), mul(in[6], F0541 - F1847));
  int32_t tmp0 = (int32_t)((uint32_t)(int32_t)w16(in[0] + in[4]) << CB);
  int32_t tmp1 = (int32_t)((uint32_t)(int32_t)w16(in[0] - in[4]) << CB);
  int32_t tmp10 = add(tmp0, tmp3), tmp13 = sub(tmp0, tmp3);
  int32_t tmp11 = add(tmp1, tmp2), tmp12 = sub(tmp1, tmp2);
  int32_t z3 = w16(in[7] + in[3]), z4 = w16(in[5] + in[1]);
  int32_t z3f = add(mul(z3, F1175 - F1961), mul(z4, F1175));
  int32_t z4f = add(mul(z3, F1175), mul(z4, F1175 - F0390));
  int32_t o0 = add(add(mul(in[7], F0298 - F0899), mul(in[1], -F0899)), z3f);
  int32_t o3 = add(add(mul(in[7], -F0899), mul(in[1], F1501 - F0899)), z4f);
  int32_t o1 = add(add(mul(in[5], F2053 - F2562), mul(in[3], -F2562)), z4f);
  int32_t o2 = add(add(mul(in[5], -F2562), mul(in[3], F3072 - F2562)), z3f);
  out[0] = sat16(descale(add(tmp10, o3), shift));
  out[7] = sat16(descale(sub(tmp10, o3), shift));
  out[1] = sat16(descale(add(tmp11, o2), shift));
  out[6] = sat16(descale(sub(tmp11, o2), shift));
  out[2] = sat16(descale(add(tmp12, o1), shift));
  out[5] = sat16(descale(sub(tmp12, o1), shift));
  out[3] = sat16(descale(add(tmp13, o0), shift));
  out[4] = sat16(descale(sub(tmp13, o0), shift));
}
}  // namespace idct

void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out, int stride) {
  using namespace idct;
  int16_t ws[64];  // pass 1's output, [row][col]
  bool ac_zero = true;
  for (int i = 8; i < 64 && ac_zero; i++) ac_zero = in[i] == 0;
  if (ac_zero) {
    for (int c = 0; c < 8; c++) {
      int16_t dc = w16((int32_t)(uint16_t)w16(in[c] * q[c]) << P1);
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
    }
  } else {
    int16_t col[8];
    int32_t res[8];
    for (int c = 0; c < 8; c++) {
      for (int r = 0; r < 8; r++) col[r] = w16(in[r * 8 + c] * q[r * 8 + c]);
      dodct(col, res, CB - P1);
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = (int16_t)res[r];
    }
  }
  int32_t res[8];
  for (int r = 0; r < 8; r++) {
    dodct(ws + r * 8, res, CB + P1 + 3);
    uint8_t *op = out + (size_t)r * stride;
    for (int c = 0; c < 8; c++) op[c] = (uint8_t)((res[c] < -128 ? -128 : res[c] > 127 ? 127 : res[c]) + 128);
  }
}

// jdcoefct.c smoothing_ok: a progressive file whose coefficients are not all
// known (a file cut short) is smoothed from the neighbours' DC values.
// latch[ci] and prev[ci] get coef_bits[0..9] now and before the last scan.
bool smoothing_ok(Decoder &dec, std::vector<std::array<int, 10>> &latch,
                  std::vector<std::array<int, 10>> &prev) {
  if (!dec.progressive) return false;
  bool useful = false;
  latch.resize(dec.comps.size());
  prev.resize(dec.comps.size());
  for (size_t ci = 0; ci < dec.comps.size(); ci++) {
    Component &c = dec.comps[ci];
    if (!c.latched) return false;
    for (int pos : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
      if (c.q[pos] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    latch[ci][0] = c.coef_bits[0];
    for (int k = 1; k < 10; k++) {
      prev[ci][k] = dec.scan_number > 1 ? c.prev_bits[k] : -1;
      latch[ci][k] = c.coef_bits[k];
      if (c.coef_bits[k] != 0) useful = true;
    }
  }
  return useful;
}

// jdcoefct.c decompress_smooth_data: estimate the first AC coefficients
// (and, with no AC data at all, the DC) of each block from a 5 x 5
// neighbourhood of DC values (libjpeg-turbo 2.1 and later)
void smooth_block(const int16_t *blk, int16_t *ws, const int *bits, bool change_dc, const uint16_t *q,
                  const int DC[26]) {
  std::memcpy(ws, blk, 64 * sizeof(int16_t));
  const int64_t Q00 = q[0];
  auto predict = [&](int pos, int al, int64_t num, int64_t qk, bool limit) {
    int pred;
    if (num >= 0) {
      pred = (int)(((qk << 7) + num) / (qk << 8));
      if (limit && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = (int)(((qk << 7) - num) / (qk << 8));
      if (limit && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    ws[pos] = (int16_t)pred;
  };
  int al;
  if ((al = bits[1]) != 0 && ws[1] == 0) {
    int64_t num = Q00 * (change_dc ? (-DC[1] - DC[2] + DC[4] + DC[5] - 3 * DC[6] + 13 * DC[7] - 13 * DC[9] +
                                      3 * DC[10] - 3 * DC[11] + 38 * DC[12] - 38 * DC[14] + 3 * DC[15] -
                                      3 * DC[16] + 13 * DC[17] - 13 * DC[19] + 3 * DC[20] - DC[21] - DC[22] +
                                      DC[24] + DC[25])
                                   : (-7 * DC[11] + 50 * DC[12] - 50 * DC[14] + 7 * DC[15]));
    predict(1, al, num, q[1], true);
  }
  if ((al = bits[2]) != 0 && ws[8] == 0) {
    int64_t num = Q00 * (change_dc ? (-DC[1] - 3 * DC[2] - 3 * DC[3] - 3 * DC[4] - DC[5] - DC[6] + 13 * DC[7] +
                                      38 * DC[8] + 13 * DC[9] - DC[10] + DC[16] - 13 * DC[17] - 38 * DC[18] -
                                      13 * DC[19] + DC[20] + DC[21] + 3 * DC[22] + 3 * DC[23] + 3 * DC[24] +
                                      DC[25])
                                   : (-7 * DC[3] + 50 * DC[8] - 50 * DC[18] + 7 * DC[23]));
    predict(8, al, num, q[8], true);
  }
  if ((al = bits[3]) != 0 && ws[16] == 0) {
    int64_t num = Q00 * (change_dc ? (DC[3] + 2 * DC[7] + 7 * DC[8] + 2 * DC[9] - 5 * DC[12] - 14 * DC[13] -
                                      5 * DC[14] + 2 * DC[17] + 7 * DC[18] + 2 * DC[19] + DC[23])
                                   : (-DC[3] + 13 * DC[8] - 24 * DC[13] + 13 * DC[18] - DC[23]));
    predict(16, al, num, q[16], true);
  }
  if ((al = bits[4]) != 0 && ws[9] == 0) {
    int64_t num = Q00 * (change_dc ? (-DC[1] + DC[5] + 9 * DC[7] - 9 * DC[9] - 9 * DC[17] + 9 * DC[19] + DC[21] -
                                      DC[25])
                                   : (DC[10] + DC[16] - 10 * DC[17] + 10 * DC[19] - DC[2] - DC[20] + DC[22] -
                                      DC[24] + DC[4] - DC[6] + 10 * DC[7] - 10 * DC[9]));
    predict(9, al, num, q[9], true);
  }
  if ((al = bits[5]) != 0 && ws[2] == 0) {
    int64_t num = Q00 * (change_dc ? (2 * DC[7] - 5 * DC[8] + 2 * DC[9] + DC[11] + 7 * DC[12] - 14 * DC[13] +
                                      7 * DC[14] + DC[15] + 2 * DC[17] - 5 * DC[18] + 2 * DC[19])
                                   : (-DC[11] + 13 * DC[12] - 24 * DC[13] + 13 * DC[14] - DC[15]));
    predict(2, al, num, q[2], true);
  }
  if (!change_dc) return;
  if ((al = bits[6]) != 0 && ws[3] == 0)
    predict(3, al, Q00 * (DC[7] - DC[9] + 2 * DC[12] - 2 * DC[14] + DC[17] - DC[19]), q[3], true);
  if ((al = bits[7]) != 0 && ws[10] == 0)
    predict(10, al, Q00 * (DC[7] - 3 * DC[8] + DC[9] - DC[17] + 3 * DC[18] - DC[19]), q[10], true);
  if ((al = bits[8]) != 0 && ws[17] == 0)
    predict(17, al, Q00 * (DC[7] - DC[9] - 3 * DC[12] + 3 * DC[14] + DC[17] - DC[19]), q[17], true);
  if ((al = bits[9]) != 0 && ws[24] == 0)
    predict(24, al, Q00 * (DC[7] + 2 * DC[8] + DC[9] - DC[17] - 2 * DC[18] - DC[19]), q[24], true);
  int64_t num = Q00 * (-2 * DC[1] - 6 * DC[2] - 8 * DC[3] - 6 * DC[4] - 2 * DC[5] - 6 * DC[6] + 6 * DC[7] +
                       42 * DC[8] + 6 * DC[9] - 6 * DC[10] - 8 * DC[11] + 42 * DC[12] + 152 * DC[13] +
                       42 * DC[14] - 8 * DC[15] - 6 * DC[16] + 6 * DC[17] + 42 * DC[18] + 6 * DC[19] -
                       6 * DC[20] - 2 * DC[21] - 6 * DC[22] - 8 * DC[23] - 6 * DC[24] - 2 * DC[25]);
  predict(0, 0, num, Q00, false);
}

// the component's samples, dh rows of dw (the blocks' padding cut off);
// `latch`/`prev` non-null: smoothed as decompress_smooth_data does
std::vector<uint8_t> plane(Component &c, int total_rows, int last_good_row, const int *latch,
                           const int *prev) {
  int pw = c.wblocks * 8;
  std::vector<uint8_t> buf((size_t)c.hblocks * 8 * pw);
  if (!latch) {
    for (int by = 0; by < c.hblocks; by++)
      for (int bx = 0; bx < c.wblocks; bx++)
        idct_islow(c.block(by, bx), c.q, &buf[(size_t)by * 8 * pw + bx * 8], pw);
  } else {
    int16_t ws[64];
    const int last_col = c.wblocks - 1;
    for (int r = 0; r < total_rows; r++) {
      int block_rows = c.v;
      if (r == total_rows - 1) {
        block_rows = c.hblocks % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      const int *bits = r > last_good_row ? prev : latch;
      bool change_dc = true;
      for (int k = 1; k < 10; k++) change_dc = change_dc && bits[k] == -1;
      const int image_block_rows = block_rows * total_rows;
      for (int b = 0; b < block_rows; b++) {
        const int row = r * c.v + b, ibr = r * block_rows + b;
        int rp = ibr > 0 ? row - 1 : row;
        int rpp = ibr > 1 ? row - 2 : rp;
        int rn = ibr < image_block_rows - 1 ? row + 1 : row;
        int rnn = ibr < image_block_rows - 2 ? row + 2 : rn;
        const int rows[5] = {rpp, rp, row, rn, rnn};
        auto dcv = [&](int k, int col) { return (int)c.block(rows[k], col)[0]; };
        int DC[26];
        for (int k = 0; k < 5; k++)
          for (int j = 1; j <= 5; j++) DC[5 * k + j] = dcv(k, 0);
        for (int bx = 0; bx <= last_col; bx++) {
          if (bx == 0 && bx < last_col)
            for (int k = 0; k < 5; k++) DC[5 * k + 4] = DC[5 * k + 5] = dcv(k, 1);
          if (bx + 1 < last_col)
            for (int k = 0; k < 5; k++) DC[5 * k + 5] = dcv(k, bx + 2);
          smooth_block(c.block(row, bx), ws, bits, change_dc, c.q, DC);
          idct_islow(ws, c.q, &buf[(size_t)row * 8 * pw + bx * 8], pw);
          for (int k = 0; k < 5; k++)
            for (int j = 1; j <= 4; j++) DC[5 * k + j] = DC[5 * k + j + 1];
        }
      }
    }
  }
  std::vector<uint8_t> out((size_t)c.dh * c.dw);
  for (int y = 0; y < c.dh; y++) std::memcpy(&out[(size_t)y * c.dw], &buf[(size_t)y * pw], c.dw);
  return out;
}

// a component's plane (dh x dw) brought to the full size (height x width)
// by the method check_form picked (jdsample.c); raw pointers, so that the
// byte stores do not make the compiler reload the planes' addresses
std::vector<uint8_t> upsample(std::vector<uint8_t> in, const Component &c, int height, int width) {
  if (c.up == FULLSIZE) return in;
  std::vector<uint8_t> out((size_t)height * width);
  const int dw = c.dw, dh = c.dh;
  const uint8_t *src = in.data();
  uint8_t *dst = out.data();
  switch (c.up) {
    case H2V1_FANCY:
      for (int y = 0; y < height; y++) {
        uint8_t *o = dst + (size_t)y * width;
        const uint8_t *r = src + (size_t)y * dw;
        for (int x = 0; x < width; x++) {
          int i = x >> 1;
          if ((x & 1) == 0)
            o[x] = (uint8_t)((3 * r[i] + r[i > 0 ? i - 1 : 0] + 1) >> 2);
          else
            o[x] = (uint8_t)((3 * r[i] + r[i + 1 < dw ? i + 1 : dw - 1] + 2) >> 2);
        }
      }
      break;
    case H1V2_FANCY:
      for (int y = 0; y < height; y++) {
        uint8_t *o = dst + (size_t)y * width;
        const int iy = y >> 1, bias = (y & 1) ? 2 : 1;
        const int ny = (y & 1) ? (iy + 1 < dh ? iy + 1 : dh - 1) : (iy > 0 ? iy - 1 : 0);
        const uint8_t *near = src + (size_t)iy * dw, *far = src + (size_t)ny * dw;
        for (int x = 0; x < width; x++) o[x] = (uint8_t)((3 * near[x] + far[x] + bias) >> 2);
      }
      break;
    case H2V2_FANCY: {
      std::vector<int> sums(dw);
      int *colsum = sums.data();
      for (int y = 0; y < height; y++) {
        uint8_t *o = dst + (size_t)y * width;
        int iy = y >> 1;
        int ny = (y & 1) ? (iy + 1 < dh ? iy + 1 : dh - 1) : (iy > 0 ? iy - 1 : 0);
        const uint8_t *near = src + (size_t)iy * dw, *far = src + (size_t)ny * dw;
        for (int i = 0; i < dw; i++) colsum[i] = 3 * near[i] + far[i];
        for (int x = 0; x < width; x++) {
          int i = x >> 1;
          if ((x & 1) == 0)
            o[x] = (uint8_t)((3 * colsum[i] + colsum[i > 0 ? i - 1 : 0] + 8) >> 4);
          else
            o[x] = (uint8_t)((3 * colsum[i] + colsum[i + 1 < dw ? i + 1 : dw - 1] + 7) >> 4);
        }
      }
      break;
    }
    default:  // REPLICATE: h2v1, h2v2 at most two samples wide, int_upsample
      for (int y = 0; y < height; y++) {
        uint8_t *o = dst + (size_t)y * width;
        const uint8_t *r = src + (size_t)(y / c.vr) * dw;
        for (int x = 0; x < width; x++) o[x] = r[x / c.hr];
      }
      break;
  }
  return out;
}

const int SCALEBITS = 16;
const int32_t ONE_HALF = (int32_t)1 << (SCALEBITS - 1);
inline int32_t FIX(double x) { return (int32_t)(x * (1L << SCALEBITS) + 0.5); }

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    for (int i = 0, x = -128; i <= 255; i++, x++) {
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-FIX(0.71414)) * x;
      cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
  }
};

// jdcolor.c build_rgb_y_table (rgb_gray_convert)
struct RgbYTables {
  int32_t r[256], g[256], b[256];
  RgbYTables() {
    for (int i = 0; i < 256; i++) {
      r[i] = FIX(0.29900) * i;
      g[i] = FIX(0.58700) * i;
      b[i] = FIX(0.11400) * i + ONE_HALF;
    }
  }
};

inline uint8_t clamp255(int x) { return (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x); }

// cv2's icvCvt_CMYK2BGR_8u_C4C3R (modules/imgcodecs/src/utils.cpp) on one
// CMYK sample: each of C, M, Y weighted by K
inline int cmyk_channel(int v, int k) { return k - ((255 - v) * k >> 8); }

// the decoded components (decode_all done) as the read gives them: RGB or
// gray as cv2 converts them, or (RAW) each component as it is, interleaved
void decode_pixels(Decoder &dec, bool gray, uint8_t *out) {
  const int H = dec.height, W = dec.width;
  const size_t npix = (size_t)H * W;
  std::vector<std::array<int, 10>> latch, prev;
  const bool smooth = !dec.lossless && smoothing_ok(dec, latch, prev);
  // a component at the full size: upsample, after the IDCT (and block
  // smoothing) or the lossless samples
  auto pixels = [&](size_t ci) {
    Component &c = dec.comps[ci];
    std::vector<uint8_t> p =
        dec.lossless ? std::move(c.samples)
                     : plane(c, dec.mcuy, dec.last_good_row, smooth ? latch[ci].data() : nullptr,
                             smooth ? prev[ci].data() : nullptr);
    return upsample(std::move(p), c, H, W);
  };
  switch (dec.space) {
    case GRAY:
    case YCC: {
      std::vector<uint8_t> y = pixels(0);
      if (gray) {
        std::memcpy(out, y.data(), npix);
      } else if (dec.space == GRAY) {
        const uint8_t *yp = y.data();
        for (size_t i = 0; i < npix; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = yp[i];
      } else {
        std::vector<uint8_t> cbv = pixels(1), crv = pixels(2);
        const uint8_t *yp = y.data(), *cb = cbv.data(), *cr = crv.data();
        static const YccTables t;
        for (size_t i = 0; i < npix; i++) {
          int yy = yp[i], b = cb[i], r = cr[i];
          out[3 * i] = clamp255(yy + t.cr_r[r]);
          out[3 * i + 1] = clamp255(yy + (int)((t.cb_g[b] + t.cr_g[r]) >> 16));
          out[3 * i + 2] = clamp255(yy + t.cb_b[b]);
        }
      }
      break;
    }
    case RGB: {
      std::vector<uint8_t> rv = pixels(0), gv = pixels(1), bv = pixels(2);
      const uint8_t *r = rv.data(), *g = gv.data(), *b = bv.data();
      if (gray) {
        static const RgbYTables t;
        for (size_t i = 0; i < npix; i++) out[i] = (uint8_t)((t.r[r[i]] + t.g[g[i]] + t.b[b[i]]) >> SCALEBITS);
      } else {
        for (size_t i = 0; i < npix; i++) {
          out[3 * i] = r[i];
          out[3 * i + 1] = g[i];
          out[3 * i + 2] = b[i];
        }
      }
      break;
    }
    case RAW: {
      const size_t nc = dec.comps.size();
      for (size_t ci = 0; ci < nc; ci++) {
        std::vector<uint8_t> v = pixels(ci);
        const uint8_t *p = v.data();
        for (size_t i = 0; i < npix; i++) out[nc * i + ci] = p[i];
      }
      break;
    }
    case CMYK:
    case YCCK: {
      // libjpeg gives CMYK (ycck_cmyk_convert first for YCCK); cv2
      // converts it: R, G, B from C, M, Y weighted by K, gray from those
      // with 14-bit weights (icvCvt_CMYK2Gray_8u_C4C1R)
      std::vector<uint8_t> v0 = pixels(0), v1 = pixels(1), v2 = pixels(2), v3 = pixels(3);
      const uint8_t *p0 = v0.data(), *p1 = v1.data(), *p2 = v2.data(), *k = v3.data();
      static const YccTables t;
      const int cR = 4899, cG = 9617, cB = 1868;  // 0.299, 0.587, 0.114 at 14 bits
      for (size_t i = 0; i < npix; i++) {
        int c = p0[i], m = p1[i], y = p2[i], kk = k[i];
        if (dec.space == YCCK) {
          int yy = p0[i], cb = p1[i], cr = p2[i];
          c = clamp255(255 - (yy + t.cr_r[cr]));
          m = clamp255(255 - (yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
          y = clamp255(255 - (yy + t.cb_b[cb]));
        }
        const int r = cmyk_channel(c, kk), g = cmyk_channel(m, kk), b = cmyk_channel(y, kk);
        if (gray) {
          out[i] = (uint8_t)((b * cB + g * cG + r * cR + (1 << 13)) >> 14);
        } else {
          out[3 * i] = (uint8_t)r;
          out[3 * i + 1] = (uint8_t)g;
          out[3 * i + 2] = (uint8_t)b;
        }
      }
      break;
    }
  }
}

void write_msg(char *msg, int64_t msg_len, const std::string &s) {
  if (msg && msg_len > 0) std::snprintf(msg, (size_t)msg_len, "%s", s.c_str());
}

}  // namespace

extern "C" {

// info: height, width, components, progressive, exif TIFF offset (-1: none),
// exif length; gray: the read mode, which decides some refusals
int jpeg_header(const uint8_t *data, int64_t n, int gray, int64_t *info, char *msg,
                int64_t msg_len) {
  Decoder dec;
  dec.d = data;
  dec.n = (size_t)n;
  try {
    dec.read_header(gray != 0);
  } catch (Fail &f) {
    write_msg(msg, msg_len, f.msg);
    return f.code;
  }
  info[0] = dec.height;
  info[1] = dec.width;
  info[2] = (int64_t)dec.comps.size();
  info[3] = dec.progressive;
  info[4] = dec.exif_off;
  info[5] = dec.exif_len;
  return 0;
}

// out: height * width * 3 RGB bytes, or height * width when gray.  memory:
// read the data as cv2.imdecode's memory source does, which suspends where
// libjpeg's stdio source (cv2.imread) inserts an end marker; a read past
// the end then fails the decode, as it fails cv2's (anywhere in a
// multi-scan image, whose scans jpeg_start_decompress absorbs up to EOI; up
// to the last MCU of a single scan, after which jpeg_finish_decompress's
// suspension goes unchecked)
int jpeg_decode_src(const uint8_t *data, int64_t n, int gray, int memory, uint8_t *out,
                    int64_t out_len, char *msg, int64_t msg_len) {
  Decoder dec;
  dec.d = data;
  dec.n = (size_t)n;
  try {
    dec.read_header(gray != 0);
    int64_t need = (int64_t)dec.height * dec.width * (gray ? 1 : 3);
    if (out_len < need) fail(1, "output buffer too small");
    dec.decode_all();
    if (memory && dec.past_end) fail(1, "JPEG data cut short (cv2.imdecode's source suspends)");
    decode_pixels(dec, gray != 0, out);
  } catch (Fail &f) {
    write_msg(msg, msg_len, f.msg);
    return f.code;
  }
  return 0;
}

// the stdio source's read (cv2.imread)
int jpeg_decode(const uint8_t *data, int64_t n, int gray, uint8_t *out, int64_t out_len, char *msg,
                int64_t msg_len) {
  return jpeg_decode_src(data, n, gray, 0, out, out_len, msg, msg_len);
}

// JPEG-in-TIFF as libtiff's tif_jpeg.c reads it: `tables` (the JPEGTables
// tag; may be empty) first as a tables-only stream, then the strip or
// tile's stream `data`; both of libtiff's sources insert an end marker past
// their end.  rgb: JPEGCOLORMODE_RGB (jpeg_color_space YCbCr,
// out_color_space RGB), else JCS_UNKNOWN (each component as it is).  info:
// height, width, components, component 0's h and v sampling factors.  With
// out null only the header is read.
int jpeg_tiff_decode(const uint8_t *tables, int64_t tn, const uint8_t *data, int64_t n, int rgb,
                     int64_t *info, uint8_t *out, int64_t out_len, char *msg, int64_t msg_len) {
  Decoder dec;
  dec.force = rgb ? YCC : RAW;
  try {
    if (tn > 0) {
      dec.d = tables;
      dec.n = (size_t)tn;
      if (tn < 2 || tables[0] != 0xFF || tables[1] != 0xD8) fail(1, "JPEGTables is not a JPEG stream");
      dec.pos = 2;
      if (dec.read_markers() || dec.frame) fail(1, "JPEGTables holds more than tables");
    }
    dec.d = data;
    dec.n = (size_t)n;
    dec.read_header(false);
    info[0] = dec.height;
    info[1] = dec.width;
    info[2] = (int64_t)dec.comps.size();
    info[3] = dec.comps[0].h;
    info[4] = dec.comps[0].v;
    if (!out) return 0;
    const int nc = rgb ? 3 : (int)dec.comps.size();
    if (out_len < (int64_t)dec.height * dec.width * nc) fail(1, "output buffer too small");
    dec.decode_all();
    decode_pixels(dec, false, out);
  } catch (Fail &f) {
    write_msg(msg, msg_len, f.msg);
    return f.code;
  }
  return 0;
}
}
