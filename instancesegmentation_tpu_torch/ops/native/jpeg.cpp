// Baseline and progressive JPEG decoding with libjpeg's arithmetic, so that
// the pixels equal cv2.imread's (libjpeg-turbo, default decompression
// parameters) bit for bit.
//
// What is followed, and where it lives in libjpeg:
//   - Huffman decoding with libjpeg's reaction to running out of data
//     (jdhuff.c, jdphuff.c): the MCU in which the data ends is decoded with
//     zero bits, later MCUs of the segment stay zero (gray);
//   - restart markers with jdmarker.c's resync rules;
//   - progressive scans: DC first/refine, AC first/refine with EOB runs,
//     the quantisation tables latched at each component's first scan;
//   - the accurate integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2)
//     clamped around CENTERJSAMPLE;
//   - fancy upsampling of 4:2:2 and 4:2:0 chroma (jdsample.c h2v1, h2v2;
//     plain replication when the chroma plane is at most two samples
//     wide), with the edge rows and columns repeated as jdmainct.c does;
//   - YCbCr -> RGB through jdcolor.c's fixed-point tables (SCALEBITS 16).
//
// Gray output of a colour file is the Y plane; colour output of a gray file
// repeats Y.  Orientation is left to the caller: jpeg_header reports where
// the first APP1 segment's TIFF block lies, as cv2 reads it.
//
// Return codes: 0 decoded; 1 the file cannot be decoded (cv2.imread gives
// None: no image, headers cut or corrupt); 2 a valid form this decoder does
// not take (arithmetic coding, 12-bit, lossless, CMYK or RGB components,
// sampling other than 4:4:4, 4:2:2, 4:2:0).  A message goes into msg.
#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for safety in decoder (libjpeg's jpeg_natural_order)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Fail {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string &msg) { throw Fail{code, msg}; }

struct Huff {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  // 9-bit lookahead: (length << 8) | symbol, length 0 when the code is longer
  uint16_t look[512];

  void build(bool is_dc) {
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
        if (vals[i] > 15) fail(1, "bad Huffman table");
    }
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;        // allocated blocks (whole MCUs)
  int wblocks = 0, hblocks = 0;  // blocks holding image samples
  int dw = 0, dh = 0;        // downsampled width and height
  bool latched = false;
  uint16_t q[64] = {0};  // all zero until latched: an unscanned component is gray
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
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
  uint64_t acc = 0;
  int nbits = 0;
  bool at_marker = false;
  bool insufficient = false;

  uint8_t at(size_t p) const { return p < n ? d[p] : ((p - n) & 1) ? 0xD9 : 0xFF; }

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
  int decode(const Huff &t) {
    if (nbits < 9) fill();
    if (nbits >= 9) {
      uint16_t e = t.look[acc >> 55];
      if (e >> 8) {
        int l = e >> 8;
        acc <<= l;
        nbits -= l;
        return e & 0xFF;
      }
    }
    // libjpeg's slow path, one bit at a time
    int code = bit();
    int l = 1;
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

struct Decoder {
  const uint8_t *d;
  size_t n;  // the file's length
  size_t pos = 0;
  bool progressive = false;
  bool frame = false;
  int height = 0, width = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int64_t exif_off = -1, exif_len = 0;
  bool any_app1 = false;
  bool frame_scanned = false;
  int scan_number = 0;
  int last_good_row = 0;  // the last iMCU row entered before the data ran out

  // libjpeg's stdio source inserts FF D9 at each read past the end
  uint8_t at(size_t p) const { return p < n ? d[p] : ((p - n) & 1) ? 0xD9 : 0xFF; }
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
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
      fail(2, "lossless JPEG is not decoded (ROADMAP A10 part 3)");
    if (marker >= 0xC9) fail(2, "arithmetic-coded JPEG is not decoded (ROADMAP A10 part 3)");
    if (marker == 0xC5 || marker == 0xC6) fail(2, "hierarchical JPEG is not decoded (ROADMAP A10 part 3)");
    progressive = marker == 0xC2;
    int len = u16();
    int precision = byte();
    height = u16();
    width = u16();
    int nc = byte();
    if (len != 8 + 3 * nc) fail(1, "bad SOF length");
    if (height <= 0 || width <= 0 || nc <= 0) fail(1, "empty JPEG image");
    if (precision != 8) fail(2, std::to_string(precision) + "-bit JPEG is not decoded (ROADMAP A10 part 3)");
    comps.resize(nc);
    for (auto &c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail(1, "bad component");
    }
    frame = true;
  }

  void check_form() {
    int nc = (int)comps.size();
    if (nc != 1 && nc != 3)
      fail(2, std::to_string(nc) + "-component (CMYK or other) JPEG is not decoded (ROADMAP A10 part 3)");
    if (nc == 3) {
      // jdapimin.c default_decompress_parms: JFIF means YCbCr, then Adobe's
      // transform flag, then the component ids
      bool rgb = !jfif && (adobe ? adobe_transform == 0
                                 : comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B');
      if (rgb) fail(2, "RGB-coded JPEG is not decoded (ROADMAP A10 part 3)");
      const Component &y = comps[0];
      bool chroma11 = comps[1].h == 1 && comps[1].v == 1 && comps[2].h == 1 && comps[2].v == 1;
      bool ok = chroma11 && ((y.h == 1 && y.v == 1) || (y.h == 2 && y.v == 1) || (y.h == 2 && y.v == 2));
      if (!ok)
        fail(2, "JPEG sampling factors other than 4:4:4, 4:2:2 and 4:2:0 are not decoded (ROADMAP A10 part 3)");
    }
    hmax = vmax = 1;
    for (auto &c : comps) {
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto &c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
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
      Huff h;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        h.bits[i] = byte();
        count += h.bits[i];
      }
      len -= 1 + 16;
      if (count > 256 || count > len) fail(1, "bad Huffman table");
      for (int i = 0; i < count; i++) h.vals[i] = byte();
      len -= count;
      bool is_ac = index & 0x10;
      index &= 0x0F;
      if (index > 3) fail(1, "bad DHT table index");
      h.build(!is_ac);
      (is_ac ? ac : dc)[index] = h;
    }
    if (len != 0) fail(1, "bad DHT length");
  }

  void read_app(int marker) {
    int len = u16();
    if (len < 2) fail(1, "bad marker length");
    size_t start = pos, body = (size_t)len - 2;
    uint8_t p[14];
    for (size_t i = 0; i < 14; i++) p[i] = at(start + i);
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

  // markers up to the next SOS (true) or EOI (false)
  bool read_markers() {
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) return false;
      if (m == 0xDA) return true;
      if (m == 0xD8) {
        if (frame_scanned || frame) fail(1, "unexpected SOI marker");
        continue;
      }
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RST: libjpeg warns and goes on
      if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        read_sof(m);
        continue;
      }
      if (m == 0xCC) fail(2, "arithmetic-coded JPEG is not decoded (ROADMAP A10 part 3)");
      if (m == 0xC4) {
        read_dht();
        continue;
      }
      if (m == 0xDB) {
        read_dqt();
        continue;
      }
      if (m == 0xDD) {
        if (u16() != 4) fail(1, "bad DRI length");
        restart_interval = u16();
        continue;
      }
      if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
        continue;
      }
      skip_segment();  // COM, DNL, DHP, EXP, JPGn
    }
  }

  // the header of the first scan: what jpeg_read_header needs
  void read_header() {
    if (n < 3 || d[0] != 0xFF || d[1] != 0xD8) fail(1, "not a JPEG file");
    pos = 2;
    if (!read_markers()) fail(1, "no image in the JPEG file");
    if (!frame) fail(1, "SOS before SOF");
    check_form();
  }

  // ---------------------------------------------------------------- scans
  struct Scan {
    std::vector<int> comp;  // component indices
    std::vector<int> td, ta;
    int ss = 0, se = 63, ah = 0, al = 0;
  };

  Scan read_sos() {
    Scan s;
    int len = u16();
    int ns = byte();
    if (len != 6 + 2 * ns || ns < 1 || ns > 4) fail(1, "bad SOS length");
    for (int i = 0; i < ns; i++) {
      int cid = byte(), t = byte();
      int ci = -1;
      for (size_t k = 0; k < comps.size(); k++)
        if (comps[k].id == cid) ci = (int)k;
      if (ci < 0) fail(1, "bad component in SOS");
      s.comp.push_back(ci);
      s.td.push_back(t >> 4);
      s.ta.push_back(t & 15);
    }
    s.ss = byte();
    s.se = byte();
    int a = byte();
    s.ah = a >> 4;
    s.al = a & 15;
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
        if (!qt_defined[c.tq]) fail(1, "quantization table not defined");
        std::memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.latched = true;
      }
      bool need_dc = !progressive || (s.ss == 0 && s.ah == 0);
      bool need_ac = !progressive ? true : s.ss != 0;
      if (s.td[i] > 3 || s.ta[i] > 3) fail(1, "bad Huffman table index");
      if (need_dc && !dc[s.td[i]].defined) fail(1, "Huffman table not defined");
      if (need_ac && !ac[s.ta[i]].defined) fail(1, "Huffman table not defined");
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

  // jdmarker.c: read_restart_marker, with jpeg_resync_to_restart
  void restart(Bits &br, int &next_rst) {
    br.discard();
    size_t p = br.pos;
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
    br.pos = p;
    br.at_marker = !consumed;
    if (consumed) br.insufficient = false;
  }

  void decode_scan(const Scan &s) {
    Bits br;
    br.d = d;
    br.n = n;
    br.pos = pos;
    int next_rst = 0;
    int restarts_to_go = restart_interval;
    int last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0;
    bool single = s.comp.size() == 1;
    int units_x, units_y;
    if (single) {
      units_x = comps[s.comp[0]].wblocks;
      units_y = comps[s.comp[0]].hblocks;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    const int p1 = 1 << s.al, m1 = -1 * (1 << s.al);
    enum { BASE, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE } kind;
    if (!progressive) kind = BASE;
    else if (s.ss == 0) kind = s.ah == 0 ? DC_FIRST : DC_REFINE;
    else kind = s.ah == 0 ? AC_FIRST : AC_REFINE;

    // libjpeg tests for the end of the data once per MCU: the MCU in which
    // the data ends is decoded to its end with zero bits
    bool skip = false;
    auto decode_block = [&](int ci_scan, int16_t *blk) {
      int ci = s.comp[ci_scan];
      switch (kind) {
        case BASE: {
          if (skip) return;
          int t = br.decode(dc[s.td[ci_scan]]);
          int diff = t ? extend(br.get(t), t) : 0;
          last_dc[ci_scan] += diff;
          blk[0] = (int16_t)last_dc[ci_scan];
          const Huff &at = ac[s.ta[ci_scan]];
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
          (void)ci;
          return;
        }
        case DC_FIRST: {
          if (skip) return;
          int t = br.decode(dc[s.td[ci_scan]]);
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
          const Huff &at = ac[s.ta[ci_scan]];
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
          const Huff &at = ac[s.ta[ci_scan]];
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

    for (int my = 0; my < units_y; my++) {
      for (int mx = 0; mx < units_x; mx++) {
        if (restart_interval) {
          if (restarts_to_go == 0) {
            restart(br, next_rst);
            for (int &v : last_dc) v = 0;
            eobrun = 0;
            restarts_to_go = restart_interval;
          }
        }
        skip = br.insufficient;
        if (!skip) last_good_row = single ? my / comps[s.comp[0]].v : my;
        if (single) {
          Component &c = comps[s.comp[0]];
          decode_block(0, c.block(my, mx));
        } else {
          for (size_t i = 0; i < s.comp.size(); i++) {
            Component &c = comps[s.comp[i]];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++) decode_block((int)i, c.block(my * c.v + v, mx * c.h + h));
          }
        }
        if (restart_interval) restarts_to_go--;
      }
    }
    pos = br.pos;
  }

  void decode_all() {
    for (auto &c : comps) {
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      std::fill(c.prev_bits, c.prev_bits + 64, 0);
    }
    // pos is just after the first SOS marker
    for (;;) {
      Scan s = read_sos();
      frame_scanned = true;
      decode_scan(s);
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

// chroma plane (dh x dw) brought to full size (height x width)
std::vector<uint8_t> upsample(const std::vector<uint8_t> &in, const Component &c, int hmax, int vmax,
                              int height, int width) {
  int hf = hmax / c.h, vf = vmax / c.v;
  std::vector<uint8_t> out((size_t)height * width);
  const int dw = c.dw, dh = c.dh;
  if (hf == 1 && vf == 1) return in;
  auto at = [&](int y, int x) -> int { return in[(size_t)y * dw + x]; };
  bool fancy = dw > 2;
  if (hf == 2 && vf == 1) {
    for (int y = 0; y < height; y++) {
      uint8_t *o = &out[(size_t)y * width];
      for (int x = 0; x < width; x++) {
        int i = x >> 1;
        if (!fancy) {
          o[x] = (uint8_t)at(y, i);
        } else if ((x & 1) == 0) {
          o[x] = (uint8_t)((3 * at(y, i) + at(y, i > 0 ? i - 1 : 0) + 1) >> 2);
        } else {
          o[x] = (uint8_t)((3 * at(y, i) + at(y, i + 1 < dw ? i + 1 : dw - 1) + 2) >> 2);
        }
      }
    }
    return out;
  }
  // h2v2
  std::vector<int> colsum(dw);
  for (int y = 0; y < height; y++) {
    uint8_t *o = &out[(size_t)y * width];
    int iy = y >> 1;
    if (!fancy) {
      for (int x = 0; x < width; x++) o[x] = (uint8_t)at(iy, x >> 1);
      continue;
    }
    int ny = (y & 1) ? (iy + 1 < dh ? iy + 1 : dh - 1) : (iy > 0 ? iy - 1 : 0);
    for (int i = 0; i < dw; i++) colsum[i] = 3 * at(iy, i) + at(ny, i);
    for (int x = 0; x < width; x++) {
      int i = x >> 1;
      if ((x & 1) == 0)
        o[x] = (uint8_t)((3 * colsum[i] + colsum[i > 0 ? i - 1 : 0] + 8) >> 4);
      else
        o[x] = (uint8_t)((3 * colsum[i] + colsum[i + 1 < dw ? i + 1 : dw - 1] + 7) >> 4);
    }
  }
  return out;
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int SCALEBITS = 16;
    const int32_t ONE_HALF = (int32_t)1 << (SCALEBITS - 1);
    auto FIX = [](double x) { return (int32_t)(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i <= 255; i++, x++) {
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-FIX(0.71414)) * x;
      cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
  }
};

inline uint8_t clamp255(int x) { return (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x); }

void write_msg(char *msg, int64_t msg_len, const std::string &s) {
  if (msg && msg_len > 0) std::snprintf(msg, (size_t)msg_len, "%s", s.c_str());
}

}  // namespace

extern "C" {

// info: height, width, components, progressive, exif TIFF offset (-1: none),
// exif length
int jpeg_header(const uint8_t *data, int64_t n, int64_t *info, char *msg, int64_t msg_len) {
  Decoder dec;
  dec.d = data;
  dec.n = (size_t)n;
  try {
    dec.read_header();
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

// out: height * width * 3 RGB bytes, or height * width when gray
int jpeg_decode(const uint8_t *data, int64_t n, int gray, uint8_t *out, int64_t out_len, char *msg,
                int64_t msg_len) {
  Decoder dec;
  dec.d = data;
  dec.n = (size_t)n;
  try {
    dec.read_header();
    int64_t need = (int64_t)dec.height * dec.width * (gray ? 1 : 3);
    if (out_len < need) fail(1, "output buffer too small");
    dec.decode_all();
    const int H = dec.height, W = dec.width;
    std::vector<std::array<int, 10>> latch, prev;
    const bool smooth = smoothing_ok(dec, latch, prev);
    auto pixels = [&](size_t ci) {
      return plane(dec.comps[ci], dec.mcuy, dec.last_good_row, smooth ? latch[ci].data() : nullptr,
                   smooth ? prev[ci].data() : nullptr);
    };
    std::vector<uint8_t> y = pixels(0);
    if (gray) {
      std::memcpy(out, y.data(), (size_t)H * W);
      return 0;
    }
    if (dec.comps.size() == 1) {
      for (size_t i = 0; i < (size_t)H * W; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      return 0;
    }
    std::vector<uint8_t> cb = upsample(pixels(1), dec.comps[1], dec.hmax, dec.vmax, H, W);
    std::vector<uint8_t> cr = upsample(pixels(2), dec.comps[2], dec.hmax, dec.vmax, H, W);
    static const YccTables t;
    for (size_t i = 0; i < (size_t)H * W; i++) {
      int yy = y[i], b = cb[i], r = cr[i];
      out[3 * i] = clamp255(yy + t.cr_r[r]);
      out[3 * i + 1] = clamp255(yy + (int)((t.cb_g[b] + t.cr_g[r]) >> 16));
      out[3 * i + 2] = clamp255(yy + t.cb_b[b]);
    }
  } catch (Fail &f) {
    write_msg(msg, msg_len, f.msg);
    return f.code;
  }
  return 0;
}
}
