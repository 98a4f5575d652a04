// The per-code loops of the port's image decoders (core/gif.py, core/hdr.py,
// core/bmp.py, core/tiff.py), as cv2 5.0 runs them (libtiff 4.7's codecs for
// TIFF), and of its GIF, HDR and TIFF encoders, as cv2 5.0 writes those
// files (its own GIF encoder, rgbe.cpp, libtiff 4.7.1's LZW); headers,
// palettes and the conversion to pixels stay in Python.
// Built with g++ by ops/native/build.py at first use and bound with ctypes
// (ops/native/image_codes.py).
//
// The GIF, HDR and BMP functions read `data[pos:n]` and return 0, or 1 where
// cv2's decoder gives up (data cut short, a code or run it refuses).  The
// TIFF codecs fill `out[0:occ]` (zeros where they stop) and return 0, or 1
// where libtiff reports an error, whose partial output cv2 keeps.  A read
// never goes past `n` and a write never past its output.  The encoders
// write into an output their callers size for the worst case and return
// the number of bytes written.

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <vector>

extern "C" {

// GIF: the LZW image data of one frame, from its sub-blocks (`pos` at the
// first block's length byte, after the minimum code size), into `npix`
// palette indices. Codes are read LSB first over the sub-blocks; the clear
// code resets the table and the code width, the end code ends the frame
// (what follows it is not read); the width grows when the next entry
// reaches 2^width, up to 12 bits, and a full table (4096 entries) takes no
// more entries until a clear code. A code past the table, a stream that
// gives more or fewer than `npix` indices, or data cut short returns 1.
int gif_lzw(const uint8_t* data, int64_t n, int64_t pos, int min_size, uint8_t* out,
            int64_t npix) {
  if (min_size < 2 || min_size > 11) return 1;
  const int clear = 1 << min_size, eoi = clear + 1;
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096), stack(4097);
  int width = min_size + 1, next = eoi + 1, prev = -1;
  int64_t written = 0;
  uint32_t bits = 0;
  int nbits = 0;
  int64_t block_left = 0;
  for (int c = 0; c < clear; ++c) {
    suffix[c] = (uint8_t)c;
    first[c] = (uint8_t)c;
  }
  while (true) {
    while (nbits < width) {
      if (block_left == 0) {
        if (pos >= n) return 1;
        block_left = data[pos++];
        if (block_left == 0) return written == npix ? 0 : 1;  // no end code
      }
      if (pos >= n) return 1;
      bits |= (uint32_t)data[pos++] << nbits;
      nbits += 8;
      --block_left;
    }
    const int code = bits & ((1u << width) - 1);
    bits >>= width;
    nbits -= width;
    if (code == clear) {
      width = min_size + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) return written == npix ? 0 : 1;
    int len = 0, c = code;
    if (prev < 0) {  // the first code after a clear: a literal, no new entry
      if (code >= clear) return 1;
    } else if (code == next) {  // the entry this code is about to make
      stack[len++] = first[prev];
      c = prev;
    } else if (code > next) {
      return 1;
    }
    while (c >= clear) {
      stack[len++] = suffix[c];
      c = prefix[c];
    }
    stack[len++] = (uint8_t)c;
    if (written + len > npix) return 1;
    for (int i = len - 1; i >= 0; --i) out[written++] = stack[i];
    if (prev >= 0 && next < 4096) {
      prefix[next] = (uint16_t)prev;
      suffix[next] = (uint8_t)c;
      first[next] = first[prev];
      ++next;
      if (next == (1 << width) && width < 12) ++width;
    }
    prev = code;
  }
}

// Radiance HDR: `height` scanlines of `width` RGBE pixels into `rgbe`
// [height * width * 4], as rgbe.cpp's RGBE_ReadPixels_RLE reads them: flat
// pixels where the width is below 8 or above 0x7fff, or from the first
// scanline that does not start 2, 2 (then every pixel after it flat);
// otherwise each scanline's four channels in runs (count > 128: count - 128
// copies of the next byte) and literals (count bytes); a zero count, a run
// past the scanline, a scanline whose width differs, or data cut short
// returns 1.
int hdr_pixels(const uint8_t* data, int64_t n, int64_t pos, int width, int height,
               uint8_t* rgbe) {
  const int64_t total = (int64_t)width * height;
  if (width < 8 || width > 0x7fff) {
    if (pos + 4 * total > n) return 1;
    memcpy(rgbe, data + pos, 4 * total);
    return 0;
  }
  std::vector<uint8_t> line(4 * (size_t)width);
  for (int y = 0; y < height; ++y) {
    uint8_t* dst = rgbe + (int64_t)y * width * 4;
    if (pos + 4 > n) return 1;
    const uint8_t* p = data + pos;
    if (p[0] != 2 || p[1] != 2 || (p[2] & 0x80)) {  // flat from here on
      const int64_t rest = total - (int64_t)y * width;
      if (pos + 4 * rest > n) return 1;
      memcpy(dst, p, 4 * rest);
      return 0;
    }
    if (((int)p[2] << 8 | p[3]) != width) return 1;
    pos += 4;
    for (int ch = 0; ch < 4; ++ch) {
      uint8_t* q = line.data() + (size_t)ch * width;
      uint8_t* end = q + width;
      while (q < end) {
        if (pos + 2 > n) return 1;
        int count = data[pos];
        const uint8_t v = data[pos + 1];
        pos += 2;
        if (count > 128) {
          count -= 128;
          if (count > end - q) return 1;
          memset(q, v, count);
          q += count;
        } else {
          if (count == 0 || count > end - q) return 1;
          *q++ = v;
          if (--count > 0) {
            if (pos + count > n) return 1;
            memcpy(q, data + pos, count);
            q += count;
            pos += count;
          }
        }
      }
    }
    for (int x = 0; x < width; ++x)
      for (int ch = 0; ch < 4; ++ch) dst[4 * x + ch] = line[(size_t)ch * width + x];
  }
  return 0;
}

// BMP RLE8 (`bits` 8) and RLE4 (`bits` 4): palette indices [height][width]
// in the file's row order, as cv2's grfmt_bmp.cpp decodes them. Pairs of
// (count, value): an encoded run (count > 0; RLE4 alternates the value's
// two nibbles), or after a 0 an escape: 0 end of line, 1 end of bitmap, 2 a
// delta (dx, dy), >= 3 an absolute run of that many indices padded to a
// 16-bit boundary. The gaps the escapes leave take index 0, filled in
// reading order over rows; a run or an absolute run must fit in the current
// row. RLE8: end of line fills the rest of the row, end of bitmap the rest of
// the image, a delta dx + dy * width pixels; runs that end a row wrap to the
// next, after which an end of line is ignored. RLE4, as cv2 runs it: end of
// line and end of bitmap both fill the rest of the row (and the decode goes
// on), a delta fills dx pixels (dy is not used); runs stay at the row's end
// until an escape. The decode ends after the last row (RLE8 also at end of
// bitmap); data cut short or a run past its row returns 1.
int bmp_rle(const uint8_t* data, int64_t n, int64_t pos, int width, int height, int bits,
            uint8_t* out) {
  int64_t x = 0, y = 0;
  bool line_end_flag = false;
  // fill `count` pixels with `v` from (x, y), row after row
  auto fill = [&](int64_t count, uint8_t v) {
    do {
      int64_t take = count < width - x ? count : width - x;
      if (y < height) memset(out + y * width + x, v, take);
      x += take;
      count -= take;
      if (x >= width) {
        x = 0;
        if (++y >= height) break;
      }
    } while (count > 0);
  };
  while (true) {
    if (pos + 2 > n) return 1;
    const int len = data[pos], code = data[pos + 1];
    pos += 2;
    if (len != 0) {  // encoded run
      if (x + len > width) return 1;
      if (bits == 8) {
        const int64_t prev_y = y;
        fill(len, (uint8_t)code);
        line_end_flag = y != prev_y;
        if (y >= height) break;
      } else {
        const uint8_t c2[2] = {(uint8_t)(code >> 4), (uint8_t)(code & 15)};
        for (int i = 0; i < len; ++i) out[y * width + x + i] = c2[i & 1];
        x += len;
      }
    } else if (code > 2) {  // absolute run
      if (x + code > width) return 1;
      const int sz = bits == 8 ? (code + 1) & ~1 : (((code + 1) >> 1) + 1) & ~1;
      if (pos + sz > n) return 1;
      for (int i = 0; i < code; ++i)
        out[y * width + x + i] =
            bits == 8 ? data[pos + i] : (uint8_t)(data[pos + i / 2] >> (i & 1 ? 0 : 4) & 15);
      pos += sz;
      x += code;
      line_end_flag = false;
    } else if (bits == 4) {  // end of line (0), end of bitmap (1), delta (2)
      int64_t skip = width - x;
      if (code == 2) {
        if (pos + 2 > n) return 1;
        skip = data[pos];
        pos += 2;
      }
      fill(skip, 0);
      if (y >= height) break;
    } else {
      int64_t skip = width - x, rows = height - y;
      if (code != 0 || !line_end_flag || skip < width) {
        if (code == 2) {
          if (pos + 2 > n) return 1;
          skip = data[pos];
          rows = data[pos + 1];
          pos += 2;
        }
        if (code != 0) skip += rows * width;
        if (y >= height) break;
        fill(skip, 0);
        if (y >= height) break;
      }
      line_end_flag = false;
      if (y >= height) break;
    }
  }
  return 0;
}

// TIFF LZW (tif_lzw.c): 9- to 12-bit codes after a clear code, 256 clear,
// 257 end of information, entries from 258.  The current form reads codes
// MSB first and widens them one entry early (at 511, 1023, 2047); the old
// form (`old`: LZWPreDecode takes it where the data starts 00 and then an
// odd byte) reads them LSB first and widens at 512, 1024, 2048.  An error:
// the data running out before the output is full, a code before the first
// clear code or past the table (a full table takes only clear and end
// codes), a clear code followed by a code that is not a literal.
int tiff_lzw(const uint8_t* data, int64_t n, uint8_t* out, int64_t occ) {
  const bool old = n >= 2 && data[0] == 0 && (data[1] & 1);
  const int early = old ? 0 : 1;
  std::vector<uint16_t> prefix(4096), length(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  for (int c = 0; c < 256; ++c) {
    suffix[c] = first[c] = (uint8_t)c;
    length[c] = 1;
  }
  int width = 9, next = -1, prev = -1;  // next -1: no clear code yet
  int64_t pos = 0, written = 0;
  uint64_t bits = 0;
  int nbits = 0;
  while (written < occ) {
    while (nbits < width) {
      if (pos >= n) return 1;  // not terminated by an end code: short
      if (old) bits |= (uint64_t)data[pos++] << nbits;
      else bits = (bits << 8) | data[pos++];
      nbits += 8;
    }
    int code;
    if (old) {
      code = (int)(bits & ((1u << width) - 1));
      bits >>= width;
    } else {
      code = (int)((bits >> (nbits - width)) & ((1u << width) - 1));
    }
    nbits -= width;
    if (!old) bits &= (nbits ? (1ull << nbits) - 1 : 0);
    if (code == 256) {
      width = 9;
      next = 258;
      prev = -1;
      continue;
    }
    if (code == 257 || next < 0) return 1;  // the end before the output is full
    if (prev < 0) {  // the first code after a clear code: a literal
      if (code > 256) return 1;
      out[written++] = (uint8_t)code;
      prev = code;
      continue;
    }
    if (code > next || next >= 4096) return 1;
    // the string of `code` (or, for the entry about to be made, prev's
    // string and its first byte), written from its end; what passes the
    // output's end is dropped
    const int c = code == next ? prev : code;
    const int len = length[c] + (code == next);
    if (code == next && written + len - 1 < occ) out[written + len - 1] = first[prev];
    int64_t at = written + length[c] - 1;
    for (int k = c;; k = prefix[k]) {
      if (at < occ) out[at] = suffix[k];
      --at;
      if (k < 256) break;
    }
    prefix[next] = (uint16_t)prev;
    suffix[next] = first[c];
    first[next] = first[prev];
    length[next] = (uint16_t)(length[prev] + 1);
    ++next;
    if (next + early >= (1 << width) && width < 12) ++width;
    written += len;
    prev = code;
  }
  return 0;
}

// TIFF PackBits (tif_packbits.c): a count n >= 0 copies n + 1 bytes, -127..-1
// repeats the next byte 1 - n times, -128 is skipped; a run past the output is
// cut to fit; the data running out first is an error.
int tiff_packbits(const uint8_t* data, int64_t n, uint8_t* out, int64_t occ) {
  int64_t pos = 0, written = 0;
  while (pos < n && written < occ) {
    int c = (int8_t)data[pos++];
    if (c < 0) {
      if (c == -128) continue;
      int64_t run = 1 - c;
      if (run > occ - written) run = occ - written;
      if (pos >= n) break;
      memset(out + written, data[pos++], run);
      written += run;
    } else {
      int64_t run = c + 1;
      if (run > occ - written) run = occ - written;
      if (pos + run > n) break;
      memcpy(out + written, data + pos, run);
      written += run;
      pos += run;
    }
  }
  return written < occ ? 1 : 0;
}

// ---------------------------------------------------------------- CCITT
// T.4's modified Huffman codes: (code, length, run) of the white and black
// terminating (0-63) and make-up (64-1728) codes, then the make-up codes
// both colours share (1792-2560).
struct FaxCode {
  uint16_t code;
  uint8_t len;
  int16_t run;
};
const FaxCode kWhite[] = {
    {0x35, 8, 0}, {0x7, 6, 1}, {0x7, 4, 2}, {0x8, 4, 3}, {0xb, 4, 4}, {0xc, 4, 5},
    {0xe, 4, 6}, {0xf, 4, 7}, {0x13, 5, 8}, {0x14, 5, 9}, {0x7, 5, 10}, {0x8, 5, 11},
    {0x8, 6, 12}, {0x3, 6, 13}, {0x34, 6, 14}, {0x35, 6, 15}, {0x2a, 6, 16}, {0x2b, 6, 17},
    {0x27, 7, 18}, {0xc, 7, 19}, {0x8, 7, 20}, {0x17, 7, 21}, {0x3, 7, 22}, {0x4, 7, 23},
    {0x28, 7, 24}, {0x2b, 7, 25}, {0x13, 7, 26}, {0x24, 7, 27}, {0x18, 7, 28}, {0x2, 8, 29},
    {0x3, 8, 30}, {0x1a, 8, 31}, {0x1b, 8, 32}, {0x12, 8, 33}, {0x13, 8, 34}, {0x14, 8, 35},
    {0x15, 8, 36}, {0x16, 8, 37}, {0x17, 8, 38}, {0x28, 8, 39}, {0x29, 8, 40}, {0x2a, 8, 41},
    {0x2b, 8, 42}, {0x2c, 8, 43}, {0x2d, 8, 44}, {0x4, 8, 45}, {0x5, 8, 46}, {0xa, 8, 47},
    {0xb, 8, 48}, {0x52, 8, 49}, {0x53, 8, 50}, {0x54, 8, 51}, {0x55, 8, 52}, {0x24, 8, 53},
    {0x25, 8, 54}, {0x58, 8, 55}, {0x59, 8, 56}, {0x5a, 8, 57}, {0x5b, 8, 58}, {0x4a, 8, 59},
    {0x4b, 8, 60}, {0x32, 8, 61}, {0x33, 8, 62}, {0x34, 8, 63}, {0x1b, 5, 64}, {0x12, 5, 128},
    {0x17, 6, 192}, {0x37, 7, 256}, {0x36, 8, 320}, {0x37, 8, 384}, {0x64, 8, 448},
    {0x65, 8, 512}, {0x68, 8, 576}, {0x67, 8, 640}, {0xcc, 9, 704}, {0xcd, 9, 768},
    {0xd2, 9, 832}, {0xd3, 9, 896}, {0xd4, 9, 960}, {0xd5, 9, 1024}, {0xd6, 9, 1088},
    {0xd7, 9, 1152}, {0xd8, 9, 1216}, {0xd9, 9, 1280}, {0xda, 9, 1344}, {0xdb, 9, 1408},
    {0x98, 9, 1472}, {0x99, 9, 1536}, {0x9a, 9, 1600}, {0x18, 6, 1664}, {0x9b, 9, 1728}};
const FaxCode kBlack[] = {
    {0x37, 10, 0}, {0x2, 3, 1}, {0x3, 2, 2}, {0x2, 2, 3}, {0x3, 3, 4}, {0x3, 4, 5},
    {0x2, 4, 6}, {0x3, 5, 7}, {0x5, 6, 8}, {0x4, 6, 9}, {0x4, 7, 10}, {0x5, 7, 11},
    {0x7, 7, 12}, {0x4, 8, 13}, {0x7, 8, 14}, {0x18, 9, 15}, {0x17, 10, 16}, {0x18, 10, 17},
    {0x8, 10, 18}, {0x67, 11, 19}, {0x68, 11, 20}, {0x6c, 11, 21}, {0x37, 11, 22},
    {0x28, 11, 23}, {0x17, 11, 24}, {0x18, 11, 25}, {0xca, 12, 26}, {0xcb, 12, 27},
    {0xcc, 12, 28}, {0xcd, 12, 29}, {0x68, 12, 30}, {0x69, 12, 31}, {0x6a, 12, 32},
    {0x6b, 12, 33}, {0xd2, 12, 34}, {0xd3, 12, 35}, {0xd4, 12, 36}, {0xd5, 12, 37},
    {0xd6, 12, 38}, {0xd7, 12, 39}, {0x6c, 12, 40}, {0x6d, 12, 41}, {0xda, 12, 42},
    {0xdb, 12, 43}, {0x54, 12, 44}, {0x55, 12, 45}, {0x56, 12, 46}, {0x57, 12, 47},
    {0x64, 12, 48}, {0x65, 12, 49}, {0x52, 12, 50}, {0x53, 12, 51}, {0x24, 12, 52},
    {0x37, 12, 53}, {0x38, 12, 54}, {0x27, 12, 55}, {0x28, 12, 56}, {0x58, 12, 57},
    {0x59, 12, 58}, {0x2b, 12, 59}, {0x2c, 12, 60}, {0x5a, 12, 61}, {0x66, 12, 62},
    {0x67, 12, 63}, {0xf, 10, 64}, {0xc8, 12, 128}, {0xc9, 12, 192}, {0x5b, 12, 256},
    {0x33, 12, 320}, {0x34, 12, 384}, {0x35, 12, 448}, {0x6c, 13, 512}, {0x6d, 13, 576},
    {0x4a, 13, 640}, {0x4b, 13, 704}, {0x4c, 13, 768}, {0x4d, 13, 832}, {0x72, 13, 896},
    {0x73, 13, 960}, {0x74, 13, 1024}, {0x75, 13, 1088}, {0x76, 13, 1152}, {0x77, 13, 1216},
    {0x52, 13, 1280}, {0x53, 13, 1344}, {0x54, 13, 1408}, {0x55, 13, 1472}, {0x5a, 13, 1536},
    {0x5b, 13, 1600}, {0x64, 13, 1664}, {0x65, 13, 1728}};
const FaxCode kMakeUp[] = {
    {0x8, 11, 1792}, {0xc, 11, 1856}, {0xd, 11, 1920}, {0x12, 12, 1984}, {0x13, 12, 2048},
    {0x14, 12, 2112}, {0x15, 12, 2176}, {0x16, 12, 2240}, {0x17, 12, 2304}, {0x1c, 12, 2368},
    {0x1d, 12, 2432}, {0x1e, 12, 2496}, {0x1f, 12, 2560}};

// a code table read `width` bits at a time, the first bit of the data in
// the index's lowest bit (tif_fax3sm.c's 12- and 13-bit tables and its
// 7-bit main table): each entry a state, the code's length and its run.  An
// index no code fits is S_NULL of length 0; eleven zeros are an EOL of
// length 11 (the EOL's final 1 is found by the row's synchronisation).
enum FaxState : uint8_t {
  S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERM, S_MAKEUP, S_EOL
};
struct FaxEntry {
  uint8_t state, len;
  int16_t param;
};
struct FaxTable {
  int width;
  std::vector<FaxEntry> e;
  static int reverse(int v, int n) {
    int r = 0;
    for (int i = 0; i < n; ++i) r |= ((v >> i) & 1) << (n - 1 - i);
    return r;
  }
  void add(int code, int len, uint8_t state, int param) {
    const int low = reverse(code, len);
    for (int i = 0; i < (1 << (width - len)); ++i) e[low | (i << len)] = {state, (uint8_t)len,
                                                                          (int16_t)param};
  }
  FaxTable(const FaxCode* codes, int n, int w) : width(w), e(1 << w, FaxEntry{S_NULL, 0, 0}) {
    for (int i = 0; i < n; ++i) add(codes[i].code, codes[i].len,
                                    codes[i].run < 64 ? S_TERM : S_MAKEUP, codes[i].run);
    for (const FaxCode& c : kMakeUp) add(c.code, c.len, S_MAKEUP, c.run);
    add(0, 11, S_EOL, 0);
  }
  // the 2-D mode codes (T.4 table 4): P 0001, H 001, V0 1, VR1-3 011,
  // 000011, 0000011, VL1-3 010, 000010, 0000010, extension 0000001, EOL
  // 0000000 (its other four zeros read after it)
  FaxTable() : width(7), e(1 << 7, FaxEntry{S_NULL, 0, 0}) {
    add(1, 1, S_V0, 0);
    add(3, 3, S_VR, 1);
    add(2, 3, S_VL, 1);
    add(1, 3, S_HORIZ, 0);
    add(1, 4, S_PASS, 0);
    add(3, 6, S_VR, 2);
    add(2, 6, S_VL, 2);
    add(3, 7, S_VR, 3);
    add(2, 7, S_VL, 3);
    add(1, 7, S_EXT, 0);
    add(0, 7, S_EOL, 0);
  }
};

// the length of each of the two run arrays of an image `width` pixels wide
// (`runs` of tiff_fax holds 2 * fax_nruns + 4 entries, zero at first)
int64_t fax_nruns(int width, int two_d) {
  const int64_t n = ((int64_t)width + 1 + 31) / 32 * 32;  // TIFFroundup_32(width + 1, 32)
  return two_d ? 2 * n : n;
}

// tif_fax3.c's decoders (libtiff 4.7.1) on one strip or tile: `rows` rows
// of `width` pixels into `out` (rows of (width + 7) / 8 bytes, zero on
// entry; a 1 bit for a black run).  compression 2 (RLE: modified Huffman
// rows, each byte-aligned) and 32771 (RLEW: each row aligned to 16 bits,
// counted from the strip's first byte, whose address parity is `parity`),
// 3 (Group 3: each row after an EOL, 1-D, or with `two_d` a tag bit
// choosing 1-D or 2-D against the row above), 4 (Group 4: 2-D rows, the
// first against a white row, until the end or an EOFB); `runs` the
// image's run arrays, kept from strip to strip.
//
// The bits are read as libtiff's macros read them: a 32-bit accumulator
// filled a byte at a time where a lookup needs more bits than it holds,
// padded with zeros at the end of the data while any bit is left (so a
// decode runs on into the zeros), and the end reached only with none left.
// A code that fits no table ends its row, padded to the width.  A Group 3
// row whose EOL search runs out of data after its eleven zeros is decoded
// without its EOL, from the strip's first bit again, and from then on no Group 3 row looks for one (libtiff's
// FAXMODE_NOEOL, which lasts for the rest of the image: `*noeol` in and
// out).  The end of the data inside a row fills that row and stops with an
// error (Group 4: no error after a whole row); a row whose runs outgrow
// libtiff's run arrays stops the decode unfilled.  Returns 0, or 1 where
// libtiff reports an error.
int tiff_fax(int compression, int two_d, const uint8_t* data, int64_t n, int width, int rows,
             int parity, int* noeol, uint32_t* runs, uint8_t* out) {
  static const FaxTable white(kWhite, sizeof(kWhite) / sizeof(FaxCode), 12);
  static const FaxTable black(kBlack, sizeof(kBlack) / sizeof(FaxCode), 13);
  static const FaxTable mode2d;
  static uint8_t rev[256];
  static const bool rev_ready = [] {
    for (int i = 0; i < 256; ++i) rev[i] = (uint8_t)FaxTable::reverse(i, 8);
    return true;
  }();
  (void)rev_ready;
  const uint8_t* cp = data;
  const uint8_t* const ep = data + n;
  uint32_t acc = 0;
  int avail = 0;
  // NeedBits8 / NeedBits16: false where the data has ended with no bit left
  auto need8 = [&](int k) -> bool {
    if (avail < k) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = k;
      } else {
        acc |= (uint32_t)rev[*cp++] << avail;
        avail += 8;
      }
    }
    return true;
  };
  auto need16 = [&](int k) -> bool {
    if (avail < k) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = k;
      } else {
        acc |= (uint32_t)rev[*cp++] << avail;
        if ((avail += 8) < k) {
          if (cp >= ep) {
            avail = k;
          } else {
            acc |= (uint32_t)rev[*cp++] << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  };
  auto bits = [&](int k) -> int { return (int)(acc & ((1u << k) - 1)); };
  auto clear = [&](int k) {
    avail -= k;
    acc >>= k;
  };

  const bool is_2d_coded = compression == 4 || (compression == 3 && two_d);
  const int lastx = width, rowbytes = (width + 7) / 8;
  // Fax3SetupState's run arrays, a row's runs and the reference row's:
  // libtiff keeps them for the whole image, so a reference row read past
  // its imaginary last change finds runs of rows decoded earlier
  const int64_t nruns = fax_nruns(width, is_2d_coded);
  uint32_t* curruns = runs;
  uint32_t* refruns = runs + nruns;
  refruns[0] = (uint32_t)lastx;  // the white row above the first
  refruns[1] = 0;
  uint32_t* thisrun = curruns;
  uint32_t* pa = thisrun;
  uint32_t* pb = refruns;
  int a0 = 0, run_length = 0, b1 = 0, eolcnt = 0;
  enum { DONE, END, OVERFLOW };

  // SETVALUE: false where the run array is full (the decode stops)
  auto setvalue = [&](int x) -> bool {
    if (pa >= thisrun + nruns) return false;
    *pa++ = (uint32_t)(run_length + x);
    a0 += x;
    run_length = 0;
    return true;
  };
  auto cleanup = [&]() -> bool {  // CLEANUP_RUNS
    if (run_length && !setvalue(0)) return false;
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= (int)*--pa;
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (((pa - thisrun) & 1) && !setvalue(0)) return false;
        if (!setvalue(lastx - a0)) return false;
      } else if (a0 > lastx) {
        if (!setvalue(lastx) || !setvalue(0)) return false;
      }
    }
    return true;
  };
  auto fill = [&](uint8_t* row) {  // _TIFFFax3fillruns
    uint32_t x = 0;
    uint32_t* end = pa;
    if ((end - thisrun) & 1) *end++ = 0;
    for (uint32_t* r = thisrun; r < end; r += 2) {
      uint32_t w = r[0];
      if (x + w > (uint32_t)lastx || w > (uint32_t)lastx) w = r[0] = (uint32_t)lastx - x;
      x += w;
      uint32_t b = r[1];
      if (x + b > (uint32_t)lastx || b > (uint32_t)lastx) b = r[1] = (uint32_t)lastx - x;
      for (uint32_t i = x; i < x + b; ++i) row[i >> 3] |= (uint8_t)(0x80 >> (i & 7));
      x += b;
    }
  };
  // one modified Huffman run of `t`'s colour, make-up codes summed: DONE
  // the run is set (or an EOL or a code that fits no table ended the row:
  // `*row_ended`; an EOL of a 1-D row counts as the next row's), END the
  // data ended, OVERFLOW the run array is full
  auto mh_run = [&](const FaxTable& t, bool* row_ended, bool one_d = true) -> int {
    for (;;) {
      if (!need16(t.width)) return END;
      const FaxEntry e = t.e[bits(t.width)];
      clear(e.len);
      if (e.state == S_TERM) return setvalue(e.param) ? DONE : OVERFLOW;
      if (e.state == S_MAKEUP) {
        a0 += e.param;
        run_length += e.param;
        continue;
      }
      if (e.state == S_EOL && one_d) eolcnt = 1;
      *row_ended = true;
      return DONE;
    }
  };
  auto expand_1d = [&]() -> int {  // EXPAND1D
    for (;;) {
      bool ended = false;
      int rc = mh_run(white, &ended);
      if (rc == OVERFLOW) return OVERFLOW;
      if (rc == END) return cleanup() ? END : OVERFLOW;
      if (ended || a0 >= lastx) break;
      rc = mh_run(black, &ended);
      if (rc == OVERFLOW) return OVERFLOW;
      if (rc == END) return cleanup() ? END : OVERFLOW;
      if (ended || a0 >= lastx) break;
      if (pa[-1] == 0 && pa[-2] == 0) pa -= 2;
    }
    return cleanup() ? DONE : OVERFLOW;
  };
  auto expand_2d = [&]() -> int {  // EXPAND2D against the reference row
    uint32_t* const ref_end = refruns + nruns;
    auto check_b1 = [&]() -> bool {  // CHECK_b1
      if (pa != thisrun)
        while (b1 <= a0 && b1 < lastx) {
          if (pb + 1 >= ref_end) return false;
          b1 += (int)(pb[0] + pb[1]);
          pb += 2;
        }
      return true;
    };
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) return OVERFLOW;
      if (!need8(7)) return cleanup() ? END : OVERFLOW;
      const FaxEntry e = mode2d.e[bits(7)];
      clear(e.len);
      switch (e.state) {
        case S_PASS:
          if (!check_b1() || pb + 1 >= ref_end) return OVERFLOW;
          b1 += (int)*pb++;
          run_length += b1 - a0;
          a0 = b1;
          b1 += (int)*pb++;
          break;
        case S_HORIZ: {
          const bool black_first = (pa - thisrun) & 1;
          bool ended = false;
          int rc = mh_run(black_first ? black : white, &ended, false);
          if (rc == OVERFLOW) return OVERFLOW;
          if (rc == END) return cleanup() ? END : OVERFLOW;
          if (ended) return cleanup() ? DONE : OVERFLOW;
          rc = mh_run(black_first ? white : black, &ended, false);
          if (rc == OVERFLOW) return OVERFLOW;
          if (rc == END) return cleanup() ? END : OVERFLOW;
          if (ended) return cleanup() ? DONE : OVERFLOW;
          if (!check_b1()) return OVERFLOW;
          break;
        }
        case S_V0:
        case S_VR:
          if (!check_b1() || !setvalue(b1 - a0 + e.param) || pb >= ref_end) return OVERFLOW;
          b1 += (int)*pb++;
          break;
        case S_VL:
          if (!check_b1()) return OVERFLOW;
          if (b1 < a0 + e.param) return cleanup() ? DONE : OVERFLOW;
          if (!setvalue(b1 - a0 - e.param)) return OVERFLOW;
          if (pb == refruns) return cleanup() ? DONE : OVERFLOW;  // no run left of b1
          b1 -= (int)*--pb;
          break;
        case S_EXT:
          *pa++ = (uint32_t)(lastx - a0);
          return cleanup() ? DONE : OVERFLOW;
        default:  // S_EOL: its other four zeros
          *pa++ = (uint32_t)(lastx - a0);
          if (!need8(4)) return cleanup() ? END : OVERFLOW;
          clear(4);
          eolcnt = 1;
          return cleanup() ? DONE : OVERFLOW;
      }
    }
    if (run_length) {
      if (run_length + a0 < lastx) {  // a final V0 is expected
        if (!need8(1)) return cleanup() ? END : OVERFLOW;
        if (!bits(1)) return cleanup() ? DONE : OVERFLOW;
        clear(1);
      }
      if (!setvalue(0)) return OVERFLOW;
    }
    return cleanup() ? DONE : OVERFLOW;
  };
  // SYNC_EOL: DONE after the EOL, END where the data ends before its
  // eleven zeros; where it ends after them, the row is read without an EOL
  // from the strip's first bit (libtiff caches the input state again)
  auto sync_eol = [&]() -> int {
    if (*noeol) return DONE;
    if (eolcnt == 0) {
      for (;;) {
        if (!need16(11)) return END;
        if (bits(11) == 0) break;
        clear(1);
      }
    }
    for (;;) {
      if (!need8(8)) {  // no EOL: the row read from the strip's first bit
        *noeol = 1;
        cp = data;
        acc = 0;
        avail = 0;
        eolcnt = 0;
        return DONE;
      }
      if (bits(8)) break;
      clear(8);
    }
    while (bits(1) == 0) clear(1);
    clear(1);
    eolcnt = 0;
    return DONE;
  };

  for (int y = 0; y < rows; ++y) {
    uint8_t* row = out + (int64_t)y * rowbytes;
    a0 = 0;
    run_length = 0;
    pa = thisrun = curruns;
    int rc;
    if (compression == 3) {
      if (sync_eol() == END) {
        if (!cleanup()) return 1;
        fill(row);
        return 1;
      }
    }
    bool is_2d = compression == 4;
    if (compression == 3 && two_d) {
      if (!need8(1)) {
        if (!cleanup()) return 1;
        fill(row);
        return 1;
      }
      is_2d = bits(1) == 0;
      clear(1);
    }
    pb = refruns;
    b1 = (int)*pb++;
    rc = is_2d ? expand_2d() : expand_1d();
    if (rc == OVERFLOW) return 1;
    if (compression == 4 && (rc == END || eolcnt)) {  // Fax4Decode's EOFB
      fill(row);
      return y > 0 ? 0 : 1;  // a strip cut after a row is no error
    }
    fill(row);
    if (rc == END) return 1;
    if (compression == 2) {  // FAXMODE_BYTEALIGN
      clear(avail & 7);
    } else if (compression == 32771) {  // FAXMODE_WORDALIGN
      clear(avail & 15);
      if (avail == 0 && ((cp - data) + parity) & 1) ++cp;
    }
    if (is_2d_coded) {
      if (compression == 4) {
        if (!setvalue(0)) return 1;  // the imaginary change of the reference row
      } else if (pa < thisrun + nruns) {
        setvalue(0);
      }
      std::swap(curruns, refruns);
    }
  }
  return 0;
}

// ThunderScan 4-bit (tif_thunder.c): per row of `width` pixels, bytes whose
// top two bits are a code: 00 repeat the last pixel (low six bits) times, 01
// three 2-bit deltas (2 skips), 10 two 3-bit deltas (4 skips), 11 a raw
// pixel.  A row that comes out short or long zeros the rest of itself and
// stops the decode with an error (the rows after it stay zero).
int tiff_thunder(const uint8_t* data, int64_t n, int width, int rows, uint8_t* out) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const int64_t rowbytes = ((int64_t)width * 4 + 7) / 8;
  int64_t pos = 0;
  for (int y = 0; y < rows; ++y) {
    uint8_t* const op0 = out + y * rowbytes;
    uint8_t* op = op0;
    unsigned lastpixel = 0;
    int64_t npixels = 0;
    const int64_t maxpixels = width;
    auto setpixel = [&](unsigned v) {
      lastpixel = v & 0xF;
      if (npixels < maxpixels) {
        if (npixels++ & 1) *op++ |= (uint8_t)lastpixel;
        else op[0] = (uint8_t)(lastpixel << 4);
      }
    };
    while (pos < n && npixels < maxpixels) {
      int c = data[pos++], delta;
      switch (c & 0xC0) {
        case 0x00: {
          int k = c;
          if (npixels & 1) {
            op[0] |= (uint8_t)lastpixel;
            lastpixel = *op++;
            npixels++;
            k--;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += k;
          if (npixels <= maxpixels)
            for (; k > 0; k -= 2) *op++ = (uint8_t)lastpixel;
          if (k == -1) *--op &= 0xF0;
          lastpixel &= 0xF;
          break;
        }
        case 0x40:
          if ((delta = (c >> 4) & 3) != 2) setpixel((unsigned)((int)lastpixel + two[delta]));
          if ((delta = (c >> 2) & 3) != 2) setpixel((unsigned)((int)lastpixel + two[delta]));
          if ((delta = c & 3) != 2) setpixel((unsigned)((int)lastpixel + two[delta]));
          break;
        case 0x80:
          if ((delta = (c >> 3) & 7) != 4) setpixel((unsigned)((int)lastpixel + three[delta]));
          if ((delta = c & 7) != 4) setpixel((unsigned)((int)lastpixel + three[delta]));
          break;
        default:
          setpixel((unsigned)c);
          break;
      }
    }
    if (npixels != maxpixels) {
      uint8_t* end = op0 + (maxpixels + 1) / 2;
      if (op < end) memset(op, 0, end - op);
      return 1;
    }
  }
  return 0;
}

// ------------------------------------------------------- TIFF CIELab
// TIFFRGBAImage's CIELab put routines (putcontig8bitCIELab8 / 16):
// tif_color.c's TIFFCIELab16ToXYZ (8-bit samples as l * 257, a * 256,
// b * 256) and TIFFXYZToRGB through TIFFCIELabToRGBInit's tables for
// tif_getimage.c's display_sRGB, in libtiff's float and double arithmetic.
// `samples` holds n pixels of L, a, b as the file stores them (a and b
// two's complement in `bits` 8 or 16 bits); `wp` the WhitePoint tag's x,
// y.  Returns 1 (no output) where y is 0, as initCIELabConversion refuses.
int tiff_cielab(const int32_t* samples, int64_t n, int bits, float wp_x, float wp_y,
                uint8_t* rgb) {
  if (wp_y == 0.0f) return 1;
  // display_sRGB: the XYZ -> RGB matrix, Y0 1, YC 100, Vrw 255, gamma 2.4
  static const float mat[9] = {3.2410F, -1.5374F, -0.4986F, -0.9692F, 1.8760F,
                               0.0416F, 0.0556F, -0.2040F, 1.0570F};
  const float y0 = 1.0F, yc = 100.0F;
  const int range = 1500;  // CIELABTORGB_TABLE_RANGE
  static float table[1501];
  static const bool ready = [] {
    const double gamma = 1.0 / (double)2.4F;
    for (int i = 0; i <= 1500; ++i)
      table[i] = (float)255u * ((float)pow((double)i / 1500, gamma));
    return true;
  }();
  (void)ready;
  const float step = (yc - y0) / range;
  const float ref_y = 100.0F;
  const float ref_x = wp_x / wp_y * ref_y;
  const float ref_z = (1.0F - wp_x - wp_y) / wp_y * ref_y;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t l = (uint32_t)samples[3 * i];
    int32_t a = samples[3 * i + 1], b = samples[3 * i + 2];
    if (bits == 8) {
      l *= 257;
      a = (int8_t)a * 256;
      b = (int8_t)b * 256;
    } else {
      a = (int16_t)a;
      b = (int16_t)b;
    }
    // TIFFCIELab16ToXYZ
    const float L = (float)l * 100.0F / 65535.0F;
    float X, Y, Z, cby, tmp;
    if (L < 8.856F) {
      Y = (L * ref_y) / 903.292F;
      cby = 7.787F * (Y / ref_y) + 16.0F / 116.0F;
    } else {
      cby = (L + 16.0F) / 116.0F;
      Y = ref_y * cby * cby * cby;
    }
    tmp = (float)a / 256.0F / 500.0F + cby;
    if (tmp < 0.2069F) X = ref_x * (tmp - 0.13793F) / 7.787F;
    else X = ref_x * tmp * tmp * tmp;
    tmp = cby - (float)b / 256.0F / 200.0F;
    if (tmp < 0.2069F) Z = ref_z * (tmp - 0.13793F) / 7.787F;
    else Z = ref_z * tmp * tmp * tmp;
    // TIFFXYZToRGB
    float lum[3];
    for (int c = 0; c < 3; ++c) {
      float v = mat[3 * c] * X + mat[3 * c + 1] * Y + mat[3 * c + 2] * Z;
      v = v > y0 ? v : y0;
      v = v < yc ? v : yc;
      lum[c] = v;
    }
    for (int c = 0; c < 3; ++c) {
      int k = (int)((lum[c] - y0) / step);
      k = range < k ? range : k;
      const float t = table[k];
      uint32_t v = (uint32_t)(t > 0 ? (t + 0.5) : (t - 0.5));  // RINT
      rgb[3 * i + c] = (uint8_t)(v < 255u ? v : 255u);
    }
  }
  return 0;
}

// ------------------------------------------------------- TIFF SGILog
// tif_luv.c's decoders with the 8-bit data format TIFFRGBAImageBegin asks
// for: each row of `width` pixels decoded on its own from where the last
// one stopped, `kind` 0 LogL (LogL16Decode: two byte planes of runs, then
// L16toGry, one gray byte a pixel), 1 LogLuv32 (LogLuvDecode32: four byte
// planes, then Luv32toRGB) or 2 LogLuv24 (LogLuvDecode24: 3 bytes a pixel,
// then Luv24toRGB through uv_decode's table); RGB by XYZtoRGB24 (CCIR-709
// primaries, gamma 2, no dithering).  A row the data cannot fill stops the
// decode (that row and the rest stay zero) and returns 1.
namespace {

// uvcode.h: the (u', v') rows of LogLuv24's 14-bit colour index
const float kUvSqsiz = (float)0.003500, kUvVstart = (float)0.016940;
const int kUvNdivs = 16289, kUvNvs = 163;
const struct {
  float ustart;
  short nus, ncum;
} kUvRow[kUvNvs] = {
    {0.247663f, 4, 0}, {0.243779f, 6, 4}, {0.241684f, 7, 10}, {0.237874f, 9, 17},
    {0.235906f, 10, 26}, {0.232153f, 12, 36}, {0.228352f, 14, 48}, {0.226259f, 15, 62},
    {0.222371f, 17, 77}, {0.220410f, 18, 94}, {0.214710f, 21, 112}, {0.212714f, 22, 133},
    {0.210721f, 23, 155}, {0.204976f, 26, 178}, {0.202986f, 27, 204}, {0.199245f, 29, 231},
    {0.195525f, 31, 260}, {0.193560f, 32, 291}, {0.189878f, 34, 323}, {0.186216f, 36, 357},
    {0.186216f, 36, 393}, {0.182592f, 38, 429}, {0.179003f, 40, 467}, {0.175466f, 42, 507},
    {0.172001f, 44, 549}, {0.172001f, 44, 593}, {0.168612f, 46, 637}, {0.168612f, 46, 683},
    {0.163575f, 49, 729}, {0.158642f, 52, 778}, {0.158642f, 52, 830}, {0.158642f, 52, 882},
    {0.153815f, 55, 934}, {0.153815f, 55, 989}, {0.149097f, 58, 1044}, {0.149097f, 58, 1102},
    {0.142746f, 62, 1160}, {0.142746f, 62, 1222}, {0.142746f, 62, 1284}, {0.138270f, 65, 1346},
    {0.138270f, 65, 1411}, {0.138270f, 65, 1476}, {0.132166f, 69, 1541}, {0.132166f, 69, 1610},
    {0.126204f, 73, 1679}, {0.126204f, 73, 1752}, {0.126204f, 73, 1825}, {0.120381f, 77, 1898},
    {0.120381f, 77, 1975}, {0.120381f, 77, 2052}, {0.120381f, 77, 2129}, {0.112962f, 82, 2206},
    {0.112962f, 82, 2288}, {0.112962f, 82, 2370}, {0.107450f, 86, 2452}, {0.107450f, 86, 2538},
    {0.107450f, 86, 2624}, {0.107450f, 86, 2710}, {0.100343f, 91, 2796}, {0.100343f, 91, 2887},
    {0.100343f, 91, 2978}, {0.095126f, 95, 3069}, {0.095126f, 95, 3164}, {0.095126f, 95, 3259},
    {0.095126f, 95, 3354}, {0.088276f, 100, 3449}, {0.088276f, 100, 3549},
    {0.088276f, 100, 3649}, {0.088276f, 100, 3749}, {0.081523f, 105, 3849},
    {0.081523f, 105, 3954}, {0.081523f, 105, 4059}, {0.081523f, 105, 4164},
    {0.074861f, 110, 4269}, {0.074861f, 110, 4379}, {0.074861f, 110, 4489},
    {0.074861f, 110, 4599}, {0.068290f, 115, 4709}, {0.068290f, 115, 4824},
    {0.068290f, 115, 4939}, {0.068290f, 115, 5054}, {0.063573f, 119, 5169},
    {0.063573f, 119, 5288}, {0.063573f, 119, 5407}, {0.063573f, 119, 5526},
    {0.057219f, 124, 5645}, {0.057219f, 124, 5769}, {0.057219f, 124, 5893},
    {0.057219f, 124, 6017}, {0.050985f, 129, 6141}, {0.050985f, 129, 6270},
    {0.050985f, 129, 6399}, {0.050985f, 129, 6528}, {0.050985f, 129, 6657},
    {0.044859f, 134, 6786}, {0.044859f, 134, 6920}, {0.044859f, 134, 7054},
    {0.044859f, 134, 7188}, {0.040571f, 138, 7322}, {0.040571f, 138, 7460},
    {0.040571f, 138, 7598}, {0.040571f, 138, 7736}, {0.036339f, 142, 7874},
    {0.036339f, 142, 8016}, {0.036339f, 142, 8158}, {0.036339f, 142, 8300},
    {0.032139f, 146, 8442}, {0.032139f, 146, 8588}, {0.032139f, 146, 8734},
    {0.032139f, 146, 8880}, {0.027947f, 150, 9026}, {0.027947f, 150, 9176},
    {0.027947f, 150, 9326}, {0.023739f, 154, 9476}, {0.023739f, 154, 9630},
    {0.023739f, 154, 9784}, {0.023739f, 154, 9938}, {0.019504f, 158, 10092},
    {0.019504f, 158, 10250}, {0.019504f, 158, 10408}, {0.016976f, 161, 10566},
    {0.016976f, 161, 10727}, {0.016976f, 161, 10888}, {0.016976f, 161, 11049},
    {0.012639f, 165, 11210}, {0.012639f, 165, 11375}, {0.012639f, 165, 11540},
    {0.009991f, 168, 11705}, {0.009991f, 168, 11873}, {0.009991f, 168, 12041},
    {0.009016f, 170, 12209}, {0.009016f, 170, 12379}, {0.009016f, 170, 12549},
    {0.006217f, 173, 12719}, {0.006217f, 173, 12892}, {0.005097f, 175, 13065},
    {0.005097f, 175, 13240}, {0.005097f, 175, 13415}, {0.003909f, 177, 13590},
    {0.003909f, 177, 13767}, {0.002340f, 177, 13944}, {0.002389f, 170, 14121},
    {0.001068f, 164, 14291}, {0.001653f, 157, 14455}, {0.000717f, 150, 14612},
    {0.001614f, 143, 14762}, {0.000270f, 136, 14905}, {0.000484f, 129, 15041},
    {0.001103f, 123, 15170}, {0.001242f, 115, 15293}, {0.001188f, 109, 15408},
    {0.001011f, 103, 15517}, {0.000709f, 97, 15620}, {0.000301f, 89, 15717},
    {0.002416f, 82, 15806}, {0.003251f, 76, 15888}, {0.003246f, 69, 15964},
    {0.004141f, 62, 16033}, {0.005963f, 55, 16095}, {0.008839f, 47, 16150},
    {0.010490f, 40, 16197}, {0.016994f, 31, 16237}, {0.023659f, 21, 16268}};

double logl16_to_y(int p16) {
  const int le = p16 & 0x7fff;
  if (!le) return 0.;
  const double y = exp(M_LN2 / 256. * (le + .5) - M_LN2 * 64.);
  return !(p16 & 0x8000) ? y : -y;
}

double logl10_to_y(int p10) {
  if (p10 == 0) return 0.;
  return exp(M_LN2 / 64. * (p10 + .5) - M_LN2 * 12.);
}

int uv_decode(double* up, double* vp, int c) {
  if (c < 0 || c >= kUvNdivs) return -1;
  int lower = 0, upper = kUvNvs;
  while (upper - lower > 1) {
    const int vi = (lower + upper) >> 1;
    const int ui = c - kUvRow[vi].ncum;
    if (ui > 0) {
      lower = vi;
    } else if (ui < 0) {
      upper = vi;
    } else {
      lower = vi;
      break;
    }
  }
  const int vi = lower, ui = c - kUvRow[vi].ncum;
  *up = kUvRow[vi].ustart + (ui + .5) * kUvSqsiz;
  *vp = kUvVstart + (vi + .5) * kUvSqsiz;
  return 0;
}

void luv_to_xyz(double L, double u, double v, float* xyz) {
  const double s = 1. / (6. * u - 16. * v + 12.);
  const double x = 9. * u * s, y = 4. * v * s;
  xyz[0] = (float)(x / y * L);
  xyz[1] = (float)L;
  xyz[2] = (float)((1. - x - y) / y * L);
}

uint8_t gamma2(double v) { return (uint8_t)(v <= 0. ? 0 : v >= 1. ? 255 : (int)(256. * sqrt(v))); }

void xyz_to_rgb24(const float* xyz, uint8_t* rgb) {
  const double r = 2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2];
  const double g = -1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2];
  const double b = 0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2];
  rgb[0] = gamma2(r);
  rgb[1] = gamma2(g);
  rgb[2] = gamma2(b);
}

}  // namespace

int tiff_sgilog(int kind, const uint8_t* data, int64_t n, int width, int rows, uint8_t* out) {
  // the values of every code of L and of (u, v), computed once: the same
  // results as computing them per pixel
  static std::vector<double> l16, l10, uv24;
  static std::vector<uint8_t> gray16;
  static const bool ready = [] {
    l16.resize(1 << 16);
    gray16.resize(1 << 16);
    for (int c = 0; c < (1 << 16); ++c) {
      l16[c] = logl16_to_y((int16_t)c);
      gray16[c] = gamma2(l16[c]);
    }
    l10.resize(1 << 10);
    for (int c = 0; c < (1 << 10); ++c) l10[c] = logl10_to_y(c);
    uv24.resize(2 << 14);
    for (int c = 0; c < (1 << 14); ++c)
      if (uv_decode(&uv24[2 * c], &uv24[2 * c + 1], c) < 0) {
        uv24[2 * c] = 0.210526316;  // U_NEU, V_NEU
        uv24[2 * c + 1] = 0.473684211;
      }
    return true;
  }();
  (void)ready;
  const int planes = kind == 0 ? 2 : 4, px = kind == 0 ? 1 : 3;
  std::vector<uint32_t> tp(width);
  const uint8_t* bp = data;
  int64_t cc = n;
  for (int y = 0; y < rows; ++y) {
    std::fill(tp.begin(), tp.end(), 0u);
    int64_t i = 0;
    if (kind == 2) {  // LogLuvDecode24
      for (; i < width && cc >= 3; ++i, bp += 3, cc -= 3)
        tp[i] = (uint32_t)bp[0] << 16 | bp[1] << 8 | bp[2];
      if (i != width) return 1;
    } else {  // LogL16Decode / LogLuvDecode32: runs of each byte plane
      for (int shft = 8 * (planes - 1); shft >= 0; shft -= 8) {
        for (i = 0; i < width && cc > 0;) {
          if (*bp >= 128) {  // a run
            if (cc < 2) break;
            int rc = *bp++ + (2 - 128);
            const uint32_t b = (uint32_t)*bp++ << shft;
            cc -= 2;
            while (rc-- && i < width) tp[i++] |= b;
          } else {  // literal bytes
            int rc = *bp++;
            while (--cc && rc-- && i < width) tp[i++] |= (uint32_t)*bp++ << shft;
          }
        }
        if (i != width) return 1;
      }
    }
    uint8_t* op = out + (int64_t)y * width * px;
    for (int64_t x = 0; x < width; ++x) {
      const uint32_t p = tp[x];
      if (kind == 0) {  // L16toGry
        op[x] = gray16[p & 0xffff];
        continue;
      }
      float xyz[3] = {0.f, 0.f, 0.f};
      double L, u, v;
      if (kind == 1) {  // LogLuv32toXYZ
        L = l16[p >> 16];
        u = 1. / 410. * ((p >> 8 & 0xff) + .5);
        v = 1. / 410. * ((p & 0xff) + .5);
      } else {  // LogLuv24toXYZ
        L = l10[p >> 14 & 0x3ff];
        u = uv24[2 * (p & 0x3fff)];
        v = uv24[2 * (p & 0x3fff) + 1];
      }
      if (L > 0.) luv_to_xyz(L, u, v, xyz);
      xyz_to_rgb24(xyz, op + 3 * x);
    }
  }
  return 0;
}


// ---- encoders ----

// GIF: cv2 5.0's fast-mode quantiser (grfmt_gif.cpp's ditheringKernel at
// depth 3:3:2): the RGB pixels `rgb` [height * width * 3] to indices into its
// fixed table (red level * 32 + green level * 4 + blue level; red and green
// in steps of 36, blue in steps of 85), with Floyd-Steinberg error diffusion
// in float: each channel's value is the pixel plus the error it was given,
// its level floor(value / step + 0.5) in float (clamped to the table), and
// value - level
// goes 7/16 right, 3/16 down-left, 5/16 down and 1/16 down-right (none past
// an edge).  The errors of the row below sum in the order the pixels give
// them, as cv2's row buffers do.
void gif_dither(const uint8_t* rgb, int height, int width, uint8_t* out) {
  const float step[3] = {36.0f, 36.0f, 85.0f};
  const int top[3] = {7, 7, 3};
  std::vector<float> cur(3 * ((size_t)width + 2)), nxt(cur.size());
  for (int y = 0; y < height; ++y) {
    std::fill(nxt.begin(), nxt.end(), 0.0f);
    for (int x = 0; x < width; ++x) {
      const uint8_t* px = rgb + ((int64_t)y * width + x) * 3;
      int level[3];
      for (int c = 0; c < 3; ++c) {
        const float v = (float)px[c] + cur[3 * (x + 1) + c];
        int l = (int)floorf(v / step[c] + 0.5f);
        l = std::min(std::max(l, 0), top[c]);
        level[c] = l;
        const float e = v - (float)l * step[c];
        if (x + 1 < width) cur[3 * (x + 2) + c] += e * 7 / 16;
        if (x > 0) nxt[3 * x + c] += e * 3 / 16;
        nxt[3 * (x + 1) + c] += e * 5 / 16;
        if (x + 1 < width) nxt[3 * (x + 2) + c] += e * 1 / 16;
      }
      out[(int64_t)y * width + x] = (uint8_t)(level[0] * 32 + level[1] * 4 + level[2]);
    }
    std::swap(cur, nxt);
  }
}

// GIF: the LZW image data of `n` 8-bit indices (minimum code size 8) as
// cv2 5.0 writes it, in sub-blocks of 255 bytes (the last shorter) and the
// zero block that ends them: a clear code, then codes LSB first, 9 bits
// wide and one wider once the next entry passes 2^width; the entry that
// fills the table (4096) is followed by a clear code at once.  `out` holds
// at least 2 * n + 16 bytes.
int64_t gif_lzw_encode(const uint8_t* idx, int64_t n, uint8_t* out) {
  const int clear = 256, eoi = 257;
  std::vector<uint16_t> table(4096 * 256, 0);
  std::vector<uint8_t> raw;
  raw.reserve(2 * (size_t)n + 8);
  uint64_t acc = 0;
  int nacc = 0, width = 9, next = eoi + 1;
  auto put = [&](int code) {
    acc |= (uint64_t)code << nacc;
    nacc += width;
    while (nacc >= 8) {
      raw.push_back((uint8_t)acc);
      acc >>= 8;
      nacc -= 8;
    }
  };
  put(clear);
  if (n > 0) {
    int prefix = idx[0];
    for (int64_t i = 1; i < n; ++i) {
      const uint8_t c = idx[i];
      const uint16_t hit = table[(size_t)prefix * 256 + c];
      if (hit) {
        prefix = hit;
        continue;
      }
      put(prefix);
      table[(size_t)prefix * 256 + c] = (uint16_t)next++;
      if (next == 4096) {
        put(clear);
        std::fill(table.begin(), table.end(), 0);
        next = eoi + 1;
        width = 9;
      } else if (next > (1 << width)) {
        ++width;
      }
      prefix = c;
    }
    put(prefix);
  }
  put(eoi);
  if (nacc) raw.push_back((uint8_t)acc);
  int64_t o = 0;
  for (size_t at = 0; at < raw.size(); at += 255) {
    const size_t len = std::min<size_t>(255, raw.size() - at);
    out[o++] = (uint8_t)len;
    memcpy(out + o, raw.data() + at, len);
    o += len;
  }
  out[o++] = 0;
  return o;
}

// Radiance HDR: `height` scanlines of `width` RGBE pixels, given as planes
// (`planes` [height][4][width]: R, G, B, E), as rgbe.cpp's
// RGBE_WritePixels_RLE writes them for 8 <= width <= 0x7fff: each scanline
// the bytes 2, 2, width >> 8, width & 255, then each plane by
// RGBE_WriteBytes_RLE: runs of at least 4 equal bytes (at most 127) as
// 128 + count and the byte; a run of 2 or 3 that ends just before such a
// run as a short run; the rest as literals of at most 128 bytes.  `out`
// holds at least height * (4 + 4 * width + 4 * ceil(width / 128)) bytes.
int64_t hdr_rle_encode(const uint8_t* planes, int width, int height, uint8_t* out) {
  const int kMinRun = 4;
  int64_t o = 0;
  for (int y = 0; y < height; ++y) {
    out[o++] = 2;
    out[o++] = 2;
    out[o++] = (uint8_t)(width >> 8);
    out[o++] = (uint8_t)(width & 0xff);
    for (int ch = 0; ch < 4; ++ch) {
      const uint8_t* data = planes + ((int64_t)y * 4 + ch) * width;
      int cur = 0;
      while (cur < width) {
        int beg_run = cur, run_count = 0, old_run_count = 0;
        while (run_count < kMinRun && beg_run < width) {
          beg_run += run_count;
          old_run_count = run_count;
          run_count = 1;
          while (beg_run + run_count < width && run_count < 127 &&
                 data[beg_run] == data[beg_run + run_count])
            ++run_count;
        }
        if (old_run_count > 1 && old_run_count == beg_run - cur) {
          out[o++] = (uint8_t)(128 + old_run_count);
          out[o++] = data[cur];
          cur = beg_run;
        }
        while (cur < beg_run) {
          const int count = std::min(beg_run - cur, 128);
          out[o++] = (uint8_t)count;
          memcpy(out + o, data + cur, count);
          o += count;
          cur += count;
        }
        if (run_count >= kMinRun) {
          out[o++] = (uint8_t)(128 + run_count);
          out[o++] = data[beg_run];
          cur += run_count;
        }
      }
    }
  }
  return o;
}

// TIFF: one strip of `rows` rows of `row_bytes` 8-bit samples as libtiff
// 4.7.1 writes it with compression 5 (tif_lzw.c's LZWEncode) after the
// horizontal predictor (tif_predict.c's horDiff8: each sample less the one
// `stride` samples before it in its row, the row's first pixel kept), row
// by row into one LZW stream: a clear code first; 9- to 12-bit codes MSB
// first, one wider once the next entry passes 2^width - 1; a clear code
// right after the entry that brings the table to 4094, and also, at the
// first new entry that neither widens the codes nor is reached before
// 10,000 input bytes since the last check, when the ratio of input to
// output bits (24.8 fixed point) has not grown since that check; then the
// last string, the end code (LZWPostEncode: one bit wider where its entry
// would have widened the codes) and the last bits padded with zeros.
// `out` holds at least 2 * rows * row_bytes + 16 bytes.
int64_t tiff_lzw_encode(const uint8_t* samples, int64_t row_bytes, int rows, int stride,
                        uint8_t* out) {
  const int kClear = 256, kEoi = 257, kFirst = 258, kCodeMax = 4095, kCheckGap = 10000;
  std::vector<uint16_t> table(4096 * 256, 0);
  std::vector<uint8_t> row(row_bytes);
  uint64_t nextdata = 0;
  int nextbits = 0, nbits = 9, maxcode = 511, free_ent = kFirst, ent = -1;
  int64_t o = 0, incount = 0, outcount = 0, checkpoint = kCheckGap, ratio = 0;
  auto put = [&](int code) {
    nextdata = (nextdata << nbits) | (uint64_t)code;
    nextbits += nbits;
    out[o++] = (uint8_t)(nextdata >> (nextbits - 8));
    nextbits -= 8;
    if (nextbits >= 8) {
      out[o++] = (uint8_t)(nextdata >> (nextbits - 8));
      nextbits -= 8;
    }
    nextdata &= (1ull << nextbits) - 1;
    outcount += nbits;
  };
  auto reset = [&]() {
    std::fill(table.begin(), table.end(), 0);
    ratio = 0;
    incount = 0;
    outcount = 0;
    free_ent = kFirst;
    put(kClear);
    nbits = 9;
    maxcode = 511;
  };
  for (int r = 0; r < rows; ++r) {
    const uint8_t* src = samples + (int64_t)r * row_bytes;
    for (int64_t i = row_bytes - 1; i >= stride; --i) row[i] = (uint8_t)(src[i] - src[i - stride]);
    for (int64_t i = 0; i < std::min<int64_t>(stride, row_bytes); ++i) row[i] = src[i];
    int64_t i = 0;
    if (ent < 0 && row_bytes > 0) {
      put(kClear);
      ent = row[i++];
      ++incount;
    }
    for (; i < row_bytes; ++i) {
      const int c = row[i];
      ++incount;
      const uint16_t hit = table[(size_t)ent * 256 + c];
      if (hit) {
        ent = hit;
        continue;
      }
      put(ent);
      table[(size_t)ent * 256 + c] = (uint16_t)free_ent++;
      ent = c;
      if (free_ent == kCodeMax - 1) {
        reset();
      } else if (free_ent > maxcode) {
        ++nbits;
        maxcode = (1 << nbits) - 1;
      } else if (incount >= checkpoint) {
        checkpoint = incount + kCheckGap;
        int64_t rat;
        if (incount > 0x007fffff) {
          rat = outcount >> 8;
          rat = rat == 0 ? 0x7fffffff : incount / rat;
        } else {
          rat = (incount << 8) / outcount;
        }
        if (rat <= ratio) reset();
        else ratio = rat;
      }
    }
  }
  if (ent >= 0) {
    put(ent);
    const int after = free_ent + 1;
    if (after == kCodeMax - 1) {
      put(kClear);
      nbits = 9;
    } else if (after > maxcode) {
      ++nbits;
    }
  }
  put(kEoi);
  if (nextbits > 0) out[o++] = (uint8_t)((nextdata << (8 - nextbits)) & 0xff);
  return o;
}

}  // extern "C"
