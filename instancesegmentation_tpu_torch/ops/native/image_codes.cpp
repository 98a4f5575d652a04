// The per-code loops of the port's image decoders (core/gif.py, core/hdr.py,
// core/bmp.py, core/tiff.py), as cv2 5.0 runs them (libtiff 4.7's codecs for
// TIFF); headers, palettes and the conversion to pixels stay in Python.
// Built with g++ by ops/native/build.py at first use and bound with ctypes
// (ops/native/image_codes.py).
//
// The GIF, HDR and BMP functions read `data[pos:n]` and return 0, or 1 where
// cv2's decoder gives up (data cut short, a code or run it refuses).  The
// TIFF codecs fill `out[0:occ]` (zeros where they stop) and return 0, or 1
// where libtiff reports an error, whose partial output cv2 keeps.  A read
// never goes past `n` and a write never past its output.

#include <stdint.h>
#include <string.h>

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

// a code table read `width` bits at a time (tif_fax3sm.c's 12- and 13-bit
// tables): each entry the code's length and its run (-1 EOL: eleven zeros,
// -2 no code)
struct FaxTable {
  int width;
  std::vector<uint8_t> len;
  std::vector<int16_t> run;
  FaxTable(const FaxCode* codes, int n, int w) : width(w), len(1 << w, 0), run(1 << w, -2) {
    auto add = [&](const FaxCode& c) {
      const int shift = w - c.len;
      for (int i = 0; i < (1 << shift); ++i) {
        len[((int)c.code << shift) | i] = c.len;
        run[((int)c.code << shift) | i] = c.run;
      }
    };
    for (int i = 0; i < n; ++i) add(codes[i]);
    for (const FaxCode& c : kMakeUp) add(c);
    for (int i = 0; i < (1 << (w - 11)); ++i) {  // eleven zeros
      len[i] = 11;
      run[i] = -1;
    }
  }
};

struct FaxBits {
  const uint8_t* d;
  int64_t nbits, pos = 0;
  // the next `w` bits MSB first (zeros past the end); false where no bit is left
  bool peek(int w, int* v) const {
    if (pos >= nbits) return false;
    int x = 0;
    for (int i = 0; i < w; ++i) {
      const int64_t p = pos + i;
      x = (x << 1) | (p < nbits ? (d[p >> 3] >> (7 - (p & 7))) & 1 : 0);
    }
    *v = x;
    return true;
  }
  void skip(int w) { pos += w; }
};

// tif_fax3.c's decoders on one strip or tile: `rows` rows of `width`
// pixels into `out` (rows of (width + 7) / 8 bytes, a 1 bit for a black
// run).  compression 2 (RLE: modified Huffman rows, each byte-aligned), 3
// (Group 3: each row after an EOL, 1-D, or with `two_d` a tag bit choosing
// 1-D or 2-D against the row above), 4 (Group 4: 2-D rows, the first
// against a white row, until the end or an EOFB).  A code that fits no
// table ends its row, padded to the width; the data ending inside a row
// fills that row and stops with an error (Group 4: not after a whole row).
int tiff_fax(int compression, int two_d, const uint8_t* data, int64_t n, int width, int rows,
             uint8_t* out) {
  static const FaxTable white(kWhite, sizeof(kWhite) / sizeof(FaxCode), 12);
  static const FaxTable black(kBlack, sizeof(kBlack) / sizeof(FaxCode), 13);
  FaxBits br{data, n * 8};
  const int lastx = width, rowbytes = (width + 7) / 8;
  const size_t nruns = 2 * (size_t)width + 8;
  std::vector<int64_t> cur(nruns + 2), ref(nruns + 2);  // fill may pad one run
  ref[0] = lastx;  // the white row above the first
  ref[1] = 0;
  int64_t* thisrun = cur.data();
  int64_t* pa = thisrun;
  int64_t a0 = 0, run_length = 0;
  int eol = 0;
  auto setvalue = [&](int64_t x) {
    if (pa < thisrun + nruns) *pa++ = run_length + x;
    a0 += x;
    run_length = 0;
  };
  auto cleanup = [&] {  // CLEANUP_RUNS
    if (run_length) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= *--pa;
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  };
  auto fill = [&](uint8_t* row) {  // _TIFFFax3fillruns, on uint32 runs
    int64_t x = 0;
    int64_t* end = pa;
    if ((end - thisrun) & 1) *end++ = 0;
    for (int64_t* r = thisrun; r < end; r += 2) {
      int64_t w = (uint32_t)r[0];
      if (x + w > lastx || w > lastx) w = lastx - x;
      x += w;
      int64_t b = (uint32_t)r[1];
      if (x + b > lastx || b > lastx) b = lastx - x;
      for (int64_t i = x; i < x + b; ++i) row[i >> 3] |= (uint8_t)(0x80 >> (i & 7));
      x += b;
    }
  };
  // one modified Huffman run of `t`'s colour, make-up codes summed; 0 the
  // run is set, 1 an EOL or a bad code ended the row, 2 the data ended
  auto mh_run = [&](const FaxTable& t) -> int {
    for (;;) {
      int v;
      if (!br.peek(t.width, &v)) return 2;
      const int r = t.run[v];
      if (r == -2) return 1;
      br.skip(t.len[v]);
      if (r == -1) {
        eol = 1;
        return 1;
      }
      if (r < 64) {
        setvalue(r);
        return 0;
      }
      a0 += r;
      run_length += r;
    }
  };
  auto expand_1d = [&]() -> int {  // EXPAND1D: 0 row done, 2 data ended
    for (;;) {
      int rc = mh_run(white);
      if (rc) return rc == 2 ? (cleanup(), 2) : (cleanup(), 0);
      if (a0 >= lastx) break;
      rc = mh_run(black);
      if (rc) return rc == 2 ? (cleanup(), 2) : (cleanup(), 0);
      if (a0 >= lastx) break;
      if (pa - thisrun >= 2 && pa[-1] == 0 && pa[-2] == 0) pa -= 2;
    }
    cleanup();
    return 0;
  };
  auto expand_2d = [&]() -> int {  // EXPAND2D against `ref`
    int64_t* pb = ref.data();
    int64_t* const pb_end = ref.data() + nruns;
    int64_t b1 = *pb++;
    auto check_b1 = [&]() -> bool {
      if (pa != thisrun)
        while (b1 <= a0 && b1 < lastx) {
          if (pb + 1 >= pb_end) return false;
          b1 += pb[0] + pb[1];
          pb += 2;
        }
      return true;
    };
    while (a0 < lastx) {
      int v;
      if (!br.peek(7, &v)) return cleanup(), 2;
      // the main table: P 0001, H 001, V0 1, VR1 011, VR2 000011, VR3
      // 0000011, VL1 010, VL2 000010, VL3 0000010, extension 0000001,
      // EOL 0000000
      int mode, len, param = 0;
      if (v >> 6) mode = 0, len = 1;                                    // V0
      else if ((v >> 4) == 3) mode = 1, len = 3, param = 1;             // VR1
      else if ((v >> 4) == 2) mode = 2, len = 3, param = 1;             // VL1
      else if ((v >> 4) == 1) mode = 4, len = 3;                        // H
      else if ((v >> 3) == 1) mode = 3, len = 4;                        // P
      else if ((v >> 1) == 3) mode = 1, len = 6, param = 2;             // VR2
      else if ((v >> 1) == 2) mode = 2, len = 6, param = 2;             // VL2
      else if (v == 3) mode = 1, len = 7, param = 3;                    // VR3
      else if (v == 2) mode = 2, len = 7, param = 3;                    // VL3
      else if (v == 1) mode = 5, len = 7;                               // extension
      else mode = 6, len = 7;                                           // EOL
      br.skip(len);
      switch (mode) {
        case 0:
        case 1:
          if (!check_b1()) return cleanup(), 2;
          setvalue(b1 - a0 + param);
          if (pb >= pb_end) return cleanup(), 2;
          b1 += *pb++;
          break;
        case 2:
          if (!check_b1()) return cleanup(), 2;
          if (b1 < a0 + param) return cleanup(), 0;
          setvalue(b1 - a0 - param);
          if (pb == ref.data()) return cleanup(), 0;  // no run left of b1
          b1 -= *--pb;
          break;
        case 3:
          if (!check_b1()) return cleanup(), 2;
          if (pb + 1 >= pb_end) return cleanup(), 2;
          b1 += *pb++;
          run_length += b1 - a0;
          a0 = b1;
          b1 += *pb++;
          break;
        case 4: {
          const bool black_first = (pa - thisrun) & 1;
          int rc = mh_run(black_first ? black : white);
          if (rc == 2) return cleanup(), 2;
          if (rc == 1) return cleanup(), 0;
          rc = mh_run(black_first ? white : black);
          if (rc == 2) return cleanup(), 2;
          if (rc == 1) return cleanup(), 0;
          if (!check_b1()) return cleanup(), 2;
          break;
        }
        case 5:
          if (pa < thisrun + nruns) *pa++ = lastx - a0;
          return cleanup(), 0;
        default: {
          if (pa < thisrun + nruns) *pa++ = lastx - a0;
          int z;
          if (!br.peek(4, &z)) return cleanup(), 2;
          br.skip(4);
          eol = 1;
          return cleanup(), 0;
        }
      }
    }
    if (run_length) {
      if (run_length + a0 < lastx) {  // a final V0 is expected
        int z;
        if (!br.peek(1, &z)) return cleanup(), 2;
        if (!z) return cleanup(), 0;
        br.skip(1);
      }
      setvalue(0);
    }
    cleanup();
    return 0;
  };
  auto sync_eol = [&]() -> bool {  // SYNC_EOL: false where the data ends
    int v;
    if (!eol) {
      for (;;) {
        if (!br.peek(11, &v)) return false;
        if (v == 0) break;
        br.skip(1);
      }
    }
    for (;;) {
      if (!br.peek(8, &v)) return false;
      if (v) break;
      br.skip(8);
    }
    for (;;) {
      br.peek(1, &v);
      if (v) break;
      br.skip(1);
    }
    br.skip(1);
    eol = 0;
    return true;
  };
  for (int y = 0; y < rows; ++y) {
    uint8_t* row = out + (int64_t)y * rowbytes;
    a0 = 0;
    run_length = 0;
    pa = thisrun;
    int rc;
    bool is_2d = compression == 4;
    if (compression == 3) {
      if (!sync_eol()) {
        cleanup();
        fill(row);
        return 1;
      }
      if (two_d) {
        int v;
        if (!br.peek(1, &v)) {
          cleanup();
          fill(row);
          return 1;
        }
        br.skip(1);
        is_2d = v == 0;
      }
    }
    rc = is_2d ? expand_2d() : expand_1d();
    if (compression == 4 && (rc == 2 || eol)) {
      fill(row);
      return y > 0 ? 0 : 1;  // Fax4Decode takes a strip cut after a row
    }
    fill(row);
    if (rc == 2) return 1;
    if (compression == 2) br.pos = (br.pos + 7) & ~(int64_t)7;  // FAXMODE_BYTEALIGN
    if (pa < thisrun + nruns) {
      *pa++ = 0;  // the imaginary change of the reference row
    }
    std::swap(cur, ref);
    thisrun = cur.data();
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

}  // extern "C"
