// The per-code loops of the port's image decoders (core/gif.py, core/hdr.py,
// core/bmp.py), as cv2 5.0 runs them; headers, palettes and the conversion
// to pixels stay in Python. Built with g++ by ops/native/build.py at first
// use and bound with ctypes (ops/native/image_codes.py).
//
// Every function reads `data[pos:n]` and returns 0, or 1 where cv2's decoder
// gives up (data cut short, a code or run it refuses); a read never goes past
// `n` and a write never past its output.

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

}  // extern "C"
