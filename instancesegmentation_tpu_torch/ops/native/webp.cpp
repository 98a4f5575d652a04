// WebP decoding so that the pixels equal cv2.imread's and cv2.imdecode's
// (cv2 5.0's bundled libwebp, WebPDecodeBGRInto / WebPDecodeBGRAInto with
// default options) bit for bit: the lossless (VP8L) and lossy (VP8) bit
// streams and the alpha (ALPH) stream of a lossy image.  The container
// (RIFF, VP8X, chunks, animation, EXIF) is core/webp.py's.
//
// Lossless (VP8L):
//   - the image header (signature 0x2f, 14-bit sides, alpha hint, version 0)
//     and the transforms, each type at most once: predictor (modes 0-13, 14
//     and 15 black), cross-colour, subtract-green, colour indexing with
//     pixels bundled 8, 4 or 2 to a byte at <= 2, <= 4 and <= 16 colours
//     (indices past the palette read transparent black);
//   - the meta prefix-code image and five codes per group (green + length +
//     cache, red, blue, alpha, distance); simple codes and code-length
//     codes; a set of code lengths that is not a complete prefix code is
//     refused unless it names a single symbol, which then takes no bits;
//   - the colour cache (1-11 bits), LZ77 copies with the 120-entry
//     distance map;
//   - libwebp's bit reader and its end of stream: a 64-bit window, so a
//     stream of fewer than 8 bytes reads zeros up to bit 64; passing the
//     end fails the image, except that an alpha stream decoded one byte per
//     pixel (libwebp's 8-bit path: colour indexing alone, no cache, one
//     symbol for red, blue and alpha) fails only if pixels are left;
//   - the reader is given every byte from the stream's start to the end of
//     the data, as libwebp gives it (so a chunk declared short reads on into
//     what follows).
// Alpha (ALPH): header byte (method 0 raw or 1 VP8L, filter none /
// horizontal / vertical / gradient, pre-processing 0-1, reserved 0), the
// VP8L stream's green channel, the filter undone row by row.  A bad stream
// fails the whole read, as libwebp decodes it for every output mode.
// Lossy (VP8), key frames only:
//   - frame header, boolean decoder with libwebp's end-of-data rule (a
//     partition fails once a bit is needed after its last byte);
//   - segments (quantiser and filter levels, absolute or delta, map probs),
//     filter header (simple / normal, level, sharpness, ref and mode lf
//     deltas), 1 / 2 / 4 / 8 token partitions (the last one runs to the end
//     of the data and must hold at least one byte), quantiser deltas with
//     libwebp's tables and clamps (y2 dc x2, y2 ac x155/100 at least 8, uv
//     dc at most index 117), coefficient probability updates, skip flag;
//   - intra modes (16x16, the ten 4x4 modes with the replicated top-right,
//     chroma), DC prediction at the picture edges, 127 / 129 borders;
//   - tokens with their contexts, the inverse WHT and DCT (int16 storage of
//     the dequantised coefficients);
//   - the loop filter (simple and normal, sharpness, per-segment and
//     per-mode levels, inner edges unless the macroblock is skipped with no
//     coefficients and is not 4x4), in macroblock raster order on the
//     reconstructed frame (intra prediction reads unfiltered samples);
//   - cropping to the picture, then libwebp's fancy upsampling of 4:2:0
//     chroma and its YUV -> RGB (MultHi with 14-bit coefficients, 6 bits
//     of fraction), no dithering.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Fail : std::runtime_error {
    explicit Fail(const char* m) : std::runtime_error(m) {}
};

// The probability, quantiser and distance tables of the VP8 and VP8L formats
// (RFC 6386 sections 13.5, 14.1, 11.5; the WebP lossless format's distance
// map), as libwebp holds them.
const uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// 4x4 intra-mode tree: leaves are -mode
const int8_t kYModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};
const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7,
                                      8,  9,  10, 11, 12, 13, 14, 15};

// ---------------------------------------------------------------------------
// VP8L

// libwebp's VP8L bit reader: a 64-bit window `val` of the bytes before
// `pos`, `bit_pos` bits of it used.  The end is passed once every byte is in
// the window and more than 64 of its bits are used; reading a value there
// (read) marks the end and restarts the window (bits read after that are
// what libwebp reads: garbage, decided only by the alpha path's last pixel).
struct LBits {
    const uint8_t* buf;
    uint64_t len, pos = 0, val = 0;
    int bit_pos = 0;
    bool eos = false;
    LBits(const uint8_t* b, uint64_t n) : buf(b), len(n) {
        const uint64_t first = n < 8 ? n : 8;
        for (uint64_t i = 0; i < first; ++i) val |= (uint64_t)b[i] << (8 * i);
        pos = first;
    }
    inline bool at_end() const { return eos || (pos == len && bit_pos > 64); }
    inline void shift() {
        while (bit_pos >= 8 && pos < len) {
            val = (val >> 8) | ((uint64_t)buf[pos++] << 56);
            bit_pos -= 8;
        }
        if (at_end()) {
            eos = true;
            bit_pos = 0;
        }
    }
    inline void fill() {
        if (bit_pos >= 32) shift();
    }
    inline uint32_t peek() const { return (uint32_t)(val >> (bit_pos & 63)); }
    inline uint32_t read(int n) {
        if (!eos && n <= 24) {
            const uint32_t v = peek() & ((1u << n) - 1);
            bit_pos += n;
            shift();
            return v;
        }
        eos = true;
        bit_pos = 0;
        return 0;
    }
};

// A canonical prefix code: symbols of up to 8 bits through a 256-entry table
// of the next 8 stream bits, longer ones by the canonical walk.
struct HCode {
    uint32_t root[256];
    uint16_t count[16];
    std::vector<uint16_t> sorted;
    int single = -1;

    // false where libwebp's BuildHuffmanTable refuses the lengths
    bool build(const int* lens, int n) {
        std::memset(count, 0, sizeof(count));
        int nsym = 0, last = 0;
        for (int s = 0; s < n; ++s)
            if (lens[s]) {
                if (lens[s] > 15) return false;
                ++count[lens[s]];
                ++nsym;
                last = s;
            }
        if (nsym == 0) return false;
        if (nsym == 1) {
            single = last;
            return true;
        }
        int left = 1;
        for (int l = 1; l <= 15; ++l) {
            left = (left << 1) - count[l];
            if (left < 0) return false;
        }
        if (left != 0) return false;
        single = -1;
        int offs[16];
        offs[1] = 0;
        for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + count[l];
        sorted.assign(nsym, 0);
        for (int s = 0; s < n; ++s)
            if (lens[s]) sorted[offs[lens[s]]++] = (uint16_t)s;
        std::memset(root, 0, sizeof(root));
        uint32_t code = 0;
        int idx = 0;
        for (int l = 1; l <= 15; ++l) {
            for (int k = 0; k < count[l]; ++k, ++idx, ++code) {
                if (l > 8) continue;
                uint32_t rev = 0;
                for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
                for (uint32_t i = rev; i < 256; i += 1u << l) root[i] = ((uint32_t)l << 16) | sorted[idx];
            }
            code <<= 1;
        }
        return true;
    }
    inline int decode(LBits& br) const {
        if (single >= 0) return single;
        const uint32_t bits = br.peek();
        const uint32_t e = root[bits & 255];
        if (e) {
            br.bit_pos += (int)(e >> 16);
            return (int)(e & 0xffff);
        }
        int code = 0, first = 0, index = 0;
        for (int l = 1; l <= 15; ++l) {
            code |= (bits >> (l - 1)) & 1;
            const int c = count[l];
            if (code - c < first) {
                br.bit_pos += l;
                return sorted[index + (code - first)];
            }
            index += c;
            first = (first + c) << 1;
            code <<= 1;
        }
        br.bit_pos += 15;
        return 0;  // not reached for a complete code
    }
};

struct Group {
    HCode h[5];
};

struct Transform {
    int type, bits, xsize, ysize;
    std::vector<uint32_t> data;
};

struct LDecoder {
    LBits br;
    Transform transforms[4];
    int ntransforms = 0;
    unsigned seen = 0;
    explicit LDecoder(const uint8_t* d, uint64_t n) : br(d, n) {}
};

inline int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

bool read_code_lengths(LBits& br, const int* cl_lens, int num_symbols, int* lens) {
    HCode t;
    if (!t.build(cl_lens, 19)) return false;
    int max_symbol;
    if (br.read(1)) {
        const int nbits = 2 + 2 * (int)br.read(3);
        max_symbol = 2 + (int)br.read(nbits);
        if (max_symbol > num_symbols) return false;
    } else {
        max_symbol = num_symbols;
    }
    int symbol = 0, prev = 8;
    while (symbol < num_symbols) {
        if (max_symbol-- == 0) break;
        br.fill();
        const int code_len = t.decode(br);
        if (code_len < 16) {
            lens[symbol++] = code_len;
            if (code_len) prev = code_len;
        } else {
            static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
            const int slot = code_len - 16;
            const int repeat = (int)br.read(kExtra[slot]) + kOffset[slot];
            if (symbol + repeat > num_symbols) return false;
            const int l = code_len == 16 ? prev : 0;
            for (int i = 0; i < repeat; ++i) lens[symbol++] = l;
        }
    }
    return true;
}

bool read_code(LBits& br, int alphabet, HCode& out, std::vector<int>& lens) {
    lens.assign(alphabet > 256 ? alphabet : 256, 0);
    if (br.read(1)) {  // simple code
        const int num = (int)br.read(1) + 1;
        const int first8 = (int)br.read(1);
        lens[br.read(first8 ? 8 : 1)] = 1;
        if (num == 2) lens[br.read(8)] = 1;
    } else {
        int cl[19] = {0};
        const int num_codes = (int)br.read(4) + 4;
        for (int i = 0; i < num_codes; ++i) cl[kCodeLengthOrder[i]] = (int)br.read(3);
        if (!read_code_lengths(br, cl, alphabet, lens.data())) return false;
    }
    if (br.eos) return false;
    return out.build(lens.data(), alphabet);
}

struct Meta {
    int bits = 0, xsize = 0, cache_bits = 0;
    std::vector<uint32_t> image;  // group index per tile
    std::vector<Group> groups;
    inline const Group& group_at(int x, int y) const {
        if (bits == 0) return groups[0];
        return groups[image[(size_t)xsize * (y >> bits) + (x >> bits)]];
    }
};

bool decode_image_stream(LDecoder& dec, int xsize, int ysize, bool level0, Meta* level0_meta,
                         int* level0_xsize, std::vector<uint32_t>* out);

bool read_codes(LDecoder& dec, int xsize, int ysize, int cache_bits, bool allow_recursion,
                Meta& m) {
    LBits& br = dec.br;
    int num_max = 1;
    std::vector<uint32_t> img;
    if (allow_recursion && br.read(1)) {
        const int prec = 2 + (int)br.read(3);
        const int hx = sub_sample(xsize, prec), hy = sub_sample(ysize, prec);
        if (!decode_image_stream(dec, hx, hy, false, nullptr, nullptr, &img)) return false;
        m.bits = prec;
        m.xsize = hx;
        for (auto& p : img) {
            p = (p >> 8) & 0xffff;
            if ((int)p + 1 > num_max) num_max = (int)p + 1;
        }
    }
    if (br.eos) return false;
    // many groups: libwebp keeps only the ones the image uses (and still
    // reads and checks the others)
    std::vector<int> mapping;
    int num_used = num_max;
    if (num_max > 1000 || num_max > (int64_t)xsize * ysize) {
        mapping.assign(num_max, -1);
        num_used = 0;
        for (auto& p : img) {
            if (mapping[p] < 0) mapping[p] = num_used++;
            p = (uint32_t)mapping[p];
        }
    }
    m.image.swap(img);
    m.cache_bits = cache_bits;
    m.groups.resize(num_used);
    static const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
    std::vector<int> lens;
    Group scratch;
    for (int g = 0; g < num_max; ++g) {
        Group& grp = mapping.empty() ? m.groups[g] : mapping[g] < 0 ? scratch : m.groups[mapping[g]];
        for (int j = 0; j < 5; ++j) {
            const int alphabet = kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
            if (!read_code(br, alphabet, grp.h[j], lens)) return false;
        }
    }
    return true;
}

inline uint32_t copy_value(int sym, LBits& br) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    const uint32_t offset = (uint32_t)(2 + (sym & 1)) << extra;
    return offset + br.read(extra) + 1;
}

inline int plane_to_distance(int xsize, uint32_t code) {
    if (code > 120) return (int)(code - 120);
    const int dist_code = kCodeToPlane[code - 1];
    const int yoff = dist_code >> 4, xoff = 8 - (dist_code & 0xf);
    const int dist = yoff * xsize + xoff;
    return dist >= 1 ? dist : 1;
}

// The LZ77 / prefix-coded pixels of one (sub)image, as libwebp's
// DecodeImageData reads them: passing the end fails.
bool decode_pixels(LBits& br, const Meta& m, int w, int h, uint32_t* data) {
    const size_t total = (size_t)w * h;
    size_t pos = 0, last_cached = 0;
    int col = 0, row = 0;
    const int cache_size = m.cache_bits ? 1 << m.cache_bits : 0;
    std::vector<uint32_t> cache(cache_size ? cache_size : 1);
    const int cache_shift = 32 - m.cache_bits;
    auto insert_pending = [&]() {
        if (!cache_size) return;
        while (last_cached < pos) {
            const uint32_t argb = data[last_cached++];
            cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
        }
    };
    const int mask = m.bits ? (1 << m.bits) - 1 : -1;
    const Group* grp = total ? &m.group_at(0, 0) : nullptr;
    while (pos < total) {
        if ((col & mask) == 0) grp = &m.group_at(col, row);
        br.fill();
        const int code = grp->h[0].decode(br);
        if (br.at_end()) break;
        if (code < 256) {
            const int r = grp->h[1].decode(br);
            br.fill();
            const int b = grp->h[2].decode(br), a = grp->h[3].decode(br);
            if (br.at_end()) break;
            data[pos] = ((uint32_t)a << 24) | ((uint32_t)r << 16) | ((uint32_t)code << 8) | (uint32_t)b;
        } else if (code < 256 + 24) {
            const uint32_t length = copy_value(code - 256, br);
            const int dsym = grp->h[4].decode(br);
            br.fill();
            const int dist = plane_to_distance(w, copy_value(dsym, br));
            if (br.at_end()) break;
            if (pos < (size_t)dist || total - pos < length) return false;
            uint32_t* dst = data + pos;
            for (uint32_t i = 0; i < length; ++i) dst[i] = dst[(int64_t)i - dist];
            pos += length;
            col += (int)length;
            while (col >= w) {
                col -= w;
                ++row;
            }
            if (pos < total && (col & mask)) grp = &m.group_at(col, row);
            insert_pending();
            continue;
        } else if (code < 256 + 24 + cache_size) {
            insert_pending();
            data[pos] = cache[code - 256 - 24];
        } else {
            return false;
        }
        ++pos;
        if (++col >= w) {
            col = 0;
            ++row;
            insert_pending();
        }
    }
    return !br.at_end();
}

// An alpha stream's palette indices one byte per pixel, as libwebp's
// DecodeAlphaData reads them: the end may be passed by the last pixel.
bool decode_alpha8(LBits& br, const Meta& m, int w, int h, uint32_t* data) {
    const size_t total = (size_t)w * h;
    size_t pos = 0;
    int col = 0, row = 0;
    const int mask = m.bits ? (1 << m.bits) - 1 : -1;
    const Group* grp = total ? &m.group_at(0, 0) : nullptr;
    while (!br.eos && pos < total) {
        if ((col & mask) == 0) grp = &m.group_at(col, row);
        br.fill();
        const int code = grp->h[0].decode(br);
        if (code < 256) {
            data[pos++] = (uint32_t)code << 8;
            if (++col >= w) {
                col = 0;
                ++row;
            }
        } else if (code < 256 + 24) {
            const uint32_t length = copy_value(code - 256, br);
            const int dsym = grp->h[4].decode(br);
            br.fill();
            const int dist = plane_to_distance(w, copy_value(dsym, br));
            if (pos < (size_t)dist || total - pos < length) return false;
            uint32_t* dst = data + pos;
            for (uint32_t i = 0; i < length; ++i) dst[i] = dst[(int64_t)i - dist];
            pos += length;
            col += (int)length;
            while (col >= w) {
                col -= w;
                ++row;
            }
            if (pos < total && (col & mask)) grp = &m.group_at(col, row);
        } else {
            return false;
        }
        br.eos = br.at_end();
    }
    return !(br.at_end() && pos < total);
}

bool read_transform(LDecoder& dec, int* xsize, int ysize) {
    LBits& br = dec.br;
    const int type = (int)br.read(2);
    if (dec.seen & (1u << type)) return false;
    dec.seen |= 1u << type;
    Transform& t = dec.transforms[dec.ntransforms++];
    t.type = type;
    t.xsize = *xsize;
    t.ysize = ysize;
    t.bits = 0;
    t.data.clear();
    if (type == 0 || type == 1) {
        t.bits = (int)br.read(3) + 2;
        return decode_image_stream(dec, sub_sample(t.xsize, t.bits), sub_sample(ysize, t.bits),
                                   false, nullptr, nullptr, &t.data);
    }
    if (type == 3) {
        const int n = (int)br.read(8) + 1;
        const int bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
        *xsize = sub_sample(t.xsize, bits);
        t.bits = bits;
        std::vector<uint32_t> pal;
        if (!decode_image_stream(dec, n, 1, false, nullptr, nullptr, &pal)) return false;
        const int final_n = 1 << (8 >> bits);
        t.data.assign(final_n, 0);
        // each entry delta-coded from the one before, byte by byte
        uint8_t* dst = reinterpret_cast<uint8_t*>(t.data.data());
        const uint8_t* src = reinterpret_cast<const uint8_t*>(pal.data());
        for (int i = 0; i < 4; ++i) dst[i] = src[i];
        for (int i = 4; i < 4 * n; ++i) dst[i] = (uint8_t)(src[i] + dst[i - 4]);
    }
    return true;
}

bool decode_image_stream(LDecoder& dec, int xsize, int ysize, bool level0, Meta* level0_meta,
                         int* level0_xsize, std::vector<uint32_t>* out) {
    LBits& br = dec.br;
    int txs = xsize;
    if (level0)
        while (br.read(1))
            if (!read_transform(dec, &txs, ysize)) return false;
    int cache_bits = 0;
    if (br.read(1)) {
        cache_bits = (int)br.read(4);
        if (cache_bits < 1 || cache_bits > 11) return false;
    }
    Meta local;
    Meta& m = level0 ? *level0_meta : local;
    if (!read_codes(dec, txs, ysize, cache_bits, level0, m)) return false;
    if (level0) {
        *level0_xsize = txs;
        return true;
    }
    out->assign((size_t)txs * ysize, 0);
    return decode_pixels(br, m, txs, ysize, out->data()) && !br.eos;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int v = (int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) - (int)((c2 >> s) & 0xff);
        out |= (clip255((uint32_t)v) & 0xff) << s;
    }
    return out;
}
inline uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
    const uint32_t ave = average2(c0, c1);
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int a = (int)((ave >> s) & 0xff), b = (int)((c2 >> s) & 0xff);
        out |= (clip255((uint32_t)(a + (a - b) / 2)) & 0xff) << s;
    }
    return out;
}
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
    int sum = 0;
    for (int s = 0; s < 32; s += 8) {
        const int pa = (int)((a >> s) & 0xff), pb = (int)((b >> s) & 0xff), pc = (int)((c >> s) & 0xff);
        sum += std::abs(pb - pc) - std::abs(pa - pc);
    }
    return sum <= 0 ? a : b;
}

inline uint32_t predict(int mode, const uint32_t* top, uint32_t left) {
    switch (mode) {
        case 1: return left;
        case 2: return top[0];
        case 3: return top[1];
        case 4: return top[-1];
        case 5: return average2(average2(left, top[1]), top[0]);
        case 6: return average2(left, top[-1]);
        case 7: return average2(left, top[0]);
        case 8: return average2(top[-1], top[0]);
        case 9: return average2(top[0], top[1]);
        case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
        case 11: return select_pred(top[0], left, top[-1]);
        case 12: return add_sub_full(left, top[0], top[-1]);
        case 13: return add_sub_half(left, top[0], top[-1]);
        default: return 0xff000000u;
    }
}

// Undo `t` on `in` (t.xsize wide, except colour indexing: packed), giving
// t.xsize x t.ysize pixels.
void inverse_transform(const Transform& t, std::vector<uint32_t>& px) {
    const int w = t.xsize, h = t.ysize;
    if (t.type == 0) {
        uint32_t* d = px.data();
        d[0] = add_pixels(d[0], 0xff000000u);
        for (int x = 1; x < w; ++x) d[x] = add_pixels(d[x], d[x - 1]);
        const int tiles = sub_sample(w, t.bits);
        for (int y = 1; y < h; ++y) {
            uint32_t* row = d + (size_t)y * w;
            const uint32_t* top = row - w;
            const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tiles;
            row[0] = add_pixels(row[0], top[0]);
            for (int x = 1; x < w; ++x) {
                const int mode = (int)((modes[x >> t.bits] >> 8) & 0xf);
                row[x] = add_pixels(row[x], predict(mode, top + x, row[x - 1]));
            }
        }
    } else if (t.type == 1) {
        const int tiles = sub_sample(w, t.bits);
        for (int y = 0; y < h; ++y) {
            uint32_t* row = px.data() + (size_t)y * w;
            const uint32_t* codes = t.data.data() + (size_t)(y >> t.bits) * tiles;
            for (int x = 0; x < w; ++x) {
                const uint32_t cc = codes[x >> t.bits];
                const int g2r = (int8_t)(cc & 0xff), g2b = (int8_t)((cc >> 8) & 0xff),
                          r2b = (int8_t)((cc >> 16) & 0xff);
                const uint32_t argb = row[x];
                const int green = (int8_t)(argb >> 8);
                int nr = (int)((argb >> 16) & 0xff), nb = (int)(argb & 0xff);
                nr = (nr + ((g2r * green) >> 5)) & 0xff;
                nb += (g2b * green) >> 5;
                nb += (r2b * (int8_t)nr) >> 5;
                nb &= 0xff;
                row[x] = (argb & 0xff00ff00u) | ((uint32_t)nr << 16) | (uint32_t)nb;
            }
        }
    } else if (t.type == 2) {
        for (auto& p : px) {
            const uint32_t g = (p >> 8) & 0xff;
            p = (p & 0xff00ff00u) | (((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu);
        }
    } else {
        const int packed_w = sub_sample(w, t.bits);
        std::vector<uint32_t> out((size_t)w * h);
        const int bpp = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1, bit_mask = (1 << bpp) - 1;
        for (int y = 0; y < h; ++y) {
            const uint32_t* src = px.data() + (size_t)y * packed_w;
            uint32_t* dst = out.data() + (size_t)y * w;
            uint32_t packed = 0;
            for (int x = 0; x < w; ++x) {
                if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
                dst[x] = t.data[packed & bit_mask];
                packed >>= bpp;
            }
        }
        px.swap(out);
    }
}

// A VP8L image stream (after the header for an image, from the start for an
// alpha stream) of w x h into ARGB.
bool vp8l_stream(LDecoder& dec, int w, int h, bool alpha, std::vector<uint32_t>& argb) {
    Meta m;
    int txs = 0;
    if (!decode_image_stream(dec, w, h, true, &m, &txs, nullptr)) return false;
    bool eight_bit = false;
    if (alpha && dec.ntransforms == 1 && dec.transforms[0].type == 3 && m.cache_bits == 0) {
        eight_bit = true;
        for (const Group& g : m.groups)
            if (g.h[1].single < 0 || g.h[2].single < 0 || g.h[3].single < 0) eight_bit = false;
    }
    argb.assign((size_t)txs * h, 0);
    if (!(eight_bit ? decode_alpha8 : decode_pixels)(dec.br, m, txs, h, argb.data())) return false;
    for (int i = dec.ntransforms - 1; i >= 0; --i) inverse_transform(dec.transforms[i], argb);
    return true;
}

void unfilter_row(int filter, const uint8_t* prev, uint8_t* row, int w) {
    if (filter == 0) return;
    if (filter == 1 || prev == nullptr) {
        uint8_t pred = prev == nullptr ? 0 : prev[0];
        for (int i = 0; i < w; ++i) {
            row[i] = (uint8_t)(pred + row[i]);
            pred = row[i];
        }
    } else if (filter == 2) {
        for (int i = 0; i < w; ++i) row[i] = (uint8_t)(prev[i] + row[i]);
    } else {
        uint8_t top = prev[0], top_left = top, left = top;
        for (int i = 0; i < w; ++i) {
            top = prev[i];
            int g = left + top - top_left;
            g = g < 0 ? 0 : g > 255 ? 255 : g;
            left = (uint8_t)(row[i] + g);
            top_left = top;
            row[i] = left;
        }
    }
}

// The ALPH chunk's payload into w x h alpha values; false where libwebp fails.
bool decode_alpha(const uint8_t* data, uint64_t size, int w, int h, uint8_t* out) {
    if (size <= 1) return false;
    const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3,
              rsrv = (data[0] >> 6) & 3;
    if (method > 1 || pre > 1 || rsrv != 0) return false;
    const size_t n = (size_t)w * h;
    if (method == 0) {
        if (size - 1 < n) return false;
        std::memcpy(out, data + 1, n);
    } else {
        LDecoder dec(data + 1, size - 1);
        std::vector<uint32_t> argb;
        if (!vp8l_stream(dec, w, h, true, argb)) return false;
        for (size_t i = 0; i < n; ++i) out[i] = (uint8_t)(argb[i] >> 8);
    }
    for (int y = 0; y < h; ++y)
        unfilter_row(filter, y ? out + (size_t)(y - 1) * w : nullptr, out + (size_t)y * w, w);
    return true;
}

// ---------------------------------------------------------------------------
// VP8

struct BoolDec {
    const uint8_t *buf = nullptr, *end = nullptr, *max = nullptr;
    uint64_t value = 0;
    int bits = -8;
    uint32_t range = 254;
    bool eof = false;

    void init(const uint8_t* s, size_t n) {
        buf = s;
        end = s + n;
        max = n >= 8 ? s + n - 8 + 1 : s;
        value = 0;
        bits = -8;
        range = 254;
        eof = false;
        load();
    }
    void load() {
        if (buf < max) {
            uint64_t v = 0;
            for (int i = 0; i < 7; ++i) v = (v << 8) | buf[i];
            buf += 7;
            value = v | (value << 56);
            bits += 56;
        } else if (buf < end) {
            bits += 8;
            value = (uint64_t)(*buf++) | (value << 8);
        } else if (!eof) {
            value <<= 8;
            bits += 8;
            eof = true;
        } else {
            bits = 0;
        }
    }
    inline int get_bit(int prob) {
        uint32_t r = range;
        if (bits < 0) load();
        const int pos = bits;
        const uint32_t split = (r * (uint32_t)prob) >> 8;
        const uint32_t v = (uint32_t)(value >> pos);
        const int bit = v > split;
        if (bit) {
            r -= split;
            value -= (uint64_t)(split + 1) << pos;
        } else {
            r = split + 1;
        }
        const int shift = 7 ^ (31 - __builtin_clz(r));
        r <<= shift;
        bits -= shift;
        range = r - 1;
        return bit;
    }
    inline int get_value(int n) {
        int v = 0;
        while (n-- > 0) v |= get_bit(0x80) << n;
        return v;
    }
    inline int get_signed_value(int n) {
        const int v = get_value(n);
        return get_bit(0x80) ? -v : v;
    }
};

constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// The inverse DCT as libwebp runs it on x86: blocks with coefficients past
// the third (and chroma blocks beside them) through its SSE2 transform,
// whose sums wrap at 16 bits; the rest through its C transforms (DC only,
// or the first three coefficients) in int.  The two agree on every stream
// an encoder writes and differ where corrupt data overflows 16 bits.
inline int16_t w16(int v) { return (int16_t)v; }
inline int mulhi(int16_t x, int k) { return (x * k) >> 16; }
constexpr int kK1 = 20091, kK2 = -30068;

void transform_sse2(const int16_t* in, uint8_t* dst) {
    int16_t C[16];
    for (int i = 0; i < 4; ++i) {
        const int16_t in0 = in[i], in1 = in[4 + i], in2 = in[8 + i], in3 = in[12 + i];
        const int16_t a = w16(in0 + in2), b = w16(in0 - in2);
        const int16_t c = w16(w16(in1 - in3) + w16(mulhi(in1, kK2) - mulhi(in3, kK1)));
        const int16_t d = w16(w16(in1 + in3) + w16(mulhi(in1, kK1) + mulhi(in3, kK2)));
        C[4 * i + 0] = w16(a + d);
        C[4 * i + 1] = w16(b + c);
        C[4 * i + 2] = w16(b - c);
        C[4 * i + 3] = w16(a - d);
    }
    for (int i = 0; i < 4; ++i) {
        const int16_t t0 = C[i], t1 = C[4 + i], t2 = C[8 + i], t3 = C[12 + i];
        const int16_t dc = w16(t0 + 4);
        const int16_t a = w16(dc + t2), b = w16(dc - t2);
        const int16_t c = w16(w16(t1 - t3) + w16(mulhi(t1, kK2) - mulhi(t3, kK1)));
        const int16_t d = w16(w16(t1 + t3) + w16(mulhi(t1, kK1) + mulhi(t3, kK2)));
        const int16_t out[4] = {(int16_t)(w16(a + d) >> 3), (int16_t)(w16(b + c) >> 3),
                                (int16_t)(w16(b - c) >> 3), (int16_t)(w16(a - d) >> 3)};
        for (int k = 0; k < 4; ++k) {
            const int v = w16(dst[k] + out[k]);
            dst[k] = v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v;
        }
        dst += BPS;
    }
}

void transform_ac3(const int16_t* in, uint8_t* dst) {
    const int a = in[0] + 4;
    const int c4 = mul2(in[4]), d4 = mul1(in[4]), c1 = mul2(in[1]), d1 = mul1(in[1]);
    const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
    for (int y = 0; y < 4; ++y) {
        dst[0] = clip8(dst[0] + ((rows[y] + d1) >> 3));
        dst[1] = clip8(dst[1] + ((rows[y] + c1) >> 3));
        dst[2] = clip8(dst[2] + ((rows[y] - c1) >> 3));
        dst[3] = clip8(dst[3] + ((rows[y] - d1) >> 3));
        dst += BPS;
    }
}

void transform_dc(const int16_t* in, uint8_t* dst) {
    const int dc = in[0] + 4;
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) dst[x + y * BPS] = clip8(dst[x + y * BPS] + (dc >> 3));
}

// one luma block by its non-zero code (3: past the third coefficient, 2: up
// to the third, 1: DC only, 0: none)
inline void transform_block(uint32_t code, const int16_t* in, uint8_t* dst) {
    if (code == 3) transform_sse2(in, dst);
    else if (code == 2) transform_ac3(in, dst);
    else if (code == 1) transform_dc(in, dst);
}

void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
        out[0] = (int16_t)((a0 + a1) >> 3);
        out[16] = (int16_t)((a3 + a2) >> 3);
        out[32] = (int16_t)((a0 - a1) >> 3);
        out[48] = (int16_t)((a3 - a2) >> 3);
        out += 64;
    }
}

#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)
#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    const int tl = top[-1];
    for (int y = 0; y < size; ++y) {
        const int left = dst[-1];
        for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left - tl);
        dst += BPS;
    }
}

void put_block(uint8_t* dst, int size, int v) {
    for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

// 16x16 and chroma: mode 0 DC, 1 TM, 2 V, 3 H, 4 DC no top, 5 DC no left,
// 6 DC no top or left
void predict_square(uint8_t* dst, int size, int mode) {
    const int shift = size == 16 ? 4 : 3;
    int dc;
    switch (mode) {
        case 0:
            dc = size;
            for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
            put_block(dst, size, dc >> (shift + 1));
            break;
        case 1: true_motion(dst, size); break;
        case 2:
            for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
            break;
        case 3:
            for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[-1 + j * BPS], size);
            break;
        case 4:
            dc = size >> 1;
            for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
            put_block(dst, size, dc >> shift);
            break;
        case 5:
            dc = size >> 1;
            for (int j = 0; j < size; ++j) dc += dst[j - BPS];
            put_block(dst, size, dc >> shift);
            break;
        default: put_block(dst, size, 0x80); break;
    }
}

void predict4(uint8_t* dst, int mode) {
    const uint8_t* top = dst - BPS;
    const int X = dst[-1 - BPS];
    const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
              H = top[7];
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
    switch (mode) {
        case 0: {
            uint32_t dc = 4;
            for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
            put_block(dst, 4, (int)(dc >> 3));
            break;
        }
        case 1: true_motion(dst, 4); break;
        case 2: {
            const uint8_t v[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
            for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
            break;
        }
        case 3:
            std::memset(dst, AVG3(X, I, J), 4);
            std::memset(dst + BPS, AVG3(I, J, K), 4);
            std::memset(dst + 2 * BPS, AVG3(J, K, L), 4);
            std::memset(dst + 3 * BPS, AVG3(K, L, L), 4);
            break;
        case 4:  // down-right
            DST(0, 3) = AVG3(J, K, L);
            DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
            DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
            DST(3, 0) = AVG3(D, C, B);
            break;
        case 5:  // vertical-right
            DST(0, 0) = DST(1, 2) = AVG2(X, A);
            DST(1, 0) = DST(2, 2) = AVG2(A, B);
            DST(2, 0) = DST(3, 2) = AVG2(B, C);
            DST(3, 0) = AVG2(C, D);
            DST(0, 3) = AVG3(K, J, I);
            DST(0, 2) = AVG3(J, I, X);
            DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
            DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
            DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
            DST(3, 1) = AVG3(B, C, D);
            break;
        case 6:  // down-left
            DST(0, 0) = AVG3(A, B, C);
            DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
            DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
            DST(3, 3) = AVG3(G, H, H);
            break;
        case 7:  // vertical-left
            DST(0, 0) = AVG2(A, B);
            DST(1, 0) = DST(0, 2) = AVG2(B, C);
            DST(2, 0) = DST(1, 2) = AVG2(C, D);
            DST(3, 0) = DST(2, 2) = AVG2(D, E);
            DST(0, 1) = AVG3(A, B, C);
            DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
            DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
            DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
            DST(3, 2) = AVG3(E, F, G);
            DST(3, 3) = AVG3(F, G, H);
            break;
        case 8:  // horizontal-down
            DST(0, 0) = DST(2, 1) = AVG2(I, X);
            DST(0, 1) = DST(2, 2) = AVG2(J, I);
            DST(0, 2) = DST(2, 3) = AVG2(K, J);
            DST(0, 3) = AVG2(L, K);
            DST(3, 0) = AVG3(A, B, C);
            DST(2, 0) = AVG3(X, A, B);
            DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
            DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
            DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
            DST(1, 3) = AVG3(L, K, J);
            break;
        default:  // horizontal-up
            DST(0, 0) = AVG2(I, J);
            DST(2, 0) = DST(0, 1) = AVG2(J, K);
            DST(2, 1) = DST(0, 2) = AVG2(K, L);
            DST(1, 0) = AVG3(I, J, K);
            DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
            DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
            break;
    }
}

struct MBData {
    int16_t coeffs[384];
    uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
    uint32_t non_zero_y, non_zero_uv;
};

struct FInfo {
    uint8_t limit, ilevel, inner, hev;
};

struct VP8Frame {
    int width, height, mb_w, mb_h;
    std::vector<uint8_t> y, u, v;  // mb_w*16 wide, mb_h*16 high (chroma halves)
};

// Where the coefficients stop (the last non-zero one's position plus one,
// or where the zero run reached 16).
int get_coeffs(BoolDec& br, const uint8_t* const* prob, int ctx, const int* dq, int n,
               int16_t* out) {
    const uint8_t* p = prob[n] + ctx * 11;
    for (; n < 16; ++n) {
        if (!br.get_bit(p[0])) return n;
        while (!br.get_bit(p[1])) {
            p = prob[++n];
            if (n == 16) return 16;
        }
        const uint8_t* p_ctx = prob[n + 1];
        int v;
        if (!br.get_bit(p[2])) {
            v = 1;
            p = p_ctx + 11;
        } else {
            if (!br.get_bit(p[3])) {
                if (!br.get_bit(p[4])) v = 2;
                else v = 3 + br.get_bit(p[5]);
            } else if (!br.get_bit(p[6])) {
                if (!br.get_bit(p[7])) {
                    v = 5 + br.get_bit(159);
                } else {
                    v = 7 + 2 * br.get_bit(165);
                    v += br.get_bit(145);
                }
            } else {
                const int bit1 = br.get_bit(p[8]);
                const int bit0 = br.get_bit(p[9 + bit1]);
                const int cat = 2 * bit1 + bit0;
                v = 0;
                for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
                v += 3 + (8 << cat);
            }
            p = p_ctx + 22;
        }
        const int s = br.get_bit(0x80) ? -v : v;
        out[kZigzag[n]] = (int16_t)(s * dq[n > 0]);
    }
    return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
}

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return ((v & ~16383) == 0) ? (uint8_t)(v >> 6) : (v < 0) ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
    rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// One output row of libwebp's fancy upsampler: `near` is the chroma row
// whose samples weigh 3, `far` the one that weighs 1.
void upsample_row(const uint8_t* yrow, const uint8_t* nu, const uint8_t* nv, const uint8_t* fu,
                  const uint8_t* fv, int len, uint8_t* out) {
    yuv_to_rgb(yrow[0], (3 * nu[0] + fu[0] + 2) >> 2, (3 * nv[0] + fv[0] + 2) >> 2, out);
    const int last_pair = (len - 1) >> 1;
    for (int x = 1; x <= last_pair; ++x) {
        const uint8_t* n[2] = {nu, nv};
        const uint8_t* f[2] = {fu, fv};
        int c0[2], c1[2];
        for (int c = 0; c < 2; ++c) {
            const int nl = n[c][x - 1], nr = n[c][x], fl = f[c][x - 1], fr = f[c][x];
            const int avg = nl + nr + fl + fr + 8;
            const int d_a = (avg + 2 * (nr + fl)) >> 3;  // toward the near-left sample
            const int d_b = (avg + 2 * (nl + fr)) >> 3;  // toward the near-right sample
            c0[c] = (d_a + nl) >> 1;
            c1[c] = (d_b + nr) >> 1;
        }
        yuv_to_rgb(yrow[2 * x - 1], c0[0], c0[1], out + 3 * (2 * x - 1));
        yuv_to_rgb(yrow[2 * x], c1[0], c1[1], out + 3 * (2 * x));
    }
    if (!(len & 1)) {
        const int k = (len - 1) >> 1;
        yuv_to_rgb(yrow[len - 1], (3 * nu[k] + fu[k] + 2) >> 2, (3 * nv[k] + fv[k] + 2) >> 2,
                   out + 3 * (len - 1));
    }
}

// loop filter
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }    // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }         // [-112, 112]
inline uint8_t uclip(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

inline void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = uclip(p0 + a2);
    p[0] = uclip(q0 - a1);
}
inline void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = uclip(p1 + a3);
    p[-step] = uclip(p0 + a2);
    p[0] = uclip(q0 - a1);
    p[step] = uclip(q1 - a3);
}
inline void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
    p[-3 * step] = uclip(p2 + a3);
    p[-2 * step] = uclip(p1 + a2);
    p[-step] = uclip(p0 + a1);
    p[0] = uclip(q0 - a1);
    p[step] = uclip(q1 - a2);
    p[2 * step] = uclip(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
           std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i)
        if (needs_filter(p + i * vstride, hstride, t2)) do_filter2(p + i * vstride, hstride);
}
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_t, bool mb_edge) {
    const int t2 = 2 * thresh + 1;
    while (size-- > 0) {
        if (needs_filter2(p, hstride, t2, ithresh)) {
            if (hev(p, hstride, hev_t)) do_filter2(p, hstride);
            else if (mb_edge) do_filter6(p, hstride);
            else do_filter4(p, hstride);
        }
        p += vstride;
    }
}

struct Quant {
    int y1[2], y2[2], uv[2];
};

// Decode a VP8 key frame (`data`: from the frame tag to the end of the
// data) into its macroblock-aligned planes; raises Fail.
void vp8_decode(const uint8_t* data, uint64_t size, VP8Frame& fr) {
    if (size < 4) throw Fail("VP8 frame header cut short");
    const uint32_t tag = data[0] | (data[1] << 8) | (data[2] << 16);
    const bool key_frame = !(tag & 1);
    const int profile = (tag >> 1) & 7, show = (tag >> 4) & 1;
    const uint32_t part_len = tag >> 5;
    if (profile > 3) throw Fail("VP8: incorrect keyframe parameters");
    if (!show) throw Fail("VP8: frame not displayable");
    const uint8_t* buf = data + 3;
    uint64_t left = size - 3;
    if (!key_frame) throw Fail("VP8: not a key frame");
    if (left < 7) throw Fail("VP8: cannot parse picture header");
    if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) throw Fail("VP8: bad code word");
    fr.width = ((buf[4] << 8) | buf[3]) & 0x3fff;
    fr.height = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    left -= 7;
    fr.mb_w = (fr.width + 15) >> 4;
    fr.mb_h = (fr.height + 15) >> 4;
    if (part_len > left) throw Fail("VP8: bad partition length");
    BoolDec br;
    br.init(buf, part_len);
    buf += part_len;
    left -= part_len;

    br.get_value(1);  // colour space
    br.get_value(1);  // clamping type
    // segment header
    bool use_segment = br.get_value(1), update_map = false, absolute_delta = true;
    int quantizer[4] = {0}, filter_strength[4] = {0};
    uint8_t seg_probs[3] = {255, 255, 255};
    if (use_segment) {
        update_map = br.get_value(1);
        if (br.get_value(1)) {
            absolute_delta = br.get_value(1);
            for (int s = 0; s < 4; ++s) quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
            for (int s = 0; s < 4; ++s) filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
        }
        if (update_map)
            for (int s = 0; s < 3; ++s) seg_probs[s] = br.get_value(1) ? (uint8_t)br.get_value(8) : 255;
    }
    if (br.eof) throw Fail("VP8: cannot parse segment header");
    // filter header
    const bool simple = br.get_value(1);
    const int level = br.get_value(6), sharpness = br.get_value(3);
    const bool use_lf_delta = br.get_value(1);
    int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
    if (use_lf_delta && br.get_value(1)) {
        for (int i = 0; i < 4; ++i)
            if (br.get_value(1)) ref_lf_delta[i] = br.get_signed_value(6);
        for (int i = 0; i < 4; ++i)
            if (br.get_value(1)) mode_lf_delta[i] = br.get_signed_value(6);
    }
    const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) throw Fail("VP8: cannot parse filter header");
    // partitions
    const int num_parts = 1 << br.get_value(2);
    const int last_part = num_parts - 1;
    if (left < 3 * (uint64_t)last_part) throw Fail("VP8: cannot parse partitions");
    std::vector<BoolDec> parts(num_parts);
    {
        const uint8_t* sz = buf;
        const uint8_t* part_start = buf + last_part * 3;
        uint64_t size_left = left - last_part * 3;
        for (int p = 0; p < last_part; ++p) {
            uint64_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
            if (psize > size_left) psize = size_left;
            parts[p].init(part_start, psize);
            part_start += psize;
            size_left -= psize;
            sz += 3;
        }
        parts[last_part].init(part_start, size_left);
        if (part_start >= buf + left) throw Fail("VP8: cannot parse partitions");
    }
    // quantisers
    Quant dqm[4];
    {
        const int base_q0 = br.get_value(7);
        const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
        const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
        const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
        const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
        const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
        auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
        for (int i = 0; i < 4; ++i) {
            int q;
            if (use_segment) {
                q = quantizer[i] + (absolute_delta ? 0 : base_q0);
            } else if (i > 0) {
                dqm[i] = dqm[0];
                continue;
            } else {
                q = base_q0;
            }
            Quant& m = dqm[i];
            m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
            m.y1[1] = kAcTable[clip(q, 127)];
            m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
            m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
            if (m.y2[1] < 8) m.y2[1] = 8;
            m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
            m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
        }
    }
    br.get_value(1);  // update_proba, ignored for a key frame
    uint8_t proba[4][8][3][11];
    for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 8; ++b)
            for (int c = 0; c < 3; ++c)
                for (int p = 0; p < 11; ++p) {
                    const int i = ((t * 8 + b) * 3 + c) * 11 + p;
                    proba[t][b][c][p] = br.get_bit(kCoeffsUpdateProba[i]) ? (uint8_t)br.get_value(8)
                                                                         : kCoeffsProba0[i];
                }
    const uint8_t* bands[4][17];
    for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 17; ++b) bands[t][b] = &proba[t][kBands[b]][0][0];
    const bool use_skip_proba = br.get_value(1);
    const int skip_p = use_skip_proba ? br.get_value(8) : 0;

    // filter strengths per segment and 4x4-ness
    FInfo fstrengths[4][2];
    std::memset(fstrengths, 0, sizeof(fstrengths));
    if (filter_type > 0) {
        for (int s = 0; s < 4; ++s) {
            int base_level = level;
            if (use_segment) base_level = filter_strength[s] + (absolute_delta ? 0 : level);
            for (int i4 = 0; i4 <= 1; ++i4) {
                FInfo& info = fstrengths[s][i4];
                int lv = base_level;
                if (use_lf_delta) {
                    lv += ref_lf_delta[0];
                    if (i4) lv += mode_lf_delta[0];
                }
                lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
                if (lv > 0) {
                    int ilevel = lv;
                    if (sharpness > 0) {
                        ilevel >>= sharpness > 4 ? 2 : 1;
                        if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
                    }
                    if (ilevel < 1) ilevel = 1;
                    info.ilevel = (uint8_t)ilevel;
                    info.limit = (uint8_t)(2 * lv + ilevel);
                    info.hev = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
                } else {
                    info.limit = 0;
                }
                info.inner = (uint8_t)i4;
            }
        }
    }

    const int mb_w = fr.mb_w, mb_h = fr.mb_h;
    const int ys = mb_w * 16, uvs = mb_w * 8;
    fr.y.assign((size_t)ys * mb_h * 16, 0);
    fr.u.assign((size_t)uvs * mb_h * 8, 0);
    fr.v.assign((size_t)uvs * mb_h * 8, 0);
    std::vector<FInfo> finfo((size_t)mb_w * mb_h);
    std::vector<uint8_t> intra_t(4 * mb_w, 0);
    std::vector<uint8_t> nz_top(mb_w, 0), nz_dc_top(mb_w, 0);
    std::vector<uint8_t> top_y((size_t)mb_w * 16), top_u((size_t)mb_w * 8), top_v((size_t)mb_w * 8);
    std::vector<MBData> row(mb_w);
    uint8_t ws[BPS * 17 + BPS * 9];
    uint8_t* const y_dst = ws + Y_OFF;
    uint8_t* const u_dst = ws + U_OFF;
    uint8_t* const v_dst = ws + V_OFF;
    static const int kScan[16] = {0,       4,           8,           12,
                                  4 * BPS, 4 + 4 * BPS, 8 + 4 * BPS, 12 + 4 * BPS,
                                  8 * BPS, 4 + 8 * BPS, 8 + 8 * BPS, 12 + 8 * BPS,
                                  12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
        // intra modes of the row (first partition)
        uint8_t intra_l[4] = {0, 0, 0, 0};
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            MBData& blk = row[mb_x];
            uint8_t* top = &intra_t[4 * mb_x];
            blk.segment = update_map ? (!br.get_bit(seg_probs[0]) ? br.get_bit(seg_probs[1])
                                                                  : br.get_bit(seg_probs[2]) + 2)
                                     : 0;
            blk.skip = use_skip_proba ? (uint8_t)br.get_bit(skip_p) : 0;
            blk.is_i4x4 = !br.get_bit(145);
            if (!blk.is_i4x4) {
                const int ymode = br.get_bit(156) ? (br.get_bit(128) ? 1 : 3) : (br.get_bit(163) ? 2 : 0);
                blk.imodes[0] = (uint8_t)ymode;
                std::memset(top, ymode, 4);
                std::memset(intra_l, ymode, 4);
            } else {
                uint8_t* modes = blk.imodes;
                for (int y = 0; y < 4; ++y) {
                    int ymode = intra_l[y];
                    for (int x = 0; x < 4; ++x) {
                        const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
                        int i = kYModesIntra4[br.get_bit(prob[0])];
                        while (i > 0) i = kYModesIntra4[2 * i + br.get_bit(prob[i])];
                        ymode = -i;
                        top[x] = (uint8_t)ymode;
                    }
                    std::memcpy(modes, top, 4);
                    modes += 4;
                    intra_l[y] = (uint8_t)ymode;
                }
            }
            blk.uvmode = !br.get_bit(142) ? 0 : !br.get_bit(114) ? 2 : br.get_bit(183) ? 1 : 3;
        }
        if (br.eof) throw Fail("VP8: premature end of partition 0");
        // tokens
        BoolDec& tb = parts[mb_y & last_part];
        uint8_t nz_left = 0, nz_dc_left = 0;
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            MBData& blk = row[mb_x];
            const Quant& q = dqm[blk.segment];
            int skip = use_skip_proba ? blk.skip : 0;
            if (!skip) {
                int16_t* dst = blk.coeffs;
                std::memset(dst, 0, sizeof(blk.coeffs));
                const uint8_t* const* ac_proba;
                int first;
                if (!blk.is_i4x4) {
                    int16_t dc[16] = {0};
                    const int ctx = nz_dc_top[mb_x] + nz_dc_left;
                    const int nz = get_coeffs(tb, bands[1], ctx, q.y2, 0, dc);
                    nz_dc_top[mb_x] = nz_dc_left = nz > 0;
                    transform_wht(dc, dst);
                    first = 1;
                    ac_proba = bands[0];
                } else {
                    first = 0;
                    ac_proba = bands[3];
                }
                uint32_t tnz = nz_top[mb_x] & 0x0f, lnz = nz_left & 0x0f;
                uint32_t non_zero_y = 0, non_zero_uv = 0;
                for (int y = 0; y < 4; ++y) {
                    int l = lnz & 1;
                    uint32_t nz_coeffs = 0;
                    for (int x = 0; x < 4; ++x) {
                        const int ctx = l + (tnz & 1);
                        const int nz = get_coeffs(tb, ac_proba, ctx, q.y1, first, dst);
                        l = nz > first;
                        tnz = (tnz >> 1) | (l << 7);
                        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                        dst += 16;
                    }
                    tnz >>= 4;
                    lnz = (lnz >> 1) | (l << 7);
                    non_zero_y = (non_zero_y << 8) | nz_coeffs;
                }
                uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
                for (int ch = 0; ch < 4; ch += 2) {
                    uint32_t nz_coeffs = 0;
                    tnz = nz_top[mb_x] >> (4 + ch);
                    lnz = nz_left >> (4 + ch);
                    for (int y = 0; y < 2; ++y) {
                        int l = lnz & 1;
                        for (int x = 0; x < 2; ++x) {
                            const int ctx = l + (tnz & 1);
                            const int nz = get_coeffs(tb, bands[2], ctx, q.uv, 0, dst);
                            l = nz > 0;
                            tnz = (tnz >> 1) | (l << 3);
                            nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                            dst += 16;
                        }
                        tnz >>= 2;
                        lnz = (lnz >> 1) | (l << 5);
                    }
                    non_zero_uv |= nz_coeffs << (4 * ch);
                    out_t_nz |= (tnz << 4) << ch;
                    out_l_nz |= (lnz & 0xf0) << ch;
                }
                nz_top[mb_x] = (uint8_t)out_t_nz;
                nz_left = (uint8_t)out_l_nz;
                blk.non_zero_y = non_zero_y;
                blk.non_zero_uv = non_zero_uv;
                skip = !(non_zero_y | non_zero_uv);
            } else {
                nz_top[mb_x] = nz_left = 0;
                if (!blk.is_i4x4) nz_dc_top[mb_x] = nz_dc_left = 0;
                blk.non_zero_y = blk.non_zero_uv = 0;
            }
            if (filter_type > 0) {
                FInfo f = fstrengths[blk.segment][blk.is_i4x4];
                f.inner |= !skip;
                finfo[(size_t)mb_y * mb_w + mb_x] = f;
            }
            if (tb.eof) throw Fail("VP8: premature end of file");
        }
        // reconstruct the row
        for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
        for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
        if (mb_y > 0) {
            y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
        } else {
            std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
            std::memset(u_dst - BPS - 1, 127, 8 + 1);
            std::memset(v_dst - BPS - 1, 127, 8 + 1);
        }
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            const MBData& blk = row[mb_x];
            if (mb_x > 0) {
                for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
                for (int j = -1; j < 8; ++j) {
                    std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
                    std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
                }
            }
            if (mb_y > 0) {
                std::memcpy(y_dst - BPS, &top_y[16 * mb_x], 16);
                std::memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
                std::memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
            }
            const int16_t* coeffs = blk.coeffs;
            uint32_t bits = blk.non_zero_y;
            if (blk.is_i4x4) {
                uint8_t* top_right = y_dst - BPS + 16;
                if (mb_y > 0) {
                    if (mb_x >= mb_w - 1) std::memset(top_right, top_y[16 * mb_x + 15], 4);
                    else std::memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
                }
                for (int k = 1; k <= 3; ++k) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
                for (int n = 0; n < 16; ++n, bits <<= 2) {
                    uint8_t* dst = y_dst + kScan[n];
                    predict4(dst, blk.imodes[n]);
                    transform_block(bits >> 30, coeffs + n * 16, dst);
                }
            } else {
                int mode = blk.imodes[0];
                if (mode == 0) mode = mb_x == 0 ? (mb_y == 0 ? 6 : 5) : (mb_y == 0 ? 4 : 0);
                predict_square(y_dst, 16, mode);
                for (int n = 0; n < 16; ++n, bits <<= 2)
                    transform_block(bits >> 30, coeffs + n * 16, y_dst + kScan[n]);
            }
            {
                const uint32_t bits_uv = blk.non_zero_uv;
                int mode = blk.uvmode;
                if (mode == 0) mode = mb_x == 0 ? (mb_y == 0 ? 6 : 5) : (mb_y == 0 ? 4 : 0);
                predict_square(u_dst, 8, mode);
                predict_square(v_dst, 8, mode);
                static const int kUV[4] = {0, 4, 4 * BPS, 4 * BPS + 4};
                for (int p = 0; p < 2; ++p) {
                    const uint32_t b = (bits_uv >> (8 * p)) & 0xff;
                    uint8_t* dst = p ? v_dst : u_dst;
                    if (!b) continue;
                    for (int n = 0; n < 4; ++n) {
                        if (b & 0xaa) transform_sse2(coeffs + 256 + 64 * p + n * 16, dst + kUV[n]);
                        else transform_dc(coeffs + 256 + 64 * p + n * 16, dst + kUV[n]);
                    }
                }
            }
            std::memcpy(&top_y[16 * mb_x], y_dst + 15 * BPS, 16);
            std::memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
            std::memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
            for (int j = 0; j < 16; ++j)
                std::memcpy(&fr.y[(size_t)(mb_y * 16 + j) * ys + mb_x * 16], y_dst + j * BPS, 16);
            for (int j = 0; j < 8; ++j) {
                std::memcpy(&fr.u[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], u_dst + j * BPS, 8);
                std::memcpy(&fr.v[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], v_dst + j * BPS, 8);
            }
        }
    }
    for (int p = 0; p < num_parts; ++p)
        if (parts[p].eof) throw Fail("VP8: premature end of file");

    // loop filter, macroblock raster order
    if (filter_type > 0) {
        for (int mb_y = 0; mb_y < mb_h; ++mb_y)
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                const FInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
                const int limit = f.limit;
                if (limit == 0) continue;
                uint8_t* yd = &fr.y[(size_t)mb_y * 16 * ys + mb_x * 16];
                if (filter_type == 1) {
                    if (mb_x > 0) simple_filter(yd, 1, ys, limit + 4);
                    if (f.inner)
                        for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k, 1, ys, limit);
                    if (mb_y > 0) simple_filter(yd, ys, 1, limit + 4);
                    if (f.inner)
                        for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k * ys, ys, 1, limit);
                } else {
                    uint8_t* ud = &fr.u[(size_t)mb_y * 8 * uvs + mb_x * 8];
                    uint8_t* vd = &fr.v[(size_t)mb_y * 8 * uvs + mb_x * 8];
                    const int il = f.ilevel, ht = f.hev;
                    if (mb_x > 0) {
                        filter_loop(yd, 1, ys, 16, limit + 4, il, ht, true);
                        filter_loop(ud, 1, uvs, 8, limit + 4, il, ht, true);
                        filter_loop(vd, 1, uvs, 8, limit + 4, il, ht, true);
                    }
                    if (f.inner) {
                        for (int k = 1; k <= 3; ++k) filter_loop(yd + 4 * k, 1, ys, 16, limit, il, ht, false);
                        filter_loop(ud + 4, 1, uvs, 8, limit, il, ht, false);
                        filter_loop(vd + 4, 1, uvs, 8, limit, il, ht, false);
                    }
                    if (mb_y > 0) {
                        filter_loop(yd, ys, 1, 16, limit + 4, il, ht, true);
                        filter_loop(ud, uvs, 1, 8, limit + 4, il, ht, true);
                        filter_loop(vd, uvs, 1, 8, limit + 4, il, ht, true);
                    }
                    if (f.inner) {
                        for (int k = 1; k <= 3; ++k)
                            filter_loop(yd + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
                        filter_loop(ud + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
                        filter_loop(vd + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
                    }
                }
            }
    }
}

void copy_msg(const char* m, char* msg, int64_t msg_len) {
    if (msg && msg_len > 0) {
        std::strncpy(msg, m, (size_t)msg_len - 1);
        msg[msg_len - 1] = 0;
    }
}

}  // namespace

extern "C" {

// A VP8L image (`data` from its signature byte to the end of the data) into
// RGB `out` [h, w, 3] (h, w from its header, checked against the caller's).
// 0 on success, 1 where libwebp fails (the reason in `msg`).
int webp_vp8l(const uint8_t* data, int64_t size, int width, int height, uint8_t* out, char* msg,
              int64_t msg_len) {
    try {
        if (size < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) throw Fail("VP8L: bad signature");
        LDecoder dec(data, (uint64_t)size);
        dec.br.read(8);
        const int w = (int)dec.br.read(14) + 1, h = (int)dec.br.read(14) + 1;
        dec.br.read(1);
        if (dec.br.read(3) != 0 || dec.br.eos) throw Fail("VP8L: bad header");
        if (w != width || h != height) throw Fail("VP8L: sides differ from the caller's");
        std::vector<uint32_t> argb;
        if (!vp8l_stream(dec, w, h, false, argb)) throw Fail("VP8L: bitstream error");
        const size_t n = (size_t)w * h;
        for (size_t i = 0; i < n; ++i) {
            const uint32_t p = argb[i];
            out[3 * i] = (uint8_t)(p >> 16);
            out[3 * i + 1] = (uint8_t)(p >> 8);
            out[3 * i + 2] = (uint8_t)p;
        }
        return 0;
    } catch (const Fail& e) {
        copy_msg(e.what(), msg, msg_len);
        return 1;
    } catch (const std::bad_alloc&) {
        copy_msg("out of memory", msg, msg_len);
        return 1;
    }
}

// A VP8 key frame (`data` from its frame tag to the end of the data) into
// RGB `out` [h, w, 3] by fancy upsampling; with `alph` (the ALPH payload, or
// null) its alpha decoded too, into `alpha_out` [h, w] when that is not null
// (a bad alpha stream fails the image).  0 on success, 1 where libwebp fails.
int webp_vp8(const uint8_t* data, int64_t size, const uint8_t* alph, int64_t alph_size,
             int width, int height, uint8_t* out, uint8_t* alpha_out, char* msg, int64_t msg_len) {
    try {
        VP8Frame fr;
        vp8_decode(data, (uint64_t)size, fr);
        if (fr.width != width || fr.height != height) throw Fail("VP8: sides differ from the caller's");
        if (alph != nullptr) {
            std::vector<uint8_t> a((size_t)width * height);
            if (!decode_alpha(alph, (uint64_t)alph_size, width, height, a.data()))
                throw Fail("ALPH: alpha decoder failed");
            if (alpha_out) std::memcpy(alpha_out, a.data(), a.size());
        }
        const int ys = fr.mb_w * 16, uvs = fr.mb_w * 8, ch = (height + 1) / 2;
        for (int y = 0; y < height; ++y) {
            const int nr = y >> 1;
            // the chroma row that weighs 1: the next one below an odd row
            // (the row's own at the bottom), the one above an even row
            int fr_row;
            if (y & 1) fr_row = ((y + 1) >> 1) < ch ? (y + 1) >> 1 : nr;
            else fr_row = nr > 0 ? nr - 1 : 0;
            upsample_row(&fr.y[(size_t)y * ys], &fr.u[(size_t)nr * uvs], &fr.v[(size_t)nr * uvs],
                         &fr.u[(size_t)fr_row * uvs], &fr.v[(size_t)fr_row * uvs], width,
                         out + (size_t)y * width * 3);
        }
        return 0;
    } catch (const Fail& e) {
        copy_msg(e.what(), msg, msg_len);
        return 1;
    } catch (const std::bad_alloc&) {
        copy_msg("out of memory", msg, msg_len);
        return 1;
    }
}

}  // extern "C"
