// AV1 still-picture decoder: one shown key frame at 8 bits, 4:2:0, 4:2:2,
// 4:4:4 or 4:0:0, as libaom 3.14.1 (cv2 5.0's, through libavif 1.4.2)
// decodes it, bit for bit.  Bound by ctypes in av1.py; core/avif.py reads the
// container.
//
// What it decodes: the OBUs (temporal delimiter, sequence header reduced or
// full with one operating point, frame header + tile groups or OBU_FRAME,
// metadata and padding skipped), the uncompressed header of a shown key
// frame (tiles uniform or not, quantiser with delta q and matrices,
// segmentation, delta lf, loop filter, CDEF, loop restoration, tx mode,
// reduced tx set), libaom's entropy decoder with CDF adaptation, the intra
// block syntax (palettes with their colour caches and index maps), intra
// block copy (the displacement vector's reference from the neighbours' or
// the default one, its syntax and libaom's validity rules, the variable
// transform tree and the inter transform sets, the bilinear copy from the
// frame), dequantisation, the inverse transforms (DCT 4-64, ADST 4-16,
// identity, flips, the lossless WHT) with libaom's intermediate clamps, every
// intra predictor, then the deblocking filter, CDEF and loop restoration.
//
// What it refuses (code 2, UnsupportedImage): bit depths above 8, superres,
// film grain (its parameters read and checked, raised once the frame
// decodes), frames other than a shown key frame.  What libaom refuses (code
// 1): among them a displacement vector libaom finds invalid and a block size
// that has no chroma block under the frame's subsampling.
//
// Tables come from av1_tables.h, generated from libaom's binary by
// tests/data/avif/extract_tables.py.
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "av1_tables.h"

namespace {

struct Failure {
    int code;
    std::string msg;
};
[[noreturn]] void fail(const std::string& m) { throw Failure{1, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Failure{2, m}; }

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline int clip1(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }
inline int round2(int64_t x, int n) { return n == 0 ? (int)x : (int)((x + ((int64_t)1 << (n - 1))) >> n); }
inline int floor_log2(uint32_t x) { int s = 0; while (x > 1) { x >>= 1; s++; } return s; }

// ---------------------------------------------------------------- sizes
enum { BLOCK_4X4 = 0, BLOCK_8X8 = 3, BLOCK_64X64 = 12, BLOCK_128X128 = 15, BLOCK_INVALID = 22 };
const uint8_t kBW[22] = {2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 2, 4, 3, 5, 4, 6};
const uint8_t kBH[22] = {2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 6, 5, 6, 7, 6, 7, 4, 2, 5, 3, 6, 4};
int block_of(int wl, int hl) {
    for (int b = 0; b < 22; b++)
        if (kBW[b] == wl && kBH[b] == hl) return b;
    return BLOCK_INVALID;
}
const uint8_t kTW[19] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6};
const uint8_t kTH[19] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4};
int tx_of(int wl, int hl) {
    for (int t = 0; t < 19; t++)
        if (kTW[t] == wl && kTH[t] == hl) return t;
    return -1;
}
inline int tx_sqr(int t) { return std::min(kTW[t], kTH[t]) - 2; }
inline int tx_sqr_up(int t) { return std::max(kTW[t], kTH[t]) - 2; }
int max_tx_rect(int b) { return tx_of(std::min<int>(kBW[b], 6), std::min<int>(kBH[b], 6)); }
int split_tx(int t) {
    int w = kTW[t], h = kTH[t];
    if (w == h) return w == 2 ? t : tx_of(w - 1, h - 1);
    if (std::abs(w - h) == 1) return tx_of(std::min(w, h), std::min(w, h));
    return w > h ? tx_of(w - 1, h) : tx_of(w, h - 1);
}
// libaom's bsize_to_max_depth and bsize_to_tx_size_cat
int max_depth(int b) {
    int t = max_tx_rect(b), d = 0;
    while (d < 2 && t != 0) { d++; t = split_tx(t); }
    return d;
}
int tx_cat(int b) {
    int t = max_tx_rect(b), d = 0;
    while (t != 0) { d++; t = split_tx(t); }
    return d - 1;
}
// libaom's av1_ss_size_lookup: BLOCK_INVALID where a luma size has no
// chroma block under the subsampling
int plane_block(int b, int ssx, int ssy) {
    int v = kSsSizeLookup[b][ssx][ssy];
    return v == 255 ? BLOCK_INVALID : v;
}

// intra modes
enum { DC_PRED = 0, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED,
       D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED };
const uint8_t kIntraModeCtx[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const uint8_t kModeToTxfm[14] = {0, 1, 2, 0, 3, 1, 2, 2, 1, 3, 1, 2, 3, 0};
// tx types
enum { DCT_DCT = 0, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST,
       ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST };
enum { T_DCT = 0, T_ADST, T_FLIPADST, T_IDTX };
const uint8_t kVtx[16] = {0, 1, 0, 1, 2, 0, 2, 1, 2, 3, 0, 3, 1, 3, 2, 3};
const uint8_t kHtx[16] = {0, 0, 1, 1, 0, 2, 2, 2, 1, 3, 3, 0, 3, 1, 3, 2};
enum { CLASS_2D = 0, CLASS_HORIZ = 1, CLASS_VERT = 2 };
int tx_class(int t) {
    if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return CLASS_VERT;
    if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return CLASS_HORIZ;
    return CLASS_2D;
}
// tx set types (libaom): 0 DCT only, 2 DTT4_IDTX, 3 DTT4_IDTX_1DDCT
const int kTxSetSize[6] = {1, 2, 5, 7, 12, 16};

// ---------------------------------------------------------------- readers
struct BitReader {
    const uint8_t* p;
    size_t n;
    size_t pos = 0;  // bits
    BitReader(const uint8_t* d, size_t sz) : p(d), n(sz) {}
    int bit() {
        if ((pos >> 3) >= n) fail("truncated header");
        int b = (p[pos >> 3] >> (7 - (pos & 7))) & 1;
        pos++;
        return b;
    }
    uint32_t f(int k) {
        uint32_t v = 0;
        for (int i = 0; i < k; i++) v = (v << 1) | bit();
        return v;
    }
    int su(int k) {
        int v = (int)f(k);
        int m = 1 << (k - 1);
        return (v & m) ? v - 2 * m : v;
    }
    uint32_t ns(uint32_t nv) {
        int w = floor_log2(nv) + 1;
        uint32_t m = (1u << w) - nv;
        uint32_t v = f(w - 1);
        if (v < m) return v;
        return (v << 1) - m + f(1);
    }
    uint32_t uvlc() {
        int lz = 0;
        while (!bit()) {
            lz++;
            if (lz >= 32) return UINT32_MAX;
        }
        return lz >= 32 ? UINT32_MAX : f(lz) + (1u << lz) - 1;
    }
    // libaom's byte_alignment: the padding bits must be zero
    void byte_align() {
        while (pos & 7)
            if (bit()) fail("byte_alignment() is not all 0 bits");
    }
    // libaom's av1_check_trailing_bits
    void trailing() {
        int k = 8 - (int)(pos % 8);
        if ((int)f(k) != (1 << (k - 1))) fail("bad trailing bits");
    }
};

// libaom's od_ec decoder
struct Ec {
    const uint8_t *buf, *bptr, *end;
    uint32_t dif, rng;
    int32_t cnt, tell_offs;
    bool update = true;
    void init(const uint8_t* b, size_t n) {
        buf = bptr = b;
        end = b + n;
        tell_offs = 10 - (32 - 8);
        dif = (1u << 31) - 1;
        rng = 0x8000;
        cnt = -15;
        refill();
    }
    void refill() {
        int s = 32 - 9 - (cnt + 15);
        for (; s >= 0 && bptr < end; s -= 8, bptr++) {
            dif ^= (uint32_t)bptr[0] << s;
            cnt += 8;
        }
        if (bptr >= end) {
            tell_offs += 0x4000 - cnt;
            cnt = 0x4000;
        }
    }
    int normalize(uint32_t d, uint32_t r, int ret) {
        int sh = 15 - floor_log2(r);
        cnt -= sh;
        dif = ((d + 1) << sh) - 1;
        rng = r << sh;
        if (cnt < 0) refill();
        return ret;
    }
    int decode(const uint16_t* icdf, int nsyms) {
        uint32_t d = dif, r = rng;
        const int N = nsyms - 1;
        uint32_t c = d >> 16, u, v = r;
        int ret = -1;
        do {
            u = v;
            v = ((r >> 8) * (uint32_t)(icdf[++ret] >> 6) >> 1);
            v += 4 * (N - ret);
        } while (c < v);
        r = u - v;
        d -= v << 16;
        return normalize(d, r, ret);
    }
    int read(uint16_t* cdf, int nsyms) {
        int v = decode(cdf, nsyms);
        if (update) {
            static const int speed[17] = {0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2};
            int rate = 3 + (cdf[nsyms] > 15) + (cdf[nsyms] > 31) + speed[nsyms];
            int tmp = 32768;
            for (int i = 0; i < nsyms - 1; i++) {
                tmp = (i == v) ? 0 : tmp;
                if (tmp < cdf[i]) cdf[i] -= (uint16_t)((cdf[i] - tmp) >> rate);
                else cdf[i] += (uint16_t)((tmp - cdf[i]) >> rate);
            }
            cdf[nsyms] += (cdf[nsyms] < 32);
        }
        return v;
    }
    int bool_q15(uint32_t f) {
        uint32_t d = dif, r = rng;
        uint32_t v = ((r >> 8) * (f >> 6) >> 1) + 4;
        uint32_t vw = v << 16;
        int ret = 1;
        uint32_t rn = v;
        if (d >= vw) {
            rn = r - v;
            d -= vw;
            ret = 0;
        }
        return normalize(d, rn, ret);
    }
    int bit() { return bool_q15(16384); }
    int lit(int n) {
        int v = 0;
        for (int i = 0; i < n; i++) v = (v << 1) | bit();
        return v;
    }
    int tell() const { return (int)((bptr - buf) * 8 - cnt + tell_offs); }
    bool overflowed() const { return (int64_t)((tell() + 7) >> 3) > (int64_t)(end - buf); }
    // libaom's check_trailing_bits_after_symbol_coder
    bool trailing_ok() const {
        if (overflowed()) return false;
        uint32_t nb_bits = (uint32_t)tell();
        uint32_t nb_bytes = (nb_bits + 7) >> 3;
        const uint8_t* p = buf + nb_bytes;
        uint8_t last = p[-1];
        uint8_t pattern = (uint8_t)(128 >> ((nb_bits - 1) & 7));
        if ((last & (2 * pattern - 1)) != pattern) return false;
        for (; p < end; p++)
            if (*p) return false;
        return true;
    }
};

// ---------------------------------------------------------------- CDFs
template <size_t N>
void copy_cdf(uint16_t (&dst)[N], const uint16_t* src) { std::memcpy(dst, src, sizeof(dst)); }

struct Cdfs {
    uint16_t txb_skip[5][13][3], eob_extra[5][2][9][3], dc_sign[2][3][3];
    uint16_t eob16[2][2][6], eob32[2][2][7], eob64[2][2][8], eob128[2][2][9], eob256[2][2][10],
        eob512[2][2][11], eob1024[2][2][12];
    uint16_t base_eob[5][2][4][4], base[5][2][42][5], br[5][2][21][5];
    uint16_t skip[3][3], intrabc[3], seg[3][9], filter_intra[22][3], filter_intra_mode[6];
    uint16_t restore_switchable[4], restore_wiener[3], restore_sgr[3];
    uint16_t uv_mode[2][13][15], partition[20][11], kf_y[5][5][14], angle[8][8], tx_size[4][3][4];
    uint16_t delta_q[5], delta_lf_multi[4][5], delta_lf[5], intra_ext_tx[3][4][13][17];
    uint16_t cfl_sign[9], cfl_alpha[6][17], palette_y_mode[7][3][3], palette_uv_mode[2][3];
    uint16_t palette_y_size[7][8], palette_uv_size[7][8], palette_y_color[7][5][9], palette_uv_color[7][5][9];
    // intra block copy: the transform partitions, the inter transform types
    // and the displacement vectors' nmv_context (libaom's ndvc)
    uint16_t txfm_partition[21][3], inter_ext_tx[4][4][17], dv[143];
    void init(int base_q_idx) {
        int q = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1 : base_q_idx <= 120 ? 2 : 3;
        std::memcpy(txb_skip, kTxbSkipCdf[q], sizeof(txb_skip));
        std::memcpy(eob_extra, kEobExtraCdf[q], sizeof(eob_extra));
        std::memcpy(dc_sign, kDcSignCdf[q], sizeof(dc_sign));
        std::memcpy(eob16, kEobMulti16Cdf[q], sizeof(eob16));
        std::memcpy(eob32, kEobMulti32Cdf[q], sizeof(eob32));
        std::memcpy(eob64, kEobMulti64Cdf[q], sizeof(eob64));
        std::memcpy(eob128, kEobMulti128Cdf[q], sizeof(eob128));
        std::memcpy(eob256, kEobMulti256Cdf[q], sizeof(eob256));
        std::memcpy(eob512, kEobMulti512Cdf[q], sizeof(eob512));
        std::memcpy(eob1024, kEobMulti1024Cdf[q], sizeof(eob1024));
        std::memcpy(base_eob, kCoeffBaseEobCdf[q], sizeof(base_eob));
        std::memcpy(base, kCoeffBaseCdf[q], sizeof(base));
        std::memcpy(br, kCoeffBrCdf[q], sizeof(br));
        std::memcpy(skip, kSkipCdf, sizeof(skip));
        std::memcpy(intrabc, kIntrabcCdf, sizeof(intrabc));
        std::memcpy(seg, kSegIdCdf, sizeof(seg));
        std::memcpy(filter_intra, kFilterIntraCdf, sizeof(filter_intra));
        std::memcpy(filter_intra_mode, kFilterIntraModeCdf, sizeof(filter_intra_mode));
        std::memcpy(restore_switchable, kRestoreSwitchableCdf, sizeof(restore_switchable));
        std::memcpy(restore_wiener, kRestoreWienerCdf, sizeof(restore_wiener));
        std::memcpy(restore_sgr, kRestoreSgrprojCdf, sizeof(restore_sgr));
        std::memcpy(uv_mode, kUvModeCdf, sizeof(uv_mode));
        std::memcpy(partition, kPartitionCdf, sizeof(partition));
        std::memcpy(kf_y, kKfYModeCdf, sizeof(kf_y));
        std::memcpy(angle, kAngleDeltaCdf, sizeof(angle));
        std::memcpy(tx_size, kTxSizeCdf, sizeof(tx_size));
        std::memcpy(delta_q, kDeltaQCdf, sizeof(delta_q));
        std::memcpy(delta_lf_multi, kDeltaLfMultiCdf, sizeof(delta_lf_multi));
        std::memcpy(delta_lf, kDeltaLfCdf, sizeof(delta_lf));
        std::memcpy(intra_ext_tx, kIntraExtTxCdf, sizeof(intra_ext_tx));
        std::memcpy(cfl_sign, kCflSignCdf, sizeof(cfl_sign));
        std::memcpy(cfl_alpha, kCflAlphaCdf, sizeof(cfl_alpha));
        std::memcpy(palette_y_mode, kPaletteYModeCdf, sizeof(palette_y_mode));
        std::memcpy(palette_uv_mode, kPaletteUvModeCdf, sizeof(palette_uv_mode));
        std::memcpy(palette_y_size, kPaletteYSizeCdf, sizeof(palette_y_size));
        std::memcpy(palette_uv_size, kPaletteUvSizeCdf, sizeof(palette_uv_size));
        std::memcpy(palette_y_color, kPaletteYColorCdf, sizeof(palette_y_color));
        std::memcpy(palette_uv_color, kPaletteUvColorCdf, sizeof(palette_uv_color));
        std::memcpy(txfm_partition, kTxfmPartitionCdf, sizeof(txfm_partition));
        std::memcpy(inter_ext_tx, kInterExtTxCdf, sizeof(inter_ext_tx));
        std::memcpy(dv, kNmvContext, sizeof(dv));
    }
};

// ---------------------------------------------------------------- transforms
int cos128(int angle) {
    int a = angle & 255;
    if (a <= 64) return a == 64 ? 0 : kCospi[2][a];
    if (a <= 128) return -(128 - a == 64 ? 0 : kCospi[2][128 - a]);
    if (a <= 192) return -(a - 128 == 64 ? 0 : kCospi[2][a - 128]);
    return 256 - a == 64 ? 0 : kCospi[2][256 - a];
}
inline int sin128(int angle) { return cos128(angle - 64); }
inline int clamp16(int64_t v) { return (int)(v < -32768 ? -32768 : v > 32767 ? 32767 : v); }
inline int brev(int n, int x) {
    int r = 0;
    for (int i = 0; i < n; i++) r |= ((x >> i) & 1) << (n - 1 - i);
    return r;
}

struct Tx1d {
    int32_t T[64];
    void B(int a, int b, int angle, int flip) {
        int64_t x = (int64_t)T[a] * cos128(angle) - (int64_t)T[b] * sin128(angle);
        int64_t y = (int64_t)T[a] * sin128(angle) + (int64_t)T[b] * cos128(angle);
        T[a] = round2(x, 12);
        T[b] = round2(y, 12);
        if (flip) std::swap(T[a], T[b]);
    }
    void H(int a, int b, int flip) {
        if (flip) std::swap(a, b);
        int x = T[a], y = T[b];
        T[a] = clamp16((int64_t)x + y);
        T[b] = clamp16((int64_t)x - y);
    }
    // libaom's inverse DCT: the even half is the DCT of half the size, the
    // odd half a chain of rotations and add/sub levels, then one add/sub
    // level joins them (T already in bit-reversed order)
    static int hb(int w0, int64_t x, int w1, int64_t y) { return round2(w0 * x + w1 * y, 12); }
    void dct_core(int lo, int N) {
        const int32_t* cp = kCospi[2];
        auto C = [&](int t) { return t == 64 ? 0 : cp[t]; };
        if (N == 2) {
            int64_t x = T[lo], y = T[lo + 1];
            T[lo] = hb(C(32), x, C(32), y);
            T[lo + 1] = hb(C(32), x, -C(32), y);
            return;
        }
        int M = N / 2, n = floor_log2(N);
        dct_core(lo, M);
        int o = lo + M;
        for (int i = 0; i < M / 2; i++) {
            int a = M + i, b = N - 1 - i;
            int th = 64 - (64 / N) * brev(n, a);
            int64_t x = T[lo + a], y = T[lo + b];
            T[lo + a] = hb(C(th), x, -C(64 - th), y);
            T[lo + b] = hb(C(64 - th), x, C(th), y);
        }
        int levels = floor_log2(M) - 1;
        for (int L = 1; L <= levels; L++) {
            int g = 1 << L;
            for (int k = 0; k < M / g; k++) {
                int base = o + k * g;
                for (int j = 0; j < g / 2; j++) {
                    int a = base + j, b = base + g - 1 - j;
                    int64_t x = T[a], y = T[b];
                    if (k % 2 == 0) {
                        T[a] = clamp16(x + y);
                        T[b] = clamp16(x - y);
                    } else {
                        T[a] = clamp16(-x + y);
                        T[b] = clamp16(x + y);
                    }
                }
            }
            if (L == levels) {
                for (int off = M / 4; off < M / 2; off++) {
                    int a = o + off, b = o + M - 1 - off;
                    int64_t x = T[a], y = T[b];
                    T[a] = hb(-C(32), x, C(32), y);
                    T[b] = hb(C(32), x, C(32), y);
                }
            } else {
                int np = N >> (L + 1), nn = floor_log2(np);
                for (int k = 0; k < (M / 2) / (2 * g); k++) {
                    int th = (64 / np) * brev(nn, np / 2 + k);
                    int base = o + k * 2 * g;
                    for (int off = g / 2; off < 3 * g / 2; off++) {
                        int a = base + off, b = lo + 3 * M - 1 - (a - lo);
                        int64_t x = T[a], y = T[b];
                        if (off < g) {
                            T[a] = hb(-C(th), x, C(64 - th), y);
                            T[b] = hb(C(64 - th), x, C(th), y);
                        } else {
                            T[a] = hb(-C(64 - th), x, -C(th), y);
                            T[b] = hb(-C(th), x, C(64 - th), y);
                        }
                    }
                }
            }
        }
        for (int k = 0; k < M; k++) {
            int64_t x = T[lo + k], y = T[lo + N - 1 - k];
            T[lo + k] = clamp16(x + y);
            T[lo + N - 1 - k] = clamp16(x - y);
        }
    }
    void dct(int n) {
        int32_t c[64];
        int n0 = 1 << n;
        std::memcpy(c, T, sizeof(int32_t) * n0);
        for (int i = 0; i < n0; i++) T[i] = c[brev(n, i)];
        dct_core(0, n0);
    }
    void adst4() {
        const int32_t* s = kSinpi[2];
        int64_t x0 = T[0], x1 = T[1], x2 = T[2], x3 = T[3];
        if (!(x0 | x1 | x2 | x3)) return;
        int64_t s0 = s[1] * x0, s1 = s[2] * x0, s2 = s[3] * x1, s3 = s[4] * x2;
        int64_t s4 = s[1] * x2, s5 = s[2] * x3, s6 = s[4] * x3;
        int64_t s7 = (x0 - x2) + x3;
        s0 = s0 + s3;
        s1 = s1 - s4;
        s3 = s2;
        s2 = s[3] * s7;
        s0 = s0 + s5;
        s1 = s1 - s6;
        int64_t y0 = s0 + s3, y1 = s1 + s3, y2 = s2, y3 = s0 + s1;
        y3 = y3 - s3;
        T[0] = (int32_t)round2(y0, 12);
        T[1] = (int32_t)round2(y1, 12);
        T[2] = (int32_t)round2(y2, 12);
        T[3] = (int32_t)round2(y3, 12);
    }
    void adst_in(int n) {
        int32_t c[16];
        int n0 = 1 << n;
        std::memcpy(c, T, sizeof(int32_t) * n0);
        for (int i = 0; i < n0; i++) T[i] = c[(i & 1) ? (i - 1) : (n0 - i - 1)];
    }
    void adst_out(int n) {
        int32_t c[16];
        int n0 = 1 << n;
        std::memcpy(c, T, sizeof(int32_t) * n0);
        for (int i = 0; i < n0; i++) {
            int a = (i >> 3) & 1, b = ((i >> 2) & 1) ^ ((i >> 3) & 1), cc = ((i >> 1) & 1) ^ ((i >> 2) & 1),
                d = (i & 1) ^ ((i >> 1) & 1);
            int idx = ((d << 3) | (cc << 2) | (b << 1) | a) >> (4 - n);
            T[i] = (i & 1) ? -c[idx] : c[idx];
        }
    }
    void adst8() {
        adst_in(3);
        for (int i = 0; i < 4; i++) B(2 * i, 2 * i + 1, 60 - 16 * i, 1);
        for (int i = 0; i < 4; i++) H(i, 4 + i, 0);
        for (int i = 0; i < 2; i++) B(4 + 3 * i, 5 + i, 48 - 32 * i, 1);
        for (int i = 0; i < 2; i++)
            for (int j = 0; j < 2; j++) H(4 * j + i, 2 + 4 * j + i, 0);
        for (int i = 0; i < 2; i++) B(2 + 4 * i, 3 + 4 * i, 32, 1);
        adst_out(3);
    }
    void adst16() {
        adst_in(4);
        for (int i = 0; i < 8; i++) B(2 * i, 2 * i + 1, 62 - 8 * i, 1);
        for (int i = 0; i < 8; i++) H(i, 8 + i, 0);
        for (int i = 0; i < 2; i++) {
            B(8 + 2 * i, 9 + 2 * i, 56 - 32 * i, 1);
            B(13 + 2 * i, 12 + 2 * i, 8 + 32 * i, 1);
        }
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 2; j++) H(8 * j + i, 4 + 8 * j + i, 0);
        for (int i = 0; i < 2; i++)
            for (int j = 0; j < 2; j++) B(4 + 8 * j + 3 * i, 5 + 8 * j + i, 48 - 32 * i, 1);
        for (int i = 0; i < 2; i++)
            for (int j = 0; j < 4; j++) H(4 * j + i, 2 + 4 * j + i, 0);
        for (int i = 0; i < 4; i++) B(2 + 4 * i, 3 + 4 * i, 32, 1);
        adst_out(4);
    }
    void identity(int n) {
        int n0 = 1 << n;
        for (int i = 0; i < n0; i++) {
            if (n == 2) T[i] = round2((int64_t)T[i] * 5793, 12);
            else if (n == 3) T[i] = T[i] * 2;
            else if (n == 4) T[i] = round2((int64_t)T[i] * 11586, 12);
            else T[i] = T[i] * 4;
        }
    }
    void run(int type, int n) {
        if (type == T_IDTX) identity(n);
        else if (type == T_DCT) dct(n);
        else if (n == 2) adst4();
        else if (n == 3) adst8();
        else adst16();
    }
};

// row shifts of libaom's inverse transforms
int row_shift(int t) {
    static const int8_t s[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};
    return s[t];
}

// Adds the inverse transform of coef (row-major, tw x th nonzero region of a
// w x h block) to dst.
void inverse_transform_add(const int32_t* coef, int t, int type, bool lossless, uint8_t* dst, int stride) {
    if (lossless) {
        int32_t tmp[16];
        for (int i = 0; i < 4; i++) {
            int a = coef[i * 4 + 0] >> 2, c = coef[i * 4 + 1] >> 2, d = coef[i * 4 + 2] >> 2, b = coef[i * 4 + 3] >> 2;
            a += c; d -= b;
            int e = (a - d) >> 1;
            b = e - b; c = e - c; a -= b; d += c;
            tmp[i * 4 + 0] = a; tmp[i * 4 + 1] = b; tmp[i * 4 + 2] = c; tmp[i * 4 + 3] = d;
        }
        for (int j = 0; j < 4; j++) {
            int a = tmp[0 * 4 + j], c = tmp[1 * 4 + j], d = tmp[2 * 4 + j], b = tmp[3 * 4 + j];
            a += c; d -= b;
            int e = (a - d) >> 1;
            b = e - b; c = e - c; a -= b; d += c;
            dst[0 * stride + j] = (uint8_t)clip1(dst[0 * stride + j] + a);
            dst[1 * stride + j] = (uint8_t)clip1(dst[1 * stride + j] + b);
            dst[2 * stride + j] = (uint8_t)clip1(dst[2 * stride + j] + c);
            dst[3 * stride + j] = (uint8_t)clip1(dst[3 * stride + j] + d);
        }
        return;
    }
    const int wl = kTW[t], hl = kTH[t], w = 1 << wl, h = 1 << hl;
    const int tw = std::min(32, w), th = std::min(32, h);
    const int vt = kVtx[type], ht = kHtx[type];
    const bool ud = vt == T_FLIPADST, lr = ht == T_FLIPADST;
    const int hn = ht == T_FLIPADST ? T_ADST : ht, vn = vt == T_FLIPADST ? T_ADST : vt;
    const bool rect = std::abs(wl - hl) == 1;
    const int rs = row_shift(t);
    static thread_local std::vector<int32_t> buf;
    buf.assign((size_t)w * h, 0);
    Tx1d x;
    for (int r = 0; r < h; r++) {
        if (r >= th) break;  // zero rows stay zero through the row transform
        for (int c = 0; c < w; c++) {
            int64_t v = c < tw ? coef[r * tw + c] : 0;
            if (rect) v = round2(v * 2896, 12);
            x.T[c] = clip3(-32768, 32767, (int)std::max<int64_t>(INT32_MIN, std::min<int64_t>(INT32_MAX, v)));
        }
        x.run(hn, wl);
        for (int c = 0; c < w; c++) buf[r * w + c] = round2(x.T[c], rs);
    }
    for (int c = 0; c < w; c++) {
        int cc = lr ? w - 1 - c : c;
        for (int r = 0; r < h; r++) x.T[r] = clamp16(buf[r * w + cc]);
        x.run(vn, hl);
        for (int r = 0; r < h; r++) {
            int v = round2(x.T[ud ? h - 1 - r : r], 4);
            uint8_t* p = dst + r * stride + c;
            *p = (uint8_t)clip1(*p + v);
        }
    }
}

// ---------------------------------------------------------------- headers
struct SeqHeader {
    int profile = 0, still = 0, reduced = 0;
    int timing_info = 0, decoder_model_info = 0, equal_picture_interval = 0;
    int buffer_removal_time_length = 0, frame_presentation_time_length = 0;
    int op_count = 1, op_idc[32] = {0}, decoder_model_present_op[32] = {0};
    int frame_width_bits = 0, frame_height_bits = 0, max_w = 0, max_h = 0;
    int frame_id_numbers = 0, delta_frame_id_length = 0, additional_frame_id_length = 0;
    int sb128 = 0, enable_filter_intra = 0, enable_intra_edge = 0;
    int enable_order_hint = 0, order_hint_bits = 0;
    int force_screen_content = 2, force_integer_mv = 2;
    int enable_superres = 0, enable_cdef = 0, enable_restoration = 0;
    int bitdepth = 8, mono = 0, cp = 2, tc = 2, mc = 2, color_range = 0, ssx = 1, ssy = 1;
    int separate_uv_delta_q = 0, film_grain = 0;
    bool seen = false;
};

// libaom's is_valid_seq_level_idx: levels 2.2, 2.3, 3.2, 3.3, 4.2, 4.3 and
// 7.0 up are undefined (31 is the maximum level)
void check_level(int level) {
    static const bool valid[32] = {1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 1,
                                   1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1};
    if (!valid[level]) fail("seq_level_idx " + std::to_string(level) + " is not defined");
}

void read_sequence_header(BitReader& rb, SeqHeader& s) {
    s.profile = rb.f(3);
    if (s.profile > 2) fail("unsupported profile");
    s.still = rb.f(1);
    s.reduced = rb.f(1);
    if (s.reduced && !s.still) fail("reduced header without still picture");
    if (s.reduced) {
        check_level(rb.f(5));
    } else {
        s.timing_info = rb.f(1);
        if (s.timing_info) {
            rb.f(32);
            rb.f(32);
            s.equal_picture_interval = rb.f(1);
            if (s.equal_picture_interval) {
                uint32_t v = rb.uvlc();
                if (v == UINT32_MAX) fail("bad num_ticks_per_picture");
            }
            s.decoder_model_info = rb.f(1);
            if (s.decoder_model_info) {
                int bdl = rb.f(5) + 1;
                rb.f(32);
                s.buffer_removal_time_length = rb.f(5) + 1;
                s.frame_presentation_time_length = rb.f(5) + 1;
                s.buffer_removal_time_length |= bdl << 8;
            }
        }
        int initial_display_delay = rb.f(1);
        s.op_count = rb.f(5) + 1;
        for (int i = 0; i < s.op_count; i++) {
            s.op_idc[i] = rb.f(12);
            int lvl = rb.f(5);
            check_level(lvl);
            if (lvl > 7) rb.f(1);
            if (s.decoder_model_info) {
                s.decoder_model_present_op[i] = rb.f(1);
                if (s.decoder_model_present_op[i]) {
                    int n = (s.buffer_removal_time_length >> 8);
                    rb.f(n);
                    rb.f(n);
                    rb.f(1);
                }
            }
            if (initial_display_delay)
                if (rb.f(1)) rb.f(4);
        }
        s.buffer_removal_time_length &= 0xff;
    }
    s.frame_width_bits = rb.f(4) + 1;
    s.frame_height_bits = rb.f(4) + 1;
    s.max_w = rb.f(s.frame_width_bits) + 1;
    s.max_h = rb.f(s.frame_height_bits) + 1;
    if (!s.reduced) s.frame_id_numbers = rb.f(1);
    if (s.frame_id_numbers) {
        s.delta_frame_id_length = rb.f(4) + 2;
        s.additional_frame_id_length = rb.f(3) + 1;
    }
    s.sb128 = rb.f(1);
    s.enable_filter_intra = rb.f(1);
    s.enable_intra_edge = rb.f(1);
    if (!s.reduced) {
        rb.f(1);  // interintra
        rb.f(1);  // masked compound
        rb.f(1);  // warped motion
        rb.f(1);  // dual filter
        s.enable_order_hint = rb.f(1);
        if (s.enable_order_hint) {
            rb.f(1);
            rb.f(1);
        }
        if (rb.f(1)) s.force_screen_content = 2;
        else s.force_screen_content = rb.f(1);
        if (s.force_screen_content > 0) {
            if (rb.f(1)) s.force_integer_mv = 2;
            else s.force_integer_mv = rb.f(1);
        } else {
            s.force_integer_mv = 2;
        }
        if (s.enable_order_hint) s.order_hint_bits = rb.f(3) + 1;
    }
    s.enable_superres = rb.f(1);
    s.enable_cdef = rb.f(1);
    s.enable_restoration = rb.f(1);
    // color_config
    int high = rb.f(1);
    if (s.profile == 2 && high) s.bitdepth = rb.f(1) ? 12 : 10;
    else s.bitdepth = high ? 10 : 8;
    s.mono = s.profile == 1 ? 0 : rb.f(1);
    if (rb.f(1)) {
        s.cp = rb.f(8);
        s.tc = rb.f(8);
        s.mc = rb.f(8);
    } else {
        s.cp = s.tc = s.mc = 2;
    }
    if (s.mono) {
        s.color_range = rb.f(1);
        s.ssx = s.ssy = 1;
        s.separate_uv_delta_q = 0;
    } else {
        if (s.cp == 1 && s.tc == 13 && s.mc == 0) {
            s.color_range = 1;
            s.ssx = s.ssy = 0;
        } else {
            s.color_range = rb.f(1);
            if (s.profile == 0) {
                s.ssx = s.ssy = 1;
            } else if (s.profile == 1) {
                s.ssx = s.ssy = 0;
            } else {
                if (s.bitdepth == 12) {
                    s.ssx = rb.f(1);
                    s.ssy = s.ssx ? rb.f(1) : 0;
                } else {
                    s.ssx = 1;
                    s.ssy = 0;
                }
            }
            if (s.ssx && s.ssy) rb.f(2);
        }
        s.separate_uv_delta_q = rb.f(1);
    }
    if (s.mc == 0 && (s.ssx || s.ssy) && !s.mono) fail("identity matrix with subsampling");
    s.film_grain = rb.f(1);
    rb.trailing();
}

const int kSegBits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
const int kSegSigned[8] = {1, 1, 1, 1, 1, 0, 0, 0};
const int kSegMax[8] = {255, 63, 63, 63, 63, 7, 0, 0};

struct FrameHeader {
    int w = 0, h = 0, mi_cols = 0, mi_rows = 0;
    int disable_cdf_update = 0, allow_screen_content = 0, allow_intrabc = 0;
    int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0, tile_size_bytes = 4;
    int mi_col_starts[65], mi_row_starts[65];
    int base_q_idx = 0, dq_y_dc = 0, dq_u_dc = 0, dq_u_ac = 0, dq_v_dc = 0, dq_v_ac = 0;
    int using_qmatrix = 0, qm_y = 15, qm_u = 15, qm_v = 15;
    int seg_enabled = 0, feature_enabled[8][8], feature_data[8][8], seg_id_pre_skip = 0, last_active_seg = 0;
    int delta_q_present = 0, delta_q_res = 0, delta_lf_present = 0, delta_lf_res = 0, delta_lf_multi = 0;
    int lossless_array[8], coded_lossless = 0, all_lossless = 0;
    int lf_level[4] = {0, 0, 0, 0}, lf_sharpness = 0, lf_delta_enabled = 0;
    int lf_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1}, lf_mode_deltas[2] = {0, 0};
    int cdef_damping = 3, cdef_bits = 0, cdef_y_pri[8], cdef_y_sec[8], cdef_uv_pri[8], cdef_uv_sec[8];
    int lr_type[3] = {0, 0, 0}, lr_size[3] = {256, 256, 256}, uses_lr = 0;
    int tx_mode_select = 0, reduced_tx_set = 0, apply_grain = 0;
};

int tile_log2(int blk, int target) {
    int k = 0;
    while ((blk << k) < target) k++;
    return k;
}

int read_delta_q(BitReader& rb) { return rb.f(1) ? rb.su(7) : 0; }

// ---------------------------------------------------------------- decoder
struct MiInfo {
    uint8_t size, ymode, uvmode, skip, seg, use_filter_intra;
    int8_t dlf[4];
    uint8_t intrabc;      // an intra-block-copy block (libaom's is_inter_block)
    int16_t dv_row, dv_col;  // its displacement vector, 1/8 pel
};

// Counters a test reads after a decode (av1_test_counters): which of the
// decoder's paths the frame reached.
enum {
    C_IBC_444, C_IBC_420, C_IBC_422, C_IBC_400, C_HALF_PEL_420, C_HALF_PEL_422, C_DV_REF_NEIGHBOUR,
    C_DV_REF_DEFAULT, C_VARTX_DEPTH1, C_VARTX_DEPTH2, C_TX_SET_DCT_IDTX, C_TX_SET_DTT9, C_TX_SET_ALL16,
    C_CDEF_422_REMAPPED, C_LR_422_CHROMA, C_BLOCKS_422, C_COUNT
};
thread_local int64_t g_counters[C_COUNT];

struct Palette {
    uint8_t n[2];
    uint16_t c[3][8];
};

struct Frame {
    int w, h, stride[3], pw[3], ph[3];
    std::vector<uint8_t> p[3];
};

struct Decoder {
    SeqHeader seq;
    FrameHeader fh;
    Cdfs init_cdf, cdf;
    Ec ec;
    int num_planes = 3, ssx = 1, ssy = 1;
    // mi grid
    int mi_stride = 0, mi_alloc_rows = 0;
    std::vector<MiInfo> mi;
    std::vector<uint8_t> tx_types;
    std::vector<Palette> palettes;
    std::vector<uint8_t> lf_tx[3];
    int lf_stride[3];
    std::vector<int8_t> cdef_idx;  // per 64x64
    int cdef_stride = 0;
    Frame cur;
    // contexts
    std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
    // libaom's transform-size contexts (above_txfm_context, left_txfm_context):
    // the width (height) in pixels of the transform above (left of) each 4x4
    std::vector<uint8_t> above_txfm, left_txfm;
    // tile
    int mi_row_start, mi_row_end, mi_col_start, mi_col_end;
    int current_q = 0, delta_lf[4];
    uint8_t block_decoded[3][35][35];
    // block state
    int mi_row, mi_col, mi_size, has_chroma, avail_u, avail_l, avail_u_chroma, avail_l_chroma;
    int skip, segment_id, lossless, ymode, uvmode, angle_y, angle_uv, use_filter_intra, filter_intra_mode;
    int cfl_u, cfl_v, tx_size, read_deltas;
    // intra block copy: the block's flag, displacement vector (1/8 pel), the
    // partition that made it (has_top_right reads it) and the transform size
    // of each 4x4 (libaom's inter_tx_size)
    int use_intrabc, dv_row, dv_col, partition;
    uint8_t inter_tx[32][32];
    Palette pal;
    uint8_t color_map[2][64 * 64];
    int color_map_w[2];
    int max_luma_w, max_luma_h;
    // loop restoration
    struct LrUnit { uint8_t type, set; int8_t wiener[2][3]; int16_t xqd[2]; };
    std::vector<LrUnit> lr_units[3];
    int lr_unit_rows[3], lr_unit_cols[3];
    int ref_sgr_xqd[3][2], ref_wiener[3][2][3];
    // dequant scratch
    int32_t quant[1024];
    int32_t dequant[1024];
    int plane_tx_type;

    MiInfo& at(int r, int c) { return mi[(size_t)r * mi_stride + c]; }
    bool inside(int r, int c) const {
        return c >= mi_col_start && c < mi_col_end && r >= mi_row_start && r < mi_row_end;
    }

    // ------------------------------------------------------------ frame header
    void read_frame_header(BitReader& rb) {
        FrameHeader& f = fh;
        if (seq.frame_id_numbers) unsupported("frame id numbers");
        // a shown key frame: error resilient, every reference refreshed
        if (!seq.reduced) {
            if (rb.f(1)) unsupported("show_existing_frame");
            int frame_type = rb.f(2), show_frame = rb.f(1);
            if (frame_type != 0 || !show_frame) unsupported("a frame other than a shown key frame");
            if (seq.decoder_model_info && !seq.equal_picture_interval)
                rb.f(seq.frame_presentation_time_length);
        }
        f.disable_cdf_update = rb.f(1);
        if (seq.force_screen_content == 2) f.allow_screen_content = rb.f(1);
        else f.allow_screen_content = seq.force_screen_content;
        if (f.allow_screen_content && seq.force_integer_mv == 2) rb.f(1);
        int frame_size_override = seq.reduced ? 0 : rb.f(1);
        if (seq.order_hint_bits) rb.f(seq.order_hint_bits);
        if (seq.decoder_model_info && rb.f(1)) {  // buffer_removal_time_present_flag
            for (int op = 0; op < seq.op_count; op++) {
                if (!seq.decoder_model_present_op[op]) continue;
                int idc = seq.op_idc[op];
                if (idc == 0 || (((idc >> obu_tid) & 1) && ((idc >> (obu_sid + 8)) & 1)))
                    rb.f(seq.buffer_removal_time_length);
            }
        }
        // refresh_frame_flags = all for a shown key frame
        if (frame_size_override) {
            f.w = rb.f(seq.frame_width_bits) + 1;
            f.h = rb.f(seq.frame_height_bits) + 1;
        } else {
            f.w = seq.max_w;
            f.h = seq.max_h;
        }
        if (f.w > seq.max_w || f.h > seq.max_h) fail("frame larger than the sequence's maximum");
        if (seq.enable_superres && rb.f(1)) unsupported("superres");
        f.mi_cols = 2 * ((f.w + 7) >> 3);
        f.mi_rows = 2 * ((f.h + 7) >> 3);
        if (rb.f(1)) {  // render_and_frame_size_different
            rb.f(16);
            rb.f(16);
        }
        if (f.allow_screen_content) f.allow_intrabc = rb.f(1);
        // disable_frame_end_update_cdf
        if (!seq.reduced && !f.disable_cdf_update) rb.f(1);
        // tile_info
        int sb_cols = seq.sb128 ? (f.mi_cols + 31) >> 5 : (f.mi_cols + 15) >> 4;
        int sb_rows = seq.sb128 ? (f.mi_rows + 31) >> 5 : (f.mi_rows + 15) >> 4;
        int sb_shift = seq.sb128 ? 5 : 4;
        int sb_size = sb_shift + 2;
        int max_tile_width_sb = 4096 >> sb_size;
        int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
        int min_log2_tile_cols = tile_log2(max_tile_width_sb, sb_cols);
        int max_log2_tile_cols = tile_log2(1, std::min(sb_cols, 64));
        int max_log2_tile_rows = tile_log2(1, std::min(sb_rows, 64));
        int min_log2_tiles = std::max(min_log2_tile_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
        if (rb.f(1)) {
            f.tile_cols_log2 = min_log2_tile_cols;
            while (f.tile_cols_log2 < max_log2_tile_cols) {
                if (rb.f(1)) f.tile_cols_log2++;
                else break;
            }
            int tw = (sb_cols + (1 << f.tile_cols_log2) - 1) >> f.tile_cols_log2;
            int i = 0;
            for (int st = 0; st < sb_cols; st += tw) f.mi_col_starts[i++] = st << sb_shift;
            f.mi_col_starts[i] = f.mi_cols;
            f.tile_cols = i;
            int min_log2_tile_rows = std::max(min_log2_tiles - f.tile_cols_log2, 0);
            f.tile_rows_log2 = min_log2_tile_rows;
            while (f.tile_rows_log2 < max_log2_tile_rows) {
                if (rb.f(1)) f.tile_rows_log2++;
                else break;
            }
            int th = (sb_rows + (1 << f.tile_rows_log2) - 1) >> f.tile_rows_log2;
            i = 0;
            for (int st = 0; st < sb_rows; st += th) f.mi_row_starts[i++] = st << sb_shift;
            f.mi_row_starts[i] = f.mi_rows;
            f.tile_rows = i;
        } else {
            int widest = 0, st = 0, i = 0;
            for (; st < sb_cols; i++) {
                if (i >= 64) fail("too many tile columns");
                f.mi_col_starts[i] = st << sb_shift;
                int mx = std::min(sb_cols - st, max_tile_width_sb);
                int sz = (int)rb.ns(mx) + 1;
                widest = std::max(sz, widest);
                st += sz;
            }
            f.mi_col_starts[i] = f.mi_cols;
            f.tile_cols = i;
            f.tile_cols_log2 = tile_log2(1, f.tile_cols);
            int area = min_log2_tiles > 0 ? (sb_rows * sb_cols) >> (min_log2_tiles + 1) : sb_rows * sb_cols;
            int max_th = std::max(area / widest, 1);
            st = 0;
            i = 0;
            for (; st < sb_rows; i++) {
                if (i >= 64) fail("too many tile rows");
                f.mi_row_starts[i] = st << sb_shift;
                int mx = std::min(sb_rows - st, max_th);
                int sz = (int)rb.ns(mx) + 1;
                st += sz;
            }
            f.mi_row_starts[i] = f.mi_rows;
            f.tile_rows = i;
            f.tile_rows_log2 = tile_log2(1, f.tile_rows);
        }
        if (f.tile_cols_log2 > 0 || f.tile_rows_log2 > 0) {
            int id = rb.f(f.tile_rows_log2 + f.tile_cols_log2);
            if (id >= f.tile_cols * f.tile_rows) fail("bad context_update_tile_id");
            f.tile_size_bytes = rb.f(2) + 1;
        }
        // quantization_params
        f.base_q_idx = rb.f(8);
        f.dq_y_dc = read_delta_q(rb);
        if (num_planes > 1) {
            int diff = seq.separate_uv_delta_q ? rb.f(1) : 0;
            f.dq_u_dc = read_delta_q(rb);
            f.dq_u_ac = read_delta_q(rb);
            if (diff) {
                f.dq_v_dc = read_delta_q(rb);
                f.dq_v_ac = read_delta_q(rb);
            } else {
                f.dq_v_dc = f.dq_u_dc;
                f.dq_v_ac = f.dq_u_ac;
            }
        }
        f.using_qmatrix = rb.f(1);
        if (f.using_qmatrix) {
            f.qm_y = rb.f(4);
            f.qm_u = rb.f(4);
            f.qm_v = seq.separate_uv_delta_q ? rb.f(4) : f.qm_u;
        }
        // segmentation_params
        std::memset(f.feature_enabled, 0, sizeof(f.feature_enabled));
        std::memset(f.feature_data, 0, sizeof(f.feature_data));
        f.seg_enabled = rb.f(1);
        if (f.seg_enabled) {
            for (int i = 0; i < 8; i++)
                for (int j = 0; j < 8; j++) {
                    int en = rb.f(1);
                    f.feature_enabled[i][j] = en;
                    int v = 0;
                    if (en) {
                        if (kSegSigned[j]) v = clip3(-kSegMax[j], kSegMax[j], rb.su(1 + kSegBits[j]));
                        else v = clip3(0, kSegMax[j], (int)rb.f(kSegBits[j]));
                    }
                    f.feature_data[i][j] = v;
                }
        }
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++)
                if (f.feature_enabled[i][j]) {
                    f.last_active_seg = i;
                    if (j >= 5) f.seg_id_pre_skip = 1;
                }
        // delta_q / delta_lf
        if (f.base_q_idx > 0) f.delta_q_present = rb.f(1);
        if (f.delta_q_present) f.delta_q_res = rb.f(2);
        if (f.delta_q_present && !f.allow_intrabc) {
            f.delta_lf_present = rb.f(1);
            if (f.delta_lf_present) {
                f.delta_lf_res = rb.f(2);
                f.delta_lf_multi = rb.f(1);
            }
        }
        f.coded_lossless = 1;
        for (int s = 0; s < 8; s++) {
            int q = seg_qindex(s, f.base_q_idx);
            f.lossless_array[s] = q == 0 && f.dq_y_dc == 0 && f.dq_u_ac == 0 && f.dq_u_dc == 0 && f.dq_v_ac == 0 &&
                                  f.dq_v_dc == 0;
            if (!f.lossless_array[s]) f.coded_lossless = 0;
        }
        f.all_lossless = f.coded_lossless;
        // loop_filter_params
        if (!f.coded_lossless && !f.allow_intrabc) {
            f.lf_level[0] = rb.f(6);
            f.lf_level[1] = rb.f(6);
            if (num_planes > 1 && (f.lf_level[0] || f.lf_level[1])) {
                f.lf_level[2] = rb.f(6);
                f.lf_level[3] = rb.f(6);
            }
            f.lf_sharpness = rb.f(3);
            f.lf_delta_enabled = rb.f(1);
            if (f.lf_delta_enabled) {
                if (rb.f(1)) {
                    for (int i = 0; i < 8; i++)
                        if (rb.f(1)) f.lf_ref_deltas[i] = rb.su(7);
                    for (int i = 0; i < 2; i++)
                        if (rb.f(1)) f.lf_mode_deltas[i] = rb.su(7);
                }
            }
        }
        // cdef_params
        f.cdef_y_pri[0] = f.cdef_y_sec[0] = f.cdef_uv_pri[0] = f.cdef_uv_sec[0] = 0;
        if (!f.coded_lossless && !f.allow_intrabc && seq.enable_cdef) {
            f.cdef_damping = rb.f(2) + 3;
            f.cdef_bits = rb.f(2);
            for (int i = 0; i < (1 << f.cdef_bits); i++) {
                f.cdef_y_pri[i] = rb.f(4);
                f.cdef_y_sec[i] = rb.f(2);
                if (f.cdef_y_sec[i] == 3) f.cdef_y_sec[i]++;
                if (num_planes > 1) {
                    f.cdef_uv_pri[i] = rb.f(4);
                    f.cdef_uv_sec[i] = rb.f(2);
                    if (f.cdef_uv_sec[i] == 3) f.cdef_uv_sec[i]++;
                }
            }
        }
        // lr_params
        if (!f.all_lossless && !f.allow_intrabc && seq.enable_restoration) {
            static const int remap[4] = {0, 3, 1, 2};  // NONE, SWITCHABLE, WIENER, SGRPROJ
            int chroma = 0;
            for (int i = 0; i < num_planes; i++) {
                f.lr_type[i] = remap[rb.f(2)];
                if (f.lr_type[i]) {
                    f.uses_lr = 1;
                    if (i > 0) chroma = 1;
                }
            }
            if (f.uses_lr) {
                int shift;
                if (seq.sb128) {
                    shift = rb.f(1) + 1;
                } else {
                    shift = rb.f(1);
                    if (shift) shift += rb.f(1);
                }
                f.lr_size[0] = 256 >> (2 - shift);
                int uv_shift = (ssx && ssy && chroma) ? rb.f(1) : 0;
                f.lr_size[1] = f.lr_size[2] = f.lr_size[0] >> uv_shift;
            }
        }
        // tx mode
        if (!f.coded_lossless) f.tx_mode_select = rb.f(1);
        f.reduced_tx_set = rb.f(1);
        if (seq.film_grain && rb.f(1)) film_grain_params(rb);
    }

    // libaom's read_film_grain_params (a key frame's, apply_grain set): the
    // parameters are checked as libaom checks them; the grain itself is
    // left out, so a frame that decodes refuses at its end
    void film_grain_params(BitReader& rb) {
        fh.apply_grain = 1;
        rb.f(16);  // grain_seed
        int ny = rb.f(4);
        if (ny > 14) fail("too many film grain luma points");
        for (int i = 0, prev = -1; i < ny; i++) {
            int v = rb.f(8);
            if (v <= prev) fail("film grain scaling points not increasing");
            prev = v;
            rb.f(8);
        }
        int from_luma = seq.mono ? 0 : rb.f(1);
        int ncb = 0, ncr = 0;
        if (!(seq.mono || from_luma || (seq.ssx && seq.ssy && ny == 0))) {
            for (int c = 0; c < 2; c++) {
                int n = rb.f(4);
                if (n > 10) fail("too many film grain chroma points");
                for (int i = 0, prev = -1; i < n; i++) {
                    int v = rb.f(8);
                    if (v <= prev) fail("film grain scaling points not increasing");
                    prev = v;
                    rb.f(8);
                }
                (c ? ncr : ncb) = n;
            }
            if (seq.ssx && seq.ssy && ((ncb == 0) != (ncr == 0)))
                fail("film grain on one chroma component of 4:2:0");
        }
        rb.f(2);  // grain_scaling_minus_8
        int lag = rb.f(2);
        int pos_luma = 2 * lag * (lag + 1), pos_chroma = pos_luma + (ny ? 1 : 0);
        if (ny) rb.f(8 * pos_luma);
        if (from_luma || ncb) rb.f(8 * pos_chroma);
        if (from_luma || ncr) rb.f(8 * pos_chroma);
        rb.f(2);  // ar_coeff_shift_minus_6
        rb.f(2);  // grain_scale_shift
        if (ncb) rb.f(25);
        if (ncr) rb.f(25);
        rb.f(2);  // overlap_flag, clip_to_restricted_range
    }

    int seg_qindex(int seg, int current) const {
        // get_qindex: with ignoreDeltaQ the frame's base_q_idx, else CurrentQIndex
        if (fh.seg_enabled && fh.feature_enabled[seg][0]) return clip3(0, 255, current + fh.feature_data[seg][0]);
        return current;
    }

    // ------------------------------------------------------------ set up
    void setup() {
        int sb_mi = seq.sb128 ? 32 : 16;
        int sbc = (fh.mi_cols + sb_mi - 1) / sb_mi, sbr = (fh.mi_rows + sb_mi - 1) / sb_mi;
        mi_stride = sbc * sb_mi + 32;
        mi_alloc_rows = sbr * sb_mi + 32;
        mi.assign((size_t)mi_stride * mi_alloc_rows, MiInfo{});
        above_txfm.assign(mi_stride, 64);
        left_txfm.assign(mi_alloc_rows, 64);
        tx_types.assign((size_t)mi_stride * mi_alloc_rows, 0);
        palettes.assign((size_t)mi_stride * mi_alloc_rows, Palette{});
        for (int p = 0; p < num_planes; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            cur.pw[p] = (sbc * sb_mi * 4) >> sx;
            cur.ph[p] = (sbr * sb_mi * 4) >> sy;
            cur.stride[p] = cur.pw[p];
            cur.p[p].assign((size_t)cur.pw[p] * cur.ph[p], 0);
            lf_stride[p] = mi_stride;
            lf_tx[p].assign((size_t)mi_stride * mi_alloc_rows, 0);
            above_level[p].assign(mi_stride, 0);
            above_dc[p].assign(mi_stride, 0);
            left_level[p].assign(mi_alloc_rows, 0);
            left_dc[p].assign(mi_alloc_rows, 0);
        }
        cur.w = fh.w;
        cur.h = fh.h;
        cdef_stride = (fh.mi_cols + 15) / 16 + 2;
        cdef_idx.assign((size_t)cdef_stride * ((fh.mi_rows + 15) / 16 + 2), -1);
        for (int p = 0; p < num_planes; p++) {
            if (!fh.lr_type[p]) continue;
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int us = fh.lr_size[p];
            lr_unit_rows[p] = std::max((round2(fh.h, sy) + (us >> 1)) / us, 1);
            lr_unit_cols[p] = std::max((round2(fh.w, sx) + (us >> 1)) / us, 1);
            lr_units[p].assign((size_t)lr_unit_rows[p] * lr_unit_cols[p], LrUnit{});
        }
    }

    // ------------------------------------------------------------ tiles
    void decode_tile(int tr, int tc, const uint8_t* data, size_t size) {
        mi_row_start = fh.mi_row_starts[tr];
        mi_row_end = fh.mi_row_starts[tr + 1];
        mi_col_start = fh.mi_col_starts[tc];
        mi_col_end = fh.mi_col_starts[tc + 1];
        current_q = fh.base_q_idx;
        cdf = init_cdf;
        ec.init(data, size);
        ec.update = !fh.disable_cdf_update;
        for (int p = 0; p < num_planes; p++) {
            int sx = p ? ssx : 0;
            for (int i = mi_col_start >> sx; i < (mi_col_end >> sx) + 1 && i < mi_stride; i++)
                above_level[p][i] = above_dc[p][i] = 0;
        }
        for (int i = mi_col_start; i < mi_col_end; i++) above_txfm[i] = 64;
        for (int i = 0; i < 4; i++) delta_lf[i] = 0;
        for (int p = 0; p < num_planes; p++) {
            ref_sgr_xqd[p][0] = -32;
            ref_sgr_xqd[p][1] = 31;
            for (int pass = 0; pass < 2; pass++) {
                ref_wiener[p][pass][0] = 3;
                ref_wiener[p][pass][1] = -7;
                ref_wiener[p][pass][2] = 15;
            }
        }
        int sb4 = seq.sb128 ? 32 : 16;
        int sb_size = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
        for (int r = mi_row_start; r < mi_row_end; r += sb4) {
            for (int p = 0; p < num_planes; p++) {
                int sy = p ? ssy : 0;
                for (int i = r >> sy; i < ((r + sb4) >> sy) && i < mi_alloc_rows; i++)
                    left_level[p][i] = left_dc[p][i] = 0;
            }
            for (int i = r; i < r + sb4 && i < mi_alloc_rows; i++) left_txfm[i] = 64;
            for (int c = mi_col_start; c < mi_col_end; c += sb4) {
                read_deltas = fh.delta_q_present;
                clear_cdef(r, c);
                clear_block_decoded(r, c, sb4);
                read_lr(r, c, sb_size);
                decode_partition(r, c, sb_size);
                if (ec.overflowed()) fail("tile data overflow");
            }
        }
        if (!ec.trailing_ok()) fail("bad tile trailing bits");
    }

    void clear_cdef(int r, int c) {
        cdef_at(r, c) = -1;
        if (seq.sb128) {
            cdef_at(r, c + 16) = -1;
            cdef_at(r + 16, c) = -1;
            cdef_at(r + 16, c + 16) = -1;
        }
    }
    int8_t& cdef_at(int r, int c) { return cdef_idx[(size_t)(r >> 4) * cdef_stride + (c >> 4)]; }

    void clear_block_decoded(int r, int c, int sb4) {
        for (int p = 0; p < num_planes; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int sbw4 = (mi_col_end - c) >> sx, sbh4 = (mi_row_end - r) >> sy;
            for (int y = -1; y <= (sb4 >> sy); y++)
                for (int x = -1; x <= (sb4 >> sx); x++) {
                    uint8_t v;
                    if (y < 0 && x < sbw4) v = 1;
                    else if (x < 0 && y < sbh4) v = 1;
                    else v = 0;
                    block_decoded[p][y + 1][x + 1] = v;
                }
            block_decoded[p][(sb4 >> sy) + 1][0] = 0;
        }
    }

    // ------------------------------------------------------------ loop restoration syntax
    int decode_subexp_bool(int num_syms, int k) {
        int i = 0, mk = 0;
        while (true) {
            int b2 = i ? k + i - 1 : k;
            int a = 1 << b2;
            if (num_syms <= mk + 3 * a) {
                // ns via bools
                int n = num_syms - mk;
                int w = floor_log2(n) + 1;
                int m = (1 << w) - n;
                int v = ec.lit(w - 1);
                if (v >= m) v = (v << 1) - m + ec.lit(1);
                return v + mk;
            }
            if (ec.lit(1)) {
                i++;
                mk += a;
            } else {
                return ec.lit(b2) + mk;
            }
        }
    }
    static int inverse_recenter(int r, int v) {
        if (v > 2 * r) return v;
        if (v & 1) return r - ((v + 1) >> 1);
        return r + (v >> 1);
    }
    int decode_signed_subexp_with_ref(int low, int high, int k, int r) {
        int mx = high - low;
        r -= low;
        int v = decode_subexp_bool(mx, k);
        int x = (r << 1) <= mx ? inverse_recenter(r, v) : mx - 1 - inverse_recenter(mx - 1 - r, v);
        return x + low;
    }
    void read_lr(int r, int c, int bsize) {
        if (fh.allow_intrabc) return;
        int w = 1 << (kBW[bsize] - 2), h = 1 << (kBH[bsize] - 2);
        for (int p = 0; p < num_planes; p++) {
            if (!fh.lr_type[p]) continue;
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int us = fh.lr_size[p];
            int ur = lr_unit_rows[p], uc = lr_unit_cols[p];
            int row_start = (r * (4 >> sy) + us - 1) / us;
            int row_end = std::min(ur, ((r + h) * (4 >> sy) + us - 1) / us);
            int col_start = (c * (4 >> sx) + us - 1) / us;
            int col_end = std::min(uc, ((c + w) * (4 >> sx) + us - 1) / us);
            for (int y = row_start; y < row_end; y++)
                for (int x = col_start; x < col_end; x++) read_lr_unit(p, y, x);
        }
    }
    void read_lr_unit(int p, int y, int x) {
        LrUnit& u = lr_units[p][(size_t)y * lr_unit_cols[p] + x];
        int t;
        if (fh.lr_type[p] == 1) t = ec.read(cdf.restore_wiener, 2) ? 1 : 0;
        else if (fh.lr_type[p] == 2) t = ec.read(cdf.restore_sgr, 2) ? 2 : 0;
        else t = ec.read(cdf.restore_switchable, 3);
        u.type = (uint8_t)t;
        static const int wmin[3] = {-5, -23, -17}, wmax[3] = {10, 8, 46}, wk[3] = {1, 2, 3};
        if (t == 1) {
            for (int pass = 0; pass < 2; pass++) {
                int first = 0;
                if (p) {
                    first = 1;
                    u.wiener[pass][0] = 0;
                }
                for (int j = first; j < 3; j++) {
                    int v = decode_signed_subexp_with_ref(wmin[j], wmax[j] + 1, wk[j], ref_wiener[p][pass][j]);
                    u.wiener[pass][j] = (int8_t)v;
                    ref_wiener[p][pass][j] = v;
                }
            }
        } else if (t == 2) {
            int set = ec.lit(4);
            u.set = (uint8_t)set;
            static const int xmin[2] = {-96, -32}, xmax[2] = {31, 95};
            for (int i = 0; i < 2; i++) {
                int radius = kSgrParams[set][i];
                int v;
                if (radius) {
                    v = decode_signed_subexp_with_ref(xmin[i], xmax[i] + 1, 4, ref_sgr_xqd[p][i]);
                } else {
                    v = 0;
                    if (i == 1) v = clip3(xmin[i], xmax[i], 128 - ref_sgr_xqd[p][0]);
                }
                u.xqd[i] = (int16_t)v;
                ref_sgr_xqd[p][i] = v;
            }
        }
    }

    // ------------------------------------------------------------ partition
    void decode_partition(int r, int c, int bsize) {
        if (r >= fh.mi_rows || c >= fh.mi_cols) return;
        int au = inside(r - 1, c), al = inside(r, c - 1);
        int num4 = 1 << (kBW[bsize] - 2);
        int half = num4 >> 1, quarter = half >> 1;
        bool has_rows = (r + half) < fh.mi_rows, has_cols = (c + half) < fh.mi_cols;
        int partition;
        if (bsize < BLOCK_8X8) {
            partition = 0;
        } else {
            int bsl = kBW[bsize] - 3;  // 0 for 8x8 .. 4 for 128x128
            int above = au && (kBW[at(r - 1, c).size] < kBW[bsize]);
            int left = al && (kBH[at(r, c - 1).size] < kBW[bsize]);
            int ctx = left * 2 + above;
            uint16_t* pc = cdf.partition[bsl * 4 + ctx];
            int n = bsl == 0 ? 4 : bsl == 4 ? 8 : 10;
            auto prob = [&](int e) { return (e > 0 ? pc[e - 1] : 32768) - pc[e]; };
            if (has_rows && has_cols) {
                partition = ec.read(pc, n);
            } else if (has_cols) {
                int p = 32768 - prob(2) - prob(3) - prob(4) - prob(6) - prob(7);
                if (bsize != BLOCK_128X128) p -= prob(9);
                uint16_t tmp[2] = {(uint16_t)(32768 - p), 0};
                partition = ec.decode(tmp, 2) ? 3 : 1;
            } else if (has_rows) {
                int p = 32768 - prob(1) - prob(3) - prob(4) - prob(5) - prob(6);
                if (bsize != BLOCK_128X128) p -= prob(8);
                uint16_t tmp[2] = {(uint16_t)(32768 - p), 0};
                partition = ec.decode(tmp, 2) ? 3 : 2;
            } else {
                partition = 3;
            }
        }
        int bl = kBW[bsize];
        int horz = block_of(bl, bl - 1), vert = block_of(bl - 1, bl), split = block_of(bl - 1, bl - 1);
        // libaom: the partition's block size must have a chroma block under
        // the frame's subsampling (4:2:2 has none for the tall sizes)
        static const int kSub[10] = {0, 1, 2, 3, 1, 1, 2, 2, 4, 5};
        int sub = bsize;
        switch (kSub[partition]) {
            case 1: sub = horz; break;
            case 2: sub = vert; break;
            case 3: sub = split; break;
            case 4: sub = block_of(bl, bl - 2); break;
            case 5: sub = block_of(bl - 2, bl); break;
        }
        if (plane_block(sub, ssx, ssy) == BLOCK_INVALID) fail("block size invalid with this subsampling mode");
        // each block knows the partition that made it (has_top_right reads it)
        auto block = [&](int br, int bc, int bs) { decode_block(br, bc, bs, partition); };
        switch (partition) {
            case 0: block(r, c, bsize); break;
            case 1:
                block(r, c, horz);
                if (has_rows) block(r + half, c, horz);
                break;
            case 2:
                block(r, c, vert);
                if (has_cols) block(r, c + half, vert);
                break;
            case 3:
                decode_partition(r, c, split);
                decode_partition(r, c + half, split);
                decode_partition(r + half, c, split);
                decode_partition(r + half, c + half, split);
                break;
            case 4:
                block(r, c, split);
                block(r, c + half, split);
                block(r + half, c, horz);
                break;
            case 5:
                block(r, c, horz);
                block(r + half, c, split);
                block(r + half, c + half, split);
                break;
            case 6:
                block(r, c, split);
                block(r + half, c, split);
                block(r, c + half, vert);
                break;
            case 7:
                block(r, c, vert);
                block(r, c + half, split);
                block(r + half, c + half, split);
                break;
            case 8: {
                int b4 = block_of(bl, bl - 2);
                for (int i = 0; i < 4; i++)
                    if (i < 3 || r + quarter * 3 < fh.mi_rows) block(r + quarter * i, c, b4);
                break;
            }
            case 9: {
                int b4 = block_of(bl - 2, bl);
                for (int i = 0; i < 4; i++)
                    if (i < 3 || c + quarter * 3 < fh.mi_cols) block(r, c + quarter * i, b4);
                break;
            }
        }
    }

    // ------------------------------------------------------------ block
    void decode_block(int r, int c, int bsize, int part) {
        mi_row = r;
        mi_col = c;
        mi_size = bsize;
        partition = part;
        int bw4 = 1 << (kBW[bsize] - 2), bh4 = 1 << (kBH[bsize] - 2);
        if (bh4 == 1 && ssy && (r & 1) == 0) has_chroma = 0;
        else if (bw4 == 1 && ssx && (c & 1) == 0) has_chroma = 0;
        else has_chroma = num_planes > 1;
        avail_u = inside(r - 1, c);
        avail_l = inside(r, c - 1);
        avail_u_chroma = avail_u;
        avail_l_chroma = avail_l;
        if (has_chroma) {
            if (ssy && bh4 == 1) avail_u_chroma = inside(r - 2, c);
            if (ssx && bw4 == 1) avail_l_chroma = inside(r, c - 2);
        } else {
            avail_u_chroma = avail_l_chroma = 0;
        }
        if (ssx && !ssy && num_planes > 1) g_counters[C_BLOCKS_422]++;
        mode_info();
        palette_tokens();
        if (use_intrabc) read_tx_size_inter(bw4, bh4);
        else read_tx_size_block(bw4, bh4);
        if (skip) reset_block_context(bw4, bh4);
        for (int y = 0; y < bh4; y++)
            for (int x = 0; x < bw4; x++) {
                MiInfo& m = at(r + y, c + x);
                m.size = (uint8_t)bsize;
                m.ymode = (uint8_t)ymode;
                m.uvmode = (uint8_t)uvmode;
                m.skip = (uint8_t)skip;
                m.seg = (uint8_t)segment_id;
                m.use_filter_intra = (uint8_t)use_filter_intra;
                for (int i = 0; i < 4; i++) m.dlf[i] = (int8_t)delta_lf[i];
                m.intrabc = (uint8_t)use_intrabc;
                m.dv_row = (int16_t)dv_row;
                m.dv_col = (int16_t)dv_col;
                palettes[(size_t)(r + y) * mi_stride + c + x] = pal;
            }
        if (use_intrabc) {
            predict_intrabc(bw4, bh4);
            residual_inter(bw4, bh4);
        } else {
            residual(bw4, bh4);
        }
    }

    void mode_info() {
        skip = 0;
        if (fh.seg_id_pre_skip) intra_segment_id();
        read_skip();
        if (!fh.seg_id_pre_skip) intra_segment_id();
        read_cdef();
        read_delta_qindex();
        read_delta_lf();
        read_deltas = 0;
        use_intrabc = 0;
        dv_row = dv_col = 0;
        if (fh.allow_intrabc) use_intrabc = ec.read(cdf.intrabc, 2);
        if (use_intrabc) {
            // libaom's read_intrabc_info: DC_PRED for luma and chroma, no
            // palette, no filter intra, no CfL, no angle deltas
            ymode = uvmode = DC_PRED;
            angle_y = angle_uv = 0;
            pal = Palette{};
            use_filter_intra = 0;
            read_intrabc_dv();
            static const int kIbc[2][2] = {{C_IBC_444, -1}, {C_IBC_422, C_IBC_420}};
            g_counters[num_planes == 1 ? C_IBC_400 : kIbc[ssx][ssy]]++;
            return;
        }
        // intra frame y mode
        int am = avail_u ? at(mi_row - 1, mi_col).ymode : DC_PRED;
        int lm = avail_l ? at(mi_row, mi_col - 1).ymode : DC_PRED;
        ymode = ec.read(cdf.kf_y[kIntraModeCtx[am]][kIntraModeCtx[lm]], 13);
        angle_y = 0;
        if (mi_size >= BLOCK_8X8 && ymode >= V_PRED && ymode <= D67_PRED)
            angle_y = ec.read(cdf.angle[ymode - V_PRED], 7) - 3;
        uvmode = DC_PRED;
        angle_uv = 0;
        if (has_chroma) {
            int cfl_allowed;
            if (lossless && plane_block(mi_size, ssx, ssy) == BLOCK_4X4) cfl_allowed = 1;
            else if (!lossless && std::max(kBW[mi_size], kBH[mi_size]) <= 5) cfl_allowed = 1;
            else cfl_allowed = 0;
            uvmode = ec.read(cdf.uv_mode[cfl_allowed][ymode], cfl_allowed ? 14 : 13);
            if (uvmode == UV_CFL_PRED) read_cfl_alphas();
            if (mi_size >= BLOCK_8X8 && uvmode >= V_PRED && uvmode <= D67_PRED)
                angle_uv = ec.read(cdf.angle[uvmode - V_PRED], 7) - 3;
        }
        pal = Palette{};
        if (mi_size >= BLOCK_8X8 && kBW[mi_size] <= 6 && kBH[mi_size] <= 6 && fh.allow_screen_content)
            palette_mode_info();
        use_filter_intra = 0;
        if (seq.enable_filter_intra && ymode == DC_PRED && pal.n[0] == 0 &&
            std::max(kBW[mi_size], kBH[mi_size]) <= 5) {
            use_filter_intra = ec.read(cdf.filter_intra[mi_size], 2);
            if (use_filter_intra) filter_intra_mode = ec.read(cdf.filter_intra_mode, 5);
        }
    }

    // ------------------------------------------------------------ intra block copy: the DV
    // libaom's av1_find_mv_refs for INTRA_FRAME in an intra frame: the
    // spatial scan (rows above, columns left, top right, the outer ring),
    // where only intra-block-copy neighbours count, their weights and the
    // sort, then the clamp; no temporal candidates, no extension (every
    // candidate's reference is INTRA_FRAME)
    struct RefMv {
        int row, col, weight;
    };
    RefMv stack[8];
    int stack_n;
    void add_candidate(const MiInfo& m, int weight) {
        if (!m.intrabc) return;
        int k = 0;
        for (; k < stack_n; k++)
            if (stack[k].row == m.dv_row && stack[k].col == m.dv_col) {
                stack[k].weight += weight;
                break;
            }
        if (k == stack_n && stack_n < 8) stack[stack_n++] = RefMv{m.dv_row, m.dv_col, weight};
    }
    static int mi_w(int b) { return 1 << (kBW[b] - 2); }
    static int mi_h(int b) { return 1 << (kBH[b] - 2); }
    void scan_row(int row_offset, int max_row_offset, int* processed_rows) {
        int bw = mi_w(mi_size);
        int end_mi = std::min(std::min(bw, fh.mi_cols - mi_col), 16);
        int col_offset = 0;
        if (std::abs(row_offset) > 1) {
            col_offset = 1;
            if ((mi_col & 1) && bw < 2) col_offset--;
        }
        int use_step_16 = bw >= 16;
        for (int i = 0; i < end_mi;) {
            const MiInfo& m = at(mi_row + row_offset, mi_col + col_offset + i);
            int n4_w = mi_w(m.size);
            int len = std::min(bw, n4_w);
            if (use_step_16) len = std::max(4, len);
            else if (std::abs(row_offset) > 1) len = std::max(len, 2);
            int weight = 2;
            if (bw >= 2 && bw <= n4_w) {
                int inc = std::min(-max_row_offset + row_offset + 1, mi_h(m.size));
                weight = std::max(weight, inc);
                *processed_rows = inc - row_offset - 1;
            }
            add_candidate(m, len * weight);
            i += len;
        }
    }
    void scan_col(int col_offset, int max_col_offset, int* processed_cols) {
        int bh = mi_h(mi_size);
        int end_mi = std::min(std::min(bh, fh.mi_rows - mi_row), 16);
        int row_offset = 0;
        if (std::abs(col_offset) > 1) {
            row_offset = 1;
            if ((mi_row & 1) && bh < 2) row_offset--;
        }
        int use_step_16 = bh >= 16;
        for (int i = 0; i < end_mi;) {
            const MiInfo& m = at(mi_row + row_offset + i, mi_col + col_offset);
            int n4_h = mi_h(m.size);
            int len = std::min(bh, n4_h);
            if (use_step_16) len = std::max(4, len);
            else if (std::abs(col_offset) > 1) len = std::max(len, 2);
            int weight = 2;
            if (bh >= 2 && bh <= n4_h) {
                int inc = std::min(-max_col_offset + col_offset + 1, mi_w(m.size));
                weight = std::max(weight, inc);
                *processed_cols = inc - col_offset - 1;
            }
            add_candidate(m, len * weight);
            i += len;
        }
    }
    void scan_blk(int row_offset, int col_offset) {
        if (inside(mi_row + row_offset, mi_col + col_offset)) add_candidate(at(mi_row + row_offset, mi_col + col_offset), 4);
    }
    // libaom's has_top_right (bs in 4x4 units)
    int has_top_right(int bs) {
        int sb_mi = seq.sb128 ? 32 : 16;
        int mask_row = mi_row & (sb_mi - 1), mask_col = mi_col & (sb_mi - 1);
        if (bs > 16) return 0;
        int has_tr = !((mask_row & bs) && (mask_col & bs));
        while (bs < sb_mi) {
            if (mask_col & bs) {
                if ((mask_col & (2 * bs)) && (mask_row & (2 * bs))) {
                    has_tr = 0;
                    break;
                }
            } else {
                break;
            }
            bs <<= 1;
        }
        int w = mi_w(mi_size), h = mi_h(mi_size);
        // the last of a vertical partition; the first of a horizontal one
        if (w < h && ((mi_col + w) & (h - 1))) has_tr = 1;
        if (w > h && (mi_row & (w - 1))) has_tr = 0;
        if (partition == 6 && w == h && (mask_row & bs)) has_tr = 0;  // PARTITION_VERT_A
        return has_tr;
    }
    void find_dv_ref(int* ref_row, int* ref_col) {
        int bw = mi_w(mi_size), bh = mi_h(mi_size);
        int has_tr = has_top_right(std::max(bw, bh));
        int row_adj = bh < 2 && (mi_row & 1), col_adj = bw < 2 && (mi_col & 1);
        int max_row_offset = 0, max_col_offset = 0, processed_rows = 0, processed_cols = 0;
        stack_n = 0;
        if (avail_u) {
            max_row_offset = bh < 2 ? -4 + row_adj : -6 + row_adj;
            max_row_offset = clip3(mi_row_start - mi_row, mi_row_end - mi_row - 1, max_row_offset);
        }
        if (avail_l) {
            max_col_offset = bw < 2 ? -4 + col_adj : -6 + col_adj;
            max_col_offset = clip3(mi_col_start - mi_col, mi_col_end - mi_col - 1, max_col_offset);
        }
        if (std::abs(max_row_offset) >= 1) scan_row(-1, max_row_offset, &processed_rows);
        if (std::abs(max_col_offset) >= 1) scan_col(-1, max_col_offset, &processed_cols);
        if (has_tr) scan_blk(-1, bw);
        int nearest = stack_n;
        for (int k = 0; k < nearest; k++) stack[k].weight += 640;  // REF_CAT_LEVEL
        scan_blk(-1, -1);
        for (int idx = 2; idx <= 3; idx++) {
            int ro = -(idx << 1) + 1 + row_adj, co = -(idx << 1) + 1 + col_adj;
            if (std::abs(ro) <= std::abs(max_row_offset) && std::abs(ro) > processed_rows)
                scan_row(ro, max_row_offset, &processed_rows);
            if (std::abs(co) <= std::abs(max_col_offset) && std::abs(co) > processed_cols)
                scan_col(co, max_col_offset, &processed_cols);
        }
        auto sort = [&](int lo, int len) {
            while (len > lo) {
                int nr = lo;
                for (int k = lo + 1; k < len; k++)
                    if (stack[k - 1].weight < stack[k].weight) {
                        std::swap(stack[k - 1], stack[k]);
                        nr = k;
                    }
                len = nr;
            }
        };
        sort(0, nearest);
        sort(nearest, stack_n);
        // clamp_mv_ref: the block may reach 16 pixels past the frame's edges
        int left = -(mi_col * 32) - bw * 32 - 128, right = (fh.mi_cols - bw - mi_col) * 32 + bw * 32 + 128;
        int top = -(mi_row * 32) - bh * 32 - 128, bottom = (fh.mi_rows - bh - mi_row) * 32 + bh * 32 + 128;
        int list[2][2] = {{0, 0}, {0, 0}};
        for (int k = 0; k < std::min(stack_n, 2); k++) {
            list[k][0] = clip3(top, bottom, stack[k].row);
            list[k][1] = clip3(left, right, stack[k].col);
        }
        int k = (list[0][0] || list[0][1]) ? 0 : 1;
        *ref_row = list[k][0];
        *ref_col = list[k][1];
        if (*ref_row || *ref_col) {
            g_counters[C_DV_REF_NEIGHBOUR]++;
            return;
        }
        // av1_find_ref_dv: a superblock up, else a superblock and the
        // 256-pixel delay left
        int mib = seq.sb128 ? 32 : 16;
        if (mi_row - mib < mi_row_start) {
            *ref_row = 0;
            *ref_col = (-4 * mib - 256) * 8;
        } else {
            *ref_row = -4 * mib * 8;
            *ref_col = 0;
        }
        g_counters[C_DV_REF_DEFAULT]++;
    }
    // libaom's read_mv_component at MV_SUBPEL_NONE over the ndvc context
    int read_mv_component(int comp) {
        uint16_t* c = cdf.dv + 5 + 69 * comp;
        uint16_t *classes = c, *sign = c + 27, *class0 = c + 36, *bits = c + 39;
        int s = ec.read(sign, 2);
        int mv_class = ec.read(classes, 11);
        int mag, d;
        if (mv_class == 0) {
            d = ec.read(class0, 2);
            mag = 0;
        } else {
            int n = mv_class;  // mv_class + CLASS0_BITS - 1
            d = 0;
            for (int i = 0; i < n; i++) d |= ec.read(bits + 3 * i, 2) << i;
            mag = 2 << (mv_class + 2);
        }
        mag += ((d << 3) | (3 << 1) | 1) + 1;
        return s ? -mag : mag;
    }
    // libaom's av1_is_dv_valid
    bool dv_valid(int row, int col) {
        if ((row & 7) || (col & 7)) return false;
        int bw = 4 << (kBW[mi_size] - 2), bh = 4 << (kBH[mi_size] - 2);
        int src_top = mi_row * 32 + row, tile_top = mi_row_start * 32;
        if (src_top < tile_top) return false;
        int src_left = mi_col * 32 + col, tile_left = mi_col_start * 32;
        if (src_left < tile_left) return false;
        int src_bottom = (mi_row * 4 + bh) * 8 + row;
        if (src_bottom > mi_row_end * 32) return false;
        int src_right = (mi_col * 4 + bw) * 8 + col;
        if (src_right > mi_col_end * 32) return false;
        // sub-8x8 chroma reaches 4 pixels up or left of the block
        if (num_planes > 1 && has_chroma) {
            if (bw < 8 && ssx && src_left < tile_left + 32) return false;
            if (bh < 8 && ssy && src_top < tile_top + 32) return false;
        }
        int mib_log2 = seq.sb128 ? 5 : 4;
        int sb_size = 4 << mib_log2;
        int active_sb_row = mi_row >> mib_log2, active_sb64_col = (mi_col * 4) >> 6;
        int src_sb_row = ((src_bottom >> 3) - 1) / sb_size, src_sb64_col = ((src_right >> 3) - 1) >> 6;
        int total_sb64_per_row = ((mi_col_end - mi_col_start - 1) >> 4) + 1;
        int active_sb64 = active_sb_row * total_sb64_per_row + active_sb64_col;
        int src_sb64 = src_sb_row * total_sb64_per_row + src_sb64_col;
        if (src_sb64 >= active_sb64 - 4) return false;  // INTRABC_DELAY_SB64
        int gradient = 1 + 4 + (sb_size > 64);
        int wf_offset = gradient * (active_sb_row - src_sb_row);
        if (src_sb_row > active_sb_row || src_sb64_col >= active_sb64_col - 4 + wf_offset) return false;
        return true;
    }
    void read_intrabc_dv() {
        int ref_row, ref_col;
        find_dv_ref(&ref_row, &ref_col);
        bool valid = !(ref_row & 7) && !(ref_col & 7);
        ref_row = (ref_row >> 3) * 8;
        ref_col = (ref_col >> 3) * 8;
        int joint = ec.read(cdf.dv, 4);
        int drow = (joint == 2 || joint == 3) ? read_mv_component(0) : 0;
        int dcol = (joint == 1 || joint == 3) ? read_mv_component(1) : 0;
        dv_row = ((ref_row + drow) >> 3) * 8;
        dv_col = ((ref_col + dcol) >> 3) * 8;
        valid = valid && dv_row > -(1 << 14) && dv_row < (1 << 14) && dv_col > -(1 << 14) && dv_col < (1 << 14);
        if (!valid || !dv_valid(dv_row, dv_col)) fail("invalid intrabc dv");
    }

    // ------------------------------------------------------------ intra block copy: transforms
    // libaom's txfm_partition_context
    int txfm_partition_ctx(int blk_row, int blk_col, int t) {
        int above = above_txfm[mi_col + blk_col] < (1 << kTW[t]);
        int left = left_txfm[mi_row + blk_row] < (1 << kTH[t]);
        if (t == 0) return 0;
        int dim = std::max(kBW[mi_size], kBH[mi_size]);  // log2 of the larger side
        int max_sq = std::min(dim, 6) - 2;  // get_sqr_tx_size: TX_4X4 .. TX_64X64
        int category = (tx_sqr_up(t) != max_sq && max_sq > 1) + (4 - max_sq) * 2;
        return category * 3 + above + left;
    }
    void txfm_update(int blk_row, int blk_col, int area_t, int t) {
        int w4 = 1 << (kTW[area_t] - 2), h4 = 1 << (kTH[area_t] - 2);
        for (int i = 0; i < h4; i++) left_txfm[mi_row + blk_row + i] = (uint8_t)(1 << kTH[t]);
        for (int i = 0; i < w4; i++) above_txfm[mi_col + blk_col + i] = (uint8_t)(1 << kTW[t]);
    }
    void set_inter_tx(int blk_row, int blk_col, int area_t, int t) {
        int w4 = 1 << (kTW[area_t] - 2), h4 = 1 << (kTH[area_t] - 2);
        for (int i = 0; i < h4; i++)
            for (int j = 0; j < w4; j++) inter_tx[blk_row + i][blk_col + j] = (uint8_t)t;
    }
    // libaom's read_tx_size_vartx
    void read_vartx(int t, int depth, int blk_row, int blk_col) {
        int max_h = std::min(mi_h(mi_size), fh.mi_rows - mi_row), max_w = std::min(mi_w(mi_size), fh.mi_cols - mi_col);
        if (blk_row >= max_h || blk_col >= max_w) return;
        if (depth == 2) {
            set_inter_tx(blk_row, blk_col, t, t);
            tx_size = t;
            txfm_update(blk_row, blk_col, t, t);
            g_counters[C_VARTX_DEPTH2]++;
            return;
        }
        int ctx = txfm_partition_ctx(blk_row, blk_col, t);
        if (ec.read(cdf.txfm_partition[ctx], 2)) {
            int sub = split_tx(t);
            if (sub == 0) {
                set_inter_tx(blk_row, blk_col, t, sub);
                tx_size = sub;
                txfm_update(blk_row, blk_col, t, sub);
                g_counters[depth + 1 == 1 ? C_VARTX_DEPTH1 : C_VARTX_DEPTH2]++;
                return;
            }
            int sh = 1 << (kTH[sub] - 2), sw = 1 << (kTW[sub] - 2);
            for (int row = 0; row < (1 << (kTH[t] - 2)); row += sh)
                for (int col = 0; col < (1 << (kTW[t] - 2)); col += sw)
                    read_vartx(sub, depth + 1, blk_row + row, blk_col + col);
        } else {
            set_inter_tx(blk_row, blk_col, t, t);
            tx_size = t;
            txfm_update(blk_row, blk_col, t, t);
            if (depth == 1) g_counters[C_VARTX_DEPTH1]++;
        }
    }
    // libaom's parse_decode_block for an intra-block-copy block: the
    // transform tree where it is coded, else one size for the block (the
    // largest rectangle; 4x4 where lossless)
    void read_tx_size_inter(int bw4, int bh4) {
        int mt = max_tx_rect(mi_size);
        if (fh.tx_mode_select && mi_size > BLOCK_4X4 && !skip && !lossless) {
            int bh = 1 << (kTH[mt] - 2), bw = 1 << (kTW[mt] - 2);
            for (int idy = 0; idy < bh4; idy += bh)
                for (int idx = 0; idx < bw4; idx += bw) read_vartx(mt, 0, idy, idx);
            return;
        }
        tx_size = lossless ? 0 : mt;
        for (int i = 0; i < bh4; i++)
            for (int j = 0; j < bw4; j++) inter_tx[i][j] = (uint8_t)tx_size;
        // set_txfm_ctxs: a skipped inter block gives its own size
        for (int i = 0; i < bw4; i++) above_txfm[mi_col + i] = (uint8_t)(skip ? bw4 * 4 : 1 << kTW[tx_size]);
        for (int i = 0; i < bh4; i++) left_txfm[mi_row + i] = (uint8_t)(skip ? bh4 * 4 : 1 << kTH[tx_size]);
    }

    // ------------------------------------------------------------ intra block copy: prediction
    // libaom's build_inter_predictors_8x8_and_bigger with the intra block
    // copy filter: whole pixels copied, half-pel chroma positions averaged
    // (av1_convolve_{x,y,2d}_sr_intrabc_c: round_0 3, round_1 11 at 8 bits)
    void predict_intrabc(int bw4, int bh4) {
        for (int p = 0; p < 1 + 2 * has_chroma; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int bw = std::max(4, (bw4 * 4) >> sx), bh = std::max(4, (bh4 * 4) >> sy);
            int row_start = (bh4 == 1 && sy) ? -1 : 0, col_start = (bw4 == 1 && sx) ? -1 : 0;
            int pre_x = (mi_col * 4 + 4 * col_start) >> sx, pre_y = (mi_row * 4 + 4 * row_start) >> sy;
            // clamp_mv_to_umv_border_sb (a valid DV is never clamped)
            int mvr = dv_row * (1 << (1 - sy)), mvc = dv_col * (1 << (1 - sx));
            int spel_left = (4 + bw) << 4, spel_top = (4 + bh) << 4;
            mvc = clip3(-(mi_col * 32) * (1 << (1 - sx)) - spel_left,
                        (fh.mi_cols - bw4 - mi_col) * 32 * (1 << (1 - sx)) + spel_left - 16, mvc);
            mvr = clip3(-(mi_row * 32) * (1 << (1 - sy)) - spel_top,
                        (fh.mi_rows - bh4 - mi_row) * 32 * (1 << (1 - sy)) + spel_top - 16, mvr);
            int pos_x = (pre_x << 4) + mvc, pos_y = (pre_y << 4) + mvr;
            int x0 = pos_x >> 4, y0 = pos_y >> 4, fx = pos_x & 15, fy = pos_y & 15;
            if (x0 < 0 || y0 < 0 || x0 + bw + (fx != 0) > cur.pw[p] || y0 + bh + (fy != 0) > cur.ph[p])
                fail("intrabc source outside the frame");
            if (p && (fx || fy)) g_counters[ssy ? C_HALF_PEL_420 : C_HALF_PEL_422]++;
            int stride = cur.stride[p];
            const uint8_t* src = &cur.p[p][(size_t)y0 * stride + x0];
            uint8_t* dst = &cur.p[p][(size_t)pre_y * stride + pre_x];
            for (int i = 0; i < bh; i++)
                for (int j = 0; j < bw; j++) {
                    const uint8_t* s = src + (size_t)i * stride + j;
                    int v;
                    if (fx && fy) v = (s[0] + s[1] + s[stride] + s[stride + 1] + 2) >> 2;
                    else if (fx) v = (s[0] + s[1] + 1) >> 1;
                    else if (fy) v = (s[0] + s[stride] + 1) >> 1;
                    else v = s[0];
                    dst[(size_t)i * stride + j] = (uint8_t)v;
                }
        }
    }

    // ------------------------------------------------------------ intra block copy: residual
    // libaom's decode_token_recon_block for an inter block: each 64x64 unit,
    // luma along the transform tree (decode_reconstruct_tx), then chroma at
    // the largest chroma transform
    void residual_inter(int bw4, int bh4) {
        int max_bw = std::min(bw4, fh.mi_cols - mi_col), max_bh = std::min(bh4, fh.mi_rows - mi_row);
        int mu_w = std::min(max_bw, 16), mu_h = std::min(max_bh, 16);
        for (int row = 0; row < max_bh; row += mu_h)
            for (int col = 0; col < max_bw; col += mu_w)
                for (int p = 0; p < 1 + 2 * has_chroma; p++) {
                    int sx = p ? ssx : 0, sy = p ? ssy : 0;
                    int pb = p ? plane_block(mi_size, ssx, ssy) : mi_size;
                    int mt = lossless ? 0 : p ? uv_tx_size() : max_tx_rect(mi_size);
                    int bh_var = 1 << (kTH[mt] - 2), bw_var = 1 << (kTW[mt] - 2);
                    int unit_h = round2(std::min(mu_h + row, max_bh), sy), unit_w = round2(std::min(mu_w + col, max_bw), sx);
                    for (int br = row >> sy; br < unit_h; br += bh_var)
                        for (int bc = col >> sx; bc < unit_w; bc += bw_var) recon_tx(p, pb, br, bc, mt);
                }
    }
    void recon_tx(int p, int pb, int blk_row, int blk_col, int t) {
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        // max_block_high / wide of the plane block, clipped at the frame
        int max_h = 1 << kBH[pb], max_w = 1 << kBW[pb];
        int bh4 = mi_h(mi_size), bw4 = mi_w(mi_size);
        if (mi_row + bh4 > fh.mi_rows) max_h += ((fh.mi_rows - bh4 - mi_row) * 4) >> sy;
        if (mi_col + bw4 > fh.mi_cols) max_w += ((fh.mi_cols - bw4 - mi_col) * 4) >> sx;
        max_h >>= 2;
        max_w >>= 2;
        if (blk_row >= max_h || blk_col >= max_w) return;
        int plane_t = p ? t : inter_tx[blk_row][blk_col];
        if (t == plane_t || p) {
            int startx = (mi_col >> sx) * 4 + blk_col * 4, starty = (mi_row >> sy) * 4 + blk_row * 4;
            if (!skip) {
                inter_blk_row = blk_row;
                inter_blk_col = blk_col;
                int eob = coeffs(p, startx, starty, t);
                if (eob > 0)
                    inverse_transform_add(dequant, t, plane_tx_type, lossless,
                                          &cur.p[p][(size_t)starty * cur.stride[p] + startx], cur.stride[p]);
            }
            mark_decoded(p, startx, starty, t);
            return;
        }
        int sub = split_tx(t);
        int bsw = 1 << (kTW[sub] - 2), bsh = 1 << (kTH[sub] - 2);
        int row_end = std::min(1 << (kTH[t] - 2), max_h - blk_row), col_end = std::min(1 << (kTW[t] - 2), max_w - blk_col);
        for (int row = 0; row < row_end; row += bsh)
            for (int col = 0; col < col_end; col += bsw) recon_tx(p, pb, blk_row + row, blk_col + col, sub);
    }
    int inter_blk_row = 0, inter_blk_col = 0;

    // ------------------------------------------------------------ palettes
    static int ceil_log2(int n) {
        if (n < 2) return 0;
        int i = 1, p = 2;
        while (p < n) {
            i++;
            p <<= 1;
        }
        return i;
    }
    // libaom's av1_get_palette_cache: the sorted union of the above (not
    // across a 64-pixel row boundary) and left blocks' colours
    int palette_cache(int plane, uint16_t* cache) {
        int an = 0, ln = 0;
        const Palette* a = nullptr;
        const Palette* l = nullptr;
        if (avail_u && (mi_row * 4) % 64) {
            a = &palettes[(size_t)(mi_row - 1) * mi_stride + mi_col];
            an = a->n[plane != 0];
        }
        if (avail_l) {
            l = &palettes[(size_t)mi_row * mi_stride + mi_col - 1];
            ln = l->n[plane != 0];
        }
        int ai = 0, li = 0, n = 0;
        while (an > 0 && ln > 0) {
            int va = a->c[plane][ai], vl = l->c[plane][li];
            if (vl < va) {
                if (n == 0 || vl != cache[n - 1]) cache[n++] = (uint16_t)vl;
                li++, ln--;
            } else {
                if (n == 0 || va != cache[n - 1]) cache[n++] = (uint16_t)va;
                ai++, an--;
                if (vl == va) li++, ln--;
            }
        }
        while (an-- > 0) {
            int v = a->c[plane][ai++];
            if (n == 0 || v != cache[n - 1]) cache[n++] = (uint16_t)v;
        }
        while (ln-- > 0) {
            int v = l->c[plane][li++];
            if (n == 0 || v != cache[n - 1]) cache[n++] = (uint16_t)v;
        }
        return n;
    }
    // libaom's read_palette_colors_y / _uv (U: plane 1, no +1 on deltas)
    void palette_colors(int plane, int n) {
        uint16_t cache[16], cached[8];
        int ncache = palette_cache(plane, cache);
        uint16_t* colors = pal.c[plane];
        int idx = 0;
        for (int i = 0; i < ncache && idx < n; i++)
            if (ec.lit(1)) cached[idx++] = cache[i];
        if (idx < n) {
            int ncached = idx;
            colors[idx++] = (uint16_t)ec.lit(8);
            if (idx < n) {
                int bits = 5 + ec.lit(2);
                int range = 256 - colors[idx - 1] - (plane == 0);
                for (; idx < n; idx++) {
                    int delta = ec.lit(bits) + (plane == 0);
                    colors[idx] = (uint16_t)clip3(0, 255, colors[idx - 1] + delta);
                    range -= colors[idx] - colors[idx - 1];
                    bits = std::min(bits, ceil_log2(range));
                }
            }
            if (ncached) {  // libaom's merge_colors
                uint16_t merged[8];
                int ci = 0, ti = ncached;
                for (int i = 0; i < n; i++) {
                    if (ci < ncached && (ti >= n || cached[ci] <= colors[ti])) merged[i] = cached[ci++];
                    else merged[i] = colors[ti++];
                }
                std::memcpy(colors, merged, sizeof(uint16_t) * n);
            }
        } else {
            std::memcpy(colors, cached, sizeof(uint16_t) * n);
        }
    }
    void palette_mode_info() {
        int bctx = kBW[mi_size] + kBH[mi_size] - 6;
        if (ymode == DC_PRED) {
            int ctx = (avail_u && palettes[(size_t)(mi_row - 1) * mi_stride + mi_col].n[0] > 0) +
                      (avail_l && palettes[(size_t)mi_row * mi_stride + mi_col - 1].n[0] > 0);
            if (ec.read(cdf.palette_y_mode[bctx][ctx], 2)) {
                pal.n[0] = (uint8_t)(ec.read(cdf.palette_y_size[bctx], 7) + 2);
                palette_colors(0, pal.n[0]);
            }
        }
        if (has_chroma && uvmode == DC_PRED) {
            if (ec.read(cdf.palette_uv_mode[pal.n[0] > 0], 2)) {
                int n = ec.read(cdf.palette_uv_size[bctx], 7) + 2;
                pal.n[1] = (uint8_t)n;
                palette_colors(1, n);
                uint16_t* v = pal.c[2];
                if (ec.lit(1)) {
                    int bits = 4 + ec.lit(2);
                    v[0] = (uint16_t)ec.lit(8);
                    for (int i = 1; i < n; i++) {
                        int delta = ec.lit(bits);
                        if (delta && ec.lit(1)) delta = -delta;
                        int val = v[i - 1] + delta;
                        if (val < 0) val += 256;
                        if (val >= 256) val -= 256;
                        v[i] = (uint16_t)clip1(val);
                    }
                } else {
                    for (int i = 0; i < n; i++) v[i] = (uint16_t)ec.lit(8);
                }
            }
        }
    }
    // the colour index map of a plane type, in libaom's wavefront order
    void palette_tokens() {
        int bw = 4 << (kBW[mi_size] - 2), bh = 4 << (kBH[mi_size] - 2);
        int onh = std::min(bh, (fh.mi_rows - mi_row) * 4), onw = std::min(bw, (fh.mi_cols - mi_col) * 4);
        for (int t = 0; t < 2; t++) {
            int n = pal.n[t];
            if (!n) continue;
            int w = bw, h = bh, ow = onw, oh = onh;
            if (t) {
                w >>= ssx;
                h >>= ssy;
                ow >>= ssx;
                oh >>= ssy;
                if (w < 4) { w += 2; ow += 2; }
                if (h < 4) { h += 2; oh += 2; }
            }
            uint8_t* map = color_map[t];
            color_map_w[t] = w;
            {
                int l = floor_log2(n) + 1, m = (1 << l) - n;
                int v = ec.lit(l - 1);
                map[0] = (uint8_t)(v < m ? v : (v << 1) - m + ec.lit(1));
            }
            for (int i = 1; i < oh + ow - 1; i++)
                for (int j = std::min(i, ow - 1); j >= std::max(0, i - oh + 1); j--) {
                    int r = i - j, c = j;
                    int scores[8] = {0}, order[8];
                    for (int k = 0; k < 8; k++) order[k] = k;
                    if (c > 0) scores[map[r * w + c - 1]] += 2;
                    if (r > 0 && c > 0) scores[map[(r - 1) * w + c - 1]] += 1;
                    if (r > 0) scores[map[(r - 1) * w + c]] += 2;
                    for (int k = 0; k < 3; k++) {
                        int best = scores[k], bi = k;
                        for (int q = k + 1; q < n; q++)
                            if (scores[q] > best) {
                                best = scores[q];
                                bi = q;
                            }
                        if (bi != k) {
                            int bs = scores[bi], bo = order[bi];
                            for (int q = bi; q > k; q--) {
                                scores[q] = scores[q - 1];
                                order[q] = order[q - 1];
                            }
                            scores[k] = bs;
                            order[k] = bo;
                        }
                    }
                    static const int hash_ctx[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
                    int ctx = hash_ctx[scores[0] + scores[1] * 2 + scores[2] * 2];
                    uint16_t* pc = t ? cdf.palette_uv_color[n - 2][ctx] : cdf.palette_y_color[n - 2][ctx];
                    map[r * w + c] = (uint8_t)order[ec.read(pc, n)];
                }
            for (int i = 0; i < oh; i++)
                for (int j = ow; j < w; j++) map[i * w + j] = map[i * w + ow - 1];
            for (int i = oh; i < h; i++) std::memcpy(&map[i * w], &map[(oh - 1) * w], w);
        }
    }

    void intra_segment_id() {
        if (fh.seg_enabled) read_segment_id();
        else segment_id = 0;
        lossless = fh.lossless_array[segment_id];
    }
    void read_segment_id() {
        int prev_ul = (avail_u && avail_l) ? at(mi_row - 1, mi_col - 1).seg : -1;
        int prev_u = avail_u ? at(mi_row - 1, mi_col).seg : -1;
        int prev_l = avail_l ? at(mi_row, mi_col - 1).seg : -1;
        int pred;
        if (prev_u == -1) pred = prev_l == -1 ? 0 : prev_l;
        else if (prev_l == -1) pred = prev_u;
        else pred = prev_ul == prev_u ? prev_u : prev_l;
        if (skip) {
            segment_id = pred;
            return;
        }
        int ctx;
        if (prev_ul < 0) ctx = 0;
        else if (prev_ul == prev_u && prev_ul == prev_l) ctx = 2;
        else if (prev_ul == prev_u || prev_ul == prev_l || prev_u == prev_l) ctx = 1;
        else ctx = 0;
        int v = ec.read(cdf.seg[ctx], 8);
        int mx = fh.last_active_seg + 1;
        int s;
        if (!pred) s = v;
        else if (pred >= mx - 1) s = mx - v - 1;
        else if (2 * pred < mx) {
            if (v <= 2 * pred) s = (v & 1) ? pred + ((v + 1) >> 1) : pred - (v >> 1);
            else s = v;
        } else {
            if (v <= 2 * (mx - pred - 1)) s = (v & 1) ? pred + ((v + 1) >> 1) : pred - (v >> 1);
            else s = mx - (v + 1);
        }
        segment_id = clip3(0, fh.last_active_seg, s);
    }
    void read_skip() {
        if (fh.seg_id_pre_skip && fh.seg_enabled && fh.feature_enabled[segment_id][6]) {
            skip = 1;
            return;
        }
        int ctx = (avail_u ? at(mi_row - 1, mi_col).skip : 0) + (avail_l ? at(mi_row, mi_col - 1).skip : 0);
        skip = ec.read(cdf.skip[ctx], 2);
    }
    void read_cdef() {
        if (skip || fh.coded_lossless || !seq.enable_cdef || fh.allow_intrabc) return;
        int r = mi_row & ~15, c = mi_col & ~15;
        if (cdef_at(r, c) == -1) {
            int v = ec.lit(fh.cdef_bits);
            int w4 = 1 << (kBW[mi_size] - 2), h4 = 1 << (kBH[mi_size] - 2);
            for (int y = r; y < r + h4; y += 16)
                for (int x = c; x < c + w4; x += 16) cdef_at(y, x) = (int8_t)v;
        }
    }
    void read_delta_qindex() {
        int sb = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
        if (mi_size == sb && skip) return;
        if (!read_deltas) return;
        int a = ec.read(cdf.delta_q, 4);
        if (a == 3) {
            int rem = ec.lit(3) + 1;
            a = ec.lit(rem) + (1 << rem) + 1;
        }
        if (a) {
            int sign = ec.lit(1);
            int red = sign ? -a : a;
            current_q = clip3(1, 255, current_q + (red << fh.delta_q_res));
        }
    }
    void read_delta_lf() {
        int sb = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
        if (mi_size == sb && skip) return;
        if (!read_deltas || !fh.delta_lf_present) return;
        int count = 1;
        if (fh.delta_lf_multi) count = num_planes > 1 ? 4 : 2;
        for (int i = 0; i < count; i++) {
            int a = ec.read(fh.delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf, 4);
            if (a == 3) {
                int n = ec.lit(3) + 1;
                a = ec.lit(n) + (1 << n) + 1;
            }
            if (a) {
                int sign = ec.lit(1);
                int red = sign ? -a : a;
                delta_lf[i] = clip3(-63, 63, delta_lf[i] + (red << fh.delta_lf_res));
            }
        }
    }
    void read_cfl_alphas() {
        int signs = ec.read(cdf.cfl_sign, 8);
        int su = (signs + 1) / 3, sv = (signs + 1) % 3;
        cfl_u = cfl_v = 0;
        if (su) {
            cfl_u = 1 + ec.read(cdf.cfl_alpha[(su - 1) * 3 + sv], 16);
            if (su == 1) cfl_u = -cfl_u;
        }
        if (sv) {
            cfl_v = 1 + ec.read(cdf.cfl_alpha[(sv - 1) * 3 + su], 16);
            if (sv == 1) cfl_v = -cfl_v;
        }
    }

    // libaom's read_tx_size of an intra block; its get_tx_size_context reads
    // the transform-size contexts, and an intra-block-copy neighbour's block
    // size
    void read_tx_size_block(int bw4, int bh4) {
        int mt = max_tx_rect(mi_size);
        tx_size = lossless ? 0 : mt;
        if (!lossless && mi_size > BLOCK_4X4 && fh.tx_mode_select) {
            int maxw = 1 << kTW[mt], maxh = 1 << kTH[mt];
            int above = 0, left = 0;
            if (avail_u) {
                const MiInfo& a = at(mi_row - 1, mi_col);
                above = (a.intrabc ? 1 << kBW[a.size] : above_txfm[mi_col]) >= maxw;
            }
            if (avail_l) {
                const MiInfo& l = at(mi_row, mi_col - 1);
                left = (l.intrabc ? 1 << kBH[l.size] : left_txfm[mi_row]) >= maxh;
            }
            int ctx = above + left;
            int md = max_depth(mi_size);
            int depth = ec.read(cdf.tx_size[tx_cat(mi_size)][ctx], md + 1);
            for (int i = 0; i < depth; i++) tx_size = split_tx(tx_size);
        }
        for (int i = 0; i < bw4; i++) above_txfm[mi_col + i] = (uint8_t)(1 << kTW[tx_size]);
        for (int i = 0; i < bh4; i++) left_txfm[mi_row + i] = (uint8_t)(1 << kTH[tx_size]);
    }
    void reset_block_context(int bw4, int bh4) {
        for (int p = 0; p < 1 + 2 * has_chroma; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            for (int i = mi_col >> sx; i < ((mi_col + bw4) >> sx); i++) above_level[p][i] = above_dc[p][i] = 0;
            for (int i = mi_row >> sy; i < ((mi_row + bh4) >> sy); i++) left_level[p][i] = left_dc[p][i] = 0;
            if (p && ((mi_col + bw4) >> sx) == (mi_col >> sx)) above_level[p][mi_col >> sx] = above_dc[p][mi_col >> sx] = 0;
            if (p && ((mi_row + bh4) >> sy) == (mi_row >> sy)) left_level[p][mi_row >> sy] = left_dc[p][mi_row >> sy] = 0;
        }
    }

    // ------------------------------------------------------------ residual
    int uv_tx_size() {
        int ut = max_tx_rect(plane_block(mi_size, ssx, ssy));
        if (kTW[ut] == 6 || kTH[ut] == 6) {
            if (kTW[ut] == 4) return tx_of(4, 5);
            if (kTH[ut] == 4) return tx_of(5, 4);
            return 3;
        }
        return ut;
    }
    void residual(int bw4, int bh4) {
        int wchunks = std::max(1, bw4 >> 4), hchunks = std::max(1, bh4 >> 4);
        for (int cy = 0; cy < hchunks; cy++)
            for (int cx = 0; cx < wchunks; cx++) {
                for (int p = 0; p < 1 + has_chroma * 2; p++) {
                    int t = lossless ? 0 : (p == 0 ? tx_size : uv_tx_size());
                    int stepx = 1 << (kTW[t] - 2), stepy = 1 << (kTH[t] - 2);
                    int sx = p ? ssx : 0, sy = p ? ssy : 0;
                    int pb = p ? plane_block(mi_size, ssx, ssy) : mi_size;
                    int n4w = 1 << (kBW[pb] - 2), n4h = 1 << (kBH[pb] - 2);
                    int basex = (mi_col >> sx) * 4, basey = (mi_row >> sy) * 4;
                    for (int y = 0; y < std::min(n4h, 16 >> sy); y += stepy)
                        for (int x = 0; x < std::min(n4w, 16 >> sx); x += stepx)
                            transform_block(p, basex, basey, t, x + ((cx << 4) >> sx), y + ((cy << 4) >> sy));
                }
            }
    }

    void transform_block(int p, int basex, int basey, int t, int x, int y) {
        int startx = basex + 4 * x, starty = basey + 4 * y;
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int row = (starty << sy) >> 2, col = (startx << sx) >> 2;
        int sbmask = seq.sb128 ? 31 : 15;
        int sbr = row & sbmask, sbc = col & sbmask;
        int stepx = 1 << (kTW[t] - 2), stepy = 1 << (kTH[t] - 2);
        int maxx = (fh.mi_cols * 4) >> sx, maxy = (fh.mi_rows * 4) >> sy;
        if (startx >= maxx || starty >= maxy) return;
        bool is_cfl = p > 0 && uvmode == UV_CFL_PRED;
        int mode = p == 0 ? ymode : (is_cfl ? DC_PRED : uvmode);
        int have_left = (p == 0 ? avail_l : avail_l_chroma) || x > 0;
        int have_above = (p == 0 ? avail_u : avail_u_chroma) || y > 0;
        int have_ar = block_decoded[p][(sbr >> sy) - 1 + 1][(sbc >> sx) + stepx + 1];
        int have_bl = block_decoded[p][(sbr >> sy) + stepy + 1][(sbc >> sx) - 1 + 1];
        if (pal.n[p > 0]) {
            const uint8_t* map = color_map[p > 0];
            int mw = color_map_w[p > 0];
            for (int i = 0; i < (1 << kTH[t]); i++)
                for (int j = 0; j < (1 << kTW[t]); j++)
                    cur.p[p][(size_t)(starty + i) * cur.stride[p] + startx + j] =
                        (uint8_t)pal.c[p][map[(y * 4 + i) * mw + x * 4 + j]];
        } else {
            predict_intra(p, startx, starty, have_left, have_above, have_ar, have_bl, mode, kTW[t], kTH[t]);
            if (is_cfl) predict_cfl(p, startx, starty, t);
        }
        if (p == 0) {
            max_luma_w = startx + stepx * 4;
            max_luma_h = starty + stepy * 4;
        }
        if (!skip) {
            int eob = coeffs(p, startx, starty, t);
            if (eob > 0)
                inverse_transform_add(dequant, t, plane_tx_type, lossless,
                                      &cur.p[p][(size_t)starty * cur.stride[p] + startx], cur.stride[p]);
        }
        mark_decoded(p, startx, starty, t);
    }
    // the spec's LoopfilterTxSizes and BlockDecoded of a transform block
    void mark_decoded(int p, int startx, int starty, int t) {
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int row = (starty << sy) >> 2, col = (startx << sx) >> 2;
        int sbmask = seq.sb128 ? 31 : 15;
        int sbr = row & sbmask, sbc = col & sbmask;
        int stepx = 1 << (kTW[t] - 2), stepy = 1 << (kTH[t] - 2);
        for (int i = 0; i < stepy; i++)
            for (int j = 0; j < stepx; j++) {
                lf_tx[p][(size_t)((row >> sy) + i) * lf_stride[p] + (col >> sx) + j] = (uint8_t)t;
                block_decoded[p][(sbr >> sy) + i + 1][(sbc >> sx) + j + 1] = 1;
            }
    }

    // ------------------------------------------------------------ coefficients
    // libaom's av1_get_ext_tx_set_type: 0 DCT only, 1 DCT and IDTX, 2 DTT4_IDTX,
    // 3 DTT4_IDTX_1DDCT, 4 DTT9_IDTX_1DDCT, 5 all 16
    int get_tx_set(int t, int inter = 0) {
        int sq = tx_sqr(t), squp = tx_sqr_up(t);
        if (squp > 3) return 0;
        if (squp == 3) return inter ? 1 : 0;
        if (fh.reduced_tx_set) return inter ? 1 : 2;
        if (inter) return sq == 2 ? 4 : 5;
        if (sq == 2) return 2;
        return 3;
    }
    int compute_tx_type(int p, int t, int x4, int y4) {
        if (lossless || tx_sqr_up(t) > 3) return DCT_DCT;
        if (p == 0) return tx_types[(size_t)y4 * mi_stride + x4];
        if (use_intrabc) {
            // the luma type at the chroma transform's place in the block
            int type = tx_types[(size_t)(mi_row + (inter_blk_row << ssy)) * mi_stride + mi_col + (inter_blk_col << ssx)];
            return kExtTxUsed[get_tx_set(t, 1)][type] ? type : DCT_DCT;
        }
        int type = kModeToTxfm[uvmode];
        int set = get_tx_set(t);
        if (set == 0 && type != DCT_DCT) return DCT_DCT;
        return type;
    }
    // an inter block's luma type, at its transform's top-left 4x4 only
    void read_tx_type_inter(int t, int x4, int y4) {
        int set = get_tx_set(t, 1);
        int type = DCT_DCT;
        int q = fh.seg_enabled ? seg_qindex(segment_id, fh.base_q_idx) : fh.base_q_idx;
        if (set > 0 && q > 0) {
            int sym = ec.read(cdf.inter_ext_tx[kExtTxSetIndex[1][set]][tx_sqr(t)], kTxSetSize[set]);
            type = kExtTxInv[set][sym];
            g_counters[set == 1 ? C_TX_SET_DCT_IDTX : set == 4 ? C_TX_SET_DTT9 : C_TX_SET_ALL16]++;
        }
        tx_types[(size_t)y4 * mi_stride + x4] = (uint8_t)type;
    }
    void read_tx_type(int t, int x4, int y4) {
        int set = get_tx_set(t);
        int type = DCT_DCT;
        int q = fh.seg_enabled ? seg_qindex(segment_id, fh.base_q_idx) : fh.base_q_idx;
        if (set > 0 && q > 0) {
            int eset = kExtTxSetIndex[0][set];
            int dir = use_filter_intra ? (int)"\x00\x01\x02\x06\x00"[filter_intra_mode] : ymode;
            int sym = ec.read(cdf.intra_ext_tx[eset][tx_sqr(t)][dir], kTxSetSize[set]);
            type = kExtTxInv[set][sym];
        }
        int w4 = 1 << (kTW[t] - 2), h4 = 1 << (kTH[t] - 2);
        for (int j = 0; j < h4; j++)
            for (int i = 0; i < w4; i++) tx_types[(size_t)(y4 + j) * mi_stride + x4 + i] = (uint8_t)type;
    }
    int get_dc_q(int p) {
        int q = seg_qindex(segment_id, fh.delta_q_present ? current_q : fh.base_q_idx);
        int d = p == 0 ? fh.dq_y_dc : p == 1 ? fh.dq_u_dc : fh.dq_v_dc;
        return kDcQLookup[clip3(0, 255, q + d)];
    }
    int get_ac_q(int p) {
        int q = seg_qindex(segment_id, fh.delta_q_present ? current_q : fh.base_q_idx);
        int d = p == 0 ? 0 : p == 1 ? fh.dq_u_ac : fh.dq_v_ac;
        return kAcQLookup[clip3(0, 255, q + d)];
    }

    int coeffs(int p, int startx, int starty, int t) {
        int x4 = startx >> 2, y4 = starty >> 2;
        int w4 = 1 << (kTW[t] - 2), h4 = 1 << (kTH[t] - 2);
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int tsctx = (tx_sqr(t) + tx_sqr_up(t) + 1) >> 1;
        int ptype = p > 0;
        int awl = std::min<int>(kTW[t], 5), ahl = std::min<int>(kTH[t], 5);
        int tw = 1 << awl, th = 1 << ahl;
        int area = tw * th;
        std::memset(quant, 0, sizeof(int32_t) * area);
        int maxx4 = fh.mi_cols >> sx, maxy4 = fh.mi_rows >> sy;
        int pb = p ? plane_block(mi_size, ssx, ssy) : mi_size;
        // all_zero context
        int ctx;
        if (p == 0) {
            int top = 0, left = 0;
            for (int k = 0; k < w4; k++)
                if (x4 + k < maxx4) top = std::max<int>(top, above_level[p][x4 + k]);
            for (int k = 0; k < h4; k++)
                if (y4 + k < maxy4) left = std::max<int>(left, left_level[p][y4 + k]);
            if (kBW[pb] == kTW[t] && kBH[pb] == kTH[t]) ctx = 0;
            else if (top == 0 && left == 0) ctx = 1;
            else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
            else if (std::max(top, left) <= 3) ctx = 4;
            else if (std::min(top, left) <= 3) ctx = 5;
            else ctx = 6;
        } else {
            int above = 0, left = 0;
            for (int i = 0; i < w4; i++)
                if (x4 + i < maxx4) above |= above_level[p][x4 + i] | above_dc[p][x4 + i];
            for (int i = 0; i < h4; i++)
                if (y4 + i < maxy4) left |= left_level[p][y4 + i] | left_dc[p][y4 + i];
            ctx = (above != 0) + (left != 0) + 7;
            if (kBW[pb] + kBH[pb] > kTW[t] + kTH[t]) ctx += 3;
        }
        int all_zero = ec.read(cdf.txb_skip[tsctx][ctx], 2);
        int eob = 0, cul = 0, dccat = 0;
        if (all_zero) {
            if (p == 0 && use_intrabc) tx_types[(size_t)y4 * mi_stride + x4] = DCT_DCT;
            else if (p == 0)
                for (int j = 0; j < h4; j++)
                    for (int i = 0; i < w4; i++) tx_types[(size_t)(y4 + j) * mi_stride + x4 + i] = DCT_DCT;
        } else {
            if (p == 0 && use_intrabc) read_tx_type_inter(t, x4, y4);
            else if (p == 0) read_tx_type(t, x4, y4);
            plane_tx_type = compute_tx_type(p, t, x4, y4);
            int cls = tx_class(plane_tx_type);
            const int16_t* scan = &kScanPool[kScanOffset[kScanOf[t][plane_tx_type]]];
            int ems = awl + ahl - 4;
            int ectx = cls == CLASS_2D ? 0 : 1;
            int eob_pt;
            switch (ems) {
                case 0: eob_pt = ec.read(cdf.eob16[ptype][ectx], 5) + 1; break;
                case 1: eob_pt = ec.read(cdf.eob32[ptype][ectx], 6) + 1; break;
                case 2: eob_pt = ec.read(cdf.eob64[ptype][ectx], 7) + 1; break;
                case 3: eob_pt = ec.read(cdf.eob128[ptype][ectx], 8) + 1; break;
                case 4: eob_pt = ec.read(cdf.eob256[ptype][ectx], 9) + 1; break;
                case 5: eob_pt = ec.read(cdf.eob512[ptype][ectx], 10) + 1; break;
                default: eob_pt = ec.read(cdf.eob1024[ptype][ectx], 11) + 1; break;
            }
            eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
            int shift = eob_pt - 3;
            if (shift >= 0) {
                if (ec.read(cdf.eob_extra[tsctx][ptype][eob_pt - 3], 2)) eob += 1 << shift;
                for (int i = 1; i < std::max(0, eob_pt - 2); i++) {
                    shift = std::max(0, eob_pt - 2) - 1 - i;
                    if (ec.lit(1)) eob += 1 << shift;
                }
            }
            static const int sig_ref[3][5][2] = {{{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
                                                 {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
                                                 {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
            static const int mag_ref[3][3][2] = {{{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}},
                                                 {{0, 1}, {1, 0}, {2, 0}}};
            for (int c = eob - 1; c >= 0; c--) {
                int pos = scan[c];
                int row = pos >> awl, col = pos & (tw - 1);
                int level;
                if (c == eob - 1) {
                    int ctxe = c == 0 ? 0 : c <= area / 8 ? 1 : c <= area / 4 ? 2 : 3;
                    level = ec.read(cdf.base_eob[tsctx][ptype][ctxe], 3) + 1;
                } else {
                    int mag = 0;
                    for (int k = 0; k < 5; k++) {
                        int rr = row + sig_ref[cls][k][0], cc = col + sig_ref[cls][k][1];
                        if (rr < th && cc < tw) mag += std::min<int>(quant[(rr << awl) + cc], 3);
                    }
                    int cx = std::min((mag + 1) >> 1, 4);
                    if (cls == CLASS_2D) {
                        if (pos == 0) cx = 0;
                        else cx += kNzMapCtxOffset[t][pos];
                    } else {
                        int idx = cls == CLASS_VERT ? row : col;
                        cx += idx == 0 ? 26 : idx == 1 ? 31 : 36;
                    }
                    level = ec.read(cdf.base[tsctx][ptype][cx], 4);
                }
                if (level > 2) {
                    int mag = 0;
                    for (int k = 0; k < 3; k++) {
                        int rr = row + mag_ref[cls][k][0], cc = col + mag_ref[cls][k][1];
                        if (rr < th && cc < tw) mag += std::min<int>(quant[(rr << awl) + cc], 15);
                    }
                    mag = std::min((mag + 1) >> 1, 6);
                    int cx;
                    if (pos == 0) cx = mag;
                    else if (cls == CLASS_2D) cx = (row < 2 && col < 2) ? mag + 7 : mag + 14;
                    else if (cls == CLASS_HORIZ) cx = col == 0 ? mag + 7 : mag + 14;
                    else cx = row == 0 ? mag + 7 : mag + 14;
                    for (int idx = 0; idx < 4; idx++) {
                        int br = ec.read(cdf.br[std::min(tsctx, 3)][ptype][cx], 4);
                        level += br;
                        if (br < 3) break;
                    }
                }
                quant[pos] = level;
            }
            // signs, golomb, dequantisation
            int dcq = get_dc_q(p), acq = get_ac_q(p);
            int qml = p == 0 ? fh.qm_y : p == 1 ? fh.qm_u : fh.qm_v;
            // libaom weights only 2-D transforms (identity and 1-D ones flat)
            bool use_qm = fh.using_qmatrix && !lossless && qml < 15 && plane_tx_type < IDTX;
            const uint8_t* qm = nullptr;
            if (use_qm) {
                static const int qm_off[14][2] = {{2, 2}, {3, 3}, {4, 4}, {5, 5}, {2, 3}, {3, 2}, {3, 4},
                                                  {4, 3}, {4, 5}, {5, 4}, {2, 4}, {4, 2}, {3, 5}, {5, 3}};
                int off = 0;
                for (int k = 0; k < 14; k++) {
                    if (qm_off[k][0] == awl && qm_off[k][1] == ahl) break;
                    off += 1 << (qm_off[k][0] + qm_off[k][1]);
                }
                qm = &kQmIwt[qml][ptype][off];
            }
            int pels = (1 << kTW[t]) * (1 << kTH[t]);
            int dq_shift = (pels > 256) + (pels > 1024);
            std::memset(dequant, 0, sizeof(int32_t) * area);
            for (int c = 0; c < eob; c++) {
                int pos = scan[c];
                int level = quant[pos];
                if (!level) continue;
                int sign;
                if (c == 0) {
                    int dcs = 0;
                    for (int k = 0; k < w4; k++)
                        if (x4 + k < maxx4) {
                            int s = above_dc[p][x4 + k];
                            if (s == 1) dcs--;
                            else if (s == 2) dcs++;
                        }
                    for (int k = 0; k < h4; k++)
                        if (y4 + k < maxy4) {
                            int s = left_dc[p][y4 + k];
                            if (s == 1) dcs--;
                            else if (s == 2) dcs++;
                        }
                    int sctx = dcs < 0 ? 1 : dcs > 0 ? 2 : 0;
                    sign = ec.read(cdf.dc_sign[ptype][sctx], 2);
                } else {
                    sign = ec.lit(1);
                }
                if (level > 14) {
                    int length = 0, b = 0;
                    do {
                        length++;
                        b = ec.lit(1);
                        if (length > 20) fail("invalid golomb length");
                    } while (!b);
                    int x = 1;
                    for (int i = length - 2; i >= 0; i--) x = (x << 1) | ec.lit(1);
                    level = x + 14;
                }
                if (pos == 0) dccat = sign ? 1 : 2;
                level &= 0xFFFFF;
                cul += level;
                int dqv = pos == 0 ? dcq : acq;
                if (qm) dqv = (qm[pos] * dqv + 16) >> 5;
                int64_t dq = ((int64_t)level * dqv) & 0xFFFFFF;
                dq >>= dq_shift;
                if (sign) dq = -dq;
                dequant[pos] = (int32_t)clip3(-(1 << 15), (1 << 15) - 1, (int)dq);
            }
            cul = std::min(63, cul);
        }
        for (int i = 0; i < w4; i++) {
            above_level[p][x4 + i] = (uint8_t)cul;
            above_dc[p][x4 + i] = (uint8_t)dccat;
        }
        for (int i = 0; i < h4; i++) {
            left_level[p][y4 + i] = (uint8_t)cul;
            left_dc[p][y4 + i] = (uint8_t)dccat;
        }
        return eob;
    }

    // ------------------------------------------------------------ intra prediction
    uint8_t px(int p, int y, int x) { return cur.p[p][(size_t)y * cur.stride[p] + x]; }
    bool is_smooth(int r, int c, int p) {
        int m = p == 0 ? at(r, c).ymode : at(r, c).uvmode;
        return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
    }
    int filter_type(int p) {
        int as = 0, ls = 0;
        if (p == 0 ? avail_u : avail_u_chroma) {
            int r = mi_row - 1, c = mi_col;
            if (p > 0) {
                if (ssx && !(mi_col & 1)) c++;
                if (ssy && (mi_row & 1)) r--;
            }
            as = is_smooth(r, c, p);
        }
        if (p == 0 ? avail_l : avail_l_chroma) {
            int r = mi_row, c = mi_col - 1;
            if (p > 0) {
                if (ssx && (mi_col & 1)) c--;
                if (ssy && !(mi_row & 1)) r++;
            }
            ls = is_smooth(r, c, p);
        }
        return as || ls;
    }
    static int edge_strength(int w, int h, int delta, int type) {
        int d = std::abs(delta), wh = w + h, s = 0;
        if (type == 0) {
            if (wh <= 8) { if (d >= 56) s = 1; }
            else if (wh <= 12) { if (d >= 40) s = 1; }
            else if (wh <= 16) { if (d >= 40) s = 1; }
            else if (wh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
            else if (wh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
            else { if (d >= 1) s = 3; }
        } else {
            if (wh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
            else if (wh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
            else if (wh <= 24) { if (d >= 4) s = 3; }
            else { if (d >= 1) s = 3; }
        }
        return s;
    }
    static int use_upsample(int w, int h, int delta, int type) {
        int d = std::abs(delta), wh = w + h;
        if (d <= 0 || d >= 40) return 0;
        return type ? (wh <= 8) : (wh <= 16);
    }
    static void edge_filter(int* e, int sz, int strength) {
        // e points at index -1 of the edge; filters e[0 .. sz-1] (spec's
        // edge[i - 1] for i < sz) in place
        if (!strength) return;
        static const int k[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
        int tmp[300];
        for (int i = 0; i < sz; i++) tmp[i] = e[i];
        for (int i = 1; i < sz; i++) {
            int s = 0;
            for (int j = 0; j < 5; j++) {
                int kk = clip3(0, sz - 1, i - 2 + j);
                s += k[strength - 1][j] * tmp[kk];
            }
            e[i] = (s + 8) >> 4;
        }
    }
    static void edge_upsample(int* buf, int num) {
        // buf points at index 0 of the edge (buf[-1] is the corner); writes
        // buf[-2 .. 2*num-2]
        int dup[300];
        dup[0] = buf[-1];
        for (int i = -1; i < num; i++) dup[i + 2] = buf[i];
        dup[num + 2] = buf[num - 1];
        buf[-2] = dup[0];
        for (int i = 0; i < num; i++) {
            int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
            s = clip1(round2(s, 4));
            buf[2 * i - 1] = s;
            buf[2 * i] = dup[i + 2];
        }
    }

    void predict_intra(int p, int x, int y, int have_left, int have_above, int have_ar, int have_bl, int mode,
                       int wl, int hl) {
        int w = 1 << wl, h = 1 << hl;
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int maxx = ((fh.mi_cols * 4) >> sx) - 1, maxy = ((fh.mi_rows * 4) >> sy) - 1;
        int above_buf[300], left_buf[300];
        int* above = above_buf + 16;
        int* left = left_buf + 16;
        int n = w + h;
        if (!have_above && have_left) {
            for (int i = 0; i < n; i++) above[i] = px(p, y, x - 1);
        } else if (!have_above && !have_left) {
            for (int i = 0; i < n; i++) above[i] = 127;
        } else {
            int lim = std::min(maxx, x + (have_ar ? 2 * w : w) - 1);
            for (int i = 0; i < n; i++) above[i] = px(p, y - 1, std::min(lim, x + i));
        }
        if (!have_left && have_above) {
            for (int i = 0; i < n; i++) left[i] = px(p, y - 1, x);
        } else if (!have_left && !have_above) {
            for (int i = 0; i < n; i++) left[i] = 129;
        } else {
            int lim = std::min(maxy, y + (have_bl ? 2 * h : h) - 1);
            for (int i = 0; i < n; i++) left[i] = px(p, std::min(lim, y + i), x - 1);
        }
        if (have_above && have_left) above[-1] = px(p, y - 1, x - 1);
        else if (have_above) above[-1] = px(p, y - 1, x);
        else if (have_left) above[-1] = px(p, y, x - 1);
        else above[-1] = 128;
        left[-1] = above[-1];
        uint8_t* dst = &cur.p[p][(size_t)y * cur.stride[p] + x];
        int stride = cur.stride[p];
        if (p == 0 && use_filter_intra) {
            int pred[64][64];
            int w4 = w >> 2, h2 = h >> 1;
            for (int i2 = 0; i2 < h2; i2++)
                for (int j4 = 0; j4 < w4; j4++) {
                    int pp[7];
                    for (int i = 0; i < 7; i++) {
                        if (i < 5) {
                            if (i2 == 0) pp[i] = above[(j4 << 2) + i - 1];
                            else if (j4 == 0 && i == 0) pp[i] = left[(i2 << 1) - 1];
                            else pp[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
                        } else {
                            if (j4 == 0) pp[i] = left[(i2 << 1) + i - 5];
                            else pp[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
                        }
                    }
                    for (int i = 0; i < 8; i++) {
                        int pr = 0;
                        for (int j = 0; j < 7; j++) pr += kFilterIntraTaps[filter_intra_mode][i][j] * pp[j];
                        int v = pr >= 0 ? round2(pr, 4) : -round2(-pr, 4);
                        pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = clip1(v);
                    }
                }
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) dst[i * stride + j] = (uint8_t)pred[i][j];
            return;
        }
        if (mode >= V_PRED && mode <= D67_PRED) {
            int pangle = kModeToAngle[mode] + (p == 0 ? angle_y : angle_uv) * 3;
            int up_above = 0, up_left = 0;
            if (seq.enable_intra_edge) {
                if (pangle != 90 && pangle != 180) {
                    if (pangle > 90 && pangle < 180 && (w + h) >= 24) {
                        int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
                        left[-1] = above[-1] = v;
                    }
                    int ft = filter_type(p);
                    if (have_above) {
                        int s = edge_strength(w, h, pangle - 90, ft);
                        int npx = std::min(w, maxx - x + 1) + (pangle < 90 ? h : 0) + 1;
                        edge_filter(above - 1, npx, s);
                    }
                    if (have_left) {
                        int s = edge_strength(w, h, pangle - 180, ft);
                        int npx = std::min(h, maxy - y + 1) + (pangle > 180 ? w : 0) + 1;
                        edge_filter(left - 1, npx, s);
                    }
                }
                int ft = filter_type(p);
                up_above = use_upsample(w, h, pangle - 90, ft);
                if (up_above) edge_upsample(above, w + (pangle < 90 ? h : 0));
                up_left = use_upsample(w, h, pangle - 180, ft);
                if (up_left) edge_upsample(left, h + (pangle > 180 ? w : 0));
            }
            int dx = 0, dy = 0;
            if (pangle < 90) dx = kDrIntraDerivative[pangle];
            else if (pangle > 90 && pangle < 180) dx = kDrIntraDerivative[180 - pangle];
            if (pangle > 90 && pangle < 180) dy = kDrIntraDerivative[pangle - 90];
            else if (pangle > 180) dy = kDrIntraDerivative[270 - pangle];
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) {
                    int pred;
                    if (pangle < 90) {
                        int idx = (i + 1) * dx;
                        int base = (idx >> (6 - up_above)) + (j << up_above);
                        int shift = ((idx << up_above) >> 1) & 0x1F;
                        int maxb = (w + h - 1) << up_above;
                        if (base < maxb) pred = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                        else pred = above[maxb];
                    } else if (pangle > 90 && pangle < 180) {
                        int idx = (j << 6) - (i + 1) * dx;
                        int base = idx >> (6 - up_above);
                        if (base >= -(1 << up_above)) {
                            int shift = ((idx * (1 << up_above)) & 0x3F) >> 1;
                            pred = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                        } else {
                            idx = (i << 6) - (j + 1) * dy;
                            base = idx >> (6 - up_left);
                            int shift = ((idx * (1 << up_left)) & 0x3F) >> 1;
                            pred = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                        }
                    } else if (pangle > 180) {
                        int idx = (j + 1) * dy;
                        int base = (idx >> (6 - up_left)) + (i << up_left);
                        int shift = ((idx << up_left) >> 1) & 0x1F;
                        int maxb = (w + h - 1) << up_left;
                        if (base < maxb) pred = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                        else pred = left[maxb];
                    } else if (pangle == 90) {
                        pred = above[j];
                    } else {
                        pred = left[i];
                    }
                    dst[i * stride + j] = (uint8_t)pred;
                }
            return;
        }
        if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
            const uint8_t* ww = kSmoothWeights + (w - 4);
            const uint8_t* wh = kSmoothWeights + (h - 4);
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) {
                    int v;
                    if (mode == SMOOTH_PRED)
                        v = round2(wh[i] * above[j] + (256 - wh[i]) * left[h - 1] + ww[j] * left[i] +
                                       (256 - ww[j]) * above[w - 1], 9);
                    else if (mode == SMOOTH_V_PRED)
                        v = round2(wh[i] * above[j] + (256 - wh[i]) * left[h - 1], 8);
                    else
                        v = round2(ww[j] * left[i] + (256 - ww[j]) * above[w - 1], 8);
                    dst[i * stride + j] = (uint8_t)v;
                }
            return;
        }
        if (mode == DC_PRED) {
            int avg;
            if (have_left && have_above) {
                int sum = 0;
                for (int k = 0; k < w; k++) sum += above[k];
                for (int k = 0; k < h; k++) sum += left[k];
                avg = (sum + ((w + h) >> 1)) / (w + h);
            } else if (have_left) {
                int sum = 0;
                for (int k = 0; k < h; k++) sum += left[k];
                avg = (sum + (h >> 1)) >> hl;
            } else if (have_above) {
                int sum = 0;
                for (int k = 0; k < w; k++) sum += above[k];
                avg = (sum + (w >> 1)) >> wl;
            } else {
                avg = 128;
            }
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) dst[i * stride + j] = (uint8_t)avg;
            return;
        }
        // PAETH
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int base = above[j] + left[i] - above[-1];
                int pl = std::abs(base - left[i]), pt = std::abs(base - above[j]), ptl = std::abs(base - above[-1]);
                int v;
                if (pl <= pt && pl <= ptl) v = left[i];
                else if (pt <= ptl) v = above[j];
                else v = above[-1];
                dst[i * stride + j] = (uint8_t)v;
            }
    }

    void predict_cfl(int p, int startx, int starty, int t) {
        int w = 1 << kTW[t], h = 1 << kTH[t];
        int alpha = p == 1 ? cfl_u : cfl_v;
        static int L[64][64];
        int64_t avg = 0;
        for (int i = 0; i < h; i++) {
            int ly = std::min(max_luma_h - (1 << ssy), (starty + i) << ssy);
            for (int j = 0; j < w; j++) {
                int lx = std::min(max_luma_w - (1 << ssx), (startx + j) << ssx);
                int s = 0;
                for (int dy = 0; dy <= ssy; dy++)
                    for (int dx = 0; dx <= ssx; dx++) s += px(0, ly + dy, lx + dx);
                int v = s << (3 - ssx - ssy);
                L[i][j] = v;
                avg += v;
            }
        }
        int a = round2(avg, kTW[t] + kTH[t]);
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                uint8_t& d = cur.p[p][(size_t)(starty + i) * cur.stride[p] + startx + j];
                int m = alpha * (L[i][j] - a);
                int sc = m >= 0 ? round2(m, 6) : -round2(-m, 6);
                d = (uint8_t)clip1(d + sc);
            }
    }

    // ------------------------------------------------------------ loop filter
    void loop_filter() {
        if (!fh.lf_level[0] && !fh.lf_level[1]) return;
        for (int p = 0; p < num_planes; p++) {
            if (p == 0 && !fh.lf_level[0] && !fh.lf_level[1]) break;
            if (p > 0 && !fh.lf_level[p + 1]) continue;
            for (int pass = 0; pass < 2; pass++) {
                int rs = p == 0 ? 1 : (1 << ssy), cs = p == 0 ? 1 : (1 << ssx);
                for (int r = 0; r < fh.mi_rows; r += rs)
                    for (int c = 0; c < fh.mi_cols; c += cs) edge_lf(p, pass, r, c);
            }
        }
    }
    int filter_level(int r, int c, int p, int pass) {
        MiInfo& m = at(r, c);
        int i = p == 0 ? pass : p + 1;
        int dlf = fh.delta_lf_multi ? m.dlf[i] : m.dlf[0];
        int lvl = fh.delta_lf_present ? clip3(0, 63, dlf + fh.lf_level[i]) : fh.lf_level[i];
        int feat = 1 + i;
        if (fh.seg_enabled && fh.feature_enabled[m.seg][feat])
            lvl = clip3(0, 63, lvl + fh.feature_data[m.seg][feat]);
        if (fh.lf_delta_enabled) {
            int ns = lvl >> 5;
            lvl = clip3(0, 63, lvl + fh.lf_ref_deltas[0] * (1 << ns));
        }
        return lvl;
    }
    void edge_lf(int p, int pass, int row, int col) {
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int dx = pass == 0, dy = pass == 1;
        int x = col * 4, y = row * 4;
        row |= sy;
        col |= sx;
        if (x >= fh.w || y >= fh.h) return;
        if (pass == 0 && x == 0) return;
        if (pass == 1 && y == 0) return;
        int xp = x >> sx, yp = y >> sy;
        int prow = row - (dy << sy), pcol = col - (dx << sx);
        int t = lf_tx[p][(size_t)(row >> sy) * lf_stride[p] + (col >> sx)];
        int pt = lf_tx[p][(size_t)(prow >> sy) * lf_stride[p] + (pcol >> sx)];
        int is_tx_edge = pass == 0 ? (xp % (1 << kTW[t]) == 0) : (yp % (1 << kTH[t]) == 0);
        if (!is_tx_edge) return;
        int base = pass == 0 ? std::min(1 << kTW[pt], 1 << kTW[t]) : std::min(1 << kTH[pt], 1 << kTH[t]);
        int fsize = p == 0 ? std::min(16, base) : std::min(8, base);
        int lvl = filter_level(row, col, p, pass);
        if (lvl == 0) lvl = filter_level(prow, pcol, p, pass);
        if (lvl == 0) return;
        int shift = fh.lf_sharpness > 4 ? 2 : (fh.lf_sharpness > 0 ? 1 : 0);
        int limit = fh.lf_sharpness > 0 ? clip3(1, 9 - fh.lf_sharpness, lvl >> shift) : std::max(1, lvl >> shift);
        int blimit = 2 * (lvl + 2) + limit;
        int thresh = lvl >> 4;
        for (int i = 0; i < 4; i++) {
            int xx = xp + dy * i, yy = yp + dx * i;
            uint8_t* s = &cur.p[p][(size_t)yy * cur.stride[p] + xx];
            int step = pass == 0 ? 1 : cur.stride[p];
            sample_filter(s, step, limit, blimit, thresh, fsize, p);
        }
    }
    static inline int8_t sclamp(int t) { return (int8_t)(t < -128 ? -128 : t > 127 ? 127 : t); }
    static void filter4(int mask, int thresh, uint8_t* op1, uint8_t* op0, uint8_t* oq0, uint8_t* oq1) {
        int8_t ps1 = (int8_t)(*op1 ^ 0x80), ps0 = (int8_t)(*op0 ^ 0x80), qs0 = (int8_t)(*oq0 ^ 0x80),
               qs1 = (int8_t)(*oq1 ^ 0x80);
        int8_t hev = (std::abs(*op1 - *op0) > thresh || std::abs(*oq1 - *oq0) > thresh) ? -1 : 0;
        int8_t m = mask ? -1 : 0;
        int8_t filter = sclamp(ps1 - qs1) & hev;
        filter = sclamp(filter + 3 * (qs0 - ps0)) & m;
        int8_t f1 = sclamp(filter + 4) >> 3;
        int8_t f2 = sclamp(filter + 3) >> 3;
        *oq0 = (uint8_t)(sclamp(qs0 - f1) ^ 0x80);
        *op0 = (uint8_t)(sclamp(ps0 + f2) ^ 0x80);
        filter = (int8_t)(((f1 + 1) >> 1) & ~hev);
        *oq1 = (uint8_t)(sclamp(qs1 - filter) ^ 0x80);
        *op1 = (uint8_t)(sclamp(ps1 + filter) ^ 0x80);
    }
    static void sample_filter(uint8_t* s, int step, int limit, int blimit, int thresh, int size, int plane) {
        auto P = [&](int k) -> uint8_t& { return s[-(k + 1) * step]; };
        auto Q = [&](int k) -> uint8_t& { return s[k * step]; };
        int p0 = P(0), p1 = P(1), q0 = Q(0), q1 = Q(1);
        if (size == 4) {
            bool mask = std::abs(p1 - p0) <= limit && std::abs(q1 - q0) <= limit &&
                        std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 <= blimit;
            filter4(mask, thresh, &P(1), &P(0), &Q(0), &Q(1));
            return;
        }
        int p2 = P(2), q2 = Q(2);
        if (size == 8 && plane > 0) {
            bool mask = std::abs(p2 - p1) <= limit && std::abs(p1 - p0) <= limit && std::abs(q1 - q0) <= limit &&
                        std::abs(q2 - q1) <= limit && std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 <= blimit;
            bool flat = std::abs(p1 - p0) <= 1 && std::abs(q1 - q0) <= 1 && std::abs(p2 - p0) <= 1 &&
                        std::abs(q2 - q0) <= 1;
            if (flat && mask) {
                P(1) = (uint8_t)round2(p2 * 3 + p1 * 2 + p0 * 2 + q0, 3);
                P(0) = (uint8_t)round2(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1, 3);
                Q(0) = (uint8_t)round2(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2, 3);
                Q(1) = (uint8_t)round2(p0 + q0 * 2 + q1 * 2 + q2 * 3, 3);
            } else {
                filter4(mask, thresh, &P(1), &P(0), &Q(0), &Q(1));
            }
            return;
        }
        int p3 = P(3), q3 = Q(3);
        bool mask = std::abs(p3 - p2) <= limit && std::abs(p2 - p1) <= limit && std::abs(p1 - p0) <= limit &&
                    std::abs(q1 - q0) <= limit && std::abs(q2 - q1) <= limit && std::abs(q3 - q2) <= limit &&
                    std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 <= blimit;
        bool flat = std::abs(p1 - p0) <= 1 && std::abs(q1 - q0) <= 1 && std::abs(p2 - p0) <= 1 &&
                    std::abs(q2 - q0) <= 1 && std::abs(p3 - p0) <= 1 && std::abs(q3 - q0) <= 1;
        if (size == 16) {
            int p4 = P(4), p5 = P(5), p6 = P(6), q4 = Q(4), q5 = Q(5), q6 = Q(6);
            bool flat2 = std::abs(p4 - p0) <= 1 && std::abs(q4 - q0) <= 1 && std::abs(p5 - p0) <= 1 &&
                         std::abs(q5 - q0) <= 1 && std::abs(p6 - p0) <= 1 && std::abs(q6 - q0) <= 1;
            if (flat2 && flat && mask) {
                P(5) = (uint8_t)round2(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0, 4);
                P(4) = (uint8_t)round2(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1, 4);
                P(3) = (uint8_t)round2(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2, 4);
                P(2) = (uint8_t)round2(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3, 4);
                P(1) = (uint8_t)round2(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4, 4);
                P(0) = (uint8_t)round2(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5, 4);
                Q(0) = (uint8_t)round2(p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6, 4);
                Q(1) = (uint8_t)round2(p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2, 4);
                Q(2) = (uint8_t)round2(p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3, 4);
                Q(3) = (uint8_t)round2(p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4, 4);
                Q(4) = (uint8_t)round2(p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5, 4);
                Q(5) = (uint8_t)round2(p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7, 4);
                return;
            }
        }
        if (flat && mask) {
            P(2) = (uint8_t)round2(p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0, 3);
            P(1) = (uint8_t)round2(p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1, 3);
            P(0) = (uint8_t)round2(p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2, 3);
            Q(0) = (uint8_t)round2(p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3, 3);
            Q(1) = (uint8_t)round2(p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3, 3);
            Q(2) = (uint8_t)round2(p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3, 3);
        } else {
            filter4(mask, thresh, &P(1), &P(0), &Q(0), &Q(1));
        }
    }

    // ------------------------------------------------------------ CDEF
    static int cdef_find_dir(const uint8_t* img, int stride, int* var) {
        int cost[8] = {0};
        int partial[8][15] = {{0}};
        static const int div_table[] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++) {
                int x = img[i * stride + j] - 128;
                partial[0][i + j] += x;
                partial[1][i + j / 2] += x;
                partial[2][i] += x;
                partial[3][3 + i - j / 2] += x;
                partial[4][7 + i - j] += x;
                partial[5][3 - i / 2 + j] += x;
                partial[6][j] += x;
                partial[7][i / 2 + j] += x;
            }
        for (int i = 0; i < 8; i++) {
            cost[2] += partial[2][i] * partial[2][i];
            cost[6] += partial[6][i] * partial[6][i];
        }
        cost[2] *= div_table[8];
        cost[6] *= div_table[8];
        for (int i = 0; i < 7; i++) {
            cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) * div_table[i + 1];
            cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) * div_table[i + 1];
        }
        cost[0] += partial[0][7] * partial[0][7] * div_table[8];
        cost[4] += partial[4][7] * partial[4][7] * div_table[8];
        for (int i = 1; i < 8; i += 2) {
            for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
            cost[i] *= div_table[8];
            for (int j = 0; j < 3; j++)
                cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) * div_table[2 * j + 2];
        }
        int best_cost = 0, best_dir = 0;
        for (int i = 0; i < 8; i++)
            if (cost[i] > best_cost) {
                best_cost = cost[i];
                best_dir = i;
            }
        *var = (best_cost - cost[(best_dir + 4) & 7]) >> 10;
        return best_dir;
    }
    // libaom's constrain, its shift max(0, damping - msb(threshold)) given
    static inline int constrain(int diff, int threshold, int shift) {
        if (!threshold) return 0;
        int ad = std::abs(diff);
        int v = std::min(ad, std::max(0, threshold - (ad >> shift)));
        return diff < 0 ? -v : v;
    }
    void cdef() {
        if (fh.coded_lossless || fh.allow_intrabc || !seq.enable_cdef) return;
        // libaom's layout: each plane's deblocked samples as int16 with a
        // border of 2 that holds CDEF_VERY_LARGE (outside the frame's 4x4
        // area: no tap there adds to the sum, the max or the min)
        const int16_t kLarge = 30000;
        std::vector<int16_t> pad[3];
        int pstride[3];
        for (int p = 0; p < num_planes; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int pw = (fh.mi_cols * 4) >> sx, ph = (fh.mi_rows * 4) >> sy;
            pstride[p] = pw + 4;
            pad[p].assign((size_t)(ph + 4) * pstride[p], kLarge);
            for (int y = 0; y < ph; y++)
                for (int x = 0; x < pw; x++)
                    pad[p][(size_t)(y + 2) * pstride[p] + x + 2] = cur.p[p][(size_t)y * cur.stride[p] + x];
        }
        if (fh.uses_lr) deblocked = cur;  // loop restoration reads it past its stripes
        static const int dirs[8][2][2] = {{{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}}, {{0, 1}, {1, 2}},
                                          {{1, 1}, {2, 2}},   {{1, 0}, {2, 1}},  {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}}};
        static const int pri_taps[2][2] = {{4, 2}, {3, 3}};
        static const int sec_taps[2] = {2, 1};
        for (int r = 0; r < fh.mi_rows; r += 2)
            for (int c = 0; c < fh.mi_cols; c += 2) {
                int idx = cdef_at(r & ~15, c & ~15);
                if (idx == -1) continue;
                if (at(r, c).skip && at(r + 1, c).skip && at(r, c + 1).skip && at(r + 1, c + 1).skip) continue;
                int var = 0;
                int ydir = cdef_find_dir(&cur.p[0][(size_t)(r * 4) * cur.stride[0] + c * 4], cur.stride[0], &var);
                for (int p = 0; p < num_planes; p++) {
                    int pri = p == 0 ? fh.cdef_y_pri[idx] : fh.cdef_uv_pri[idx];
                    int sec = p == 0 ? fh.cdef_y_sec[idx] : fh.cdef_uv_sec[idx];
                    // libaom remaps the chroma direction where the
                    // subsampling differs by axis (conv422)
                    int cdir = p > 0 && ssx != ssy ? kConv422[ydir] : ydir;
                    int dir = pri == 0 ? 0 : cdir;
                    int damping = fh.cdef_damping - (p > 0);
                    if (p == 0) {
                        int vs = (var >> 6) ? std::min(floor_log2(var >> 6), 12) : 0;
                        pri = var ? (pri * (4 + vs) + 8) >> 4 : 0;
                    }
                    if (!pri && !sec) continue;
                    if (p > 0 && ssx != ssy && pri && cdir != ydir) g_counters[C_CDEF_422_REMAPPED]++;
                    int pri_shift = pri ? std::max(0, damping - floor_log2(pri)) : 0;
                    int sec_shift = sec ? std::max(0, damping - floor_log2(sec)) : 0;
                    int sx = p ? ssx : 0, sy = p ? ssy : 0;
                    int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy;
                    int w = 8 >> sx, h = 8 >> sy, ps = pstride[p];
                    const int* pt = pri_taps[pri & 1];
                    int po[2], so[2][2];
                    for (int k = 0; k < 2; k++) {
                        po[k] = dirs[dir][k][0] * ps + dirs[dir][k][1];
                        so[k][0] = dirs[(dir + 2) & 7][k][0] * ps + dirs[(dir + 2) & 7][k][1];
                        so[k][1] = dirs[(dir - 2) & 7][k][0] * ps + dirs[(dir - 2) & 7][k][1];
                    }
                    for (int i = 0; i < h; i++)
                        for (int j = 0; j < w; j++) {
                            const int16_t* q = &pad[p][(size_t)(y0 + i + 2) * ps + x0 + j + 2];
                            int x = q[0], sum = 0, mx = x, mn = x;
                            for (int k = 0; k < 2; k++) {
                                int taps[6] = {q[po[k]], q[-po[k]], q[so[k][0]], q[-so[k][0]], q[so[k][1]],
                                               q[-so[k][1]]};
                                for (int t = 0; t < 6; t++) {
                                    int v = taps[t];
                                    sum += (t < 2 ? pt[k] * constrain(v - x, pri, pri_shift)
                                                  : sec_taps[k] * constrain(v - x, sec, sec_shift));
                                    if (v != kLarge) mx = std::max(v, mx);
                                    mn = std::min(v, mn);
                                }
                            }
                            cur.p[p][(size_t)(y0 + i) * cur.stride[p] + x0 + j] =
                                (uint8_t)clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4));
                        }
                }
            }
    }
    Frame deblocked;

    // ------------------------------------------------------------ loop restoration
    int stripe_start, stripe_end, plane_end_x, plane_end_y;
    int src_sample(const Frame& cdefd, int p, int x, int y) {
        x = std::max(0, std::min(plane_end_x, x));
        y = std::max(0, std::min(plane_end_y, y));
        if (y < stripe_start) {
            y = std::max(stripe_start - 2, y);
            return deblocked.p[p][(size_t)y * deblocked.stride[p] + x];
        }
        if (y > stripe_end) {
            y = std::min(stripe_end + 2, y);
            return deblocked.p[p][(size_t)y * deblocked.stride[p] + x];
        }
        return cdefd.p[p][(size_t)y * cdefd.stride[p] + x];
    }
    void loop_restoration() {
        if (!fh.uses_lr) return;
        if (deblocked.p[0].empty()) deblocked = cur;  // no CDEF: the deblocked frame is the input
        Frame cdefd = cur;
        for (int y = 0; y < fh.h; y += 4)
            for (int x = 0; x < fh.w; x += 4)
                for (int p = 0; p < num_planes; p++) {
                    if (!fh.lr_type[p]) continue;
                    lr_block(cdefd, p, y >> 2, x >> 2);
                }
    }
    void lr_block(const Frame& cdefd, int p, int row, int col) {
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int luma_y = row * 4;
        int stripe = (luma_y + 8) / 64;
        stripe_start = (-8 + stripe * 64) >> sy;
        stripe_end = stripe_start + (64 >> sy) - 1;
        int us = fh.lr_size[p];
        int ur = lr_unit_rows[p], uc = lr_unit_cols[p];
        int unit_row = std::min(ur - 1, ((row * 4 + 8) >> sy) / us);
        int unit_col = std::min(uc - 1, ((col * 4) >> sx) / us);
        plane_end_x = round2(fh.w, sx) - 1;
        plane_end_y = round2(fh.h, sy) - 1;
        int x = (col * 4) >> sx, y = (row * 4) >> sy;
        int w = std::min(4 >> sx, plane_end_x - x + 1), h = std::min(4 >> sy, plane_end_y - y + 1);
        const LrUnit& u = lr_units[p][(size_t)unit_row * uc + unit_col];
        if (u.type == 0) return;
        if (p > 0 && ssx != ssy) g_counters[C_LR_422_CHROMA]++;
        uint8_t* out = &cur.p[p][0];
        int stride = cur.stride[p];
        // the block's source samples, 3 around (the reach of both filters)
        int P[10][10];
        for (int i = 0; i < h + 6; i++)
            for (int j = 0; j < w + 6; j++) P[i][j] = src_sample(cdefd, p, x + j - 3, y + i - 3);
        if (u.type == 1) {
            int vf[7], hf[7];
            auto mk = [](const int8_t* c, int* f) {
                f[3] = 128;
                for (int i = 0; i < 3; i++) {
                    f[i] = c[i];
                    f[6 - i] = c[i];
                    f[3] -= 2 * c[i];
                }
            };
            mk(u.wiener[0], vf);
            mk(u.wiener[1], hf);
            int inter[10][4];
            int offset = 1 << (8 + 7 - 3 - 1), limit = (1 << (8 + 1 + 7 - 3)) - 1;
            for (int r = 0; r < h + 6; r++)
                for (int c = 0; c < w; c++) {
                    int s = 0;
                    for (int t = 0; t < 7; t++) s += hf[t] * P[r][c + t];
                    int v = round2(s, 3);
                    inter[r][c] = clip3(-offset, limit - offset, v);
                }
            for (int r = 0; r < h; r++)
                for (int c = 0; c < w; c++) {
                    int s = 0;
                    for (int t = 0; t < 7; t++) s += vf[t] * inter[r + t][c];
                    out[(size_t)(y + r) * stride + x + c] = (uint8_t)clip1(round2(s, 11));
                }
        } else if (u.type == 2) {
            int set = u.set;
            int r0 = kSgrParams[set][0], r1 = kSgrParams[set][1];
            int flt[2][4][4];
            for (int pass = 0; pass < 2; pass++) {
                int r = pass ? r1 : r0;
                if (!r) continue;
                box_filter(cdefd, P, p, x, y, w, h, r, kSgrParams[set][2 + pass], pass, flt[pass]);
            }
            int xq0, xq1;
            if (r0 == 0) {
                xq0 = 0;
                xq1 = 128 - u.xqd[1];
            } else if (r1 == 0) {
                xq0 = u.xqd[0];
                xq1 = 0;
            } else {
                xq0 = u.xqd[0];
                xq1 = 128 - xq0 - u.xqd[1];
            }
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) {
                    int uu = cdefd.p[p][(size_t)(y + i) * cdefd.stride[p] + x + j] << 4;
                    int v = uu << 7;
                    if (r0) v += xq0 * (flt[0][i][j] - uu);
                    if (r1) v += xq1 * (flt[1][i][j] - uu);
                    int16_t ww = (int16_t)round2(v, 11);
                    out[(size_t)(y + i) * stride + x + j] = (uint8_t)clip1(ww);
                }
        }
    }
    void box_filter(const Frame& cdefd, const int (*P)[10], int p, int x, int y, int w, int h, int r, int s,
                    int pass, int F[4][4]) {
        int n = (2 * r + 1) * (2 * r + 1);
        int A[6][6], B[6][6];
        for (int i = -1; i < h + 1; i++)
            for (int j = -1; j < w + 1; j++) {
                uint32_t a = 0, b = 0;
                for (int dy = -r; dy <= r; dy++)
                    for (int dx = -r; dx <= r; dx++) {
                        uint32_t c = (uint32_t)P[i + dy + 3][j + dx + 3];
                        a += c * c;
                        b += c;
                    }
                uint32_t pp = (a * n < b * b) ? 0 : a * n - b * b;
                uint32_t z = (uint32_t)(((uint64_t)pp * (uint32_t)s + (1u << 19)) >> 20);
                int a2 = (int)kXByXplus1[std::min<uint32_t>(z, 255)];
                uint32_t b2 = (uint32_t)(256 - a2) * b * (uint32_t)kOneByX[n - 1];
                A[i + 1][j + 1] = a2;
                B[i + 1][j + 1] = (int)((b2 + (1u << 11)) >> 12);
            }
        for (int i = 0; i < h; i++) {
            int shift = (pass == 0 && ((y + i) & 1)) ? 4 : 5;
            for (int j = 0; j < w; j++) {
                int a = 0, b = 0;
                for (int dy = -1; dy <= 1; dy++)
                    for (int dx = -1; dx <= 1; dx++) {
                        int wt;
                        if (pass == 0) wt = ((y + i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
                        else wt = (dx == 0 || dy == 0) ? 4 : 3;
                        a += wt * A[i + dy + 1][j + dx + 1];
                        b += wt * B[i + dy + 1][j + dx + 1];
                    }
                int v = a * cdefd.p[p][(size_t)(y + i) * cdefd.stride[p] + x + j] + b;
                F[i][j] = round2(v, 8 + shift - 4);
            }
        }
    }

    // ------------------------------------------------------------ OBUs
    bool seen_frame_header = false, frame_done = false;
    int obu_tid = 0, obu_sid = 0, expected_depth = 0;
    void tile_group(const uint8_t* data, size_t size) {
        BitReader rb(data, size);
        int num_tiles = fh.tile_cols * fh.tile_rows;
        int start = 0, end = num_tiles - 1;
        if (num_tiles > 1 && rb.f(1)) {
            int bits = fh.tile_cols_log2 + fh.tile_rows_log2;
            start = rb.f(bits);
            end = rb.f(bits);
            if (start != next_tile || end < start || end >= num_tiles) fail("bad tile group");
        } else if (next_tile != 0) {
            fail("bad tile group");
        }
        rb.byte_align();
        const uint8_t* p = data + rb.pos / 8;
        const uint8_t* e = data + size;
        for (int t = start; t <= end; t++) {
            size_t ts;
            if (t == end) {
                ts = (size_t)(e - p);
            } else {
                if ((size_t)(e - p) < (size_t)fh.tile_size_bytes) fail("not enough data to read tile size");
                ts = 0;
                for (int k = 0; k < fh.tile_size_bytes; k++) ts |= (size_t)p[k] << (8 * k);
                ts += 1;
                p += fh.tile_size_bytes;
                if (ts > (size_t)(e - p)) fail("truncated tile");
            }
            decode_tile(t / fh.tile_cols, t % fh.tile_cols, p, ts);
            p += ts;
        }
        next_tile = end + 1;
        if (end == num_tiles - 1) frame_done = true;
    }
    int next_tile = 0;

    void decode(const uint8_t* data, size_t size) {
        const uint8_t* p = data;
        const uint8_t* end = data + size;
        while (!frame_done) {
            if (p == end) {
                if (!seen_frame_header) fail("no frame in the stream");
                fail("frame data ends early");
            }
            // obu header
            int h0 = p[0];
            if (h0 & 0x80) fail("forbidden bit set");
            int type = (h0 >> 3) & 15, ext = (h0 >> 2) & 1, has_size = (h0 >> 1) & 1;
            size_t hdr = 1 + ext;
            if ((size_t)(end - p) < hdr) fail("truncated OBU header");
            int tid = 0, sid = 0;
            if (ext) {
                tid = p[1] >> 5;
                sid = (p[1] >> 3) & 3;
            }
            size_t payload;
            if (has_size) {
                uint64_t v = 0;
                size_t k = 0;
                for (;; k++) {
                    if (k >= 8 || hdr + k >= (size_t)(end - p)) fail("truncated OBU size");
                    uint8_t b = p[hdr + k];
                    v |= (uint64_t)(b & 0x7f) << (7 * k);
                    if (!(b & 0x80)) break;
                }
                hdr += k + 1;
                payload = (size_t)v;
            } else {
                payload = (size_t)(end - p) - hdr;
            }
            p += hdr;
            if ((size_t)(end - p) < payload) fail("OBU larger than the data");
            obu_tid = tid;
            obu_sid = sid;
            if (type != 2 && type != 1 && ext && seq.op_idc[0]) {
                bool in_t = (seq.op_idc[0] >> tid) & 1, in_s = (seq.op_idc[0] >> (sid + 8)) & 1;
                if (!in_t || !in_s) {
                    p += payload;
                    continue;
                }
            }
            size_t used = 0;
            switch (type) {
                case 2:  // temporal delimiter
                    if (seen_frame_header) fail("incomplete frame");
                    break;
                case 1: {
                    BitReader rb(p, payload);
                    SeqHeader s;
                    read_sequence_header(rb, s);
                    s.seen = true;
                    seq = s;
                    used = (rb.pos + 7) / 8;
                    break;
                }
                case 3:
                case 6: {
                    if (!seq.seen) fail("frame before the sequence header");
                    if (seen_frame_header) fail("second frame header");
                    // libavif refuses a stream whose depth is not its av1C's
                    if (expected_depth && seq.bitdepth != expected_depth) fail("bit depth differs from av1C's");
                    if (seq.bitdepth != 8) unsupported("bit depth " + std::to_string(seq.bitdepth));
                    num_planes = seq.mono ? 1 : 3;
                    ssx = seq.ssx;
                    ssy = seq.ssy;
                    BitReader rb(p, payload);
                    read_frame_header(rb);
                    seen_frame_header = true;
                    setup();
                    init_cdf.init(fh.base_q_idx);
                    if (type == 3) {
                        rb.trailing();
                        used = (rb.pos + 7) / 8;
                    } else {
                        rb.byte_align();
                        size_t off = rb.pos / 8;
                        if (off > payload) fail("frame header past the OBU");
                        tile_group(p + off, payload - off);
                        used = payload;
                    }
                    break;
                }
                case 7:
                    used = payload;
                    break;
                case 4:
                    if (!seen_frame_header) fail("tile group before a frame header");
                    tile_group(p, payload);
                    used = payload;
                    break;
                case 5:
                case 15:
                    used = payload;
                    break;
                default: {
                    if (payload > 0) {
                        size_t k = payload;
                        while (k > 0 && p[k - 1] == 0) k--;
                        if (k == 0) fail("unknown OBU of zeros");
                    }
                    used = payload;
                }
            }
            if (used > payload) fail("OBU payload overrun");
            for (size_t k = used; k < payload; k++)
                if (p[k]) fail("non-zero OBU padding");
            p += payload;
        }
        loop_filter();
        cdef();
        loop_restoration();
        if (fh.apply_grain) unsupported("film grain");
    }
};

struct Result {
    int w, h, mono, ssx, ssy, range, cp, tc, mc;
    std::vector<uint8_t> planes[3];
};

}  // namespace

extern "C" {

// Decodes one AV1 image item whose av1C gives bit depth ``depth`` (0: any).
// info: width, height, mono, subsampling x, y, colour range, colour
// primaries, transfer, matrix (from the sequence header).  Returns 0 and a
// handle (av1_planes / av1_free), 1 where libaom or libavif refuses the
// stream, 2 for a form left out (msg says which).
int av1_decode(const uint8_t* data, int64_t size, int depth, int64_t* info, void** handle, char* msg,
               int64_t msg_len) {
    *handle = nullptr;
    std::memset(g_counters, 0, sizeof(g_counters));
    try {
        Decoder d;
        d.expected_depth = depth;
        d.decode(data, (size_t)size);
        Result* r = new Result();
        r->w = d.fh.w;
        r->h = d.fh.h;
        r->mono = d.seq.mono;
        r->ssx = d.ssx;
        r->ssy = d.ssy;
        r->range = d.seq.color_range;
        r->cp = d.seq.cp;
        r->tc = d.seq.tc;
        r->mc = d.seq.mc;
        for (int p = 0; p < d.num_planes; p++) {
            int sx = p ? d.ssx : 0, sy = p ? d.ssy : 0;
            int pw = (r->w + sx) >> sx, ph = (r->h + sy) >> sy;
            r->planes[p].resize((size_t)pw * ph);
            for (int y = 0; y < ph; y++)
                std::memcpy(&r->planes[p][(size_t)y * pw], &d.cur.p[p][(size_t)y * d.cur.stride[p]], pw);
        }
        int64_t v[9] = {r->w, r->h, r->mono, r->ssx, r->ssy, r->range, r->cp, r->tc, r->mc};
        std::memcpy(info, v, sizeof(v));
        *handle = r;
        return 0;
    } catch (const Failure& f) {
        std::snprintf(msg, (size_t)msg_len, "%s", f.msg.c_str());
        return f.code;
    } catch (const std::bad_alloc&) {
        std::snprintf(msg, (size_t)msg_len, "out of memory");
        return 1;
    }
}

void av1_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v) {
    Result* r = (Result*)handle;
    std::memcpy(y, r->planes[0].data(), r->planes[0].size());
    if (!r->mono) {
        std::memcpy(u, r->planes[1].data(), r->planes[1].size());
        std::memcpy(v, r->planes[2].data(), r->planes[2].size());
    }
}

void av1_free(void* handle) { delete (Result*)handle; }

// Test entry point: the calling thread's counters of its last av1_decode
// (which paths the frame reached), n of them.
int av1_test_counters(int64_t* out, int n) {
    for (int i = 0; i < n && i < C_COUNT; i++) out[i] = g_counters[i];
    return C_COUNT;
}

// Test entry points: one inverse 1-D transform (type 0 DCT, 1 ADST, 3
// identity) of 2^n values, in place.
void av1_test_tx1d(int32_t* v, int type, int n) {
    Tx1d x;
    std::memcpy(x.T, v, sizeof(int32_t) << n);
    x.run(type, n);
    std::memcpy(v, x.T, sizeof(int32_t) << n);
}

// One inverse 2-D transform (tx size t, tx type) of row-major coefficients
// added to dst.
void av1_test_tx2d(const int32_t* coef, int t, int type, int lossless, uint8_t* dst, int stride) {
    inverse_transform_add(coef, t, type, lossless != 0, dst, stride);
}

}  // extern "C"
