// A JPEG 2000 codestream encoder: the codestream of the file cv2.imwrite
// writes for ".jp2", byte for byte as cv2 5.0 has OpenJPEG 2.5.3 write it
// (opj_set_default_encoder_parameters, one quality layer, cp_disto_alloc,
// tcp_rates[0] = 1000 / IMWRITE_JPEG2000_COMPRESSION_X1000, 4 by default).
// The JP2 boxes around it are core/jpeg2000.py's.  It links no OpenJPEG;
// the decoder (jpeg2000.cpp) is the model for the MQ table and the
// context rules.
//
// The codestream:
//   - SOC, SIZ (one tile, the image's sides), COD (LRCP, one layer, no
//     component transform, 5 decompositions, 64 x 64 code-blocks, style 0,
//     the reversible 5/3), QCD (no quantisation, 2 guard bits), COM
//     ("Created by OpenJPEG version 2.5.3"), one tile-part (SOT, SOD), EOC;
//   - per component: the DC level shift, then opj_dwt_encode's integer 5/3
//     (columns, then rows, at each level);
//   - Tier-1: the MQ encoder with OpenJPEG's byte-out, flush and fake first
//     byte; significance, refinement and cleanup passes; each pass's rate
//     (bytes so far + 3, the last pass terminated) and distortion
//     (opj_t1_getwmsedec from the lut_nmsedec tables and the 5/3 norms, in
//     double precision in OpenJPEG's order);
//   - Tier-2: OpenJPEG 2.5.3's packet headers (the first bit always 1),
//     tag trees, pass counts, Lblock and segment lengths, bit stuffing;
//   - rate allocation: opj_j2k_update_rates's byte budget (in float, less
//     the bytes written before the tile), then opj_tcd_rateallocate: the
//     slopes' range, at most 128 bisection steps of opj_tcd_makelayer with
//     Tier-2 as a length probe (stopped where the threshold moves by a
//     relative 0.5e-5 or less), the last threshold that fitted.
//
// Built with -ffp-contract=off so that no product and sum are fused.
#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int NUMRES = 6;       // 5 decomposition levels
constexpr int CBLK_EXP = 6;     // 64 x 64 code-blocks
constexpr int NMSEDEC_BITS = 7;
constexpr int NMSEDEC_FRACBITS = NMSEDEC_BITS - 1;
const char COMMENT[] = "Created by OpenJPEG version 2.5.3";

// -- tables -------------------------------------------------------------------------------

struct MQState { uint16_t qe; uint8_t nmps, nlps, sw; };
const MQState MQ_TABLE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NUM_CTX = 19 };

// flag bits of a sample, as in the decoder: the significance of its eight
// neighbours, its own state, and the signs of its four direct neighbours
constexpr uint32_t F_NW = 1, F_N = 2, F_NE = 4, F_W = 8, F_E = 16, F_SW = 32, F_S = 64,
                   F_SE = 128, F_NEIGHBOURS = 255, F_SIG = 256, F_VISIT = 512, F_REFINE = 1024,
                   F_SIGN = 2048, F_NSGN = 4096, F_SSGN = 8192, F_WSGN = 16384, F_ESGN = 32768;

struct Luts {
    uint8_t zc[4][256];
    uint8_t sc[256], spb[256];  // indexed by W, E, N, S significance and their signs
    // t1_generate_luts.c: the distortion decrease of a pass's bit, in 1/8192
    int16_t nmsedec_sig[1 << NMSEDEC_BITS], nmsedec_sig0[1 << NMSEDEC_BITS];
    int16_t nmsedec_ref[1 << NMSEDEC_BITS], nmsedec_ref0[1 << NMSEDEC_BITS];
    Luts() {
        for (int orient = 0; orient < 4; ++orient)
            for (int f = 0; f < 256; ++f) {
                int h = !!(f & F_W) + !!(f & F_E), v = !!(f & F_N) + !!(f & F_S);
                int dg = !!(f & F_NW) + !!(f & F_NE) + !!(f & F_SW) + !!(f & F_SE);
                int n = 0;
                if (orient == 3) {
                    int hv = h + v;
                    if (!dg) n = !hv ? 0 : hv == 1 ? 1 : 2;
                    else if (dg == 1) n = !hv ? 3 : hv == 1 ? 4 : 5;
                    else if (dg == 2) n = !hv ? 6 : 7;
                    else n = 8;
                } else {
                    if (orient == 1) std::swap(h, v);  // HL: horizontally high-pass
                    if (!h) n = !v ? (!dg ? 0 : dg == 1 ? 1 : 2) : v == 1 ? 3 : 4;
                    else if (h == 1) n = !v ? (!dg ? 5 : 6) : 7;
                    else n = 8;
                }
                zc[orient][f] = (uint8_t)(CTX_ZC + n);
            }
        // index bits: 0 W sig, 1 E sig, 2 N sig, 3 S sig, 4 W neg, 5 E neg, 6 N neg, 7 S neg
        for (int i = 0; i < 256; ++i) {
            auto contrib = [&](int sig, int neg) { return !(i & sig) ? 0 : (i & neg) ? -1 : 1; };
            int hc = contrib(1, 16) + contrib(2, 32), vc = contrib(4, 64) + contrib(8, 128);
            hc = std::max(-1, std::min(1, hc));
            vc = std::max(-1, std::min(1, vc));
            int ctx, x = 0;
            if (hc == 0 && vc == 0) ctx = 9;
            else if (hc == 0) { ctx = 10; x = vc < 0; }
            else {
                x = hc < 0;
                int v = hc < 0 ? -vc : vc;
                ctx = v == 1 ? 13 : v == 0 ? 12 : 11;
            }
            sc[i] = (uint8_t)ctx;
            spb[i] = (uint8_t)x;
        }
        const double frac = std::pow(2.0, NMSEDEC_FRACBITS);
        auto q = [&](double x) {
            return (int16_t)std::max(0, (int)(std::floor(x * frac + 0.5) / frac * 8192.0));
        };
        for (int i = 0; i < (1 << NMSEDEC_BITS); ++i) {
            double t = i / frac, u = t, v = t - 1.5;
            nmsedec_sig[i] = q(u * u - v * v);
            nmsedec_sig0[i] = q(u * u);
            u = t - 1.0;
            v = (i & (1 << (NMSEDEC_BITS - 1))) ? t - 1.5 : t - 0.5;
            nmsedec_ref[i] = q(u * u - v * v);
            nmsedec_ref0[i] = q(u * u);
        }
    }
};
const Luts LUT;

// opj_dwt_norms: the norms of the 5/3 synthesis basis per orientation and level
const double DWT_NORMS[4][10] = {
    {1.000, 1.500, 2.750, 5.375, 10.68, 21.34, 42.67, 85.33, 170.7, 341.3},
    {1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9},
    {1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9},
    {.7186, .9218, 1.586, 3.043, 6.019, 12.01, 24.00, 47.97, 95.93}};

int floorlog2(uint32_t a) {
    int l = 0;
    while (a > 1) { a >>= 1; ++l; }
    return l;
}

// opj_t1_getwmsedec for the 5/3 with no component transform (w1 = 1, step 1)
double getwmsedec(int32_t nmsedec, uint32_t level, uint32_t orient, int32_t bpno) {
    const double w1 = 1.0, stepsize = 1.0;
    double w2 = DWT_NORMS[orient][std::min(level, orient == 0 ? 9u : 8u)];
    double wmsedec = w1 * w2 * stepsize * (double)(1 << bpno);
    wmsedec *= wmsedec * nmsedec / 8192.0;
    return wmsedec;
}

// -- the MQ encoder (opj_mqc) ----------------------------------------------------------------

struct MQEnc {
    std::vector<uint8_t>* buf = nullptr;  // (*buf)[0]: the fake byte before the data, 0
    uint8_t* base = nullptr;
    size_t bp = 0;
    uint32_t a = 0, c = 0, ct = 0;
    uint8_t state[NUM_CTX], mps[NUM_CTX];

    void reset_states() {
        for (int i = 0; i < NUM_CTX; ++i) { state[i] = 0; mps[i] = 0; }
        state[CTX_UNI] = 46;
        state[CTX_AGG] = 3;
        state[CTX_ZC] = 4;
    }
    void init(std::vector<uint8_t>* b) {
        buf = b;
        base = b->data();
        base[0] = 0;
        a = 0x8000;
        c = 0;
        bp = 0;
        ct = 12;
    }
    void byteout() {
        if (bp + 2 > buf->size()) {  // room for the next byte (OpenJPEG's 4 per sample suffice)
            buf->resize(2 * buf->size());
            base = buf->data();
        }
        if (base[bp] == 0xff) {
            bp++;
            base[bp] = (uint8_t)(c >> 20);
            c &= 0xfffff;
            ct = 7;
        } else if ((c & 0x8000000) == 0) {
            bp++;
            base[bp] = (uint8_t)(c >> 19);
            c &= 0x7ffff;
            ct = 8;
        } else {
            base[bp]++;
            if (base[bp] == 0xff) {
                c &= 0x7ffffff;
                bp++;
                base[bp] = (uint8_t)(c >> 20);
                c &= 0xfffff;
                ct = 7;
            } else {
                bp++;
                base[bp] = (uint8_t)(c >> 19);
                c &= 0x7ffff;
                ct = 8;
            }
        }
    }
    inline void renorm() {
        do {
            a <<= 1;
            c <<= 1;
            if (--ct == 0) byteout();
        } while ((a & 0x8000) == 0);
    }
    inline void encode(int cx, uint32_t d) {
        const MQState& s = MQ_TABLE[state[cx]];
        a -= s.qe;
        if (mps[cx] == d) {
            if ((a & 0x8000) == 0) {
                if (a < s.qe) a = s.qe;
                else c += s.qe;
                state[cx] = s.nmps;
                renorm();
            } else {
                c += s.qe;
            }
        } else {
            if (a < s.qe) c += s.qe;
            else a = s.qe;
            if (s.sw) mps[cx] = (uint8_t)(1 - mps[cx]);
            state[cx] = s.nlps;
            renorm();
        }
    }
    void flush() {
        uint32_t tempc = c + a;
        c |= 0xffff;
        if (c >= tempc) c -= 0x8000;
        c <<= ct;
        byteout();
        c <<= ct;
        byteout();
        if (base[bp] != 0xff) bp++;  // a pass never ends on 0xFF
    }
    uint32_t numbytes() const { return (uint32_t)(bp - 1); }
};

// -- code-blocks, bands, the tile -----------------------------------------------------------

struct Pass {
    uint32_t rate = 0, len = 0;
    double distortiondec = 0;
    bool term = false;
};

struct Cblk {
    int x0, y0, x1, y1;  // in the tile buffer
    std::vector<uint8_t> bytes;  // bytes[0]: MQ's fake byte; the data from bytes[1]
    std::vector<Pass> passes;
    uint32_t totalpasses = 0, numbps = 0;
    // the one layer: its passes (the first layer_passes) and their bytes
    uint32_t layer_passes = 0, layer_len = 0;
    // Tier-2's state: the passes sent, the Lblock
    uint32_t numpasses = 0, numlenbits = 0;
    const uint8_t* data() const { return bytes.data() + 1; }
};

struct TagTree {
    struct Node { int parent; int32_t value, low; bool known; };
    std::vector<Node> nodes;
    // opj_tgt_create's layout: leaves in raster order, then each level above
    TagTree(uint32_t w, uint32_t h) {
        std::vector<uint32_t> nw{w}, nh{h};
        while (nw.back() * nh.back() > 1) {
            nw.push_back((nw.back() + 1) / 2);
            nh.push_back((nh.back() + 1) / 2);
        }
        size_t total = 0;
        std::vector<size_t> start;
        for (size_t l = 0; l < nw.size(); ++l) {
            start.push_back(total);
            total += (size_t)nw[l] * nh[l];
        }
        nodes.resize(total);
        for (size_t l = 0; l < nw.size(); ++l)
            for (uint32_t y = 0; y < nh[l]; ++y)
                for (uint32_t x = 0; x < nw[l]; ++x) {
                    Node& n = nodes[start[l] + (size_t)y * nw[l] + x];
                    n.parent = l + 1 < nw.size()
                                   ? (int)(start[l + 1] + (size_t)(y / 2) * nw[l + 1] + x / 2)
                                   : -1;
                }
        reset();
    }
    void reset() {
        for (Node& n : nodes) { n.value = 999; n.low = 0; n.known = false; }
    }
    void setvalue(uint32_t leaf, int32_t value) {
        int i = (int)leaf;
        while (i >= 0 && nodes[i].value > value) {
            nodes[i].value = value;
            i = nodes[i].parent;
        }
    }
    template <class Bio> void encode(Bio& bio, uint32_t leaf, int32_t threshold) {
        int stk[32], depth = 0;
        int i = (int)leaf;
        while (nodes[i].parent >= 0) {
            stk[depth++] = i;
            i = nodes[i].parent;
        }
        int32_t low = 0;
        for (;;) {
            Node& n = nodes[i];
            if (low > n.low) n.low = low;
            else low = n.low;
            while (low < threshold) {
                if (low >= n.value) {
                    if (!n.known) {
                        bio.write(1, 1);
                        n.known = true;
                    }
                    break;
                }
                bio.write(0, 1);
                ++low;
            }
            n.low = low;
            if (depth == 0) break;
            i = stk[--depth];
        }
    }
};

struct Band {
    uint32_t orient = 0;      // 0 LL, 1 HL, 2 LH, 3 HH
    int x0 = 0, y0 = 0, w = 0, h = 0;  // its place in the tile buffer
    int32_t numbps = 0;
    uint32_t cw = 0, ch = 0;  // code-blocks across and down
    std::vector<Cblk> cblks;
    TagTree incl{1, 1}, imsb{1, 1};
};

struct Resolution {
    std::vector<Band> bands;
};

struct Component {
    int w = 0, h = 0;
    std::vector<int32_t> data;  // the tile buffer, w x h
    Resolution res[NUMRES];
};

// -- the packet-header bit writer (opj_bio) ---------------------------------------------------

struct Bio {
    uint8_t* out;  // nullptr: count only
    size_t pos = 0, end;
    uint32_t buf = 0, ct = 8;
    Bio(uint8_t* o, size_t len) : out(o), end(len) {}
    bool byteout() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (pos >= end) return false;
        if (out) out[pos] = (uint8_t)(buf >> 8);
        pos++;
        return true;
    }
    void putbit(uint32_t b) {
        if (ct == 0) byteout();
        ct--;
        buf |= b << ct;
    }
    void write(uint32_t v, uint32_t n) {
        for (int i = (int)n - 1; i >= 0; --i) putbit((v >> i) & 1);
    }
    bool flush() {
        if (!byteout()) return false;
        if (ct == 7 && !byteout()) return false;
        return true;
    }
};

// -- Tier-1 ---------------------------------------------------------------------------------

struct T1 {
    uint32_t w = 0, h = 0, stride = 0;
    // per sample, at the flags' index: |coefficient| << NMSEDEC_FRACBITS, its sign
    std::vector<uint32_t> mag;
    std::vector<uint8_t> neg;
    std::vector<uint32_t> flags;  // (w + 2) x (h + 2), one sample of border
    MQEnc mqc;
    uint32_t orient = 0;

    inline uint32_t sc_index(uint32_t f) const {
        return (!!(f & F_W)) | (!!(f & F_E)) << 1 | (!!(f & F_N)) << 2 | (!!(f & F_S)) << 3 |
               (!!(f & F_WSGN)) << 4 | (!!(f & F_ESGN)) << 5 | (!!(f & F_NSGN)) << 6 |
               (!!(f & F_SSGN)) << 7;
    }
    inline void set_significant(uint32_t* f, uint32_t n) {
        f[0] |= F_SIG | (n ? F_SIGN : 0);
        f[-1] |= F_E | (n ? F_ESGN : 0);
        f[1] |= F_W | (n ? F_WSGN : 0);
        uint32_t* a = f - stride;
        a[-1] |= F_SE;
        a[0] |= F_S | (n ? F_SSGN : 0);
        a[1] |= F_SW;
        uint32_t* b = f + stride;
        b[-1] |= F_NE;
        b[0] |= F_N | (n ? F_NSGN : 0);
        b[1] |= F_NW;
    }
    inline int32_t nmsedec_sig(uint32_t x, int32_t bpno) const {
        return bpno > 0 ? LUT.nmsedec_sig[(x >> bpno) & ((1 << NMSEDEC_BITS) - 1)]
                        : LUT.nmsedec_sig0[x & ((1 << NMSEDEC_BITS) - 1)];
    }
    inline int32_t nmsedec_ref(uint32_t x, int32_t bpno) const {
        return bpno > 0 ? LUT.nmsedec_ref[(x >> bpno) & ((1 << NMSEDEC_BITS) - 1)]
                        : LUT.nmsedec_ref0[x & ((1 << NMSEDEC_BITS) - 1)];
    }
    // the sample at flags `f` becomes significant: its sign, coded
    inline void code_sign(uint32_t* f) {
        const uint32_t i = sc_index(*f), n = neg[f - flags.data()];
        mqc.encode(LUT.sc[i], n ^ LUT.spb[i]);
        set_significant(f, n);
    }
    inline uint32_t mag_at(const uint32_t* f) const { return mag[f - flags.data()]; }
    uint32_t* flags_at(uint32_t y, uint32_t x) { return &flags[(size_t)(y + 1) * stride + x + 1]; }

    // the passes visit stripes of 4 rows, each column of a stripe top down
    int32_t sigpass(int32_t bpno) {
        int32_t nmsedec = 0;
        const uint32_t one = 1u << (bpno + NMSEDEC_FRACBITS);
        for (uint32_t k = 0; k < h; k += 4) {
            const uint32_t rows = std::min(4u, h - k);
            uint32_t* fc = flags_at(k, 0);
            for (uint32_t i = 0; i < w; ++i, ++fc) {
                uint32_t any = 0;
                for (uint32_t r = 0; r < rows; ++r) any |= fc[r * stride];
                if (!(any & F_NEIGHBOURS)) continue;  // no sample has a significant neighbour
                for (uint32_t r = 0; r < rows; ++r) {
                    uint32_t* f = fc + r * stride;
                    const uint32_t fv = *f;
                    if ((fv & (F_SIG | F_VISIT)) || !(fv & F_NEIGHBOURS)) continue;
                    const uint32_t m = mag_at(f), v = (m & one) ? 1 : 0;
                    mqc.encode(LUT.zc[orient][fv & F_NEIGHBOURS], v);
                    if (v) {
                        nmsedec += nmsedec_sig(m, bpno);
                        code_sign(f);
                    }
                    *f |= F_VISIT;
                }
            }
        }
        return nmsedec;
    }
    int32_t refpass(int32_t bpno) {
        int32_t nmsedec = 0;
        const uint32_t one = 1u << (bpno + NMSEDEC_FRACBITS);
        for (uint32_t k = 0; k < h; k += 4) {
            const uint32_t rows = std::min(4u, h - k);
            uint32_t* fc = flags_at(k, 0);
            for (uint32_t i = 0; i < w; ++i, ++fc) {
                uint32_t any = 0;
                for (uint32_t r = 0; r < rows; ++r) any |= fc[r * stride];
                if (!(any & F_SIG)) continue;
                for (uint32_t r = 0; r < rows; ++r) {
                    uint32_t* f = fc + r * stride;
                    const uint32_t fv = *f;
                    if ((fv & (F_SIG | F_VISIT)) != F_SIG) continue;
                    const uint32_t m = mag_at(f);
                    nmsedec += nmsedec_ref(m, bpno);
                    mqc.encode((fv & F_REFINE)       ? CTX_MAG + 2
                               : (fv & F_NEIGHBOURS) ? CTX_MAG + 1
                                                     : CTX_MAG,
                               (m & one) ? 1 : 0);
                    *f |= F_REFINE;
                }
            }
        }
        return nmsedec;
    }
    int32_t clnpass(int32_t bpno) {
        int32_t nmsedec = 0;
        const uint32_t one = 1u << (bpno + NMSEDEC_FRACBITS);
        for (uint32_t k = 0; k < h; k += 4) {
            const uint32_t rows = std::min(4u, h - k);
            uint32_t* fc = flags_at(k, 0);
            for (uint32_t i = 0; i < w; ++i, ++fc) {
                uint32_t r = 0;
                bool agg = false;
                if (rows == 4) {
                    const uint32_t any = fc[0] | fc[stride] | fc[2 * stride] | fc[3 * stride];
                    agg = !(any & (F_NEIGHBOURS | F_SIG | F_VISIT));
                }
                if (agg) {
                    uint32_t runlen = 0;
                    while (runlen < 4 && !(mag_at(fc + runlen * stride) & one)) ++runlen;
                    mqc.encode(CTX_AGG, runlen != 4);
                    if (runlen == 4) continue;
                    mqc.encode(CTX_UNI, runlen >> 1);
                    mqc.encode(CTX_UNI, runlen & 1);
                    r = runlen;
                }
                for (uint32_t ci = r; ci < rows; ++ci) {
                    uint32_t* f = fc + ci * stride;
                    bool partial = agg && ci == r;
                    if (!partial && !(*f & (F_SIG | F_VISIT))) {
                        const uint32_t v = (mag_at(f) & one) ? 1 : 0;
                        mqc.encode(LUT.zc[orient][*f & F_NEIGHBOURS], v);
                        partial = v;
                    }
                    if (partial) {
                        nmsedec += nmsedec_sig(mag_at(f), bpno);
                        code_sign(f);
                    }
                    *f &= ~F_VISIT;
                }
            }
        }
        return nmsedec;
    }

    // opj_t1_encode_cblk: the passes of `cb` (coefficients `coef`, stride
    // `cstride`), each with its rate and cumulative distortion decrease
    void encode(Cblk& cb, const int32_t* coef, size_t cstride, uint32_t orient_, uint32_t level) {
        w = (uint32_t)(cb.x1 - cb.x0);
        h = (uint32_t)(cb.y1 - cb.y0);
        stride = w + 2;
        orient = orient_;
        const size_t n = (size_t)stride * (h + 2);
        mag.assign(n, 0);
        neg.assign(n, 0);
        uint32_t max = 0;
        for (uint32_t y = 0; y < h; ++y)
            for (uint32_t x = 0; x < w; ++x) {
                const int32_t v = coef[(size_t)y * cstride + x];
                const uint32_t m = (uint32_t)(v < 0 ? -v : v) << NMSEDEC_FRACBITS;
                const size_t at = (size_t)(y + 1) * stride + x + 1;
                mag[at] = m;
                neg[at] = v < 0;
                max = std::max(max, m);
            }
        cb.numbps = max ? (uint32_t)(floorlog2(max) + 1 - NMSEDEC_FRACBITS) : 0;
        cb.totalpasses = 0;
        if (cb.numbps == 0) return;
        flags.assign(n, 0);
        cb.bytes.assign(28 + (size_t)w * h * 4, 0);
        cb.passes.assign(3 * cb.numbps - 2, Pass());
        mqc.reset_states();
        mqc.init(&cb.bytes);

        int32_t bpno = (int32_t)cb.numbps - 1;
        uint32_t passtype = 2, passno = 0;
        double cumwmsedec = 0.0;
        for (; bpno >= 0; ++passno) {
            Pass& pass = cb.passes[passno];
            int32_t nmsedec = passtype == 0 ? sigpass(bpno)
                              : passtype == 1 ? refpass(bpno) : clnpass(bpno);
            double tempwmsedec = getwmsedec(nmsedec, level, orient, bpno);
            cumwmsedec += tempwmsedec;
            pass.distortiondec = cumwmsedec;
            if (passtype == 2 && bpno == 0) {
                mqc.flush();
                pass.term = true;
                pass.rate = mqc.numbytes();
            } else {
                pass.term = false;
                pass.rate = mqc.numbytes() + 3;
            }
            if (++passtype == 3) {
                passtype = 0;
                bpno--;
            }
        }
        cb.totalpasses = passno;
        uint32_t last = mqc.numbytes();
        for (uint32_t p = cb.totalpasses; p > 0;) {
            Pass& pass = cb.passes[--p];
            if (pass.rate > last) pass.rate = last;
            else last = pass.rate;
        }
        const uint8_t* d = cb.data();
        for (uint32_t p = 0; p < cb.totalpasses; ++p) {
            Pass& pass = cb.passes[p];
            if (d[pass.rate - 1] == 0xff) pass.rate--;
            pass.len = pass.rate - (p == 0 ? 0 : cb.passes[p - 1].rate);
        }
    }
};

// -- the 5/3 forward transform (opj_dwt_encode) ------------------------------------------------

// the lifting of one line of n = sn + dn samples: S(i) = x[2i], D(i) =
// x[2i + 1], indices clamped at the ends (the symmetric extension), each
// step on `cols` columns at once (a row of samples per index)
template <class Row> void lift_53(Row row, int32_t sn, int32_t dn, uint32_t cols) {
    if (!(dn > 0 || sn > 1)) return;
    auto S = [&](int32_t i) { return row(2 * (i < 0 ? 0 : i >= sn ? sn - 1 : i)); };
    auto D = [&](int32_t i) { return row(1 + 2 * (i < 0 ? 0 : i >= dn ? dn - 1 : i)); };
    for (int32_t i = 0; i < dn; ++i) {
        int32_t* d = row(1 + 2 * i);
        const int32_t *a = S(i), *b = S(i + 1);
        for (uint32_t c = 0; c < cols; ++c) d[c] -= (a[c] + b[c]) >> 1;
    }
    for (int32_t i = 0; i < sn; ++i) {
        int32_t* x = row(2 * i);
        const int32_t *a = D(i - 1), *b = D(i);
        for (uint32_t c = 0; c < cols; ++c) x[c] += (a[c] + b[c] + 2) >> 2;
    }
}

// the side of resolution `r` of a tile side `n`
inline int res_side(int n, int r) {
    const int shift = NUMRES - 1 - r;
    return (n + (1 << shift) - 1) >> shift;
}

// opj_dwt_encode: at each level the columns, then the rows, each split
// into its low then its high half
void dwt_encode(Component& comp) {
    std::vector<int32_t> tmp;
    const size_t w = (size_t)comp.w;
    for (int r = NUMRES - 1; r > 0; --r) {
        const uint32_t rw = (uint32_t)res_side(comp.w, r), rh = (uint32_t)res_side(comp.h, r);
        // columns: every column of the rh x rw region at once, row by row
        tmp.resize((size_t)rw * rh);
        for (uint32_t y = 0; y < rh; ++y)
            std::memcpy(&tmp[(size_t)y * rw], &comp.data[y * w], rw * sizeof(int32_t));
        int32_t sn = (int32_t)((rh + 1) >> 1), dn = (int32_t)rh - sn;
        lift_53([&](int32_t i) { return &tmp[(size_t)i * rw]; }, sn, dn, rw);
        for (int32_t i = 0; i < sn; ++i)
            std::memcpy(&comp.data[(size_t)i * w], &tmp[(size_t)(2 * i) * rw], rw * sizeof(int32_t));
        for (int32_t i = 0; i < dn; ++i)
            std::memcpy(&comp.data[(size_t)(sn + i) * w], &tmp[(size_t)(1 + 2 * i) * rw],
                        rw * sizeof(int32_t));
        // rows
        sn = (int32_t)((rw + 1) >> 1);
        dn = (int32_t)rw - sn;
        tmp.resize(rw);
        for (uint32_t y = 0; y < rh; ++y) {
            int32_t* line = &comp.data[y * w];
            std::memcpy(tmp.data(), line, rw * sizeof(int32_t));
            lift_53([&](int32_t i) { return &tmp[(size_t)i]; }, sn, dn, 1);
            for (int32_t i = 0; i < sn; ++i) line[i] = tmp[2 * i];
            for (int32_t i = 0; i < dn; ++i) line[sn + i] = tmp[1 + 2 * i];
        }
    }
}

// -- the tile: layout, Tier-1, Tier-2, rate allocation --------------------------------------

void layout(Component& comp) {
    for (int r = 0; r < NUMRES; ++r) {
        Resolution& res = comp.res[r];
        const int rw = res_side(comp.w, r), rh = res_side(comp.h, r);
        const int lw = r ? res_side(comp.w, r - 1) : 0, lh = r ? res_side(comp.h, r - 1) : 0;
        res.bands.clear();
        for (uint32_t orient = r ? 1 : 0; orient < (r ? 4u : 1u); ++orient) {
            Band b;
            b.orient = orient;
            b.x0 = (orient & 1) ? lw : 0;
            b.y0 = (orient & 2) ? lh : 0;
            b.w = r == 0 ? rw : (orient & 1) ? rw - lw : lw;
            b.h = r == 0 ? rh : (orient & 2) ? rh - lh : lh;
            // QCD exponent: 8 + gain (0, 1, 1, 2); numbps = expn + guard bits - 1
            b.numbps = 8 + (orient == 0 ? 0 : orient == 3 ? 2 : 1) + 2 - 1;
            b.cw = (uint32_t)((b.w + (1 << CBLK_EXP) - 1) >> CBLK_EXP);
            b.ch = (uint32_t)((b.h + (1 << CBLK_EXP) - 1) >> CBLK_EXP);
            for (uint32_t cy = 0; cy < b.ch; ++cy)
                for (uint32_t cx = 0; cx < b.cw; ++cx) {
                    Cblk cb;
                    cb.x0 = b.x0 + (int)(cx << CBLK_EXP);
                    cb.y0 = b.y0 + (int)(cy << CBLK_EXP);
                    cb.x1 = std::min(cb.x0 + (1 << CBLK_EXP), b.x0 + b.w);
                    cb.y1 = std::min(cb.y0 + (1 << CBLK_EXP), b.y0 + b.h);
                    b.cblks.push_back(std::move(cb));
                }
            b.incl = TagTree(b.cw, b.ch);
            b.imsb = TagTree(b.cw, b.ch);
            res.bands.push_back(std::move(b));
        }
    }
}

// (sides of 32 or more leave no band empty, so none is skipped)
template <class F> void each_cblk(std::vector<Component>& comps, F f) {
    for (Component& comp : comps)
        for (Resolution& res : comp.res)
            for (Band& b : res.bands)
                for (Cblk& cb : b.cblks) f(cb);
}

void putnumpasses(Bio& bio, uint32_t n) {
    if (n == 1) bio.write(0, 1);
    else if (n == 2) bio.write(2, 2);
    else if (n <= 5) bio.write(0xc | (n - 3), 4);
    else if (n <= 36) bio.write(0x1e0 | (n - 6), 9);
    else if (n <= 164) bio.write(0xff80 | (n - 37), 16);
}

// opj_t2_encode_packet for layer 0 of one resolution of one component (one
// precinct); `out` nullptr: count only.  False where it passes `length`.
bool encode_packet(Resolution& res, uint8_t* out, size_t length, size_t& written) {
    for (Band& b : res.bands) {
        b.incl.reset();
        b.imsb.reset();
        for (size_t i = 0; i < b.cblks.size(); ++i) {
            b.cblks[i].numpasses = 0;
            b.imsb.setvalue((uint32_t)i, b.numbps - (int32_t)b.cblks[i].numbps);
        }
    }
    Bio bio(out, length);
    bio.write(1, 1);  // 2.5.3 writes every packet as non-empty
    for (Band& b : res.bands) {
        for (size_t i = 0; i < b.cblks.size(); ++i)
            if (!b.cblks[i].numpasses && b.cblks[i].layer_passes)
                b.incl.setvalue((uint32_t)i, 0);
        for (size_t i = 0; i < b.cblks.size(); ++i) {
            Cblk& cb = b.cblks[i];
            if (!cb.numpasses) b.incl.encode(bio, (uint32_t)i, 1);
            else bio.write(cb.layer_passes != 0, 1);
            if (!cb.layer_passes) continue;
            if (!cb.numpasses) {
                cb.numlenbits = 3;
                b.imsb.encode(bio, (uint32_t)i, 999);
            }
            putnumpasses(bio, cb.layer_passes);
            const uint32_t end = cb.numpasses + cb.layer_passes;
            int32_t increment = 0;
            uint32_t len = 0, nump = 0;
            for (uint32_t p = cb.numpasses; p < end; ++p) {
                ++nump;
                len += cb.passes[p].len;
                if (cb.passes[p].term || p == end - 1) {
                    increment = std::max(increment, floorlog2(len) + 1 -
                                                        ((int32_t)cb.numlenbits + floorlog2(nump)));
                    len = 0;
                    nump = 0;
                }
            }
            for (int32_t n = increment; --n >= 0;) bio.write(1, 1);
            bio.write(0, 1);
            cb.numlenbits += (uint32_t)increment;
            for (uint32_t p = cb.numpasses; p < end; ++p) {
                ++nump;
                len += cb.passes[p].len;
                if (cb.passes[p].term || p == end - 1) {
                    bio.write(len, cb.numlenbits + (uint32_t)floorlog2(nump));
                    len = 0;
                    nump = 0;
                }
            }
        }
    }
    if (!bio.flush()) return false;
    size_t pos = bio.pos;
    length -= pos;
    for (Band& b : res.bands) {
        for (Cblk& cb : b.cblks) {
            if (!cb.layer_passes) continue;
            if (cb.layer_len > length) return false;
            if (out) std::memcpy(out + pos, cb.data(), cb.layer_len);
            cb.numpasses += cb.layer_passes;
            pos += cb.layer_len;
            length -= cb.layer_len;
        }
    }
    written += pos;
    return true;
}

// opj_t2_encode_packets: LRCP with one layer and one precinct per resolution
bool encode_packets(std::vector<Component>& comps, uint8_t* out, size_t length, size_t& written) {
    written = 0;
    for (int r = 0; r < NUMRES; ++r)
        for (Component& comp : comps) {
            size_t n = 0;
            if (!encode_packet(comp.res[r], out ? out + written : nullptr, length - written, n))
                return false;
            written += n;
        }
    return true;
}

// opj_tcd_makelayer for the one layer (a threshold below 0: every pass);
// whether every code-block keeps the passes it had
bool makelayer(std::vector<Component>& comps, double thresh) {
    bool same = true;
    each_cblk(comps, [&](Cblk& cb) {
        uint32_t n = 0;
        if (thresh < 0) {
            n = cb.totalpasses;
        } else {
            for (uint32_t p = 0; p < cb.totalpasses; ++p) {
                const Pass& pass = cb.passes[p];
                uint32_t dr;
                double dd;
                if (n == 0) {
                    dr = pass.rate;
                    dd = pass.distortiondec;
                } else {
                    dr = pass.rate - cb.passes[n - 1].rate;
                    dd = pass.distortiondec - cb.passes[n - 1].distortiondec;
                }
                if (!dr) {
                    if (dd != 0) n = p + 1;
                    continue;
                }
                if (thresh - (dd / dr) < DBL_EPSILON) n = p + 1;
            }
        }
        if (cb.layer_passes != n) {
            same = false;
            cb.layer_passes = n;
        }
        cb.layer_len = n ? cb.passes[n - 1].rate : 0;
    });
    return same;
}

// opj_tcd_rateallocate for one layer of `budget` bytes (0: every pass)
void rateallocate(std::vector<Component>& comps, uint32_t budget) {
    if (budget == 0) {
        makelayer(comps, -1);
        return;
    }
    double min = DBL_MAX, max = 0;
    each_cblk(comps, [&](Cblk& cb) {
        for (uint32_t p = 0; p < cb.totalpasses; ++p) {
            const Pass& pass = cb.passes[p];
            int32_t dr;
            double dd;
            if (p == 0) {
                dr = (int32_t)pass.rate;
                dd = pass.distortiondec;
            } else {
                dr = (int32_t)(pass.rate - cb.passes[p - 1].rate);
                dd = pass.distortiondec - cb.passes[p - 1].distortiondec;
            }
            if (dr == 0) continue;
            double rdslope = dd / dr;
            if (rdslope < min) min = rdslope;
            if (rdslope > max) max = rdslope;
        }
    });
    double lo = min, hi = max, thresh = 0, stable_thresh = 0;
    bool last_fits = false;
    for (int i = 0; i < 128; ++i) {
        // 2.5's early stop: the threshold moved by at most a relative 0.5e-5
        const double new_thresh = (lo + hi) / 2;
        if (std::fabs(new_thresh - thresh) <= 0.5 * 1e-5 * thresh) break;
        thresh = new_thresh;
        // Tier-2 runs only where the passes changed, as in 2.5
        const bool same = makelayer(comps, thresh) && i != 0;
        size_t written;
        if (!same) last_fits = encode_packets(comps, nullptr, budget, written);
        if (!last_fits) {
            lo = thresh;
            continue;
        }
        hi = thresh;
        stable_thresh = thresh;
    }
    makelayer(comps, stable_thresh == 0 ? thresh : stable_thresh);
}

// opj_j2k_update_rates for one tile and one layer: the packets' byte budget
// (0: every pass), from the rate in float as OpenJPEG holds it
uint32_t byte_budget(float rate, int ncomp, int w, int h, int64_t written_before) {
    if (!(rate > 0.0f)) return 0;
    const uint32_t bits_empty = 8, size_pixel = (uint32_t)ncomp * 8;
    const float sot_remove = (float)written_before / (float)1;
    float r = (float)(((double)size_pixel * (uint32_t)w * (uint32_t)h) /
                      (double)(rate * (float)bits_empty)) - 0.0f;
    r -= sot_remove;
    if (r < 30.0f) r = 30.0f;
    return (uint32_t)std::ceil((double)r);
}

void put16(std::vector<uint8_t>& o, uint32_t v) {
    o.push_back((uint8_t)(v >> 8));
    o.push_back((uint8_t)v);
}
void put32(std::vector<uint8_t>& o, uint32_t v) {
    put16(o, v >> 16);
    put16(o, v & 0xffff);
}

void main_header(std::vector<uint8_t>& o, int ncomp, int w, int h) {
    put16(o, 0xff4f);  // SOC
    put16(o, 0xff51);  // SIZ
    put16(o, 38 + 3 * ncomp);
    put16(o, 0);
    put32(o, w); put32(o, h); put32(o, 0); put32(o, 0);
    put32(o, w); put32(o, h); put32(o, 0); put32(o, 0);
    put16(o, ncomp);
    for (int c = 0; c < ncomp; ++c) { o.push_back(7); o.push_back(1); o.push_back(1); }
    const uint8_t cod[] = {0xff, 0x52, 0x00, 0x0c, 0x00, 0x00, 0x00, 0x01, 0x00,
                           NUMRES - 1, CBLK_EXP - 2, CBLK_EXP - 2, 0x00, 0x01};
    o.insert(o.end(), cod, cod + sizeof cod);
    put16(o, 0xff5c);  // QCD: no quantisation, 2 guard bits, exponents 8 + gain
    put16(o, 3 + 3 * NUMRES - 2);
    o.push_back(0x40);
    o.push_back(8 << 3);
    for (int r = 1; r < NUMRES; ++r) { o.push_back(9 << 3); o.push_back(9 << 3); o.push_back(10 << 3); }
    put16(o, 0xff64);  // COM, Latin
    put16(o, 4 + (uint32_t)(sizeof COMMENT - 1));
    put16(o, 1);
    o.insert(o.end(), COMMENT, COMMENT + sizeof COMMENT - 1);
}

}  // namespace

extern "C" {

// The codestream (SOC to EOC) of `ncomp` planes of h x w uint8 samples
// (`planes`, one after another), as OpenJPEG 2.5.3 writes it for cv2 with
// IMWRITE_JPEG2000_COMPRESSION_X1000 = `x1000` (cv2's default: 250);
// `before`: the bytes of the JP2 boxes written before the codestream.
// *out (malloc'd; free with j2k_enc_free) and its size.  Returns 1 where
// OpenJPEG refuses the image (a side under 32: too small for 6
// resolutions), 2 on bad arguments.
int j2k_encode(const uint8_t* planes, int ncomp, int w, int h, int x1000, int64_t before,
               uint8_t** out, int64_t* size) {
    *out = nullptr;
    *size = 0;
    if (ncomp < 1 || ncomp > 4 || w < 1 || h < 1 || x1000 < 1) return 2;
    if (w < (1 << (NUMRES - 1)) || h < (1 << (NUMRES - 1))) return 1;
    const float rate = 1000.f / (float)std::min(x1000, 1000);
    const float layer_rate = rate <= 1.0f ? 0.0f : rate;

    std::vector<Component> comps(ncomp);
    T1 t1;
    for (int c = 0; c < ncomp; ++c) {
        Component& comp = comps[c];
        comp.w = w;
        comp.h = h;
        comp.data.resize((size_t)w * h);
        const uint8_t* p = planes + (size_t)c * w * h;
        for (size_t i = 0; i < comp.data.size(); ++i) comp.data[i] = (int32_t)p[i] - 128;
        dwt_encode(comp);
        layout(comp);
        for (int r = 0; r < NUMRES; ++r)
            for (Band& b : comp.res[r].bands)
                for (Cblk& cb : b.cblks)
                    t1.encode(cb, &comp.data[(size_t)cb.y0 * w + cb.x0], (size_t)w, b.orient,
                              (uint32_t)(NUMRES - 1 - r));
    }

    std::vector<uint8_t> o;
    main_header(o, ncomp, w, h);
    rateallocate(comps, byte_budget(layer_rate, ncomp, w, h, before + (int64_t)o.size()));
    size_t total = 0;
    each_cblk(comps, [&](Cblk& cb) { total += 64 + cb.layer_len; });
    std::vector<uint8_t> body(total);
    size_t written = 0;
    if (!encode_packets(comps, body.data(), body.size(), written)) return 2;

    put16(o, 0xff90);  // SOT: tile 0, Psot, part 0 of 1
    put16(o, 10);
    put16(o, 0);
    put32(o, (uint32_t)(12 + 2 + written));
    o.push_back(0);
    o.push_back(1);
    put16(o, 0xff93);  // SOD
    o.insert(o.end(), body.begin(), body.begin() + (std::ptrdiff_t)written);
    put16(o, 0xffd9);  // EOC

    uint8_t* buf = (uint8_t*)std::malloc(o.size());
    if (!buf) return 2;
    std::memcpy(buf, o.data(), o.size());
    *out = buf;
    *size = (int64_t)o.size();
    return 0;
}

void j2k_enc_free(void* p) { std::free(p); }

}  // extern "C"
