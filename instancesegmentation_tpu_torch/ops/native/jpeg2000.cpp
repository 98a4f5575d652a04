// JPEG 2000 codestream decoding so that the component planes equal what
// OpenJPEG 2.5.3 (cv2 5.0's bundled JPEG 2000 decoder, default decoder
// parameters, strict mode) gives cv2 bit for bit.  The JP2 boxes, the
// palette and channel definitions and cv2's conversion to BGR or gray are
// core/jpeg2000.py's.
//
// Codestream:
//   - main and tile-part headers read as OpenJPEG reads them: marker states
//     (SIZ first, tile-part markers only after SOT), SIZ, COD and COC, QCD
//     and QCC (a later COD or QCD overwrites every component, an earlier
//     COC or QCC included; no quantisation, scalar derived, scalar
//     expounded), RGN (max-shift ROI), POC, TLM / PLM / PLT / CRG / COM
//     checked and skipped, unknown main-header markers skipped two bytes at
//     a time, SOT (tile-parts of one tile in order, Psot 0 for the last,
//     TNsot 0), SOD, EOC; the stream-length rules of strict mode;
//   - PPM and PPT: the packed packet headers, joined in Zppm / Zppt order
//     (PPM's Nppm lengths may run across markers), read in place of the
//     headers in the packets;
//   - the Part 2 markers MCT, MCC, MCO and CBD checked as OpenJPEG checks
//     them; an MCT record is kept by OpenJPEG but serves only a COD
//     transform of 2, which is refused, so it is unused here;
//   - refused as unported forms (`unsupported`): an MCC, MCO or CBD that
//     OpenJPEG would apply, the HTJ2K markers (CAP, CPF) and code-block
//     style 0x40 (HT; 0x80, mixed HT, OpenJPEG refuses);
//   - tiles in any order, their tile-parts concatenated; tiles never sent
//     are zero where another tile was decoded; a tile whose packets stop
//     below its top resolution (a POC that leaves levels out) is
//     transformed up to the level reached and placed as OpenJPEG places it.
// Tier-2: OpenJPEG's packet iterator (LRCP, RLCP, RPCL, PCRL, CPRL, POC
// with its include table; 64-bit positions), tag trees, the packet header
// bit reader with its stuffing, SOP (optional) / EPH (required),
// code-block segments (RESTART / BYPASS / TERMALL), zero-length packets,
// "segment too long" refused; packets none of whose precincts meets the
// tile skipped as OpenJPEG skips them.
// Tier-1: the MQ decoder (with OpenJPEG's 0xFF 0xFF sentinel after each
// segment), the raw decoder of bypass passes, significance propagation,
// refinement and cleanup passes with run-length coding, code-block styles
// BYPASS, RESET, TERMALL, VSC, PTERM and SEGSYM, OpenJPEG's mid-point
// reconstruction (one extra bit), the ROI shift.
// Dequantisation and inverse DWT: 5/3 in integers; 9/7 in single precision
// in OpenJPEG's lifting order and constants (K on the low band, 2/K on the
// high band, the step sizes of non-LL bands halved to match).
// Component transform: RCT in integers, ICT in single precision, chosen by
// component 0's wavelet and run over the first three components' 32-bit
// buffers whatever wavelet a COC gave the others; then each component's own
// DC level shift and clamp (9/7: lrintf, round half to even).
//
// Built with -ffp-contract=off so that no product and sum are fused.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

struct Error {
    int code;  // 1: OpenJPEG refuses the data, 2: a form the port does not decode
    std::string msg;
};

[[noreturn]] void refuse(const std::string& m) { throw Error{1, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Error{2, m}; }

// -- markers and states ---------------------------------------------------------

enum : uint32_t {
    MS_SOC = 0xFF4F, MS_SOT = 0xFF90, MS_SOD = 0xFF93, MS_EOC = 0xFFD9, MS_SIZ = 0xFF51,
    MS_COD = 0xFF52, MS_COC = 0xFF53, MS_RGN = 0xFF5E, MS_QCD = 0xFF5C, MS_QCC = 0xFF5D,
    MS_POC = 0xFF5F, MS_TLM = 0xFF55, MS_PLM = 0xFF57, MS_PLT = 0xFF58, MS_PPM = 0xFF60,
    MS_PPT = 0xFF61, MS_SOP = 0xFF91, MS_CRG = 0xFF63, MS_COM = 0xFF64, MS_MCT = 0xFF74,
    MS_CBD = 0xFF78, MS_CAP = 0xFF50, MS_CPF = 0xFF59, MS_MCC = 0xFF75, MS_MCO = 0xFF77,
    MS_UNK = 0
};
enum : uint32_t {
    ST_MHSOC = 0x1, ST_MHSIZ = 0x2, ST_MH = 0x4, ST_TPHSOT = 0x8, ST_TPH = 0x10,
    ST_NEOC = 0x40, ST_DATA = 0x80, ST_EOC = 0x100
};

// OpenJPEG's marker table: the id and the states it may appear in.
uint32_t marker_states(uint32_t id, uint32_t* known) {
    *known = id;
    switch (id) {
        case MS_SOT: return ST_MH | ST_TPHSOT;
        case MS_COD: case MS_COC: case MS_RGN: case MS_QCD: case MS_QCC: case MS_POC:
        case MS_COM: case MS_MCT: case MS_MCC: case MS_MCO:
            return ST_MH | ST_TPH;
        case MS_SIZ: return ST_MHSIZ;
        case MS_TLM: case MS_PLM: case MS_PPM: case MS_CRG: case MS_CBD: case MS_CAP:
        case MS_CPF:
            return ST_MH;
        case MS_PLT: case MS_PPT: return ST_TPH;
        case MS_SOP: return 0;
        default: *known = MS_UNK; return ST_MH | ST_TPH;
    }
}

// -- integer helpers as OpenJPEG defines them --------------------------------------

inline int32_t int_ceildivpow2(int32_t a, int32_t b) {
    return (int32_t)(((int64_t)a + ((int64_t)1 << b) - 1) >> b);
}
inline int32_t int64_ceildivpow2(int64_t a, int32_t b) {
    return (int32_t)((a + ((int64_t)1 << b) - 1) >> b);
}
inline int32_t int_floordivpow2(int32_t a, int32_t b) { return a >> b; }
inline int32_t int_ceildiv(int32_t a, int32_t b) {
    return (int32_t)(((int64_t)a + b - 1) / b);
}
inline uint32_t uint_ceildiv(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a + b - 1) / b);
}
inline uint32_t uint_adds(uint32_t a, uint32_t b) {
    uint64_t s = (uint64_t)a + b;
    return s > 0xFFFFFFFFu ? 0xFFFFFFFFu : (uint32_t)s;
}
inline uint32_t floorlog2(uint32_t a) {
    uint32_t l = 0;
    while (a > 1) { a >>= 1; ++l; }
    return l;
}
inline uint32_t be(const uint8_t* p, int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 8) | p[i];
    return v;
}

// -- coding parameters ------------------------------------------------------------

struct StepSize { int32_t expn = 0, mant = 0; };
constexpr int MAXRLVLS = 33, MAXBANDS = 3 * MAXRLVLS - 2;

struct TCCP {
    uint32_t csty = 0, numresolutions = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
    uint32_t qntsty = 0, numgbits = 0;
    int32_t roishift = 0;
    uint32_t prcw[MAXRLVLS] = {}, prch[MAXRLVLS] = {};
    StepSize stepsizes[MAXBANDS];
    int32_t dc_level_shift = 0;
};

struct POC {
    uint32_t resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0;
    int32_t prg = 0;
};

struct TCP {
    uint32_t csty = 0, numlayers = 0, mct = 0;
    int32_t prg = 0;
    bool poc = false;
    uint32_t numpocs = 0;
    std::vector<POC> pocs;
    std::vector<TCCP> tccps;
    std::vector<uint8_t> data;
    bool has_data = false;
    uint32_t nb_tile_parts = 0;
    int32_t current_tile_part = -1;
    // PPT: the packed packet headers of the tile's tile-parts, by Zppt
    bool ppt = false, ppt_merged = false;
    std::map<uint32_t, std::vector<uint8_t>> ppt_markers;
    std::vector<uint8_t> ppt_data;
    size_t ppt_pos = 0;
};

struct Comp {
    uint32_t dx = 1, dy = 1, prec = 0, sgnd = 0;
    uint32_t x0 = 0, y0 = 0, w = 0, h = 0;
};

// -- the packet header bit reader (opj_bio) ---------------------------------------------

struct Bio {
    const uint8_t *start, *end, *bp;
    uint32_t buf = 0, ct = 0;
    Bio(const uint8_t* p, size_t n) : start(p), end(p + n), bp(p) {}
    void bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp >= end) return;
        buf |= *bp++;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        ct--;
        return (buf >> ct) & 1;
    }
    uint32_t read(uint32_t n) {
        uint32_t v = 0;
        for (uint32_t i = n - 1; i < n; i--) v |= bit() << i;
        return v;
    }
    void inalign() {
        if ((buf & 0xff) == 0xff) bytein();
        ct = 0;
    }
    size_t numbytes() const { return (size_t)(bp - start); }
};

// -- tag trees -----------------------------------------------------------------------

struct TagTree {
    struct Node { int32_t parent, value, low; };
    std::vector<Node> nodes;
    TagTree() = default;
    TagTree(uint32_t w, uint32_t h) {
        if (!w || !h) return;
        std::vector<uint32_t> nw, nh;
        uint32_t a = w, b = h;
        size_t n = 0;
        for (;;) {
            nw.push_back(a);
            nh.push_back(b);
            n += (size_t)a * b;
            if (a * b <= 1) break;
            a = (a + 1) >> 1;
            b = (b + 1) >> 1;
        }
        nodes.resize(n);
        size_t base = 0;
        for (size_t l = 0; l < nw.size(); ++l) {
            size_t next = base + (size_t)nw[l] * nh[l];
            for (uint32_t j = 0; j < nh[l]; ++j)
                for (uint32_t i = 0; i < nw[l]; ++i) {
                    Node& node = nodes[base + (size_t)j * nw[l] + i];
                    node.parent = l + 1 < nw.size()
                                      ? (int32_t)(next + (size_t)(j >> 1) * nw[l + 1] + (i >> 1))
                                      : -1;
                }
            base = next;
        }
        reset();
    }
    void reset() {
        for (auto& nd : nodes) { nd.value = 999; nd.low = 0; }
    }
    uint32_t decode(Bio& bio, uint32_t leaf, int32_t threshold) {
        int32_t stk[40];
        int sp = 0;
        int32_t node = (int32_t)leaf;
        while (nodes[node].parent >= 0) {
            stk[sp++] = node;
            node = nodes[node].parent;
        }
        int32_t low = 0;
        for (;;) {
            Node& nd = nodes[node];
            if (low > nd.low) nd.low = low; else low = nd.low;
            while (low < threshold && low < nd.value) {
                if (bio.read(1)) nd.value = low; else ++low;
            }
            nd.low = low;
            if (sp == 0) break;
            node = stk[--sp];
        }
        return nodes[node].value < threshold ? 1 : 0;
    }
};

// -- tile structures -------------------------------------------------------------------

struct Seg {
    uint32_t len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0, numnewpasses = 0,
             newlen = 0;
};
struct Chunk { size_t off; uint32_t len; };
struct Cblk {
    int32_t x0, y0, x1, y1;
    uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0, real_num_segs = 0;
    std::vector<Seg> segs;
    std::vector<Chunk> chunks;
};
struct Precinct {
    int32_t x0, y0, x1, y1;
    uint32_t cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};
struct Band {
    uint32_t bandno;
    int32_t x0, y0, x1, y1;
    float stepsize;
    int32_t numbps;
    std::vector<Precinct> precincts;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};
struct Resolution {
    int32_t x0, y0, x1, y1;
    uint32_t pw, ph, pdx, pdy, numbands;
    Band bands[3];
};
struct TileComp {
    int32_t x0, y0, x1, y1;
    uint32_t numresolutions;
    std::vector<Resolution> res;
    std::vector<int32_t> idata;  // 5/3 (and the output after the level shift)
    std::vector<float> fdata;    // 9/7
    uint32_t resno_decoded = 0;
};

// -- the MQ and raw decoders (opj_mqc) ------------------------------------------------------

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

struct MQ {
    const uint8_t* d = nullptr;  // the segment, followed by two 0xFF bytes
    size_t bp = 0;
    uint32_t c = 0, a = 0, ct = 0;
    uint8_t state[NUM_CTX], mps[NUM_CTX];

    void reset_states() {
        for (int i = 0; i < NUM_CTX; ++i) { state[i] = 0; mps[i] = 0; }
        state[CTX_UNI] = 46;
        state[CTX_AGG] = 3;
        state[CTX_ZC] = 4;
    }
    void bytein() {
        if (d[bp] == 0xff) {
            if (d[bp + 1] > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                bp++;
                c += (uint32_t)d[bp] << 9;
                ct = 7;
            }
        } else {
            bp++;
            c += (uint32_t)d[bp] << 8;
            ct = 8;
        }
    }
    void init(const uint8_t* data, uint32_t len) {
        d = data;
        bp = 0;
        c = len == 0 ? 0xffu << 16 : (uint32_t)d[0] << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void raw_init(const uint8_t* data) {
        d = data;
        bp = 0;
        c = 0;
        ct = 0;
    }
    inline void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while (a < 0x8000);
    }
    inline uint32_t decode(int cx) {
        const MQState& s = MQ_TABLE[state[cx]];
        uint32_t dbit;
        a -= s.qe;
        if ((c >> 16) < s.qe) {
            if (a < s.qe) {
                a = s.qe;
                dbit = mps[cx];
                state[cx] = s.nmps;
            } else {
                a = s.qe;
                dbit = !mps[cx];
                if (s.sw) mps[cx] = !mps[cx];
                state[cx] = s.nlps;
            }
            renorm();
        } else {
            c -= (uint32_t)s.qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < s.qe) {
                    dbit = !mps[cx];
                    if (s.sw) mps[cx] = !mps[cx];
                    state[cx] = s.nlps;
                } else {
                    dbit = mps[cx];
                    state[cx] = s.nmps;
                }
                renorm();
            } else {
                dbit = mps[cx];
            }
        }
        return dbit;
    }
    inline uint32_t raw() {
        if (ct == 0) {
            if (c == 0xff) {
                if (d[bp] > 0x8f) {
                    c = 0xff;
                    ct = 8;
                } else {
                    c = d[bp];
                    bp++;
                    ct = 7;
                }
            } else {
                c = d[bp];
                bp++;
                ct = 8;
            }
        }
        ct--;
        return (c >> ct) & 1u;
    }
};

// -- Tier-1 -------------------------------------------------------------------------------

// flag bits of a sample: the significance of its eight neighbours, its own
// state, and the signs of its four direct neighbours (1 = negative)
constexpr uint32_t F_NW = 1, F_N = 2, F_NE = 4, F_W = 8, F_E = 16, F_SW = 32, F_S = 64,
                   F_SE = 128, F_NEIGHBOURS = 255, F_SIG = 256, F_VISIT = 512, F_REFINE = 1024,
                   F_SIGN = 2048, F_NSGN = 4096, F_SSGN = 8192, F_WSGN = 16384, F_ESGN = 32768;

struct Luts {
    uint8_t zc[4][256];
    uint8_t sc[256], spb[256];  // indexed by W, E, N, S significance and their signs
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
    }
};
const Luts LUT;

struct T1 {
    uint32_t w = 0, h = 0, stride = 0;
    std::vector<int32_t> data;
    std::vector<uint32_t> flags;  // (w + 2) x (h + 2), one sample of border
    MQ mqc;
    int orient = 0;
    bool vsc = false;

    inline uint32_t sc_index(uint32_t f) const {
        return (!!(f & F_W)) | (!!(f & F_E)) << 1 | (!!(f & F_N)) << 2 | (!!(f & F_S)) << 3 |
               (!!(f & F_WSGN)) << 4 | (!!(f & F_ESGN)) << 5 | (!!(f & F_NSGN)) << 6 |
               (!!(f & F_SSGN)) << 7;
    }
    // the sample at flags `f`, in row `y` of the code-block, becomes significant
    inline void set_significant(uint32_t* f, uint32_t y, uint32_t neg) {
        f[0] |= F_SIG | (neg ? F_SIGN : 0);
        f[-1] |= F_E | (neg ? F_ESGN : 0);
        f[1] |= F_W | (neg ? F_WSGN : 0);
        if (!((y & 3) == 0 && vsc)) {
            uint32_t* n = f - stride;
            n[-1] |= F_SE;
            n[0] |= F_S | (neg ? F_SSGN : 0);
            n[1] |= F_SW;
        }
        uint32_t* s = f + stride;
        s[-1] |= F_NE;
        s[0] |= F_N | (neg ? F_NSGN : 0);
        s[1] |= F_NW;
    }
    inline uint32_t decode_sign(uint32_t f) {
        uint32_t i = sc_index(f);
        return mqc.decode(LUT.sc[i]) ^ LUT.spb[i];
    }
    // the flags and coefficients of the first sample of stripe row `k`
    uint32_t* flags_at(uint32_t k) { return &flags[(size_t)(k + 1) * stride + 1]; }
    int32_t* data_at(uint32_t k) { return &data[(size_t)k * w]; }

    void sigpass(int32_t bpno, bool raw) {
        const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
        for (uint32_t k = 0; k < h; k += 4) {
            const uint32_t rows = std::min(4u, h - k);
            uint32_t* fc = flags_at(k);
            int32_t* dc = data_at(k);
            for (uint32_t i = 0; i < w; ++i, ++fc, ++dc) {
                uint32_t any = 0;
                for (uint32_t r = 0; r < rows; ++r) any |= fc[r * stride];
                if (!(any & F_NEIGHBOURS)) continue;  // no sample has a significant neighbour
                uint32_t* f = fc;
                int32_t* d = dc;
                for (uint32_t r = 0; r < rows; ++r, f += stride, d += w) {
                    const uint32_t fv = *f;
                    if ((fv & (F_SIG | F_VISIT)) || !(fv & F_NEIGHBOURS)) continue;
                    if (raw) {
                        if (mqc.raw()) {
                            uint32_t v = mqc.raw();
                            *d = v ? -oneplushalf : oneplushalf;
                            set_significant(f, k + r, v);
                        }
                    } else if (mqc.decode(LUT.zc[orient][fv & F_NEIGHBOURS])) {
                        uint32_t v = decode_sign(fv);
                        *d = v ? -oneplushalf : oneplushalf;
                        set_significant(f, k + r, v);
                    }
                    *f |= F_VISIT;
                }
            }
        }
    }
    void refpass(int32_t bpno, bool raw) {
        const int32_t poshalf = (1 << bpno) >> 1;
        for (uint32_t k = 0; k < h; k += 4) {
            const uint32_t rows = std::min(4u, h - k);
            uint32_t* fc = flags_at(k);
            int32_t* dc = data_at(k);
            for (uint32_t i = 0; i < w; ++i, ++fc, ++dc) {
                uint32_t* f = fc;
                int32_t* d = dc;
                for (uint32_t r = 0; r < rows; ++r, f += stride, d += w) {
                    const uint32_t fv = *f;
                    if ((fv & (F_SIG | F_VISIT)) != F_SIG) continue;
                    uint32_t v;
                    if (raw) v = mqc.raw();
                    else v = mqc.decode((fv & F_REFINE) ? CTX_MAG + 2
                                        : (fv & F_NEIGHBOURS) ? CTX_MAG + 1 : CTX_MAG);
                    *d += (v ^ (*d < 0)) ? poshalf : -poshalf;
                    *f |= F_REFINE;
                }
            }
        }
    }
    void clnpass(int32_t bpno, bool segsym) {
        const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
        for (uint32_t k = 0; k < h; k += 4) {
            const uint32_t rows = std::min(4u, h - k);
            uint32_t* fc = flags_at(k);
            int32_t* dc = data_at(k);
            for (uint32_t i = 0; i < w; ++i, ++fc, ++dc) {
                uint32_t r = 0;
                if (rows == 4 && !((fc[0] | fc[stride] | fc[2 * stride] | fc[3 * stride]) &
                                   (F_NEIGHBOURS | F_SIG | F_VISIT))) {
                    // run-length mode: four insignificant samples with no context
                    if (!mqc.decode(CTX_AGG)) continue;
                    uint32_t runlen = mqc.decode(CTX_UNI) << 1;
                    runlen |= mqc.decode(CTX_UNI);
                    r = runlen;
                    uint32_t* f = fc + r * stride;
                    uint32_t v = decode_sign(*f);
                    dc[r * w] = v ? -oneplushalf : oneplushalf;
                    set_significant(f, k + r, v);
                    ++r;
                }
                for (; r < rows; ++r) {
                    uint32_t* f = fc + r * stride;
                    const uint32_t fv = *f;
                    if (fv & (F_SIG | F_VISIT)) continue;
                    if (mqc.decode(LUT.zc[orient][fv & F_NEIGHBOURS])) {
                        uint32_t v = decode_sign(fv);
                        dc[r * w] = v ? -oneplushalf : oneplushalf;
                        set_significant(f, k + r, v);
                    }
                }
                for (uint32_t q = 0; q < rows; ++q) fc[q * stride] &= ~F_VISIT;
            }
        }
        if (segsym) {
            for (int n = 0; n < 4; ++n) mqc.decode(CTX_UNI);
        }
    }

    // opj_t1_decode_cblk: the code-block's passes into `data` (w x h)
    void decode(const Cblk& cblk, const std::vector<uint8_t>& tile_data, uint32_t bandno,
                uint32_t roishift, uint32_t cblksty) {
        w = (uint32_t)(cblk.x1 - cblk.x0);
        h = (uint32_t)(cblk.y1 - cblk.y0);
        stride = w + 2;
        data.assign((size_t)w * h, 0);
        flags.assign((size_t)stride * (h + 2), 0);
        orient = (int)bandno;
        vsc = cblksty & 0x08;
        mqc.reset_states();
        int32_t bpno_plus_one = (int32_t)(roishift + cblk.numbps);
        if (bpno_plus_one >= 31) refuse("unsupported bpno_plus_one >= 31 in a code-block");
        // the chunks concatenated, each segment followed by the 0xFF 0xFF sentinel
        std::vector<uint8_t> cat;
        for (const Chunk& ch : cblk.chunks)
            cat.insert(cat.end(), tile_data.begin() + ch.off, tile_data.begin() + ch.off + ch.len);
        std::vector<uint8_t> segbuf;
        size_t index = 0;
        uint32_t passtype = 2;
        for (uint32_t segno = 0; segno < cblk.real_num_segs; ++segno) {
            const Seg& seg = cblk.segs[segno];
            bool raw = bpno_plus_one <= (int32_t)cblk.numbps - 4 && passtype < 2 &&
                       (cblksty & 0x01);
            size_t len = seg.len;
            segbuf.assign(len + 2, 0xFF);
            if (len) {
                size_t avail = index < cat.size() ? std::min(len, cat.size() - index) : 0;
                if (avail) std::memcpy(segbuf.data(), cat.data() + index, avail);
            }
            if (raw) mqc.raw_init(segbuf.data());
            else mqc.init(segbuf.data(), (uint32_t)len);
            index += len;
            for (uint32_t passno = 0; passno < seg.real_num_passes && bpno_plus_one >= 1;
                 ++passno) {
                switch (passtype) {
                    case 0: sigpass(bpno_plus_one, raw); break;
                    case 1: refpass(bpno_plus_one, raw); break;
                    case 2: clnpass(bpno_plus_one, cblksty & 0x20); break;
                }
                if ((cblksty & 0x02) && !raw) mqc.reset_states();
                if (++passtype == 3) {
                    passtype = 0;
                    bpno_plus_one--;
                }
            }
        }
        if (roishift) {
            if (roishift >= 31) {
                std::fill(data.begin(), data.end(), 0);
            } else {
                const int32_t thresh = 1 << roishift;
                for (int32_t& v : data) {
                    int32_t mag = std::abs(v);
                    if (mag >= thresh) {
                        mag >>= roishift;
                        v = v < 0 ? -mag : mag;
                    }
                }
            }
        }
    }
};

// -- inverse DWT --------------------------------------------------------------------

// One line of 5/3: `low` (sn) and `high` (dn) into `out` (sn + dn), cas the
// parity of the line's first coordinate.
void idwt53_line(const int32_t* low, const int32_t* high, int32_t sn, int32_t dn, int cas,
                 int32_t* out, std::vector<int32_t>& s, std::vector<int32_t>& d) {
    const int32_t n = sn + dn;
    if (cas == 0) {
        if (n == 1) { out[0] = low[0]; return; }
        if (n == 0) return;
        s.resize(sn);
        d.resize(dn);
        for (int32_t i = 0; i < sn; ++i) {
            int32_t dl = high[std::max(i - 1, 0)], dr = high[std::min(i, dn - 1)];
            s[i] = low[i] - ((dl + dr + 2) >> 2);
        }
        for (int32_t i = 0; i < dn; ++i)
            d[i] = high[i] + ((s[i] + s[std::min(i + 1, sn - 1)]) >> 1);
        for (int32_t i = 0; i < sn; ++i) out[2 * i] = s[i];
        for (int32_t i = 0; i < dn; ++i) out[2 * i + 1] = d[i];
    } else {
        if (n == 1) { out[0] = high[0] / 2; return; }
        if (n == 0) return;
        s.resize(sn);
        d.resize(dn);
        for (int32_t i = 0; i < sn; ++i)
            s[i] = low[i] - ((high[i] + high[std::min(i + 1, dn - 1)] + 2) >> 2);
        for (int32_t i = 0; i < dn; ++i)
            d[i] = high[i] + ((s[std::max(i - 1, 0)] + s[std::min(i, sn - 1)]) >> 1);
        for (int32_t i = 0; i < sn; ++i) out[2 * i + 1] = s[i];
        for (int32_t i = 0; i < dn; ++i) out[2 * i] = d[i];
    }
}

const float DWT_K = 1.230174104914001f;
const float DWT_TWO_INVK = 1.625732422f;
const float DWT_C_DELTA = -0.443506852f, DWT_C_GAMMA = -0.882911075f;
const float DWT_C_BETA = 0.052980118f, DWT_C_ALPHA = 1.586134342f;

// opj_v8dwt_decode_step2 on one line: fw[-1] += (fl + fw) * c
void step2(float* l, float* w, uint32_t end, uint32_t m, float c) {
    uint32_t imax = std::min(end, m);
    float* fl = l;
    float* fw = w;
    for (uint32_t i = 0; i < imax; ++i) {
        float t = fl[0] + fw[0];
        t = t * c;
        fw[-1] = fw[-1] + t;
        fl = fw;
        fw += 2;
    }
    if (m < end) {
        float c2 = c + c;
        float t = fl[0] * c2;
        fw[-1] = fw[-1] + t;
    }
}

// One line of 9/7 already interleaved in x (sn low, dn high samples).
void idwt97_line(float* x, int32_t sn, int32_t dn, int cas) {
    int a, b;
    if (cas == 0) {
        if (!(dn > 0 || sn > 1)) return;
        a = 0; b = 1;
    } else {
        if (!(sn > 0 || dn > 1)) return;
        a = 1; b = 0;
    }
    for (int32_t i = 0; i < sn; ++i) x[2 * i + a] = x[2 * i + a] * DWT_K;
    for (int32_t i = 0; i < dn; ++i) x[2 * i + b] = x[2 * i + b] * DWT_TWO_INVK;
    uint32_t ml = (uint32_t)std::min(sn, dn - a), mh = (uint32_t)std::min(dn, sn - b);
    step2(x + b, x + a + 1, (uint32_t)sn, ml, DWT_C_DELTA);
    step2(x + a, x + b + 1, (uint32_t)dn, mh, DWT_C_GAMMA);
    step2(x + b, x + a + 1, (uint32_t)sn, ml, DWT_C_BETA);
    step2(x + a, x + b + 1, (uint32_t)dn, mh, DWT_C_ALPHA);
}

void idwt53_tile(TileComp& tc, uint32_t numres) {
    const int32_t stride = tc.x1 - tc.x0;
    std::vector<int32_t> line, out, s, d;
    for (uint32_t r = 1; r < numres; ++r) {
        const Resolution& pr = tc.res[r - 1];
        const Resolution& cr = tc.res[r];
        int32_t rw = cr.x1 - cr.x0, rh = cr.y1 - cr.y0;
        int32_t sn = pr.x1 - pr.x0, dn = rw - sn, cas = cr.x0 % 2;
        line.resize(std::max(rw, rh));
        out.resize(std::max(rw, rh) + 1);
        for (int32_t j = 0; j < rh; ++j) {
            int32_t* row = &tc.idata[(size_t)j * stride];
            std::copy(row, row + rw, line.begin());
            idwt53_line(line.data(), line.data() + sn, sn, dn, cas, out.data(), s, d);
            std::copy(out.begin(), out.begin() + rw, row);
        }
        sn = pr.y1 - pr.y0;
        dn = rh - sn;
        cas = cr.y0 % 2;
        for (int32_t i = 0; i < rw; ++i) {
            for (int32_t j = 0; j < rh; ++j) line[j] = tc.idata[(size_t)j * stride + i];
            idwt53_line(line.data(), line.data() + sn, sn, dn, cas, out.data(), s, d);
            for (int32_t j = 0; j < rh; ++j) tc.idata[(size_t)j * stride + i] = out[j];
        }
    }
}

void idwt97_tile(TileComp& tc, uint32_t numres) {
    const int32_t stride = tc.x1 - tc.x0;
    std::vector<float> line;
    for (uint32_t r = 1; r < numres; ++r) {
        const Resolution& pr = tc.res[r - 1];
        const Resolution& cr = tc.res[r];
        int32_t rw = cr.x1 - cr.x0, rh = cr.y1 - cr.y0;
        int32_t sn = pr.x1 - pr.x0, dn = rw - sn, cas = cr.x0 % 2;
        line.assign(std::max(rw, rh) + 2, 0.0f);
        for (int32_t j = 0; j < rh; ++j) {
            float* row = &tc.fdata[(size_t)j * stride];
            for (int32_t i = 0; i < sn; ++i) line[2 * i + cas] = row[i];
            for (int32_t i = 0; i < dn; ++i) line[2 * i + 1 - cas] = row[sn + i];
            idwt97_line(line.data(), sn, dn, cas);
            std::copy(line.begin(), line.begin() + rw, row);
        }
        sn = pr.y1 - pr.y0;
        dn = rh - sn;
        cas = cr.y0 % 2;
        for (int32_t i = 0; i < rw; ++i) {
            for (int32_t j = 0; j < sn; ++j) line[2 * j + cas] = tc.fdata[(size_t)j * stride + i];
            for (int32_t j = 0; j < dn; ++j)
                line[2 * j + 1 - cas] = tc.fdata[(size_t)(sn + j) * stride + i];
            idwt97_line(line.data(), sn, dn, cas);
            for (int32_t j = 0; j < rh; ++j) tc.fdata[(size_t)j * stride + i] = line[j];
        }
    }
}

// -- the packet iterator (opj_pi) ---------------------------------------------------------

struct PiRes { uint32_t pdx, pdy, pw, ph; };
struct PiComp { uint32_t dx, dy, numresolutions; std::vector<PiRes> res; };
struct Packet { uint32_t compno, resno, precno, layno, pino; };

// ---------------------------------------------------------------------------------------

class Decoder {
  public:
    Decoder(const uint8_t* d, int64_t n, uint32_t ihdr_w, uint32_t ihdr_h)
        : d_(d), n_(n), ihdr_w_(ihdr_w), ihdr_h_(ihdr_h) {}

    // image header
    uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    std::vector<Comp> comps;
    std::vector<std::vector<int32_t>> planes;  // per component, w x h, after decode

    void read_header();
    void decode();

  private:
    const uint8_t* d_;
    int64_t n_, pos_ = 0;
    uint32_t ihdr_w_, ihdr_h_;
    uint32_t state_ = 0;
    uint32_t tx0_ = 0, ty0_ = 0, tdx_ = 0, tdy_ = 0, tw_ = 0, th_ = 0;
    TCP default_;
    std::vector<TCP> tcps_;
    uint32_t current_tile_ = 0;
    bool can_decode_ = false, last_tile_part_ = false, nb_tile_parts_checked_ = false;
    uint32_t nb_tile_parts_correction_ = 0;
    uint64_t sot_length_ = 0;
    std::vector<uint8_t> hdr_;
    std::vector<bool> decoded_;
    // PPM: the packed packet headers of every tile-part, by Zppm, then merged
    bool ppm_ = false;
    std::map<uint32_t, std::vector<uint8_t>> ppm_markers_;
    std::vector<uint8_t> ppm_data_;
    size_t ppm_pos_ = 0;
    void merge_ppm();

    int64_t left() const { return n_ - pos_; }
    int64_t read(uint8_t* out, int64_t k) {
        int64_t m = std::max<int64_t>(0, std::min(k, left()));
        if (m) std::memcpy(out, d_ + pos_, (size_t)m);
        pos_ += m;
        return m;
    }
    bool read2(uint32_t* v) {
        uint8_t b[2];
        if (read(b, 2) != 2) return false;
        *v = be(b, 2);
        return true;
    }
    TCP& cur_tcp() { return (state_ & ST_TPH) ? tcps_[current_tile_] : default_; }

    void read_unk(uint32_t* marker);
    void handle(uint32_t id, const uint8_t* p, uint32_t size);
    void read_siz(const uint8_t* p, uint32_t size);
    void read_cod(const uint8_t* p, uint32_t size);
    void read_spcod(TCCP& tccp, const uint8_t*& p, uint32_t& size);
    void read_qcd(const uint8_t* p, uint32_t size);
    void read_qcc(const uint8_t* p, uint32_t size);
    void read_coc(const uint8_t* p, uint32_t size);
    void read_poc(const uint8_t* p, uint32_t size);
    void read_rgn(const uint8_t* p, uint32_t size);
    void read_sot(const uint8_t* p, uint32_t size);
    void read_sod();
    bool read_tile_header(uint32_t* tile, bool* go_on);
    bool need_tile_parts_correction(uint32_t tile);
    void decode_tile(uint32_t tileno, bool whole);
    void after_tile();
    std::vector<Packet> packets(uint32_t tileno, const std::vector<PiComp>& pcomps,
                                uint32_t max_res, uint32_t max_prec, int32_t tx0, int32_t ty0,
                                int32_t tx1, int32_t ty1);
};

void Decoder::read_unk(uint32_t* marker) {
    for (;;) {
        uint32_t m;
        if (!read2(&m)) refuse("Stream too short");
        if (m >= 0xff00) {
            uint32_t known;
            uint32_t states = marker_states(m, &known);
            if (!(state_ & states)) refuse("Marker is not compliant with its position");
            if (known != MS_UNK) {
                *marker = m;
                return;
            }
        }
    }
}

void Decoder::read_siz(const uint8_t* p, uint32_t size) {
    if (size < 36) refuse("Error with SIZ marker size");
    uint32_t remaining = size - 36;
    if (remaining % 3) refuse("Error with SIZ marker size");
    uint32_t nb_comp = remaining / 3;
    x1 = be(p + 2, 4);
    y1 = be(p + 6, 4);
    x0 = be(p + 10, 4);
    y0 = be(p + 14, 4);
    tdx_ = be(p + 18, 4);
    tdy_ = be(p + 22, 4);
    tx0_ = be(p + 26, 4);
    ty0_ = be(p + 30, 4);
    uint32_t csiz = be(p + 34, 2);
    if (csiz >= 16385) refuse("Error with SIZ marker: number of component is illegal");
    if (csiz != nb_comp)
        refuse("Error with SIZ marker: number of component is not compatible with the "
               "remaining number of parameters");
    if (x0 >= x1 || y0 >= y1) refuse("Error with SIZ marker: negative or zero image size");
    if (tdx_ == 0 || tdy_ == 0) refuse("Error with SIZ marker: invalid tile size");
    uint32_t tx1 = uint_adds(tx0_, tdx_), ty1 = uint_adds(ty0_, tdy_);
    if (tx0_ > x0 || ty0_ > y0 || tx1 <= x0 || ty1 <= y0)
        refuse("Error with SIZ marker: illegal tile offset");
    if (ihdr_w_ > 0 && ihdr_h_ > 0 && (ihdr_w_ != x1 - x0 || ihdr_h_ != y1 - y0))
        refuse("Error with SIZ marker: IHDR w/h vs. SIZ w/h");
    comps.assign(csiz, Comp());
    const uint8_t* q = p + 36;
    for (uint32_t i = 0; i < csiz; ++i, q += 3) {
        Comp& c = comps[i];
        c.prec = (q[0] & 0x7f) + 1;
        c.sgnd = q[0] >> 7;
        c.dx = q[1];
        c.dy = q[2];
        if (c.dx < 1 || c.dx > 255 || c.dy < 1 || c.dy > 255)
            refuse("Invalid values for comp: dx/dy should be between 1 and 255");
        if (c.prec > 31) refuse("Invalid values for comp: prec (OpenJpeg only supports up to 31)");
    }
    tw_ = uint_ceildiv(x1 - tx0_, tdx_);
    th_ = uint_ceildiv(y1 - ty0_, tdy_);
    if (tw_ == 0 || th_ == 0 || tw_ > 65535 / th_) refuse("Invalid number of tiles");
    for (Comp& c : comps) {
        c.x0 = uint_ceildiv(x0, c.dx);
        c.y0 = uint_ceildiv(y0, c.dy);
        c.w = uint_ceildiv(x1, c.dx) - c.x0;
        c.h = uint_ceildiv(y1, c.dy) - c.y0;
    }
    default_.tccps.assign(csiz, TCCP());
    state_ = ST_MH;
}

void Decoder::read_spcod(TCCP& t, const uint8_t*& p, uint32_t& size) {
    if (size < 5) refuse("Error reading SPCod SPCoc element");
    t.numresolutions = p[0] + 1u;
    if (t.numresolutions > MAXRLVLS) refuse("Invalid value for numresolutions");
    t.cblkw = p[1] + 2u;
    t.cblkh = p[2] + 2u;
    if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
        refuse("Error reading SPCod SPCoc element, Invalid cblk w/h");
    t.cblksty = p[3];
    if (t.cblksty & 0x80) refuse("Unsupported Mixed HT code-block style found");
    if (t.cblksty & 0x40) unsupported("HTJ2K (high-throughput) code-blocks");
    t.qmfbid = p[4];
    if (t.qmfbid > 1) refuse("Error reading SPCod SPCoc element, Invalid transformation found");
    p += 5;
    size -= 5;
    if (t.csty & 0x01) {
        if (size < t.numresolutions) refuse("Error reading SPCod SPCoc element");
        for (uint32_t i = 0; i < t.numresolutions; ++i) {
            uint32_t v = p[i];
            if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) refuse("Invalid precinct size");
            t.prcw[i] = v & 0xf;
            t.prch[i] = v >> 4;
        }
        p += t.numresolutions;
        size -= t.numresolutions;
    } else {
        for (uint32_t i = 0; i < t.numresolutions; ++i) t.prcw[i] = t.prch[i] = 15;
    }
}

void Decoder::read_cod(const uint8_t* p, uint32_t size) {
    TCP& tcp = cur_tcp();  // a later COD overrides an earlier one
    if (size < 5) refuse("Error reading COD marker");
    tcp.csty = p[0];
    if (tcp.csty & ~0x07u) refuse("Unknown Scod value in COD marker");
    tcp.prg = p[1];
    if (tcp.prg > 4) tcp.prg = -1;
    tcp.numlayers = be(p + 2, 2);
    if (tcp.numlayers < 1) refuse("Invalid number of layers in COD marker");
    tcp.mct = p[4];
    if (tcp.mct > 1) refuse("Invalid multiple component transformation");
    p += 5;
    size -= 5;
    TCCP& t0 = tcp.tccps[0];
    for (TCCP& t : tcp.tccps) t.csty = tcp.csty & 0x01;
    read_spcod(t0, p, size);
    if (size != 0) refuse("Error reading COD marker");
    for (size_t i = 1; i < tcp.tccps.size(); ++i) {
        TCCP& t = tcp.tccps[i];
        t.numresolutions = t0.numresolutions;
        t.cblkw = t0.cblkw;
        t.cblkh = t0.cblkh;
        t.cblksty = t0.cblksty;
        t.qmfbid = t0.qmfbid;
        std::memcpy(t.prcw, t0.prcw, sizeof t.prcw);
        std::memcpy(t.prch, t0.prch, sizeof t.prch);
    }
}

// SQcd / SQcc into `t`; returns the bytes left over (which the caller refuses)
uint32_t read_sqcd(TCCP& t, const uint8_t* p, uint32_t size) {
    if (size < 1) refuse("Error reading SQcd or SQcc element");
    t.qntsty = p[0] & 0x1f;
    t.numgbits = p[0] >> 5;
    p++;
    size--;
    uint32_t num_band;
    if (t.qntsty == 1) num_band = 1;
    else num_band = t.qntsty == 0 ? size : size / 2;
    uint32_t need = t.qntsty == 0 ? num_band : 2 * num_band;
    if (need > size) refuse("Error reading SQcd or SQcc element");
    for (uint32_t b = 0; b < num_band; ++b) {
        if (t.qntsty == 0) {
            if (b < (uint32_t)MAXBANDS) t.stepsizes[b] = {(int32_t)(p[b] >> 3), 0};
        } else {
            uint32_t v = be(p + 2 * b, 2);
            if (b < (uint32_t)MAXBANDS) t.stepsizes[b] = {(int32_t)(v >> 11), (int32_t)(v & 0x7ff)};
        }
    }
    if (t.qntsty == 1) {
        for (int b = 1; b < MAXBANDS; ++b) {
            int32_t e = t.stepsizes[0].expn - (b - 1) / 3;
            t.stepsizes[b] = {e > 0 ? e : 0, t.stepsizes[0].mant};
        }
    }
    return size - need;
}

// QCD: component 0's quantisation, then copied to every component (an
// earlier QCC included, as OpenJPEG copies it)
void Decoder::read_qcd(const uint8_t* p, uint32_t size) {
    TCP& tcp = cur_tcp();
    TCCP& t = tcp.tccps[0];
    if (read_sqcd(t, p, size) != 0) refuse("Error reading QCD marker");
    for (size_t i = 1; i < tcp.tccps.size(); ++i) {
        TCCP& o = tcp.tccps[i];
        o.qntsty = t.qntsty;
        o.numgbits = t.numgbits;
        std::memcpy(o.stepsizes, t.stepsizes, sizeof o.stepsizes);
    }
}

// QCC: one component's quantisation
void Decoder::read_qcc(const uint8_t* p, uint32_t size) {
    const uint32_t room = comps.size() <= 256 ? 1 : 2;
    if (size < room) refuse("Error reading QCC marker");
    const uint32_t compno = be(p, room);
    if (compno >= comps.size()) refuse("Invalid component number in QCC marker");
    if (read_sqcd(cur_tcp().tccps[compno], p + room, size - room) != 0)
        refuse("Error reading QCC marker");
}

// COC: one component's coding style
void Decoder::read_coc(const uint8_t* p, uint32_t size) {
    const uint32_t room = comps.size() <= 256 ? 1 : 2;
    if (size < room + 1) refuse("Error reading COC marker");
    const uint32_t compno = be(p, room);
    if (compno >= comps.size()) refuse("Error reading COC marker (bad number of components)");
    TCCP& t = cur_tcp().tccps[compno];
    t.csty = p[room];
    p += room + 1;
    size -= room + 1;
    read_spcod(t, p, size);
    if (size != 0) refuse("Error reading COC marker");
}

void Decoder::read_poc(const uint8_t* p, uint32_t size) {
    const uint32_t nb_comp = (uint32_t)comps.size();
    const uint32_t room = nb_comp <= 256 ? 1 : 2, chunk = 5 + 2 * room;
    uint32_t nb = size / chunk;
    if (nb == 0 || size % chunk) refuse("Error reading POC marker");
    TCP& tcp = cur_tcp();
    uint32_t old = tcp.poc ? tcp.numpocs + 1 : 0;
    nb += old;
    if (nb >= 32) refuse("Too many POCs");
    tcp.poc = true;
    tcp.pocs.resize(nb);
    for (uint32_t i = old; i < nb; ++i) {
        POC& c = tcp.pocs[i];
        c.resno0 = p[0];
        p++;
        c.compno0 = be(p, room);
        p += room;
        c.layno1 = std::min(be(p, 2), tcp.numlayers);
        p += 2;
        c.resno1 = p[0];
        p++;
        c.compno1 = std::min(be(p, room), nb_comp);
        p += room;
        c.prg = p[0];
        p++;
    }
    tcp.numpocs = nb - 1;
}

void Decoder::read_rgn(const uint8_t* p, uint32_t size) {
    const uint32_t nb_comp = (uint32_t)comps.size(), room = nb_comp <= 256 ? 1 : 2;
    if (size != 2 + room) refuse("Error reading RGN marker");
    uint32_t compno = be(p, room);
    if (compno >= nb_comp) refuse("bad component number in RGN");
    cur_tcp().tccps[compno].roishift = p[room + 1];
}

void Decoder::handle(uint32_t id, const uint8_t* p, uint32_t size) {
    switch (id) {
        case MS_SIZ: read_siz(p, size); break;
        case MS_COD: read_cod(p, size); break;
        case MS_QCD: read_qcd(p, size); break;
        case MS_POC: read_poc(p, size); break;
        case MS_RGN: read_rgn(p, size); break;
        case MS_SOT: read_sot(p, size); break;
        case MS_COC: read_coc(p, size); break;
        case MS_QCC: read_qcc(p, size); break;
        case MS_PPM: {
            if (size < 2) refuse("Error reading PPM marker");
            ppm_ = true;
            if (ppm_markers_.count(p[0])) refuse("Zppm already read");
            ppm_markers_[p[0]].assign(p + 1, p + size);
            break;
        }
        case MS_PPT: {
            if (size < 2) refuse("Error reading PPT marker");
            if (ppm_) refuse("Error reading PPT marker: packet headers were found in a PPM marker");
            TCP& tcp = tcps_[current_tile_];
            tcp.ppt = true;
            if (tcp.ppt_markers.count(p[0])) refuse("Zppt already read");
            tcp.ppt_markers[p[0]].assign(p + 1, p + size);
            break;
        }
        case MS_MCT:  // its records serve only a COD transform of 2, which is refused
            if (size < 2) refuse("Error reading MCT marker");
            if (be(p, 2) != 0) break;
            if (size <= 6) refuse("Error reading MCT marker");
            break;
        case MS_MCC:  // OpenJPEG takes no MCC that spans several markers
            if (size < 2) refuse("Error reading MCC marker");
            if (be(p, 2) != 0) break;
            unsupported("a JPEG 2000 Part 2 MCC marker");
        case MS_MCO:  // nor more than one transform stage
            if (size < 1) refuse("Error reading MCO marker");
            if (p[0] > 1) break;
            if (size != p[0] + 1u) refuse("Error reading MCO marker");
            unsupported("a JPEG 2000 Part 2 MCO marker");
        case MS_CBD:
            if (size != comps.size() + 2 || be(p, 2) != comps.size())
                refuse("Error reading CBD marker");
            unsupported("a JPEG 2000 Part 2 CBD marker");
        case MS_CAP: case MS_CPF: unsupported("HTJ2K (CAP / CPF markers)");
        case MS_TLM:  // a TLM of the wrong size is only warned about
            if (size < 2) refuse("Error reading TLM marker");
            break;
        case MS_PLM:
            if (size < 1) refuse("Error reading PLM marker");
            break;
        case MS_PLT: {
            if (size < 1) refuse("Error reading PLT marker");
            uint32_t len = 0;
            for (uint32_t i = 1; i < size; ++i) {
                len |= p[i] & 0x7f;
                if (p[i] & 0x80) len <<= 7; else len = 0;
            }
            if (len != 0) refuse("Error reading PLT marker");
            break;
        }
        case MS_CRG:
            if (size != comps.size() * 4) refuse("Error reading CRG marker");
            break;
        case MS_COM: break;
        default: refuse("Not sure how that happened");
    }
}

void Decoder::read_header() {
    state_ = ST_MHSOC;
    uint32_t m;
    if (!read2(&m) || m != MS_SOC) refuse("Expected a SOC marker");
    state_ = ST_MHSIZ;
    if (!read2(&m)) refuse("Stream too short");
    bool has_siz = false, has_cod = false, has_qcd = false;
    while (m != MS_SOT) {
        if (m < 0xff00) refuse("A marker ID was expected (0xff--)");
        uint32_t known;
        uint32_t states = marker_states(m, &known);
        if (known == MS_UNK) {
            read_unk(&m);
            if (m == MS_SOT) break;
            states = marker_states(m, &known);
        }
        has_siz |= known == MS_SIZ;
        has_cod |= known == MS_COD;
        has_qcd |= known == MS_QCD;
        if (!(state_ & states)) refuse("Marker is not compliant with its position");
        uint32_t size;
        if (!read2(&size)) refuse("Stream too short");
        if (size < 2) refuse("Invalid marker size");
        size -= 2;
        hdr_.resize(size + 1);
        if (read(hdr_.data(), size) != size) refuse("Stream too short");
        handle(known, hdr_.data(), size);
        if (!read2(&m)) refuse("Stream too short");
    }
    if (!has_siz) refuse("required SIZ marker not found in main header");
    if (!has_cod) refuse("required COD marker not found in main header");
    if (!has_qcd) refuse("required QCD marker not found in main header");
    merge_ppm();
    for (size_t i = 0; i < comps.size(); ++i)
        default_.tccps[i].dc_level_shift = comps[i].sgnd ? 0 : 1 << (comps[i].prec - 1);
    tcps_.assign((size_t)tw_ * th_, default_);
    for (TCP& t : tcps_) t.current_tile_part = -1;
    state_ = ST_TPHSOT;
}

// opj_j2k_merge_ppm: the PPM markers in Zppm order, each tile-part's Nppm
// header bytes (which may run on into the next marker) joined into one
// stream of packet headers
void Decoder::merge_ppm() {
    if (!ppm_) return;
    uint64_t remaining = 0;
    for (const auto& kv : ppm_markers_) {
        const uint8_t* d = kv.second.data();
        uint64_t size = kv.second.size();
        if (remaining >= size) {
            ppm_data_.insert(ppm_data_.end(), d, d + size);
            remaining -= size;
            continue;
        }
        ppm_data_.insert(ppm_data_.end(), d, d + remaining);
        d += remaining;
        size -= remaining;
        remaining = 0;
        while (size > 0) {
            if (size < 4) refuse("Not enough bytes to read Nppm");
            uint64_t n = be(d, 4);
            d += 4;
            size -= 4;
            if (size >= n) {
                ppm_data_.insert(ppm_data_.end(), d, d + n);
                d += n;
                size -= n;
            } else {
                ppm_data_.insert(ppm_data_.end(), d, d + size);
                remaining = n - size;
                size = 0;
            }
        }
    }
    if (remaining != 0) refuse("Corrupted PPM markers");
}

void Decoder::read_sot(const uint8_t* p, uint32_t size) {
    if (size != 8) refuse("Error reading SOT marker");
    current_tile_ = be(p, 2);
    uint32_t tot_len = be(p + 2, 4), part = p[6], num_parts = p[7];
    if (current_tile_ >= tw_ * th_) refuse("Invalid tile number");
    TCP& tcp = tcps_[current_tile_];
    if (tcp.current_tile_part + 1 != (int32_t)part) refuse("Invalid tile part index for tile");
    ++tcp.current_tile_part;
    if (tot_len != 0 && tot_len < 14) {
        if (tot_len != 12) refuse("Psot value is not correct regards to the JPEG2000 norm");
    }
    if (!tot_len) last_tile_part_ = true;
    if (tcp.nb_tile_parts != 0 && part >= tcp.nb_tile_parts) {
        last_tile_part_ = true;
        refuse("In SOT marker, TPSot is not valid regards to the previous number of tile-part");
    }
    if (num_parts != 0) {
        num_parts += nb_tile_parts_correction_;
        if (tcp.nb_tile_parts && part >= tcp.nb_tile_parts)
            refuse("In SOT marker, TPSot is not valid regards to the current number of tile-part");
        if (part >= num_parts)
            refuse("In SOT marker, TPSot is not valid regards to the current number of "
                   "tile-part (header)");
        tcp.nb_tile_parts = num_parts;
    }
    if (tcp.nb_tile_parts && tcp.nb_tile_parts == part + 1) can_decode_ = true;
    sot_length_ = last_tile_part_ ? 0 : (uint64_t)tot_len - 12;
    state_ = ST_TPH;
}

void Decoder::read_sod() {
    TCP& tcp = tcps_[current_tile_];
    if (last_tile_part_) {
        sot_length_ = (uint32_t)(left() - 2);
    } else {
        sot_length_ = sot_length_ >= 2 ? sot_length_ - 2 : 0;
    }
    int64_t got = 0;
    if (sot_length_) {
        if ((int64_t)sot_length_ > left())
            refuse("Tile part length size inconsistent with stream length");
        size_t old = tcp.data.size();
        tcp.data.resize(old + sot_length_);
        got = read(tcp.data.data() + old, (int64_t)sot_length_);
        tcp.has_data = true;
    }
    state_ = (uint64_t)got != sot_length_ ? ST_NEOC : ST_TPHSOT;
}

// opj_j2k_need_nb_tile_parts_correction: look ahead for a further tile-part
// of `tile` whose TPsot equals its TNsot (files whose TNsot is one short).
// As cv2 shows it, the look-ahead runs only after a tile of more than one
// tile-part; data that ends inside a SOT marker segment then fails the read.
bool Decoder::need_tile_parts_correction(uint32_t tile) {
    if (tcps_[tile].nb_tile_parts < 2) return false;
    int64_t backup = pos_;
    bool needed = false;
    for (;;) {
        uint32_t m, size;
        if (!read2(&m) || m != MS_SOT) break;  // the data ends, or no SOT follows
        if (!read2(&size)) refuse("Stream too short");
        if (size != 10) refuse("Inconsistent marker size");
        uint8_t b[8];
        if (read(b, 8) != 8) refuse("Stream too short");
        uint32_t t = be(b, 2), tot = be(b + 2, 4), part = b[6], num = b[7];
        if (t == tile) {
            needed = part == num && num != 0;
            break;
        }
        if (tot < 14) break;
        tot -= 12;
        if (left() < (int64_t)tot) break;
        pos_ += tot;
    }
    pos_ = backup;
    return needed;
}

bool Decoder::read_tile_header(uint32_t* tile, bool* go_on) {
    const uint32_t nb_tiles = tw_ * th_;
    uint32_t m = MS_SOT;
    if (state_ == ST_EOC) m = MS_EOC;
    else if (state_ != ST_TPHSOT) return false;
    while (!can_decode_ && m != MS_EOC) {
        while (m != MS_SOD) {
            if (left() == 0) {
                state_ = ST_NEOC;
                break;
            }
            uint32_t size;
            if (!read2(&size)) refuse("Stream too short");
            if (size < 2) refuse("Inconsistent marker size");
            if (m == 0x8080 && left() == 0) {
                state_ = ST_NEOC;
                break;
            }
            if ((state_ & ST_TPH) && sot_length_ != 0) {
                if (sot_length_ < size + 2) refuse("Sot length is invalid");
                sot_length_ -= size + 2;
            }
            size -= 2;
            uint32_t known;
            uint32_t states = marker_states(m, &known);
            if (!(state_ & states)) refuse("Marker is not compliant with its position");
            if ((int64_t)size > left()) refuse("Marker size inconsistent with stream length");
            hdr_.resize(size + 1);
            if (read(hdr_.data(), size) != size) refuse("Stream too short");
            if (known == MS_UNK) refuse("Not sure how that happened");
            handle(known, hdr_.data(), size);
            if (!read2(&m)) refuse("Stream too short");
        }
        if (left() == 0 && state_ == ST_NEOC) break;
        read_sod();
        if (can_decode_ && !nb_tile_parts_checked_) {
            nb_tile_parts_checked_ = true;
            if (need_tile_parts_correction(current_tile_)) {
                // every tile's TNsot is one too small: take one more part each
                for (TCP& t : tcps_)
                    if (t.nb_tile_parts) t.nb_tile_parts++;
                nb_tile_parts_correction_ = 1;
                can_decode_ = false;
            }
        }
        if (!can_decode_) {
            if (!read2(&m)) {
                if (current_tile_ + 1 == nb_tiles) {
                    uint32_t t = 0;
                    for (; t < nb_tiles; ++t)
                        if (tcps_[t].current_tile_part == 0 && tcps_[t].nb_tile_parts == 0) break;
                    if (t < nb_tiles) {
                        current_tile_ = t;
                        m = MS_EOC;
                        state_ = ST_EOC;
                        break;
                    }
                }
                refuse("Stream too short");
            }
        }
    }
    if (m == MS_EOC && state_ != ST_EOC) {
        current_tile_ = 0;
        state_ = ST_EOC;
    }
    if (!can_decode_) {
        while (current_tile_ < nb_tiles && !tcps_[current_tile_].has_data) ++current_tile_;
        if (current_tile_ == nb_tiles) {
            *go_on = false;
            return true;
        }
    }
    TCP& tcp = tcps_[current_tile_];  // opj_j2k_merge_ppt
    if (tcp.ppt_merged) refuse("opj_j2k_merge_ppt() has already been called");
    if (tcp.ppt) {
        for (const auto& kv : tcp.ppt_markers)
            tcp.ppt_data.insert(tcp.ppt_data.end(), kv.second.begin(), kv.second.end());
        tcp.ppt_merged = true;
    }
    *tile = current_tile_;
    *go_on = true;
    state_ |= ST_DATA;
    return true;
}

// -- one tile ---------------------------------------------------------------------------

std::vector<Packet> Decoder::packets(uint32_t tileno, const std::vector<PiComp>& pc,
                                     uint32_t max_res, uint32_t max_prec, int32_t tx0,
                                     int32_t ty0, int32_t tx1, int32_t ty1) {
    const TCP& tcp = tcps_[tileno];
    const uint32_t numcomps = (uint32_t)pc.size();
    const uint64_t step_p = 1, step_c = max_prec * step_p, step_r = numcomps * step_c,
                   step_l = max_res * step_r;
    const uint64_t include_size = (tcp.numlayers + 1ull) * step_l;
    std::vector<uint8_t> include((size_t)include_size, 0);
    std::vector<Packet> out;
    const uint32_t bound = tcp.numpocs + 1;
    for (uint32_t pino = 0; pino < bound; ++pino) {
        int32_t prg;
        uint32_t resno0, resno1, compno0, compno1, layno1;
        if (tcp.poc) {
            const POC& c = tcp.pocs[pino];
            prg = c.prg;
            resno0 = c.resno0;
            resno1 = c.resno1;
            compno0 = c.compno0;
            compno1 = c.compno1;
            layno1 = std::min(c.layno1, tcp.numlayers);
        } else {
            prg = tcp.prg;
            resno0 = 0;
            resno1 = max_res;
            compno0 = 0;
            compno1 = numcomps;
            layno1 = tcp.numlayers;
        }
        if (prg < 0) refuse("unknown progression order");  // COD's, unless a POC replaces it
        if (prg > 4) continue;  // a POC's order OpenJPEG does not know: no packets
        if (compno0 >= numcomps || compno1 >= numcomps + 1) continue;
        // returns false when the include table would be overrun (iteration ends)
        auto emit = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t p) -> int {
            uint64_t index = l * step_l + r * step_r + c * step_c + p * step_p;
            if (index >= include_size) return -1;
            if (!include[index]) {
                include[index] = 1;
                out.push_back({c, r, p, l, pino});
            }
            return 0;
        };
        if (prg == 0 || prg == 1) {  // LRCP, RLCP
            bool stop = false;
            uint32_t outer1 = prg == 0 ? layno1 : resno1, outer0 = prg == 0 ? 0 : resno0;
            uint32_t inner1 = prg == 0 ? resno1 : layno1, inner0 = prg == 0 ? resno0 : 0;
            for (uint32_t a = outer0; a < outer1 && !stop; ++a)
                for (uint32_t b = inner0; b < inner1 && !stop; ++b) {
                    uint32_t layno = prg == 0 ? a : b, resno = prg == 0 ? b : a;
                    for (uint32_t c = compno0; c < compno1 && !stop; ++c) {
                        if (resno >= pc[c].numresolutions) continue;
                        const PiRes& r = pc[c].res[resno];
                        uint32_t precno1 = r.pw * r.ph;
                        for (uint32_t p = 0; p < precno1; ++p)
                            if (emit(layno, resno, c, p) < 0) { stop = true; break; }
                    }
                }
            continue;
        }
        // RPCL, PCRL, CPRL: positions on the reference grid
        auto min_step = [&](uint32_t c0, uint32_t c1, uint32_t* dx, uint32_t* dy) {
            *dx = *dy = 0;
            for (uint32_t c = c0; c < c1; ++c)
                for (uint32_t r = 0; r < pc[c].numresolutions; ++r) {
                    const PiRes& rr = pc[c].res[r];
                    uint32_t lv = pc[c].numresolutions - 1 - r;
                    if (rr.pdx + lv < 32 && pc[c].dx <= 0xFFFFFFFFu / (1u << (rr.pdx + lv))) {
                        uint32_t v = pc[c].dx * (1u << (rr.pdx + lv));
                        *dx = !*dx ? v : std::min(*dx, v);
                    }
                    if (rr.pdy + lv < 32 && pc[c].dy <= 0xFFFFFFFFu / (1u << (rr.pdy + lv))) {
                        uint32_t v = pc[c].dy * (1u << (rr.pdy + lv));
                        *dy = !*dy ? v : std::min(*dy, v);
                    }
                }
        };
        // the precinct of (x, y) for component c at resolution r, or -1
        auto precinct_at = [&](uint32_t c, uint32_t resno, uint32_t x, uint32_t y) -> int64_t {
            const PiComp& comp = pc[c];
            const PiRes& res = comp.res[resno];
            uint32_t levelno = comp.numresolutions - 1 - resno;
            // in 64 bits, as OpenJPEG 2.5.3 iterates (cv2 decodes 33 resolutions so)
            const uint64_t dxl = (uint64_t)comp.dx << levelno, dyl = (uint64_t)comp.dy << levelno;
            uint64_t trx0 = ((uint64_t)tx0 + dxl - 1) / dxl, try0 = ((uint64_t)ty0 + dyl - 1) / dyl;
            uint64_t trx1 = ((uint64_t)tx1 + dxl - 1) / dxl, try1 = ((uint64_t)ty1 + dyl - 1) / dyl;
            uint32_t rpx = res.pdx + levelno, rpy = res.pdy + levelno;
            if (rpx >= 63 || rpy >= 63) return -1;
            if (!(((uint64_t)y % ((uint64_t)comp.dy << rpy) == 0) ||
                  ((y == (uint32_t)ty0) && ((try0 << levelno) % ((uint64_t)1 << rpy)))))
                return -1;
            if (!(((uint64_t)x % ((uint64_t)comp.dx << rpx) == 0) ||
                  ((x == (uint32_t)tx0) && ((trx0 << levelno) % ((uint64_t)1 << rpx)))))
                return -1;
            if (res.pw == 0 || res.ph == 0) return -1;
            if (trx0 == trx1 || try0 == try1) return -1;
            uint64_t prci = (((uint64_t)x + dxl - 1) / dxl >> res.pdx) - (trx0 >> res.pdx);
            uint64_t prcj = (((uint64_t)y + dyl - 1) / dyl >> res.pdy) - (try0 >> res.pdy);
            return (int64_t)prci + (int64_t)prcj * res.pw;
        };
        bool stop = false;
        auto layers = [&](uint32_t r, uint32_t c, int64_t p) {
            for (uint32_t l = 0; l < layno1 && !stop; ++l)
                if (emit(l, r, c, (uint32_t)p) < 0) stop = true;
        };
        if (prg == 2 || prg == 3) {
            uint32_t dx, dy;
            min_step(0, numcomps, &dx, &dy);
            if (dx == 0 || dy == 0) continue;
            if (prg == 2) {  // RPCL
                for (uint32_t r = resno0; r < resno1 && !stop; ++r)
                    for (uint32_t y = ty0; y < (uint32_t)ty1 && !stop; y += dy - (y % dy))
                        for (uint32_t x = tx0; x < (uint32_t)tx1 && !stop; x += dx - (x % dx))
                            for (uint32_t c = compno0; c < compno1 && !stop; ++c) {
                                if (r >= pc[c].numresolutions) continue;
                                int64_t p = precinct_at(c, r, x, y);
                                if (p >= 0) layers(r, c, p);
                            }
            } else {  // PCRL
                for (uint32_t y = ty0; y < (uint32_t)ty1 && !stop; y += dy - (y % dy))
                    for (uint32_t x = tx0; x < (uint32_t)tx1 && !stop; x += dx - (x % dx))
                        for (uint32_t c = compno0; c < compno1 && !stop; ++c)
                            for (uint32_t r = resno0;
                                 r < std::min(resno1, pc[c].numresolutions) && !stop; ++r) {
                                int64_t p = precinct_at(c, r, x, y);
                                if (p >= 0) layers(r, c, p);
                            }
            }
        } else {  // CPRL
            for (uint32_t c = compno0; c < compno1 && !stop; ++c) {
                uint32_t dx, dy;
                min_step(c, c + 1, &dx, &dy);
                if (dx == 0 || dy == 0) { stop = true; break; }
                for (uint32_t y = ty0; y < (uint32_t)ty1 && !stop; y += dy - (y % dy))
                    for (uint32_t x = tx0; x < (uint32_t)tx1 && !stop; x += dx - (x % dx))
                        for (uint32_t r = resno0; r < std::min(resno1, pc[c].numresolutions) && !stop;
                             ++r) {
                            int64_t p = precinct_at(c, r, x, y);
                            if (p >= 0) layers(r, c, p);
                        }
            }
        }
    }
    return out;
}

void Decoder::decode_tile(uint32_t tileno, bool whole) {
    TCP& tcp = tcps_[tileno];
    if (!tcp.has_data) refuse("Failed to decode tile: no data");
    const uint32_t numcomps = (uint32_t)comps.size();
    const uint32_t p = tileno % tw_, q = tileno / tw_;
    uint32_t ltx0 = tx0_ + p * tdx_, lty0 = ty0_ + q * tdy_;
    int32_t tx0 = (int32_t)std::max(ltx0, x0), tx1 = (int32_t)std::min(uint_adds(ltx0, tdx_), x1);
    int32_t ty0 = (int32_t)std::max(lty0, y0), ty1 = (int32_t)std::min(uint_adds(lty0, tdy_), y1);
    if (tx0 < 0 || tx1 <= tx0) refuse("Tile X coordinates are not supported");
    if (ty0 < 0 || ty1 <= ty0) refuse("Tile Y coordinates are not supported");

    // the tile's components, resolutions, bands, precincts and code-blocks
    std::vector<TileComp> tcs(numcomps);
    std::vector<PiComp> pcs(numcomps);
    uint32_t max_res = 0, max_prec = 0;
    for (uint32_t c = 0; c < numcomps; ++c) {
        const TCCP& t = tcp.tccps[c];
        const Comp& ic = comps[c];
        TileComp& tc = tcs[c];
        tc.x0 = int_ceildiv(tx0, (int32_t)ic.dx);
        tc.y0 = int_ceildiv(ty0, (int32_t)ic.dy);
        tc.x1 = int_ceildiv(tx1, (int32_t)ic.dx);
        tc.y1 = int_ceildiv(ty1, (int32_t)ic.dy);
        tc.numresolutions = t.numresolutions;
        tc.res.resize(t.numresolutions);
        PiComp& pcomp = pcs[c];
        pcomp.dx = ic.dx;
        pcomp.dy = ic.dy;
        pcomp.numresolutions = t.numresolutions;
        pcomp.res.resize(t.numresolutions);
        max_res = std::max(max_res, t.numresolutions);
        size_t step = 0;
        for (uint32_t r = 0; r < t.numresolutions; ++r) {
            Resolution& res = tc.res[r];
            const int32_t level = (int32_t)(t.numresolutions - 1 - r);
            res.x0 = int_ceildivpow2(tc.x0, level);
            res.y0 = int_ceildivpow2(tc.y0, level);
            res.x1 = int_ceildivpow2(tc.x1, level);
            res.y1 = int_ceildivpow2(tc.y1, level);
            const uint32_t pdx = t.prcw[r], pdy = t.prch[r];
            res.pdx = pdx;
            res.pdy = pdy;
            int32_t prc_x0 = int_floordivpow2(res.x0, (int32_t)pdx) << pdx;
            int32_t prc_y0 = int_floordivpow2(res.y0, (int32_t)pdy) << pdy;
            int64_t prc_x1 = (int64_t)(uint32_t)int_ceildivpow2(res.x1, (int32_t)pdx) << pdx;
            int64_t prc_y1 = (int64_t)(uint32_t)int_ceildivpow2(res.y1, (int32_t)pdy) << pdy;
            res.pw = res.x0 == res.x1 ? 0 : (uint32_t)((prc_x1 - prc_x0) >> pdx);
            res.ph = res.y0 == res.y1 ? 0 : (uint32_t)((prc_y1 - prc_y0) >> pdy);
            if (res.pw && (uint64_t)res.pw * res.ph > 0xFFFFFFFFull)
                refuse("Size of tile data exceeds system limits");
            pcomp.res[r] = {pdx, pdy, res.pw, res.ph};
            max_prec = std::max(max_prec, res.pw * res.ph);
            const uint32_t nprec = res.pw * res.ph;
            int32_t cbg_x0, cbg_y0;
            uint32_t cbgw, cbgh;
            if (r == 0) {
                cbg_x0 = prc_x0;
                cbg_y0 = prc_y0;
                cbgw = pdx;
                cbgh = pdy;
                res.numbands = 1;
            } else {
                cbg_x0 = int_ceildivpow2(prc_x0, 1);
                cbg_y0 = int_ceildivpow2(prc_y0, 1);
                cbgw = pdx - 1;
                cbgh = pdy - 1;
                res.numbands = 3;
            }
            const uint32_t cblkw = std::min(t.cblkw, cbgw), cblkh = std::min(t.cblkh, cbgh);
            for (uint32_t b = 0; b < res.numbands; ++b, ++step) {
                Band& band = res.bands[b];
                if (r == 0) {
                    band.bandno = 0;
                    band.x0 = int_ceildivpow2(tc.x0, level);
                    band.y0 = int_ceildivpow2(tc.y0, level);
                    band.x1 = int_ceildivpow2(tc.x1, level);
                    band.y1 = int_ceildivpow2(tc.y1, level);
                } else {
                    band.bandno = b + 1;
                    int64_t x0b = band.bandno & 1, y0b = band.bandno >> 1;
                    band.x0 = int64_ceildivpow2(tc.x0 - (x0b << level), level + 1);
                    band.y0 = int64_ceildivpow2(tc.y0 - (y0b << level), level + 1);
                    band.x1 = int64_ceildivpow2(tc.x1 - (x0b << level), level + 1);
                    band.y1 = int64_ceildivpow2(tc.y1 - (y0b << level), level + 1);
                }
                const StepSize& ss = t.stepsizes[std::min(step, (size_t)MAXBANDS - 1)];
                const int32_t log2_gain = t.qmfbid == 0 ? 0
                                          : band.bandno == 0 ? 0
                                          : band.bandno == 3 ? 2 : 1;
                const int32_t rb = (int32_t)ic.prec + log2_gain;
                band.stepsize =
                    (float)((1.0 + ss.mant / 2048.0) * std::pow(2.0, (int32_t)(rb - ss.expn)));
                band.numbps = ss.expn + (int32_t)t.numgbits - 1;
                band.precincts.resize(nprec);
                for (uint32_t pn = 0; pn < nprec; ++pn) {
                    Precinct& prc = band.precincts[pn];
                    int32_t gx0 = cbg_x0 + (int32_t)(pn % res.pw) * (1 << cbgw);
                    int32_t gy0 = cbg_y0 + (int32_t)(pn / res.pw) * (1 << cbgh);
                    prc.x0 = std::max(gx0, band.x0);
                    prc.y0 = std::max(gy0, band.y0);
                    prc.x1 = std::min(gx0 + (1 << cbgw), band.x1);
                    prc.y1 = std::min(gy0 + (1 << cbgh), band.y1);
                    int32_t bx0 = int_floordivpow2(prc.x0, (int32_t)cblkw) << cblkw;
                    int32_t by0 = int_floordivpow2(prc.y0, (int32_t)cblkh) << cblkh;
                    int32_t bx1 = int_ceildivpow2(prc.x1, (int32_t)cblkw) << cblkw;
                    int32_t by1 = int_ceildivpow2(prc.y1, (int32_t)cblkh) << cblkh;
                    prc.cw = bx1 > bx0 ? (uint32_t)((bx1 - bx0) >> cblkw) : 0;
                    prc.ch = by1 > by0 ? (uint32_t)((by1 - by0) >> cblkh) : 0;
                    const uint32_t ncb = prc.cw * prc.ch;
                    prc.cblks.resize(ncb);
                    for (uint32_t k = 0; k < ncb; ++k) {
                        Cblk& cb = prc.cblks[k];
                        int32_t cx0 = bx0 + (int32_t)(k % prc.cw) * (1 << cblkw);
                        int32_t cy0 = by0 + (int32_t)(k / prc.cw) * (1 << cblkh);
                        cb.x0 = std::max(cx0, prc.x0);
                        cb.y0 = std::max(cy0, prc.y0);
                        cb.x1 = std::min(cx0 + (1 << cblkw), prc.x1);
                        cb.y1 = std::min(cy0 + (1 << cblkh), prc.y1);
                    }
                    prc.incl = TagTree(prc.cw, prc.ch);
                    prc.imsb = TagTree(prc.cw, prc.ch);
                }
            }
        }
    }

    // Tier-2
    const std::vector<uint8_t>& data = tcp.data;
    size_t cur = 0;
    std::vector<uint8_t>* packed = ppm_ ? &ppm_data_ : tcp.ppt ? &tcp.ppt_data : nullptr;
    size_t* packed_pos = ppm_ ? &ppm_pos_ : &tcp.ppt_pos;
    // OpenJPEG skips a packet none of whose bands' precincts meets the tile
    // (widened by the filter's margin): its data is passed over, its
    // resolution does not count as decoded, and a component whose packets
    // in a progression were all skipped so far counts as decoded to the top
    std::vector<bool> first_pass_failed(numcomps, true);
    uint32_t last_pino = 0;
    auto meets = [&](const TileComp& tc, const TCCP& t, uint32_t resno, const Band& band,
                     const Precinct& prc) {
        const uint32_t margin = t.qmfbid == 1 ? 2 : 3;
        const uint32_t nb = resno == 0 ? tc.numresolutions - 1 : tc.numresolutions - resno;
        const uint32_t x0b = band.bandno & 1, y0b = band.bandno >> 1;
        auto sub = [&](uint32_t v, uint32_t b) -> uint32_t {
            if (nb == 0) return v;
            const uint64_t off = ((uint64_t)1 << (nb - 1)) * b;
            if (v <= off) return 0;
            return (uint32_t)((v - off + ((uint64_t)1 << nb) - 1) >> nb);
        };
        uint32_t bx0 = sub((uint32_t)tc.x0, x0b), by0 = sub((uint32_t)tc.y0, y0b);
        uint32_t bx1 = sub((uint32_t)tc.x1, x0b), by1 = sub((uint32_t)tc.y1, y0b);
        bx0 = bx0 < margin ? 0 : bx0 - margin;
        by0 = by0 < margin ? 0 : by0 - margin;
        bx1 = uint_adds(bx1, margin);
        by1 = uint_adds(by1, margin);
        return (uint32_t)prc.x0 < bx1 && (uint32_t)prc.y0 < by1 && (uint32_t)prc.x1 > bx0 &&
               (uint32_t)prc.y1 > by0;
    };
    for (const Packet& pk : packets(tileno, pcs, max_res, max_prec, tx0, ty0, tx1, ty1)) {
        TileComp& tc = tcs[pk.compno];
        Resolution& res = tc.res[pk.resno];
        const TCCP& t = tcp.tccps[pk.compno];
        const uint8_t* src = data.data() + cur;
        const size_t max_len = data.size() - cur;
        if (pk.pino != last_pino) {
            first_pass_failed.assign(numcomps, true);
            last_pino = pk.pino;
        }
        bool skip = true;
        for (uint32_t b = 0; b < res.numbands && skip; ++b)
            if (pk.precno < res.bands[b].precincts.size() &&
                meets(tc, t, pk.resno, res.bands[b], res.bands[b].precincts[pk.precno]))
                skip = false;
        if (!skip) first_pass_failed[pk.compno] = false;
        // after the packet: the resolution decoded, or the jump of a skipped one
        auto done = [&]() {
            if (!skip) tc.resno_decoded = std::max(tc.resno_decoded, pk.resno);
            if (first_pass_failed[pk.compno] && tc.resno_decoded == 0)
                tc.resno_decoded = tc.numresolutions - 1;
        };
        if (pk.layno == 0) {
            for (uint32_t b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                if (band.empty()) continue;
                if (pk.precno >= band.precincts.size()) refuse("Invalid precinct");
                Precinct& prc = band.precincts[pk.precno];
                prc.incl.reset();
                prc.imsb.reset();
                for (Cblk& cb : prc.cblks) cb.numsegs = cb.real_num_segs = 0;
            }
        }
        size_t hpos = 0;
        if (tcp.csty & 0x02) {  // SOP: optional, skipped where present
            if (max_len >= 6 && src[0] == 0xff && src[1] == 0x91) hpos = 6;
        }
        // the packet header: in the packet, or next in the PPM / PPT headers
        const uint8_t* hdr = packed ? packed->data() + *packed_pos : src + hpos;
        const size_t remaining = packed ? packed->size() - *packed_pos : max_len - hpos;
        Bio bio(hdr, remaining);
        bool present = bio.read(1);
        auto eph = [&](size_t at) -> size_t {  // EPH: required
            if (!(tcp.csty & 0x04)) return at;
            if (remaining - at < 2) refuse("Not enough space for required EPH marker");
            if (hdr[at] != 0xff || hdr[at + 1] != 0x92) refuse("Expected EPH marker");
            return at + 2;
        };
        // the header's length; returns where the packet's body starts
        auto header_done = [&](size_t len) -> size_t {
            if (!packed) return hpos + len;
            *packed_pos += len;
            return hpos;
        };
        if (!present) {
            bio.inalign();
            cur += header_done(eph(bio.numbytes()));
            done();
            continue;
        }
        for (uint32_t b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            Precinct& prc = band.precincts[pk.precno];
            for (uint32_t k = 0; k < prc.cblks.size(); ++k) {
                Cblk& cb = prc.cblks[k];
                uint32_t included = !cb.numsegs
                                        ? prc.incl.decode(bio, k, (int32_t)(pk.layno + 1))
                                        : bio.read(1);
                if (!included) {
                    cb.numnewpasses = 0;
                    continue;
                }
                if (!cb.numsegs) {
                    uint32_t i = 0;
                    while (!prc.imsb.decode(bio, k, (int32_t)i)) ++i;
                    cb.numbps = (uint32_t)band.numbps + 1 - i;
                    cb.numlenbits = 3;
                }
                // number of coding passes
                uint32_t np;
                if (!bio.read(1)) np = 1;
                else if (!bio.read(1)) np = 2;
                else if ((np = bio.read(2)) != 3) np += 3;
                else if ((np = bio.read(5)) != 31) np += 6;
                else np = 37 + bio.read(7);
                cb.numnewpasses = np;
                uint32_t incr = 0;
                while (bio.read(1)) ++incr;
                cb.numlenbits += incr;
                auto init_seg = [&](uint32_t index, bool first) {
                    if (cb.segs.size() <= index) cb.segs.resize(index + 1);
                    Seg& s = cb.segs[index];
                    s = Seg();
                    if (t.cblksty & 0x04) s.maxpasses = 1;
                    else if (t.cblksty & 0x01) {
                        if (first) s.maxpasses = 10;
                        else {
                            uint32_t pm = cb.segs[index - 1].maxpasses;
                            s.maxpasses = (pm == 1 || pm == 10) ? 2 : 1;
                        }
                    } else s.maxpasses = 109;
                };
                uint32_t segno = 0;
                if (!cb.numsegs) {
                    init_seg(0, true);
                } else {
                    segno = cb.numsegs - 1;
                    if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) init_seg(++segno, false);
                }
                int32_t n = (int32_t)np;
                do {
                    Seg& s = cb.segs[segno];
                    s.numnewpasses = (uint32_t)std::min((int32_t)(s.maxpasses - s.numpasses), n);
                    uint32_t bits = cb.numlenbits + floorlog2(s.numnewpasses);
                    if (bits > 32) refuse("Invalid bit number in opj_t2_read_packet_header()");
                    s.newlen = bio.read(bits);
                    n -= (int32_t)s.numnewpasses;
                    if (n > 0) init_seg(++segno, false);
                } while (n > 0);
            }
        }
        bio.inalign();
        size_t body = header_done(eph(bio.numbytes()));
        // the packet's body
        size_t dpos = body;
        for (uint32_t b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            Precinct& prc = band.precincts[pk.precno];
            for (Cblk& cb : prc.cblks) {
                if (!cb.numnewpasses) continue;
                size_t si;
                if (!cb.numsegs) {
                    si = 0;
                    cb.numsegs = 1;
                } else {
                    si = cb.numsegs - 1;
                    if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
                        ++si;
                        ++cb.numsegs;
                    }
                }
                do {
                    Seg& s = cb.segs[si];
                    if ((uint64_t)dpos + s.newlen > max_len)
                        refuse(skip ? "skip: segment too long for codeblock"
                                    : "read: segment too long for codeblock");
                    if (!skip) {
                        cb.chunks.push_back({cur + dpos, s.newlen});
                        s.len += s.newlen;
                    }
                    dpos += s.newlen;
                    s.numpasses += s.numnewpasses;
                    cb.numnewpasses -= s.numnewpasses;
                    if (!skip) s.real_num_passes = s.numpasses;
                    if (cb.numnewpasses > 0) {
                        ++si;
                        ++cb.numsegs;
                    }
                } while (cb.numnewpasses > 0);
                if (!skip) cb.real_num_segs = cb.numsegs;
            }
        }
        cur += dpos;
        done();
    }

    // Tier-1 into each component's coefficients
    T1 t1;
    for (uint32_t c = 0; c < numcomps; ++c) {
        TileComp& tc = tcs[c];
        const TCCP& t = tcp.tccps[c];
        const size_t tw = (size_t)(tc.x1 - tc.x0), th = (size_t)(tc.y1 - tc.y0);
        if (t.qmfbid == 1) tc.idata.assign(tw * th, 0);
        else tc.fdata.assign(tw * th, 0.0f);
        for (uint32_t r = 0; r < tc.numresolutions; ++r) {
            Resolution& res = tc.res[r];
            for (uint32_t b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                if (band.empty()) continue;
                const float half_step = 0.5f * band.stepsize;
                for (Precinct& prc : band.precincts)
                    for (Cblk& cb : prc.cblks) {
                        if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
                        t1.decode(cb, data, band.bandno, (uint32_t)t.roishift, t.cblksty);
                        int32_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
                        if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
                        if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
                        for (uint32_t j = 0; j < t1.h; ++j) {
                            const int32_t* src = &t1.data[(size_t)j * t1.w];
                            size_t o = (size_t)(y + j) * tw + x;
                            if (t.qmfbid == 1) {
                                for (uint32_t i = 0; i < t1.w; ++i) tc.idata[o + i] = src[i] / 2;
                            } else {
                                for (uint32_t i = 0; i < t1.w; ++i)
                                    tc.fdata[o + i] = (float)src[i] * half_step;
                            }
                        }
                    }
            }
        }
        if (t.qmfbid == 1) idwt53_tile(tc, tc.resno_decoded + 1);
        else idwt97_tile(tc, tc.resno_decoded + 1);
    }

    // multiple component transform
    if (tcp.mct) {
        if (numcomps >= 3) {
            const size_t n0 = tcs[0].idata.size() + tcs[0].fdata.size();
            if (tcs[0].numresolutions != tcs[1].numresolutions ||
                tcs[0].numresolutions != tcs[2].numresolutions ||
                tcs[0].resno_decoded != tcs[1].resno_decoded ||
                tcs[0].resno_decoded != tcs[2].resno_decoded ||
                (size_t)(tcs[1].x1 - tcs[1].x0) * (tcs[1].y1 - tcs[1].y0) != n0 ||
                (size_t)(tcs[2].x1 - tcs[2].x0) * (tcs[2].y1 - tcs[2].y0) != n0)
                refuse("Tiles don't all have the same dimension. Skip the MCT step.");
            // opj_tcd_mct_decode: component 0's wavelet picks the transform,
            // which runs over the three buffers as they lie. A component of
            // the other wavelet is read through its bits (OpenJPEG keeps one
            // 32-bit buffer for both), and keeps what the transform wrote
            // there for its own DC shift to read the same way.
            std::vector<uint32_t> w[3];
            for (int c = 0; c < 3; ++c) {
                w[c].resize(n0);
                const void* src = tcs[c].idata.empty() ? (const void*)tcs[c].fdata.data()
                                                       : (const void*)tcs[c].idata.data();
                std::memcpy(w[c].data(), src, n0 * 4);
            }
            if (tcp.tccps[0].qmfbid == 1) {  // opj_mct_decode: int32, wrapping as SSE2's adds
                for (size_t i = 0; i < n0; ++i) {
                    const uint32_t y = w[0][i], u = w[1][i], v = w[2][i];
                    const uint32_t g = y - (uint32_t)((int32_t)(u + v) >> 2);
                    w[0][i] = v + g;
                    w[1][i] = g;
                    w[2][i] = u + g;
                }
            } else {  // opj_mct_decode_real: float32
                for (size_t i = 0; i < n0; ++i) {
                    float y, u, v;
                    std::memcpy(&y, &w[0][i], 4);
                    std::memcpy(&u, &w[1][i], 4);
                    std::memcpy(&v, &w[2][i], 4);
                    float vr = v * 1.402f;
                    float r = y + vr;
                    float ug = u * 0.34413f, vg = v * 0.71414f;
                    float g = y - ug;
                    g = g - vg;
                    float ub = u * 1.772f;
                    float b = y + ub;
                    std::memcpy(&w[0][i], &r, 4);
                    std::memcpy(&w[1][i], &g, 4);
                    std::memcpy(&w[2][i], &b, 4);
                }
            }
            for (int c = 0; c < 3; ++c) {
                void* dst = tcs[c].idata.empty() ? (void*)tcs[c].fdata.data()
                                                 : (void*)tcs[c].idata.data();
                std::memcpy(dst, w[c].data(), n0 * 4);
            }
        }
    }

    // DC level shift and clamp over the resolution the packets reached (the
    // whole tile-component unless a POC left levels out); past it the buffer
    // keeps its coefficients (9/7: their float32 bits), as OpenJPEG leaves it
    for (uint32_t c = 0; c < numcomps; ++c) {
        TileComp& tc = tcs[c];
        const TCCP& t = tcp.tccps[c];
        const Comp& ic = comps[c];
        int32_t lmin, lmax;
        if (ic.sgnd) {
            lmin = -(1 << (ic.prec - 1));
            lmax = (1 << (ic.prec - 1)) - 1;
        } else {
            lmin = 0;
            lmax = (int32_t)((1u << ic.prec) - 1);
        }
        const size_t tw = (size_t)(tc.x1 - tc.x0), th = (size_t)(tc.y1 - tc.y0);
        const Resolution& rr = tc.res[tc.resno_decoded];
        const size_t rw = (size_t)(rr.x1 - rr.x0), rh = (size_t)(rr.y1 - rr.y0);
        std::vector<int32_t> out(tw * th);
        for (size_t j = 0; j < th; ++j)
            for (size_t i = 0; i < tw; ++i) {
                const size_t k = j * tw + i;
                if (t.qmfbid == 1) {
                    int64_t v = tc.idata[k];
                    out[k] = j < rh && i < rw
                                 ? (int32_t)std::max<int64_t>(lmin, std::min<int64_t>(
                                                                        lmax, v + t.dc_level_shift))
                                 : (int32_t)v;
                } else {
                    float v = tc.fdata[k];
                    if (!(j < rh && i < rw)) std::memcpy(&out[k], &v, 4);
                    else if (v > (float)INT32_MAX) out[k] = lmax;
                    else if (v < (float)INT32_MIN) out[k] = lmin;
                    else {
                        int64_t iv = (int64_t)std::lrintf(v) + t.dc_level_shift;
                        out[k] = (int32_t)std::max<int64_t>(lmin, std::min<int64_t>(lmax, iv));
                    }
                }
            }
        decoded_[c] = true;
        std::vector<int32_t>& plane = planes[c];
        if (whole) {  // the tile is the image: its buffer is the component's
            plane.swap(out);
            continue;
        }
        // opj_j2k_update_image_data: the decoded resolution's area, placed
        // by its own coordinates on the component's full-resolution grid
        if (plane.empty()) plane.assign((size_t)ic.w * ic.h, 0);
        auto span = [](uint32_t d0, uint32_t len, int64_t r0, int64_t r1, uint32_t* start,
                       uint32_t* off, uint32_t* n) {
            const uint32_t d1 = d0 + len, src = (uint32_t)(r1 - r0);
            if ((int64_t)d0 < r0) {
                *start = (uint32_t)(r0 - d0);
                *off = 0;
                *n = (int64_t)d1 >= r1 ? src : (uint32_t)(d1 - r0);
            } else {
                *start = 0;
                *off = (uint32_t)(d0 - r0);
                *n = (int64_t)d1 >= r1 ? src - *off : len;
            }
        };
        uint32_t sx, ox, nx, sy, oy, ny;
        span(ic.x0, ic.w, rr.x0, rr.x1, &sx, &ox, &nx);
        span(ic.y0, ic.h, rr.y0, rr.y1, &sy, &oy, &ny);
        // a decoded resolution whose area misses the component's (an image
        // offset past the last level a POC reached) gives a negative width
        // there, and opj_j2k_update_image_data fails the decode
        if ((uint64_t)sx + nx > ic.w || (uint64_t)sy + ny > ic.h || (uint64_t)ox + nx > tw ||
            (uint64_t)oy + ny > th)
            refuse("a tile's decoded area falls outside its component");
        for (uint32_t j = 0; j < ny; ++j)
            std::memcpy(&plane[(size_t)(sy + j) * ic.w + sx], &out[(size_t)(oy + j) * tw + ox],
                        (size_t)nx * 4);
    }
    tcp.data.clear();
    tcp.data.shrink_to_fit();
    tcp.has_data = false;
}

// opj_j2k_decode_tile's end: the next marker after a decoded tile
void Decoder::after_tile() {
    can_decode_ = false;
    state_ &= ~ST_DATA;
    if (left() == 0 && state_ == ST_NEOC) return;
    if (state_ != ST_EOC) {
        uint32_t m;
        if (!read2(&m)) refuse("Stream too short");
        if (m == MS_EOC) {
            current_tile_ = 0;
            state_ = ST_EOC;
        } else if (m != MS_SOT) {
            if (left() == 0) {
                state_ = ST_NEOC;
                return;
            }
            refuse("Stream too short, expected SOT");
        }
    }
}

void Decoder::decode() {
    read_header();
    const size_t nc = comps.size();
    planes.assign(nc, std::vector<int32_t>());
    decoded_.assign(nc, false);
    const uint32_t nb_tiles = tw_ * th_;
    uint32_t tile = 0;
    bool go_on = true;
    if (tw_ == 1 && th_ == 1 && tx0_ == 0 && ty0_ == 0 && x0 == 0 && y0 == 0 && x1 == tdx_ &&
        y1 == tdy_) {
        if (!read_tile_header(&tile, &go_on)) refuse("Failed to read the tile header");
        if (!go_on || !(state_ & ST_DATA) || tile != current_tile_)
            refuse("Failed to decode tile 1/1");
        decode_tile(tile, true);
        after_tile();
        return;
    }
    uint32_t nr = 0;
    for (;;) {
        if (!read_tile_header(&tile, &go_on)) refuse("Failed to read the tile header");
        if (!go_on) break;
        if (!(state_ & ST_DATA) || tile != current_tile_) refuse("Failed to decode tile");
        decode_tile(tile, false);
        after_tile();
        if (left() == 0 && state_ == ST_NEOC) break;
        if (++nr == nb_tiles) break;
    }
    for (size_t c = 0; c < nc; ++c)
        if (!decoded_[c]) refuse("Failed to decode all used components");
}

void copy_msg(const std::string& m, char* msg, int64_t len) {
    if (!msg || len <= 0) return;
    size_t n = std::min((size_t)len - 1, m.size());
    std::memcpy(msg, m.data(), n);
    msg[n] = 0;
}

}  // namespace

extern "C" {

// The main header of the codestream `data` (`size` bytes: from SOC to the
// end of the data).  `info`: x0, y0, x1, y1, number of components, then per
// component prec, sgnd, dx, dy, x0, y0, w, h (at most (info_len - 5) / 8
// components are written).  `ihdr_w`, `ihdr_h`: a JP2 file's ihdr sides
// (0 for a raw codestream).  0: read; 1: OpenJPEG refuses it; 2: a form the
// port does not decode (the reason in `msg`).
int j2k_header(const uint8_t* data, int64_t size, uint32_t ihdr_w, uint32_t ihdr_h,
               int64_t* info, int64_t info_len, char* msg, int64_t msg_len) {
    try {
        Decoder dec(data, size, ihdr_w, ihdr_h);
        dec.read_header();
        info[0] = dec.x0;
        info[1] = dec.y0;
        info[2] = dec.x1;
        info[3] = dec.y1;
        info[4] = (int64_t)dec.comps.size();
        for (size_t i = 0; i < dec.comps.size() && (int64_t)(5 + 8 * i + 8) <= info_len; ++i) {
            const Comp& c = dec.comps[i];
            int64_t* o = info + 5 + 8 * i;
            o[0] = c.prec; o[1] = c.sgnd; o[2] = c.dx; o[3] = c.dy;
            o[4] = c.x0; o[5] = c.y0; o[6] = c.w; o[7] = c.h;
        }
        return 0;
    } catch (const Error& e) {
        copy_msg(e.msg, msg, msg_len);
        return e.code;
    } catch (const std::bad_alloc&) {
        copy_msg("out of memory", msg, msg_len);
        return 1;
    }
}

// The whole codestream decoded: component i's w x h samples at
// out + offsets[i] (int32).  Returns as j2k_header.
int j2k_decode(const uint8_t* data, int64_t size, uint32_t ihdr_w, uint32_t ihdr_h, int32_t* out,
               const int64_t* offsets, int64_t ncomps, char* msg, int64_t msg_len) {
    try {
        Decoder dec(data, size, ihdr_w, ihdr_h);
        dec.decode();
        if ((int64_t)dec.comps.size() != ncomps) throw Error{1, "component count changed"};
        for (int64_t i = 0; i < ncomps; ++i)
            std::memcpy(out + offsets[i], dec.planes[i].data(), dec.planes[i].size() * 4);
        return 0;
    } catch (const Error& e) {
        copy_msg(e.msg, msg, msg_len);
        return e.code;
    } catch (const std::bad_alloc&) {
        copy_msg("out of memory", msg, msg_len);
        return 1;
    }
}

}  // extern "C"
