// A WebP lossless (VP8L) encoder: the bit stream of the file cv2.imwrite
// writes for ".webp" at its default parameters (libwebp's
// WebPEncodeLosslessBGR / BGRA).  libwebp picks its transforms, LZ77
// references and prefix codes by heuristics that change between versions,
// so this encoder is held to what a lossless file means: every decoder
// returns the input's pixels.  It links no libwebp; the decoder
// (webp.cpp) is the model for every table.
//
// The stream (WebP lossless bit-stream specification):
//   - header: signature 0x2f, 14-bit sides, the alpha hint, version 0;
//   - transforms: colour indexing where the image has at most 256 colours
//     (pixels bundled 8, 4 or 2 to a byte at <= 2, <= 4 and <= 16
//     colours), otherwise subtract-green, the predictor transform (modes
//     0-13 per tile of 16 or 32, tile size and modes by an entropy
//     estimate) and the cross-colour transform (per tile);
//   - LZ77 over a hash chain with the 120 plane codes for 2-D distances,
//     then a colour cache whose size is chosen by cost;
//   - prefix codes limited to 15 bits, written with the code-length code
//     and its repeat codes (or as a simple code of one or two symbols);
//   - one prefix-code group for the image.
// Some choices are made by encoding both ways and keeping the shorter: an
// image of 17-256 colours is written with colour indexing and with the
// predictors, the cross-colour transform is kept where it shortens the
// stream, and an image of at most 2^16 pixels is also tried with
// subtract-green alone.
//
// Every decision is made in integer arithmetic (costs in 1/65536 bit, from
// an integer log2), so that every machine writes the same bytes.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// -- costs ------------------------------------------------------------------

// log2(n) in 1/65536 units, by the bitwise squaring method: integer only
int64_t log2_q16(uint64_t n) {
    if (n <= 1) return 0;
    int k = 63 - __builtin_clzll(n);
    uint64_t m = k <= 30 ? n << (30 - k) : n >> (k - 30);  // mantissa in [1, 2), 30 fraction bits
    int64_t res = (int64_t)k << 16;
    for (int i = 15; i >= 0; --i) {
        m = (m * m) >> 30;
        if (m >= (2ull << 30)) {
            m >>= 1;
            res |= (int64_t)1 << i;
        }
    }
    return res;
}

constexpr int kLogTable = 1 << 16;

// n * log2(n) in 1/65536 bit
inline int64_t nlogn(uint64_t n) {
    static const std::vector<int64_t> table = [] {
        std::vector<int64_t> t(kLogTable);
        for (int i = 0; i < kLogTable; ++i) t[i] = (int64_t)i * log2_q16((uint64_t)i);
        return t;
    }();
    return n < (uint64_t)kLogTable ? table[n] : (int64_t)n * log2_q16(n);
}

// Shannon bits of a histogram, 1/65536 bit
int64_t entropy(const uint32_t* h, int n) {
    uint64_t total = 0;
    int64_t sum = 0;
    for (int i = 0; i < n; ++i)
        if (h[i]) {
            total += h[i];
            sum += nlogn(h[i]);
        }
    return nlogn(total) - sum;
}

// -- bits -------------------------------------------------------------------

struct BitWriter {
    std::vector<uint8_t> buf;
    uint64_t acc = 0;
    int nbits = 0;
    inline void put(uint32_t v, int n) {  // n <= 32
        acc |= (uint64_t)v << nbits;
        nbits += n;
        while (nbits >= 8) {
            buf.push_back((uint8_t)acc);
            acc >>= 8;
            nbits -= 8;
        }
    }
    size_t bits() const { return buf.size() * 8 + nbits; }
    void flush() {
        if (nbits) buf.push_back((uint8_t)acc);
        acc = 0;
        nbits = 0;
    }
    void append(const BitWriter& o) {  // o's bits after these
        for (uint8_t b : o.buf) put(b, 8);
        if (o.nbits) put((uint32_t)(o.acc & ((1u << o.nbits) - 1)), o.nbits);
    }
};

// -- prefix codes -----------------------------------------------------------

const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7,
                                      8,  9,  10, 11, 12, 13, 14, 15};

// Huffman code lengths of the symbols with a count, none above `limit`: the
// optimal tree, rebuilt with small counts raised (1, 2, 4, ...) until it is
// shallow enough.  Ties go to the lower symbol.
void huffman_lengths(const uint32_t* hist, int n, int limit, uint8_t* lens) {
    std::fill(lens, lens + n, 0);
    std::vector<int> syms;
    for (int s = 0; s < n; ++s)
        if (hist[s]) syms.push_back(s);
    const int m = (int)syms.size();
    if (m == 0) return;
    if (m == 1) {
        lens[syms[0]] = 1;
        return;
    }
    std::vector<uint64_t> weight(2 * m);
    std::vector<int> left(2 * m), right(2 * m), depth(2 * m), order(m);
    for (uint64_t count_min = 1;; count_min *= 2) {
        for (int i = 0; i < m; ++i) order[i] = i;
        std::vector<uint64_t> w(m);
        for (int i = 0; i < m; ++i) w[i] = std::max<uint64_t>(hist[syms[i]], count_min);
        std::stable_sort(order.begin(), order.end(), [&](int a, int b) { return w[a] < w[b]; });
        for (int i = 0; i < m; ++i) weight[i] = w[order[i]];  // leaves in weight order
        int li = 0, ii = m, next = m;
        auto take = [&]() {
            if (li < m && (ii >= next || weight[li] <= weight[ii])) return li++;
            return ii++;
        };
        while (next < 2 * m - 1) {
            const int a = take(), b = take();
            left[next] = a;
            right[next] = b;
            weight[next] = weight[a] + weight[b];
            ++next;
        }
        depth[2 * m - 2] = 0;
        int max_depth = 0;
        for (int node = 2 * m - 2; node >= m; --node) {
            depth[left[node]] = depth[right[node]] = depth[node] + 1;
        }
        for (int i = 0; i < m; ++i) max_depth = std::max(max_depth, depth[i]);
        if (max_depth <= limit) {
            for (int i = 0; i < m; ++i) lens[syms[order[i]]] = (uint8_t)depth[i];
            return;
        }
    }
}

// canonical codes of `lens`, bit-reversed for the LSB-first stream
void canonical_codes(const uint8_t* lens, int n, uint16_t* codes) {
    int count[16] = {0}, next[16] = {0};
    for (int s = 0; s < n; ++s) ++count[lens[s]];
    count[0] = 0;
    int code = 0;
    for (int l = 1; l < 16; ++l) {
        code = (code + count[l - 1]) << 1;
        next[l] = code;
    }
    for (int s = 0; s < n; ++s) {
        const int l = lens[s];
        if (!l) {
            codes[s] = 0;
            continue;
        }
        const int c = next[l]++;
        int rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((c >> b) & 1) << (l - 1 - b);
        codes[s] = (uint16_t)rev;
    }
}

struct Token {
    uint8_t code, extra;
};

// the code-length tokens of `lens`: literal lengths 0-15, 16 (repeat the
// last non-zero length 3-6 times), 17 (3-10 zeros), 18 (11-138 zeros)
void length_tokens(const uint8_t* lens, int n, std::vector<Token>& out) {
    out.clear();
    int prev = 8;  // the decoder's length before the first non-zero one
    for (int i = 0; i < n;) {
        const int v = lens[i];
        int run = 1;
        while (i + run < n && lens[i + run] == v) ++run;
        i += run;
        if (v == 0) {
            while (run > 0) {
                if (run < 3) {
                    for (; run > 0; --run) out.push_back({0, 0});
                } else if (run <= 10) {
                    out.push_back({17, (uint8_t)(run - 3)});
                    run = 0;
                } else {
                    const int k = std::min(run, 138);
                    out.push_back({18, (uint8_t)(k - 11)});
                    run -= k;
                }
            }
        } else {
            if (v != prev) {
                out.push_back({(uint8_t)v, 0});
                prev = v;
                --run;
            }
            while (run > 0) {
                if (run < 3) {
                    for (; run > 0; --run) out.push_back({(uint8_t)v, 0});
                } else {
                    const int k = std::min(run, 6);
                    out.push_back({16, (uint8_t)(k - 3)});
                    run -= k;
                }
            }
        }
    }
}

const int kTokenExtra[19] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 3, 7};

// A prefix code over `n` symbols for the counts `hist`: its lengths and
// codes for the symbols (length 0: the symbol takes no bits), and the bits
// of its header (`put` writes it).
struct Code {
    std::vector<uint8_t> lens;
    std::vector<uint16_t> codes;
    // header
    bool simple = false;
    int used = 0, s0 = 0, s1 = 0;
    std::vector<Token> tokens;
    size_t kept = 0;  // tokens written (all, or those before the trailing zeros)
    uint8_t cl_lens[19] = {0};  // the code-length code as written
    uint8_t cl_bits[19] = {0};  // and as coded (a lone token takes no bits)
    uint16_t cl_codes[19] = {0};
    int num_cl = 4;
    int64_t header_bits = 0;

    void build(const uint32_t* hist, int n) {
        lens.assign(n, 0);
        codes.assign(n, 0);
        used = 0;
        for (int s = 0; s < n; ++s)
            if (hist[s]) {
                if (used == 0) s0 = s;
                else if (used == 1) s1 = s;
                ++used;
            }
        if (used == 0) {  // nothing coded: one symbol, 0
            simple = true;
            s0 = 0;
            header_bits = 4;
            return;
        }
        if (used <= 2 && s0 < 256 && (used == 1 || s1 < 256)) {
            simple = true;
            header_bits = 3 + (s0 < 2 ? 1 : 8) + (used == 2 ? 8 : 0);
            if (used == 2) {
                lens[s0] = lens[s1] = 1;
                codes[s1] = 1;
            }
            return;
        }
        simple = false;
        huffman_lengths(hist, n, 15, lens.data());
        length_tokens(lens.data(), n, tokens);
        if (used == 1) lens[s0] = 0;  // a single symbol takes no bits
        canonical_codes(lens.data(), n, codes.data());
        // all tokens, or those before a trailing run of zero tokens
        size_t last = tokens.size();
        while (last > 0 && (tokens[last - 1].code == 0 || tokens[last - 1].code >= 17)) --last;
        int64_t best = -1;
        for (int variant = 0; variant < 2; ++variant) {
            const size_t k = variant ? last : tokens.size();
            if (variant && (k == tokens.size() || k < 2)) break;
            uint32_t th[19] = {0};
            for (size_t i = 0; i < k; ++i) ++th[tokens[i].code];
            uint8_t cl[19];
            huffman_lengths(th, 19, 7, cl);
            int ncl = 19;
            while (ncl > 4 && cl[kCodeLengthOrder[ncl - 1]] == 0) --ncl;
            int64_t bits = 1 + 4 + 3 * ncl + 1;
            if (variant) {
                const uint32_t v = (uint32_t)(k - 2);
                int nb = 2;
                while (v >> nb) nb += 2;
                bits += 3 + nb;
            }
            int nsym = 0;
            for (int s = 0; s < 19; ++s) nsym += th[s] ? 1 : 0;
            for (size_t i = 0; i < k; ++i)
                bits += (nsym > 1 ? cl[tokens[i].code] : 0) + kTokenExtra[tokens[i].code];
            if (best < 0 || bits < best) {
                best = bits;
                kept = k;
                num_cl = ncl;
                std::memcpy(cl_lens, cl, sizeof(cl));
                for (int s = 0; s < 19; ++s) cl_bits[s] = nsym > 1 ? cl[s] : 0;
                canonical_codes(cl_bits, 19, cl_codes);
            }
        }
        header_bits = best;
    }

    void put(BitWriter& bw) const {
        if (simple) {
            bw.put(1, 1);
            bw.put(used == 2 ? 1 : 0, 1);
            if (s0 < 2) {
                bw.put(0, 1);
                bw.put(s0, 1);
            } else {
                bw.put(1, 1);
                bw.put(s0, 8);
            }
            if (used == 2) bw.put(s1, 8);
            return;
        }
        bw.put(0, 1);
        bw.put(num_cl - 4, 4);
        for (int i = 0; i < num_cl; ++i) bw.put(cl_lens[kCodeLengthOrder[i]], 3);
        if (kept < tokens.size()) {
            const uint32_t v = (uint32_t)(kept - 2);
            int nb = 2;
            while (v >> nb) nb += 2;
            bw.put(1, 1);
            bw.put((nb - 2) / 2, 3);
            bw.put(v, nb);
        } else {
            bw.put(0, 1);
        }
        for (size_t i = 0; i < kept; ++i) {
            const Token& t = tokens[i];
            bw.put(cl_codes[t.code], cl_bits[t.code]);
            if (kTokenExtra[t.code]) bw.put(t.extra, kTokenExtra[t.code]);
        }
    }

    inline void put_symbol(BitWriter& bw, int s) const { bw.put(codes[s], lens[s]); }
    int64_t symbol_bits(const uint32_t* hist, int n) const {
        int64_t b = 0;
        for (int s = 0; s < n; ++s) b += (int64_t)hist[s] * lens[s];
        return b;
    }
};

// -- backward references -----------------------------------------------------

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

struct PlaneCodes {
    uint8_t code[128];  // plane -> code - 1, 255 where the plane has none
    PlaneCodes() {
        std::memset(code, 255, sizeof(code));
        for (int i = 0; i < 120; ++i) code[kCodeToPlane[i]] = (uint8_t)i;
    }
};

// the distance code of a backward distance in an image `xsize` wide: a
// plane code (1-120) for the 2-D neighbourhood, else distance + 120
inline uint32_t distance_code(int xsize, uint32_t dist) {
    static const PlaneCodes planes;
    const uint32_t yoff = dist / (uint32_t)xsize, xoff = dist - yoff * (uint32_t)xsize;
    if (xoff <= 8 && yoff < 8) return planes.code[yoff * 16 + 8 - xoff] + 1u;
    if ((int)xoff > xsize - 8 && yoff < 7)
        return planes.code[(yoff + 1) * 16 + 8 + ((uint32_t)xsize - xoff)] + 1u;
    return dist + 120;
}

// prefix code, extra bits and their value of a length or distance code v >= 1
inline void prefix_split(uint32_t v, int* code, int* nbits, uint32_t* extra) {
    const uint32_t d = v - 1;
    if (d < 4) {
        *code = (int)d;
        *nbits = 0;
        *extra = 0;
        return;
    }
    const int hb = 31 - __builtin_clz(d);
    const int second = (int)((d >> (hb - 1)) & 1);
    *code = 2 * hb + second;
    *nbits = hb - 1;
    *extra = d & ((1u << (hb - 1)) - 1);
}

constexpr int kMaxLength = 4096;
constexpr int kMaxIter = 48;  // hash-chain entries an LZ77 search visits
constexpr int kNumLength = 24, kNumDistance = 40, kNumLiteral = 256;

enum : uint8_t { kLiteral = 0, kCache = 1, kCopy = 2 };

struct Ref {
    uint8_t kind;
    uint32_t a;  // literal: the pixel; cache: the index; copy: the length
    uint32_t b;  // copy: the distance code
};

inline uint32_t hash_triple(const uint32_t* p, int bits) {
    const uint64_t k = (((uint64_t)p[1] << 32) | p[0]) * 0x9E3779B97F4A7C15ull;
    return (uint32_t)(((k ^ (k >> 29)) + (uint64_t)p[2] * 0xC2B2AE3D27D4EB4Full) >> (64 - bits));
}

inline int match_length(const uint32_t* a, const uint32_t* b, int max_len) {
    int n = 0;
    while (n < max_len && a[n] == b[n]) ++n;
    return n;
}

// LZ77 over a hash chain of pixel triples: at each position the longest match
// among the left and upper neighbours and `kMaxIter` chain entries within
// `window` pixels (ties to the shorter distance code), taken where it is at
// least 3 long (2 for the left and upper neighbours) and not beaten by more
// than one at the next position.
void backward_refs(const uint32_t* px, int w, int h, std::vector<Ref>& refs) {
    const int n = w * h;
    refs.clear();
    if (n == 0) return;
    const int hash_bits = n < (1 << 10) ? 10 : n < (1 << 16) ? 16 : 18;
    std::vector<int32_t> head((size_t)1 << hash_bits, -1), chain(n, -1);
    const int64_t window = std::min<int64_t>((int64_t)w * 256, (1 << 20) - 120);
    int inserted = 0;
    auto insert_to = [&](int upto) {  // chain positions < upto (those with a triple)
        for (; inserted < upto && inserted + 2 < n; ++inserted) {
            const uint32_t hh = hash_triple(px + inserted, hash_bits);
            chain[inserted] = head[hh];
            head[hh] = inserted;
        }
    };
    auto find = [&](int i, int* best_dist) -> int {
        const int max_len = std::min(kMaxLength, n - i);
        int best_len = 0;
        uint32_t best_code = 0;
        *best_dist = 0;
        if (max_len < 2) return 0;
        auto consider = [&](int dist) {
            if (dist <= 0 || dist > i) return;
            const int len = match_length(px + i - dist, px + i, max_len);
            if (len < 2) return;
            const uint32_t code = distance_code(w, (uint32_t)dist);
            if (len > best_len || (len == best_len && code < best_code)) {
                best_len = len;
                best_code = code;
                *best_dist = dist;
            }
        };
        consider(1);
        if (w > 1) consider(w);
        if (best_len >= max_len || max_len < 3) return best_len;
        insert_to(i);
        const uint32_t hh = hash_triple(px + i, hash_bits);
        int iter = 0;
        for (int j = head[hh]; j >= 0 && iter < kMaxIter; j = chain[j], ++iter) {
            const int dist = i - j;
            if (dist > window) break;
            if (dist == 1 || dist == w) continue;  // considered above
            // one that differs at best_len is not longer
            if (best_len >= 2 && px[j + best_len] != px[i + best_len]) continue;
            const int len = match_length(px + j, px + i, max_len);
            if (len < 3) continue;
            const uint32_t code = distance_code(w, (uint32_t)dist);
            if (len > best_len || (len == best_len && code < best_code)) {
                best_len = len;
                best_code = code;
                *best_dist = dist;
                if (len >= max_len) break;
            }
        }
        return best_len;
    };
    int i = 0, pending_len = -1, pending_dist = 0;
    while (i < n) {
        int dist, len;
        if (pending_len >= 0) {
            len = pending_len;
            dist = pending_dist;
            pending_len = -1;
        } else {
            len = find(i, &dist);
        }
        if (len >= 2 && len < kMaxLength && i + 1 < n) {
            int dist2;
            const int len2 = find(i + 1, &dist2);
            if (len2 > len + 1) {
                refs.push_back({kLiteral, px[i], 0});
                ++i;
                pending_len = len2;
                pending_dist = dist2;
                continue;
            }
        }
        if (len >= 2) {
            refs.push_back({kCopy, (uint32_t)len, distance_code(w, (uint32_t)dist)});
            i += len;
        } else {
            refs.push_back({kLiteral, px[i], 0});
            ++i;
        }
    }
}

// -- the entropy-coded image -------------------------------------------------

inline uint32_t cache_key(uint32_t argb, int bits) { return (0x1e35a7bdu * argb) >> (32 - bits); }

// The symbol counts of references under a colour cache of `cache_bits`.
struct Histo {
    std::vector<uint32_t> g;  // 256 literals, 24 lengths, the cache
    uint32_t r[256] = {0}, b[256] = {0}, a[256] = {0}, d[kNumDistance] = {0};
    int64_t extra = 0;  // length and distance extra bits
    explicit Histo(int cache_bits)
        : g(kNumLiteral + kNumLength + (cache_bits ? 1 << cache_bits : 0), 0) {}
    void add(const Ref& ref) {
        if (ref.kind == kLiteral) {
            ++g[(ref.a >> 8) & 0xff];
            ++r[(ref.a >> 16) & 0xff];
            ++b[ref.a & 0xff];
            ++a[ref.a >> 24];
        } else if (ref.kind == kCache) {
            ++g[kNumLiteral + kNumLength + ref.a];
        } else {
            int c, nb;
            uint32_t e;
            prefix_split(ref.a, &c, &nb, &e);
            ++g[kNumLiteral + c];
            extra += nb;
            prefix_split(ref.b, &c, &nb, &e);
            ++d[c];
            extra += nb;
        }
    }
    // Shannon estimate, 1/65536 bit
    int64_t estimate() const {
        return entropy(g.data(), (int)g.size()) + entropy(r, 256) + entropy(b, 256) +
               entropy(a, 256) + entropy(d, kNumDistance) + (extra << 16);
    }
};

// the references with the literals found in a colour cache of `bits`
// replaced by their index (the decoder's cache: every pixel in order,
// starting empty)
void apply_cache(const std::vector<Ref>& in, const uint32_t* px, int bits, std::vector<Ref>& out) {
    out = in;
    if (!bits) return;
    std::vector<uint32_t> cache((size_t)1 << bits, 0);
    std::vector<uint8_t> valid((size_t)1 << bits, 0);
    size_t pos = 0;
    for (Ref& ref : out) {
        if (ref.kind == kLiteral) {
            const uint32_t k = cache_key(ref.a, bits);
            if (valid[k] && cache[k] == ref.a) {
                ref.kind = kCache;
                ref.a = k;
            } else {
                cache[k] = ref.a;
                valid[k] = 1;
            }
            ++pos;
        } else {
            for (uint32_t i = 0; i < ref.a; ++i, ++pos) {
                const uint32_t p = px[pos], k = cache_key(p, bits);
                cache[k] = p;
                valid[k] = 1;
            }
        }
    }
}

struct Codes {
    Code c[5];
    int64_t bits(const Histo& h) const {
        return c[0].header_bits + c[1].header_bits + c[2].header_bits + c[3].header_bits +
               c[4].header_bits + c[0].symbol_bits(h.g.data(), (int)h.g.size()) +
               c[1].symbol_bits(h.r, 256) + c[2].symbol_bits(h.b, 256) +
               c[3].symbol_bits(h.a, 256) + c[4].symbol_bits(h.d, kNumDistance) + h.extra;
    }
    void build(const Histo& h) {
        c[0].build(h.g.data(), (int)h.g.size());
        c[1].build(h.r, 256);
        c[2].build(h.b, 256);
        c[3].build(h.a, 256);
        c[4].build(h.d, kNumDistance);
    }
};

// the cache size (0: none, else 1-`max_bits` bits) that gives the fewest
// bits: every size's cache run over the references in one pass
int best_cache_bits(const std::vector<Ref>& refs, const uint32_t* px, int max_bits) {
    std::vector<Histo> hists;
    std::vector<std::vector<uint32_t>> caches(max_bits + 1);
    std::vector<std::vector<uint8_t>> valid(max_bits + 1);
    for (int bits = 0; bits <= max_bits; ++bits) {
        hists.emplace_back(bits);
        caches[bits].assign((size_t)1 << bits, 0);
        valid[bits].assign((size_t)1 << bits, 0);
    }
    size_t pos = 0;
    for (const Ref& ref : refs) {
        if (ref.kind != kLiteral) {
            for (Histo& h : hists) h.add(ref);
            for (uint32_t i = 0; i < ref.a; ++i, ++pos) {
                const uint32_t p = px[pos], key = 0x1e35a7bdu * p;
                for (int bits = 1; bits <= max_bits; ++bits) {
                    caches[bits][key >> (32 - bits)] = p;
                    valid[bits][key >> (32 - bits)] = 1;
                }
            }
            continue;
        }
        const uint32_t p = ref.a, key = 0x1e35a7bdu * p;
        hists[0].add(ref);
        for (int bits = 1; bits <= max_bits; ++bits) {
            const uint32_t k = key >> (32 - bits);
            if (valid[bits][k] && caches[bits][k] == p) {
                hists[bits].add({kCache, k, 0});
            } else {
                hists[bits].add(ref);
                caches[bits][k] = p;
                valid[bits][k] = 1;
            }
        }
        ++pos;
    }
    Codes codes;
    codes.build(hists[0]);
    int64_t best = codes.bits(hists[0]);
    int best_bits = 0;
    for (int bits = 1; bits <= max_bits; ++bits) {
        if (hists[bits].estimate() >= best << 16) continue;  // a cheap bound first
        codes.build(hists[bits]);
        const int64_t b = codes.bits(hists[bits]);
        if (b < best) {
            best = b;
            best_bits = bits;
        }
    }
    return best_bits;
}

void put_refs(BitWriter& bw, const std::vector<Ref>& refs, const Codes& codes) {
    for (const Ref& ref : refs) {
        if (ref.kind == kLiteral) {
            codes.c[0].put_symbol(bw, (ref.a >> 8) & 0xff);
            codes.c[1].put_symbol(bw, (ref.a >> 16) & 0xff);
            codes.c[2].put_symbol(bw, ref.a & 0xff);
            codes.c[3].put_symbol(bw, ref.a >> 24);
        } else if (ref.kind == kCache) {
            codes.c[0].put_symbol(bw, kNumLiteral + kNumLength + (int)ref.a);
        } else {
            int c, nb;
            uint32_t e;
            prefix_split(ref.a, &c, &nb, &e);
            codes.c[0].put_symbol(bw, kNumLiteral + c);
            if (nb) bw.put(e, nb);
            prefix_split(ref.b, &c, &nb, &e);
            codes.c[4].put_symbol(bw, c);
            if (nb) bw.put(e, nb);
        }
    }
}

// An entropy-coded image (the main image after its transforms, or a
// sub-image): cache, [meta-code flag], the five codes, the pixels.
void put_image(BitWriter& bw, const uint32_t* px, int w, int h, bool level0) {
    std::vector<Ref> refs, cached;
    backward_refs(px, w, h, refs);
    const int cache_bits = best_cache_bits(refs, px, (int64_t)w * h > 64 ? 10 : 0);
    apply_cache(refs, px, cache_bits, cached);
    Histo hist(cache_bits);
    for (const Ref& ref : cached) hist.add(ref);
    Codes codes;
    codes.build(hist);
    if (cache_bits) {
        bw.put(1, 1);
        bw.put(cache_bits, 4);
    } else {
        bw.put(0, 1);
    }
    if (level0) bw.put(0, 1);  // one prefix-code group
    for (const Code& c : codes.c) c.put(bw);
    put_refs(bw, cached, codes);
}

// -- transforms ---------------------------------------------------------------

inline uint32_t sub_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = 0x00ff00ffu + (a & 0xff00ff00u) - (b & 0xff00ff00u);
    const uint32_t rb = 0xff00ff00u + (a & 0x00ff00ffu) - (b & 0x00ff00ffu);
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

// the decoder's prediction (webp.cpp: predict) of mode 0-13
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

// the prediction of pixel (x, y) of `px` (w wide) under `mode`, with the
// fixed rules of the first row (black, then left) and column (top)
inline uint32_t prediction(const uint32_t* px, int w, int x, int y, int mode) {
    const uint32_t* p = px + (size_t)y * w + x;
    if (y == 0) return x == 0 ? 0xff000000u : p[-1];
    if (x == 0) return p[-w];
    return predict(mode, p - w, p[-1]);
}

inline int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

// the growth in Shannon bits of `acc` when `tile` is added to it (1/65536
// bit), over the bins `touched` lists
int64_t added_bits(const uint32_t* acc, uint64_t acc_total, const uint32_t* tile, uint64_t tile_total,
                   const uint16_t* touched, int ntouched) {
    int64_t cost = nlogn(acc_total + tile_total) - nlogn(acc_total);
    for (int i = 0; i < ntouched; ++i) {
        const int s = touched[i];
        cost -= nlogn((uint64_t)acc[s] + tile[s]) - nlogn(acc[s]);
    }
    return cost;
}

// Per-channel residual histograms of one tile (the first `nch` channels:
// 3 for an opaque image, whose alpha residuals are all 0), with the bins
// each touches.
struct TileHist {
    uint32_t h[4][256];
    uint16_t touched[4][256];
    int nt[4];
    int nch = 4;
    uint64_t total = 0;
    TileHist() {
        std::memset(h, 0, sizeof(h));
        std::memset(nt, 0, sizeof(nt));
    }
    inline void add(uint32_t v) {
        for (int c = 0; c < nch; ++c) {
            const int s = (v >> (8 * c)) & 0xff;
            if (h[c][s]++ == 0) touched[c][nt[c]++] = (uint16_t)s;
        }
        ++total;
    }
    void clear() {
        for (int c = 0; c < 4; ++c) {
            for (int i = 0; i < nt[c]; ++i) h[c][touched[c][i]] = 0;
            nt[c] = 0;
        }
        total = 0;
    }
};

struct Accumulated {
    uint32_t h[4][256];
    uint64_t total = 0;
    Accumulated() { std::memset(h, 0, sizeof(h)); }
    int64_t cost(const TileHist& t) const {
        int64_t c = 0;
        for (int ch = 0; ch < t.nch; ++ch)
            c += added_bits(h[ch], total, t.h[ch], t.total, t.touched[ch], t.nt[ch]);
        return c;
    }
    void add(const TileHist& t) {
        for (int ch = 0; ch < t.nch; ++ch)
            for (int i = 0; i < t.nt[ch]; ++i) h[ch][t.touched[ch][i]] += t.h[ch][t.touched[ch][i]];
        total += t.total;
    }
    int64_t bits(int nch) const {
        int64_t b = 0;
        for (int ch = 0; ch < nch; ++ch) b += entropy(h[ch], 256);
        return b;
    }
};

// the residuals of the tile [x0, x1) x [y0, y1) under MODE into `t` (and
// `out`, w wide, where given)
template <int MODE>
void tile_residuals(const uint32_t* px, int w, int x0, int x1, int y0, int y1, TileHist& t,
                    uint32_t* out) {
    for (int y = y0; y < y1; ++y) {
        const uint32_t* row = px + (size_t)y * w;
        for (int x = x0; x < x1; ++x) {
            uint32_t pred;
            if (y == 0) pred = x == 0 ? 0xff000000u : row[x - 1];
            else if (x == 0) pred = row[x - w];
            else pred = predict(MODE, row + x - w, row[x - 1]);
            const uint32_t r = sub_pixels(row[x], pred);
            t.add(r);
            if (out) out[(size_t)y * w + x] = r;
        }
    }
}

using TileFn = void (*)(const uint32_t*, int, int, int, int, int, TileHist&, uint32_t*);
const TileFn kTileFns[14] = {tile_residuals<0>, tile_residuals<1>, tile_residuals<2>,
                             tile_residuals<3>, tile_residuals<4>, tile_residuals<5>,
                             tile_residuals<6>, tile_residuals<7>, tile_residuals<8>,
                             tile_residuals<9>, tile_residuals<10>, tile_residuals<11>,
                             tile_residuals<12>, tile_residuals<13>};

// bits a tile's mode is credited for being its left or upper neighbour's
constexpr int64_t kSameModeBonus = (int64_t)15 << 16;

// The predictor mode of each tile of 2^bits (raster order): the mode whose
// residuals add the fewest bits to those of the tiles before it.  Gives the
// mode image, the residuals and the estimated bits of both.
int64_t predictor_transform(const uint32_t* px, int w, int h, int bits, int nch,
                            std::vector<uint32_t>& modes, std::vector<uint32_t>& residuals) {
    const int tw = sub_sample(w, bits), th = sub_sample(h, bits);
    modes.assign((size_t)tw * th, 0);
    residuals.assign((size_t)w * h, 0);
    Accumulated acc;
    TileHist tile;
    tile.nch = nch;
    uint32_t mode_hist[14] = {0};
    int left_mode = 0;
    for (int ty = 0; ty < th; ++ty)
        for (int tx = 0; tx < tw; ++tx) {
            const int x0 = tx << bits, y0 = ty << bits;
            const int x1 = std::min(w, x0 + (1 << bits)), y1 = std::min(h, y0 + (1 << bits));
            int best_mode = 0;
            int64_t best = 0;
            for (int mode = 0; mode < 14; ++mode) {
                tile.clear();
                kTileFns[mode](px, w, x0, x1, y0, y1, tile, nullptr);
                int64_t c = acc.cost(tile);
                if (tx > 0 && mode == left_mode) c -= kSameModeBonus;
                if (ty > 0 && mode == (int)((modes[(size_t)(ty - 1) * tw + tx] >> 8) & 0xf))
                    c -= kSameModeBonus;
                if (mode == 0 || c < best) {
                    best = c;
                    best_mode = mode;
                }
            }
            tile.clear();
            kTileFns[best_mode](px, w, x0, x1, y0, y1, tile, residuals.data());
            acc.add(tile);
            ++mode_hist[best_mode];
            left_mode = best_mode;
            modes[(size_t)ty * tw + tx] = 0xff000000u | ((uint32_t)best_mode << 8);
        }
    return acc.bits(nch) + entropy(mode_hist, 14) + ((int64_t)14 * 4 << 16);
}

inline int color_delta(int8_t t, int8_t c) { return ((int)t * (int)c) >> 5; }

// The cross-colour transform of each tile of 2^bits on the residuals (in
// place): the multipliers (green to red, then green and red to blue) found
// by a search that halves its step, each adding the fewest bits to the red
// or blue residuals of the tiles before.  A tile's search runs over its
// distinct (green, red, blue) values.  Returns whether any multiplier is
// not 0.
bool cross_color_transform(std::vector<uint32_t>& px, int w, int h, int bits,
                           std::vector<uint32_t>& codes) {
    const int tw = sub_sample(w, bits), th = sub_sample(h, bits);
    codes.assign((size_t)tw * th, 0);
    uint32_t acc_r[256] = {0}, acc_b[256] = {0};
    uint64_t acc_total = 0;
    uint32_t hist[256] = {0};
    uint16_t touched[256];
    std::vector<uint32_t> tile_px;
    std::vector<std::pair<uint32_t, uint32_t>> distinct;  // (0x00RRGGBB, count)
    bool any = false;
    for (int ty = 0; ty < th; ++ty)
        for (int tx = 0; tx < tw; ++tx) {
            const int x0 = tx << bits, y0 = ty << bits;
            const int x1 = std::min(w, x0 + (1 << bits)), y1 = std::min(h, y0 + (1 << bits));
            tile_px.clear();
            for (int y = y0; y < y1; ++y)
                for (int x = x0; x < x1; ++x) tile_px.push_back(px[(size_t)y * w + x] & 0xffffffu);
            std::sort(tile_px.begin(), tile_px.end());
            distinct.clear();
            for (uint32_t p : tile_px) {
                if (distinct.empty() || distinct.back().first != p) distinct.push_back({p, 0});
                ++distinct.back().second;
            }
            const uint64_t n = tile_px.size();
            auto cost = [&](const uint32_t* acc, auto value) {
                int nt = 0;
                for (const auto& d : distinct) {
                    const int s = value(d.first);
                    if (hist[s] == 0) touched[nt++] = (uint16_t)s;
                    hist[s] += d.second;
                }
                const int64_t c = added_bits(acc, acc_total, hist, n, touched, nt);
                for (int i = 0; i < nt; ++i) hist[touched[i]] = 0;
                return c;
            };
            auto red_cost = [&](int g2r) {
                return cost(acc_r, [&](uint32_t p) {
                    return ((int)((p >> 16) & 0xff) - color_delta((int8_t)g2r, (int8_t)(p >> 8))) & 0xff;
                });
            };
            auto blue_cost = [&](int g2b, int r2b) {
                return cost(acc_b, [&](uint32_t p) {
                    return ((int)(p & 0xff) - color_delta((int8_t)g2b, (int8_t)(p >> 8)) -
                            color_delta((int8_t)r2b, (int8_t)(p >> 16))) & 0xff;
                });
            };
            int g2r = 0, g2b = 0, r2b = 0;
            if (distinct.size() > 1) {
                int64_t best = red_cost(0);
                for (int step = 32; step >= 1; step >>= 1) {
                    const int center = g2r;
                    for (int cand : {center - step, center + step}) {
                        if (cand < -128 || cand > 127) continue;
                        const int64_t c = red_cost(cand);
                        if (c < best) {
                            best = c;
                            g2r = cand;
                        }
                    }
                }
                best = blue_cost(0, 0);
                for (int step = 32; step >= 1; step >>= 1) {
                    const int cg = g2b, cr = r2b;
                    const int cand[4][2] = {{cg - step, cr}, {cg + step, cr}, {cg, cr - step},
                                            {cg, cr + step}};
                    for (auto& c2 : cand) {
                        if (c2[0] < -128 || c2[0] > 127 || c2[1] < -128 || c2[1] > 127) continue;
                        const int64_t c = blue_cost(c2[0], c2[1]);
                        if (c < best) {
                            best = c;
                            g2b = c2[0];
                            r2b = c2[1];
                        }
                    }
                }
            }
            any = any || g2r || g2b || r2b;
            for (int y = y0; y < y1; ++y)
                for (int x = x0; x < x1; ++x) {
                    uint32_t& p = px[(size_t)y * w + x];
                    const int8_t g = (int8_t)(p >> 8), r = (int8_t)(p >> 16);
                    const int nr = ((int)((p >> 16) & 0xff) - color_delta((int8_t)g2r, g)) & 0xff;
                    const int nb = ((int)(p & 0xff) - color_delta((int8_t)g2b, g) -
                                    color_delta((int8_t)r2b, r)) & 0xff;
                    p = (p & 0xff00ff00u) | ((uint32_t)nr << 16) | (uint32_t)nb;
                    ++acc_r[nr];
                    ++acc_b[nb];
                }
            acc_total += n;
            codes[(size_t)ty * tw + tx] = 0xff000000u | ((uint32_t)(uint8_t)r2b << 16) |
                                          ((uint32_t)(uint8_t)g2b << 8) | (uint32_t)(uint8_t)g2r;
        }
    return any;
}

// images of up to this many pixels also try subtract-green alone (no predictor)
constexpr int64_t kPlainMaxPixels = 1 << 16;
// the tile sizes (bits) the predictor transform chooses among
constexpr int kMinTransformBits = 4, kMaxTransformBits = 5;

inline void put_transform(BitWriter& bw, int type, int bits) {
    bw.put(1, 1);
    bw.put(type, 2);
    if (bits) bw.put(bits - 2, 3);
}

// The image as subtract-green and predictor transforms (the tile size whose
// estimate is the least), then the entropy-coded residuals, with the
// cross-colour transform before them where that comes out shorter.
// `use_predictor` false: subtract-green alone.
void put_spatial(BitWriter& bw, const std::vector<uint32_t>& argb, int w, int h, bool opaque,
                 bool use_predictor) {
    std::vector<uint32_t> px(argb), modes, residuals;
    for (uint32_t& p : px) {
        const uint32_t g = (p >> 8) & 0xff;
        p = (p & 0xff00ff00u) | ((((p >> 16) & 0xff) - g) & 0xff) << 16 | (((p & 0xff) - g) & 0xff);
    }
    put_transform(bw, 2, 0);
    if (!use_predictor) {
        bw.put(0, 1);
        put_image(bw, px.data(), w, h, true);
        return;
    }
    int bits = kMinTransformBits;
    int64_t best = -1;
    for (int b = kMinTransformBits; b <= kMaxTransformBits; ++b) {
        if (b > kMinTransformBits && (1 << (b - 1)) >= std::max(w, h)) break;  // one tile already
        std::vector<uint32_t> m, r;
        const int64_t est = predictor_transform(px.data(), w, h, b, opaque ? 3 : 4, m, r);
        if (best < 0 || est < best) {
            best = est;
            bits = b;
            modes.swap(m);
            residuals.swap(r);
        }
    }
    const int tw = sub_sample(w, bits), th = sub_sample(h, bits);
    put_transform(bw, 0, bits);
    put_image(bw, modes.data(), tw, th, false);
    BitWriter plain;
    plain.put(0, 1);
    put_image(plain, residuals.data(), w, h, true);
    std::vector<uint32_t> ccodes;
    if (cross_color_transform(residuals, w, h, bits, ccodes)) {
        BitWriter cross;
        put_transform(cross, 1, bits);
        put_image(cross, ccodes.data(), tw, th, false);
        cross.put(0, 1);
        put_image(cross, residuals.data(), w, h, true);
        if (cross.bits() < plain.bits()) {
            bw.append(cross);
            return;
        }
    }
    bw.append(plain);
}

// the image as colour indexing over its sorted palette (at most 256
// colours), pixels bundled where the palette allows
void put_palette(BitWriter& bw, const std::vector<uint32_t>& argb, int w, int h,
                 const std::vector<uint32_t>& palette) {
    const int n = (int)palette.size();
    const int xbits = n <= 2 ? 3 : n <= 4 ? 2 : n <= 16 ? 1 : 0;
    std::vector<uint32_t> deltas(n);
    deltas[0] = palette[0];
    for (int i = 1; i < n; ++i) deltas[i] = sub_pixels(palette[i], palette[i - 1]);
    bw.put(1, 1);
    bw.put(3, 2);
    bw.put(n - 1, 8);
    put_image(bw, deltas.data(), n, 1, false);
    const int pw = sub_sample(w, xbits), bpp = 8 >> xbits;
    std::vector<uint32_t> packed((size_t)pw * h, 0);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            const uint32_t p = argb[(size_t)y * w + x];
            const uint32_t idx = (uint32_t)(std::lower_bound(palette.begin(), palette.end(), p) -
                                            palette.begin());
            packed[(size_t)y * pw + (x >> xbits)] |= idx << (bpp * (x & ((1 << xbits) - 1)));
        }
    for (uint32_t& p : packed) p = 0xff000000u | (p << 8);
    bw.put(0, 1);
    put_image(bw, packed.data(), pw, h, true);
}

// the sorted colours of `argb`, or none where it has more than 256
std::vector<uint32_t> palette_of(const std::vector<uint32_t>& argb) {
    std::vector<uint32_t> colors;
    constexpr int kSlots = 1024;
    uint32_t table[kSlots];
    uint8_t used[kSlots] = {0};
    for (uint32_t p : argb) {
        uint32_t k = (p * 0x1e35a7bdu) >> 22;
        while (used[k] && table[k] != p) k = (k + 1) & (kSlots - 1);
        if (used[k]) continue;
        if (colors.size() == 256) return {};
        used[k] = 1;
        table[k] = p;
        colors.push_back(p);
    }
    std::sort(colors.begin(), colors.end());
    return colors;
}

}  // namespace

extern "C" {

// The VP8L stream (header included) of w x h ARGB pixels (0xAARRGGBB):
// *out (malloc'd; free with webp_enc_free) and its size.  `use_alpha`: the
// header's alpha hint.  RGB under alpha 0 is written as 0 (libwebp's
// default, inexact mode).  Returns 0, or 1 where the sides are out of the
// format's range or memory runs out.
int webp_vp8l_encode(const uint32_t* argb, int w, int h, int use_alpha, uint8_t** out,
                     int64_t* out_size) {
    *out = nullptr;
    *out_size = 0;
    if (w < 1 || h < 1 || w > 16384 || h > 16384) return 1;
    try {
        std::vector<uint32_t> px(argb, argb + (size_t)w * h);
        for (uint32_t& p : px)
            if ((p >> 24) == 0) p = 0;
        BitWriter head;
        head.put(0x2f, 8);
        head.put((uint32_t)(w - 1), 14);
        head.put((uint32_t)(h - 1), 14);
        head.put(use_alpha ? 1 : 0, 1);
        head.put(0, 3);
        BitWriter best;
        bool have = false;
        const std::vector<uint32_t> palette = palette_of(px);
        if (!palette.empty()) {
            put_palette(best, px, w, h, palette);
            have = true;
        }
        const bool opaque = std::all_of(px.begin(), px.end(), [](uint32_t p) { return p >> 24 == 0xff; });
        if (palette.empty() || palette.size() > 16) {
            BitWriter spatial;
            put_spatial(spatial, px, w, h, opaque, true);
            if (!have || spatial.bits() < best.bits()) best = std::move(spatial);
        }
        if (palette.empty() && (int64_t)w * h <= kPlainMaxPixels) {
            BitWriter plain;
            put_spatial(plain, px, w, h, opaque, false);
            if (plain.bits() < best.bits()) best = std::move(plain);
        }
        head.append(best);
        head.flush();
        uint8_t* buf = (uint8_t*)std::malloc(head.buf.size());
        if (!buf) return 1;
        std::memcpy(buf, head.buf.data(), head.buf.size());
        *out = buf;
        *out_size = (int64_t)head.buf.size();
        return 0;
    } catch (...) {
        return 1;
    }
}

void webp_enc_free(uint8_t* p) { std::free(p); }

}  // extern "C"
