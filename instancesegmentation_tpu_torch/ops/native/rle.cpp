// Native RLE mask codec: the port's copy of the JAX package's host codec.
//
// Runs are column-major (Fortran order) starting with the count of zeros,
// the COCO convention, identical to core/rasterize.py's NumPy codec (the
// semantic oracle; tests assert equality).  rle_iou is a linear merge walk
// over run boundaries; rle_iou_matrix is mask AP's IoU matrix in one call.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 rle.cpp -o librle.so  (build.py
// does this into build/native/ at first use).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Encode a 0/255 (any nonzero = fg) uint8 mask [h, w] (row-major in
// memory) into column-major runs. Returns the number of counts written,
// or -1 if out_capacity is too small.
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w,
                   uint32_t* counts_out, int64_t out_capacity) {
    int64_t n = 0;
    uint8_t current = 0;  // runs start with zeros
    int64_t run = 0;
    for (int64_t x = 0; x < w; ++x) {
        for (int64_t y = 0; y < h; ++y) {
            uint8_t v = mask[y * w + x] ? 1 : 0;
            if (v == current) {
                ++run;
            } else {
                if (n >= out_capacity) return -1;
                counts_out[n++] = static_cast<uint32_t>(run);
                current = v;
                run = 1;
            }
        }
    }
    if (n >= out_capacity) return -1;
    counts_out[n++] = static_cast<uint32_t>(run);
    return n;
}

// Decode runs into a 0/255 uint8 mask [h, w] row-major.
void rle_decode(const uint32_t* counts, int64_t n,
                uint8_t* mask_out, int64_t h, int64_t w) {
    std::memset(mask_out, 0, static_cast<size_t>(h * w));
    int64_t pos = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t run = counts[i];
        if (i & 1) {  // odd runs are foreground
            for (int64_t k = pos; k < pos + run && k < h * w; ++k) {
                int64_t x = k / h;
                int64_t y = k % h;
                mask_out[y * w + x] = 255;
            }
        }
        pos += run;
    }
}

// Foreground pixel count.
uint64_t rle_area(const uint32_t* counts, int64_t n) {
    uint64_t area = 0;
    for (int64_t i = 1; i < n; i += 2) area += counts[i];
    return area;
}

// IoU of two RLEs over the same canvas: linear merge walk over run
// boundaries (the pycocotools rleIou algorithm shape), O(nA + nB).
double rle_iou(const uint32_t* a, int64_t na, const uint32_t* b, int64_t nb) {
    uint64_t inter = 0, uni = 0;
    int64_t ia = 0, ib = 0;
    uint64_t ca = ia < na ? a[ia] : 0;  // remaining in current a-run
    uint64_t cb = ib < nb ? b[ib] : 0;
    bool va = false, vb = false;        // run values (start at 0s)
    while (ia < na && ib < nb) {
        uint64_t step = std::min(ca, cb);
        if (va && vb) inter += step;
        if (va || vb) uni += step;
        ca -= step;
        cb -= step;
        if (ca == 0) { ++ia; va = !va; if (ia < na) ca = a[ia]; }
        if (cb == 0) { ++ib; vb = !vb; if (ib < nb) cb = b[ib]; }
    }
    if (uni == 0) return 1.0;  // both empty == identical
    return static_cast<double>(inter) / static_cast<double>(uni);
}

// Pairwise IoU matrix of P predictions x G ground truths, all RLEs
// packed in one buffer with offsets/lengths.
void rle_iou_matrix(const uint32_t* buf,
                    const int64_t* offsets_a, const int64_t* lens_a, int64_t pa,
                    const int64_t* offsets_b, const int64_t* lens_b, int64_t pb,
                    double* out) {
    for (int64_t i = 0; i < pa; ++i) {
        for (int64_t j = 0; j < pb; ++j) {
            out[i * pb + j] = rle_iou(buf + offsets_a[i], lens_a[i],
                                      buf + offsets_b[j], lens_b[j]);
        }
    }
}

}  // extern "C"
