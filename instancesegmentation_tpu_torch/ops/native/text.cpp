// Glyph rasteriser and text blend of cv2 5.0's putText (core/text.py).
//
// cv2 5.0 draws text with its own copy of stb_truetype (public domain), in
// Rubik and in its fallback font alike: each glyph's quadratic contours are
// flattened with a tolerance of 0.35 pixels and filled by stb's exact-area
// scanline rasteriser (version 2) into an 8-bit coverage bitmap, in single
// precision.  cv2 pads the glyph's box (from the glyph header) by a margin
// on every side and passes the margin as the shift of the outline; the
// float rounding of the coverage depends on that frame, so it is kept here
// as cv2 has it.  The bitmap is then blended glyph by glyph into the image:
// round(bg + (c - bg) * a / 255) on each colour channel, and a 4th channel
// takes the coverage itself.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum { V_MOVE = 1, V_LINE = 2, V_CURVE = 3 };

struct Point {
    float x, y;
};

void tesselate_curve(std::vector<Point>& pts, float x0, float y0, float x1, float y1, float x2,
                     float y2, float flatness_squared, int n) {
    float mx = (x0 + 2 * x1 + x2) / 4;
    float my = (y0 + 2 * y1 + y2) / 4;
    float dx = (x0 + x2) / 2 - mx;
    float dy = (y0 + y2) / 2 - my;
    if (n > 16) return;
    if (dx * dx + dy * dy > flatness_squared) {
        tesselate_curve(pts, x0, y0, (x0 + x1) / 2.0f, (y0 + y1) / 2.0f, mx, my, flatness_squared,
                        n + 1);
        tesselate_curve(pts, mx, my, (x1 + x2) / 2.0f, (y1 + y2) / 2.0f, x2, y2, flatness_squared,
                        n + 1);
    } else {
        pts.push_back({x2, y2});
    }
}

struct Edge {
    float x0, y0, x1, y1;
    int invert;
};

struct ActiveEdge {
    ActiveEdge* next;
    float fx, fdx, fdy, direction, sy, ey;
};

inline bool edge_less(const Edge* a, const Edge* b) { return a->y0 < b->y0; }

// stb's sort: a quicksort to runs of 12, then an insertion sort.  Edges of
// equal y0 keep the order these give, which fixes the order of the active
// list and so the order of the float sums.
void sort_edges_ins_sort(Edge* p, int n) {
    for (int i = 1; i < n; ++i) {
        Edge t = p[i];
        int j = i;
        while (j > 0) {
            if (!edge_less(&t, &p[j - 1])) break;
            p[j] = p[j - 1];
            --j;
        }
        if (i != j) p[j] = t;
    }
}

void sort_edges_quicksort(Edge* p, int n) {
    while (n > 12) {
        Edge t;
        int m = n >> 1;
        int c01 = edge_less(&p[0], &p[m]);
        int c12 = edge_less(&p[m], &p[n - 1]);
        if (c01 != c12) {
            int c = edge_less(&p[0], &p[n - 1]);
            int z = (c == c12) ? 0 : n - 1;
            t = p[z];
            p[z] = p[m];
            p[m] = t;
        }
        t = p[0];
        p[0] = p[m];
        p[m] = t;
        int i = 1, j = n - 1;
        for (;;) {
            for (;; ++i)
                if (!edge_less(&p[i], &p[0])) break;
            for (;; --j)
                if (!edge_less(&p[0], &p[j])) break;
            if (i >= j) break;
            t = p[i];
            p[i] = p[j];
            p[j] = t;
            ++i;
            --j;
        }
        if (j < (n - i)) {
            sort_edges_quicksort(p, j);
            p = p + i;
            n = n - i;
        } else {
            sort_edges_quicksort(p + i, n - i);
            n = j;
        }
    }
}

// The edge does not cross the vertical lines at x or x + 1.
void handle_clipped_edge(float* scanline, int x, const ActiveEdge* e, float x0, float y0, float x1,
                         float y1) {
    if (y0 == y1) return;
    if (y0 > e->ey) return;
    if (y1 < e->sy) return;
    if (y0 < e->sy) {
        x0 += (x1 - x0) * (e->sy - y0) / (y1 - y0);
        y0 = e->sy;
    }
    if (y1 > e->ey) {
        x1 += (x1 - x0) * (e->ey - y1) / (y1 - y0);
        y1 = e->ey;
    }
    if (x0 <= x && x1 <= x)
        scanline[x] += e->direction * (y1 - y0);
    else if (x0 >= x + 1 && x1 >= x + 1)
        ;
    else
        scanline[x] += e->direction * (y1 - y0) * (1 - ((x0 - x) + (x1 - x)) / 2);
}

inline float sized_trapezoid_area(float height, float top_width, float bottom_width) {
    return (top_width + bottom_width) / 2.0f * height;
}

inline float position_trapezoid_area(float height, float tx0, float tx1, float bx0, float bx1) {
    return sized_trapezoid_area(height, tx1 - tx0, bx1 - bx0);
}

inline float sized_triangle_area(float height, float width) { return height * width / 2; }

// Adds each active edge's signed area to this scanline's pixels (scanline)
// and to the run right of it (scanline_fill).
void fill_active_edges(float* scanline, float* scanline_fill, int len, ActiveEdge* e, float y_top) {
    float y_bottom = y_top + 1;
    for (; e; e = e->next) {
        if (e->fdx == 0) {
            float x0 = e->fx;
            if (x0 < len) {
                if (x0 >= 0) {
                    handle_clipped_edge(scanline, (int)x0, e, x0, y_top, x0, y_bottom);
                    handle_clipped_edge(scanline_fill - 1, (int)x0 + 1, e, x0, y_top, x0, y_bottom);
                } else {
                    handle_clipped_edge(scanline_fill - 1, 0, e, x0, y_top, x0, y_bottom);
                }
            }
            continue;
        }
        float x0 = e->fx;
        float dx = e->fdx;
        float xb = x0 + dx;
        float x_top, x_bottom, sy0, sy1;
        float dy = e->fdy;
        if (e->sy > y_top) {
            x_top = x0 + dx * (e->sy - y_top);
            sy0 = e->sy;
        } else {
            x_top = x0;
            sy0 = y_top;
        }
        if (e->ey < y_bottom) {
            x_bottom = x0 + dx * (e->ey - y_top);
            sy1 = e->ey;
        } else {
            x_bottom = xb;
            sy1 = y_bottom;
        }
        if (x_top >= 0 && x_bottom >= 0 && x_top < len && x_bottom < len) {
            if ((int)x_top == (int)x_bottom) {
                int x = (int)x_top;
                float height = (sy1 - sy0) * e->direction;
                scanline[x] += position_trapezoid_area(height, x_top, x + 1.0f, x_bottom, x + 1.0f);
                scanline_fill[x] += height;
            } else {
                if (x_top > x_bottom) {
                    float t;
                    sy0 = y_bottom - (sy0 - y_top);
                    sy1 = y_bottom - (sy1 - y_top);
                    t = sy0, sy0 = sy1, sy1 = t;
                    t = x_bottom, x_bottom = x_top, x_top = t;
                    dx = -dx;
                    dy = -dy;
                    t = x0, x0 = xb, xb = t;
                }
                int x1 = (int)x_top;
                int x2 = (int)x_bottom;
                float y_crossing = y_top + dy * (x1 + 1 - x0);
                float y_final = y_top + dy * (x2 - x0);
                if (y_crossing > y_bottom) y_crossing = y_bottom;
                float sign = e->direction;
                float area = sign * (y_crossing - sy0);
                scanline[x1] += sized_triangle_area(area, x1 + 1 - x_top);
                if (y_final > y_bottom) {
                    int denom = x2 - (x1 + 1);
                    y_final = y_bottom;
                    if (denom != 0) dy = (y_final - y_crossing) / denom;
                }
                float step = sign * dy * 1;
                for (int x = x1 + 1; x < x2; ++x) {
                    scanline[x] += area + step / 2;
                    area += step;
                }
                scanline[x2] += area + sign * position_trapezoid_area(sy1 - y_final, (float)x2,
                                                                      x2 + 1.0f, x_bottom, x2 + 1.0f);
                scanline_fill[x2] += sign * (sy1 - sy0);
            }
            continue;
        }
        // The edge leaves the bitmap's columns: stb's slow exact path.
        for (int x = 0; x < len; ++x) {
            float y0 = y_top;
            float x1 = (float)(x);
            float x2 = (float)(x + 1);
            float x3 = xb;
            float y3 = y_bottom;
            float y1 = (x - x0) / dx + y_top;
            float y2 = (x + 1 - x0) / dx + y_top;
            if (x0 < x1 && x3 > x2) {
                handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
                handle_clipped_edge(scanline, x, e, x1, y1, x2, y2);
                handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
            } else if (x3 < x1 && x0 > x2) {
                handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
                handle_clipped_edge(scanline, x, e, x2, y2, x1, y1);
                handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
            } else if (x0 < x1 && x3 > x1) {
                handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
                handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
            } else if (x3 < x1 && x0 > x1) {
                handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
                handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
            } else if (x0 < x2 && x3 > x2) {
                handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
                handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
            } else if (x3 < x2 && x0 > x2) {
                handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
                handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
            } else {
                handle_clipped_edge(scanline, x, e, x0, y0, x3, y3);
            }
        }
    }
}

void rasterize_sorted_edges(uint8_t* pixels, int w, int h, Edge* e, int n, int off_x, int off_y) {
    std::vector<ActiveEdge> pool(n + 1);
    std::vector<ActiveEdge*> free_list;
    size_t used = 0;
    ActiveEdge* active = nullptr;
    std::vector<float> buffer(2 * w + 1);
    float* scanline = buffer.data();
    float* scanline2 = scanline + w;
    int y = off_y;
    e[n].y0 = (float)(off_y + h) + 1;
    for (int j = 0; j < h; ++j, ++y) {
        float scan_y_top = y + 0.0f;
        float scan_y_bottom = y + 1.0f;
        std::memset(scanline, 0, w * sizeof(float));
        std::memset(scanline2, 0, (w + 1) * sizeof(float));
        for (ActiveEdge** step = &active; *step;) {
            ActiveEdge* z = *step;
            if (z->ey <= scan_y_top) {
                *step = z->next;
                z->direction = 0;
                free_list.push_back(z);
            } else {
                step = &z->next;
            }
        }
        for (; e->y0 <= scan_y_bottom; ++e) {
            if (e->y0 == e->y1) continue;
            ActiveEdge* z;
            if (!free_list.empty()) {
                z = free_list.back();
                free_list.pop_back();
            } else {
                z = &pool[used++];
            }
            float dxdy = (e->x1 - e->x0) / (e->y1 - e->y0);
            z->fdx = dxdy;
            z->fdy = dxdy != 0.0f ? (1.0f / dxdy) : 0.0f;
            z->fx = e->x0 + dxdy * (scan_y_top - e->y0);
            z->fx -= off_x;
            z->direction = e->invert ? 1.0f : -1.0f;
            z->sy = e->y0;
            z->ey = e->y1;
            if (j == 0 && off_y != 0 && z->ey < scan_y_top) z->ey = scan_y_top;
            z->next = active;
            active = z;
        }
        if (active) fill_active_edges(scanline, scanline2 + 1, w, active, scan_y_top);
        float sum = 0;
        for (int i = 0; i < w; ++i) {
            sum += scanline2[i];
            float k = scanline[i] + sum;
            k = (float)std::fabs(k) * 255 + 0.5f;
            int m = (int)k;
            if (m > 255) m = 255;
            pixels[j * w + i] = (uint8_t)m;
        }
        for (ActiveEdge* z = active; z; z = z->next) z->fx += z->fdx;
    }
}

}  // namespace

extern "C" {

// One glyph's coverage [height, width] (uint8) into `out`, zeroed first.
// The n vertices are stb's: types (1 move, 2 line, 3 quadratic curve) and
// xy [n, 4] = end x, end y, control x, control y in font units.  The
// outline is scaled by `scale`, flipped in y, shifted by `margin` pixels
// and drawn with its origin at pixel (off_x, off_y) of cv2's frame.
int text_glyph(const uint8_t* types, const float* xy, int n, float scale, int off_x, int off_y,
               int margin, int width, int height, uint8_t* out) {
    std::memset(out, 0, (size_t)width * height);
    if (n <= 0 || width <= 0 || height <= 0) return 0;
    float shift_x = (float)margin + 0.0f;
    float shift_y = 0.0f + (float)margin;
    float flatness = 0.35f / scale;
    float flatness_squared = flatness * flatness;
    std::vector<Point> pts;
    std::vector<int> lengths;
    int start = 0;
    float x = 0, y = 0;
    for (int i = 0; i < n; ++i) {
        const float* v = xy + 4 * i;
        if (types[i] == V_MOVE) {
            if (i > 0) lengths.push_back((int)pts.size() - start);
            start = (int)pts.size();
            x = v[0], y = v[1];
            pts.push_back({x, y});
        } else if (types[i] == V_LINE) {
            x = v[0], y = v[1];
            pts.push_back({x, y});
        } else if (types[i] == V_CURVE) {
            tesselate_curve(pts, x, y, v[2], v[3], v[0], v[1], flatness_squared, 0);
            x = v[0], y = v[1];
        }
    }
    lengths.push_back((int)pts.size() - start);
    std::vector<Edge> edges(pts.size() + 1);
    int ne = 0, m = 0;
    for (int len : lengths) {
        const Point* p = pts.data() + m;
        m += len;
        for (int k = 0, j = len - 1; k < len; j = k++) {
            if (p[j].y == p[k].y) continue;
            int a = k, b = j;
            Edge& e = edges[ne++];
            e.invert = 0;
            if (p[j].y > p[k].y) {
                e.invert = 1;
                a = j, b = k;
            }
            e.x0 = p[a].x * scale + shift_x;
            e.y0 = (p[a].y * -scale + shift_y) * 1;
            e.x1 = p[b].x * scale + shift_x;
            e.y1 = (p[b].y * -scale + shift_y) * 1;
        }
    }
    sort_edges_quicksort(edges.data(), ne);
    sort_edges_ins_sort(edges.data(), ne);
    rasterize_sorted_edges(out, width, height, edges.data(), ne, off_x, off_y);
    return 0;
}

// Blend a coverage bitmap cov [bh, bw] with its top-left corner at (x0, y0)
// into the uint8 image img [h, w, ch] (ch 1, 3 or 4, rows `stride` bytes
// apart), clipped at the image's edges.  Pixels of coverage 0 are left.
void text_blend(uint8_t* img, int h, int w, int ch, int64_t stride, const uint8_t* cov, int bh,
                int bw, int x0, int y0, const uint8_t* color) {
    int colour_channels = ch == 4 ? 3 : ch;
    for (int r = 0; r < bh; ++r) {
        int y = y0 + r;
        if (y < 0 || y >= h) continue;
        uint8_t* row = img + (int64_t)y * stride;
        for (int c = 0; c < bw; ++c) {
            int x = x0 + c;
            int a = cov[r * bw + c];
            if (a == 0 || x < 0 || x >= w) continue;
            uint8_t* px = row + (int64_t)x * ch;
            for (int k = 0; k < colour_channels; ++k) {
                int bg = px[k];
                int v = (color[k] - bg) * a;
                px[k] = (uint8_t)(bg + (v >= 0 ? (v + 127) / 255 : -((127 - v) / 255)));
            }
            if (ch == 4) px[3] = (uint8_t)a;
        }
    }
}

}  // extern "C"
