// Polygon rasterization for COCO segmentation masks, on the host (no cv2).
//
// Takes the place of `cv2.fillPoly(mask, pts, 1)` with int32 points, no
// shift and 8-connected edges in `litepose_tpu/data/coco_io.py:
// polygons_to_mask`, and must set the same pixels.  It follows OpenCV's
// drawing.cpp step for step:
//   - CollectPolyEdges: every edge, closing edge included, is first drawn
//     as an 8-connected line (LineIterator, left to right, after
//     clipLine's clipping to the image); each edge that is not horizontal
//     becomes a 16.16 fixed-point edge through its end points, or, when
//     the image clips its line, with the clipped line's x (and its y where
//     the clipped line is not horizontal);
//   - FillEdgeCollection: the edges of all contours together, sorted by
//     (y0, x, dx), scanned row by row with the active list kept in x
//     order by a bubble pass; spans between pairs of active edges are
//     filled from ceil(x_left) to floor(x_right) inclusive (even-odd).
// OpenCV 5.0 (the version this was held to, pixel for pixel, on random
// convex, concave, self-touching, multi-contour and off-image polygons)
// takes the span ends so; older releases put x half a pixel right and
// rounded both ends down.
// Built into the host library with jpeg_decode.cpp (kernels/build.py).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <vector>

namespace {

constexpr int kShift = 16;  // XY_SHIFT
constexpr int64_t kOne = int64_t{1} << kShift;

struct Img {
  uint8_t* data;
  int h, w;
  void set(int64_t x, int64_t y, uint8_t c) { data[y * w + x] = c; }
};

// cv::clipLine on int64 points; false when the line misses the image.
bool clip_line(int64_t w, int64_t h, int64_t& x1, int64_t& y1, int64_t& x2, int64_t& y2) {
  const int64_t right = w - 1, bottom = h - 1;
  if (w <= 0 || h <= 0) return false;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += static_cast<int64_t>(static_cast<double>(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += static_cast<int64_t>(static_cast<double>(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += static_cast<int64_t>(static_cast<double>(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += static_cast<int64_t>(static_cast<double>(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// cv::Line with an 8-connected LineIterator, left to right.
void line8(Img& img, int64_t x1, int64_t y1, int64_t x2, int64_t y2, uint8_t color) {
  if (static_cast<uint64_t>(x1) >= static_cast<uint64_t>(img.w) ||
      static_cast<uint64_t>(x2) >= static_cast<uint64_t>(img.w) ||
      static_cast<uint64_t>(y1) >= static_cast<uint64_t>(img.h) ||
      static_cast<uint64_t>(y2) >= static_cast<uint64_t>(img.h)) {
    if (!clip_line(img.w, img.h, x1, y1, x2, y2)) return;
  }
  int64_t dx = x2 - x1, dy = y2 - y1;
  if (dx < 0) {  // left to right
    dx = -dx;
    dy = -dy;
    std::swap(x1, x2);
    std::swap(y1, y2);
  }
  int64_t sx = 1, sy = 1;  // the x and y steps
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  const bool vert = dy > dx;
  const int64_t major = vert ? dy : dx, minor = vert ? dx : dy;
  int64_t err = major - 2 * minor;
  const int64_t count = major + 1;
  int64_t x = x1, y = y1;
  for (int64_t i = 0; i < count; ++i) {
    img.set(x, y, color);
    const bool both = err < 0;
    err += -2 * minor + (both ? 2 * major : 0);
    if (vert) {
      y += sy;
      if (both) x += sx;
    } else {
      x += sx;
      if (both) y += sy;
    }
  }
}

struct Edge {
  int y0, y1;
  int64_t x, dx;
  Edge* next;
};

void collect_edges(Img& img, const int32_t* v, int count, std::vector<Edge>& edges,
                   uint8_t color) {
  int64_t p0x = static_cast<int64_t>(v[2 * (count - 1)]) << kShift;
  int64_t p0y = v[2 * (count - 1) + 1];
  for (int i = 0; i < count; ++i) {
    const int64_t p1x = static_cast<int64_t>(v[2 * i]) << kShift;
    const int64_t p1y = v[2 * i + 1];
    int64_t c0x = p0x, c0y = p0y, c1x = p1x, c1y = p1y;
    int64_t t0x = (p0x + (kOne >> 1)) >> kShift, t0y = p0y;
    int64_t t1x = (p1x + (kOne >> 1)) >> kShift, t1y = p1y;
    line8(img, t0x, t0y, t1x, t1y, color);
    if (static_cast<uint64_t>(t0x) >= static_cast<uint64_t>(img.w) ||
        static_cast<uint64_t>(t1x) >= static_cast<uint64_t>(img.w) ||
        static_cast<uint64_t>(t0y) >= static_cast<uint64_t>(img.h) ||
        static_cast<uint64_t>(t1y) >= static_cast<uint64_t>(img.h)) {
      // the edge runs through the clipped line's ends
      clip_line(img.w, img.h, t0x, t0y, t1x, t1y);
      if (t0y != t1y) {
        c0y = t0y;
        c1y = t1y;
      }
      c0x = t0x << kShift;
      c1x = t1x << kShift;
    }
    if (p0y != p1y) {
      Edge e;
      e.dx = (c1x - c0x) / (c1y - c0y);
      if (p0y < p1y) {
        e.y0 = static_cast<int>(p0y);
        e.y1 = static_cast<int>(p1y);
        e.x = c0x + (p0y - c0y) * e.dx;
      } else {
        e.y0 = static_cast<int>(p1y);
        e.y1 = static_cast<int>(p0y);
        e.x = c1x + (p1y - c1y) * e.dx;
      }
      e.next = nullptr;
      edges.push_back(e);
    }
    p0x = p1x;
    p0y = p1y;
  }
}

void fill_edges(Img& img, std::vector<Edge>& edges, uint8_t color) {
  const int total = static_cast<int>(edges.size());
  if (total < 2) return;
  int y_max = INT_MIN, y_min = INT_MAX;
  int64_t x_max = -1, x_min = INT64_MAX;
  for (const Edge& e : edges) {
    const int64_t x1 = e.x + (e.y1 - e.y0) * e.dx;
    y_min = std::min(y_min, e.y0);
    y_max = std::max(y_max, e.y1);
    x_min = std::min({x_min, e.x, x1});
    x_max = std::max({x_max, e.x, x1});
  }
  if (y_max < 0 || y_min >= img.h || x_max < 0 || x_min >= (static_cast<int64_t>(img.w) << kShift))
    return;
  std::sort(edges.begin(), edges.end(), [](const Edge& a, const Edge& b) {
    return a.y0 != b.y0 ? a.y0 < b.y0 : a.x != b.x ? a.x < b.x : a.dx < b.dx;
  });
  Edge tmp;
  tmp.y0 = INT_MAX;
  tmp.next = nullptr;
  edges.push_back(tmp);  // the sentinel; no reallocation from here on
  Edge head;
  head.next = nullptr;
  int i = 0;
  Edge* e = &edges[0];
  y_max = std::min(y_max, img.h);
  for (int y = e->y0; y < y_max; ++y) {
    Edge *last, *prelast, *keep_prelast;
    int draw = 0;
    const bool clipline = y < 0;
    prelast = &head;
    last = head.next;
    while (last || e->y0 == y) {
      if (last && last->y1 == y) {  // the edge ends here
        prelast->next = last->next;
        last = last->next;
        continue;
      }
      keep_prelast = prelast;
      if (last && (e->y0 > y || last->x < e->x)) {
        prelast = last;
        last = last->next;
      } else if (i < total) {  // the next edge starts here
        prelast->next = e;
        e->next = last;
        prelast = e;
        e = &edges[++i];
      } else {
        break;
      }
      if (draw) {
        if (!clipline) {
          int64_t x1, x2;
          if (keep_prelast->x > prelast->x) {
            x1 = (prelast->x + kOne - 1) >> kShift;
            x2 = keep_prelast->x >> kShift;
          } else {
            x1 = (keep_prelast->x + kOne - 1) >> kShift;
            x2 = prelast->x >> kShift;
          }
          if (x1 < img.w && x2 >= 0) {
            x1 = std::max<int64_t>(x1, 0);
            x2 = std::min<int64_t>(x2, img.w - 1);
            for (int64_t x = x1; x <= x2; ++x) img.set(x, y, color);
          }
        }
        keep_prelast->x += keep_prelast->dx;
        prelast->x += prelast->dx;
      }
      draw ^= 1;
    }
    // keep the active list in x order (bubble sort)
    keep_prelast = nullptr;
    do {
      prelast = &head;
      last = head.next;
      Edge* last_exchange = nullptr;
      while (last != keep_prelast && last->next != nullptr) {
        Edge* te = last->next;
        if (last->x > te->x) {
          prelast->next = te;
          last->next = te->next;
          te->next = last;
          prelast = te;
          last_exchange = prelast;
        } else {
          prelast = last;
          last = te;
        }
      }
      if (last_exchange == nullptr) break;
      keep_prelast = last_exchange;
    } while (keep_prelast != head.next && keep_prelast != &head);
  }
}

}  // namespace

// Fills the ncontours polygons (contour c has npts[c] (x, y) int32 points,
// all contours back to back in pts) into mask, h x w uint8, with color, as
// cv2.fillPoly(mask, contours, color) does.  Returns 0.
extern "C" int lp_fill_poly(uint8_t* mask, int h, int w, const int32_t* pts,
                            const int32_t* npts, int ncontours, int color) {
  Img img{mask, h, w};
  std::vector<Edge> edges;
  int total = 0;
  for (int c = 0; c < ncontours; ++c) total += npts[c];
  edges.reserve(total + 1);
  const int32_t* v = pts;
  for (int c = 0; c < ncontours; ++c) {
    if (npts[c] > 0) collect_edges(img, v, npts[c], edges, static_cast<uint8_t>(color));
    v += 2 * npts[c];
  }
  fill_edges(img, edges, static_cast<uint8_t>(color));
  return 0;
}
