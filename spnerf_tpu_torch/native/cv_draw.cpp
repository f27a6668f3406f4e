// OpenCV's integer line and convex-polygon rasteriser (imgproc/drawing.cpp)
// at line type 8 on an (h, w) uint8 image, in place, as data/cv_draw.py
// calls it:
//   cv_clip_line:        cv::clipLine, the ends moved onto the border;
//   cv_line8:            cv::Line, a Bresenham walk from the left end,
//                        clipped first where an end lies outside;
//   cv_fill_convex_poly: cv::FillConvexPoly, the edges drawn (by cv_line8
//                        at shift 0, else by Line2, a 16.16 fixed-point
//                        DDA), then the spans between the two chains that
//                        start at the top vertex.
// The C arithmetic of the original is kept: truncating division, 64-bit
// coordinates, arithmetic right shifts.
#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <utility>

namespace {

constexpr int XY_SHIFT = 16;
constexpr int64_t XY_ONE = int64_t(1) << XY_SHIFT;

struct Image {
  uint8_t* data;
  int64_t h, w;
  void put(int64_t y, int64_t x, uint8_t c) const {
    if (0 <= x && x < w && 0 <= y && y < h) data[y * w + x] = c;
  }
  void hline(int64_t y, int64_t x1, int64_t x2, uint8_t c) const {
    std::fill(data + y * w + x1, data + y * w + x2 + 1, c);
  }
};

bool clip_line(int64_t width, int64_t height, int64_t& x1, int64_t& y1,
               int64_t& x2, int64_t& y2) {
  if (width <= 0 || height <= 0) return false;
  const int64_t right = width - 1, bottom = height - 1;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (int64_t)((double)(a - y1) * (double)(x2 - x1) /
                      (double)(y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (int64_t)((double)(a - y2) * (double)(x2 - x1) /
                      (double)(y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (int64_t)((double)(a - x1) * (double)(y2 - y1) /
                        (double)(x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (int64_t)((double)(a - x2) * (double)(y2 - y1) /
                        (double)(x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

void line8(const Image& img, int64_t x1, int64_t y1, int64_t x2, int64_t y2,
           uint8_t color) {
  if (!(0 <= x1 && x1 < img.w && 0 <= x2 && x2 < img.w && 0 <= y1 &&
        y1 < img.h && 0 <= y2 && y2 < img.h) &&
      !clip_line(img.w, img.h, x1, y1, x2, y2))
    return;
  int64_t dx = x2 - x1, dy = y2 - y1;
  if (dx < 0) {
    dx = -dx;
    dy = -dy;
    std::swap(x1, x2);
    std::swap(y1, y2);
  }
  int64_t step_y = 1;
  if (dy < 0) {
    dy = -dy;
    step_y = -1;
  }
  const int64_t n = std::max(dx, dy);
  for (int64_t k = 0; k <= n; ++k) {
    if (dy > dx) {  // y is the major axis, x the minor one (it only grows)
      img.put(y1 + step_y * k, x1 + (2 * dx * k + dy - 1) / (2 * dy), color);
    } else {
      const int64_t minor = dx ? (2 * dy * k + dx - 1) / (2 * dx) : 0;
      img.put(y1 + step_y * minor, x1 + k, color);
    }
  }
}

// cv::Line2: between 16.16 fixed-point ends, one pixel a step along the
// major axis, plus the far end's pixel.
void line2(const Image& img, int64_t x1, int64_t y1, int64_t x2, int64_t y2,
           uint8_t color) {
  if (!clip_line(img.w << XY_SHIFT, img.h << XY_SHIFT, x1, y1, x2, y2))
    return;
  int64_t dx = x2 - x1, dy = y2 - y1;
  const int64_t ax = std::llabs(dx), ay = std::llabs(dy);
  int64_t step, ecount;
  if (ax > ay) {
    if (dx < 0) {
      dy = -dy;
      std::swap(x1, x2);
      std::swap(y1, y2);
    }
    step = (dy * XY_ONE) / (ax | 1);
    ecount = (x2 - x1) >> XY_SHIFT;
  } else {
    if (dy < 0) {
      dx = -dx;
      std::swap(x1, x2);
      std::swap(y1, y2);
    }
    step = (dx * XY_ONE) / (ay | 1);
    ecount = (y2 - y1) >> XY_SHIFT;
  }
  x1 += XY_ONE >> 1;
  y1 += XY_ONE >> 1;
  img.put((y2 + (XY_ONE >> 1)) >> XY_SHIFT, (x2 + (XY_ONE >> 1)) >> XY_SHIFT,
          color);
  for (int64_t k = 0; k <= ecount; ++k) {
    if (ax > ay)
      img.put((y1 + k * step) >> XY_SHIFT, (x1 >> XY_SHIFT) + k, color);
    else
      img.put((y1 >> XY_SHIFT) + k, (x1 + k * step) >> XY_SHIFT, color);
  }
}

}  // namespace

extern "C" int cv_clip_line(int64_t width, int64_t height, int64_t* pts) {
  return clip_line(width, height, pts[0], pts[1], pts[2], pts[3]);
}

extern "C" void cv_line8(uint8_t* data, int64_t h, int64_t w, int64_t x1,
                         int64_t y1, int64_t x2, int64_t y2, int32_t color) {
  line8(Image{data, h, w}, x1, y1, x2, y2, (uint8_t)color);
}

// pts: npts (x, y) pairs with `shift` fractional bits
extern "C" void cv_fill_convex_poly(uint8_t* data, int64_t h, int64_t w,
                                    const int64_t* pts, int64_t npts,
                                    int32_t color_, int32_t shift) {
  const Image img{data, h, w};
  const uint8_t color = (uint8_t)color_;
  const int64_t delta = (int64_t(1) << shift) >> 1;
  const int64_t delta1 = XY_ONE >> 1, delta2 = XY_ONE >> 1;
  const int up = XY_SHIFT - shift;
  int64_t px = pts[2 * (npts - 1)] * (int64_t(1) << up);
  int64_t py = pts[2 * (npts - 1) + 1] * (int64_t(1) << up);
  int64_t xmin = pts[0], xmax = pts[0], ymin = pts[1], ymax = pts[1];
  int64_t imin = 0;
  for (int64_t i = 0; i < npts; ++i) {
    int64_t x = pts[2 * i], y = pts[2 * i + 1];
    if (y < ymin) {
      ymin = y;
      imin = i;
    }
    ymax = std::max(ymax, y);
    xmax = std::max(xmax, x);
    xmin = std::min(xmin, x);
    x *= int64_t(1) << up;
    y *= int64_t(1) << up;
    if (shift == 0)
      line8(img, px >> XY_SHIFT, py >> XY_SHIFT, x >> XY_SHIFT,
            y >> XY_SHIFT, color);
    else
      line2(img, px, py, x, y, color);
    px = x;
    py = y;
  }
  xmin = (xmin + delta) >> shift;
  xmax = (xmax + delta) >> shift;
  ymin = (ymin + delta) >> shift;
  ymax = (ymax + delta) >> shift;
  if (npts < 3 || xmax < 0 || ymax < 0 || xmin >= w || ymin >= h) return;
  ymax = std::min(ymax, h - 1);
  int64_t e_idx[2] = {imin, imin}, e_di[2] = {1, npts - 1};
  int64_t e_x[2] = {-XY_ONE, -XY_ONE}, e_dx[2] = {0, 0};
  int64_t y = ymin;
  int64_t e_ye[2] = {y, y};
  int64_t edges = npts;
  for (;;) {
    for (int i = 0; i < 2; ++i) {
      if (y < e_ye[i]) continue;
      int64_t idx0 = e_idx[i], di = e_di[i];
      int64_t idx = idx0 + di;
      if (idx >= npts) idx -= npts;
      while (edges-- > 0) {
        const int64_t ty = (pts[2 * idx + 1] + delta) >> shift;
        if (ty > y) {
          const int64_t xs = pts[2 * idx0] * (int64_t(1) << up);
          const int64_t xe = pts[2 * idx] * (int64_t(1) << up);
          e_ye[i] = ty;
          e_dx[i] = ((xe - xs) * 2 + (ty - y)) / (2 * (ty - y));
          e_x[i] = xs;
          e_idx[i] = idx;
          break;
        }
        idx0 = idx;
        idx += di;
        if (idx >= npts) idx -= npts;
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      const int left = e_x[0] > e_x[1] ? 1 : 0, right = 1 - left;
      const int64_t xx1 = (e_x[left] + delta1) >> XY_SHIFT;
      const int64_t xx2 = (e_x[right] + delta2) >> XY_SHIFT;
      if (xx2 >= 0 && xx1 < w)
        img.hline(y, std::max<int64_t>(xx1, 0), std::min(xx2, w - 1), color);
    }
    e_x[0] += e_dx[0];
    e_x[1] += e_dx[1];
    if (++y > ymax) break;
  }
}
