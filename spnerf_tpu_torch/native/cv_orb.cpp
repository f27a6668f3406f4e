// cv2.ORB_create(nfeatures).detectAndCompute(gray, None) on an 8-bit gray
// image, with ORB's defaults (scale 1.2, 8 levels, edgeThreshold 31,
// firstLevel 0, WTA_K 2, HARRIS_SCORE, patchSize 31, fastThreshold 20),
// as OpenCV 5.0 computes it on x86-64 (features/src/orb.cpp):
//
//   pyramid   level l is cvRound(side / 1.2^l) on a side, resized from
//             level l - 1 (level 1 from the image) by INTER_LINEAR_EXACT:
//             8-bit weights round(256 f) and 256 - that, both passes in
//             integers, (s + 2^15) >> 16 (rows past the clamp (h + 128) >> 8);
//             an exact halving in both axes is INTER_AREA's 2 x 2 mean;
//   detector  FAST-9 (threshold 20) with non-maximum suppression on each
//             level, raster order, keypoints closer than 31 px to the
//             level's border dropped, retainBest(2 n_l) (std::nth_element,
//             then std::partition of the ties at the cut), the Harris
//             response (7 x 7 Sobel sums in integers, scaled in float32),
//             retainBest(n_l), n_l = cvRound(n (1 - f) f^l / (1 - f^8)) in
//             float32 for f = 1 / 1.2, the last level taking the rest;
//   angle     the intensity centroid over the 31 px disc (umax table),
//             fastAtan2 in degrees without a fused multiply-add (cv2's
//             scalar fastAtan2 is built for the baseline CPU);
//   descriptor each level blurred by GaussianBlur(7 x 7, sigma 2,
//             BORDER_REFLECT_101) as cv2 blurs a sub-matrix of its pyramid
//             buffer: sepFilter2D's float32 path, the row pass by fma left
//             to right up to the last whole group of 32 columns (the AVX2
//             kernel) and with rounded products after it, the symmetric
//             column pass by fma outward from the centre up to the last whole
//             group of 4 columns and with rounded products after it, rounded
//             half to even; then 256 rBRIEF tests of bit_pattern_31_ rotated
//             by the angle, each tap rounded half to even, about the point
//             scaled back to its level.
//
// Every float32 product and sum is in cv2's order: the library is built with
// contraction off (utils/native.py) and each fma is stated. The pyramid
// levels are kept apart here, not in one buffer: the blur's reads past a
// level's edge find in cv2's buffer the level's own BORDER_REFLECT_101
// border, as they do here, and no read of the detector, the angle or the
// descriptor leaves its level (every keypoint is 31 px inside it).
//
// C interface (ctypes): cv_orb_detect(img, h, w, nfeatures) returns a
// handle (null where a pyramid level would be empty); cv_orb_count(handle) the number of keypoints; cv_orb_fetch(handle,
// kp, octave, desc) copies out (N, 5) float32 rows of x, y, size, angle,
// response, the (N,) int32 levels and the (N, 32) uint8 descriptors;
// cv_orb_free(handle) releases it; cv_orb_pattern(out) copies the 1,024
// pattern ints; cv_orb_resize(src, h, w, dst, dh, dw) and cv_orb_blur(src,
// h, w, dst) are the pyramid's resize and the descriptor's blur alone.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kLevels = 8;
constexpr double kScaleFactor = (double)1.2f;
constexpr int kEdgeThreshold = 31;
constexpr int kPatchSize = 31;
constexpr int kFastThreshold = 20;
constexpr int kBytes = 32;
constexpr float kHarrisK = 0.04f;
constexpr int kHarrisBlock = 7;

// OpenCV's orb.cpp bit_pattern_31_ (Apache-2.0, the OpenCV authors): 256
// tests of two points (x, y) each, in OpenCV's order. Read from the compiled
// cv2 module (opencv-python 5.0), where the 1,024 int32 stand at the only
// occurrence of their first eight values; python -m
// spnerf_tpu_torch.tools.orb_pattern reads them again and checks this copy.
const int kPattern[1024] = {
      8,  -3,   9,   5,
      4,   2,   7, -12,
    -11,   9,  -8,   2,
      7, -12,  12, -13,
      2, -13,   2,  12,
      1,  -7,   1,   6,
     -2, -10,  -2,  -4,
    -13, -13, -11,  -8,
    -13,  -3, -12,  -9,
     10,   4,  11,   9,
    -13,  -8,  -8,  -9,
    -11,   7,  -9,  12,
      7,   7,  12,   6,
     -4,  -5,  -3,   0,
    -13,   2, -12,  -3,
     -9,   0,  -7,   5,
     12,  -6,  12,  -1,
     -3,   6,  -2,  12,
     -6, -13,  -4,  -8,
     11, -13,  12,  -8,
      4,   7,   5,   1,
      5,  -3,  10,  -3,
      3,  -7,   6,  12,
     -8,  -7,  -6,  -2,
     -2,  11,  -1, -10,
    -13,  12,  -8,  10,
     -7,   3,  -5,  -3,
     -4,   2,  -3,   7,
    -10, -12,  -6,  11,
      5, -12,   6,  -7,
      5,  -6,   7,  -1,
      1,   0,   4,  -5,
      9,  11,  11, -13,
      4,   7,   4,  12,
      2,  -1,   4,   4,
     -4, -12,  -2,   7,
     -8,  -5,  -7, -10,
      4,  11,   9,  12,
      0,  -8,   1, -13,
    -13,  -2,  -8,   2,
     -3,  -2,  -2,   3,
     -6,   9,  -4,  -9,
      8,  12,  10,   7,
      0,   9,   1,   3,
      7,  -5,  11, -10,
    -13,  -6, -11,   0,
     10,   7,  12,   1,
     -6,  -3,  -6,  12,
     10,  -9,  12,  -4,
    -13,   8,  -8, -12,
    -13,   0,  -8,  -4,
      3,   3,   7,   8,
      5,   7,  10,  -7,
     -1,   7,   1, -12,
      3, -10,   5,   6,
      2,  -4,   3, -10,
    -13,   0, -13,   5,
    -13,  -7, -12,  12,
    -13,   3, -11,   8,
     -7,  12,  -4,   7,
      6, -10,  12,   8,
     -9,  -1,  -7,  -6,
     -2,  -5,   0,  12,
    -12,   5,  -7,   5,
      3, -10,   8, -13,
     -7,  -7,  -4,   5,
     -3,  -2,  -1,  -7,
      2,   9,   5, -11,
    -11, -13,  -5, -13,
     -1,   6,   0,  -1,
      5,  -3,   5,   2,
     -4, -13,  -4,  12,
     -9,  -6,  -9,   6,
    -12, -10,  -8,  -4,
     10,   2,  12,  -3,
      7,  12,  12,  12,
     -7, -13,  -6,   5,
     -4,   9,  -3,   4,
      7,  -1,  12,   2,
     -7,   6,  -5,   1,
    -13,  11, -12,   5,
     -3,   7,  -2,  -6,
      7,  -8,  12,  -7,
    -13,  -7, -11, -12,
      1,  -3,  12,  12,
      2,  -6,   3,   0,
     -4,   3,  -2, -13,
     -1, -13,   1,   9,
      7,   1,   8,  -6,
      1,  -1,   3,  12,
      9,   1,  12,   6,
     -1,  -9,  -1,   3,
    -13, -13, -10,   5,
      7,   7,  10,  12,
     12,  -5,  12,   9,
      6,   3,   7,  11,
      5, -13,   6,  10,
      2, -12,   2,   3,
      3,   8,   4,  -6,
      2,   6,  12, -13,
      9, -12,  10,   3,
     -8,   4,  -7,   9,
    -11,  12,  -4,  -6,
      1,  12,   2,  -8,
      6,  -9,   7,  -4,
      2,   3,   3,  -2,
      6,   3,  11,   0,
      3,  -3,   8,  -8,
      7,   8,   9,   3,
    -11,  -5,  -6,  -4,
    -10,  11,  -5,  10,
     -5,  -8,  -3,  12,
    -10,   5,  -9,   0,
      8,  -1,  12,  -6,
      4,  -6,   6, -11,
    -10,  12,  -8,   7,
      4,  -2,   6,   7,
     -2,   0,  -2,  12,
     -5,  -8,  -5,   2,
      7,  -6,  10,  12,
     -9, -13,  -8,  -8,
     -5, -13,  -5,  -2,
      8,  -8,   9, -13,
     -9, -11,  -9,   0,
      1,  -8,   1,  -2,
      7,  -4,   9,   1,
     -2,   1,  -1,  -4,
     11,  -6,  12, -11,
    -12,  -9,  -6,   4,
      3,   7,   7,  12,
      5,   5,  10,   8,
      0,  -4,   2,   8,
     -9,  12,  -5, -13,
      0,   7,   2,  12,
     -1,   2,   1,   7,
      5,  11,   7,  -9,
      3,   5,   6,  -8,
    -13,  -4,  -8,   9,
     -5,   9,  -3,  -3,
     -4,  -7,  -3, -12,
      6,   5,   8,   0,
     -7,   6,  -6,  12,
    -13,   6,  -5,  -2,
      1, -10,   3,  10,
      4,   1,   8,  -4,
     -2,  -2,   2, -13,
      2, -12,  12,  12,
     -2, -13,   0,  -6,
      4,   1,   9,   3,
     -6, -10,  -3,  -5,
     -3, -13,  -1,   1,
      7,   5,  12, -11,
      4,  -2,   5,  -7,
    -13,   9,  -9,  -5,
      7,   1,   8,   6,
      7,  -8,   7,   6,
     -7,  -4,  -7,   1,
     -8,  11,  -7,  -8,
    -13,   6, -12,  -8,
      2,   4,   3,   9,
     10,  -5,  12,   3,
     -6,  -5,  -6,   7,
      8,  -3,   9,  -8,
      2, -12,   2,   8,
    -11,  -2, -10,   3,
    -12, -13,  -7,  -9,
    -11,   0, -10,  -5,
      5,  -3,  11,   8,
     -2, -13,  -1,  12,
     -1,  -8,   0,   9,
    -13, -11, -12,  -5,
    -10,  -2, -10,  11,
     -3,   9,  -2, -13,
      2,  -3,   3,   2,
     -9, -13,  -4,   0,
     -4,   6,  -3, -10,
     -4,  12,  -2,  -7,
     -6, -11,  -4,   9,
      6,  -3,   6,  11,
    -13,  11,  -5,   5,
     11,  11,  12,   6,
      7,  -5,  12,  -2,
     -1,  12,   0,   7,
     -4,  -8,  -3,  -2,
     -7,   1,  -6,   7,
    -13, -12,  -8, -13,
     -7,  -2,  -6,  -8,
     -8,   5,  -6,  -9,
     -5,  -1,  -4,   5,
    -13,   7,  -8,  10,
      1,   5,   5, -13,
      1,   0,  10, -13,
      9,  12,  10,  -1,
      5,  -8,  10,  -9,
     -1,  11,   1, -13,
     -9,  -3,  -6,   2,
     -1, -10,   1,  12,
    -13,   1,  -8, -10,
      8, -11,  10,  -6,
      2, -13,   3,  -6,
      7, -13,  12,  -9,
    -10, -10,  -5,  -7,
    -10,  -8,  -8, -13,
      4,  -6,   8,   5,
      3,  12,   8, -13,
     -4,   2,  -3,  -3,
      5, -13,  10, -12,
      4, -13,   5,  -1,
     -9,   9,  -4,   3,
      0,   3,   3,  -9,
    -12,   1,  -6,   1,
      3,   2,   4,  -8,
    -10, -10, -10,   9,
      8, -13,  12,  12,
     -8, -12,  -6,  -5,
      2,   2,   3,   7,
     10,   6,  11,  -8,
      6,   8,   8, -12,
     -7,  10,  -6,   5,
     -3,  -9,  -3,   9,
     -1, -13,  -1,   5,
     -3,  -7,  -3,   4,
     -8,  -2,  -8,   3,
      4,   2,  12,  12,
      2,  -5,   3,  11,
      6,  -9,  11, -13,
      3,  -1,   7,  12,
     11,  -1,  12,   4,
     -3,   0,  -3,   6,
      4, -11,   4,  12,
      2,  -4,   2,   1,
    -10,  -6,  -8,   1,
    -13,   7, -11,   1,
    -13,  12, -11, -13,
      6,   0,  11, -13,
      0,  -1,   1,   4,
    -13,   3,  -9,  -2,
     -9,   8,  -6,  -3,
    -13,  -6,  -8,  -2,
      5,  -9,   8,  10,
      2,   7,   3,  -9,
     -1,  -6,  -1,  -1,
      9,   5,  11,  -2,
     11,  -3,  12,  -8,
      3,   0,   3,   5,
     -1,   4,   0,  10,
      3,  -6,   4,   5,
    -13,   0, -10,   5,
      5,   8,  12,  11,
      8,   9,   9,  -6,
      7,  -4,   8, -12,
    -10,   4, -10,   9,
      7,   3,  12,   4,
      9,  -7,  10,  -2,
      7,   0,  12,  -2,
     -1,  -6,   0, -11,
};

struct KeyPoint {
  float x, y, size, angle, response;
  int octave, class_id;
};

struct Img {
  int rows = 0, cols = 0;
  std::vector<uint8_t> px;
  void create(int r, int c) { rows = r; cols = c; px.assign((size_t)r * c, 0); }
  const uint8_t* row(int r) const { return px.data() + (size_t)r * cols; }
  uint8_t* row(int r) { return px.data() + (size_t)r * cols; }
};

inline int round_even(float v) { return (int)std::nearbyintf(v); }
inline int round_even(double v) { return (int)std::nearbyint(v); }

inline int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

// ---- resize INTER_LINEAR_EXACT ---------------------------------------------

struct Axis {
  std::vector<int> ofs, c0, c1;
  int lo = 0, hi = 0;
};

Axis exact_axis(int dst, int src) {
  Axis a;
  a.ofs.assign(dst, 0); a.c0.assign(dst, 0); a.c1.assign(dst, 0);
  a.lo = 0; a.hi = dst;
  const double scale = 1.0 / ((double)dst / (double)src);
  for (int v = 0; v < dst; ++v) {
    const double f = scale * ((double)v + 0.5) - 0.5;
    const int iv = (int)std::floor(f);
    if (iv >= 0 && src > 1) {
      if (iv < src - 1) {
        a.ofs[v] = iv;
        a.c1[v] = round_even((f - (double)iv) * 256.0);
        a.c0[v] = 256 - a.c1[v];
      } else {
        a.ofs[v] = src - 1;
        a.hi = std::min(a.hi, v);
      }
    } else {
      a.lo = std::max(a.lo, v + 1);
    }
  }
  return a;
}

void resize_exact(const Img& src, Img& dst, int dw, int dh) {
  dst.create(dh, dw);
  if (dw == src.cols && dh == src.rows) { dst.px = src.px; return; }
  if (src.cols == 2 * dw && src.rows == 2 * dh) {  // INTER_AREA
    for (int y = 0; y < dh; ++y)
      for (int x = 0; x < dw; ++x) {
        const int s = src.row(2 * y)[2 * x] + src.row(2 * y)[2 * x + 1] +
                      src.row(2 * y + 1)[2 * x] + src.row(2 * y + 1)[2 * x + 1];
        dst.row(y)[x] = (uint8_t)((s + 2) >> 2);
      }
    return;
  }
  const Axis ax = exact_axis(dw, src.cols), ay = exact_axis(dh, src.rows);
  const int last = ax.hi < dw ? ax.ofs[dw - 1] : 0;
  auto hline = [&](int r, std::vector<int>& h) {
    const uint8_t* p = src.row(r);
    for (int x = 0; x < dw; ++x) {
      if (x < ax.lo) h[x] = 256 * p[0];
      else if (x < ax.hi) h[x] = ax.c0[x] * p[ax.ofs[x]] + ax.c1[x] * p[ax.ofs[x] + 1];
      else h[x] = 256 * p[last];
    }
  };
  std::vector<int> h0(dw), h1(dw);
  for (int y = 0; y < dh; ++y) {
    uint8_t* o = dst.row(y);
    if (y < ay.lo || y >= ay.hi) {
      hline(y < ay.lo ? 0 : src.rows - 1, h0);
      for (int x = 0; x < dw; ++x) o[x] = (uint8_t)std::min((h0[x] + 128) >> 8, 255);
    } else {
      hline(ay.ofs[y], h0);
      hline(ay.ofs[y] + 1, h1);
      for (int x = 0; x < dw; ++x) {
        const int64_t s = (int64_t)ay.c0[y] * h0[x] + (int64_t)ay.c1[y] * h1[x];
        o[x] = (uint8_t)std::min<int64_t>((s + 32768) >> 16, 255);
      }
    }
  }
}

// ---- GaussianBlur 7x7 sigma 2 ----------------------------------------------

// getGaussianKernelBitExact(n, sigma > 0) in float64
std::vector<double> gaussian_kernel(int n, double sigma) {
  const double scale2x = -0.125 / (sigma * sigma);
  const int half = (n - 1) / 2;
  std::vector<double> values(half);
  double sum = 0;
  for (int i = 0, x = 1 - n; i < half; ++i, x += 2) {
    values[i] = std::exp((double)(x * x) * scale2x);
    sum += values[i];
  }
  sum = sum * 2 + 1;
  const double mul = 1 / sum;
  std::vector<double> k(n);
  for (int i = 0; i < half; ++i) k[i] = k[n - 1 - i] = values[i] * mul;
  k[half] = mul;
  return k;
}

// GaussianBlur(level, (7, 7), 2, 2, BORDER_REFLECT_101) of a level inside
// cv2's pyramid buffer (module comment)
void blur(const Img& src, Img& dst) {
  constexpr int n = 7, a = 3;
  const int h = src.rows, w = src.cols;
  const std::vector<double> kd = gaussian_kernel(n, 2.0);
  float k[n];
  for (int i = 0; i < n; ++i) k[i] = (float)kd[i];
  std::vector<int> xs(w + n - 1), ys(h + n - 1);
  for (int i = 0; i < w + n - 1; ++i) xs[i] = reflect101(i - a, w);
  for (int i = 0; i < h + n - 1; ++i) ys[i] = reflect101(i - a, h);
  std::vector<float> rows((size_t)h * w);
  const int row_fused = w - w % 32;
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = src.row(y);
    float* r = rows.data() + (size_t)y * w;
    for (int x = 0; x < w; ++x) {
      const int* xi = xs.data() + x;
      float acc = k[0] * (float)s[xi[0]];
      if (x < row_fused)
        for (int i = 1; i < n; ++i) acc = std::fmaf((float)s[xi[i]], k[i], acc);
      else
        for (int i = 1; i < n; ++i) acc = acc + k[i] * (float)s[xi[i]];
      r[x] = acc;
    }
  }
  dst.create(h, w);
  const int col_fused = w - w % 4;
  for (int y = 0; y < h; ++y) {
    const float* r[n];
    for (int i = 0; i < n; ++i) r[i] = rows.data() + (size_t)ys[y + i] * w;
    uint8_t* o = dst.row(y);
    for (int x = 0; x < w; ++x) {
      float acc = k[a] * r[a][x];
      if (x < col_fused)
        for (int j = 1; j <= a; ++j) acc = std::fmaf(k[a + j], r[a + j][x] + r[a - j][x], acc);
      else
        for (int j = 1; j <= a; ++j) acc = acc + k[a + j] * (r[a + j][x] + r[a - j][x]);
      o[x] = (uint8_t)std::min(std::max(round_even(acc), 0), 255);
    }
  }
}

// ---- FAST-9 ----------------------------------------------------------------

int corner_score(const uint8_t* ptr, const int* pixel, int threshold) {
  const int K = 8, N = K * 3 + 1;
  const int v = ptr[0];
  short d[N];
  for (int k = 0; k < N; ++k) d[k] = (short)(v - ptr[pixel[k]]);
  int a0 = threshold;
  for (int k = 0; k < 16; k += 2) {
    int a = std::min((int)d[k + 1], (int)d[k + 2]);
    a = std::min(a, (int)d[k + 3]);
    if (a <= a0) continue;
    a = std::min(a, (int)d[k + 4]);
    a = std::min(a, (int)d[k + 5]);
    a = std::min(a, (int)d[k + 6]);
    a = std::min(a, (int)d[k + 7]);
    a = std::min(a, (int)d[k + 8]);
    a0 = std::max(a0, std::min(a, (int)d[k]));
    a0 = std::max(a0, std::min(a, (int)d[k + 9]));
  }
  int b0 = -a0;
  for (int k = 0; k < 16; k += 2) {
    int b = std::max((int)d[k + 1], (int)d[k + 2]);
    b = std::max(b, (int)d[k + 3]);
    b = std::max(b, (int)d[k + 4]);
    b = std::max(b, (int)d[k + 5]);
    if (b >= b0) continue;
    b = std::max(b, (int)d[k + 6]);
    b = std::max(b, (int)d[k + 7]);
    b = std::max(b, (int)d[k + 8]);
    b0 = std::min(b0, std::max(b, (int)d[k]));
    b0 = std::min(b0, std::max(b, (int)d[k + 9]));
  }
  return -b0 - 1;
}

void fast9(const Img& img, int threshold, std::vector<KeyPoint>& out) {
  static const int offsets[16][2] = {
      {0, 3}, {1, 3}, {2, 2}, {3, 1}, {3, 0}, {3, -1}, {2, -2}, {1, -3},
      {0, -3}, {-1, -3}, {-2, -2}, {-3, -1}, {-3, 0}, {-3, 1}, {-2, 2}, {-1, 3}};
  const int step = img.cols, K = 8, N = 16 + K + 1;
  int pixel[25];
  for (int k = 0; k < 16; ++k) pixel[k] = offsets[k][0] + offsets[k][1] * step;
  for (int k = 16; k < 25; ++k) pixel[k] = pixel[k - 16];
  out.clear();
  threshold = std::min(std::max(threshold, 0), 255);
  uint8_t tab[512];
  for (int i = -255; i <= 255; ++i)
    tab[i + 255] = (uint8_t)(i < -threshold ? 1 : i > threshold ? 2 : 0);
  const int cols = img.cols;
  std::vector<uint8_t> buf[3];
  std::vector<int> cpos[3];
  for (int i = 0; i < 3; ++i) { buf[i].assign(cols, 0); cpos[i].clear(); }
  for (int i = 3; i < img.rows - 2; ++i) {
    uint8_t* curr = buf[(i - 3) % 3].data();
    std::vector<int>& corners = cpos[(i - 3) % 3];
    std::fill(curr, curr + cols, 0);
    corners.clear();
    if (i < img.rows - 3) {
      const uint8_t* ptr = img.row(i) + 3;
      for (int j = 3; j < cols - 3; ++j, ++ptr) {
        const int v = ptr[0];
        const uint8_t* t = tab - v + 255;
        int d = t[ptr[pixel[0]]] | t[ptr[pixel[8]]];
        if (d == 0) continue;
        d &= t[ptr[pixel[2]]] | t[ptr[pixel[10]]];
        d &= t[ptr[pixel[4]]] | t[ptr[pixel[12]]];
        d &= t[ptr[pixel[6]]] | t[ptr[pixel[14]]];
        if (d == 0) continue;
        d &= t[ptr[pixel[1]]] | t[ptr[pixel[9]]];
        d &= t[ptr[pixel[3]]] | t[ptr[pixel[11]]];
        d &= t[ptr[pixel[5]]] | t[ptr[pixel[13]]];
        d &= t[ptr[pixel[7]]] | t[ptr[pixel[15]]];
        if (d & 1) {
          const int vt = v - threshold;
          int count = 0;
          for (int k = 0; k < N; ++k) {
            if (ptr[pixel[k]] < vt) {
              if (++count > K) {
                corners.push_back(j);
                curr[j] = (uint8_t)corner_score(ptr, pixel, threshold);
                break;
              }
            } else count = 0;
          }
        }
        if (d & 2) {
          const int vt = v + threshold;
          int count = 0;
          for (int k = 0; k < N; ++k) {
            if (ptr[pixel[k]] > vt) {
              if (++count > K) {
                corners.push_back(j);
                curr[j] = (uint8_t)corner_score(ptr, pixel, threshold);
                break;
              }
            } else count = 0;
          }
        }
      }
    }
    if (i == 3) continue;
    const uint8_t* prev = buf[(i - 4 + 3) % 3].data();
    const uint8_t* pprev = buf[(i - 5 + 3) % 3].data();
    for (int j : cpos[(i - 4 + 3) % 3]) {
      const int score = prev[j];
      if (score > prev[j + 1] && score > prev[j - 1] && score > pprev[j - 1] &&
          score > pprev[j] && score > pprev[j + 1] && score > curr[j - 1] &&
          score > curr[j] && score > curr[j + 1])
        out.push_back({(float)j, (float)(i - 1), 7.f, -1.f, (float)score, 0, -1});
    }
  }
}

// ---- selection -------------------------------------------------------------

void retain_best(std::vector<KeyPoint>& kps, int n) {
  if (n >= 0 && kps.size() > (size_t)n) {
    if (n == 0) { kps.clear(); return; }
    std::nth_element(kps.begin(), kps.begin() + n - 1, kps.end(),
                     [](const KeyPoint& a, const KeyPoint& b) { return a.response > b.response; });
    const float amb = kps[n - 1].response;
    auto end = std::partition(kps.begin() + n, kps.end(),
                              [amb](const KeyPoint& k) { return k.response >= amb; });
    kps.resize(end - kps.begin());
  }
}

void run_by_border(std::vector<KeyPoint>& kps, int w, int h, int b) {
  if (h <= b * 2 || w <= b * 2) { kps.clear(); return; }
  kps.erase(std::remove_if(kps.begin(), kps.end(), [&](const KeyPoint& k) {
              return !(b <= k.x && k.x < w - b && b <= k.y && k.y < h - b);
            }), kps.end());
}

void harris(const std::vector<Img>& levels, std::vector<KeyPoint>& kps) {
  const int r = kHarrisBlock / 2;
  const float scale = 1.f / ((1 << 2) * kHarrisBlock * 255.f);
  const float scale_sq_sq = scale * scale * scale * scale;
  for (KeyPoint& k : kps) {
    const Img& img = levels[k.octave];
    const int step = img.cols;
    const int x0 = round_even(k.x), y0 = round_even(k.y);
    const uint8_t* ptr0 = img.row(y0 - r) + x0 - r;
    int a = 0, b = 0, c = 0;
    for (int i = 0; i < kHarrisBlock; ++i)
      for (int j = 0; j < kHarrisBlock; ++j) {
        const uint8_t* p = ptr0 + i * step + j;
        const int ix = (p[1] - p[-1]) * 2 + (p[-step + 1] - p[-step - 1]) + (p[step + 1] - p[step - 1]);
        const int iy = (p[step] - p[-step]) * 2 + (p[step - 1] - p[-step - 1]) + (p[step + 1] - p[-step + 1]);
        a += ix * ix; b += iy * iy; c += ix * iy;
      }
    k.response = ((float)a * b - (float)c * c - kHarrisK * ((float)a + b) * ((float)a + b)) * scale_sq_sq;
  }
}

// cv::fastAtan2 in degrees, each product and sum rounded
float fast_atan2(float y, float x) {
  const float p1 = 0.9997878412794807f * (float)(180 / M_PI);
  const float p3 = -0.3258083974640975f * (float)(180 / M_PI);
  const float p5 = 0.1555786518463281f * (float)(180 / M_PI);
  const float p7 = -0.04432655554792128f * (float)(180 / M_PI);
  const float ax = std::fabs(x), ay = std::fabs(y);
  float a;
  if (ax >= ay) {
    const float c = ay / (ax + (float)2.220446049250313e-16);
    const float c2 = c * c;
    a = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c;
  } else {
    const float c = ax / (ay + (float)2.220446049250313e-16);
    const float c2 = c * c;
    a = 90.f - (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c;
  }
  if (x < 0) a = 180.f - a;
  if (y < 0) a = 360.f - a;
  return a;
}

void ic_angles(const std::vector<Img>& levels, std::vector<KeyPoint>& kps, const std::vector<int>& umax, int half_k) {
  for (KeyPoint& k : kps) {
    const Img& img = levels[k.octave];
    const int step = img.cols;
    const uint8_t* center = img.row(round_even(k.y)) + round_even(k.x);
    int m_01 = 0, m_10 = 0;
    for (int u = -half_k; u <= half_k; ++u) m_10 += u * center[u];
    for (int v = 1; v <= half_k; ++v) {
      int v_sum = 0;
      const int d = umax[v];
      for (int u = -d; u <= d; ++u) {
        const int val_plus = center[u + v * step], val_minus = center[u - v * step];
        v_sum += (val_plus - val_minus);
        m_10 += u * (val_plus + val_minus);
      }
      m_01 += v * v_sum;
    }
    k.angle = fast_atan2((float)m_01, (float)m_10);
  }
}

struct Result {
  std::vector<KeyPoint> kps;
  std::vector<uint8_t> desc;
};

// nullptr where a level would be empty (cv2's resize asserts there)
Result* detect(const uint8_t* image, int rows, int cols, int nfeatures) {
  const int nlevels = kLevels;
  std::vector<float> layer_scale(nlevels);
  std::vector<int> level_w(nlevels), level_h(nlevels);
  for (int level = 0; level < nlevels; ++level) {
    const float scale = (float)std::pow(kScaleFactor, (double)level);
    layer_scale[level] = scale;
    const float inv_scale = 1.0f / scale;
    level_w[level] = round_even((float)cols * inv_scale);
    level_h[level] = round_even((float)rows * inv_scale);
    if (level_w[level] <= 0 || level_h[level] <= 0) return nullptr;
  }
  Result* res = new Result();
  std::vector<Img> levels(nlevels);
  levels[0].create(rows, cols);
  std::memcpy(levels[0].px.data(), image, (size_t)rows * cols);
  for (int level = 1; level < nlevels; ++level)
    resize_exact(levels[level - 1], levels[level], level_w[level], level_h[level]);
  // per-level budget
  std::vector<int> per_level(nlevels);
  const float factor = (float)(1.0 / kScaleFactor);
  float ndesired = nfeatures * (1 - factor) / (1 - (float)std::pow((double)factor, (double)nlevels));
  int sum = 0;
  for (int level = 0; level < nlevels - 1; ++level) {
    per_level[level] = round_even(ndesired);
    sum += per_level[level];
    ndesired *= factor;
  }
  per_level[nlevels - 1] = std::max(nfeatures - sum, 0);
  const int half = kPatchSize / 2;
  std::vector<int> umax(half + 2);
  const int vmax = (int)std::floor(half * std::sqrt(2.f) / 2 + 1);
  const int vmin = (int)std::ceil(half * std::sqrt(2.f) / 2);
  for (int v = 0; v <= vmax; ++v) umax[v] = round_even(std::sqrt((double)half * half - v * v));
  for (int v = half, v0 = 0; v >= vmin; --v) {
    while (umax[v0] == umax[v0 + 1]) ++v0;
    umax[v] = v0;
    ++v0;
  }
  std::vector<KeyPoint> all, kps;
  std::vector<int> counters(nlevels);
  for (int level = 0; level < nlevels; ++level) {
    const Img& img = levels[level];
    fast9(img, kFastThreshold, kps);
    run_by_border(kps, img.cols, img.rows, kEdgeThreshold);
    retain_best(kps, 2 * per_level[level]);
    counters[level] = (int)kps.size();
    const float sf = layer_scale[level];
    for (KeyPoint& k : kps) { k.octave = level; k.size = kPatchSize * sf; }
    all.insert(all.end(), kps.begin(), kps.end());
  }
  if (!all.empty()) {
    harris(levels, all);
    std::vector<KeyPoint> fresh;
    int offset = 0;
    for (int level = 0; level < nlevels; ++level) {
      kps.assign(all.begin() + offset, all.begin() + offset + counters[level]);
      offset += counters[level];
      retain_best(kps, per_level[level]);
      fresh.insert(fresh.end(), kps.begin(), kps.end());
    }
    all.swap(fresh);
    ic_angles(levels, all, umax, half);
    for (KeyPoint& k : all) {
      const float s = layer_scale[k.octave];
      k.x *= s; k.y *= s;
    }
  }
  res->kps = all;
  if (all.empty()) return res;
  // descriptors on the blurred levels (only those with keypoints)
  std::vector<Img> blurred(nlevels);
  for (int level = 0; level < nlevels; ++level)
    if (counters[level] > 0) blur(levels[level], blurred[level]);
  res->desc.assign(all.size() * kBytes, 0);
  for (size_t j = 0; j < all.size(); ++j) {
    const KeyPoint& k = all[j];
    const Img& img = blurred[k.octave];
    const int step = img.cols;
    const float scale = 1.f / layer_scale[k.octave];
    float angle = k.angle;
    angle *= (float)(M_PI / 180.f);
    const float a = (float)std::cos((double)angle), b = (float)std::sin((double)angle);
    const uint8_t* center = img.row(round_even(k.y * scale)) + round_even(k.x * scale);
    const int* pattern = kPattern;
    uint8_t* desc = res->desc.data() + j * kBytes;
    for (int i = 0; i < kBytes; ++i, pattern += 32) {
      int val = 0;
      for (int bit = 0; bit < 8; ++bit) {
        int t[2];
        for (int q = 0; q < 2; ++q) {
          const int px = pattern[4 * bit + 2 * q], py = pattern[4 * bit + 2 * q + 1];
          const float x = px * a - py * b, y = px * b + py * a;
          t[q] = center[round_even(y) * step + round_even(x)];
        }
        val |= (t[0] < t[1]) << bit;
      }
      desc[i] = (uint8_t)val;
    }
  }
  return res;
}

}  // namespace

extern "C" {

void* cv_orb_detect(const uint8_t* img, int32_t h, int32_t w, int32_t nfeatures) {
  return detect(img, h, w, nfeatures);
}

int64_t cv_orb_count(void* handle) {
  return (int64_t)static_cast<Result*>(handle)->kps.size();
}

void cv_orb_fetch(void* handle, float* kp, int32_t* octave, uint8_t* desc) {
  const Result* r = static_cast<Result*>(handle);
  for (size_t i = 0; i < r->kps.size(); ++i) {
    const KeyPoint& k = r->kps[i];
    float* row = kp + 5 * i;
    row[0] = k.x; row[1] = k.y; row[2] = k.size; row[3] = k.angle; row[4] = k.response;
    octave[i] = k.octave;
  }
  if (!r->desc.empty()) std::memcpy(desc, r->desc.data(), r->desc.size());
}

void cv_orb_free(void* handle) { delete static_cast<Result*>(handle); }

void cv_orb_pattern(int32_t* out) {
  for (int i = 0; i < 1024; ++i) out[i] = kPattern[i];
}

void cv_orb_resize(const uint8_t* src, int32_t h, int32_t w, uint8_t* dst, int32_t dh, int32_t dw) {
  Img s, d;
  s.create(h, w);
  std::memcpy(s.px.data(), src, (size_t)h * w);
  resize_exact(s, d, dw, dh);
  std::memcpy(dst, d.px.data(), (size_t)dh * dw);
}

void cv_orb_blur(const uint8_t* src, int32_t h, int32_t w, uint8_t* dst) {
  Img s, d;
  s.create(h, w);
  std::memcpy(s.px.data(), src, (size_t)h * w);
  blur(s, d);
  std::memcpy(dst, d.px.data(), (size_t)h * w);
}

}  // extern "C"
