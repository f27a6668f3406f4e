// cv2.SIFT_create(nfeatures, 3, 0.04, 10, 1.6).detectAndCompute(gray, None)
// on an 8-bit gray image, as OpenCV 5.0 computes it on x86-64
// (sift.dispatch.cpp / sift.simd.hpp, descriptors in float32):
//
//   base      the image as float32, doubled by INTER_LINEAR, blurred by
//             sigma sqrt(max(1.6^2 - 1, 0.01)) (firstOctave = -1);
//   pyramid   cvRound(log2(min side) - 2) + 1 octaves of 6 Gaussians each,
//             incremental sigmas in float64; an octave starts from layer 3
//             of the one before, halved by INTER_NEAREST; 5 DoG layers;
//   extrema   |v| > floor(0.5 * 0.04 / 3 * 255) = 1, 5 px from the border,
//             v >= (or <=) all 26 neighbours; up to 5 Newton steps (the
//             3 x 3 solve by Cramer's rule in float32, Matx::solve),
//             |contrast| * 3 >= 0.04, the edge test at r = 10;
//   angles    36-bin histogram of the gradients within 4.5 sigma, weights
//             exp(-r^2 / (2 (1.5 sigma)^2)), smoothed by [1 4 6 4 1] / 16,
//             every peak >= 0.8 max interpolated by a parabola;
//   selection KeyPointsFilter::removeDuplicatedSorted, retainBest(n), the
//             octave word and coordinates unpacked to firstOctave = -1;
//   descriptor 4 x 4 x 8 bins, trilinear, cut at 0.2 of the norm, scaled
//             by 512 over the new norm, rounded and saturated to 0..255.
//
// Every float32 sum is in OpenCV's order, with a fused multiply-add
// exactly where its build (GCC, -ffp-contract=fast, on AVX2 / AVX-512)
// contracts one: the port builds it with contraction off
// (utils/native.py) and it states each fma. Two widths matter: `lanes`, the vector width of sift.simd.hpp's
// dispatch (16 on AVX-512, 8 on AVX2), which splits the orientation and
// descriptor histograms into a vector part and a scalar tail that round
// differently; and the AVX2 width (8) of the filter and math kernels
// (GaussianBlur's column tail, fastAtan2's scalar path). cv2's hal::exp32f
// and hal::magnitude32f route to IPP when OpenCV is built with it; this
// file copies OpenCV's own kernels, so orientations may differ from such a
// build in the last float32 bits (descriptors and keypoints did not, in
// the tests).
//
// C interface (ctypes): cv_sift_lanes() is the width cv2 dispatches to on
// this CPU; cv_sift_detect(img, h, w, nfeatures, lanes) returns a handle; cv_sift_count(handle) the number of keypoints;
// cv_sift_fetch(handle, kp, octave, desc) copies out (N, 5) float32 rows
// of x, y, size, angle, response, the (N,) packed octave words and the
// (N, 128) float32 descriptors; cv_sift_free(handle) releases it.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kLayers = 3;             // nOctaveLayers
constexpr float kContrast = 0.04f;     // contrastThreshold
constexpr float kEdge = 10.f;          // edgeThreshold
constexpr double kSigma = 1.6;         // sigma
constexpr int kFirstOctave = -1;
constexpr float kInitSigma = 0.5f;
constexpr int kBorder = 5;
constexpr int kInterpSteps = 5;
constexpr int kOriBins = 36;
constexpr float kOriSigFactor = 1.5f;
constexpr float kOriRadius = 3 * kOriSigFactor;
constexpr float kOriPeakRatio = 0.8f;
constexpr int kDescWidth = 4;
constexpr int kDescBins = 8;
constexpr int kDescLen = kDescWidth * kDescWidth * kDescBins;
constexpr float kDescSclFactor = 3.f;
constexpr float kDescMagThr = 0.2f;
constexpr float kIntDescFactor = 512.f;
constexpr int kAvx2Lanes = 8;
constexpr float kFltEpsilon = 1.1920928955078125e-07f;

inline int round_even(double v) { return (int)std::nearbyint(v); }
inline int round_even(float v) { return (int)std::nearbyintf(v); }
inline int floor_int(float v) { return (int)std::floor(v); }

struct Mat {
  int rows = 0, cols = 0;
  std::vector<float> px;
  void create(int r, int c) { rows = r; cols = c; px.assign((size_t)r * c, 0.f); }
  const float* row(int r) const { return px.data() + (size_t)r * cols; }
  float* row(int r) { return px.data() + (size_t)r * cols; }
  float at(int r, int c) const { return px[(size_t)r * cols + c]; }
};

struct KeyPoint {
  float x, y, size, angle, response;
  int octave, class_id;
};

inline int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

// getGaussianKernelBitExact(n, sigma > 0) rounded to float32
std::vector<float> gaussian_kernel(int n, double sigma) {
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
  std::vector<float> k(n);
  for (int i = 0; i < half; ++i) k[i] = k[n - 1 - i] = (float)(values[i] * mul);
  k[half] = (float)mul;
  return k;
}

// GaussianBlur(src, dst, Size(), sigma, sigma) of a float32 image:
// sepFilter2D with BORDER_REFLECT_101. The row pass sums the taps left to
// right by fma, except the last cols % 4 columns (the scalar remainder),
// which round each product; the symmetric column pass adds each pair of
// rows first and sums outward from the centre by fma, except the columns
// past the last whole AVX2 vector, which round each product.
void gaussian_blur(const Mat& src, Mat& dst, double sigma) {
  const int n = round_even(sigma * 4 * 2 + 1) | 1;
  const int h = src.rows, w = src.cols;
  const std::vector<float> one(1, 1.f);
  const std::vector<float> kern = gaussian_kernel(n, sigma);
  const std::vector<float>& kx = w == 1 ? one : kern;
  const std::vector<float>& ky = h == 1 ? one : kern;
  dst.create(h, w);
  if (kx.size() == 1 && ky.size() == 1) {
    dst.px = src.px;
    return;
  }
  const int nx = (int)kx.size(), ax = nx / 2;
  const int ny = (int)ky.size(), ay = ny / 2;
  Mat rows;
  rows.create(h, w);
  std::vector<float> line(w + nx - 1);
  const int row_body = w - w % 4;
  for (int y = 0; y < h; ++y) {
    const float* s = src.row(y);
    for (int i = 0; i < w + nx - 1; ++i) line[i] = s[reflect101(i - ax, w)];
    float* r = rows.row(y);
    for (int x = 0; x < w; ++x) r[x] = kx[0] * line[x];
    for (int j = 1; j < nx; ++j) {
      const float t = kx[j];
      const float* l = line.data() + j;
      for (int x = 0; x < row_body; ++x) r[x] = std::fmaf(l[x], t, r[x]);
      for (int x = row_body; x < w; ++x) r[x] = r[x] + l[x] * t;
    }
  }
  const int col_body = w - w % kAvx2Lanes;
  std::vector<const float*> taps(ny);
  for (int y = 0; y < h; ++y) {
    for (int i = 0; i < ny; ++i) taps[i] = rows.row(reflect101(y + i - ay, h));
    float* o = dst.row(y);
    const float* c = taps[ay];
    for (int x = 0; x < w; ++x) o[x] = c[x] * ky[ay];
    for (int j = 1; j <= ay; ++j) {
      const float t = ky[ay + j];
      const float* up = taps[ay + j];
      const float* dn = taps[ay - j];
      for (int x = 0; x < col_body; ++x) o[x] = std::fmaf(up[x] + dn[x], t, o[x]);
      for (int x = col_body; x < w; ++x) o[x] = o[x] + (up[x] + dn[x]) * t;
    }
  }
}

// resize(src, 2x, INTER_LINEAR) of a float32 image: every weight is 1/4 or
// 3/4 (1 at the border), so the integer-valued input gives exact sums
void upscale_linear_2x(const uint8_t* img, int h, int w, Mat& dst) {
  auto taps = [](int d, int n, int& s0, int& s1, float& a0, float& a1) {
    const double f = (d + 0.5) * 0.5 - 0.5;
    int s = (int)std::floor(f);
    double a = f - s;
    if (s < 0) { s = 0; a = 0; }
    if (s >= n - 1) { s = n - 1; a = 0; }
    s0 = s;
    s1 = std::min(s + 1, n - 1);
    a0 = (float)(1 - a);
    a1 = (float)a;
  };
  const int dw = 2 * w, dh = 2 * h;
  std::vector<int> x0(dw), x1(dw);
  std::vector<float> wx0(dw), wx1(dw);
  for (int x = 0; x < dw; ++x) taps(x, w, x0[x], x1[x], wx0[x], wx1[x]);
  Mat horiz;
  horiz.create(h, dw);
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = img + (size_t)y * w;
    float* r = horiz.row(y);
    for (int x = 0; x < dw; ++x)
      r[x] = (float)s[x0[x]] * wx0[x] + (float)s[x1[x]] * wx1[x];
  }
  dst.create(dh, dw);
  for (int y = 0; y < dh; ++y) {
    int y0, y1;
    float b0, b1;
    taps(y, h, y0, y1, b0, b1);
    const float* r0 = horiz.row(y0);
    const float* r1 = horiz.row(y1);
    float* o = dst.row(y);
    for (int x = 0; x < dw; ++x) o[x] = r0[x] * b0 + r1[x] * b1;
  }
}

// resize(src, Size(cols / 2, rows / 2), INTER_NEAREST)
void halve_nearest(const Mat& src, Mat& dst) {
  const int dw = src.cols / 2, dh = src.rows / 2;
  const double ifx = 1. / ((double)dw / src.cols);
  const double ify = 1. / ((double)dh / src.rows);
  std::vector<int> xs(dw);
  for (int x = 0; x < dw; ++x)
    xs[x] = std::min((int)std::floor(x * ifx), src.cols - 1);
  dst.create(dh, dw);
  for (int y = 0; y < dh; ++y) {
    const float* s = src.row(std::min((int)std::floor(y * ify), src.rows - 1));
    float* o = dst.row(y);
    for (int x = 0; x < dw; ++x) o[x] = s[xs[x]];
  }
}

// ---- hal::exp32f, hal::fastAtan2 (degrees), hal::magnitude32f ----------

// expTab[i] = 2^(i/64) * EXPPOLY_32F_A0, rounded to float32
const float kExpTab[64] = {
    0x1.3ce0f4p-7f, 0x1.40544ep-7f, 0x1.43d146p-7f, 0x1.4757f6p-7f,
    0x1.4ae87cp-7f, 0x1.4e82f2p-7f, 0x1.522772p-7f, 0x1.55d61ap-7f,
    0x1.598f06p-7f, 0x1.5d5254p-7f, 0x1.61201ep-7f, 0x1.64f882p-7f,
    0x1.68db9ep-7f, 0x1.6cc992p-7f, 0x1.70c278p-7f, 0x1.74c672p-7f,
    0x1.78d59ep-7f, 0x1.7cf01ap-7f, 0x1.811606p-7f, 0x1.854782p-7f,
    0x1.8984b0p-7f, 0x1.8dcdaep-7f, 0x1.9222a0p-7f, 0x1.9683a4p-7f,
    0x1.9af0dcp-7f, 0x1.9f6a6cp-7f, 0x1.a3f076p-7f, 0x1.a8831cp-7f,
    0x1.ad2280p-7f, 0x1.b1cec8p-7f, 0x1.b68816p-7f, 0x1.bb4e90p-7f,
    0x1.c0225ap-7f, 0x1.c50398p-7f, 0x1.c9f272p-7f, 0x1.ceef0cp-7f,
    0x1.d3f98cp-7f, 0x1.d91218p-7f, 0x1.de38dcp-7f, 0x1.e36dfap-7f,
    0x1.e8b19cp-7f, 0x1.ee03ecp-7f, 0x1.f36512p-7f, 0x1.f8d536p-7f,
    0x1.fe5482p-7f, 0x1.01f192p-6f, 0x1.04c0a0p-6f, 0x1.079784p-6f,
    0x1.0a7652p-6f, 0x1.0d5d20p-6f, 0x1.104c04p-6f, 0x1.134316p-6f,
    0x1.16426cp-6f, 0x1.194a1ep-6f, 0x1.1c5a42p-6f, 0x1.1f72eep-6f,
    0x1.22943ep-6f, 0x1.25be46p-6f, 0x1.28f122p-6f, 0x1.2c2ce8p-6f,
    0x1.2f71b0p-6f, 0x1.32bf96p-6f, 0x1.3616b2p-6f, 0x1.39771ep-6f,
};

void exp32f(float* v, int n) {
  const double a0 = .9670371139572337719125840413672004409288e-2;
  const float A4 = (float)(1.000000000000002438532970795181890933776 / a0);
  const float A3 = (float)(.6931471805521448196800669615864773144641 / a0);
  const float A2 = (float)(.2402265109513301490103372422686535526573 / a0);
  const float A1 = (float)(.5550339366753125211915322047004666939128e-1 / a0);
  const double prescale = 1.4426950408889634073599246810019 * (1 << 6);
  const double postscale = 1. / (1 << 6);
  const double max_val = 3000. * (1 << 6);
  const float lo = (float)(-max_val / prescale), hi = (float)(max_val / prescale);
  for (int i = 0; i < n; ++i) {
    float x = std::min(std::max(v[i], lo), hi) * (float)prescale;
    const int xi = round_even(x);
    x = (x - (float)xi) * (float)postscale;
    int t = (xi >> 6) + 127;
    t = t < 0 ? 0 : t > 255 ? 255 : t;
    const uint32_t bits = (uint32_t)t << 23;
    float p2;
    std::memcpy(&p2, &bits, sizeof p2);
    float z = std::fmaf(x + A1, x, A2);
    z = std::fmaf(z, x, A3);
    z = std::fmaf(z, x, A4);
    v[i] = z * (kExpTab[xi & 63] * p2);
  }
}

// fastAtan2 in degrees; below two AVX2 vectors OpenCV takes its scalar
// path, whose 90 - p(c) c is one fma
void fast_atan2(const float* Y, const float* X, float* out, int n) {
  const float p1 = 0.9997878412794807f * (float)(180 / M_PI);
  const float p3 = -0.3258083974640975f * (float)(180 / M_PI);
  const float p5 = 0.1555786518463281f * (float)(180 / M_PI);
  const float p7 = -0.04432655554792128f * (float)(180 / M_PI);
  const bool scalar = n < 2 * kAvx2Lanes;
  for (int i = 0; i < n; ++i) {
    const float x = X[i], y = Y[i];
    const float ax = std::fabs(x), ay = std::fabs(y);
    const float c = std::min(ax, ay) / (std::max(ax, ay) + (float)2.220446049250313e-16);
    const float cc = c * c;
    const float p = std::fmaf(std::fmaf(std::fmaf(cc, p7, p5), cc, p3), cc, p1);
    float a;
    if (ax >= ay) a = p * c;
    else a = scalar ? std::fmaf(-p, c, 90.f) : 90.f - p * c;
    if (x < 0) a = 180.f - a;
    if (y < 0) a = 360.f - a;
    out[i] = a;
  }
}

void magnitude32f(const float* X, const float* Y, float* out, int n) {
  for (int i = 0; i < n; ++i)
    out[i] = std::sqrt(std::fmaf(X[i], X[i], Y[i] * Y[i]));
}

// ---- keypoints -------------------------------------------------------------

struct Pyramids {
  std::vector<Mat> gauss, dog;
  int octaves = 0;
  const Mat& g(int o, int i) const { return gauss[o * (kLayers + 3) + i]; }
  const Mat& d(int o, int i) const { return dog[o * (kLayers + 2) + i]; }
};

// Matx33f::solve(b, DECOMP_LU) of the symmetric Hessian: Cramer's rule in
// float32 (Matx_FastSolveOp<float, 3, 3, 1>), contracted as GCC contracts
// it. Each difference of two products fuses the first; the solve's
// differences of the Hessian alone are the determinant's m0, m1, m2.
bool solve3(const float h[9], const float b[3], float x[3]) {
  const float dxx = h[0], dxy = h[1], dxs = h[2];
  const float dyy = h[4], dys = h[5], dss = h[8];
  const float m0 = std::fmaf(dyy, dss, -(dys * dys));
  const float m1 = std::fmaf(dxy, dss, -(dxs * dys));
  const float m2 = std::fmaf(dxy, dys, -(dxs * dyy));
  float d = std::fmaf(dxs, m2, std::fmaf(dxx, m0, -(dxy * m1)));
  if (d == 0) return false;
  d = 1 / d;
  const float b0 = b[0], b1 = b[1], b2 = b[2];
  const float u1 = std::fmaf(b1, dss, -(dys * b2));
  // b1 * dys comes first in the source and both of its uses are
  // differences, so both fuse it: w0 = -u2 exactly
  const float u2 = std::fmaf(b1, dys, -(dyy * b2));
  const float w0 = std::fmaf(-b1, dys, dyy * b2);
  const float v2 = std::fmaf(dxy, b2, -(b1 * dxs));
  x[0] = d * std::fmaf(dxs, u2, std::fmaf(b0, m0, -(dxy * u1)));
  x[1] = d * std::fmaf(dxs, v2, std::fmaf(dxx, u1, -(b0 * m1)));
  x[2] = d * std::fmaf(b0, m2, std::fmaf(dxx, w0, -(dxy * v2)));
  return true;
}

bool adjust_local_extrema(const Pyramids& p, KeyPoint& kpt, int octv,
                          int& layer, int& r, int& c) {
  const float img_scale = 1.f / 255;
  const float deriv_scale = img_scale * 0.5f;
  const float second_deriv_scale = img_scale;
  const float cross_deriv_scale = img_scale * 0.25f;
  float xi = 0, xr = 0, xc = 0;
  int i = 0;
  for (; i < kInterpSteps; ++i) {
    const Mat& img = p.d(octv, layer);
    const Mat& prev = p.d(octv, layer - 1);
    const Mat& next = p.d(octv, layer + 1);
    const float dD[3] = {(img.at(r, c + 1) - img.at(r, c - 1)) * deriv_scale,
                         (img.at(r + 1, c) - img.at(r - 1, c)) * deriv_scale,
                         (next.at(r, c) - prev.at(r, c)) * deriv_scale};
    const float v2 = img.at(r, c) * 2;
    const float dxx = (img.at(r, c + 1) + img.at(r, c - 1) - v2) * second_deriv_scale;
    const float dyy = (img.at(r + 1, c) + img.at(r - 1, c) - v2) * second_deriv_scale;
    const float dss = (next.at(r, c) + prev.at(r, c) - v2) * second_deriv_scale;
    const float dxy = (img.at(r + 1, c + 1) - img.at(r + 1, c - 1) -
                       img.at(r - 1, c + 1) + img.at(r - 1, c - 1)) * cross_deriv_scale;
    const float dxs = (next.at(r, c + 1) - next.at(r, c - 1) -
                       prev.at(r, c + 1) + prev.at(r, c - 1)) * cross_deriv_scale;
    const float dys = (next.at(r + 1, c) - next.at(r - 1, c) -
                       prev.at(r + 1, c) + prev.at(r - 1, c)) * cross_deriv_scale;
    const float H[9] = {dxx, dxy, dxs, dxy, dyy, dys, dxs, dys, dss};
    float X[3];
    if (!solve3(H, dD, X)) X[0] = X[1] = X[2] = 0;
    xi = -X[2];
    xr = -X[1];
    xc = -X[0];
    if (std::fabs(xi) < 0.5f && std::fabs(xr) < 0.5f && std::fabs(xc) < 0.5f)
      break;
    const float big = (float)(INT32_MAX / 3);
    if (std::fabs(xi) > big || std::fabs(xr) > big || std::fabs(xc) > big)
      return false;
    c += round_even(xc);
    r += round_even(xr);
    layer += round_even(xi);
    if (layer < 1 || layer > kLayers || c < kBorder || c >= img.cols - kBorder ||
        r < kBorder || r >= img.rows - kBorder)
      return false;
  }
  if (i >= kInterpSteps) return false;

  const Mat& img = p.d(octv, layer);
  const Mat& prev = p.d(octv, layer - 1);
  const Mat& next = p.d(octv, layer + 1);
  const float d0 = (img.at(r, c + 1) - img.at(r, c - 1)) * deriv_scale;
  const float d1 = (img.at(r + 1, c) - img.at(r - 1, c)) * deriv_scale;
  const float d2 = (next.at(r, c) - prev.at(r, c)) * deriv_scale;
  // Matx::dot: s = 0 folds away, then each product fuses into its sum
  const float t = std::fmaf(d2, xi, std::fmaf(d0, xc, d1 * xr));
  const float contr = std::fmaf(img.at(r, c), img_scale, t * 0.5f);
  if (std::fabs(contr) * kLayers < kContrast) return false;

  const float v2 = img.at(r, c) * 2.f;
  const float dxx = (img.at(r, c + 1) + img.at(r, c - 1) - v2) * second_deriv_scale;
  const float dyy = (img.at(r + 1, c) + img.at(r - 1, c) - v2) * second_deriv_scale;
  const float dxy = (img.at(r + 1, c + 1) - img.at(r + 1, c - 1) -
                     img.at(r - 1, c + 1) + img.at(r - 1, c - 1)) * cross_deriv_scale;
  const float tr = dxx + dyy;
  const float det = std::fmaf(dxx, dyy, -(dxy * dxy));
  if (det <= 0 || tr * tr * kEdge >= (kEdge + 1) * (kEdge + 1) * det) return false;

  kpt.x = (c + xc) * (float)(1 << octv);
  kpt.y = (r + xr) * (float)(1 << octv);
  kpt.octave = octv + (layer << 8) + (round_even((xi + 0.5) * 255) << 16);
  kpt.size = (float)kSigma * std::pow(2.f, (layer + xi) / kLayers) * (float)(1 << octv) * 2;
  kpt.response = std::fabs(contr);
  kpt.class_id = -1;
  return true;
}

// calcOrientationHist: the gradient weights, angles and magnitudes of the
// disc, then the histogram; the samples of whole `lanes` vectors add
// their rounded products, the tail fuses them; bins past the last whole
// vector smooth in the scalar order
float orientation_hist(const Mat& img, int px, int py, int radius, float sigma,
                       float* hist, int lanes) {
  constexpr int n = kOriBins;
  const float expf_scale = -1.f / (2.f * sigma * sigma);
  const int cap = (radius * 2 + 1) * (radius * 2 + 1);
  std::vector<float> X(cap), Y(cap), W(cap), Ori(cap);
  float temp[n + 4];
  float* temphist = temp + 2;
  for (int i = 0; i < n; ++i) temphist[i] = 0.f;
  int k = 0;
  for (int i = -radius; i <= radius; ++i) {
    const int y = py + i;
    if (y <= 0 || y >= img.rows - 1) continue;
    for (int j = -radius; j <= radius; ++j) {
      const int x = px + j;
      if (x <= 0 || x >= img.cols - 1) continue;
      X[k] = img.at(y, x + 1) - img.at(y, x - 1);
      Y[k] = img.at(y - 1, x) - img.at(y + 1, x);
      W[k] = (float)(i * i + j * j) * expf_scale;
      ++k;
    }
  }
  const int len = k;
  exp32f(W.data(), len);
  fast_atan2(Y.data(), X.data(), Ori.data(), len);
  magnitude32f(X.data(), Y.data(), X.data(), len);
  const float* Mag = X.data();
  const int body = len - len % lanes;
  for (k = 0; k < len; ++k) {
    int bin = round_even((n / 360.f) * Ori[k]);
    if (bin >= n) bin -= n;
    if (bin < 0) bin += n;
    if (k < body) temphist[bin] += W[k] * Mag[k];
    else temphist[bin] = std::fmaf(W[k], Mag[k], temphist[bin]);
  }
  temphist[-1] = temphist[n - 1];
  temphist[-2] = temphist[n - 2];
  temphist[n] = temphist[0];
  temphist[n + 1] = temphist[1];
  const int hist_body = n - n % lanes;
  for (int i = 0; i < n; ++i) {
    const float outer = temphist[i - 2] + temphist[i + 2];
    const float inner = temphist[i - 1] + temphist[i + 1];
    if (i < hist_body)
      hist[i] = std::fmaf(outer, 1.f / 16.f,
                          std::fmaf(inner, 4.f / 16.f, temphist[i] * (6.f / 16.f)));
    else
      hist[i] = std::fmaf(temphist[i], 6.f / 16.f,
                          std::fmaf(outer, 1.f / 16.f, inner * (4.f / 16.f)));
  }
  float maxval = hist[0];
  for (int i = 1; i < n; ++i) maxval = std::max(maxval, hist[i]);
  return maxval;
}

void find_extrema(const Pyramids& p, int lanes, std::vector<KeyPoint>& out) {
  const int threshold = (int)std::floor(0.5 * (double)kContrast / kLayers * 255);
  constexpr int n = kOriBins;
  float hist[n];
  for (int o = 0; o < p.octaves; ++o) {
    for (int i = 1; i <= kLayers; ++i) {
      const Mat& img = p.d(o, i);
      const Mat& prev = p.d(o, i - 1);
      const Mat& next = p.d(o, i + 1);
      const int rows = img.rows, cols = img.cols;
      for (int r = kBorder; r < rows - kBorder; ++r) {
        const float* cur = img.row(r);
        const float* pre = prev.row(r);
        const float* nxt = next.row(r);
        const int step = cols;
        for (int c = kBorder; c < cols - kBorder; ++c) {
          const float val = cur[c];
          if (std::fabs(val) <= threshold) continue;
          bool extremum = true;
          const float* planes[3] = {cur, pre, nxt};
          for (int pl = 0; pl < 3 && extremum; ++pl) {
            const float* q = planes[pl];
            for (int dy = -1; dy <= 1 && extremum; ++dy)
              for (int dx = -1; dx <= 1; ++dx) {
                if (pl == 0 && dy == 0 && dx == 0) continue;
                const float v = q[c + dy * step + dx];
                if (val > 0 ? !(val >= v) : !(val <= v)) {
                  extremum = false;
                  break;
                }
              }
          }
          if (!extremum) continue;
          KeyPoint kpt;
          int r1 = r, c1 = c, layer = i;
          if (!adjust_local_extrema(p, kpt, o, layer, r1, c1)) continue;
          const float scl_octv = kpt.size * 0.5f / (float)(1 << o);
          const float omax = orientation_hist(
              p.g(o, layer), c1, r1, round_even(kOriRadius * scl_octv),
              kOriSigFactor * scl_octv, hist, lanes);
          const float mag_thr = omax * kOriPeakRatio;
          for (int j = 0; j < n; ++j) {
            const int l = j > 0 ? j - 1 : n - 1;
            const int r2 = j < n - 1 ? j + 1 : 0;
            if (hist[j] > hist[l] && hist[j] > hist[r2] && hist[j] >= mag_thr) {
              float bin = j + 0.5f * (hist[l] - hist[r2]) /
                                  (hist[l] - 2 * hist[j] + hist[r2]);
              bin = bin < 0 ? n + bin : bin >= n ? bin - n : bin;
              kpt.angle = std::fmaf(-(360.f / n), bin, 360.f);
              if (std::fabs(kpt.angle - 360.f) < kFltEpsilon) kpt.angle = 0.f;
              out.push_back(kpt);
            }
          }
        }
      }
    }
  }
}

bool keypoint12_less(const KeyPoint& a, const KeyPoint& b) {
  if (a.x != b.x) return a.x < b.x;
  if (a.y != b.y) return a.y < b.y;
  if (a.size != b.size) return a.size > b.size;
  if (a.angle != b.angle) return a.angle < b.angle;
  if (a.response != b.response) return a.response > b.response;
  if (a.octave != b.octave) return a.octave > b.octave;
  return a.class_id > b.class_id;
}

void remove_duplicated_sorted(std::vector<KeyPoint>& kps) {
  const int n = (int)kps.size();
  if (n < 2) return;
  std::sort(kps.begin(), kps.end(), keypoint12_less);
  int i = 0;
  for (int j = 1; j < n; ++j) {
    const KeyPoint& a = kps[i];
    const KeyPoint& b = kps[j];
    if (a.x != b.x || a.y != b.y || a.size != b.size || a.angle != b.angle)
      kps[++i] = kps[j];
  }
  kps.resize(i + 1);
}

// KeyPointsFilter::retainBest: nth_element by response, then every point
// tied with the n-th one kept (libstdc++'s introselect fixes the order)
void retain_best(std::vector<KeyPoint>& kps, int n) {
  if (n < 0 || kps.size() <= (size_t)n) return;
  if (n == 0) {
    kps.clear();
    return;
  }
  std::nth_element(kps.begin(), kps.begin() + n - 1, kps.end(),
                   [](const KeyPoint& a, const KeyPoint& b) { return a.response > b.response; });
  const float ambiguous = kps[n - 1].response;
  auto end = std::partition(kps.begin() + n, kps.end(),
                            [ambiguous](const KeyPoint& k) { return k.response >= ambiguous; });
  kps.resize(end - kps.begin());
}

// calcSIFTDescriptor into `dst` (128 float32 values)
void descriptor(const Mat& img, float ptx, float pty, float ori, float scl,
                float* dst, int lanes) {
  constexpr int d = kDescWidth, n = kDescBins;
  const int px = round_even(ptx), py = round_even(pty);
  float cos_t = std::cos(ori * (float)(M_PI / 180));
  float sin_t = std::sin(ori * (float)(M_PI / 180));
  const float bins_per_rad = n / 360.f;
  const float exp_scale = -1.f / (d * d * 0.5f);
  const float hist_width = kDescSclFactor * scl;
  int radius = round_even(hist_width * 1.4142135623730951f * (d + 1) * 0.5f);
  radius = std::min(radius, (int)std::sqrt((double)img.cols * img.cols +
                                           (double)img.rows * img.rows));
  cos_t /= hist_width;
  sin_t /= hist_width;
  const int cap = (radius * 2 + 1) * (radius * 2 + 1);
  const int histlen = (d + 2) * (d + 2) * (n + 2);
  std::vector<float> X(cap), Y(cap), Ori(cap), W(cap), RBin(cap), CBin(cap);
  std::vector<float> hist(histlen, 0.f);
  const int rows = img.rows, cols = img.cols;
  int k = 0;
  for (int i = -radius; i <= radius; ++i)
    for (int j = -radius; j <= radius; ++j) {
      const float c_rot = std::fmaf((float)j, cos_t, -((float)i * sin_t));
      const float r_rot = std::fmaf((float)j, sin_t, (float)i * cos_t);
      const float rbin = r_rot + d / 2 - 0.5f;
      const float cbin = c_rot + d / 2 - 0.5f;
      const int r = py + i, c = px + j;
      if (rbin > -1 && rbin < d && cbin > -1 && cbin < d && r > 0 &&
          r < rows - 1 && c > 0 && c < cols - 1) {
        X[k] = img.at(r, c + 1) - img.at(r, c - 1);
        Y[k] = img.at(r - 1, c) - img.at(r + 1, c);
        RBin[k] = rbin;
        CBin[k] = cbin;
        W[k] = std::fmaf(c_rot, c_rot, r_rot * r_rot) * exp_scale;
        ++k;
      }
    }
  const int len = k;
  fast_atan2(Y.data(), X.data(), Ori.data(), len);
  magnitude32f(X.data(), Y.data(), Y.data(), len);
  exp32f(W.data(), len);
  const float* Mag = Y.data();
  const int body = len - len % lanes;
  for (k = 0; k < len; ++k) {
    float rbin = RBin[k], cbin = CBin[k];
    float obin = (Ori[k] - ori) * bins_per_rad;
    const float mag = Mag[k] * W[k];
    const int r0 = floor_int(rbin), c0 = floor_int(cbin);
    int o0 = floor_int(obin);
    rbin -= r0;
    cbin -= c0;
    obin -= o0;
    if (o0 < 0) o0 += n;
    if (o0 >= n) o0 -= n;
    const float v_r1 = mag * rbin, v_r0 = mag - v_r1;
    const float v_rc11 = v_r1 * cbin, v_rc10 = v_r1 - v_rc11;
    const float v_rc01 = v_r0 * cbin, v_rc00 = v_r0 - v_rc01;
    const int idx = ((r0 + 1) * (d + 2) + c0 + 1) * (n + 2) + o0;
    float* h = hist.data() + idx;
    const int down = (d + 2) * (n + 2);
    if (k < body) {
      const float v_rco111 = v_rc11 * obin, v_rco110 = v_rc11 - v_rco111;
      const float v_rco101 = v_rc10 * obin, v_rco100 = v_rc10 - v_rco101;
      const float v_rco011 = v_rc01 * obin, v_rco010 = v_rc01 - v_rco011;
      const float v_rco001 = v_rc00 * obin, v_rco000 = v_rc00 - v_rco001;
      h[0] += v_rco000;
      h[1] += v_rco001;
      h[n + 2] += v_rco010;
      h[n + 3] += v_rco011;
      h[down] += v_rco100;
      h[down + 1] += v_rco101;
      h[down + n + 2] += v_rco110;
      h[down + n + 3] += v_rco111;
    } else {  // the scalar tail: each product fused into both its uses
      h[0] += std::fmaf(-v_rc00, obin, v_rc00);
      h[1] = std::fmaf(v_rc00, obin, h[1]);
      h[n + 2] += std::fmaf(-v_rc01, obin, v_rc01);
      h[n + 3] = std::fmaf(v_rc01, obin, h[n + 3]);
      h[down] += std::fmaf(-v_rc10, obin, v_rc10);
      h[down + 1] = std::fmaf(v_rc10, obin, h[down + 1]);
      h[down + n + 2] += std::fmaf(-v_rc11, obin, v_rc11);
      h[down + n + 3] = std::fmaf(v_rc11, obin, h[down + n + 3]);
    }
  }
  float raw[kDescLen];
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j) {
      const int idx = ((i + 1) * (d + 2) + (j + 1)) * (n + 2);
      hist[idx] += hist[idx + n];
      hist[idx + 1] += hist[idx + n + 1];
      for (k = 0; k < n; ++k) raw[(i * d + j) * n + k] = hist[idx + k];
    }
  // the squared norm: one fma accumulator a lane, then v_reduce_sum
  float acc[16] = {0};
  for (k = 0; k < kDescLen; ++k) acc[k % lanes] = std::fmaf(raw[k], raw[k], acc[k % lanes]);
  float nrm2;
  if (lanes == 16) {
    float half[8], quarter[4];
    for (int i = 0; i < 8; ++i) half[i] = acc[i] + acc[i + 8];
    for (int i = 0; i < 4; ++i) quarter[i] = half[i] + half[i + 4];
    nrm2 = (quarter[0] + quarter[1]) + (quarter[2] + quarter[3]);
  } else {
    nrm2 = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
           ((acc[4] + acc[5]) + (acc[6] + acc[7]));
  }
  const float thr = std::sqrt(nrm2) * kDescMagThr;
  nrm2 = 0;
  for (int i = 0; i < kDescLen; ++i) {
    const float val = std::min(raw[i], thr);
    raw[i] = val;
    nrm2 = std::fmaf(val, val, nrm2);
  }
  nrm2 = kIntDescFactor / std::max(std::sqrt(nrm2), kFltEpsilon);
  for (k = 0; k < kDescLen; ++k) {
    const float v = (float)round_even(raw[k] * nrm2);
    dst[k] = std::min(std::max(v, 0.f), 255.f);
  }
}

struct Result {
  std::vector<KeyPoint> kps;
  std::vector<float> desc;
};

Result* detect(const uint8_t* image, int h, int w, int nfeatures, int lanes) {
  Result* res = new Result;
  Pyramids p;
  Mat dbl;
  upscale_linear_2x(image, h, w, dbl);
  const float sig = (float)kSigma;
  const float sig_diff = std::sqrt(std::max(sig * sig - kInitSigma * kInitSigma * 4, 0.01f));
  Mat base;
  gaussian_blur(dbl, base, sig_diff);
  p.octaves = round_even(std::log((double)std::min(base.cols, base.rows)) / std::log(2.) - 2) -
              kFirstOctave;
  if (p.octaves < 1) return res;
  double sigmas[kLayers + 3];
  sigmas[0] = kSigma;
  const double k = std::pow(2., 1. / kLayers);
  for (int i = 1; i < kLayers + 3; ++i) {
    const double prev = std::pow(k, (double)(i - 1)) * kSigma;
    const double total = prev * k;
    sigmas[i] = std::sqrt(total * total - prev * prev);
  }
  p.gauss.resize(p.octaves * (kLayers + 3));
  for (int o = 0; o < p.octaves; ++o)
    for (int i = 0; i < kLayers + 3; ++i) {
      Mat& dst = p.gauss[o * (kLayers + 3) + i];
      if (o == 0 && i == 0) dst = base;
      else if (i == 0) halve_nearest(p.g(o - 1, kLayers), dst);
      else gaussian_blur(p.g(o, i - 1), dst, sigmas[i]);
    }
  p.dog.resize(p.octaves * (kLayers + 2));
  for (int o = 0; o < p.octaves; ++o)
    for (int i = 0; i < kLayers + 2; ++i) {
      const Mat& a = p.g(o, i);
      const Mat& b = p.g(o, i + 1);
      Mat& dst = p.dog[o * (kLayers + 2) + i];
      dst.create(a.rows, a.cols);
      for (size_t q = 0; q < a.px.size(); ++q) dst.px[q] = b.px[q] - a.px[q];
    }
  std::vector<KeyPoint>& kps = res->kps;
  find_extrema(p, lanes, kps);
  remove_duplicated_sorted(kps);
  if (nfeatures > 0) retain_best(kps, nfeatures);
  const float scale = 1.f / (float)(1 << -kFirstOctave);
  for (KeyPoint& kpt : kps) {
    kpt.octave = (kpt.octave & ~255) | ((kpt.octave + kFirstOctave) & 255);
    kpt.x *= scale;
    kpt.y *= scale;
    kpt.size *= scale;
  }
  res->desc.assign(kps.size() * kDescLen, 0.f);
  for (size_t q = 0; q < kps.size(); ++q) {
    const KeyPoint& kpt = kps[q];
    int octave = kpt.octave & 255;
    const int layer = (kpt.octave >> 8) & 255;
    octave = octave < 128 ? octave : (-128 | octave);
    const float s = octave >= 0 ? 1.f / (float)(1 << octave) : (float)(1 << -octave);
    const float size = kpt.size * s;
    float angle = 360.f - kpt.angle;
    if (std::fabs(angle - 360.f) < kFltEpsilon) angle = 0.f;
    descriptor(p.g(octave - kFirstOctave, layer), kpt.x * s, kpt.y * s, angle,
               size * 0.5f, res->desc.data() + q * kDescLen, lanes);
  }
  return res;
}

}  // namespace

extern "C" {

int32_t cv_sift_lanes() {
#if defined(__x86_64__) || defined(__i386__)
  __builtin_cpu_init();
  if (__builtin_cpu_supports("avx512f") && __builtin_cpu_supports("avx512cd") &&
      __builtin_cpu_supports("avx512bw") && __builtin_cpu_supports("avx512dq") &&
      __builtin_cpu_supports("avx512vl"))
    return 16;
#endif
  return kAvx2Lanes;
}

void* cv_sift_detect(const uint8_t* image, int32_t h, int32_t w,
                     int32_t nfeatures, int32_t lanes) {
  return detect(image, h, w, nfeatures, lanes);
}

int64_t cv_sift_count(void* handle) {
  return (int64_t)static_cast<Result*>(handle)->kps.size();
}

void cv_sift_fetch(void* handle, float* kp, int32_t* octave, float* desc) {
  const Result* res = static_cast<Result*>(handle);
  for (size_t i = 0; i < res->kps.size(); ++i) {
    const KeyPoint& k = res->kps[i];
    float* row = kp + i * 5;
    row[0] = k.x;
    row[1] = k.y;
    row[2] = k.size;
    row[3] = k.angle;
    row[4] = k.response;
    octave[i] = k.octave;
  }
  std::memcpy(desc, res->desc.data(), res->desc.size() * sizeof(float));
}

void cv_sift_free(void* handle) { delete static_cast<Result*>(handle); }

}  // extern "C"
