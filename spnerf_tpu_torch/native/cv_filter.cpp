// Passes of OpenCV's box and Gaussian filters, each border read by
// repeated BORDER_REFLECT_101 (the rounding of the 8-bit ones is done by
// the caller, data/cv_filter.py):
//   box_sums_u8:  the exact sum of every k x k window anchored at k / 2;
//   gaussian_u8:  sum_j t_j sum_i t_i p, then (s + 2^15) >> 16, for the
//                 k fixed-point taps t (sum 256) of a separable kernel;
//   gaussian_f32: sum_j t_j sum_i t_i p in float64, tap by tap in order,
//                 rounded to float32 once, for k float64 taps t.
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

inline int64_t reflect101(int64_t i, int64_t n) {
  if (n == 1) return 0;
  const int64_t period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

std::vector<int64_t> indices(int64_t n, int64_t before, int64_t total) {
  std::vector<int64_t> idx(total);
  for (int64_t i = 0; i < total; ++i) idx[i] = reflect101(i - before, n);
  return idx;
}

}  // namespace

extern "C" void box_sums_u8(const uint8_t* src, int64_t h, int64_t w,
                            int64_t k, int64_t* out) {
  const int64_t a = k / 2;
  std::vector<int64_t> xs = indices(w, a, w + k - 1);
  std::vector<int64_t> ys = indices(h, a, h + k - 1);
  // horizontal window sums of every source row
  std::vector<int64_t> rows((size_t)h * w);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* s = src + y * w;
    int64_t* r = rows.data() + y * w;
    int64_t acc = 0;
    for (int64_t i = 0; i < k; ++i) acc += s[xs[i]];
    r[0] = acc;
    for (int64_t x = 1; x < w; ++x) {
      acc += s[xs[x + k - 1]] - s[xs[x - 1]];
      r[x] = acc;
    }
  }
  // vertical window sums of those, column by column in row order
  std::vector<int64_t> acc(w, 0);
  for (int64_t i = 0; i < k; ++i) {
    const int64_t* r = rows.data() + ys[i] * w;
    for (int64_t x = 0; x < w; ++x) acc[x] += r[x];
  }
  for (int64_t x = 0; x < w; ++x) out[x] = acc[x];
  for (int64_t y = 1; y < h; ++y) {
    const int64_t* add = rows.data() + ys[y + k - 1] * w;
    const int64_t* sub = rows.data() + ys[y - 1] * w;
    int64_t* o = out + y * w;
    for (int64_t x = 0; x < w; ++x) {
      acc[x] += add[x] - sub[x];
      o[x] = acc[x];
    }
  }
}

extern "C" void gaussian_u8(const uint8_t* src, int64_t h, int64_t w,
                            const int32_t* taps, int64_t k, uint8_t* dst) {
  const int64_t a = k / 2;
  std::vector<int64_t> xs = indices(w, a, w + k - 1);
  std::vector<int64_t> ys = indices(h, a, h + k - 1);
  std::vector<int32_t> rows((size_t)h * w);
  std::vector<int32_t> line(w + k - 1);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* s = src + y * w;
    for (int64_t i = 0; i < w + k - 1; ++i) line[i] = s[xs[i]];
    int32_t* r = rows.data() + y * w;
    for (int64_t x = 0; x < w; ++x) r[x] = 0;
    for (int64_t i = 0; i < k; ++i) {
      if (!taps[i]) continue;
      const int32_t* l = line.data() + i;
      const int32_t t = taps[i];
      for (int64_t x = 0; x < w; ++x) r[x] += l[x] * t;
    }
  }
  std::vector<int32_t> acc(w);
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) acc[x] = 1 << 15;
    for (int64_t i = 0; i < k; ++i) {
      if (!taps[i]) continue;
      const int32_t* r = rows.data() + ys[y + i] * w;
      const int32_t t = taps[i];
      for (int64_t x = 0; x < w; ++x) acc[x] += r[x] * t;
    }
    uint8_t* o = dst + y * w;
    for (int64_t x = 0; x < w; ++x) {
      int32_t v = acc[x] >> 16;
      o[x] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
}

extern "C" void gaussian_f32(const float* src, int64_t h, int64_t w,
                             const double* taps, int64_t k, float* dst) {
  const int64_t a = k / 2;
  std::vector<int64_t> xs = indices(w, a, w + k - 1);
  std::vector<int64_t> ys = indices(h, a, h + k - 1);
  std::vector<double> rows((size_t)h * w, 0.0);
  std::vector<double> line(w + k - 1);
  for (int64_t y = 0; y < h; ++y) {
    const float* s = src + y * w;
    for (int64_t i = 0; i < w + k - 1; ++i) line[i] = s[xs[i]];
    double* r = rows.data() + y * w;
    for (int64_t i = 0; i < k; ++i) {
      const double* l = line.data() + i;
      const double t = taps[i];
      for (int64_t x = 0; x < w; ++x) r[x] += l[x] * t;
    }
  }
  std::vector<double> acc(w);
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) acc[x] = 0.0;
    for (int64_t i = 0; i < k; ++i) {
      const double* r = rows.data() + ys[y + i] * w;
      const double t = taps[i];
      for (int64_t x = 0; x < w; ++x) acc[x] += r[x] * t;
    }
    float* o = dst + y * w;
    for (int64_t x = 0; x < w; ++x) o[x] = (float)acc[x];
  }
}
