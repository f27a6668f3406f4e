// cv2.warpPerspective(src, M, (w, h), flags=INTER_LINEAR) of an 8-bit
// single-channel image with a constant-0 border, as OpenCV 4.11+ / 5.x
// computes it on x86 (warp_kernels.simd.hpp, the AVX2 dispatch): the
// inverse map in float32, each row's constants y * M[1] + M[2] (and for
// 4, 5, 7, 8) rounded before use. Columns in whole groups of 16 from the
// left take the vector body: the source x, y and w by fused
// multiply-adds, x and y divided by w, then the bilinear blend by fused
// multiply-adds; the columns past the last whole group take the scalar
// tail, whose w is fma(x, M[6], y * M[7]) + M[8] (x, y alike) as the
// compiler contracts it. A tap outside the image reads the border value;
// the result is rounded half to even and saturated.
//
// C interface (ctypes): cv_warp_perspective_u8(src, sh, sw, dst, dh, dw,
// minv) with minv the float64 inverse map (row-major 3 x 3).
#include <cmath>
#include <cstdint>

namespace {

constexpr int kGroup = 16;  // two AVX2 float vectors a step

// a product rounded to float before any sum: kept from being fused into
// a multiply-add on targets where the compiler would contract it
inline float product(float a, float b) {
  volatile float p = a * b;
  return p;
}

inline float tap(const uint8_t* src, int sh, int sw, int64_t y, int64_t x) {
  return (y >= 0 && y < sh && x >= 0 && x < sw) ? (float)src[y * sw + x]
                                                 : 0.f;
}

inline uint8_t blend(const uint8_t* src, int sh, int sw, float sx, float sy) {
  // v_floor of a value out of int range (or NaN) gives INT_MIN: every tap
  // then lies outside and the pixel is the border value
  if (!(std::fabs(sx) < 2147483520.f) || !(std::fabs(sy) < 2147483520.f))
    return 0;
  int64_t ix = (int64_t)std::floor(sx), iy = (int64_t)std::floor(sy);
  float ax = sx - (float)ix, ay = sy - (float)iy;
  float p00 = tap(src, sh, sw, iy, ix), p01 = tap(src, sh, sw, iy, ix + 1);
  float p10 = tap(src, sh, sw, iy + 1, ix);
  float p11 = tap(src, sh, sw, iy + 1, ix + 1);
  float v0 = std::fmaf(ax, p01 - p00, p00);
  float v1 = std::fmaf(ax, p11 - p10, p10);
  float v = std::fmaf(ay, v1 - v0, v0);
  float r = std::nearbyint(v);  // round half to even
  return (uint8_t)(r < 0.f ? 0.f : r > 255.f ? 255.f : r);
}

}  // namespace

extern "C" void cv_warp_perspective_u8(const uint8_t* src, int32_t sh,
                                       int32_t sw, uint8_t* dst, int32_t dh,
                                       int32_t dw, const double* minv) {
  float m[9];
  for (int i = 0; i < 9; ++i) m[i] = (float)minv[i];
  const int body = dw - dw % kGroup;
  for (int y = 0; y < dh; ++y) {
    const float fy = (float)y;
    const float row_x = product(fy, m[1]), row_y = product(fy, m[4]);
    const float row_w = product(fy, m[7]);
    const float mx = row_x + m[2], my = row_y + m[5], mw = row_w + m[8];
    uint8_t* out = dst + (int64_t)y * dw;
    for (int x = 0; x < body; ++x) {
      const float fx = (float)x;
      const float w = std::fmaf(m[6], fx, mw);
      out[x] = blend(src, sh, sw, std::fmaf(m[0], fx, mx) / w,
                     std::fmaf(m[3], fx, my) / w);
    }
    for (int x = body; x < dw; ++x) {
      const float fx = (float)x;
      const float w = std::fmaf(fx, m[6], row_w) + m[8];
      out[x] = blend(src, sh, sw, (std::fmaf(fx, m[0], row_x) + m[2]) / w,
                     (std::fmaf(fx, m[3], row_y) + m[5]) / w);
    }
  }
}
