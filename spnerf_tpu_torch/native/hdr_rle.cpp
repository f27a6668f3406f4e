// Radiance HDR pixels read as OpenCV's rgbe.cpp reads them
// (RGBE_ReadPixels_RLE, Greg Ward's reader): scanlines of width 8 to
// 32,767 may be run-length encoded, each starting 2, 2, width (high byte
// under 0x80); the first scanline that does not start so, and every pixel
// after it, is read flat (4 bytes a pixel), which is how old-style runs
// (1, 1, 1, n) come out: as pixels. Within an encoded scanline each of
// the four planes is a sequence of runs (count above 128: count - 128
// copies of the next byte) and literals (count 1-128 bytes); a count of 0
// or one past the plane's end is a format error. The port's HDR reader
// (data/hdr.py) hands the bytes after the header here, then the R, G, B,
// E quadruples for their 8-bit colour.
//
// C interface (ctypes): hdr_rgbe() writes width * height quadruples and
// returns 0, 1 for a format error (OpenCV: "wrong scanline width", "bad
// scanline data") or 2 where the bytes end first ("RGBE read error").
// hdr_bgr8() turns n quadruples into 8-bit B, G, R as OpenCV does: the
// float mantissa * 2^(E - 136) (0 where E is 0), then convertTo's x255 in
// float and cvRound (half to even), 0 outside int32 (x86's conversion
// gives INT_MIN there), clamped to 0-255.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Stream {
  const uint8_t* p;
  int64_t n, pos = 0;
  // fread of count bytes: false (nothing taken) where fewer are left
  bool read(uint8_t* dst, int64_t count) {
    if (n - pos < count) return false;
    memcpy(dst, p + pos, count);
    pos += count;
    return true;
  }
};

int flat(Stream& s, uint8_t* out, int64_t pixels) {
  for (int64_t i = 0; i < pixels; ++i)
    if (!s.read(out + 4 * i, 4)) return 2;
  return 0;
}

}  // namespace

extern "C" int hdr_rgbe(const uint8_t* src, int64_t n, int width, int height,
                        uint8_t* out) {
  Stream s{src, n};
  if (width < 8 || width > 0x7fff)
    return flat(s, out, (int64_t)width * height);
  std::vector<uint8_t> line(4 * (size_t)width);
  for (int64_t left = height; left > 0; --left) {
    uint8_t rgbe[4];
    if (!s.read(rgbe, 4)) return 2;
    if (rgbe[0] != 2 || rgbe[1] != 2 || (rgbe[2] & 0x80)) {
      memcpy(out, rgbe, 4);
      return flat(s, out + 4, (int64_t)width * left - 1);
    }
    if (((rgbe[2] << 8) | rgbe[3]) != width) return 1;
    uint8_t* ptr = line.data();
    for (int i = 0; i < 4; ++i) {
      uint8_t* ptr_end = line.data() + (size_t)(i + 1) * width;
      while (ptr < ptr_end) {
        uint8_t buf[2];
        if (!s.read(buf, 2)) return 2;
        if (buf[0] > 128) {
          int count = buf[0] - 128;
          if (count > ptr_end - ptr) return 1;
          memset(ptr, buf[1], count);
          ptr += count;
        } else {
          int count = buf[0];
          if (count == 0 || count > ptr_end - ptr) return 1;
          *ptr++ = buf[1];
          if (--count > 0) {
            if (!s.read(ptr, count)) return 2;
            ptr += count;
          }
        }
      }
    }
    for (int x = 0; x < width; ++x)
      for (int k = 0; k < 4; ++k) out[4 * x + k] = line[(size_t)k * width + x];
    out += 4 * (size_t)width;
  }
  return 0;
}

extern "C" void hdr_bgr8(const uint8_t* rgbe, int64_t n, uint8_t* bgr) {
  float scale[256];
  scale[0] = 0.0f;
  for (int e = 1; e < 256; ++e) scale[e] = (float)ldexp(1.0, e - 136);
  for (int64_t i = 0; i < n; ++i, rgbe += 4, bgr += 3) {
    const float f = scale[rgbe[3]];
    for (int k = 0; k < 3; ++k) {
      const float v = (float)rgbe[2 - k] * f * 255.0f;
      const float r = nearbyintf(v);
      int out = 0;
      if (r >= -2147483648.0f && r < 2147483648.0f)
        out = r < 0.0f ? 0 : (r > 255.0f ? 255 : (int)r);
      bgr[k] = (uint8_t)out;
    }
  }
}
