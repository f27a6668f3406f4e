// PNG's five row filters undone (PNG specification, section 9): the
// port's PNG reader (data/png.py) hands each interlace pass's rows here,
// since Average and Paeth run byte by byte along a row.
//
// C interface (ctypes): png_unfilter() reads height rows of 1 + stride
// bytes (the filter type, then the filtered bytes) and writes height x
// stride bytes; bpp is the bytes of a whole pixel (1 below 8 bits).
// Returns 0, or 1 + the row whose filter type is not 0-4.
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" int png_unfilter(const uint8_t* in, int64_t height, int64_t stride,
                            int bpp, uint8_t* out) {
  const uint8_t* prior = nullptr;  // the row above, unfiltered
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = in + y * (stride + 1);
    const int filter = src[0];
    ++src;
    uint8_t* dst = out + y * stride;
    switch (filter) {
      case 0:
        memcpy(dst, src, stride);
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < stride; ++i)
          dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t i = 0; i < stride; ++i)
          dst[i] = (uint8_t)(src[i] + (prior ? prior[i] : 0));
        break;
      case 3:  // Average
        for (int64_t i = 0; i < stride; ++i) {
          int left = i >= bpp ? dst[i - bpp] : 0, up = prior ? prior[i] : 0;
          dst[i] = (uint8_t)(src[i] + ((left + up) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0, b = prior ? prior[i] : 0;
          int c = i >= bpp && prior ? prior[i - bpp] : 0;
          int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          int pred = pa <= pb && pa <= pc ? a : (pb <= pc ? b : c);
          dst[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return (int)(1 + y);
    }
    prior = dst;
  }
  return 0;
}
