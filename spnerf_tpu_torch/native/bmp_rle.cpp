// BMP's run-length encodings (BI_RLE8, BI_RLE4) decoded as OpenCV's
// grfmt_bmp.cpp decodes them, with its FillUniColor / FillUniGray
// (imgcodecs/src/utils.cpp): a run never crosses the end of its row (the
// file is refused), an RLE8 run that ends on it moves to the next row,
// and the escapes (0 end of line, 1 end of bitmap, 2 delta) fill the
// pixels they skip with palette entry 0. In RLE4 OpenCV treats the end of
// bitmap as an end of line and drops a delta's row count, so a file
// that ends early is cut for it. The port's BMP reader
// (data/bmp.py) hands the bytes from the pixel offset to the end of the
// file here.
//
// C interface (ctypes): bmp_rle() writes height rows of width * nch bytes
// (nch 3: B, G, R from palette; nch 1: gray from gray), bottom row first
// in memory order when bottom_up (the image's last row is written first),
// and returns 0, 1 where OpenCV gives up on the file (a run past its row)
// or 2 where the bytes end first (OpenCV's stream throws).
#include <cstdint>
#include <cstring>

namespace {

struct Stream {
  const uint8_t* p;
  int64_t n, pos = 0;
  bool cut = false;
  int byte() {
    if (pos >= n) {
      cut = true;
      return 0;
    }
    return p[pos++];
  }
  int word() {
    int lo = byte();
    int hi = byte();
    return lo | (hi << 8);
  }
};

struct Image {
  uint8_t* base;
  int64_t step;  // signed: negative for bottom-up files
  int width3, nch;
};

// OpenCV's FillUniColor / FillUniGray: count bytes of one pixel value from
// data on, moving to the next row at line_end; stops at the last row.
uint8_t* fill_uni(uint8_t* data, uint8_t*& line_end, const Image& im, int& y,
                  int height, int64_t count, const uint8_t* pix) {
  do {
    uint8_t* end = data + count;
    if (end > line_end) end = line_end;
    count -= end - data;
    for (; data < end; data += im.nch) memcpy(data, pix, im.nch);
    if (data >= line_end) {
      line_end += im.step;
      data = line_end - im.width3;
      if (++y >= height) break;
    }
  } while (count > 0);
  return data;
}

}  // namespace

extern "C" int bmp_rle(const uint8_t* src, int64_t n, int bits, int width,
                       int height, int bottom_up, const uint8_t* palette,
                       const uint8_t* gray, int nch, uint8_t* out) {
  Stream s{src, n};
  Image im{out, (int64_t)width * nch, width * nch, nch};
  uint8_t* data = out;
  if (bottom_up) {
    data = out + (int64_t)(height - 1) * im.step;
    im.step = -im.step;
  }
  // pixel values: B, G, R of each palette entry, or its gray
  uint8_t pix[256][3];
  for (int i = 0; i < 256; ++i) {
    if (nch == 3) {
      pix[i][0] = palette[4 * i];
      pix[i][1] = palette[4 * i + 1];
      pix[i][2] = palette[4 * i + 2];
    } else {
      pix[i][0] = gray[i];
    }
  }
  uint8_t* line_end = data + im.width3;
  int y = 0;
  int line_end_flag = 0;
  uint8_t buf[256];
  for (;;) {
    int code = s.word();
    int len = code & 255;
    code >>= 8;
    if (s.cut) return 2;
    if (len != 0) {  // encoded mode
      if (bits == 8) {
        int prev_y = y;
        int64_t len3 = (int64_t)len * nch;
        if (data + len3 > line_end) return 1;
        data = fill_uni(data, line_end, im, y, height, len3, pix[code]);
        line_end_flag = y - prev_y;
        if (y >= height) break;
      } else {
        uint8_t* end = data + (int64_t)len * nch;
        if (end > line_end) return 1;
        int t = 0;
        const uint8_t* two[2] = {pix[code >> 4], pix[code & 15]};
        do {
          memcpy(data, two[t], nch);
          t ^= 1;
        } while ((data += nch) < end);
      }
    } else if (code > 2) {  // absolute mode
      if (data + (int64_t)code * nch > line_end) return 1;
      int sz = bits == 8 ? (code + 1) & ~1 : (((code + 1) >> 1) + 1) & ~1;
      for (int i = 0; i < sz; ++i) buf[i] = (uint8_t)s.byte();
      if (s.cut) return 2;
      for (int i = 0; i < code; ++i, data += nch) {
        int index = bits == 8 ? buf[i] : (i & 1 ? buf[i >> 1] & 15
                                                  : buf[i >> 1] >> 4);
        memcpy(data, pix[index], nch);
      }
      if (bits == 8) line_end_flag = 0;
    } else if (bits == 8) {  // escapes
      int64_t x_shift3 = line_end - data;
      int64_t y_shift = height - y;
      if (code || !line_end_flag || x_shift3 < im.width3) {
        if (code == 2) {
          x_shift3 = (int64_t)s.byte() * nch;
          y_shift = s.byte();
          if (s.cut) return 2;
        }
        if (code != 0) x_shift3 += y_shift * im.width3;
        if (y >= height) break;
        data = fill_uni(data, line_end, im, y, height, x_shift3, pix[0]);
        if (y >= height) break;
      }
      line_end_flag = 0;
      if (y >= height) break;
    } else {  // RLE4's escapes: end of bitmap ends the row alone, and a
              // delta's row count is read and dropped
      int64_t x_shift3 = line_end - data;
      if (code == 2) {
        x_shift3 = (int64_t)s.byte() * nch;
        s.byte();
        if (s.cut) return 2;
      }
      data = fill_uni(data, line_end, im, y, height, x_shift3, pix[0]);
      if (y >= height) break;
    }
  }
  return 0;
}
