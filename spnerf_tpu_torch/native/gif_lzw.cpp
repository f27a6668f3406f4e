// GIF's LZW image data decoded as OpenCV 5.0's grfmt_gif.cpp (lzwDecode)
// decodes it, its control flow included: codes of min_size + 1 bits
// growing to 12, least significant bit first, read a byte at a time from
// the data sub-blocks. The clear and end-of-information codes both
// rebuild the table and reset the width; after the end code OpenCV reads
// the next sub-block's length at once where the current one is used up,
// and stops there if it is the terminator. A table entry is made for
// every code after the first, until 4,095; a code past the next free
// entry fails, and so does a string that would run past the frame
// (OpenCV's CV_Assert); a code for a single pixel keeps its low byte
// (min_size 9-11). A code that comes when the frame is already full ends
// the decoding: it succeeds only if this is the last byte of its
// sub-block and the next length read is the terminator. Where the
// sub-blocks end first, it succeeds if the frame is full. The port's GIF
// reader (data/gif.py) hands the bytes from the first sub-block's length
// on here.
//
// C interface (ctypes): gif_lzw() writes npix indices to out and returns
// 1, or 0 where OpenCV's lzwDecode fails (cv2.imread returns None), or -1
// where the bytes end first.
#include <cstdint>
#include <vector>

namespace {

struct Reader {
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
};

}  // namespace

extern "C" int gif_lzw(const uint8_t* src, int64_t n, int min_size,
                       uint8_t* out, int64_t npix) {
  const int clear = 1 << min_size, exit_code = clear + 1;
  // entry k's string is string(parent[k]) + suffix[k]; head[k] is its
  // first index and length[k] its length. Entry `table` is OpenCV's
  // pending one: its suffix comes with the next code.
  std::vector<int> parent(4097), length(4097);
  std::vector<uint8_t> suffix(4097), head(4097), buf(4097);
  auto first_of = [&](int code) { return code < clear ? code : head[code]; };
  auto length_of = [&](int code) { return code < clear ? 1 : length[code]; };
  Reader r{src, n};
  int64_t idx = 0;
  int block = r.byte();
  if (r.cut) return -1;
  if (block == 0) return idx == npix;
  int size = min_size + 1, table = exit_code;
  uint32_t bits = 0;
  int left = 0;
  for (;;) {
    while (left < size) {  // read bytes until a code's worth is there
      if (block == 0) {
        block = r.byte();
        if (r.cut) return -1;
        if (block == 0) return idx == npix;
      }
      bits |= (uint32_t)r.byte() << left;
      if (r.cut) return -1;
      left += 8;
      --block;
    }
    const int limit = 1 << size;
    const int code = bits & (limit - 1);
    bits >>= size;
    left -= size;
    if (code == clear || code == exit_code) {
      table = exit_code;
      size = min_size + 1;
      if (code == exit_code && block == 0) {
        block = r.byte();
        if (r.cut) return -1;
        if (block == 0) return idx == npix;
      }
      continue;
    }
    if (idx >= npix) {
      if (idx != npix || block != 0) return 0;
      const int next = r.byte();
      if (r.cut) return -1;
      return next == 0;
    }
    if (table <= 0xfff) {
      if (code >= clear && code > table) return 0;
      suffix[table] = (uint8_t)first_of(code);
      ++table;
      parent[table] = code;
      head[table] = (uint8_t)first_of(code);
      length[table] = length_of(code) + 1;
    }
    const int len = length_of(code);
    if (code >= clear && idx + len > npix) return 0;  // OpenCV asserts
    int c = code;
    for (int i = len - 1; i >= 0; --i, c = parent[c])
      buf[i] = c < clear ? (uint8_t)c : suffix[c];
    for (int i = 0; i < len; ++i) out[idx++] = buf[i];
    if (table == limit && size <= 11) ++size;
  }
}
