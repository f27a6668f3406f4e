// Gray decoding of baseline and extended-sequential Huffman JPEG files
// (8-bit samples, 1 or 3 components), as libjpeg(-turbo) decodes them to
// JCS_GRAYSCALE: the luma component alone, its 8x8 blocks through the
// integer "islow" inverse DCT (jidctint.c), cropped to the image.
// Chroma scans are entropy-decoded and dropped. Sampling factors may be
// any at which luma is at full resolution; restart markers are followed.
// Progressive, lossless, hierarchical, arithmetic-coded, 12-bit files,
// 2 or 4 components, RGB-coded 3-component files and luma below full
// resolution are refused with a message.
//
// C interface (ctypes): jpeg_gray_header() reads the size, and
// jpeg_gray_decode() fills a height x width uint8 buffer. Both return 0,
// or -1 with the reason in err.
#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for a corrupt run past 63 (libjpeg's guard)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

struct Huffman {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t values[256];
  // 8-bit lookahead: (length << 8) | value, 0 where longer
  uint16_t look[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dc_pred = 0;
  int width_blocks = 0, height_blocks = 0;  // blocks covering its samples
};

class Decoder {
 public:
  Decoder(const uint8_t* data, int64_t n) : d_(data), n_(n) {}

  void header();
  void decode(uint8_t* out);
  int width = 0, height = 0;

 private:
  const uint8_t* d_;
  int64_t n_;
  int64_t pos_ = 0;
  uint16_t q_[4][64] = {};
  bool q_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  std::vector<Component> comps_;
  int hmax_ = 1, vmax_ = 1;
  int restart_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  bool frame_ = false;
  int64_t sos_pos_ = 0;  // first SOS segment (after the header)
  // bit reader
  uint32_t bits_ = 0;
  int nbits_ = 0;
  bool hit_marker_ = false;

  uint8_t byte() {
    if (pos_ >= n_) throw Error{"unexpected end of file"};
    return d_[pos_++];
  }
  int u16() {
    int a = byte();
    return (a << 8) | byte();
  }
  int next_marker();
  void read_dqt(int64_t end);
  void read_dht(int64_t end);
  void read_sof();
  void scan(uint8_t* out, int ow, int oh);
  void fill();
  int get_bits(int n);
  int decode_huff(const Huffman& h);
  void decode_block(Component& c, int16_t* coef);
  void restart_marker(int expected);
};

int Decoder::next_marker() {
  // skip to 0xFF, then past fill bytes
  int c = byte();
  while (c != 0xFF) c = byte();
  do {
    c = byte();
  } while (c == 0xFF);
  return c;
}

void Decoder::read_dqt(int64_t end) {
  while (pos_ < end) {
    int pq_tq = byte();
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (tq > 3 || pq > 1) throw Error{"bad quantization table"};
    for (int i = 0; i < 64; ++i)
      q_[tq][kZigzag[i]] = pq ? (uint16_t)u16() : byte();
    q_defined_[tq] = true;
  }
}

void Decoder::read_dht(int64_t end) {
  while (pos_ < end) {
    int tc_th = byte();
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) throw Error{"bad Huffman table"};
    Huffman& h = tc ? ac_[th] : dc_[th];
    int counts[17] = {0};
    int total = 0;
    for (int i = 1; i <= 16; ++i) total += counts[i] = byte();
    if (total > 256) throw Error{"bad Huffman table"};
    for (int i = 0; i < total; ++i) h.values[i] = byte();
    // canonical codes (jdhuff.c jpeg_make_d_derived_tbl)
    int code = 0, k = 0;
    memset(h.look, 0, sizeof h.look);
    for (int len = 1; len <= 16; ++len) {
      h.valoffset[len] = k - code;
      for (int i = 0; i < counts[len]; ++i, ++k, ++code) {
        if (len <= 8) {
          int shift = 8 - len;
          for (int j = 0; j < (1 << shift); ++j)
            h.look[(code << shift) | j] = (uint16_t)((len << 8) | h.values[k]);
        }
      }
      h.maxcode[len] = counts[len] ? code - 1 : -1;
      code <<= 1;
    }
    h.maxcode[17] = 0x7fffffff;
    h.defined = true;
  }
}

void Decoder::read_sof() {
  if (frame_) throw Error{"more than one frame"};
  int precision = byte();
  height = u16();
  width = u16();
  int nc = byte();
  if (precision != 8)
    throw Error{std::to_string(precision) + "-bit samples are not decoded"};
  if (nc != 1 && nc != 3)
    throw Error{std::to_string(nc) + " components are not decoded"};
  if (width <= 0 || height <= 0) throw Error{"empty image"};
  comps_.resize(nc);
  for (auto& c : comps_) {
    c.id = byte();
    int hv = byte();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.tq = byte();
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      throw Error{"bad component"};
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  if (nc == 1) comps_[0].h = comps_[0].v = hmax_ = vmax_ = 1;
  if (comps_[0].h != hmax_ || comps_[0].v != vmax_)
    throw Error{"luma below full resolution (sampling " +
                std::to_string(comps_[0].h) + "x" +
                std::to_string(comps_[0].v) + " of " + std::to_string(hmax_) +
                "x" + std::to_string(vmax_) + ") is not decoded"};
  for (auto& c : comps_) {
    int cw = (width * c.h + hmax_ - 1) / hmax_;
    int ch = (height * c.v + vmax_ - 1) / vmax_;
    c.width_blocks = (cw + 7) / 8;
    c.height_blocks = (ch + 7) / 8;
  }
  frame_ = true;
}

void Decoder::header() {
  if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) throw Error{"not a JPEG file"};
  pos_ = 2;
  for (;;) {
    int m = next_marker();
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (m == 0xD9) throw Error{"no image data"};
    int64_t start = pos_;
    int64_t len = u16();
    int64_t end = start + len;
    if (len < 2 || end > n_) throw Error{"truncated segment"};
    if (m == 0xC0 || m == 0xC1) {
      read_sof();
    } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
      throw Error{"progressive JPEG is not decoded"};
    } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
      throw Error{"lossless JPEG is not decoded"};
    } else if (m == 0xC5) {
      throw Error{"hierarchical JPEG is not decoded"};
    } else if (m == 0xC9 || m == 0xCD) {
      throw Error{"arithmetic-coded JPEG is not decoded"};
    } else if (m == 0xDB) {
      read_dqt(end);
    } else if (m == 0xC4) {
      read_dht(end);
    } else if (m == 0xCC) {
      throw Error{"arithmetic-coded JPEG is not decoded"};
    } else if (m == 0xDD) {
      restart_ = u16();
    } else if (m == 0xE0) {
      if (len >= 7 && memcmp(d_ + start + 2, "JFIF\0", 5) == 0) jfif_ = true;
    } else if (m == 0xEE) {
      if (len >= 14 && memcmp(d_ + start + 2, "Adobe", 5) == 0) {
        adobe_ = true;
        adobe_transform_ = d_[start + 13];
      }
    } else if (m == 0xDA) {
      if (!frame_) throw Error{"scan before the frame header"};
      sos_pos_ = start;
      break;
    }
    pos_ = end;
  }
  if (comps_.size() == 3) {
    // libjpeg's guess of the colour space (jdapimin.c)
    bool rgb;
    if (jfif_)
      rgb = false;
    else if (adobe_)
      rgb = adobe_transform_ == 0;
    else
      rgb = comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
    if (rgb) throw Error{"RGB-coded colour JPEG is not decoded"};
  }
}

void Decoder::fill() {
  while (nbits_ <= 24) {
    uint32_t c = 0;
    if (!hit_marker_ && pos_ < n_) {
      c = d_[pos_];
      if (c == 0xFF) {
        int64_t p = pos_ + 1;
        while (p < n_ && d_[p] == 0xFF) ++p;
        if (p < n_ && d_[p] == 0x00) {
          pos_ = p + 1;
        } else {
          hit_marker_ = true;  // a marker: zeros from here (libjpeg's way)
          c = 0;
        }
      } else {
        ++pos_;
      }
    }
    bits_ |= c << (24 - nbits_);
    nbits_ += 8;
  }
}

int Decoder::get_bits(int n) {
  if (n == 0) return 0;
  if (nbits_ < n) fill();
  int v = (int)(bits_ >> (32 - n));
  bits_ <<= n;
  nbits_ -= n;
  return v;
}

int Decoder::decode_huff(const Huffman& h) {
  if (nbits_ < 16) fill();
  int look = h.look[bits_ >> 24];
  if (look) {
    int len = look >> 8;
    bits_ <<= len;
    nbits_ -= len;
    return look & 0xFF;
  }
  int code = (int)(bits_ >> 23);  // 9 bits
  int len = 9;
  while (len <= 16 && code > h.maxcode[len]) {
    ++len;
    code = (int)(bits_ >> (32 - len));
  }
  if (len > 16) throw Error{"corrupt Huffman code"};
  bits_ <<= len;
  nbits_ -= len;
  return h.values[code + h.valoffset[len]];
}

inline int extend(int v, int t) {
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

void Decoder::decode_block(Component& c, int16_t* coef) {
  memset(coef, 0, 64 * sizeof(int16_t));
  const Huffman& dc = dc_[c.td];
  const Huffman& ac = ac_[c.ta];
  int t = decode_huff(dc);
  if (t > 15) throw Error{"corrupt DC code"};
  int diff = t ? extend(get_bits(t), t) : 0;
  c.dc_pred += diff;
  coef[0] = (int16_t)c.dc_pred;
  for (int k = 1; k < 64; ++k) {
    int rs = decode_huff(ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      coef[kZigzag[k]] = (int16_t)extend(get_bits(s), s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// jidctint.c (jpeg_idct_islow), its constants and descaling
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

inline uint8_t range_limit(int64_t x) {
  // libjpeg's post-IDCT table: x & 1023 read as a signed 10-bit value,
  // plus 128, clamped to [0, 255]
  int v = (int)(x & 1023);
  if (v >= 512) v -= 1024;
  v += 128;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int64_t ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* in = coef + col;
    const uint16_t* qt = q + col;
    int64_t z2 = (int64_t)in[16] * qt[16], z3 = (int64_t)in[48] * qt[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = (int64_t)in[0] * qt[0];
    z3 = (int64_t)in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qt[56];
    tmp1 = (int64_t)in[40] * qt[40];
    tmp2 = (int64_t)in[24] * qt[24];
    tmp3 = (int64_t)in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    ws[col + 0] = (int32_t)descale(tmp10 + tmp3, n);
    ws[col + 56] = (int32_t)descale(tmp10 - tmp3, n);
    ws[col + 8] = (int32_t)descale(tmp11 + tmp2, n);
    ws[col + 48] = (int32_t)descale(tmp11 - tmp2, n);
    ws[col + 16] = (int32_t)descale(tmp12 + tmp1, n);
    ws[col + 40] = (int32_t)descale(tmp12 - tmp1, n);
    ws[col + 24] = (int32_t)descale(tmp13 + tmp0, n);
    ws[col + 32] = (int32_t)descale(tmp13 - tmp0, n);
  }
  for (int row = 0; row < 8; ++row) {
    const int64_t* w = ws + row * 8;
    uint8_t* o = out + row * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    o[0] = range_limit(descale(tmp10 + tmp3, n));
    o[7] = range_limit(descale(tmp10 - tmp3, n));
    o[1] = range_limit(descale(tmp11 + tmp2, n));
    o[6] = range_limit(descale(tmp11 - tmp2, n));
    o[2] = range_limit(descale(tmp12 + tmp1, n));
    o[5] = range_limit(descale(tmp12 - tmp1, n));
    o[3] = range_limit(descale(tmp13 + tmp0, n));
    o[4] = range_limit(descale(tmp13 - tmp0, n));
  }
}

void Decoder::restart_marker(int expected) {
  // drop the bits left in the buffer, then expect RST<expected>
  bits_ = 0;
  nbits_ = 0;
  hit_marker_ = false;
  while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;  // stray bytes
  while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
  if (pos_ >= n_ || d_[pos_] != 0xD0 + expected)
    throw Error{"missing restart marker"};
  ++pos_;
  for (auto& c : comps_) c.dc_pred = 0;
}

void Decoder::scan(uint8_t* plane, int pw, int ph) {
  int ns = byte();
  if (ns < 1 || ns > (int)comps_.size()) throw Error{"bad scan header"};
  std::vector<Component*> sc;
  for (int i = 0; i < ns; ++i) {
    int id = byte(), t = byte();
    Component* c = nullptr;
    for (auto& cc : comps_)
      if (cc.id == id) c = &cc;
    if (!c) throw Error{"scan names an unknown component"};
    c->td = t >> 4;
    c->ta = t & 15;
    if (c->td > 3 || c->ta > 3 || !dc_[c->td].defined || !ac_[c->ta].defined)
      throw Error{"scan uses an undefined Huffman table"};
    sc.push_back(c);
  }
  int ss = byte(), se = byte(), ahal = byte();
  if (ss != 0 || se != 63 || ahal != 0)
    throw Error{"not a sequential scan (progressive JPEG is not decoded)"};
  for (auto* c : sc) c->dc_pred = 0;
  bits_ = 0;
  nbits_ = 0;
  hit_marker_ = false;
  Component* luma = &comps_[0];
  if (!q_defined_[luma->tq]) throw Error{"undefined quantization table"};
  const uint16_t* q = q_[luma->tq];
  int16_t coef[64];
  int mcu_x, mcu_y;
  if (ns == 1) {
    mcu_x = sc[0]->width_blocks;
    mcu_y = sc[0]->height_blocks;
  } else {
    mcu_x = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcu_y = (height + 8 * vmax_ - 1) / (8 * vmax_);
  }
  int64_t total = (int64_t)mcu_x * mcu_y;
  int rst = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (restart_ && m > 0 && m % restart_ == 0) {
      restart_marker(rst);
      rst = (rst + 1) & 7;
    }
    int mx = (int)(m % mcu_x), my = (int)(m / mcu_x);
    for (auto* c : sc) {
      int bh = ns == 1 ? 1 : c->h, bv = ns == 1 ? 1 : c->v;
      for (int by = 0; by < bv; ++by) {
        for (int bx = 0; bx < bh; ++bx) {
          decode_block(*c, coef);
          if (c != luma) continue;
          int x0 = (mx * bh + bx) * 8, y0 = (my * bv + by) * 8;
          if (x0 >= pw || y0 >= ph) continue;  // padding block
          idct_islow(coef, q, plane + (int64_t)y0 * pw + x0, pw);
        }
      }
    }
  }
  // past the scan's data: to the next marker
  bits_ = 0;
  nbits_ = 0;
  hit_marker_ = false;
}

void Decoder::decode(uint8_t* out) {
  Component& luma = comps_[0];
  int pw = luma.width_blocks * 8, ph = luma.height_blocks * 8;
  if (comps_.size() > 1) {  // interleaved MCUs may reach past the blocks
    pw = ((width + 8 * hmax_ - 1) / (8 * hmax_)) * 8 * hmax_;
    ph = ((height + 8 * vmax_ - 1) / (8 * vmax_)) * 8 * vmax_;
  }
  std::vector<uint8_t> plane((size_t)pw * ph, 0);
  pos_ = sos_pos_;
  bool luma_done = false;
  for (;;) {
    int64_t start = pos_;
    int64_t len = u16();
    int64_t end = start + len;
    if (len < 2 || end > n_) throw Error{"truncated segment"};
    if (d_[start - 1] == 0xDA) {
      scan(plane.data(), pw, ph);
      luma_done = true;
      // find the next marker after the entropy-coded data
      while (pos_ < n_) {
        if (d_[pos_] == 0xFF && pos_ + 1 < n_ && d_[pos_ + 1] != 0 &&
            !(d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7) &&
            d_[pos_ + 1] != 0xFF)
          break;
        ++pos_;
      }
    } else if (d_[start - 1] == 0xC4) {
      read_dht(end);
      pos_ = end;
    } else if (d_[start - 1] == 0xDB) {
      read_dqt(end);
      pos_ = end;
    } else if (d_[start - 1] == 0xDD) {
      restart_ = u16();
      pos_ = end;
    } else {
      pos_ = end;
    }
    if (pos_ >= n_) break;
    int m = next_marker();
    if (m == 0xD9) break;
    if (m == 0xDA || m == 0xC4 || m == 0xDB || m == 0xDD ||
        (m >= 0xE0 && m <= 0xEF) || m == 0xFE)
      continue;
    throw Error{"unexpected marker after a scan"};
  }
  if (!luma_done) throw Error{"no scan"};
  for (int y = 0; y < height; ++y)
    memcpy(out + (int64_t)y * width, plane.data() + (int64_t)y * pw, width);
}

int fail(const Error& e, char* err, int errlen) {
  snprintf(err, errlen, "%s", e.msg.c_str());
  return -1;
}

}  // namespace

extern "C" int jpeg_gray_header(const uint8_t* data, int64_t n, int32_t* h,
                                int32_t* w, char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.header();
    *h = dec.height;
    *w = dec.width;
    return 0;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

extern "C" int jpeg_gray_decode(const uint8_t* data, int64_t n, uint8_t* out,
                                char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.header();
    dec.decode(out);
    return 0;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}
