// JPEG decoding as cv2.imread asks libjpeg-turbo for it, gray
// (JCS_GRAYSCALE) or colour (BGR), byte for byte at full DCT scale.
//
// Huffman-coded files of 8-bit samples: baseline, extended sequential and
// progressive (SOF0, SOF1, SOF2), 1, 3 or 4 components at any integral
// sampling, restart markers. Every scan's coefficients are held for the
// whole image; each block then goes through the integer "islow" inverse
// DCT (jidctint.c), each component is upsampled as jdsample.c does with
// do_fancy_upsampling on (h2v1, h1v2 and h2v2 triangle filters, plain
// replication otherwise or where a component is 2 samples wide or less),
// and the colour conversions are jdcolor.c's: YCbCr to RGB in 16-bit
// fixed point, YCCK to CMYK, gray replicated. A gray read of YCbCr keeps
// the luma plane alone. 4-component files come out as libjpeg's CMYK,
// which cv2 turns to BGR or gray with its own integer formulas.
//
// A file cut inside its entropy-coded data decodes as libjpeg decodes
// it: zero bits for the rest of the MCU the data ran out in, then every
// later MCU of the scan left as it stood (zero coefficients: gray 128 in
// a sequential file); the caller is told, to warn as libjpeg warns.
// Refused with a message: arithmetic coding, 12-bit samples, lossless and
// hierarchical files, 2 components, RGB-coded 3-component files,
// fractional sampling ratios, a restart marker that is missing where data
// follows (libjpeg resyncs), and progressive files whose coefficients
// 1-9 are not all sent to their last bit (libjpeg would smooth the
// blocks, jdcoefct.c's decompress_smooth_data).
//
// C interface (ctypes): jpeg_header() reads the size, jpeg_decode() fills a height x width x channels uint8
// buffer (channels 1: gray; 3: B, G, R). Both return 0, or -1 with the
// reason in err; jpeg_decode sets *cut to 1 where the file ended before
// its end-of-image marker.
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

enum class Space { kGray, kYCbCr, kCMYK, kYCCK };

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dc_pred = 0;
  int dw = 0, dh = 0;  // samples (jdinput.c's downsampled_width / height)
  int bw = 0, bh = 0;  // blocks covering them
  int stride = 0;      // blocks a row in coef (MCU-padded)
  std::vector<int16_t> coef;  // natural order, 64 a block
  bool latched = false;       // quantization table copied at its 1st scan
  uint16_t q[64];
  int coef_bits[64];  // progressive: the Al of the last scan, -1 unsent
  int16_t* block(int bx, int by) {
    return coef.data() + ((int64_t)by * stride + bx) * 64;
  }
};

class Decoder {
 public:
  Decoder(const uint8_t* data, int64_t n) : d_(data), n_(n) {}

  void header();
  void decode(uint8_t* out, int channels);
  int width = 0, height = 0;
  bool cut = false;  // the file ended before EOI

 private:
  const uint8_t* d_;
  int64_t n_;
  int64_t pos_ = 0;
  uint16_t q_[4][64] = {};
  bool q_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  std::vector<Component> comps_;
  int hmax_ = 1, vmax_ = 1;
  int mcux_ = 0, mcuy_ = 0;  // MCUs of an interleaved scan
  int restart_ = 0;
  bool progressive_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  Space space_ = Space::kGray;
  bool frame_ = false;
  int64_t sos_pos_ = 0;  // first SOS segment (after the header)
  // the scan in progress
  std::vector<Component*> sc_;
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  int eobrun_ = 0;
  // bit reader: MSB-aligned buffer, of which real_ bits came from the
  // file; past a marker (or the end of the file) zeros are fed, and
  // consuming any of them marks the rest of the scan's data as missing
  // (libjpeg's insufficient_data)
  uint64_t bits_ = 0;
  int nbits_ = 0, real_ = 0;
  bool hit_marker_ = false;
  bool insufficient_ = false;

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
  void read_sof(bool progressive);
  void allocate();
  void scan();
  void skip_entropy_data();
  void fill();
  void consume(int n) {
    bits_ <<= n;
    nbits_ -= n;
    if (n > real_) {
      insufficient_ = true;
      real_ = 0;
    } else {
      real_ -= n;
    }
  }
  int get_bits(int n);
  int decode_huff(const Huffman& h);
  void restart(int expected);
  void decode_sequential(Component& c, int16_t* coef);
  void dc_first(Component& c, int16_t* coef);
  void dc_refine(int16_t* coef);
  void ac_first(Component& c, int16_t* coef);
  void ac_refine(Component& c, int16_t* coef);
  void decode_mcu(int64_t m);
  bool would_smooth() const;
  void plane(Component& c, std::vector<uint8_t>& full);
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
        if (code >= (1 << len)) throw Error{"bad Huffman table"};
        if (len <= 8) {
          int shift = 8 - len;
          for (int j = 0; j < (1 << shift); ++j)
            h.look[(code << shift) | j] = (uint16_t)((len << 8) | h.values[k]);
        }
      }
      h.maxcode[len] = counts[len] ? code - 1 : -1;
      // no all-ones code (jpeg_make_d_derived_tbl's check)
      if (code >= (1 << len)) throw Error{"bad Huffman table"};
      code <<= 1;
    }
    h.maxcode[17] = 0x7fffffff;
    h.defined = true;
  }
}

void Decoder::read_sof(bool progressive) {
  if (frame_) throw Error{"more than one frame"};
  progressive_ = progressive;
  int precision = byte();
  height = u16();
  width = u16();
  int nc = byte();
  if (precision != 8)
    throw Error{std::to_string(precision) + "-bit samples are not decoded"};
  if (nc != 1 && nc != 3 && nc != 4)
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
  // one component: its MCU is one block whatever its factors say
  if (nc == 1) comps_[0].h = comps_[0].v = hmax_ = vmax_ = 1;
  for (auto& c : comps_) {
    c.dw = (int)(((int64_t)width * c.h + hmax_ - 1) / hmax_);
    c.dh = (int)(((int64_t)height * c.v + vmax_ - 1) / vmax_);
    c.bw = (c.dw + 7) / 8;
    c.bh = (c.dh + 7) / 8;
  }
  mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
  mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
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
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      read_sof(m == 0xC2);
    } else if (m == 0xC6) {
      throw Error{"progressive hierarchical JPEG is not decoded"};
    } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
      throw Error{"lossless JPEG is not decoded"};
    } else if (m == 0xC5) {
      throw Error{"hierarchical JPEG is not decoded"};
    } else if (m == 0xC9 || m == 0xCA || m == 0xCD || m == 0xCE ||
               m == 0xCC) {
      throw Error{"arithmetic-coded JPEG is not decoded"};
    } else if (m == 0xDB) {
      read_dqt(end);
    } else if (m == 0xC4) {
      read_dht(end);
    } else if (m == 0xDD) {
      restart_ = u16();
    } else if (m == 0xE0) {
      // jdmarker.c examine_app0: 14 bytes of data, "JFIF\0"
      if (len >= 16 && memcmp(d_ + start + 2, "JFIF\0", 5) == 0) jfif_ = true;
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
  // libjpeg's guess of the colour space (jdapimin.c default_decompress_parms)
  if (comps_.size() == 1) {
    space_ = Space::kGray;
  } else if (comps_.size() == 3) {
    bool rgb;
    if (jfif_)
      rgb = false;
    else if (adobe_)
      rgb = adobe_transform_ == 0;
    else
      rgb = comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
    if (rgb) throw Error{"RGB-coded colour JPEG is not decoded"};
    space_ = Space::kYCbCr;
  } else {
    space_ = adobe_ && adobe_transform_ != 0 ? Space::kYCCK : Space::kCMYK;
  }
}

void Decoder::allocate() {
  for (auto& c : comps_) {
    // interleaved scans reach mcux_ * h blocks across, one-component
    // scans bw: hold the larger
    c.stride = std::max(c.bw, mcux_ * c.h);
    int rows = std::max(c.bh, mcuy_ * c.v);
    c.coef.assign((size_t)c.stride * rows * 64, 0);
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
  }
}

void Decoder::fill() {
  while (nbits_ <= 56) {
    uint64_t c = 0;
    bool real = false;
    if (!hit_marker_) {
      if (pos_ >= n_) {
        hit_marker_ = true;  // the file ends: libjpeg's source adds an EOI
        cut = true;
      } else if (d_[pos_] == 0xFF) {
        int64_t p = pos_ + 1;
        while (p < n_ && d_[p] == 0xFF) ++p;
        if (p < n_ && d_[p] == 0x00) {
          c = 0xFF;
          real = true;
          pos_ = p + 1;
        } else {
          hit_marker_ = true;  // a marker: zeros from here
          if (p >= n_) cut = true;
        }
      } else {
        c = d_[pos_++];
        real = true;
      }
    }
    bits_ |= c << (56 - nbits_);
    nbits_ += 8;
    if (real) real_ += 8;
  }
}

int Decoder::get_bits(int n) {
  if (n == 0) return 0;
  if (nbits_ < n) fill();
  int v = (int)(bits_ >> (64 - n));
  consume(n);
  return v;
}

int Decoder::decode_huff(const Huffman& h) {
  if (nbits_ < 16) fill();
  int look = h.look[bits_ >> 56];
  if (look) {
    consume(look >> 8);
    return look & 0xFF;
  }
  int code = (int)(bits_ >> 55);  // 9 bits
  int len = 9;
  while (len <= 16 && code > h.maxcode[len]) {
    ++len;
    code = (int)(bits_ >> (64 - len));
  }
  if (len > 16) throw Error{"corrupt Huffman code"};
  consume(len);
  return h.values[code + h.valoffset[len]];
}

inline int extend(int v, int t) {
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

// jdhuff.c decode_mcu: one block of a sequential scan
void Decoder::decode_sequential(Component& c, int16_t* coef) {
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

// jdphuff.c decode_mcu_DC_first, decode_mcu_DC_refine, decode_mcu_AC_first,
// decode_mcu_AC_refine: one block each
void Decoder::dc_first(Component& c, int16_t* coef) {
  int t = decode_huff(dc_[c.td]);
  if (t > 15) throw Error{"corrupt DC code"};
  int diff = t ? extend(get_bits(t), t) : 0;
  c.dc_pred += diff;
  coef[0] = (int16_t)((unsigned)c.dc_pred << al_);
}

void Decoder::dc_refine(int16_t* coef) {
  if (get_bits(1)) coef[0] = (int16_t)(coef[0] | (1 << al_));
}

void Decoder::ac_first(Component& c, int16_t* coef) {
  if (eobrun_ > 0) {
    --eobrun_;
    return;
  }
  const Huffman& ac = ac_[c.ta];
  for (int k = ss_; k <= se_; ++k) {
    int rs = decode_huff(ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      coef[kZigzag[k]] =
          (int16_t)((unsigned)extend(get_bits(s), s) << al_);
    } else if (r == 15) {
      k += 15;
    } else {
      eobrun_ = 1 << r;
      if (r) eobrun_ += get_bits(r);
      --eobrun_;
      break;
    }
  }
}

void Decoder::ac_refine(Component& c, int16_t* coef) {
  const int p1 = 1 << al_, m1 = -1 * (1 << al_);
  int k = ss_;
  auto correct = [&](int16_t* x) {
    if (get_bits(1) && (*x & p1) == 0) *x = (int16_t)(*x + (*x >= 0 ? p1 : m1));
  };
  if (eobrun_ == 0) {
    const Huffman& ac = ac_[c.ta];
    for (; k <= se_; ++k) {
      int rs = decode_huff(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = get_bits(1) ? p1 : m1;  // a newly nonzero coefficient, size 1
      } else if (r != 15) {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        break;
      }
      // past already-nonzero coefficients (a correction bit each) and r
      // zero ones
      do {
        int16_t* x = coef + kZigzag[k];
        if (*x != 0) {
          correct(x);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se_);
      if (s) coef[kZigzag[k]] = (int16_t)s;
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se_; ++k) {
      int16_t* x = coef + kZigzag[k];
      if (*x != 0) correct(x);
    }
    --eobrun_;
  }
}

void Decoder::restart(int expected) {
  // jdhuff.c process_restart: drop the buffered bits, read RSTn
  bits_ = 0;
  nbits_ = 0;
  real_ = 0;
  for (auto* c : sc_) c->dc_pred = 0;
  eobrun_ = 0;
  hit_marker_ = false;
  while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;  // stray bytes
  while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
  if (pos_ >= n_) {
    // the file ends here: libjpeg's resync leaves the supplied EOI unread
    // and the rest of the scan takes the zeros
    hit_marker_ = true;
    cut = true;
    return;
  }
  if (d_[pos_] != 0xD0 + expected)
    throw Error{"missing restart marker (libjpeg resyncs)"};
  ++pos_;
  insufficient_ = false;
}

void Decoder::decode_mcu(int64_t m) {
  if (sc_.size() == 1) {  // one block an MCU, over the component's blocks
    Component& c = *sc_[0];
    int16_t* coef = c.block((int)(m % c.bw), (int)(m / c.bw));
    if (!progressive_)
      decode_sequential(c, coef);
    else if (ss_ == 0)
      ah_ ? dc_refine(coef) : dc_first(c, coef);
    else
      ah_ ? ac_refine(c, coef) : ac_first(c, coef);
    return;
  }
  int mx = (int)(m % mcux_), my = (int)(m / mcux_);
  for (auto* c : sc_) {
    for (int by = 0; by < c->v; ++by) {
      for (int bx = 0; bx < c->h; ++bx) {
        int16_t* coef = c->block(mx * c->h + bx, my * c->v + by);
        if (!progressive_)
          decode_sequential(*c, coef);
        else
          ah_ ? dc_refine(coef) : dc_first(*c, coef);
      }
    }
  }
}

void Decoder::scan() {
  int ns = byte();
  if (ns < 1 || ns > 4 || ns > (int)comps_.size())
    throw Error{"bad scan header"};
  sc_.clear();
  for (int i = 0; i < ns; ++i) {
    int id = byte(), t = byte();
    Component* c = nullptr;
    for (auto& cc : comps_)
      if (cc.id == id) c = &cc;
    if (!c) throw Error{"scan names an unknown component"};
    c->td = t >> 4;
    c->ta = t & 15;
    if (c->td > 3 || c->ta > 3) throw Error{"bad scan header"};
    sc_.push_back(c);
  }
  ss_ = byte();
  se_ = byte();
  int ahal = byte();
  ah_ = ahal >> 4;
  al_ = ahal & 15;
  if (!progressive_) {
    // libjpeg warns of other values and decodes the scan as sequential
    ss_ = 0;
    se_ = 63;
    ah_ = al_ = 0;
  } else {
    // jdphuff.c start_pass_phuff_decoder's checks
    bool bad = ss_ == 0 ? se_ != 0 : (ss_ > se_ || se_ > 63 || ns != 1);
    if ((ah_ && al_ != ah_ - 1) || al_ > 13) bad = true;
    if (bad) throw Error{"bad progressive scan parameters"};
    for (auto* c : sc_)
      for (int k = ss_; k <= se_; ++k) c->coef_bits[k] = al_;
  }
  // the Huffman tables the scan reads, and the quantization tables
  // latched at a component's first scan (jdinput.c latch_quant_tables)
  for (auto* c : sc_) {
    bool dc = !progressive_ || (ss_ == 0 && ah_ == 0);
    bool ac = !progressive_ || ss_ > 0;
    if ((dc && !dc_[c->td].defined) || (ac && !ac_[c->ta].defined))
      throw Error{"scan uses an undefined Huffman table"};
    if (!c->latched) {
      if (!q_defined_[c->tq]) throw Error{"undefined quantization table"};
      memcpy(c->q, q_[c->tq], sizeof c->q);
      c->latched = true;
    }
    c->dc_pred = 0;
  }
  eobrun_ = 0;
  bits_ = 0;
  nbits_ = 0;
  real_ = 0;
  hit_marker_ = false;
  insufficient_ = false;
  int64_t total = ns == 1 ? (int64_t)sc_[0]->bw * sc_[0]->bh
                          : (int64_t)mcux_ * mcuy_;
  int rst = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (restart_ && m > 0 && m % restart_ == 0) {
      restart(rst);
      rst = (rst + 1) & 7;
    }
    if (!insufficient_) decode_mcu(m);
  }
  bits_ = 0;
  nbits_ = 0;
  real_ = 0;
}

void Decoder::skip_entropy_data() {
  // to the next marker that is not a restart marker
  while (pos_ < n_) {
    if (d_[pos_] == 0xFF && pos_ + 1 < n_ && d_[pos_ + 1] != 0 &&
        !(d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7) &&
        d_[pos_ + 1] != 0xFF)
      return;
    ++pos_;
  }
}

bool Decoder::would_smooth() const {
  // jdcoefct.c smoothing_ok (SAVED_COEFS 10)
  if (!progressive_) return false;
  static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (const auto& c : comps_) {
    if (!c.latched) return false;
    for (int p : kPos)
      if (c.q[p] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
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
                int64_t stride) {
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

// A component's samples at the output's size (width x height): its blocks
// through the IDCT, then jdsample.c's upsampling for its ratio. The rows
// above the first and below the last (dh) repeat them (jdmainct.c's
// context pointers); the fancy filters read no column past dw.
void Decoder::plane(Component& c, std::vector<uint8_t>& full) {
  const int64_t pw = (int64_t)c.bw * 8;
  std::vector<uint8_t> p((size_t)pw * c.bh * 8);
  for (int by = 0; by < c.bh; ++by)
    for (int bx = 0; bx < c.bw; ++bx)
      idct_islow(c.block(bx, by), c.q, p.data() + by * 8 * pw + bx * 8, pw);
  if (hmax_ % c.h || vmax_ % c.v)
    throw Error{"fractional sampling ratios are not decoded"};
  const int he = hmax_ / c.h, ve = vmax_ / c.v;
  const int W = width, H = height, dw = c.dw, dh = c.dh;
  full.resize((size_t)W * H);
  auto row = [&](int i) { return p.data() + (int64_t)std::min(std::max(i, 0), dh - 1) * pw; };
  std::vector<int> sums(dw);
  std::vector<uint8_t> wide(2 * (size_t)dw);
  for (int y = 0; y < H; ++y) {
    uint8_t* o = full.data() + (int64_t)y * W;
    if (he == 1 && ve == 1) {
      memcpy(o, p.data() + (int64_t)y * pw, W);
    } else if (he == 2 && ve == 1 && dw > 2) {  // h2v1_fancy_upsample
      const uint8_t* in = p.data() + (int64_t)y * pw;
      uint8_t* w = wide.data();
      w[0] = in[0];
      w[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        int v3 = in[x] * 3;
        w[2 * x] = (uint8_t)((v3 + in[x - 1] + 1) >> 2);
        w[2 * x + 1] = (uint8_t)((v3 + in[x + 1] + 2) >> 2);
      }
      w[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      w[2 * dw - 1] = in[dw - 1];
      memcpy(o, w, W);
    } else if (he == 1 && ve == 2) {  // h1v2_fancy_upsample
      int i = y / 2, up = (y & 1) == 0;
      const uint8_t* in0 = row(i);
      const uint8_t* in1 = row(up ? i - 1 : i + 1);
      int bias = up ? 1 : 2;
      for (int x = 0; x < W; ++x)
        o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (he == 2 && ve == 2 && dw > 2) {  // h2v2_fancy_upsample
      int i = y / 2;
      const uint8_t* in0 = row(i);
      const uint8_t* in1 = row((y & 1) == 0 ? i - 1 : i + 1);
      for (int x = 0; x < dw; ++x) sums[x] = in0[x] * 3 + in1[x];
      uint8_t* w = wide.data();
      w[0] = (uint8_t)((sums[0] * 4 + 8) >> 4);
      w[1] = (uint8_t)((sums[0] * 3 + sums[1] + 7) >> 4);
      for (int x = 1; x < dw - 1; ++x) {
        w[2 * x] = (uint8_t)((sums[x] * 3 + sums[x - 1] + 8) >> 4);
        w[2 * x + 1] = (uint8_t)((sums[x] * 3 + sums[x + 1] + 7) >> 4);
      }
      w[2 * dw - 2] = (uint8_t)((sums[dw - 1] * 3 + sums[dw - 2] + 8) >> 4);
      w[2 * dw - 1] = (uint8_t)((sums[dw - 1] * 4 + 7) >> 4);
      memcpy(o, w, W);
    } else {  // int_upsample, h2v1_upsample, h2v2_upsample: replication
      const uint8_t* in = p.data() + (int64_t)(y / ve) * pw;
      for (int x = 0; x < W; ++x) o[x] = in[x / he];
    }
  }
}

// jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

void Decoder::decode(uint8_t* out, int channels) {
  allocate();
  pos_ = sos_pos_;
  int m = 0xDA;
  bool scanned = false;
  for (;;) {
    int64_t start = pos_;
    if (start + 2 > n_) {
      cut = true;
      break;
    }
    int64_t len = u16();
    int64_t end = start + len;
    if (len < 2 || end > n_) throw Error{"truncated segment"};
    if (m == 0xDA) {
      scan();
      scanned = true;
      skip_entropy_data();
    } else {
      if (m == 0xC4)
        read_dht(end);
      else if (m == 0xDB)
        read_dqt(end);
      else if (m == 0xDD)
        restart_ = u16();
      pos_ = end;
    }
    if (pos_ >= n_) {
      cut = true;
      break;
    }
    m = next_marker();
    if (m == 0xD9) break;
    if (m == 0xDA || m == 0xC4 || m == 0xDB || m == 0xDD ||
        (m >= 0xE0 && m <= 0xEF) || m == 0xFE)
      continue;
    throw Error{"unexpected marker after a scan"};
  }
  if (!scanned) throw Error{"no scan"};
  if (would_smooth())
    throw Error{"progressive JPEG whose coefficients are not all sent (block "
                "smoothing) is not decoded"};

  const int64_t npix = (int64_t)width * height;
  std::vector<uint8_t> p[4];
  if (space_ == Space::kGray || (space_ == Space::kYCbCr && channels == 1)) {
    plane(comps_[0], p[0]);
    for (int64_t i = 0; i < npix; ++i)
      for (int ch = 0; ch < channels; ++ch) out[i * channels + ch] = p[0][i];
    return;
  }
  for (size_t ci = 0; ci < comps_.size(); ++ci) plane(comps_[ci], p[ci]);
  static const YccTables t;
  if (space_ == Space::kYCbCr) {  // ycc_rgb_convert, written B, G, R
    for (int64_t i = 0; i < npix; ++i) {
      int y = p[0][i], cb = p[1][i], cr = p[2][i];
      uint8_t* o = out + i * 3;
      o[2] = clamp255(y + t.cr_r[cr]);
      o[1] = clamp255(y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[0] = clamp255(y + t.cb_b[cb]);
    }
    return;
  }
  for (int64_t i = 0; i < npix; ++i) {
    int c = p[0][i], mm = p[1][i], yy = p[2][i], k = p[3][i];
    if (space_ == Space::kYCCK) {  // ycck_cmyk_convert
      int y = c, cb = mm, cr = yy;
      c = clamp255(255 - (y + t.cr_r[cr]));
      mm = clamp255(255 - (y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
      yy = clamp255(255 - (y + t.cb_b[cb]));
    }
    // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R and icvCvt_CMYK2Gray_8u_C4C1R
    c = k - ((255 - c) * k >> 8);
    mm = k - ((255 - mm) * k >> 8);
    yy = k - ((255 - yy) * k >> 8);
    if (channels == 3) {
      out[i * 3] = (uint8_t)yy;
      out[i * 3 + 1] = (uint8_t)mm;
      out[i * 3 + 2] = (uint8_t)c;
    } else {
      out[i] = (uint8_t)((yy * 1868 + mm * 9617 + c * 4899 + 8192) >> 14);
    }
  }
}

int fail(const Error& e, char* err, int errlen) {
  snprintf(err, errlen, "%s", e.msg.c_str());
  return -1;
}

}  // namespace

extern "C" int jpeg_header(const uint8_t* data, int64_t n, int32_t* h,
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

extern "C" int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                           int32_t channels, int32_t* cut, char* err,
                           int errlen) {
  try {
    if (channels != 1 && channels != 3) throw Error{"channels must be 1 or 3"};
    Decoder dec(data, n);
    dec.header();
    dec.decode(out, channels);
    *cut = dec.cut ? 1 : 0;
    return 0;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}
