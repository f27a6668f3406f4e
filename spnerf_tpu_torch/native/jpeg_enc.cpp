// Gray JPEG writing as cv2.imwrite / cv2.imencode('.jpg') does it with
// its default parameters, byte for byte: libjpeg-turbo asked for a
// baseline JCS_GRAYSCALE file at a quality (95 by default), with its
// standard Huffman tables (no optimize_coding) and no restart interval.
//
// The file is SOI, a JFIF 1.01 APP0 (no density unit, 1:1), one 8-bit
// DQT (table 0), SOF0, the standard luminance DC and AC DHT segments,
// one SOS and the entropy-coded blocks, then EOI. Its arithmetic is
// libjpeg-turbo's:
// - jcparam.c: quality scaling of the standard luminance table, each
//   entry (q * scale + 50) / 100 clamped to [1, 255] (force_baseline);
// - jcprepct.c / jcsample.c: the image extended to whole 8 x 8 blocks by
//   replicating its last column and its last row;
// - jfdctint.c: the islow forward DCT on samples less 128 (its output
//   scaled up by 8);
// - jcdctmgr.c: quantization by the reciprocals of compute_reciprocal
//   (divisor = quantval << 3; 16-bit DCTELEM as with SIMD);
// - jchuff.c: DC differences and AC runs coded by the standard tables,
//   0xFF bytes stuffed, the last byte padded with 1 bits.
//
// C interface (ctypes): jpeg_encode_gray() writes at most `cap` bytes to
// out and returns their count, or -1 when `cap` is too small.
#include <cstdint>
#include <cstring>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jcparam.c's std_luminance_quant_tbl, natural order
const int kLuminance[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

// jcparam.c's std_huff_tables: bits[1..16] and values, luminance
const uint8_t kDcBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Code {
  uint16_t code[256];
  uint8_t size[256];
};

// jchuff.c's jpeg_make_c_derived_tbl: canonical codes by length
void derive(const uint8_t* bits, const uint8_t* vals, Code& out) {
  std::memset(&out, 0, sizeof(out));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k) {
      out.code[vals[k]] = (uint16_t)code++;
      out.size[vals[k]] = (uint8_t)len;
    }
    code <<= 1;
  }
}

// jcdctmgr.c's compute_reciprocal with a 16-bit DCTELEM: the reciprocal,
// the rounding correction and the shift past the high 16 bits
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, -16};
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r - 16};
}

const int kConstBits = 13, kPass1Bits = 2;
inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// jfdctint.c's jpeg_fdct_islow, in place on 64 samples (row-major)
void fdct_islow(int16_t* data) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, stride = pass ? 1 : 8;
    const int shift_even = pass ? kPass1Bits : 0;
    const int shift_odd = pass ? kConstBits + kPass1Bits
                               : kConstBits - kPass1Bits;
    for (int k = 0; k < 8; ++k) {
      int16_t* p = data + k * stride;
      int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int32_t tmp2 = p[2 * step] + p[5 * step];
      int32_t tmp5 = p[2 * step] - p[5 * step];
      int32_t tmp3 = p[3 * step] + p[4 * step];
      int32_t tmp4 = p[3 * step] - p[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass) {
        p[0] = (int16_t)descale(tmp10 + tmp11, shift_even);
        p[4 * step] = (int16_t)descale(tmp10 - tmp11, shift_even);
      } else {
        p[0] = (int16_t)((tmp10 + tmp11) * (1 << kPass1Bits));
        p[4 * step] = (int16_t)((tmp10 - tmp11) * (1 << kPass1Bits));
      }
      int32_t z1 = (tmp12 + tmp13) * 4433;  // FIX_0_541196100
      p[2 * step] = (int16_t)descale(z1 + tmp13 * 6270, shift_odd);
      p[6 * step] = (int16_t)descale(z1 + tmp12 * -15137, shift_odd);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * 9633;  // FIX_1_175875602
      tmp4 *= 2446;    // FIX_0_298631336
      tmp5 *= 16819;   // FIX_2_053119869
      tmp6 *= 25172;   // FIX_3_072711026
      tmp7 *= 12299;   // FIX_1_501321110
      z1 *= -7373;     // FIX_0_899976223
      z2 *= -20995;    // FIX_2_562915447
      z3 *= -16069;    // FIX_1_961570560
      z4 *= -3196;     // FIX_0_390180644
      z3 += z5;
      z4 += z5;
      p[7 * step] = (int16_t)descale(tmp4 + z1 + z3, shift_odd);
      p[5 * step] = (int16_t)descale(tmp5 + z2 + z4, shift_odd);
      p[3 * step] = (int16_t)descale(tmp6 + z2 + z3, shift_odd);
      p[1 * step] = (int16_t)descale(tmp7 + z1 + z4, shift_odd);
    }
  }
}

class Writer {
 public:
  Writer(uint8_t* out, int64_t cap) : out_(out), cap_(cap) {}
  bool overflow = false;
  int64_t size = 0;

  void byte(int v) {
    if (size < cap_) out_[size] = (uint8_t)v;
    else overflow = true;
    ++size;
  }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 0xFF);
  }
  // jchuff.c's emit_bits: MSB first, 0xFF stuffed with 0x00
  void bits(uint32_t code, int n) {
    acc_ = (acc_ << n) | (code & ((1u << n) - 1));
    nacc_ += n;
    while (nacc_ >= 8) {
      int c = (int)((acc_ >> (nacc_ - 8)) & 0xFF);
      byte(c);
      if (c == 0xFF) byte(0);
      nacc_ -= 8;
    }
  }
  void flush() {  // jchuff.c's flush_bits: 1 bits to a byte boundary
    bits(0x7F, 7);
    acc_ = 0;
    nacc_ = 0;
  }

 private:
  uint8_t* out_;
  int64_t cap_;
  uint64_t acc_ = 0;
  int nacc_ = 0;
};

int nbits_of(int v) {
  int n = 0;
  for (v = v < 0 ? -v : v; v; v >>= 1) ++n;
  return n;
}

}  // namespace

extern "C" int64_t jpeg_encode_gray(const uint8_t* img, int32_t h, int32_t w,
                                    int32_t quality, uint8_t* out,
                                    int64_t cap) {
  // jcparam.c: jpeg_quality_scaling, jpeg_add_quant_table (force_baseline)
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  int q[64];
  Divisor div[64];
  for (int i = 0; i < 64; ++i) {
    long t = ((long)kLuminance[i] * scale + 50L) / 100L;
    q[i] = t <= 0 ? 1 : t > 255 ? 255 : (int)t;
    div[i] = reciprocal((uint32_t)q[i] << 3);
  }
  Code dc, ac;
  derive(kDcBits, kDcVals, dc);
  derive(kAcBits, kAcVals, ac);

  Writer wr(out, cap);
  wr.u16(0xFFD8);
  // APP0: JFIF 1.01, no density unit, density 1 x 1, no thumbnail
  const uint8_t app0[] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1,
                          0, 0, 1, 0, 1, 0, 0};
  for (uint8_t b : app0) wr.byte(b);
  wr.u16(0xFFDB);
  wr.u16(67);
  wr.byte(0);
  for (int i = 0; i < 64; ++i) wr.byte(q[kNatural[i]]);
  wr.u16(0xFFC0);
  wr.u16(11);
  wr.byte(8);
  wr.u16(h);
  wr.u16(w);
  wr.byte(1);
  wr.byte(1);     // component id
  wr.byte(0x11);  // 1 x 1 sampling
  wr.byte(0);     // table 0
  for (int cls = 0; cls < 2; ++cls) {
    const uint8_t* bits = cls ? kAcBits : kDcBits;
    const uint8_t* vals = cls ? kAcVals : kDcVals;
    int n = 0;
    for (int i = 0; i < 16; ++i) n += bits[i];
    wr.u16(0xFFC4);
    wr.u16(2 + 1 + 16 + n);
    wr.byte(cls << 4);
    for (int i = 0; i < 16; ++i) wr.byte(bits[i]);
    for (int i = 0; i < n; ++i) wr.byte(vals[i]);
  }
  const uint8_t sos[] = {0xFF, 0xDA, 0, 8, 1, 1, 0x00, 0, 63, 0};
  for (uint8_t b : sos) wr.byte(b);

  const int bw = (w + 7) / 8, bh = (h + 7) / 8;
  int last_dc = 0;
  int16_t block[64];
  for (int by = 0; by < bh; ++by) {
    for (int bx = 0; bx < bw; ++bx) {
      for (int y = 0; y < 8; ++y) {
        int sy = by * 8 + y;
        if (sy >= h) sy = h - 1;
        for (int x = 0; x < 8; ++x) {
          int sx = bx * 8 + x;
          if (sx >= w) sx = w - 1;
          block[y * 8 + x] = (int16_t)(img[(int64_t)sy * w + sx] - 128);
        }
      }
      fdct_islow(block);
      int coef[64];
      for (int i = 0; i < 64; ++i) {
        int t = block[i];
        bool neg = t < 0;
        uint32_t a = (uint32_t)(neg ? -t : t);
        uint32_t p = ((a + div[i].corr) * div[i].recip) >>
                     (div[i].shift + 16);
        coef[i] = neg ? -(int)p : (int)p;
      }
      // jchuff.c: encode_one_block
      int diff = coef[0] - last_dc;
      last_dc = coef[0];
      int nb = nbits_of(diff);
      wr.bits(dc.code[nb], dc.size[nb]);
      if (nb) wr.bits((uint32_t)(diff < 0 ? diff - 1 : diff), nb);
      int run = 0;
      for (int k = 1; k < 64; ++k) {
        int v = coef[kNatural[k]];
        if (v == 0) {
          ++run;
          continue;
        }
        while (run > 15) {
          wr.bits(ac.code[0xF0], ac.size[0xF0]);
          run -= 16;
        }
        nb = nbits_of(v);
        int sym = (run << 4) + nb;
        wr.bits(ac.code[sym], ac.size[sym]);
        wr.bits((uint32_t)(v < 0 ? v - 1 : v), nb);
        run = 0;
      }
      if (run > 0) wr.bits(ac.code[0], ac.size[0]);
    }
  }
  wr.flush();
  wr.u16(0xFFD9);
  return wr.overflow ? -1 : wr.size;
}
