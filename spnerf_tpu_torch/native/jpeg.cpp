// JPEG decoding as cv2.imread asks libjpeg-turbo (3.1) for it, gray
// (JCS_GRAYSCALE) or colour (BGR), byte for byte at full DCT scale.
//
// Files of 8-bit samples: baseline, extended sequential and progressive,
// Huffman-coded (SOF0-2) or arithmetic-coded (SOF9-10, jdarith.c: the QM
// coder and its statistics, the DAC marker's L, U and Kx); 1, 3 or 4
// components at any integral sampling; restart markers. Lossless files
// (SOF3, jdlossls.c: predictors 1-7, point transform, any integral
// sampling, upsampled by replication) where libjpeg-turbo needs no colour
// conversion: gray read gray, RGB read as BGR, CMYK. Every scan's
// coefficients are held for the whole image; each block then goes through
// the integer "islow" inverse DCT as libjpeg-turbo's SIMD code computes it
// (jidctint.c's sums in its 16- and 32-bit lanes), each component is
// upsampled as jdsample.c does with do_fancy_upsampling on (h2v1, h1v2
// and h2v2 triangle filters, plain replication otherwise or where a
// component is 2 samples wide or less), and the colour conversions are
// jdcolor.c's: YCbCr to RGB in 16-bit fixed point, RGB-coded files
// (Adobe transform 0, or ids 'R' 'G' 'B' without JFIF) copied or to gray
// by rgb_gray_convert, YCCK to CMYK, gray replicated. A gray read of
// YCbCr keeps the luma plane alone. 4-component files come out as
// libjpeg's CMYK, which cv2 turns to BGR or gray with its own formulas.
//
// Damaged files decode as libjpeg decodes them: stray bytes before a
// marker are skipped (jdmarker.c next_marker); a restart marker that is
// missing or out of order is resynced by jpeg_resync_to_restart's four
// actions; a Huffman code past 16 bits is a zero; past the end of the
// file the source supplies EOI markers, a Huffman scan takes zero bits
// for the rest of the MCU the data ran out in and leaves the MCUs after it
// as they stood, an arithmetic scan decodes on from zeros. Progressive
// files whose coefficients 1-9 are not all sent to their last bit (cut
// short, or a short scan script) are block-smoothed (jdcoefct.c
// decompress_smooth_data, libjpeg-turbo's 5 x 5 DC neighbourhood). A
// single sequential scan of every component ends the read: libjpeg has
// put the image out before it parses on. The first warning is kept for
// the caller, as libjpeg shows only its first.
//
// Refused as cv2 refuses them ("cv2 refuses: "): 12- and 16-bit samples,
// hierarchical and lossless arithmetic frames, 2 components, a lossless
// read that needs a colour conversion (libjpeg-turbo has none there), a
// file that ends inside its header, fractional sampling ratios where a
// component must be upsampled (a gray read of YCbCr decodes: it needs the
// luma alone), a DC Huffman value past 15, a lossless restart interval
// of part of an MCU row.
//
// C interface (ctypes): jpeg_header() reads the size, jpeg_decode() fills
// a height x width x channels uint8 buffer (channels 1: gray; 3: B, G, R)
// and copies libjpeg's first warning, if any, into warning. Both return 0,
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

// jaricom.c jpeg_aritab: the QM coder's Qe values and state machine,
// (Qe << 16) | (Next_Index_MPS << 8) | (Switch_MPS << 7) | Next_Index_LPS
#define V(i, qe, nlps, nmps, sw) \
  (((int64_t)(qe) << 16) | ((int64_t)(nmps) << 8) | ((sw) << 7) | (nlps))
const int64_t kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),       V(1, 0x2586, 14, 2, 0),
    V(2, 0x1114, 16, 3, 0),      V(3, 0x080b, 18, 4, 0),
    V(4, 0x03d8, 20, 5, 0),      V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),      V(7, 0x006f, 28, 8, 0),
    V(8, 0x0036, 30, 9, 0),      V(9, 0x001a, 33, 10, 0),
    V(10, 0x000d, 35, 11, 0),    V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),    V(13, 0x0001, 12, 13, 0),
    V(14, 0x5a7f, 15, 15, 1),    V(15, 0x3f25, 36, 16, 0),
    V(16, 0x2cf2, 38, 17, 0),    V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),    V(19, 0x1182, 42, 20, 0),
    V(20, 0x0cef, 43, 21, 0),    V(21, 0x09a1, 45, 22, 0),
    V(22, 0x072f, 46, 23, 0),    V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),    V(25, 0x0303, 51, 26, 0),
    V(26, 0x0240, 52, 27, 0),    V(27, 0x01b1, 54, 28, 0),
    V(28, 0x0144, 56, 29, 0),    V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),    V(31, 0x008a, 60, 32, 0),
    V(32, 0x0068, 62, 33, 0),    V(33, 0x004e, 63, 34, 0),
    V(34, 0x003b, 32, 35, 0),    V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),    V(37, 0x484c, 64, 38, 0),
    V(38, 0x3a0d, 65, 39, 0),    V(39, 0x2ef1, 67, 40, 0),
    V(40, 0x261f, 68, 41, 0),    V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),    V(43, 0x1518, 72, 44, 0),
    V(44, 0x1177, 73, 45, 0),    V(45, 0x0e74, 74, 46, 0),
    V(46, 0x0bfb, 75, 47, 0),    V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),    V(49, 0x0706, 79, 50, 0),
    V(50, 0x05cd, 48, 51, 0),    V(51, 0x04de, 50, 52, 0),
    V(52, 0x040f, 50, 53, 0),    V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),    V(55, 0x025c, 53, 56, 0),
    V(56, 0x01f8, 54, 57, 0),    V(57, 0x01a4, 55, 58, 0),
    V(58, 0x0160, 56, 59, 0),    V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),    V(61, 0x00cb, 59, 62, 0),
    V(62, 0x00ab, 61, 63, 0),    V(63, 0x008f, 61, 32, 0),
    V(64, 0x5b12, 65, 65, 1),    V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),    V(67, 0x37d8, 82, 68, 0),
    V(68, 0x2fe8, 83, 69, 0),    V(69, 0x293c, 84, 70, 0),
    V(70, 0x2379, 86, 71, 0),    V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),    V(73, 0x174e, 72, 74, 0),
    V(74, 0x1424, 72, 75, 0),    V(75, 0x119c, 74, 76, 0),
    V(76, 0x0f6b, 74, 77, 0),    V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),    V(79, 0x0a40, 77, 48, 0),
    V(80, 0x5832, 80, 81, 1),    V(81, 0x4d1c, 88, 82, 0),
    V(82, 0x438e, 89, 83, 0),    V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),    V(85, 0x2eae, 92, 86, 0),
    V(86, 0x299a, 93, 87, 0),    V(87, 0x2516, 86, 71, 0),
    V(88, 0x5570, 88, 89, 1),    V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),    V(91, 0x3e22, 97, 92, 0),
    V(92, 0x3824, 99, 93, 0),    V(93, 0x32b4, 99, 94, 0),
    V(94, 0x2e17, 93, 86, 0),    V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),   V(97, 0x47e5, 102, 98, 0),
    V(98, 0x41cf, 103, 99, 0),   V(99, 0x3c3d, 104, 100, 0),
    V(100, 0x375e, 99, 93, 0),   V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0),
    V(104, 0x415e, 103, 99, 0),  V(105, 0x5627, 105, 106, 1),
    V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0),
    V(110, 0x5a10, 110, 111, 1), V(111, 0x5522, 112, 109, 0),
    V(112, 0x59eb, 112, 111, 1),
    // a fixed probability of 0.5 (T.851 Table 5)
    V(113, 0x5a1d, 113, 113, 0)};
#undef V

struct Error {
  std::string msg;
};

// The error messages of the kinds of file cv2 refuses (jpeg.py names them
// so; every error is one libjpeg stops at too)
const char kRefused[] = "cv2 refuses: ";

struct Huffman {
  bool defined = false;
  int count = 0;  // values defined
  uint8_t counts[17] = {};  // codes of each length 1-16
  int maxcode[18];
  int valoffset[18];
  uint8_t values[256];
  // 8-bit lookahead: (length << 8) | value, 0 where longer
  uint16_t look[256];
};

enum class Space { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int fv = 1;  // the frame header's vertical factor (kept for one component)
  int td = 0, ta = 0;
  int dc_pred = 0;
  int dc_context = 0;  // arithmetic DC conditioning
  int dw = 0, dh = 0;  // samples (jdinput.c's downsampled_width / height)
  int bw = 0, bh = 0;  // blocks covering them
  int stride = 0;      // blocks a row in coef (MCU-padded)
  std::vector<int16_t> coef;  // natural order, 64 a block
  bool latched = false;       // quantization table copied at its 1st scan
  uint16_t q[64];
  int coef_bits[64];  // progressive: the Al of the last scan, -1 unsent
  int prev_bits[64];  // coef_bits before the last scan that reached them
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
  bool cut = false;     // the file ended before EOI
  std::string warning;  // the first warning (libjpeg shows only that)

 private:
  const uint8_t* d_;
  int64_t n_;
  int64_t pos_ = 0;
  int64_t marker_pos_ = 0;  // the 0xFF of the marker next_marker returned
  uint16_t q_[4][64] = {};
  bool q_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  std::vector<Component> comps_;
  int hmax_ = 1, vmax_ = 1;
  int fvmax_ = 1;            // the frame's largest vertical factor
  int mcux_ = 0, mcuy_ = 0;  // MCUs of an interleaved scan
  int restart_ = 0;
  bool progressive_ = false, arith_ = false, lossless_ = false;
  std::vector<uint16_t> samples_[4];  // a lossless frame's samples
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  Space space_ = Space::kGray;
  bool frame_ = false;
  int64_t sos_pos_ = 0;  // first SOS segment (after the header)
  int scans_ = 0;        // libjpeg's input_scan_number
  int last_good_ = 0;    // jdmaster's last_good_iMCU_row
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
  // arithmetic decoder (jdarith.c): C, A, CT and the statistics areas;
  // DAC conditioning L, U (DC) and Kx (AC) by table
  int64_t ac_c_ = 0, ac_a_ = 0;
  int ac_ct_ = 0;
  uint8_t dc_stats_[16][64], ac_stats_[16][256];
  uint8_t fixed_bin_[4] = {113, 0, 0, 0};
  uint8_t dac_l_[16], dac_u_[16], dac_k_[16];

  void warn(const std::string& msg) {
    if (warning.empty()) warning = msg;
  }
  // a segment's bytes; past the end of the file, the EOI markers that
  // libjpeg's source supplies (FF D9, again and again)
  uint8_t byte() {
    if (pos_ < n_) return d_[pos_++];
    warn("Premature end of JPEG file");
    cut = true;
    return ((pos_++ - n_) & 1) ? 0xD9 : 0xFF;
  }
  int u16() {
    int a = byte();
    return (a << 8) | byte();
  }
  int next_marker(int discarded = 0);
  void read_dqt(int64_t end);
  void read_dht(int64_t end);
  void read_dac(int64_t end);
  void read_sof(int marker, int64_t len);
  void allocate();
  void scan(int64_t len);
  void start_entropy();
  void fill();
  void consume(int n) {
    bits_ <<= n;
    nbits_ -= n;
    if (n > real_) {
      if (!insufficient_)
        warn("Corrupt JPEG data: premature end of data segment");
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
  int arith_byte();
  int arith_decode(uint8_t* st);
  bool arith_dc_diff(Component& c, int* v);
  int arith_ac_value(int tbl, int k, uint8_t* st);
  void arith_sequential(Component& c, int16_t* coef);
  void arith_dc_first(Component& c, int16_t* coef);
  void arith_ac_first(Component& c, int16_t* coef);
  void arith_ac_refine(Component& c, int16_t* coef);
  void decode_block(Component& c, int16_t* coef);
  void lossless_scan();
  void decode_mcu(int64_t m);
  int imcu_row(int64_t m) const;
  bool smoothing_ok(std::vector<int>& latch) const;
  void idct_component(Component& c, int ci, const std::vector<int>* latch,
                      uint8_t* p, int64_t pw);
  void plane(Component& c, int ci, const std::vector<int>* latch,
             std::vector<uint8_t>& full);
};

// jdmarker.c next_marker: past any other bytes (stuffed FF 00 pairs
// among them) and fill bytes to the next marker, warning of the bytes
// skipped. At the end of the file the source supplies an EOI (jdatasrc.c
// warns "Premature end of JPEG file").
int Decoder::next_marker(int discarded) {
  int c = 0;
  for (;;) {
    if (pos_ >= n_) break;
    c = d_[pos_++];
    while (c != 0xFF && pos_ < n_) {
      ++discarded;
      c = d_[pos_++];
    }
    if (c != 0xFF) {
      ++discarded;
      break;
    }
    marker_pos_ = pos_ - 1;
    do {
      c = pos_ < n_ ? d_[pos_++] : -1;
    } while (c == 0xFF);
    if (c > 0) {
      if (discarded) {
        char msg[96];
        snprintf(msg, sizeof msg,
                 "Corrupt JPEG data: %d extraneous bytes before marker 0x%02x",
                 discarded, c);
        warn(msg);
      }
      return c;
    }
    if (c < 0) break;
    discarded += 2;  // FF 00: data, not a marker
  }
  warn("Premature end of JPEG file");
  cut = true;
  pos_ = marker_pos_ = n_;
  return 0xD9;
}

// jdmarker.c get_dqt: 64 entries a table whatever the segment's length,
// which must then come out even
void Decoder::read_dqt(int64_t end) {
  while (pos_ < end) {
    int pq_tq = byte();
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (tq > 3) throw Error{"bad quantization table"};
    for (int i = 0; i < 64; ++i)
      q_[tq][kZigzag[i]] = pq ? (uint16_t)u16() : byte();
    q_defined_[tq] = true;
  }
  if (pos_ != end) throw Error{"bad DQT length"};
}

// jdmarker.c get_dht: the tables as defined; their codes are derived when
// a scan uses them
void Decoder::read_dht(int64_t end) {
  while (pos_ < end) {
    int tc_th = byte();
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) throw Error{"bad Huffman table"};
    Huffman& h = tc ? ac_[th] : dc_[th];
    int total = 0;
    for (int i = 1; i <= 16; ++i) total += h.counts[i] = byte();
    // no more values than the segment holds
    if (total > 256 || total > end - pos_) throw Error{"bad Huffman table"};
    for (int i = 0; i < total; ++i) h.values[i] = byte();
    h.count = total;
    h.defined = true;
  }
  if (pos_ != end) throw Error{"bad DHT length"};
}

// jdhuff.c jpeg_make_d_derived_tbl, at the start of each scan that reads
// the table: canonical codes (none all ones), DC values categories 0-15
// (0-16 in a lossless scan)
void derive(Huffman& h, bool dc, bool lossless) {
  if (!h.defined) throw Error{"scan uses an undefined Huffman table"};
  if (dc)
    for (int i = 0; i < h.count; ++i)
      if (h.values[i] > (lossless ? 16 : 15))
        throw Error{std::string(kRefused) + "a DC Huffman value past 15"};
  int code = 0, k = 0;
  memset(h.look, 0, sizeof h.look);
  for (int len = 1; len <= 16; ++len) {
    h.valoffset[len] = k - code;
    for (int i = 0; i < h.counts[len]; ++i, ++k, ++code) {
      if (len <= 8) {
        int shift = 8 - len;
        for (int j = 0; j < (1 << shift); ++j)
          h.look[(code << shift) | j] = (uint16_t)((len << 8) | h.values[k]);
      }
    }
    h.maxcode[len] = h.counts[len] ? code - 1 : -1;
    if (code >= (1 << len)) throw Error{"bad Huffman table"};
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
}

// jdhuff.c std_huff_tables: the tables of ITU T.81 K.3-K.6 where a
// sequential Huffman stream (Motion JPEG) leaves tables 0 or 1 undefined
void std_table(Huffman& h, const uint8_t* counts, const uint8_t* values) {
  if (h.defined) return;
  h.count = 0;
  for (int i = 1; i <= 16; ++i) h.count += h.counts[i] = counts[i - 1];
  memcpy(h.values, values, (size_t)h.count);
  h.defined = true;
}

const uint8_t kDcLumaCounts[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaCounts[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                     1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcValues[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaCounts[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                   5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaValues[162] = {
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
const uint8_t kAcChromaCounts[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                     7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaValues[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jdmarker.c get_dac: DC tables' L and U, AC tables' Kx
void Decoder::read_dac(int64_t end) {
  while (pos_ < end) {
    int index = byte(), val = byte();
    if (index >= 32) throw Error{"bad DAC marker"};
    if (index < 16) {
      dac_l_[index] = (uint8_t)(val & 15);
      dac_u_[index] = (uint8_t)(val >> 4);
      if (dac_l_[index] > dac_u_[index]) throw Error{"bad DAC value"};
    } else {
      dac_k_[index - 16] = (uint8_t)val;
    }
  }
}

void Decoder::read_sof(int marker, int64_t len) {
  if (frame_) throw Error{"more than one frame"};
  progressive_ = marker == 0xC2 || marker == 0xCA;
  arith_ = marker >= 0xC9;
  lossless_ = marker == 0xC3;
  int precision = byte();
  height = u16();
  width = u16();
  int nc = byte();
  // jpeg_read_scanlines takes 8-bit samples alone
  if (precision != 8)
    throw Error{std::string(kRefused) + std::to_string(precision) +
                "-bit samples"};
  if (nc != 1 && nc != 3 && nc != 4)  // JCS_UNKNOWN: no conversion to BGR
    throw Error{std::string(kRefused) + std::to_string(nc) + " components"};
  if (width <= 0 || height <= 0) throw Error{"empty image"};
  if (len != 8 + 3 * nc) throw Error{"bad SOF length"};  // get_sof
  comps_.resize(nc);
  for (auto& c : comps_) {
    c.id = byte();
    int hv = byte();
    c.h = hv >> 4;
    c.v = c.fv = hv & 15;
    c.tq = byte();
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      throw Error{"bad component"};
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  fvmax_ = vmax_;
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
  if (lossless_)  // every component is upsampled: none may be fractional
    for (auto& c : comps_)
      if (hmax_ % c.h || vmax_ % c.v)
        throw Error{std::string(kRefused) + "fractional sampling ratios"};
  frame_ = true;
}

void Decoder::header() {
  if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) throw Error{"not a JPEG file"};
  pos_ = 2;
  for (int k = 0; k < 16; ++k) {
    dac_l_[k] = 0;
    dac_u_[k] = 1;
    dac_k_[k] = 5;
  }
  for (;;) {
    int m = next_marker();
    // jdmarker.c read_markers: RSTn and TEM carry nothing; a second SOI
    // and the markers it does not know are errors
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (m == 0xD8) throw Error{"a second SOI marker"};
    const bool known = (m >= 0xC0 && m <= 0xCF) || m == 0xD9 || m == 0xDA ||
                       m == 0xDB || m == 0xDC || m == 0xDD ||
                       (m >= 0xE0 && m <= 0xEF) || m == 0xFE;
    if (!known) throw Error{"an unknown marker in the header"};
    if (m == 0xD9)
      throw Error{std::string(kRefused) + (cut ? "the file ends in its header"
                                               : "no image data")};
    int64_t start = pos_;
    int64_t len = u16();
    int64_t end = start + len;
    if (len < 2) throw Error{"bad segment length"};
    if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 ||
        m == 0xCA) {
      read_sof(m, len);
    } else if (m == 0xC8) {
      throw Error{std::string(kRefused) + "a JPG (extension) frame"};
    } else if (m == 0xCB) {
      throw Error{std::string(kRefused) + "lossless arithmetic-coded JPEG"};
    } else if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD ||
               m == 0xCE || m == 0xCF) {
      throw Error{std::string(kRefused) + "hierarchical JPEG"};
    } else if (m == 0xDB) {
      read_dqt(end);
    } else if (m == 0xC4) {
      read_dht(end);
    } else if (m == 0xCC) {
      read_dac(end);
    } else if (m == 0xDD) {
      if (len != 4) throw Error{"bad DRI length"};
      restart_ = u16();
    } else if (m == 0xE0) {
      // jdmarker.c examine_app0: 14 bytes of data, "JFIF\0"
      if (len >= 16 && end <= n_ && memcmp(d_ + start + 2, "JFIF\0", 5) == 0)
        jfif_ = true;
    } else if (m == 0xEE) {
      if (len >= 14 && end <= n_ && memcmp(d_ + start + 2, "Adobe", 5) == 0) {
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
    else  // ids 1, 2, 3 mean YCbCr, but RGB in a lossless file
      rgb = (comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66) ||
            (lossless_ && comps_[0].id == 1 && comps_[1].id == 2 &&
             comps_[2].id == 3);
    space_ = rgb ? Space::kRGB : Space::kYCbCr;
  } else {
    space_ = adobe_ && adobe_transform_ != 0 ? Space::kYCCK : Space::kCMYK;
  }
}

void Decoder::allocate() {
  for (auto& c : comps_) {
    // interleaved scans reach mcux_ * h blocks across, one-component
    // scans bw; block smoothing reads whole iMCU rows of the frame's
    // factor: hold the largest
    c.stride = std::max(c.bw, mcux_ * c.h);
    int rows = std::max({c.bh, mcuy_ * c.v, (c.bh + c.fv - 1) / c.fv * c.fv});
    c.coef.assign((size_t)c.stride * rows * 64, 0);
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = c.prev_bits[k] = -1;
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
        warn("Premature end of JPEG file");
      } else if (d_[pos_] == 0xFF) {
        int64_t p = pos_ + 1;
        while (p < n_ && d_[p] == 0xFF) ++p;
        if (p < n_ && d_[p] == 0x00) {
          c = 0xFF;
          real = true;
          pos_ = p + 1;
        } else {
          hit_marker_ = true;  // a marker: zeros from here
          if (p >= n_) {
            cut = true;
            warn("Premature end of JPEG file");
          }
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
  if (nbits_ < 17) fill();  // a bad code takes 17 bits
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
  if (len > 16) {  // jpeg_huff_decode: 17 bits gone, a zero faked
    warn("Corrupt JPEG data: bad Huffman code");
    consume(17);
    return 0;
  }
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

// jdarith.c: the byte source (zeros once a marker or the end is met),
// then arith_decode, the QM coder's decision
int Decoder::arith_byte() {
  if (hit_marker_) return 0;
  if (pos_ >= n_) {
    hit_marker_ = true;
    cut = true;
    warn("Premature end of JPEG file");
    return 0;
  }
  int data = d_[pos_];
  if (data != 0xFF) {
    ++pos_;
    return data;
  }
  int64_t p = pos_ + 1;
  while (p < n_ && d_[p] == 0xFF) ++p;
  if (p < n_ && d_[p] == 0) {
    pos_ = p + 1;
    return 0xFF;
  }
  hit_marker_ = true;  // a marker: legal here, zeros from now on
  if (p >= n_) {
    cut = true;
    warn("Premature end of JPEG file");
  }
  return 0;
}

int Decoder::arith_decode(uint8_t* st) {
  while (ac_a_ < 0x8000) {
    if (--ac_ct_ < 0) {
      ac_c_ = (ac_c_ << 8) | arith_byte();
      if ((ac_ct_ += 8) < 0)
        if (++ac_ct_ == 0) ac_a_ = 0x8000;  // two initial bytes read
    }
    ac_a_ <<= 1;
  }
  int sv = *st;
  int64_t qe = kAritab[sv & 0x7F];
  const int nl = (int)(qe & 0xFF);
  qe >>= 8;
  const int nm = (int)(qe & 0xFF);
  qe >>= 8;
  int64_t temp = ac_a_ - qe;
  ac_a_ = temp;
  temp <<= ac_ct_;
  if (ac_c_ >= temp) {
    ac_c_ -= temp;
    if (ac_a_ < qe) {  // conditional LPS exchange
      ac_a_ = qe;
      *st = (uint8_t)((sv & 0x80) ^ nm);
    } else {
      ac_a_ = qe;
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    }
  } else if (ac_a_ < 0x8000) {
    if (ac_a_ < qe) {  // conditional MPS exchange
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    } else {
      *st = (uint8_t)((sv & 0x80) ^ nm);
    }
  }
  return sv >> 7;
}

// Figures F.19, F.21-F.24: a DC difference into c's prediction (libjpeg
// keeps it to 16 bits); false where the magnitude overflows (CT = -1)
bool Decoder::arith_dc_diff(Component& c, int* v) {
  const int tbl = c.td;
  uint8_t* st = dc_stats_[tbl] + c.dc_context;
  if (arith_decode(st) == 0) {
    c.dc_context = 0;
    *v = 0;
    return true;
  }
  int sign = arith_decode(st + 1);
  st += 2 + sign;
  int m = arith_decode(st);
  if (m != 0) {
    st = dc_stats_[tbl] + 20;
    while (arith_decode(st)) {
      if ((m <<= 1) == 0x8000) {
        warn("Corrupt JPEG data: bad arithmetic code");
        ac_ct_ = -1;
        return false;
      }
      st += 1;
    }
  }
  if (m < (int)((1L << dac_l_[tbl]) >> 1))
    c.dc_context = 0;
  else if (m > (int)((1L << dac_u_[tbl]) >> 1))
    c.dc_context = 12 + sign * 4;
  else
    c.dc_context = 4 + sign * 4;
  int val = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(st)) val |= m;
  val += 1;
  *v = sign ? -val : val;
  return true;
}

// Figures F.21-F.24 for the AC coefficient k, st at its S0 + 2; -1 << 16
// where the magnitude overflows
int Decoder::arith_ac_value(int tbl, int k, uint8_t* st) {
  int sign = arith_decode(fixed_bin_);
  int m = arith_decode(st);
  if (m != 0 && arith_decode(st)) {
    m <<= 1;
    st = ac_stats_[tbl] + (k <= dac_k_[tbl] ? 189 : 217);
    while (arith_decode(st)) {
      if ((m <<= 1) == 0x8000) {
        warn("Corrupt JPEG data: bad arithmetic code");
        ac_ct_ = -1;
        return -1 << 16;
      }
      st += 1;
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(st)) v |= m;
  v += 1;
  return sign ? -v : v;
}

// jdarith.c decode_mcu: one block of a sequential scan
void Decoder::arith_sequential(Component& c, int16_t* coef) {
  int v;
  if (!arith_dc_diff(c, &v)) return;
  c.dc_pred = (c.dc_pred + v) & 0xffff;
  coef[0] = (int16_t)c.dc_pred;
  const int tbl = c.ta;
  for (int k = 1; k <= 63; ++k) {
    uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
    if (arith_decode(st)) break;  // EOB
    while (arith_decode(st + 1) == 0) {
      st += 3;
      if (++k > 63) {
        warn("Corrupt JPEG data: bad arithmetic code");
        ac_ct_ = -1;
        return;
      }
    }
    int x = arith_ac_value(tbl, k, st + 2);
    if (ac_ct_ == -1) return;
    coef[kZigzag[k]] = (int16_t)x;
  }
}

// jdarith.c decode_mcu_DC_first, decode_mcu_AC_first, decode_mcu_AC_refine
// (decode_mcu_DC_refine is dc_refine's bit from the fixed bin)
void Decoder::arith_dc_first(Component& c, int16_t* coef) {
  int v;
  if (!arith_dc_diff(c, &v)) return;
  c.dc_pred = (c.dc_pred + v) & 0xffff;
  coef[0] = (int16_t)((unsigned)c.dc_pred << al_);
}

void Decoder::arith_ac_first(Component& c, int16_t* coef) {
  const int tbl = c.ta;
  for (int k = ss_; k <= se_; ++k) {
    uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
    if (arith_decode(st)) break;  // EOB
    while (arith_decode(st + 1) == 0) {
      st += 3;
      if (++k > se_) {
        warn("Corrupt JPEG data: bad arithmetic code");
        ac_ct_ = -1;
        return;
      }
    }
    int x = arith_ac_value(tbl, k, st + 2);
    if (ac_ct_ == -1) return;
    coef[kZigzag[k]] = (int16_t)((unsigned)x << al_);
  }
}

void Decoder::arith_ac_refine(Component& c, int16_t* coef) {
  const int tbl = c.ta;
  const int p1 = 1 << al_, m1 = -1 * (1 << al_);
  int kex = se_;  // the previous stage's end of block
  for (; kex > 0; --kex)
    if (coef[kZigzag[kex]]) break;
  for (int k = ss_; k <= se_; ++k) {
    uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
    if (k > kex && arith_decode(st)) break;  // EOB
    for (;;) {
      int16_t* x = coef + kZigzag[k];
      if (*x) {  // nonzero before: a correction bit
        if (arith_decode(st + 2)) *x = (int16_t)(*x + (*x < 0 ? m1 : p1));
        break;
      }
      if (arith_decode(st + 1)) {  // newly nonzero
        *x = (int16_t)(arith_decode(fixed_bin_) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se_) {
        warn("Corrupt JPEG data: bad arithmetic code");
        ac_ct_ = -1;
        return;
      }
    }
  }
}

// jdhuff.c / jdphuff.c / jdarith.c process_restart: drop the buffered
// bits, read RSTn; where another marker stands there, libjpeg's
// jpeg_resync_to_restart (jdmarker.c) decides by its distance
void Decoder::restart(int expected) {
  int discarded = arith_ ? 0 : real_ / 8;
  bits_ = 0;
  nbits_ = 0;
  real_ = 0;
  int marker = next_marker(discarded);
  bool unread = false;
  if (marker != 0xD0 + expected) {
    char msg[96];
    snprintf(msg, sizeof msg,
             "Corrupt JPEG data: found marker 0x%02x instead of RST%d",
             marker, expected);
    warn(msg);
    for (;;) {
      int action;
      if (marker < 0xC0)
        action = 2;  // not a valid marker: scan on
      else if (marker < 0xD0 || marker > 0xD7)
        action = 3;  // a marker that is not RSTn: leave it unread
      else if (marker == 0xD0 + ((expected + 1) & 7) ||
               marker == 0xD0 + ((expected + 2) & 7))
        action = 3;  // one of the next two restarts: this segment is empty
      else if (marker == 0xD0 + ((expected + 7) & 7) ||
               marker == 0xD0 + ((expected + 6) & 7))
        action = 2;  // an earlier restart: scan on
      else
        action = 1;  // the expected one or far away: take it as read
      if (action == 1) break;
      if (action == 3) {
        unread = true;
        break;
      }
      marker = next_marker();
    }
  }
  if (unread) {
    pos_ = marker_pos_;  // the data segment is empty: zeros from here
    hit_marker_ = true;
  } else {
    hit_marker_ = false;
    insufficient_ = false;
  }
  eobrun_ = 0;
  start_entropy();
}

// the entropy decoder's state at the start of a scan or restart interval
void Decoder::start_entropy() {
  for (auto* c : sc_) {
    c->dc_pred = 0;
    c->dc_context = 0;
    if (arith_) {
      if (!progressive_ || (ss_ == 0 && ah_ == 0))
        memset(dc_stats_[c->td], 0, sizeof dc_stats_[0]);
      if (!progressive_ || ss_)
        memset(ac_stats_[c->ta], 0, sizeof ac_stats_[0]);
    }
  }
  ac_c_ = 0;
  ac_a_ = 0;
  ac_ct_ = -16;  // two bytes are read into C first
}

void Decoder::decode_block(Component& c, int16_t* coef) {
  if (arith_) {
    if (progressive_ && ss_ == 0 && ah_) {  // runs even after an error
      if (arith_decode(fixed_bin_)) coef[0] = (int16_t)(coef[0] | (1 << al_));
      return;
    }
    if (ac_ct_ == -1) return;
    if (!progressive_)
      arith_sequential(c, coef);
    else if (ss_ == 0)
      arith_dc_first(c, coef);
    else
      ah_ ? arith_ac_refine(c, coef) : arith_ac_first(c, coef);
    return;
  }
  if (!progressive_)
    decode_sequential(c, coef);
  else if (ss_ == 0)
    ah_ ? dc_refine(coef) : dc_first(c, coef);
  else
    ah_ ? ac_refine(c, coef) : ac_first(c, coef);
}

void Decoder::decode_mcu(int64_t m) {
  if (sc_.size() == 1) {  // one block an MCU, over the component's blocks
    Component& c = *sc_[0];
    decode_block(c, c.block((int)(m % c.bw), (int)(m / c.bw)));
    return;
  }
  int mx = (int)(m % mcux_), my = (int)(m / mcux_);
  for (auto* c : sc_)
    for (int by = 0; by < c->v; ++by)
      for (int bx = 0; bx < c->h; ++bx)
        decode_block(*c, c->block(mx * c->h + bx, my * c->v + by));
}

// the iMCU row (jdcoefct.c's input_iMCU_row) of the scan's MCU m
int Decoder::imcu_row(int64_t m) const {
  if (sc_.size() > 1) return (int)(m / mcux_);
  const Component& c = *sc_[0];
  return (int)(m / c.bw) / c.fv;
}

void Decoder::scan(int64_t len) {
  int ns = byte();
  // jdmarker.c get_sos
  if (len != 2 * ns + 6 || ns < 1 || ns > 4 || ns > (int)comps_.size())
    throw Error{"bad scan header"};
  sc_.clear();
  for (int i = 0; i < ns; ++i) {
    int id = byte(), t = byte();
    Component* c = nullptr;
    for (auto& cc : comps_)
      if (cc.id == id) c = &cc;
    if (!c || std::find(sc_.begin(), sc_.end(), c) != sc_.end())
      throw Error{"scan names an unknown component"};
    c->td = t >> 4;
    c->ta = t & 15;
    sc_.push_back(c);
  }
  ss_ = byte();
  se_ = byte();
  int ahal = byte();
  ah_ = ahal >> 4;
  al_ = ahal & 15;
  ++scans_;
  if (lossless_) {
    lossless_scan();
    return;
  }
  if (!progressive_) {
    // libjpeg warns of other values and decodes the scan as sequential
    ss_ = 0;
    se_ = 63;
    ah_ = al_ = 0;
  } else {
    // jdphuff.c / jdarith.c start_pass's checks and progression status
    bool bad = ss_ == 0 ? se_ != 0 : (ss_ > se_ || se_ > 63 || ns != 1);
    if ((ah_ && al_ != ah_ - 1) || al_ > 13) bad = true;
    if (bad) throw Error{"bad progressive scan parameters"};
    for (auto* c : sc_) {
      for (int k = std::min(ss_, 1); k <= std::max(se_, 9); ++k)
        c->prev_bits[k] = scans_ > 1 ? c->coef_bits[k] : 0;
      for (int k = ss_; k <= se_; ++k) c->coef_bits[k] = al_;
    }
  }
  // the Huffman tables the scan reads, and the quantization tables
  // latched at a component's first scan (jdinput.c latch_quant_tables)
  for (auto* c : sc_) {
    bool dc = !progressive_ || (ss_ == 0 && ah_ == 0);
    bool ac = !progressive_ || ss_ > 0;
    if (!arith_ && ((dc && c->td > 3) || (ac && c->ta > 3)))
      throw Error{"scan uses an undefined Huffman table"};
    if (!arith_ && dc) derive(dc_[c->td], true, false);
    if (!arith_ && ac) derive(ac_[c->ta], false, false);
    if (!c->latched) {
      if (!q_defined_[c->tq]) throw Error{"undefined quantization table"};
      memcpy(c->q, q_[c->tq], sizeof c->q);
      c->latched = true;
    }
  }
  eobrun_ = 0;
  bits_ = 0;
  nbits_ = 0;
  real_ = 0;
  hit_marker_ = false;
  insufficient_ = false;
  start_entropy();
  int64_t total = ns == 1 ? (int64_t)sc_[0]->bw * sc_[0]->bh
                          : (int64_t)mcux_ * mcuy_;
  int rst = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (restart_ && m > 0 && m % restart_ == 0) {
      restart(rst);
      rst = (rst + 1) & 7;
    }
    // jdcoefct.c: the iMCU row of the last MCU begun with data in hand
    if (!insufficient_) last_good_ = imcu_row(m);
    if (arith_ || !insufficient_) decode_mcu(m);
  }
  bits_ = 0;
  nbits_ = 0;
  real_ = 0;
}


// jdlhuff.c, jddiffct.c and jdlossls.c: each sample's difference (a
// DC-style category, 16 meaning 32768) undone by the scan's predictor
// (Ss, 1-7) over the row above and the sample to the left; the first row
// of the image and of each restart interval predicts from the left (its
// first sample from 1 << (7 - Pt)), the first column from above. An MCU
// is h x v samples of each component of an interleaved scan (the samples
// past a component's edge decoded and dropped), one of a scan of one
// component; restarts fall on MCU-row boundaries
void Decoder::lossless_scan() {
  const int predictor = ss_;
  if (predictor < 1 || predictor > 7 || al_ > 7)
    throw Error{"bad lossless scan parameters"};
  const int ns = (int)sc_.size();
  const int mcus_per_row = ns == 1 ? sc_[0]->dw : (width + hmax_ - 1) / hmax_;
  const int mcu_rows = ns == 1 ? sc_[0]->dh : (height + vmax_ - 1) / vmax_;
  if (restart_ && restart_ % mcus_per_row)
    throw Error{std::string(kRefused) + "a lossless restart interval of "
                "part of an MCU row"};
  struct Plane {
    Component* c;
    int uh, uv;              // samples of an MCU across and down
    int64_t pw;              // samples a row of diff, MCU-padded
    std::vector<int> diff;   // one MCU row of differences
    uint16_t* out;
  };
  std::vector<Plane> planes(ns);
  for (int k = 0; k < ns; ++k) {
    Component& c = *sc_[k];
    if (c.td > 3) throw Error{"scan uses an undefined Huffman table"};
    derive(dc_[c.td], true, true);
    if (!c.latched) {
      memset(c.q, 0, sizeof c.q);
      c.latched = true;
    }
    const size_t ci = (size_t)(&c - comps_.data());
    samples_[ci].assign((size_t)c.dw * c.dh, 0);
    Plane& p = planes[k];
    p.c = &c;
    p.uh = ns == 1 ? 1 : c.h;
    p.uv = ns == 1 ? 1 : c.v;
    p.pw = (int64_t)mcus_per_row * p.uh;
    p.diff.assign((size_t)(p.pw * p.uv), 0);
    p.out = samples_[ci].data();
  }
  bits_ = 0;
  nbits_ = 0;
  real_ = 0;
  hit_marker_ = false;
  insufficient_ = false;
  const int rows_per_restart = restart_ ? restart_ / mcus_per_row : 0;
  int rows_to_go = rows_per_restart, rst = 0;
  bool first_row = true;
  for (int my = 0; my < mcu_rows; ++my) {
    if (restart_ && my > 0 && rows_to_go == 0) {
      restart(rst);
      rst = (rst + 1) & 7;
      rows_to_go = rows_per_restart;
      first_row = true;
    }
    for (int mx = 0; mx < mcus_per_row; ++mx) {
      for (auto& p : planes) {
        for (int dy = 0; dy < p.uv; ++dy) {
          for (int dx = 0; dx < p.uh; ++dx) {
            int d = 0;
            if (!insufficient_) {
              int s = decode_huff(dc_[p.c->td]);
              if (s == 16)
                d = 32768;
              else if (s)
                d = extend(get_bits(s), s);
            }
            p.diff[(size_t)(dy * p.pw + (int64_t)mx * p.uh + dx)] = d;
          }
        }
      }
    }
    for (auto& p : planes) {
      const int w = p.c->dw;
      for (int dy = 0; dy < p.uv; ++dy) {
        const int y = my * p.uv + dy;
        if (y >= p.c->dh) break;
        uint16_t* row = p.out + (int64_t)y * w;
        const uint16_t* up = row - w;
        const int* dk = p.diff.data() + (size_t)(dy * p.pw);
        const bool first = first_row && dy == 0;
        for (int x = 0; x < w; ++x) {
          int pred;
          if (first) {
            pred = x ? row[x - 1] : 1 << (7 - al_);
          } else if (x == 0) {
            pred = up[0];
          } else {
            const int64_t a = row[x - 1], b = up[x], cc = up[x - 1];
            switch (predictor) {
              case 1: pred = (int)a; break;
              case 2: pred = (int)b; break;
              case 3: pred = (int)cc; break;
              case 4: pred = (int)(a + b - cc); break;
              case 5: pred = (int)(a + ((b - cc) >> 1)); break;
              case 6: pred = (int)(b + ((a - cc) >> 1)); break;
              default: pred = (int)((a + b) >> 1); break;
            }
          }
          row[x] = (uint16_t)((dk[x] + pred) & 0xFFFF);
        }
      }
    }
    first_row = false;
    if (restart_) --rows_to_go;
  }
  bits_ = 0;
  nbits_ = 0;
  real_ = 0;
}

// jdcoefct.c smoothing_ok (SAVED_COEFS 10): the latched coef_bits of
// coefficients 0-9 (now, and before each component's last scan) where
// smoothing applies
bool Decoder::smoothing_ok(std::vector<int>& latch) const {
  if (!progressive_) return false;
  static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  const size_t nc = comps_.size();
  latch.assign(2 * nc * 10, -1);
  for (size_t ci = 0; ci < nc; ++ci) {
    const Component& c = comps_[ci];
    if (!c.latched) return false;
    for (int p : kPos)
      if (c.q[p] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    latch[ci * 10] = c.coef_bits[0];
    for (int k = 1; k < 10; ++k) {
      latch[(nc + ci) * 10 + k] = scans_ > 1 ? c.prev_bits[k] : -1;
      latch[ci * 10 + k] = c.coef_bits[k];
      if (c.coef_bits[k] != 0) useful = true;
    }
  }
  return useful;
}

// jidctint.c's "islow" inverse DCT as libjpeg-turbo runs it on x86-64,
// its SIMD version (jidctint-sse2.asm / -avx2.asm): the same sums, in
// 16-bit lanes where the SIMD code keeps them (dequantized coefficients
// wrap, as pmullw's low half; the sums in0 +- in4 and the odd part's z3,
// z4 wrap), 32-bit lanes wrapping elsewhere, pass 1's results saturated
// to 16 bits (packssdw), and the output saturated to 8 bits around 128
// (packssdw, packsswb). A block whose rows 1-7 are all zero takes the
// SIMD code's shortcut, its row 0 dequantized and shifted in 16 bits.
// For coefficients a valid file holds this is jidctint.c's arithmetic
// exactly; past 16 bits (corrupt data) it is the SIMD code's.
constexpr int kConstBits = 13, kPass1Bits = 2;

inline int16_t wrap16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int32_t wrap32(int64_t x) { return (int32_t)(uint32_t)(uint64_t)x; }
inline int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
inline int32_t sub32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
inline int16_t sat16(int32_t x) {
  return (int16_t)(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
}
// pmaddwd: a * ca + b * cb of 16-bit lanes into a 32-bit lane
inline int32_t madd(int16_t a, int ca, int16_t b, int cb) {
  return add32(a * ca, b * cb);
}

// one 8-point pass over in[0], in[s], ..., in[7 s]: the sums before
// their descaling, in output order 0-7
void idct_pass(const int16_t* in, int s, int32_t* out) {
  const int16_t in0 = in[0], in1 = in[s], in2 = in[2 * s], in3 = in[3 * s],
                in4 = in[4 * s], in5 = in[5 * s], in6 = in[6 * s],
                in7 = in[7 * s];
  const int32_t tmp0 = (int32_t)wrap16(in0 + in4) * (1 << kConstBits);
  const int32_t tmp1 = (int32_t)wrap16(in0 - in4) * (1 << kConstBits);
  const int32_t tmp3 = madd(in2, 4433 + 6270, in6, 4433);
  const int32_t tmp2 = madd(in2, 4433, in6, 4433 - 15137);
  const int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
  const int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
  const int16_t z3 = wrap16(in7 + in3), z4 = wrap16(in5 + in1);
  const int32_t z3p = madd(z3, 9633 - 16069, z4, 9633);
  const int32_t z4p = madd(z3, 9633, z4, 9633 - 3196);
  const int32_t t0 = add32(madd(in7, 2446 - 7373, in1, -7373), z3p);
  const int32_t t3 = add32(madd(in7, -7373, in1, 12299 - 7373), z4p);
  const int32_t t1 = add32(madd(in5, 16819 - 20995, in3, -20995), z4p);
  const int32_t t2 = add32(madd(in5, -20995, in3, 25172 - 20995), z3p);
  out[0] = add32(tmp10, t3);
  out[7] = sub32(tmp10, t3);
  out[1] = add32(tmp11, t2);
  out[6] = sub32(tmp11, t2);
  out[2] = add32(tmp12, t1);
  out[5] = sub32(tmp12, t1);
  out[3] = add32(tmp13, t0);
  out[4] = sub32(tmp13, t0);
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int64_t stride) {
  int16_t ws[64];
  bool ac_zero = true;  // rows 1-7 of the block all zero
  for (int k = 8; k < 64; ++k)
    if (coef[k]) ac_zero = false;
  if (ac_zero) {
    for (int col = 0; col < 8; ++col) {
      const int16_t dc =
          wrap16(wrap16((int32_t)coef[col] * q[col]) * (1 << kPass1Bits));
      for (int row = 0; row < 8; ++row) ws[row * 8 + col] = dc;
    }
  } else {
    int16_t deq[64];
    for (int k = 0; k < 64; ++k) deq[k] = wrap16((int32_t)coef[k] * q[k]);
    const int n = kConstBits - kPass1Bits;
    for (int col = 0; col < 8; ++col) {
      int32_t sums[8];
      idct_pass(deq + col, 8, sums);
      for (int row = 0; row < 8; ++row)
        ws[row * 8 + col] = sat16(add32(sums[row], 1 << (n - 1)) >> n);
    }
  }
  const int n = kConstBits + kPass1Bits + 3;
  for (int row = 0; row < 8; ++row) {
    int32_t sums[8];
    idct_pass(ws + row * 8, 1, sums);
    uint8_t* o = out + row * stride;
    for (int x = 0; x < 8; ++x) {
      int v = sat16(add32(sums[x], 1 << (n - 1)) >> n);
      v = v < -128 ? -128 : v > 127 ? 127 : v;  // packsswb
      o[x] = (uint8_t)(v + 128);
    }
  }
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 3.1): each block's
// coefficients 1-9 that are still zero and not known to full precision
// estimated from the DC values of its 5 x 5 neighbourhood of blocks (and
// the DC itself too where no AC coefficient has been sent), then the
// inverse DCT. The neighbourhood's rows follow libjpeg's arithmetic by
// iMCU row, quirks included.
namespace {
inline int smooth_pred(int64_t q00num, int64_t qxx, int al) {
  int pred;
  if (q00num >= 0) {
    pred = (int)(((qxx << 7) + q00num) / (qxx << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = (int)(((qxx << 7) - q00num) / (qxx << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return pred;
}
}  // namespace

void Decoder::idct_component(Component& c, int ci,
                             const std::vector<int>* latch, uint8_t* p,
                             int64_t pw) {
  if (!latch) {
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.block(bx, by), c.q, p + by * 8 * pw + bx * 8, pw);
    return;
  }
  const int nc = (int)comps_.size();
  const int V = c.fv;
  const int T = (height + 8 * fvmax_ - 1) / (8 * fvmax_);  // total_iMCU_rows
  const int last_row = T - 1, last_col = c.bw - 1;
  const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16],
                Q11 = c.q[9], Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10],
                Q21 = c.q[17], Q30 = c.q[24];
  int16_t ws[64];
  for (int R = 0; R < T; ++R) {
    int block_rows = V;
    if (R == last_row) {
      block_rows = c.bh % V;
      if (block_rows == 0) block_rows = V;
    }
    // an iMCU row the last scan did not reach keeps the state before it
    const int* bits = latch->data() + (R > last_good_ ? nc + ci : ci) * 10;
    bool change_dc = true;
    for (int k = 1; k < 10; ++k)
      if (bits[k] != -1) change_dc = false;
    const int image_block_rows = block_rows * T;
    for (int b = 0; b < block_rows; ++b) {
      const int ibr = R * block_rows + b, row = R * V + b;
      if (row >= c.bh) break;
      const int prow = ibr > 0 ? row - 1 : row;
      const int pprow = ibr > 1 ? row - 2 : prow;
      const int nrow = ibr < image_block_rows - 1 ? row + 1 : row;
      const int nnrow = ibr < image_block_rows - 2 ? row + 2 : nrow;
      auto dc = [&](int r, int col) { return (int)c.block(col, r)[0]; };
      int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11,
          DC12, DC13, DC14, DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22,
          DC23, DC24, DC25;
      DC01 = DC02 = DC03 = DC04 = DC05 = dc(pprow, 0);
      DC06 = DC07 = DC08 = DC09 = DC10 = dc(prow, 0);
      DC11 = DC12 = DC13 = DC14 = DC15 = dc(row, 0);
      DC16 = DC17 = DC18 = DC19 = DC20 = dc(nrow, 0);
      DC21 = DC22 = DC23 = DC24 = DC25 = dc(nnrow, 0);
      for (int bn = 0; bn <= last_col; ++bn) {
        memcpy(ws, c.block(bn, row), sizeof ws);
        if (bn == 0 && bn < last_col) {
          DC04 = DC05 = dc(pprow, bn + 1);
          DC09 = DC10 = dc(prow, bn + 1);
          DC14 = DC15 = dc(row, bn + 1);
          DC19 = DC20 = dc(nrow, bn + 1);
          DC24 = DC25 = dc(nnrow, bn + 1);
        }
        if (bn + 1 < last_col) {
          DC05 = dc(pprow, bn + 2);
          DC10 = dc(prow, bn + 2);
          DC15 = dc(row, bn + 2);
          DC20 = dc(nrow, bn + 2);
          DC25 = dc(nnrow, bn + 2);
        }
        int al;
        int64_t num;
        if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
          num = Q00 * (change_dc
                           ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 +
                              13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11 +
                              38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
                              13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                              DC24 + DC25)
                           : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = (int16_t)smooth_pred(num, Q01, al);
        }
        if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
          num = Q00 * (change_dc
                           ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 -
                              DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09 -
                              DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                              13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 +
                              3 * DC24 + DC25)
                           : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = (int16_t)smooth_pred(num, Q10, al);
        }
        if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
          num = Q00 * (change_dc
                           ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 -
                              5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17 +
                              7 * DC18 + 2 * DC19 + DC23)
                           : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 -
                              DC23));
          ws[16] = (int16_t)smooth_pred(num, Q20, al);
        }
        if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
          num = Q00 * (change_dc
                           ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                              9 * DC19 + DC21 - DC25)
                           : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 -
                              DC20 + DC22 - DC24 + DC04 - DC06 + 10 * DC07 -
                              10 * DC09));
          ws[9] = (int16_t)smooth_pred(num, Q11, al);
        }
        if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
          num = Q00 * (change_dc
                           ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 +
                              7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
                              2 * DC17 - 5 * DC18 + 2 * DC19)
                           : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 -
                              DC15));
          ws[2] = (int16_t)smooth_pred(num, Q02, al);
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0) {  // AC03
            num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
            ws[3] = (int16_t)smooth_pred(num, Q03, al);
          }
          if ((al = bits[7]) != 0 && ws[10] == 0) {  // AC12
            num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
            ws[10] = (int16_t)smooth_pred(num, Q12, al);
          }
          if ((al = bits[8]) != 0 && ws[17] == 0) {  // AC21
            num = Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
            ws[17] = (int16_t)smooth_pred(num, Q21, al);
          }
          if ((al = bits[9]) != 0 && ws[24] == 0) {  // AC30
            num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
            ws[24] = (int16_t)smooth_pred(num, Q30, al);
          }
          num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 -
                       2 * DC05 - 6 * DC06 + 6 * DC07 + 42 * DC08 +
                       6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                       152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 +
                       6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                       2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          ws[0] = (int16_t)smooth_pred(num, Q00, 0);
        }
        idct_islow(ws, c.q, p + (int64_t)row * 8 * pw + bn * 8, pw);
        DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
        DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
        DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
        DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
        DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
      }
    }
  }
}

// A component's samples at the output's size (width x height): its blocks
// through the IDCT (block-smoothed where latch is given), then jdsample.c's upsampling for its ratio. The rows
// above the first and below the last (dh) repeat them (jdmainct.c's
// context pointers); the fancy filters read no column past dw.
void Decoder::plane(Component& c, int ci, const std::vector<int>* latch,
                    std::vector<uint8_t>& full) {
  const int64_t pw = (int64_t)c.bw * 8;
  std::vector<uint8_t> p((size_t)pw * c.bh * 8);
  // jdsample.c: no upsampling method for a fractional ratio (a gray read
  // of YCbCr needs the luma alone, whose ratio is 1)
  if (hmax_ % c.h || vmax_ % c.v)
    throw Error{std::string(kRefused) + "fractional sampling ratios"};
  idct_component(c, ci, latch, p.data(), pw);
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
  if (!progressive_ && !arith_ && !lossless_) {  // jinit_huff_decoder alone
    std_table(dc_[0], kDcLumaCounts, kDcValues);
    std_table(ac_[0], kAcLumaCounts, kAcLumaValues);
    std_table(dc_[1], kDcChromaCounts, kDcValues);
    std_table(ac_[1], kAcChromaCounts, kAcChromaValues);
  }
  pos_ = sos_pos_;
  int m = 0xDA;
  bool scanned = false;
  while (m != 0xD9) {
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {  // parameterless: ignored
      m = next_marker();
      continue;
    }
    if (!(m == 0xDA || m == 0xC4 || m == 0xDB || m == 0xDD || m == 0xCC ||
          m == 0xDC || (m >= 0xE0 && m <= 0xEF) || m == 0xFE))
      throw Error{"unexpected marker after a scan"};
    int64_t start = pos_;
    int64_t len = u16();
    int64_t end = start + len;
    if (len < 2) throw Error{"bad segment length"};
    if (m == 0xDA) {
      scan(len);
      scanned = true;
      // one sequential scan of every component: libjpeg has put out the
      // image before it reads on, and cv2 keeps it whatever follows
      if (!progressive_ && scans_ == 1 && sc_.size() == comps_.size()) break;
    } else {
      if (m == 0xC4)
        read_dht(end);
      else if (m == 0xDB)
        read_dqt(end);
      else if (m == 0xCC)
        read_dac(end);
      else if (m == 0xDD) {
        if (len != 4) throw Error{"bad DRI length"};
        restart_ = u16();
      }
      pos_ = end;
    }
    m = next_marker();
  }
  if (!scanned) throw Error{"no scan"};
  if (lossless_) {
    // libjpeg-turbo converts no colour in lossless mode: gray to gray, RGB
    // to BGR and CMYK (which cv2 converts itself) alone
    const bool ok = space_ == Space::kCMYK ||
                    (space_ == Space::kGray && channels == 1) ||
                    (space_ == Space::kRGB && channels == 3);
    if (!ok)
      throw Error{std::string(kRefused) + "a colour conversion of lossless "
                  "JPEG"};
    const int64_t npix = (int64_t)width * height;
    // each component at full size: libjpeg-turbo upsamples by replication
    // in lossless mode (h2v1 / h2v2 / int_upsample: no fancy filter)
    std::vector<uint8_t> full[4];
    for (size_t ci = 0; ci < comps_.size(); ++ci) {
      const Component& c = comps_[ci];
      if (samples_[ci].size() != (size_t)c.dw * c.dh)
        samples_[ci].assign((size_t)c.dw * c.dh, 0);  // never scanned
      const int he = hmax_ / c.h, ve = vmax_ / c.v;
      full[ci].resize((size_t)npix);
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x)
          full[ci][(int64_t)y * width + x] = (uint8_t)(
              samples_[ci][(int64_t)(y / ve) * c.dw + x / he] << al_);
    }
    auto at = [&](int ci, int64_t i) { return (int)full[ci][i]; };
    for (int64_t i = 0; i < npix; ++i) {
      if (space_ == Space::kGray) {
        out[i] = (uint8_t)at(0, i);
      } else if (space_ == Space::kRGB) {
        out[i * 3] = (uint8_t)at(2, i);
        out[i * 3 + 1] = (uint8_t)at(1, i);
        out[i * 3 + 2] = (uint8_t)at(0, i);
      } else {
        const int k = at(3, i);
        const int c = k - ((255 - at(0, i)) * k >> 8);
        const int mm = k - ((255 - at(1, i)) * k >> 8);
        const int yy = k - ((255 - at(2, i)) * k >> 8);
        if (channels == 3) {
          out[i * 3] = (uint8_t)yy;
          out[i * 3 + 1] = (uint8_t)mm;
          out[i * 3 + 2] = (uint8_t)c;
        } else {
          out[i] = (uint8_t)((yy * 1868 + mm * 9617 + c * 4899 + 8192) >> 14);
        }
      }
    }
    return;
  }
  std::vector<int> latch;
  const std::vector<int>* smooth = smoothing_ok(latch) ? &latch : nullptr;

  const int64_t npix = (int64_t)width * height;
  std::vector<uint8_t> p[4];
  if (space_ == Space::kGray || (space_ == Space::kYCbCr && channels == 1)) {
    plane(comps_[0], 0, smooth, p[0]);
    for (int64_t i = 0; i < npix; ++i)
      for (int ch = 0; ch < channels; ++ch) out[i * channels + ch] = p[0][i];
    return;
  }
  for (size_t ci = 0; ci < comps_.size(); ++ci)
    plane(comps_[ci], (int)ci, smooth, p[ci]);
  static const YccTables t;
  if (space_ == Space::kRGB) {
    for (int64_t i = 0; i < npix; ++i) {
      const int r = p[0][i], g = p[1][i], b = p[2][i];
      if (channels == 3) {  // rgb_rgb_convert, written B, G, R
        out[i * 3] = (uint8_t)b;
        out[i * 3 + 1] = (uint8_t)g;
        out[i * 3 + 2] = (uint8_t)r;
      } else {  // rgb_gray_convert: FIX(0.299), FIX(0.587), FIX(0.114)
        out[i] = (uint8_t)((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
      }
    }
    return;
  }
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
                           int32_t channels, char* warning, int warnlen,
                           char* err, int errlen) {
  try {
    if (channels != 1 && channels != 3) throw Error{"channels must be 1 or 3"};
    Decoder dec(data, n);
    dec.header();
    dec.decode(out, channels);
    snprintf(warning, warnlen, "%s", dec.warning.c_str());
    return 0;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}
