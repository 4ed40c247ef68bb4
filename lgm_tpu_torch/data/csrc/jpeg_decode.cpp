// JPEG decoding (ITU-T T.81), host code with no image library.
//
// Reads sequential (SOF0, SOF1) and progressive (SOF2) Huffman-coded frames
// of 8-bit samples with one (gray) or three components at any integral
// sampling factors, and computes what libjpeg-turbo computes at its
// defaults, bit for bit:
//   - progressive scans (T.81 G.1.2, jdphuff.c): DC first and refinement
//     scans, interleaved or not; AC first and refinement scans of one
//     component, with end-of-band runs and correction bits; restart
//     intervals in any scan. They fill a whole-image coefficient buffer,
//     each non-interleaved scan walking its component's own block grid;
//     after the last scan every block goes through the same IDCT,
//     upsampling and colour conversion as a sequential file's. A file
//     whose scans leave any coefficient short of full precision is refused:
//     libjpeg would then smooth the blocks (jdcoefct.c's
//     decompress_smooth_data), which this decoder does not;
//   - the JDCT_ISLOW inverse DCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2,
//     its range-limit table, whose wrap for out-of-range values is kept);
//   - jdsample.c's fancy upsampling: h2v1 and h2v2 where the downsampled
//     width is over 2 (box replication otherwise), h1v2 always, any other
//     integral ratio by box replication; edges replicate the component's
//     own downsampled width and height, as jdmainct.c's context rows do;
//   - jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16); no merged upsampler,
//     which libjpeg skips when fancy upsampling is on;
//   - the colour space of jdapimin.c's default_decompress_parms: one
//     component is gray; three are YCbCr under JFIF, else RGB under an
//     Adobe APP14 transform of 0, else RGB for component ids 'R' 'G' 'B',
//     else YCbCr. EXIF orientation is not applied.
// It refuses, with an error message, what it does not read: lossless,
// hierarchical and arithmetic-coded frames, 12-bit samples, four components
// (CMYK/YCCK), DNL, sequential scans that interleave fewer components than
// the frame has, progressive files short of full refinement or whose scan
// order libjpeg warns about, and truncated or corrupt data or a missing
// table (where libjpeg would warn and pad, or substitute its standard
// tables).
//
// Called through ctypes (which releases the GIL) by
// lgm_tpu_torch/io/jpeg.py. Plain C interface, built with the host
// compiler by lgm_tpu_torch/ops/_build.py::build_host.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

// Zigzag index -> natural (row-major) index.
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int64_t kMaxPixels = int64_t(1) << 26;
const char kDnl[] = "DNL (image height defined after the scan) is not read";
const int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t bits[17] = {};  // codes of each length 1-16
  uint8_t vals[256] = {};
  int nvals = 0;
  // Canonical decoding (T.81 F.2.2.3) for codes longer than kLookBits.
  int32_t mincode[17] = {}, maxcode[17] = {}, valptr[17] = {};
  // (length << 8) | symbol for every kLookBits-bit prefix; 0 where the code
  // is longer.
  uint16_t look[1 << kLookBits] = {};

  // jdhuff.c::jpeg_make_d_derived_tbl: the code of each symbol; a table
  // whose codes overflow their length (one past a length's last code must
  // still fit in its bits), or a DC table with a symbol over 15, is
  // refused.
  void derive(bool dc) {
    int code = 0, k = 0;
    std::memset(look, 0, sizeof(look));
    for (int l = 1; l <= 16; ++l) {
      if (code + bits[l] >= (1 << l))
        fail("corrupt data: bad Huffman table");
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        if (l <= kLookBits) {
          const int shift = kLookBits - l;
          for (int j = 0; j < (1 << shift); ++j)
            look[(code << shift) | j] = uint16_t((l << 8) | vals[k]);
        }
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    if (dc)
      for (int i = 0; i < nvals; ++i)
        if (vals[i] > 15) fail("corrupt data: bad DC Huffman table");
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;        // downsampled width and height (samples)
  int bw = 0, bh = 0;        // blocks in the coded plane
  int td = 0, ta = 0, pred = 0;
  // The quantisation table, copied at the component's first scan, as
  // jdinput.c::latch_quant_tables does (a later DQT does not change it).
  bool latched = false;
  uint16_t qt[64] = {};
  std::vector<uint8_t> plane;  // bw * 8 columns, bh * 8 rows
  // Progressive frames: the MCU-padded block grid's coefficients (natural
  // order, bw x bh blocks) and, for each coefficient, the point transform
  // Al of the last scan that coded it (-1 before any), as libjpeg's
  // coef_bits.
  std::vector<int16_t> coef;
  int coef_bits[64];
};

// The entropy-coded segment's bits. Stuffed bytes (FF 00) read as FF; at a
// marker (or the end of the data) the reader supplies zero bits, as
// libjpeg's fill_bit_buffer does, but consuming any of them is an error:
// the data was truncated or corrupt.
struct BitReader {
  const uint8_t* data;
  size_t n;
  size_t pos;
  uint64_t acc = 0;
  int nbits = 0;
  int phantom = 0;  // zero bits at the bottom of acc that are not data
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      int b = 0;
      if (!at_marker) {
        if (pos >= n) {
          at_marker = true;
        } else if (data[pos] != 0xFF) {
          b = data[pos++];
        } else {
          size_t q = pos + 1;
          while (q < n && data[q] == 0xFF) ++q;
          if (q < n && data[q] == 0) {
            b = 0xFF;
            pos = q + 1;
          } else {
            at_marker = true;  // pos stays on the marker's first FF
          }
        }
      }
      if (at_marker) phantom += 8;
      acc = (acc << 8) | uint64_t(b);
      nbits += 8;
    }
  }
  void consume(int k) {
    nbits -= k;
    if (nbits < phantom) fail("truncated or corrupt entropy-coded data");
  }
  int peek(int k) {
    if (nbits < k) fill();
    return int((acc >> (nbits - k)) & ((uint64_t(1) << k) - 1));
  }
  int get(int k) {
    if (k == 0) return 0;
    const int v = peek(k);
    consume(k);
    return v;
  }
  int decode(const Huffman& t) {
    const int look = peek(16) >> (16 - kLookBits);
    const int entry = t.look[look];
    if (entry) {
      consume(entry >> 8);
      return entry & 0xFF;
    }
    const int code16 = peek(16);
    for (int l = kLookBits + 1; l <= 16; ++l) {
      const int code = code16 >> (16 - l);
      if (t.bits[l] && code <= t.maxcode[l] && code >= t.mincode[l]) {
        consume(l);
        return t.vals[t.valptr[l] + code - t.mincode[l]];
      }
    }
    fail("corrupt data: bad Huffman code");
  }
  // Drop the bits left in the current byte and the prefetched bytes: the
  // reader restarts at `pos` (a restart marker or the segment's end).
  void reset() {
    acc = 0;
    nbits = 0;
    phantom = 0;
    at_marker = false;
  }
  // Byte offset of the first byte not yet consumed as bits.
  size_t consumed_pos() const {
    // Whole bytes still in acc were read from the data after the current
    // bit position; walk pos back over them (stuffed bytes count two).
    int real_bytes = (nbits - phantom) / 8;
    size_t p = pos;
    while (real_bytes-- > 0) {
      --p;
      if (p > 0 && data[p] == 0 && data[p - 1] == 0xFF) {
        --p;
        while (p > 0 && data[p - 1] == 0xFF) --p;
      }
    }
    return p;
  }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

// jidctint.c's range-limit table behind `IDCT_range_limit`: index
// (value & 1023), centred on 0.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = uint8_t(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = uint8_t(i - 896);
    }
  }
};
const RangeLimit kRange;

// jidctint.c::jpeg_idct_islow. JLONG is 64 bits, the workspace int.
void idct_islow(const int16_t* coef, const uint16_t* qt, uint8_t* out,
                int stride) {
  const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                F2_562 = 20995, F3_072 = 25172;
  const int CB = 13, P1 = 2;
  int ws[64];
  // ISLOW_MULT_TYPE is short: the quantisation value is taken as int16.
  auto deq = [&](int i) -> int64_t {
    return int64_t(int(coef[i]) * int(int16_t(qt[i])));
  };
  for (int c = 0; c < 8; ++c) {
    if (!coef[8 + c] && !coef[16 + c] && !coef[24 + c] && !coef[32 + c] &&
        !coef[40 + c] && !coef[48 + c] && !coef[56 + c]) {
      const int dc = int(uint32_t(deq(c)) << P1);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = deq(16 + c), z3 = deq(48 + c);
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = deq(c);
    z3 = deq(32 + c);
    int64_t tmp0 = int64_t(uint64_t(z2 + z3) << CB);
    int64_t tmp1 = int64_t(uint64_t(z2 - z3) << CB);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = deq(56 + c);
    tmp1 = deq(40 + c);
    tmp2 = deq(24 + c);
    tmp3 = deq(8 + c);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CB - P1;
    const int64_t half = int64_t(1) << (sh - 1);
    ws[0 * 8 + c] = int((tmp10 + tmp3 + half) >> sh);
    ws[7 * 8 + c] = int((tmp10 - tmp3 + half) >> sh);
    ws[1 * 8 + c] = int((tmp11 + tmp2 + half) >> sh);
    ws[6 * 8 + c] = int((tmp11 - tmp2 + half) >> sh);
    ws[2 * 8 + c] = int((tmp12 + tmp1 + half) >> sh);
    ws[5 * 8 + c] = int((tmp12 - tmp1 + half) >> sh);
    ws[3 * 8 + c] = int((tmp13 + tmp0 + half) >> sh);
    ws[4 * 8 + c] = int((tmp13 - tmp0 + half) >> sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t v =
          kRange.t[int((int64_t(w[0]) + (1 << (P1 + 2))) >> (P1 + 3)) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = int64_t(uint64_t(int64_t(w[0]) + w[4]) << CB);
    int64_t tmp1 = int64_t(uint64_t(int64_t(w[0]) - w[4]) << CB);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CB + P1 + 3;
    const int64_t half = int64_t(1) << (sh - 1);
    auto lim = [&](int64_t x) {
      return kRange.t[int((x + half) >> sh) & 1023];
    };
    o[0] = lim(tmp10 + tmp3);
    o[7] = lim(tmp10 - tmp3);
    o[1] = lim(tmp11 + tmp2);
    o[6] = lim(tmp11 - tmp2);
    o[2] = lim(tmp12 + tmp1);
    o[5] = lim(tmp12 - tmp1);
    o[3] = lim(tmp13 + tmp0);
    o[4] = lim(tmp13 - tmp0);
  }
}

inline int clamp255(int x) { return x < 0 ? 0 : (x > 255 ? 255 : x); }

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : data_(data), n_(n) {}

  // Reads the markers up to the frame header (header_only) or decodes the
  // whole file.
  void run(bool header_only) {
    if (n_ < 2 || data_[0] != 0xFF || data_[1] != 0xD8)
      fail("not a JPEG (no SOI marker)");
    pos_ = 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) {
        if (!scanned_) fail("no image data before EOI");
        if (progressive_) finish_progressive();
        return;
      }
      if (m >= 0xD0 && m <= 0xD7)
        fail("corrupt data: restart marker outside a scan");
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m == 0xC2);
        if (header_only) return;
        continue;
      }
      if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF)
        fail("lossless JPEG is not read");
      if (m == 0xC5 || m == 0xC6 || m == 0xDE || m == 0xDF)
        fail("hierarchical JPEG is not read");
      if (m == 0xC9 || m == 0xCA || m == 0xCC || m == 0xCE)
        fail("arithmetic-coded JPEG is not read");
      if (m == 0xC8) fail("JPEG extension frames are not read");
      if (m == 0xDC) fail(kDnl);
      const size_t len = segment_length();
      const uint8_t* body = data_ + pos_ + 2;
      const size_t blen = len - 2;
      switch (m) {
        case 0xC4: read_dht(body, blen); break;
        case 0xDB: read_dqt(body, blen); break;
        case 0xDD:
          if (blen != 2) fail("corrupt data: bad DRI length");
          restart_ = (body[0] << 8) | body[1];
          break;
        case 0xE0:
          if (blen >= 14 && !std::memcmp(body, "JFIF\0", 5)) jfif_ = true;
          break;
        case 0xEE:
          if (blen >= 12 && !std::memcmp(body, "Adobe", 5)) {
            adobe_ = true;
            adobe_transform_ = body[11];
          }
          break;
        case 0xDA:
          if (header_only) fail("scan before the frame header");
          pos_ += len;
          read_scan(body, blen);
          continue;
        default:
          if (!((m >= 0xE0 && m <= 0xEF) || m == 0xFE))
            fail("unknown marker");
      }
      pos_ += len;
    }
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int channels() const { return ncomp_ == 1 ? 1 : 3; }

  // RGB (or gray) pixels, height x width x channels.
  void output(uint8_t* out) const;

 private:
  const uint8_t* data_;
  size_t n_;
  size_t pos_ = 0;
  uint16_t qt_[4][64] = {};
  bool qdef_[4] = {};
  Huffman dc_[4], ac_[4];
  int restart_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  bool frame_ = false, scanned_ = false, progressive_ = false;
  int width_ = 0, height_ = 0, ncomp_ = 0, hmax_ = 1, vmax_ = 1;
  Component comp_[3];

  // jdmarker.c::next_marker: skips bytes up to an FF (libjpeg warns of
  // them), then the FF fill bytes; returns the marker code.
  int next_marker() {
    int m = 0;
    while (m == 0) {  // FF 00 (a stuffed FF) outside a scan is skipped
      while (pos_ < n_ && data_[pos_] != 0xFF) ++pos_;
      while (pos_ < n_ && data_[pos_] == 0xFF) ++pos_;
      if (pos_ >= n_) fail("truncated (no EOI)");
      m = data_[pos_++];
    }
    return m;
  }

  size_t segment_length() {
    if (pos_ + 2 > n_) fail("truncated marker segment");
    const size_t len = (size_t(data_[pos_]) << 8) | data_[pos_ + 1];
    if (len < 2) fail("corrupt data: bad marker length");
    if (pos_ + len > n_) fail("truncated marker segment");
    return len;
  }

  void read_sof(bool progressive) {
    if (frame_) fail("corrupt data: a second frame header");
    progressive_ = progressive;
    const size_t len = segment_length();
    const uint8_t* b = data_ + pos_ + 2;
    if (len < 8) fail("corrupt data: bad SOF length");
    if (b[0] != 8) fail(std::to_string(b[0]) + "-bit samples are not read");
    height_ = (b[1] << 8) | b[2];
    width_ = (b[3] << 8) | b[4];
    ncomp_ = b[5];
    if (height_ == 0) fail(kDnl);
    if (width_ == 0) fail("corrupt data: zero width");
    if (int64_t(width_) * height_ > kMaxPixels) fail("image too large");
    if (ncomp_ == 4) fail("4-component (CMYK/YCCK) JPEG is not read");
    if (ncomp_ != 1 && ncomp_ != 3)
      fail("corrupt data: " + std::to_string(ncomp_) + " components");
    if (len != size_t(8 + 3 * ncomp_)) fail("corrupt data: bad SOF length");
    for (int i = 0; i < ncomp_; ++i) {
      Component& c = comp_[i];
      c.id = b[6 + 3 * i];
      c.h = b[7 + 3 * i] >> 4;
      c.v = b[7 + 3 * i] & 15;
      c.tq = b[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail("corrupt data: bad sampling factors");
      if (c.tq > 3) fail("corrupt data: bad quantisation table index");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    for (int i = 0; i < ncomp_; ++i) {
      Component& c = comp_[i];
      if (hmax_ % c.h || vmax_ % c.v)
        fail("fractional sampling factors are not read");
      c.dw = int((int64_t(width_) * c.h + hmax_ - 1) / hmax_);
      c.dh = int((int64_t(height_) * c.v + vmax_ - 1) / vmax_);
      if (progressive_) {
        c.bw = (width_ + 8 * hmax_ - 1) / (8 * hmax_) * c.h;
        c.bh = (height_ + 8 * vmax_ - 1) / (8 * vmax_) * c.v;
        c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
        std::fill(c.coef_bits, c.coef_bits + 64, -1);
      }
    }
    frame_ = true;
    pos_ += len;
  }

  void read_dqt(const uint8_t* b, size_t len) {
    size_t i = 0;
    while (i < len) {
      const int pq = b[i] >> 4, tq = b[i] & 15;
      ++i;
      if (tq > 3 || pq > 1) fail("corrupt data: bad DQT");
      const size_t need = pq ? 128 : 64;
      if (i + need > len) fail("corrupt data: bad DQT length");
      for (int k = 0; k < 64; ++k)
        qt_[tq][kNatural[k]] =
            pq ? uint16_t((b[i + 2 * k] << 8) | b[i + 2 * k + 1]) : b[i + k];
      qdef_[tq] = true;
      i += need;
    }
  }

  void read_dht(const uint8_t* b, size_t len) {
    size_t i = 0;
    while (i < len) {
      if (i + 17 > len) fail("corrupt data: bad DHT length");
      const int tc = b[i] >> 4, th = b[i] & 15;
      if (tc > 1 || th > 3) fail("corrupt data: bad DHT");
      Huffman& t = tc ? ac_[th] : dc_[th];
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += (t.bits[l] = b[i + l]);
      i += 17;
      if (count > 256 || i + count > len) fail("corrupt data: bad DHT");
      std::memcpy(t.vals, b + i, count);
      t.nvals = count;
      t.defined = true;
      i += count;
    }
  }

  void read_scan(const uint8_t* b, size_t len) {
    if (!frame_) fail("corrupt data: scan before the frame header");
    if (scanned_ && !progressive_)
      fail("files with more than one scan are not read");
    if (len < 1) fail("corrupt data: bad SOS");
    const int ns = b[0];
    if (len != size_t(4 + 2 * ns) || ns < 1) fail("corrupt data: bad SOS");
    if (ns != ncomp_ && !progressive_)
      fail("non-interleaved scans of a colour image are not read");
    if (ns > ncomp_) fail("corrupt data: bad SOS");
    Component* order[3];
    for (int i = 0; i < ns; ++i) {
      const int id = b[1 + 2 * i];
      Component* c = nullptr;
      for (int k = 0; k < ncomp_; ++k)
        if (comp_[k].id == id) c = &comp_[k];
      for (int k = 0; k < i; ++k)
        if (order[k] == c) c = nullptr;
      if (!c) fail("corrupt data: bad component in SOS");
      c->td = b[2 + 2 * i] >> 4;
      c->ta = b[2 + 2 * i] & 15;
      if (c->td > 3 || c->ta > 3) fail("corrupt data: bad table in SOS");
      if (!c->latched) {
        if (!qdef_[c->tq]) fail("missing quantisation table");
        std::memcpy(c->qt, qt_[c->tq], sizeof(c->qt));
        c->latched = true;
      }
      order[i] = c;
    }
    const int ss = b[1 + 2 * ns], se = b[2 + 2 * ns];
    const int ah = b[3 + 2 * ns] >> 4, al = b[3 + 2 * ns] & 15;
    if (progressive_) {
      progressive_scan(order, ns, ss, se, ah, al);
    } else {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        fail("corrupt data: bad spectral selection for a sequential scan");
      sequential_scan(order, ns);
    }
    scanned_ = true;
  }

  // The MCU grid of a scan (T.81 A.2): one block of the component when the
  // scan has one, walking the component's own block grid; else each
  // component's h x v blocks in scan order over the frame's MCUs.
  void scan_grid(Component* const* order, int ns, int& mcux, int& mcuy) {
    if (ns == 1) {
      mcux = (order[0]->dw + 7) / 8;
      mcuy = (order[0]->dh + 7) / 8;
      return;
    }
    mcux = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    int blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += order[i]->h * order[i]->v;
    if (blocks > 10) fail("corrupt data: more than 10 blocks in an MCU");
  }

  // jdhuff.c / jdphuff.c process_restart: discard the partial byte, read
  // RSTn; the caller resets its predictions (and end-of-band run).
  void restart(BitReader& br, int& next_rst) {
    size_t p = br.consumed_pos();
    while (p < n_ && data_[p] != 0xFF) ++p;  // libjpeg skips (warns)
    while (p < n_ && data_[p] == 0xFF) ++p;
    if (p >= n_) fail("truncated or corrupt entropy-coded data");
    if (data_[p] != 0xD0 + next_rst)
      fail("corrupt data: missing or out-of-order restart marker");
    br.pos = p + 1;
    br.reset();
    next_rst = (next_rst + 1) & 7;
  }

  void sequential_scan(Component* const* order, int ns) {
    for (int i = 0; i < ns; ++i) {
      Component& c = *order[i];
      if (!dc_[c.td].defined || !ac_[c.ta].defined)
        fail("missing Huffman table");
    }
    for (int i = 0; i < ns; ++i) {
      dc_[order[i]->td].derive(true);
      ac_[order[i]->ta].derive(false);
    }
    int mcux, mcuy;
    scan_grid(order, ns, mcux, mcuy);
    for (int i = 0; i < ns; ++i) {
      Component& c = *order[i];
      c.bw = ns == 1 ? mcux : mcux * c.h;
      c.bh = ns == 1 ? mcuy : mcuy * c.v;
      c.plane.assign(size_t(c.bw) * 8 * c.bh * 8, 0);
      c.pred = 0;
    }
    BitReader br{data_, n_, pos_};
    alignas(16) int16_t blk[64];
    const int total = mcux * mcuy;
    int togo = restart_, next_rst = 0;
    for (int mcu = 0; mcu < total; ++mcu) {
      if (restart_ && togo == 0) {
        restart(br, next_rst);
        togo = restart_;
        for (int i = 0; i < ns; ++i) order[i]->pred = 0;
      }
      const int mx = mcu % mcux, my = mcu / mcux;
      for (int i = 0; i < ns; ++i) {
        Component& c = *order[i];
        const int hh = ns == 1 ? 1 : c.h, vv = ns == 1 ? 1 : c.v;
        for (int v = 0; v < vv; ++v)
          for (int h = 0; h < hh; ++h) {
            decode_block(br, c, blk);
            const int bx = mx * hh + h, by = my * vv + v;
            const int stride = c.bw * 8;
            idct_islow(blk, c.qt,
                       c.plane.data() + size_t(by) * 8 * stride + bx * 8,
                       stride);
          }
      }
      if (restart_) --togo;
    }
    pos_ = br.consumed_pos();
  }

  // A progressive scan (T.81 G.1.2, jdphuff.c) into the coefficient
  // buffer. The parameters jdphuff.c refuses are refused; the progressions
  // it only warns about (an AC scan before the component's DC scan, a
  // refinement whose Ah is not the previous Al) are refused too.
  void progressive_scan(Component* const* order, int ns, int ss, int se,
                        int ah, int al) {
    const bool dc = ss == 0;
    bool bad = dc ? se != 0 : (ss > se || se > 63 || ns != 1);
    if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
    if (bad) fail("corrupt data: bad progressive scan parameters");
    for (int i = 0; i < ns; ++i) {
      Component& c = *order[i];
      if (!dc && c.coef_bits[0] < 0)
        fail("corrupt data: an AC scan before the DC scan (bad progression)");
      for (int k = ss; k <= se; ++k) {
        if (ah != std::max(c.coef_bits[k], 0))
          fail("corrupt data: successive approximation out of order (bad "
               "progression)");
        c.coef_bits[k] = al;
      }
      if (dc && ah == 0) {
        if (!dc_[c.td].defined) fail("missing Huffman table");
        dc_[c.td].derive(true);
      } else if (!dc) {
        if (!ac_[c.ta].defined) fail("missing Huffman table");
        ac_[c.ta].derive(false);
      }
      c.pred = 0;
    }
    int mcux, mcuy;
    scan_grid(order, ns, mcux, mcuy);
    BitReader br{data_, n_, pos_};
    const int total = mcux * mcuy;
    int togo = restart_, next_rst = 0, eobrun = 0;
    for (int mcu = 0; mcu < total; ++mcu) {
      if (restart_ && togo == 0) {
        restart(br, next_rst);
        togo = restart_;
        eobrun = 0;
        for (int i = 0; i < ns; ++i) order[i]->pred = 0;
      }
      const int mx = mcu % mcux, my = mcu / mcux;
      for (int i = 0; i < ns; ++i) {
        Component& c = *order[i];
        const int hh = ns == 1 ? 1 : c.h, vv = ns == 1 ? 1 : c.v;
        for (int v = 0; v < vv; ++v)
          for (int h = 0; h < hh; ++h) {
            const int bx = mx * hh + h, by = my * vv + v;
            int16_t* blk = c.coef.data() + (size_t(by) * c.bw + bx) * 64;
            if (dc && ah == 0) dc_first(br, c, blk, al);
            else if (dc) dc_refine(br, blk, al);
            else if (ah == 0) ac_first(br, c, blk, ss, se, al, eobrun);
            else ac_refine(br, c, blk, ss, se, al, eobrun);
          }
      }
      if (restart_) --togo;
    }
    pos_ = br.consumed_pos();
  }

  // jdphuff.c::decode_mcu_DC_first.
  void dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
    int s = br.decode(dc_[c.td]);
    if (s) s = extend(br.get(s), s);
    const int64_t dc_val = int64_t(c.pred) + s;
    if (dc_val != int32_t(dc_val)) fail("corrupt data: DC value overflows");
    c.pred = int(dc_val);
    blk[0] = int16_t(uint32_t(c.pred) << al);  // JCOEF
  }

  // jdphuff.c::decode_mcu_DC_refine.
  static void dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.get(1)) blk[0] = int16_t(blk[0] | (1 << al));
  }

  // jdphuff.c::decode_mcu_AC_first: coefficients ss..se of one block, or
  // one block of a pending end-of-band run.
  void ac_first(BitReader& br, Component& c, int16_t* blk, int ss, int se,
                int al, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& t = ac_[c.ta];
    for (int k = ss; k <= se; ++k) {
      const int rs = br.decode(t);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) fail("corrupt data: coefficient index past the band");
        blk[kNatural[k]] = int16_t(uint32_t(extend(br.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) + br.get(r) - 1;
        break;
      }
    }
  }

  // jdphuff.c::decode_mcu_AC_refine: one bit of precision more for every
  // nonzero coefficient of the band (correction bits), newly nonzero ones
  // as +-(1 << al), and end-of-band runs over blocks.
  void ac_refine(BitReader& br, Component& c, int16_t* blk, int ss, int se,
                 int al, int& eobrun) {
    const int p1 = 1 << al, m1 = -(1 << al);
    auto correct = [&](int16_t& coef) {
      if (br.get(1) && (coef & p1) == 0)
        coef = int16_t(coef + (coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      const Huffman& t = ac_[c.ta];
      for (; k <= se; ++k) {
        const int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          // A newly nonzero coefficient is always of size 1 (libjpeg
          // warns otherwise).
          if (s != 1) fail("corrupt data: bad Huffman code in a refinement");
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = (1 << r) + br.get(r);
          break;
        }
        // Past already-nonzero coefficients (each with a correction bit)
        // and r zero ones, to the one a newly nonzero value goes to.
        for (; k <= se; ++k) {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
        }
        if (s) {
          if (k > se) fail("corrupt data: coefficient index past the band");
          blk[kNatural[k]] = int16_t(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  // After the last scan: every coefficient must be at full precision, as
  // cv2's and libjpeg's simple progressions leave it; then each block of
  // the padded grid goes through the IDCT into the component's plane.
  void finish_progressive() {
    for (int i = 0; i < ncomp_; ++i) {
      Component& c = comp_[i];
      for (int k = 0; k < 64; ++k)
        if (c.coef_bits[k] != 0)
          fail("progressive JPEG short of full refinement is not read");
      const int stride = c.bw * 8;
      c.plane.assign(size_t(stride) * c.bh * 8, 0);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.coef.data() + (size_t(by) * c.bw + bx) * 64, c.qt,
                     c.plane.data() + size_t(by) * 8 * stride + bx * 8,
                     stride);
      c.coef = std::vector<int16_t>();
    }
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    const Huffman& dc = dc_[c.td];
    const Huffman& ac = ac_[c.ta];
    int s = br.decode(dc);
    if (s) s = extend(br.get(s), s);
    const int64_t dc_val = int64_t(c.pred) + s;
    if (dc_val != int32_t(dc_val)) fail("corrupt data: DC value overflows");
    c.pred = int(dc_val);
    blk[0] = int16_t(c.pred);  // JCOEF
    for (int k = 1; k < 64; ++k) {
      const int rs = br.decode(ac);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt data: coefficient index past 63");
        blk[kNatural[k]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // A component upsampled to the full image: width_ x height_ samples.
  std::vector<uint8_t> upsample(const Component& c) const;
};

std::vector<uint8_t> Decoder::upsample(const Component& c) const {
  const int W = width_, H = height_;
  const int hx = hmax_ / c.h, vx = vmax_ / c.v;
  const int stride = c.bw * 8;
  const uint8_t* p = c.plane.data();
  std::vector<uint8_t> out(size_t(W) * H);
  auto in = [&](int y, int x) -> int { return p[size_t(y) * stride + x]; };
  const int dw = c.dw, dh = c.dh;
  const bool fancy_h2 = dw > 2;
  if (hx == 1 && vx == 1) {
    for (int y = 0; y < H; ++y)
      std::memcpy(&out[size_t(y) * W], p + size_t(y) * stride, W);
  } else if (hx == 2 && vx == 1 && fancy_h2) {
    // h2v1_fancy_upsample: 3/4 nearer + 1/4 further, biases 1 and 2.
    for (int y = 0; y < H; ++y) {
      uint8_t* o = &out[size_t(y) * W];
      for (int x = 0; x < W; ++x) {
        const int j = x >> 1;
        const int nb = (x & 1) ? std::min(j + 1, dw - 1) : std::max(j - 1, 0);
        o[x] = uint8_t((3 * in(y, j) + in(y, nb) + ((x & 1) ? 2 : 1)) >> 2);
      }
    }
  } else if (hx == 2 && vx == 2 && fancy_h2) {
    // h2v2_fancy_upsample: column sums 3 nearer row + further row, then
    // 3 nearer + further column, biases 8 and 7.
    std::vector<int> cs(dw);
    for (int y = 0; y < H; ++y) {
      const int i = y >> 1;
      const int ni = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      for (int j = 0; j < dw; ++j) cs[j] = 3 * in(i, j) + in(ni, j);
      uint8_t* o = &out[size_t(y) * W];
      for (int x = 0; x < W; ++x) {
        const int j = x >> 1;
        if (x & 1)
          o[x] = uint8_t((3 * cs[j] + cs[std::min(j + 1, dw - 1)] + 7) >> 4);
        else
          o[x] = uint8_t((3 * cs[j] + cs[std::max(j - 1, 0)] + 8) >> 4);
      }
    }
  } else if (hx == 1 && vx == 2) {
    // h1v2_fancy_upsample (libjpeg-turbo): biases 1 (above) and 2 (below).
    for (int y = 0; y < H; ++y) {
      const int i = y >> 1;
      const int ni = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      const int bias = (y & 1) ? 2 : 1;
      uint8_t* o = &out[size_t(y) * W];
      for (int x = 0; x < W; ++x)
        o[x] = uint8_t((3 * in(i, x) + in(ni, x) + bias) >> 2);
    }
  } else {
    // h2v1_upsample, h2v2_upsample and int_upsample: box replication.
    for (int y = 0; y < H; ++y) {
      uint8_t* o = &out[size_t(y) * W];
      for (int x = 0; x < W; ++x) o[x] = uint8_t(in(y / vx, x / hx));
    }
  }
  return out;
}

// jdcolor.c::build_ycc_rgb_table.
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int SB = 16;
    const int64_t half = int64_t(1) << (SB - 1);
    auto fix = [&](double x) { return int64_t(x * (1 << SB) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((fix(1.40200) * x + half) >> SB);
      cb_b[i] = int((fix(1.77200) * x + half) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

void Decoder::output(uint8_t* out) const {
  const size_t np = size_t(width_) * height_;
  if (ncomp_ == 1) {
    const std::vector<uint8_t> g = upsample(comp_[0]);
    std::memcpy(out, g.data(), np);
    return;
  }
  const std::vector<uint8_t> a = upsample(comp_[0]);
  const std::vector<uint8_t> b = upsample(comp_[1]);
  const std::vector<uint8_t> c = upsample(comp_[2]);
  bool ycc = true;
  if (jfif_) {
    ycc = true;
  } else if (adobe_) {
    ycc = adobe_transform_ != 0;
  } else if (comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66) {
    ycc = false;  // 'R' 'G' 'B'
  }
  if (!ycc) {
    for (size_t i = 0; i < np; ++i) {
      out[3 * i] = a[i];
      out[3 * i + 1] = b[i];
      out[3 * i + 2] = c[i];
    }
    return;
  }
  for (size_t i = 0; i < np; ++i) {
    const int y = a[i], cb = b[i], cr = c[i];
    out[3 * i] = uint8_t(clamp255(y + kYcc.cr_r[cr]));
    out[3 * i + 1] =
        uint8_t(clamp255(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
    out[3 * i + 2] = uint8_t(clamp255(y + kYcc.cb_b[cb]));
  }
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Reads the markers up to the frame header: hwc = {height, width,
// channels} (channels 1 for gray, 3 for colour). Returns 0, or -1 with a
// message in `err` for a file the decoder refuses.
int jpeg_header(const uint8_t* data, int64_t n, int32_t* hwc, char* err,
                int errlen) {
  try {
    Decoder d(data, size_t(n));
    d.run(true);
    if (d.width() == 0) throw Error{"no frame header"};
    hwc[0] = d.height();
    hwc[1] = d.width();
    hwc[2] = d.channels();
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

// Decodes the whole file into `out` (height x width x channels uint8, RGB
// or gray, `cap` bytes). Returns 0, or -1 with a message in `err`.
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap,
                char* err, int errlen) {
  try {
    Decoder d(data, size_t(n));
    d.run(false);
    if (int64_t(d.width()) * d.height() * d.channels() > cap)
      throw Error{"output buffer too small"};
    d.output(out);
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return -1;
}

}  // extern "C"
