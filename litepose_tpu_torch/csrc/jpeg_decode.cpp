// Baseline JPEG decoder for the dataset eval path, on the host (no cv2).
//
// Takes the place of `cv2.imread(path, cv2.IMREAD_COLOR)` followed by
// BGR -> RGB in `litepose_tpu/data/dataset.py:_load_image`, and must give
// the same bytes.  OpenCV decodes with libjpeg-turbo at its defaults, whose
// stages are all integer arithmetic, so this file follows them step for
// step:
//   - Huffman-coded sequential DCT, 8-bit samples (SOF0/SOF1), interleaved
//     or not, with restart intervals;
//   - dequantization and the integer "ISLOW" inverse DCT (jidctint.c:
//     13-bit constants, 2 extra bits between the passes, the post-IDCT
//     range-limit table of jdmaster.c);
//   - "fancy" triangle-filter upsampling of subsampled chroma (jdsample.c:
//     h2v1 and h2v2 when the component is wider than 2 samples, else box
//     replication; h1v2; integer replication otherwise), with the top and
//     bottom rows replicated as jdmainct.c supplies its context rows;
//   - fixed-point YCbCr -> RGB (jdcolor.c, 16 fraction bits) for YCbCr
//     images, a plain copy for RGB ones (Adobe transform 0 or component ids
//     'R','G','B', as jdapimin.c guesses), and gray replicated to three
//     channels.
// Progressive, arithmetic-coded, lossless, hierarchical and 12-bit files
// and 4-component (CMYK/YCCK) colour are refused with an error code, never
// decoded some other way; so is a scan that decodes bits past its data (a
// truncated file), where libjpeg feeds zeros and warns and OpenCV's imread
// returns no image.  EXIF orientation is applied by the caller
// (litepose_tpu_torch/data/jpeg.py).
//
// What bounds it: one host thread, the Huffman decode and the IDCT of every
// block (about 10 ms for a 640x480 4:2:0 file on the H100 host, PERF.md).
//
// Built with the host C++ compiler (kernels/build.py: `c++ -O2 -fPIC
// -shared`, no -ffast-math; the arithmetic is integer anyway) and loaded
// with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Error {
  kOk = 0,
  kNotJpeg = 1,
  kCorrupt = 2,
  kProgressive = 3,
  kArithmetic = 4,
  kLossless = 5,
  kPrecision = 6,
  kComponents = 7,
  kSampling = 8,
  kNoFrame = 9,
  kNoTable = 10,
  kSize = 11,
};

// zigzag position -> natural (row-major) position, padded with 63s so a
// corrupt run past the block's end lands on the last coefficient as in
// libjpeg (jutils.c: jpeg_natural_order)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  // jdhuff.c (jpeg_make_d_derived_tbl) refuses, when a scan uses the table,
  // code counts that over-subscribe a length or give a code of all ones,
  // and DC symbols above 15
  bool valid = false;
  bool dc_symbols_ok = false;
  // canonical decoding tables (JPEG spec F.2.2.3)
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint8_t vals[256];
  // first 9 bits -> (length << 8 | value), length 0 = longer code
  uint16_t fast[512];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;       // table selectors of the current scan
  int width = 0, height = 0;  // downsampled size (jdinput.c)
  int bw = 0, bh = 0;       // blocks across and down, in whole MCUs
  int stride = 0;           // bw * 8
  std::vector<uint8_t> plane;  // IDCT output, bh*8 rows of stride samples
  int dc = 0;               // DC predictor
};

class BitReader {
 public:
  BitReader(const uint8_t* data, long n, long pos) : d_(data), n_(n), pos_(pos) {}

  // Fill the buffer to at least 25 bits; past a marker (or the end) feed
  // zero bits, as libjpeg does.
  void fill() {
    while (nbits_ <= 24) {
      unsigned byte = 0;
      if (hit_marker_ || pos_ >= n_) {
        fake_ += 8;
      } else {
        byte = d_[pos_];
        if (byte == 0xFF) {
          long q = pos_ + 1;
          while (q < n_ && d_[q] == 0xFF) ++q;  // fill bytes
          if (q < n_ && d_[q] == 0x00) {
            pos_ = q + 1;
          } else {
            hit_marker_ = true;  // leave pos_ at the marker
            byte = 0;
            fake_ += 8;
          }
        } else {
          ++pos_;
        }
      }
      acc_ = (acc_ << 8) | byte;
      nbits_ += 8;
    }
  }

  unsigned peek(int k) {
    fill();
    return static_cast<unsigned>(acc_ >> (nbits_ - k)) & ((1u << k) - 1u);
  }

  void skip(int k) {
    nbits_ -= k;
    if (nbits_ < fake_) {  // a zero past the data was decoded
      starved_ = true;
      fake_ = nbits_;
    }
  }

  // Whether the scan read past the end of its data (a truncated file, or a
  // marker where entropy-coded data should be): libjpeg warns and OpenCV's
  // imread then returns no image.
  bool starved() const { return starved_; }

  unsigned get(int k) {
    if (k == 0) return 0;
    const unsigned v = peek(k);
    skip(k);
    return v;
  }

  // Drop the bits left before a restart marker and step past RSTn; false
  // when the next marker is not the expected one.
  bool restart(int expected) {
    nbits_ = 0;
    fake_ = 0;
    acc_ = 0;
    hit_marker_ = false;
    while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] != 0x00)) ++pos_;
    while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
    if (pos_ >= n_ || d_[pos_] != 0xD0 + expected) return false;
    ++pos_;
    return true;
  }

  // The position after the entropy-coded data: the next marker's 0xFF.
  long end() {
    long p = pos_;
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0x00 &&
                           !(d_[p + 1] >= 0xD0 && d_[p + 1] <= 0xD7))) {
      ++p;
    }
    return p;
  }

 private:
  const uint8_t* d_;
  long n_;
  long pos_;
  uint64_t acc_ = 0;
  int nbits_ = 0;
  int fake_ = 0;  // zero bits fed past the data, at the bottom of acc_
  bool hit_marker_ = false;
  bool starved_ = false;
};

// Builds the decoding tables of a DHT entry; marks the table invalid, and
// stops before writing a code out of its length's range, where libjpeg would
// refuse it.
void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* vals, int nvals) {
  std::memcpy(t.vals, vals, nvals);
  t.defined = true;
  t.valid = false;
  t.dc_symbols_ok = true;
  for (int k = 0; k < nvals; ++k) t.dc_symbols_ok = t.dc_symbols_ok && vals[k] <= 15;
  int code = 0, k = 0;
  std::memset(t.fast, 0, sizeof(t.fast));
  for (int len = 1; len <= 16; ++len) {
    t.valptr[len] = k;
    t.mincode[len] = code;
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      // over-subscribed, or the all-ones code: libjpeg's JERR_BAD_HUFF_TABLE
      if (code >= (1 << len) - 1) return;
      if (len <= 9) {
        const int shift = 9 - len;
        for (int j = 0; j < (1 << shift); ++j) {
          t.fast[(code << shift) | j] = static_cast<uint16_t>((len << 8) | vals[k]);
        }
      }
    }
    t.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    code <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;
  t.valid = true;
}

// -1 on a code that no table entry has
inline int decode_symbol(BitReader& br, const Huffman& t) {
  const unsigned f = t.fast[br.peek(9)];
  if (f >> 8) {
    br.skip(f >> 8);
    return f & 0xFF;
  }
  int code = static_cast<int>(br.get(9));
  int len = 9;
  while (len < 16 && code > t.maxcode[len]) {
    code = (code << 1) | static_cast<int>(br.get(1));
    ++len;
  }
  if (code > t.maxcode[len]) return -1;
  return t.vals[t.valptr[len] + code - t.mincode[len]];
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// jidctint.c: jpeg_idct_islow
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) {
  return static_cast<int32_t>((x + (int64_t{1} << (n - 1))) >> n);
}

// The post-IDCT range limit of jdmaster.c (prepare_range_limit_table): the
// sample 128 + x for x in [-128, 127], 255 above up to 383, 0 below down to
// -384, read through x & 1023.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int x = i < 512 ? i : i - 1024;  // the index as a signed offset
      int v = x + 128;
      if (i >= 128 && i < 512) v = 255;
      if (i >= 512 && i < 896) v = 0;
      t[i] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int32_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      const int32_t dc = (static_cast<int32_t>(in[0]) * q[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = static_cast<int32_t>(in[16]) * q[16];
    int64_t z3 = static_cast<int32_t>(in[48]) * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int32_t>(in[0]) * q[0];
    z3 = static_cast<int32_t>(in[32]) * q[32];
    int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int32_t>(in[56]) * q[56];
    tmp1 = static_cast<int32_t>(in[40]) * q[40];
    tmp2 = static_cast<int32_t>(in[24]) * q[24];
    tmp3 = static_cast<int32_t>(in[8]) * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, s);
    w[56] = descale(tmp10 - tmp3, s);
    w[8] = descale(tmp11 + tmp2, s);
    w[48] = descale(tmp11 - tmp2, s);
    w[16] = descale(tmp12 + tmp1, s);
    w[40] = descale(tmp12 - tmp1, s);
    w[24] = descale(tmp13 + tmp0, s);
    w[32] = descale(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + static_cast<long>(r) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      const uint8_t v = kRange.t[descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t{w[0]} + w[4]) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (int64_t{w[0]} - w[4]) * (int64_t{1} << kConstBits);
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
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits + kPass1Bits + 3;
    o[0] = kRange.t[descale(tmp10 + tmp3, s) & 1023];
    o[7] = kRange.t[descale(tmp10 - tmp3, s) & 1023];
    o[1] = kRange.t[descale(tmp11 + tmp2, s) & 1023];
    o[6] = kRange.t[descale(tmp11 - tmp2, s) & 1023];
    o[2] = kRange.t[descale(tmp12 + tmp1, s) & 1023];
    o[5] = kRange.t[descale(tmp12 - tmp1, s) & 1023];
    o[3] = kRange.t[descale(tmp13 + tmp0, s) & 1023];
    o[4] = kRange.t[descale(tmp13 - tmp0, s) & 1023];
  }
}

struct Decoder {
  Decoder(const uint8_t* data, long size) : d(data), n(size) {}

  const uint8_t* d;
  long n;
  long pos = 0;
  uint16_t quant[4][64];  // natural order
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;

  int u16(long p) const { return (d[p] << 8) | d[p + 1]; }

  int read_frame(long p, int len, int marker) {
    if (frame) return kCorrupt;
    if (len < 8) return kCorrupt;
    if (d[p] != 8) return kPrecision;
    height = u16(p + 1);
    width = u16(p + 3);
    const int nc = d[p + 5];
    if (height == 0 || width == 0) return kCorrupt;
    if (nc != 1 && nc != 3) return kComponents;
    if (len < 8 + 3 * nc) return kCorrupt;
    (void)marker;
    comps.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps[i];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return kCorrupt;
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    if (nc == 1) {  // a lone component is its own MCU: no subsampling
      comps[0].h = comps[0].v = hmax = vmax = 1;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      if (hmax % c.h || vmax % c.v) return kSampling;
      c.width = static_cast<int>((static_cast<long>(width) * c.h + hmax - 1) / hmax);
      c.height = static_cast<int>((static_cast<long>(height) * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.stride = c.bw * 8;
      c.plane.assign(static_cast<size_t>(c.stride) * c.bh * 8, 0);
    }
    frame = true;
    return kOk;
  }

  int read_dqt(long p, int len) {
    const long end = p + len - 2;
    while (p < end) {
      const int pq = d[p] >> 4, tq = d[p] & 15;
      ++p;
      if (tq > 3) return kCorrupt;
      const int sz = pq ? 128 : 64;
      if (p + sz > end) return kCorrupt;
      for (int k = 0; k < 64; ++k) {
        quant[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16(p + 2 * k) : d[p + k]);
      }
      quant_defined[tq] = true;
      p += sz;
    }
    return kOk;
  }

  int read_dht(long p, int len) {
    const long end = p + len - 2;
    while (p < end) {
      const int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3 || p + 17 > end) return kCorrupt;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += d[p + 1 + i];
      if (total > 256 || p + 17 + total > end) return kCorrupt;
      Huffman& t = tc ? ac[th] : dc[th];
      build_huffman(t, d + p + 1, d + p + 17, total);
      p += 17 + total;
    }
    return kOk;
  }

  int decode_block(BitReader& br, Component& c, int bx, int by) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = decode_symbol(br, hd);
    if (s < 0 || s > 15) return kCorrupt;
    const int diff = s ? extend(static_cast<int>(br.get(s)), s) : 0;
    c.dc = static_cast<int16_t>(c.dc + diff);  // JCOEF is 16 bits
    coef[0] = static_cast<int16_t>(c.dc);
    for (int k = 1; k < 64;) {
      const int rs = decode_symbol(br, ha);
      if (rs < 0) return kCorrupt;
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = static_cast<int16_t>(extend(static_cast<int>(br.get(s)), s));
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    idct_islow(coef, quant[c.tq],
               c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8, c.stride);
    return kOk;
  }

  int read_scan(long p, int len, long* after) {
    if (!frame) return kNoFrame;
    const int ns = d[p];
    if (ns < 1 || ns > 4 || len < 6 + 2 * ns) return kCorrupt;
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      const int id = d[p + 1 + 2 * i];
      Component* c = nullptr;
      for (Component& k : comps)
        if (k.id == id) c = &k;
      if (!c) return kCorrupt;
      c->td = d[p + 2 + 2 * i] >> 4;
      c->ta = d[p + 2 + 2 * i] & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined ||
          !quant_defined[c->tq])
        return kNoTable;
      if (!dc[c->td].valid || !dc[c->td].dc_symbols_ok || !ac[c->ta].valid) return kCorrupt;
      c->dc = 0;
      sc.push_back(c);
    }
    const int ss = d[p + 1 + 2 * ns], se = d[p + 2 + 2 * ns], ahal = d[p + 3 + 2 * ns];
    if (ss != 0 || se != 63 || ahal != 0) return kCorrupt;  // sequential: full band
    BitReader br(d, n, p + len - 2);
    // non-interleaved: one block a "MCU", over the component's own blocks
    int units_x, units_y;
    if (ns == 1) {
      units_x = (sc[0]->width + 7) / 8;
      units_y = (sc[0]->height + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    int todo = restart_interval, next_rst = 0;
    for (int my = 0; my < units_y; ++my) {
      for (int mx = 0; mx < units_x; ++mx) {
        if (restart_interval) {
          if (todo == 0) {
            if (br.starved() || !br.restart(next_rst)) return kCorrupt;
            next_rst = (next_rst + 1) & 7;
            todo = restart_interval;
            for (Component* c : sc) c->dc = 0;
          }
          --todo;
        }
        if (ns == 1) {
          const int err = decode_block(br, *sc[0], mx, my);
          if (err) return err;
        } else {
          for (Component* c : sc) {
            for (int v = 0; v < c->v; ++v) {
              for (int h = 0; h < c->h; ++h) {
                const int err = decode_block(br, *c, mx * c->h + h, my * c->v + v);
                if (err) return err;
              }
            }
          }
        }
      }
    }
    if (br.starved()) return kCorrupt;
    *after = br.end();
    return kOk;
  }

  int parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kNotJpeg;
    pos = 2;
    bool scanned = false;
    while (true) {
      while (pos < n && d[pos] != 0xFF) ++pos;  // tolerate junk between markers
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) return scanned ? kOk : kCorrupt;  // missing EOI: libjpeg warns
      const int marker = d[pos++];
      if (marker == 0xD9) return scanned ? kOk : kNoFrame;  // EOI
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      if (pos + 2 > n) return kCorrupt;
      const int len = u16(pos);
      if (len < 2 || pos + len > n) return kCorrupt;
      const long body = pos + 2;
      int err = kOk;
      if (marker == 0xC0 || marker == 0xC1) {
        err = read_frame(body, len, marker);
      } else if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA || marker == 0xCE) {
        return marker == 0xC2 ? kProgressive : marker == 0xC6 ? kLossless : kArithmetic;
      } else if (marker == 0xC3 || marker == 0xC5 || marker == 0xC7 || marker == 0xCB ||
                 marker == 0xCD || marker == 0xCF) {
        return (marker == 0xCB || marker == 0xCD || marker == 0xCF) ? kArithmetic : kLossless;
      } else if (marker == 0xC9) {
        return kArithmetic;
      } else if (marker == 0xCC) {
        return kArithmetic;  // DAC: arithmetic-coding conditioning
      } else if (marker == 0xC4) {
        err = read_dht(body, len);
      } else if (marker == 0xDB) {
        err = read_dqt(body, len);
      } else if (marker == 0xDD) {
        if (len < 4) return kCorrupt;
        restart_interval = u16(body);
      } else if (marker == 0xDA) {
        long after = 0;
        err = read_scan(body, len, &after);
        if (err) return err;
        scanned = true;
        pos = after;
        continue;
      } else if (marker == 0xE0) {
        // jdmarker.c: examine_app0 reads a JFIF marker of 14 data bytes or more
        if (len >= 16 && std::memcmp(d + body, "JFIF\0", 5) == 0) jfif = true;
      } else if (marker == 0xEE) {
        if (len >= 14 && std::memcmp(d + body, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = d[body + 11];
        }
      }
      if (err) return err;
      pos += len;
    }
  }
};

// jdcolor.c: build_ycc_rgb_table (16 fraction bits, rounded)
struct YccTables {
  static constexpr int kScale = 16;
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int32_t half = int32_t{1} << (kScale - 1);
    auto fix = [](double x) { return static_cast<int32_t>(x * (1L << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

// The full-size rows of component c, upsampled as jdsample.c does, into
// dst (height rows of width samples).
void upsample(const Component& c, int hmax, int vmax, int width, int height, uint8_t* dst) {
  const uint8_t* src = c.plane.data();
  const int W = c.width, H = c.height, S = c.stride;
  // rows outside [0, H) read the first or last real row (jdmainct.c)
  auto row = [&](int y) { return src + static_cast<size_t>(y < 0 ? 0 : y >= H ? H - 1 : y) * S; };
  std::vector<uint8_t> wide(static_cast<size_t>(2 * W + 2));
  if (c.h == hmax && c.v == vmax) {
    for (int y = 0; y < height; ++y) std::memcpy(dst + static_cast<size_t>(y) * width, row(y), width);
  } else if (2 * c.h == hmax && c.v == vmax) {
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = row(y);
      uint8_t* o = wide.data();
      if (W > 2) {  // h2v1_fancy_upsample
        int v = in[0];
        *o++ = static_cast<uint8_t>(v);
        *o++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < W - 1; ++x) {
          v = in[x] * 3;
          *o++ = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
          *o++ = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
        }
        v = in[W - 1];
        *o++ = static_cast<uint8_t>((v * 3 + in[W - 2] + 1) >> 2);
        *o++ = static_cast<uint8_t>(v);
      } else {  // h2v1_upsample
        for (int x = 0; x < W; ++x) o[2 * x] = o[2 * x + 1] = in[x];
      }
      std::memcpy(dst + static_cast<size_t>(y) * width, wide.data(), width);
    }
  } else if (c.h == hmax && 2 * c.v == vmax) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; ++y) {
      const int iy = y >> 1;
      const uint8_t* in0 = row(iy);
      const uint8_t* in1 = row((y & 1) ? iy + 1 : iy - 1);
      const int bias = (y & 1) ? 2 : 1;
      uint8_t* o = dst + static_cast<size_t>(y) * width;
      for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    }
  } else if (2 * c.h == hmax && 2 * c.v == vmax) {
    for (int y = 0; y < height; ++y) {
      const int iy = y >> 1;
      uint8_t* o = wide.data();
      if (W > 2) {  // h2v2_fancy_upsample
        const uint8_t* in0 = row(iy);
        const uint8_t* in1 = row((y & 1) ? iy + 1 : iy - 1);
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        *o++ = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 2; x < W; ++x) {
          next_sum = in0[x] * 3 + in1[x];
          *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
      } else {  // h2v2_upsample
        const uint8_t* in = row(iy);
        for (int x = 0; x < W; ++x) o[2 * x] = o[2 * x + 1] = in[x];
      }
      std::memcpy(dst + static_cast<size_t>(y) * width, wide.data(), width);
    }
  } else {  // int_upsample: box replication by integer factors
    const int fx = hmax / c.h, fy = vmax / c.v;
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = row(y / fy);
      uint8_t* o = dst + static_cast<size_t>(y) * width;
      for (int x = 0; x < width; ++x) o[x] = in[x / fx];
    }
  }
}

}  // namespace

// Decodes the JPEG in data[0, n) into out, height x width x 3 RGB bytes
// (the frame's own size, before any EXIF orientation).  Returns 0, or an
// error code: 1 not a JPEG, 2 corrupt or truncated, 3 progressive,
// 4 arithmetic-coded, 5 lossless or hierarchical, 6 not 8-bit, 7 not 1 or 3
// components, 8 sampling factors it cannot upsample, 9 no frame header,
// 10 a scan's Huffman or quantization table undefined, 11 the frame's size
// differs from (height, width).
extern "C" int lp_jpeg_decode(const uint8_t* data, long n, uint8_t* out, int height,
                              int width) {
  Decoder dec(data, n);
  const int err = dec.parse();
  if (err) return err;
  if (!dec.frame) return kNoFrame;
  if (dec.width != width || dec.height != height) return kSize;
  const size_t npix = static_cast<size_t>(width) * height;
  if (dec.comps.size() == 1) {
    const Component& c = dec.comps[0];
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = c.plane.data() + static_cast<size_t>(y) * c.stride;
      uint8_t* o = out + static_cast<size_t>(y) * width * 3;
      for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
    }
    return kOk;
  }
  std::vector<uint8_t> full(3 * npix);
  for (int i = 0; i < 3; ++i) {
    upsample(dec.comps[i], dec.hmax, dec.vmax, width, height, full.data() + i * npix);
  }
  const uint8_t* p0 = full.data();
  const uint8_t* p1 = p0 + npix;
  const uint8_t* p2 = p1 + npix;
  bool rgb;  // jdapimin.c: default_decompress_parms
  if (dec.jfif) {
    rgb = false;
  } else if (dec.adobe) {
    rgb = dec.adobe_transform == 0;
  } else {
    rgb = dec.comps[0].id == 'R' && dec.comps[1].id == 'G' && dec.comps[2].id == 'B';
  }
  if (rgb) {
    for (size_t i = 0; i < npix; ++i) {
      out[3 * i] = p0[i];
      out[3 * i + 1] = p1[i];
      out[3 * i + 2] = p2[i];
    }
    return kOk;
  }
  const YccTables& t = kYcc;
  auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (size_t i = 0; i < npix; ++i) {
    const int y = p0[i], cb = p1[i], cr = p2[i];
    out[3 * i] = clamp(y + t.cr_r[cr]);
    out[3 * i + 1] = clamp(y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> YccTables::kScale));
    out[3 * i + 2] = clamp(y + t.cb_b[cb]);
  }
  return kOk;
}
