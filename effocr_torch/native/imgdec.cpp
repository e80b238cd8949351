// Image decoders for the formats other than PNG: a JPEG decoder that
// gives libjpeg-turbo's pixels, and the entropy codecs of TIFF and GIF.
//
// JPEG follows libjpeg-turbo 3.x with the parameters Pillow leaves at
// their defaults (no draft): JDCT_ISLOW (jidctint.c, bit-exact to the
// SIMD islow), do_fancy_upsampling TRUE (jdsample.c h2v1 / h2v2 / h1v2
// fancy, plain replication where libjpeg picks it), ycc_rgb_convert
// (jdcolor.c, SCALEBITS 16) and the colour-space rules of jdapimin.c.
// Baseline, extended (SOF1) and progressive (SOF2) Huffman files decode;
// arithmetic coding, lossless, 12-bit, hierarchical, YCCK and sampling
// factors other than 1x1 / 2x1 / 1x2 / 2x2 are refused by name, and so is
// a progressive file whose scans leave coefficient bits unsent (libjpeg
// would smooth its blocks: jdcoefct.c smoothing_ok).
//
// The whole file is entropy-decoded into one coefficient buffer per
// component (baseline and progressive alike), then each block is
// dequantised and inverse-transformed, upsampled and colour-converted.
//
// TIFF: PackBits, LZW (MSB-first, the old LSB-first variant refused),
// CCITT modified Huffman (compression 2), T.4 1-D / 2-D (3) and T.6 (4).
// GIF: LZW.  Deflate stays with Python's zlib.
//
// Errors cross the C boundary as a status and a message: 1 corrupt data,
// 2 truncated file, 3 a feature this decoder refuses, 4 I/O.
//
// Built as a shared library; bound via ctypes (imgdec.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Status { OK = 0, CORRUPT = 1, TRUNCATED = 2, UNSUPPORTED = 3, IO = 4 };

struct DecodeError {
  int status;
  std::string msg;
};

[[noreturn]] void fail(int status, const std::string& msg) {
  throw DecodeError{status, msg};
}

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, errlen, "%s", msg.c_str());
  }
}

void parallel_for(int n, int num_threads, const std::function<void(int)>& f) {
  int nt = std::max(1, std::min(num_threads, n));
  if (nt <= 1) {
    for (int i = 0; i < n; ++i) f(i);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) {
    pool.emplace_back([&]() {
      for (int i = next++; i < n; i = next++) f(i);
    });
  }
  for (auto& th : pool) th.join();
}

// ------------------------------------------------------------------ JPEG

// zigzag index -> natural index, with 16 extra entries so a corrupt run
// length cannot index past the block (jutils.c jpeg_natural_order)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool present = false;
  uint8_t vals[256];
  int maxcode[18];   // largest code of each length, -1 if none
  int valoff[17];    // vals index of a length's first code, minus it
  uint16_t fast[1 << 9];  // (length << 8) | symbol for codes <= 9 bits

  void build(const uint8_t* bits, const uint8_t* v, int nv) {
    std::memcpy(vals, v, nv);
    std::memset(fast, 0, sizeof(fast));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valoff[l] = k - code;
      for (int i = 0; i < bits[l]; ++i) {
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j) {
            fast[(code << shift) | j] = uint16_t((l << 8) | vals[k]);
          }
        }
        ++code;
        ++k;
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      if (code > (1 << l)) fail(CORRUPT, "JPEG: bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
};

struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t acc = 0;
  int bits = 0;
  bool at_marker = false;  // the entropy segment ended at a marker
  bool at_eof = false;     // ... or at the end of the file

  void fill() {
    while (bits <= 56) {
      uint64_t b = 0;
      if (!at_marker && !at_eof) {
        if (pos >= n) {
          at_eof = true;
        } else if (d[pos] != 0xFF) {
          b = d[pos++];
        } else {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;
          if (q >= n) {
            at_eof = true;
          } else if (d[q] == 0) {
            b = 0xFF;
            pos = q + 1;
          } else {
            at_marker = true;  // zeros pad the rest, as libjpeg does
          }
        }
      }
      acc |= b << (56 - bits);
      bits += 8;
    }
  }
  inline int peek(int k) {
    if (bits < k) fill();
    return int(acc >> (64 - k));
  }
  inline void skip(int k) {
    acc <<= k;
    bits -= k;
  }
  inline int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  inline int decode(const Huff& h) {
    int look = peek(16);
    int f = h.fast[look >> 7];
    if (f) {
      skip(f >> 8);
      return f & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      int code = look >> (16 - l);
      if (code <= h.maxcode[l]) {
        skip(l);
        return h.vals[h.valoff[l] + code];
      }
    }
    fail(CORRUPT, "JPEG: bad Huffman code");
  }
  // discard the buffered bits and find the next marker: its code, with
  // pos on its 0xFF; -1 at the end of the file
  int next_marker() {
    acc = 0;
    bits = 0;
    at_marker = false;
    while (pos + 1 < n) {
      if (d[pos] == 0xFF && d[pos + 1] != 0 && d[pos + 1] != 0xFF) {
        return d[pos + 1];
      }
      ++pos;
    }
    return -1;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// the DC predictor plus a difference; a sum past int's range is corrupt
// data (jdhuff.c refuses it too)
inline int add_dc(int pred, int diff) {
  int64_t v = int64_t(pred) + diff;
  if (v > INT32_MAX || v < INT32_MIN) fail(CORRUPT, "JPEG: bad DC value");
  return int(v);
}

struct Comp {
  int id, h, v, tq;
  int wib, hib;      // width / height in blocks (libjpeg's)
  int bw, bh;        // allocated blocks (MCU-padded)
  int dsw, dsh;      // downsampled width / height
  int td, ta;        // Huffman tables of the current scan
  int pred;
  bool latched = false;
  uint16_t q[64];    // natural order, latched at the first scan
  int coef_bits[64];
  std::vector<int16_t> coef;
};

// post-IDCT range limit: (x & 1023) read as a 10-bit signed value, + 128,
// clamped to 0..255 (jdmaster.c prepare_range_limit_table)
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v = (i < 512 ? i : i - 1024) + 128;
      t[i] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const RangeLimit kRange;

// jidctint.c jpeg_idct_islow
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dc = (int(ip[0]) * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) wp[r * 8] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CONST_BITS - PASS1_BITS;
    wp[0] = int(descale(tmp10 + tmp3, S));
    wp[56] = int(descale(tmp10 - tmp3, S));
    wp[8] = int(descale(tmp11 + tmp2, S));
    wp[48] = int(descale(tmp11 - tmp2, S));
    wp[16] = int(descale(tmp12 + tmp1, S));
    wp[40] = int(descale(tmp12 - tmp1, S));
    wp[24] = int(descale(tmp13 + tmp0, S));
    wp[32] = int(descale(tmp13 - tmp0, S));
  }
  constexpr int S2 = CONST_BITS + PASS1_BITS + 3;
  const uint8_t* rl = kRange.t;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t dc = rl[int(descale(wp[0], PASS1_BITS + 3)) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = rl[int(descale(tmp10 + tmp3, S2)) & 1023];
    op[7] = rl[int(descale(tmp10 - tmp3, S2)) & 1023];
    op[1] = rl[int(descale(tmp11 + tmp2, S2)) & 1023];
    op[6] = rl[int(descale(tmp11 - tmp2, S2)) & 1023];
    op[2] = rl[int(descale(tmp12 + tmp1, S2)) & 1023];
    op[5] = rl[int(descale(tmp12 - tmp1, S2)) & 1023];
    op[3] = rl[int(descale(tmp13 + tmp0, S2)) & 1023];
    op[4] = rl[int(descale(tmp13 - tmp0, S2)) & 1023];
  }
}

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int SB = 16;
    const int64_t half = int64_t(1) << (SB - 1);
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + half) >> SB);
      cb_b[i] = int((fix(1.77200) * x + half) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp8(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

const char* sof_name(int m) {
  switch (m) {
    case 0xC3: return "lossless (SOF3)";
    case 0xC5: return "hierarchical sequential (SOF5)";
    case 0xC6: return "hierarchical progressive (SOF6)";
    case 0xC7: return "hierarchical lossless (SOF7)";
    case 0xC9: return "arithmetic coding (SOF9)";
    case 0xCA: return "arithmetic coding, progressive (SOF10)";
    case 0xCB: return "arithmetic coding, lossless (SOF11)";
    case 0xCD: return "arithmetic coding, hierarchical (SOF13)";
    case 0xCE: return "arithmetic coding, hierarchical progressive (SOF14)";
    case 0xCF: return "arithmetic coding, hierarchical lossless (SOF15)";
  }
  return nullptr;
}

// color: 0 by the file's markers (jdapimin.c default_decompress_parms),
// 1 YCbCr whatever they say (TIFF photometric YCbCr with JPEGCOLORMODE
// RGB), 2 no conversion (libtiff's JCS_UNKNOWN for other photometrics)
class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* d, size_t n, int color) : d_(d), n_(n),
      color_(color) {}

  // parse and entropy-decode the whole file
  void read() {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) {
      fail(CORRUPT, "JPEG: no SOI marker");
    }
    pos_ = 2;
    bool eoi = false;
    while (!eoi) {
      int m = next_marker();
      if (m < 0) fail(TRUNCATED, "JPEG: image file is truncated");
      pos_ += 2;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m == 0xD9) {
        eoi = true;
        break;
      }
      int len = seg_len();
      const uint8_t* s = d_ + pos_ + 2;
      int sl = len - 2;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        sof(m, s, sl);
      } else if (sof_name(m)) {
        fail(UNSUPPORTED, std::string("JPEG uses ") + sof_name(m));
      } else if (m == 0xC4) {
        dht(s, sl);
      } else if (m == 0xCC) {
        fail(UNSUPPORTED, "JPEG uses arithmetic coding (DAC)");
      } else if (m == 0xDB) {
        dqt(s, sl);
      } else if (m == 0xDD) {
        if (sl < 2) fail(CORRUPT, "JPEG: bad DRI");
        restart_ = (s[0] << 8) | s[1];
      } else if (m == 0xDC) {
        fail(UNSUPPORTED, "JPEG uses a DNL marker (height given after "
                          "the first scan)");
      } else if (m == 0xE0) {
        if (sl >= 14 && !std::memcmp(s, "JFIF\0", 5)) jfif_ = true;
      } else if (m == 0xEE) {
        if (sl >= 12 && !std::memcmp(s, "Adobe", 5)) {
          adobe_ = true;
          adobe_transform_ = s[11];
        }
      } else if (m == 0xDA) {
        pos_ += len;
        sos(s, sl);
        continue;
      }
      pos_ += len;
    }
    if (!frame_) fail(CORRUPT, "JPEG: no frame (SOFn) before EOI");
    if (!scans_) fail(CORRUPT, "JPEG: no scan before EOI");
    if (nc_ == 4 && color_ == 0 && adobe_ && adobe_transform_ != 0) {
      fail(UNSUPPORTED, "JPEG uses YCCK colour (Adobe transform " +
                            std::to_string(adobe_transform_) + ")");
    }
  }

  int width() const { return w_; }
  int height() const { return h_; }
  // channels of the decoded mode: 1 (L), 3 (RGB) or 4 (CMYK)
  int channels() const { return nc_ == 1 ? 1 : nc_ == 3 ? 3 : 4; }

  // pixels as uint8 [h, w, channels()], converted to out_ch channels:
  // equal channels as they are, L -> 3 replicated, RGB -> 1 the
  // truncating channel mean
  void output(uint8_t* out, int out_ch) {
    check_block_smoothing();
    int nat = channels();
    if (!(out_ch == nat || (nat == 1 && out_ch == 3) ||
          (nat == 3 && out_ch == 1))) {
      fail(CORRUPT, "JPEG: cannot give " + std::to_string(nat) +
                        "-channel pixels as " + std::to_string(out_ch));
    }
    std::vector<std::vector<uint8_t>> planes(nc_);
    for (int c = 0; c < nc_; ++c) planes[c] = upsampled(comp_[c]);
    const size_t np = size_t(w_) * h_;
    if (nat == 1) {
      const uint8_t* p = planes[0].data();
      if (out_ch == 1) {
        std::memcpy(out, p, np);
      } else {
        for (size_t i = 0; i < np; ++i) {
          out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = p[i];
        }
      }
      return;
    }
    if (nat == 4) {
      for (size_t i = 0; i < np; ++i) {
        for (int c = 0; c < 4; ++c) out[4 * i + c] = planes[c][i];
      }
      return;
    }
    const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(),
                  *p2 = planes[2].data();
    bool ycc = color_space_ycc();
    for (size_t i = 0; i < np; ++i) {
      int r, g, b;
      if (ycc) {
        int y = p0[i], cb = p1[i], cr = p2[i];
        r = clamp8(y + kYcc.cr_r[cr]);
        g = clamp8(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        b = clamp8(y + kYcc.cb_b[cb]);
      } else {
        r = p0[i];
        g = p1[i];
        b = p2[i];
      }
      if (out_ch == 3) {
        out[3 * i] = uint8_t(r);
        out[3 * i + 1] = uint8_t(g);
        out[3 * i + 2] = uint8_t(b);
      } else {
        out[i] = uint8_t((r + g + b) / 3);
      }
    }
  }

 private:
  const uint8_t* d_;
  size_t n_;
  int color_;
  size_t pos_ = 0;
  bool frame_ = false, progressive_ = false;
  int scans_ = 0;
  int w_ = 0, h_ = 0, nc_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  uint16_t qt_[4][64];
  bool qt_set_[4] = {false, false, false, false};
  Huff dc_[4], ac_[4];
  Comp comp_[4];
  int eobrun_ = 0;

  int next_marker() {
    while (pos_ + 1 < n_) {
      if (d_[pos_] == 0xFF && d_[pos_ + 1] != 0xFF) {
        if (d_[pos_ + 1] != 0) return d_[pos_ + 1];
        pos_ += 2;  // stuffed byte outside a scan: skip it
        continue;
      }
      ++pos_;
    }
    return -1;
  }

  int seg_len() {
    if (pos_ + 2 > n_) fail(TRUNCATED, "JPEG: image file is truncated");
    int len = (d_[pos_] << 8) | d_[pos_ + 1];
    if (len < 2) fail(CORRUPT, "JPEG: bad marker length");
    if (pos_ + len > n_) fail(TRUNCATED, "JPEG: image file is truncated");
    return len;
  }

  void sof(int m, const uint8_t* s, int sl) {
    if (frame_) fail(CORRUPT, "JPEG: two frames (SOFn)");
    if (sl < 6) fail(CORRUPT, "JPEG: bad SOF");
    int prec = s[0];
    h_ = (s[1] << 8) | s[2];
    w_ = (s[3] << 8) | s[4];
    nc_ = s[5];
    if (prec != 8) {
      fail(UNSUPPORTED, "JPEG uses " + std::to_string(prec) +
                            "-bit precision (this decoder reads 8-bit)");
    }
    if (h_ == 0) {
      fail(UNSUPPORTED, "JPEG uses a DNL marker (height given after the "
                        "first scan)");
    }
    if (w_ == 0) fail(CORRUPT, "JPEG: width 0");
    if (nc_ != 1 && nc_ != 3 && nc_ != 4) {
      fail(UNSUPPORTED, "JPEG with " + std::to_string(nc_) + " components");
    }
    if (sl < 6 + 3 * nc_) fail(CORRUPT, "JPEG: bad SOF");
    progressive_ = (m == 0xC2);
    hmax_ = vmax_ = 1;
    for (int c = 0; c < nc_; ++c) {
      Comp& k = comp_[c];
      k.id = s[6 + 3 * c];
      k.h = s[7 + 3 * c] >> 4;
      k.v = s[7 + 3 * c] & 15;
      k.tq = s[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) {
        fail(CORRUPT, "JPEG: bad component in SOF");
      }
      hmax_ = std::max(hmax_, k.h);
      vmax_ = std::max(vmax_, k.v);
    }
    std::string factors;
    bool ok = hmax_ <= 2 && vmax_ <= 2;
    for (int c = 0; c < nc_; ++c) {
      const Comp& k = comp_[c];
      factors += (c ? ", " : "") + std::to_string(k.h) + "x" +
                 std::to_string(k.v);
      if (hmax_ % k.h || vmax_ % k.v) ok = false;
    }
    if (!ok && nc_ > 1) {
      fail(UNSUPPORTED, "JPEG uses sampling factors " + factors +
                            " (this decoder reads 1x1, 2x1, 1x2 and 2x2 "
                            "luma over 1x1 chroma)");
    }
    if (nc_ == 1) comp_[0].h = comp_[0].v = hmax_ = vmax_ = 1;
    mcux_ = (w_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (h_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (int c = 0; c < nc_; ++c) {
      Comp& k = comp_[c];
      k.dsw = int((int64_t(w_) * k.h + hmax_ - 1) / hmax_);
      k.dsh = int((int64_t(h_) * k.v + vmax_ - 1) / vmax_);
      k.wib = (k.dsw + 7) / 8;
      k.hib = (k.dsh + 7) / 8;
      k.bw = mcux_ * k.h;
      k.bh = mcuy_ * k.v;
      k.coef.assign(size_t(k.bw) * k.bh * 64, 0);
      for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
    }
    frame_ = true;
  }

  void dht(const uint8_t* s, int sl) {
    int p = 0;
    while (p < sl) {
      if (p + 17 > sl) fail(CORRUPT, "JPEG: bad DHT");
      int tc = s[p] >> 4, th = s[p] & 15;
      if (tc > 1 || th > 3) fail(CORRUPT, "JPEG: bad DHT table id");
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        bits[i] = s[p + i];
        count += bits[i];
      }
      if (count > 256 || p + 17 + count > sl) fail(CORRUPT, "JPEG: bad DHT");
      for (int i = 0; i < count && tc == 0; ++i) {
        if (s[p + 17 + i] > 15) fail(CORRUPT, "JPEG: bad DC Huffman table");
      }
      (tc ? ac_ : dc_)[th].build(bits, s + p + 17, count);
      p += 17 + count;
    }
  }

  void dqt(const uint8_t* s, int sl) {
    int p = 0;
    while (p < sl) {
      int pq = s[p] >> 4, tq = s[p] & 15;
      if (tq > 3 || pq > 1) fail(CORRUPT, "JPEG: bad DQT");
      int need = 1 + 64 * (pq + 1);
      if (p + need > sl) fail(CORRUPT, "JPEG: bad DQT");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (s[p + 1 + 2 * k] << 8) | s[p + 2 + 2 * k]
                   : s[p + 1 + k];
        qt_[tq][kNatural[k]] = uint16_t(v);
      }
      qt_set_[tq] = true;
      p += need;
    }
  }

  void sos(const uint8_t* s, int sl) {
    if (!frame_) fail(CORRUPT, "JPEG: scan before frame");
    if (sl < 1) fail(CORRUPT, "JPEG: bad SOS");
    int ns = s[0];
    if (ns < 1 || ns > 4 || sl < 1 + 2 * ns + 3) {
      fail(CORRUPT, "JPEG: bad SOS");
    }
    Comp* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i];
      Comp* k = nullptr;
      for (int c = 0; c < nc_; ++c) {
        if (comp_[c].id == id) k = &comp_[c];
      }
      if (!k) fail(CORRUPT, "JPEG: scan names an unknown component");
      k->td = s[2 + 2 * i] >> 4;
      k->ta = s[2 + 2 * i] & 15;
      if (k->td > 3 || k->ta > 3) fail(CORRUPT, "JPEG: bad SOS table");
      sc[i] = k;
    }
    int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
    int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    if (progressive_) {
      if (ss > se || se > 63 || (ss == 0 && se != 0) ||
          (ss > 0 && ns != 1) || al > 13 || ah > 13) {
        fail(CORRUPT, "JPEG: bad progressive scan parameters");
      }
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    for (int i = 0; i < ns; ++i) {
      Comp* k = sc[i];
      if (!k->latched) {  // jdinput.c latch_quant_tables
        if (!qt_set_[k->tq]) fail(CORRUPT, "JPEG: quantization table "
                                           "missing");
        std::memcpy(k->q, qt_[k->tq], sizeof(k->q));
        k->latched = true;
      }
      k->pred = 0;
      bool need_dc = !progressive_ || (ss == 0 && ah == 0);
      bool need_ac = !progressive_ || ss > 0;
      if (need_dc && !dc_[k->td].present) {
        fail(CORRUPT, "JPEG: Huffman table missing");
      }
      if (need_ac && !ac_[k->ta].present) {
        fail(CORRUPT, "JPEG: Huffman table missing");
      }
      for (int c = ss; c <= se; ++c) k->coef_bits[c] = al;
    }
    BitReader br{d_, n_, pos_};
    eobrun_ = 0;
    int todo = restart_, next_rst = 0;
    auto mcu_start = [&]() {
      if (!restart_) return;
      if (todo == 0) {
        int m = br.next_marker();
        if (m < 0) fail(TRUNCATED, "JPEG: image file is truncated");
        if (m != 0xD0 + next_rst) {
          fail(CORRUPT, "JPEG: expected restart marker RST" +
                            std::to_string(next_rst));
        }
        br.pos += 2;
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        eobrun_ = 0;
        todo = restart_;
      }
      --todo;
    };
    auto block = [&](Comp* k, int bx, int by) {
      int16_t* b = &k->coef[(size_t(by) * k->bw + bx) * 64];
      if (!progressive_) {
        block_baseline(br, k, b);
      } else if (ss == 0) {
        if (ah == 0) {
          int t = br.decode(dc_[k->td]);
          int diff = t ? extend(br.get(t), t) : 0;
          k->pred = add_dc(k->pred, diff);
          b[0] = int16_t(int(unsigned(k->pred) << al));
        } else if (br.get(1)) {
          b[0] = int16_t(b[0] | (1 << al));
        }
      } else if (ah == 0) {
        block_ac_first(br, k, b, ss, se, al);
      } else {
        block_ac_refine(br, k, b, ss, se, al);
      }
    };
    if (ns == 1) {
      Comp* k = sc[0];
      for (int by = 0; by < k->hib; ++by) {
        for (int bx = 0; bx < k->wib; ++bx) {
          mcu_start();
          block(k, bx, by);
        }
      }
    } else {
      for (int my = 0; my < mcuy_; ++my) {
        for (int mx = 0; mx < mcux_; ++mx) {
          mcu_start();
          for (int i = 0; i < ns; ++i) {
            Comp* k = sc[i];
            for (int v = 0; v < k->v; ++v) {
              for (int h = 0; h < k->h; ++h) {
                block(k, mx * k->h + h, my * k->v + v);
              }
            }
          }
        }
      }
    }
    if (br.at_eof) fail(TRUNCATED, "JPEG: image file is truncated");
    // the next marker, past any bytes the scan left
    br.next_marker();
    pos_ = br.pos;
    ++scans_;
  }

  void block_baseline(BitReader& br, Comp* k, int16_t* b) {
    int t = br.decode(dc_[k->td]);
    int diff = t ? extend(br.get(t), t) : 0;
    k->pred = add_dc(k->pred, diff);
    b[0] = int16_t(k->pred);
    const Huff& ac = ac_[k->ta];
    for (int i = 1; i < 64; ++i) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        b[kNatural[i]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  void block_ac_first(BitReader& br, Comp* k, int16_t* b, int ss, int se,
                      int al) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    const Huff& ac = ac_[k->ta];
    for (int i = ss; i <= se; ++i) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        int v = extend(br.get(s), s);
        b[kNatural[i]] = int16_t(int(unsigned(v) << al));
      } else if (r == 15) {
        i += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += br.get(r);
        --eobrun_;
        break;
      }
    }
  }

  void block_ac_refine(BitReader& br, Comp* k, int16_t* b, int ss, int se,
                       int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int i = ss;
    if (eobrun_ == 0) {
      const Huff& ac = ac_[k->ta];
      for (; i <= se; ++i) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br.get(r);
          break;
        }
        do {
          int16_t* c = b + kNatural[i];
          if (*c != 0) {
            if (br.get(1) && (*c & p1) == 0) {
              *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
            }
          } else if (--r < 0) {
            break;
          }
          ++i;
        } while (i <= se);
        if (s) b[kNatural[i]] = int16_t(s);
      }
    }
    if (eobrun_ > 0) {
      for (; i <= se; ++i) {
        int16_t* c = b + kNatural[i];
        if (*c != 0 && br.get(1) && (*c & p1) == 0) {
          *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
        }
      }
      --eobrun_;
    }
  }

  // refuse what libjpeg would smooth (jdcoefct.c smoothing_ok with
  // do_block_smoothing TRUE): a progressive file with every DC known and
  // some of the first nine AC coefficients short of bits
  void check_block_smoothing() const {
    if (!progressive_) return;
    bool useful = false;
    for (int c = 0; c < nc_; ++c) {
      const Comp& k = comp_[c];
      if (!k.latched) return;
      for (int z = 0; z <= 9; ++z) {
        if (k.q[kNatural[z]] == 0) return;
      }
      if (k.coef_bits[0] < 0) return;
      for (int z = 1; z <= 9; ++z) {
        if (k.coef_bits[z] != 0) useful = true;
      }
    }
    if (useful) {
      fail(UNSUPPORTED, "progressive JPEG whose scans leave coefficient "
                        "bits unsent (libjpeg smooths its blocks)");
    }
  }

  bool color_space_ycc() const {
    if (color_ == 1) return true;
    if (color_ == 2) return false;
    if (jfif_) return true;
    if (adobe_) return adobe_transform_ != 0;
    if (comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66) {
      return false;  // 'R', 'G', 'B'
    }
    return true;
  }

  // one component's samples at full size [h_, w_] (jdsample.c)
  std::vector<uint8_t> upsampled(const Comp& k) const {
    const int stride = k.wib * 8;
    std::vector<uint8_t> plane(size_t(stride) * k.hib * 8);
    for (int by = 0; by < k.hib; ++by) {
      for (int bx = 0; bx < k.wib; ++bx) {
        idct_islow(&k.coef[(size_t(by) * k.bw + bx) * 64], k.q,
                   &plane[size_t(by) * 8 * stride + bx * 8], stride);
      }
    }
    const int hr = hmax_ / k.h, vr = vmax_ / k.v;
    if (hr == 1 && vr == 1) {
      if (stride == w_) {
        plane.resize(size_t(w_) * h_);
        return plane;
      }
      std::vector<uint8_t> out(size_t(w_) * h_);
      for (int y = 0; y < h_; ++y) {
        std::memcpy(&out[size_t(y) * w_], &plane[size_t(y) * stride], w_);
      }
      return out;
    }
    const int dw = k.dsw, dh = k.dsh;
    auto row = [&](int y) {
      y = y < 0 ? 0 : y >= dh ? dh - 1 : y;  // jdmainct.c context rows
      return &plane[size_t(y) * stride];
    };
    std::vector<uint8_t> wide(size_t(2) * dw + 2);
    std::vector<uint8_t> out(size_t(w_) * h_);
    for (int y = 0; y < h_; ++y) {
      uint8_t* o = &out[size_t(y) * w_];
      if (hr == 2 && vr == 1) {
        const uint8_t* in = row(y);
        uint8_t* t = wide.data();
        if (dw > 2) {  // h2v1_fancy_upsample
          int iv = in[0];
          t[0] = uint8_t(iv);
          t[1] = uint8_t((iv * 3 + in[1] + 2) >> 2);
          for (int i = 1; i < dw - 1; ++i) {
            iv = in[i] * 3;
            t[2 * i] = uint8_t((iv + in[i - 1] + 1) >> 2);
            t[2 * i + 1] = uint8_t((iv + in[i + 1] + 2) >> 2);
          }
          iv = in[dw - 1];
          t[2 * dw - 2] = uint8_t((iv * 3 + in[dw - 2] + 1) >> 2);
          t[2 * dw - 1] = uint8_t(iv);
        } else {  // h2v1_upsample
          for (int i = 0; i < dw; ++i) t[2 * i] = t[2 * i + 1] = in[i];
        }
        std::memcpy(o, t, w_);
      } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
        int j = y >> 1;
        const uint8_t* in0 = row(j);
        const uint8_t* in1 = (y & 1) ? row(j + 1) : row(j - 1);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < w_; ++x) {
          o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
        }
      } else if (dw > 2) {  // h2v2_fancy_upsample
        int j = y >> 1;
        const uint8_t* in0 = row(j);
        const uint8_t* in1 = (y & 1) ? row(j + 1) : row(j - 1);
        uint8_t* t = wide.data();
        int thiscs = in0[0] * 3 + in1[0];
        int nextcs = in0[1] * 3 + in1[1];
        t[0] = uint8_t((thiscs * 4 + 8) >> 4);
        t[1] = uint8_t((thiscs * 3 + nextcs + 7) >> 4);
        int lastcs = thiscs;
        thiscs = nextcs;
        for (int i = 1; i < dw - 1; ++i) {
          nextcs = in0[i + 1] * 3 + in1[i + 1];
          t[2 * i] = uint8_t((thiscs * 3 + lastcs + 8) >> 4);
          t[2 * i + 1] = uint8_t((thiscs * 3 + nextcs + 7) >> 4);
          lastcs = thiscs;
          thiscs = nextcs;
        }
        t[2 * dw - 2] = uint8_t((thiscs * 3 + lastcs + 8) >> 4);
        t[2 * dw - 1] = uint8_t((thiscs * 4 + 7) >> 4);
        std::memcpy(o, t, w_);
      } else {  // h2v2_upsample
        const uint8_t* in = row(y >> 1);
        for (int x = 0; x < w_; ++x) o[x] = in[x >> 1];
      }
    }
    return out;
  }
};

int jpeg_decode_impl(const uint8_t* data, size_t n, int color, uint8_t* out,
                     int h, int w, int ch) {
  JpegDecoder dec(data, n, color);
  dec.read();
  if (dec.height() != h || dec.width() != w) {
    fail(CORRUPT, "JPEG: size differs from its header");
  }
  dec.output(out, ch);
  return OK;
}

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(sz > 0 ? size_t(sz) : 0);
  size_t got = sz > 0 ? std::fread(buf.data(), 1, buf.size(), f) : 0;
  std::fclose(f);
  return got == buf.size();
}

// ------------------------------------------------------------------ TIFF

// CCITT code tables (ITU-T T.4 tables 2 and 3): {run, bits, length}
struct Code {
  int run;
  uint16_t bits;
  uint8_t len;
};

const Code kWhite[] = {
    {0, 0x35, 8},    {1, 0x7, 6},     {2, 0x7, 4},     {3, 0x8, 4},
    {4, 0xB, 4},     {5, 0xC, 4},     {6, 0xE, 4},     {7, 0xF, 4},
    {8, 0x13, 5},    {9, 0x14, 5},    {10, 0x7, 5},    {11, 0x8, 5},
    {12, 0x8, 6},    {13, 0x3, 6},    {14, 0x34, 6},   {15, 0x35, 6},
    {16, 0x2A, 6},   {17, 0x2B, 6},   {18, 0x27, 7},   {19, 0xC, 7},
    {20, 0x8, 7},    {21, 0x17, 7},   {22, 0x3, 7},    {23, 0x4, 7},
    {24, 0x28, 7},   {25, 0x2B, 7},   {26, 0x13, 7},   {27, 0x24, 7},
    {28, 0x18, 7},   {29, 0x2, 8},    {30, 0x3, 8},    {31, 0x1A, 8},
    {32, 0x1B, 8},   {33, 0x12, 8},   {34, 0x13, 8},   {35, 0x14, 8},
    {36, 0x15, 8},   {37, 0x16, 8},   {38, 0x17, 8},   {39, 0x28, 8},
    {40, 0x29, 8},   {41, 0x2A, 8},   {42, 0x2B, 8},   {43, 0x2C, 8},
    {44, 0x2D, 8},   {45, 0x4, 8},    {46, 0x5, 8},    {47, 0xA, 8},
    {48, 0xB, 8},    {49, 0x52, 8},   {50, 0x53, 8},   {51, 0x54, 8},
    {52, 0x55, 8},   {53, 0x24, 8},   {54, 0x25, 8},   {55, 0x58, 8},
    {56, 0x59, 8},   {57, 0x5A, 8},   {58, 0x5B, 8},   {59, 0x4A, 8},
    {60, 0x4B, 8},   {61, 0x32, 8},   {62, 0x33, 8},   {63, 0x34, 8},
    {64, 0x1B, 5},   {128, 0x12, 5},  {192, 0x17, 6},  {256, 0x37, 7},
    {320, 0x36, 8},  {384, 0x37, 8},  {448, 0x64, 8},  {512, 0x65, 8},
    {576, 0x68, 8},  {640, 0x67, 8},  {704, 0xCC, 9},  {768, 0xCD, 9},
    {832, 0xD2, 9},  {896, 0xD3, 9},  {960, 0xD4, 9},  {1024, 0xD5, 9},
    {1088, 0xD6, 9}, {1152, 0xD7, 9}, {1216, 0xD8, 9}, {1280, 0xD9, 9},
    {1344, 0xDA, 9}, {1408, 0xDB, 9}, {1472, 0x98, 9}, {1536, 0x99, 9},
    {1600, 0x9A, 9}, {1664, 0x18, 6}, {1728, 0x9B, 9},
};

const Code kBlack[] = {
    {0, 0x37, 10},    {1, 0x2, 3},      {2, 0x3, 2},      {3, 0x2, 2},
    {4, 0x3, 3},      {5, 0x3, 4},      {6, 0x2, 4},      {7, 0x3, 5},
    {8, 0x5, 6},      {9, 0x4, 6},      {10, 0x4, 7},     {11, 0x5, 7},
    {12, 0x7, 7},     {13, 0x4, 8},     {14, 0x7, 8},     {15, 0x18, 9},
    {16, 0x17, 10},   {17, 0x18, 10},   {18, 0x8, 10},    {19, 0x67, 11},
    {20, 0x68, 11},   {21, 0x6C, 11},   {22, 0x37, 11},   {23, 0x28, 11},
    {24, 0x17, 11},   {25, 0x18, 11},   {26, 0xCA, 12},   {27, 0xCB, 12},
    {28, 0xCC, 12},   {29, 0xCD, 12},   {30, 0x68, 12},   {31, 0x69, 12},
    {32, 0x6A, 12},   {33, 0x6B, 12},   {34, 0xD2, 12},   {35, 0xD3, 12},
    {36, 0xD4, 12},   {37, 0xD5, 12},   {38, 0xD6, 12},   {39, 0xD7, 12},
    {40, 0x6C, 12},   {41, 0x6D, 12},   {42, 0xDA, 12},   {43, 0xDB, 12},
    {44, 0x54, 12},   {45, 0x55, 12},   {46, 0x56, 12},   {47, 0x57, 12},
    {48, 0x64, 12},   {49, 0x65, 12},   {50, 0x52, 12},   {51, 0x53, 12},
    {52, 0x24, 12},   {53, 0x37, 12},   {54, 0x38, 12},   {55, 0x27, 12},
    {56, 0x28, 12},   {57, 0x58, 12},   {58, 0x59, 12},   {59, 0x2B, 12},
    {60, 0x2C, 12},   {61, 0x5A, 12},   {62, 0x66, 12},   {63, 0x67, 12},
    {64, 0xF, 10},    {128, 0xC8, 12},  {192, 0xC9, 12},  {256, 0x5B, 12},
    {320, 0x33, 12},  {384, 0x34, 12},  {448, 0x35, 12},  {512, 0x6C, 13},
    {576, 0x6D, 13},  {640, 0x4A, 13},  {704, 0x4B, 13},  {768, 0x4C, 13},
    {832, 0x4D, 13},  {896, 0x72, 13},  {960, 0x73, 13},  {1024, 0x74, 13},
    {1088, 0x75, 13}, {1152, 0x76, 13}, {1216, 0x77, 13}, {1280, 0x52, 13},
    {1344, 0x53, 13}, {1408, 0x54, 13}, {1472, 0x55, 13}, {1536, 0x5A, 13},
    {1600, 0x5B, 13}, {1664, 0x64, 13}, {1728, 0x65, 13},
};

// extended make-up codes, shared by both colours
const Code kExtended[] = {
    {1792, 0x8, 11},  {1856, 0xC, 11},  {1920, 0xD, 11},  {1984, 0x12, 12},
    {2048, 0x13, 12}, {2112, 0x14, 12}, {2176, 0x15, 12}, {2240, 0x16, 12},
    {2304, 0x17, 12}, {2368, 0x1C, 12}, {2432, 0x1D, 12}, {2496, 0x1E, 12},
    {2560, 0x1F, 12},
};

// 13-bit lookup: (run + 1) << 4 | length, 0 for no code
struct RunTable {
  std::vector<uint32_t> t;
  explicit RunTable(const Code* codes, size_t n) : t(1 << 13, 0) {
    auto add = [&](const Code& c) {
      int shift = 13 - c.len;
      for (int j = 0; j < (1 << shift); ++j) {
        t[(c.bits << shift) | j] = uint32_t((c.run + 1) << 4 | c.len);
      }
    };
    for (size_t i = 0; i < n; ++i) add(codes[i]);
    for (const Code& c : kExtended) add(c);
  }
};

const RunTable& white_table() {
  static const RunTable t(kWhite, sizeof(kWhite) / sizeof(Code));
  return t;
}
const RunTable& black_table() {
  static const RunTable t(kBlack, sizeof(kBlack) / sizeof(Code));
  return t;
}

struct FaxBits {
  const uint8_t* d;
  size_t n;
  bool reverse;  // FillOrder 2: least significant bit first
  size_t bitpos = 0;

  inline int bit_at(size_t p) const {
    size_t byte = p >> 3;
    if (byte >= n) return 0;
    int b = d[byte];
    int k = int(p & 7);
    return reverse ? (b >> k) & 1 : (b >> (7 - k)) & 1;
  }
  inline uint32_t peek(int k) const {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) v = (v << 1) | uint32_t(bit_at(bitpos + i));
    return v;
  }
  bool exhausted() const { return bitpos >= n * 8; }
  void align() { bitpos = (bitpos + 7) & ~size_t(7); }
};

int fax_run(FaxBits& br, bool white) {
  const RunTable& t = white ? white_table() : black_table();
  int total = 0;
  for (;;) {
    if (br.exhausted()) fail(TRUNCATED, "TIFF: CCITT data ends mid-row");
    uint32_t e = t.t[br.peek(13)];
    if (!e) fail(CORRUPT, "TIFF: bad CCITT run code");
    br.bitpos += e & 15;
    int run = int(e >> 4) - 1;
    total += run;
    if (run < 64) return total;
  }
}

// skip fill zeros and one EOL (000000000001) if one is next
bool fax_eol(FaxBits& br) {
  size_t p = br.bitpos;
  int zeros = 0;
  while (p < br.n * 8 && br.bit_at(p) == 0) {
    ++zeros;
    ++p;
  }
  if (zeros >= 11 && p < br.n * 8) {
    br.bitpos = p + 1;
    return true;
  }
  return false;
}

void fill_run(uint8_t* row, int a, int b, bool black) {
  if (black) {
    for (int x = a; x < b; ++x) row[x] = 1;
  }
}

void fax_row_1d(FaxBits& br, uint8_t* row, int width) {
  int a = 0;
  bool white = true;
  while (a < width) {
    int run = fax_run(br, white);
    int b = std::min(width, a + run);
    fill_run(row, a, b, !white);
    a += run;
    white = !white;
  }
  if (a != width) fail(CORRUPT, "TIFF: CCITT row runs past its width");
}

// changing elements of a row (pixel colours 0 white, 1 black), with
// width sentinels
void changes(const uint8_t* row, int width, std::vector<int>& out) {
  out.clear();
  int prev = 0;
  for (int x = 0; x < width; ++x) {
    if (row[x] != prev) {
      out.push_back(x);
      prev = row[x];
    }
  }
  for (int i = 0; i < 4; ++i) out.push_back(width);
}

void fax_row_2d(FaxBits& br, uint8_t* row, int width,
                const std::vector<int>& ref) {
  int a0 = -1;
  bool white = true;
  size_t ri = 0;
  while (a0 < width) {
    // b1: the first changing element right of a0 whose colour is the
    // opposite of a0's (even indices turn black); the sentinels end it
    while (ref[ri] <= a0) ++ri;
    size_t bi = ri + (((ri & 1) != (white ? 0u : 1u)) ? 1 : 0);
    int b1 = ref[bi], b2 = ref[bi + 1];
    int start = a0 < 0 ? 0 : a0;
    if (br.exhausted()) fail(TRUNCATED, "TIFF: CCITT data ends mid-row");
    uint32_t p7 = br.peek(7);
    int a1;
    if (p7 >> 6 == 1) {  // V0: 1
      br.bitpos += 1;
      a1 = b1;
    } else if (p7 >> 4 == 3 || p7 >> 4 == 2) {  // VR1 011, VL1 010
      br.bitpos += 3;
      a1 = (p7 >> 4 == 3) ? b1 + 1 : b1 - 1;
    } else if (p7 >> 4 == 1) {  // H: 001
      br.bitpos += 3;
      int r1 = fax_run(br, white);
      int r2 = fax_run(br, !white);
      if (start + r1 + r2 > width) {
        fail(CORRUPT, "TIFF: CCITT row runs past its width");
      }
      fill_run(row, start, start + r1, !white);
      fill_run(row, start + r1, start + r1 + r2, white);
      a0 = start + r1 + r2;
      continue;
    } else if (p7 >> 3 == 1) {  // P: 0001
      br.bitpos += 4;
      fill_run(row, start, b2, !white);
      a0 = b2;
      continue;
    } else if (p7 >> 1 == 3 || p7 >> 1 == 2) {  // VR2 000011, VL2 000010
      br.bitpos += 6;
      a1 = (p7 >> 1 == 3) ? b1 + 2 : b1 - 2;
    } else if (p7 == 3 || p7 == 2) {  // VR3 0000011, VL3 0000010
      br.bitpos += 7;
      a1 = (p7 == 3) ? b1 + 3 : b1 - 3;
    } else if (p7 == 1) {
      fail(UNSUPPORTED, "TIFF: CCITT uses an extension (uncompressed) mode");
    } else {
      fail(CORRUPT, "TIFF: bad CCITT mode code");
    }
    if (a1 < start || a1 > width) fail(CORRUPT, "TIFF: bad CCITT V code");
    fill_run(row, start, a1, !white);
    a0 = a1;
    white = !white;
  }
}

}  // namespace

extern "C" {

int decode_jpeg(const uint8_t* data, size_t n, int color, uint8_t* out,
                int h, int w, int ch, char* err, int errlen) {
  try {
    return jpeg_decode_impl(data, n, color, out, h, w, ch);
  } catch (const DecodeError& e) {
    set_err(err, errlen, e.msg);
    return e.status;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "JPEG: out of memory");
    return CORRUPT;
  }
}

// JPEG files over a thread pool, straight from their paths: status[i] 0
// and outs[i] filled as uint8 [hs[i], ws[i], chs[i]], or the status and
// message (errs + i * errlen) of the failure
void decode_jpeg_batch(const char** paths, int n, uint8_t** outs,
                       const int* hs, const int* ws, const int* chs,
                       int num_threads, int* status, char* errs,
                       int errlen) {
  parallel_for(n, num_threads, [&](int i) {
    char* err = errs + size_t(i) * errlen;
    std::vector<uint8_t> buf;
    if (!read_file(paths[i], buf)) {
      set_err(err, errlen, "cannot read the file");
      status[i] = IO;
      return;
    }
    status[i] = decode_jpeg(buf.data(), buf.size(), 0, outs[i], hs[i], ws[i],
                            chs[i], err, errlen);
  });
}

// PackBits: bytes written into dst (at most dn), -1 on a run past dn
long packbits_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t dn) {
  size_t i = 0, o = 0;
  while (i < n && o < dn) {
    int c = int8_t(src[i++]);
    if (c >= 0) {
      size_t k = size_t(c) + 1;
      if (i + k > n) k = n - i;
      if (o + k > dn) return -1;
      std::memcpy(dst + o, src + i, k);
      i += k;
      o += k;
    } else if (c != -128) {
      size_t k = size_t(1 - c);
      if (i >= n) break;
      if (o + k > dn) return -1;
      std::memset(dst + o, src[i++], k);
      o += k;
    }
  }
  return long(o);
}

// TIFF LZW (MSB-first codes, code width growing one code early): bytes
// written into dst (at most dn), or -status with the message in err
long tiff_lzw_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t dn,
                     char* err, int errlen) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) {
    set_err(err, errlen, "TIFF uses the old-style (LSB-first) LZW");
    return -UNSUPPORTED;
  }
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  std::vector<uint16_t> length(4096);
  std::vector<uint8_t> stack(4096);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0xFFFF;
    suffix[i] = first[i] = uint8_t(i);
    length[i] = 1;
  }
  int next = 258, width = 9, old = -1;
  uint64_t acc = 0;
  int bits = 0;
  size_t i = 0, o = 0;
  for (;;) {
    while (bits < width) {
      if (i >= n) return long(o);  // data ends without an EOI code
      acc = (acc << 8) | src[i++];
      bits += 8;
    }
    int code = int((acc >> (bits - width)) & ((1u << width) - 1));
    bits -= width;
    if (code == 257) break;
    if (code == 256) {
      next = 258;
      width = 9;
      old = -1;
      continue;
    }
    int emit;
    if (old < 0) {
      if (code > 255) {
        set_err(err, errlen, "TIFF: bad LZW code");
        return -CORRUPT;
      }
      emit = code;
    } else if (code < next) {
      emit = code;
      if (next < 4096) {
        prefix[next] = uint16_t(old);
        suffix[next] = first[code];
        first[next] = first[old];
        length[next] = uint16_t(length[old] + 1);
        ++next;
      }
    } else if (code == next && next < 4096) {
      prefix[next] = uint16_t(old);
      suffix[next] = first[old];
      first[next] = first[old];
      length[next] = uint16_t(length[old] + 1);
      emit = next++;
    } else {
      set_err(err, errlen, "TIFF: bad LZW code");
      return -CORRUPT;
    }
    int len = length[emit];
    if (o + len > dn) len = int(dn - o);  // a strip may code past its rows
    int sp = length[emit];
    int c = emit;
    while (sp > 0) {
      stack[--sp] = suffix[c];
      c = prefix[c];
    }
    std::memcpy(dst + o, stack.data(), len);
    o += len;
    old = code;
    if (next + 1 >= (1 << width) && width < 12) ++width;
    if (o >= dn) break;
  }
  return long(o);
}

// CCITT bilevel rows into dst (rows x stride bytes, one byte a pixel, 1
// for a black run).  mode 2: modified Huffman, rows byte-aligned; 3: T.4
// (t4_options bit 0: 2-D), EOLs; 4: T.6.  Returns rows decoded or -status.
long ccitt_decode(const uint8_t* src, size_t n, int mode, int t4_options,
                  int fill_order, int width, int rows, uint8_t* dst,
                  char* err, int errlen) {
  try {
    if (mode == 3 && (t4_options & 2)) {
      fail(UNSUPPORTED, "TIFF: CCITT T.4 with uncompressed mode");
    }
    FaxBits br{src, n, fill_order == 2};
    std::vector<uint8_t> blank(width, 0);
    std::vector<int> ref;
    changes(blank.data(), width, ref);
    std::memset(dst, 0, size_t(rows) * width);
    for (int y = 0; y < rows; ++y) {
      uint8_t* row = dst + size_t(y) * width;
      if (mode == 2) {
        fax_row_1d(br, row, width);
        br.align();
      } else if (mode == 3) {
        fax_eol(br);
        bool two_d = false;
        if (t4_options & 1) {  // tag bit: 1 a 1-D row, 0 a 2-D row
          two_d = br.peek(1) == 0;
          br.bitpos += 1;
        }
        if (two_d) {
          fax_row_2d(br, row, width, ref);
        } else {
          fax_row_1d(br, row, width);
        }
      } else {
        fax_row_2d(br, row, width, ref);
      }
      changes(row, width, ref);
    }
    return rows;
  } catch (const DecodeError& e) {
    set_err(err, errlen, e.msg);
    return -e.status;
  }
}

// GIF LZW (LSB-first codes): pixels written into dst (at most dn), or
// -status with the message in err
long gif_lzw_decode(const uint8_t* src, size_t n, int min_code_size,
                    uint8_t* dst, size_t dn, char* err, int errlen) {
  if (min_code_size < 1 || min_code_size > 11) {
    set_err(err, errlen, "GIF: bad LZW code size");
    return -CORRUPT;
  }
  const int clear = 1 << min_code_size, eoi = clear + 1;
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  std::vector<uint16_t> length(4096);
  std::vector<uint8_t> stack(4096);
  for (int i = 0; i < clear; ++i) {
    prefix[i] = 0xFFFF;
    suffix[i] = first[i] = uint8_t(i);
    length[i] = 1;
  }
  int width = min_code_size + 1, next = clear + 2, old = -1;
  uint64_t acc = 0;
  int bits = 0;
  size_t i = 0, o = 0;
  while (o < dn) {
    while (bits < width) {
      if (i >= n) return long(o);
      acc |= uint64_t(src[i++]) << bits;
      bits += 8;
    }
    int code = int(acc & ((1u << width) - 1));
    acc >>= width;
    bits -= width;
    if (code == clear) {
      width = min_code_size + 1;
      next = clear + 2;
      old = -1;
      continue;
    }
    if (code == eoi) break;
    int emit;
    if (old < 0) {
      if (code >= clear) {
        set_err(err, errlen, "GIF: bad LZW code");
        return -CORRUPT;
      }
      emit = code;
    } else if (code < next) {
      emit = code;
      if (next < 4096) {
        prefix[next] = uint16_t(old);
        suffix[next] = first[code];
        first[next] = first[old];
        length[next] = uint16_t(length[old] + 1);
        ++next;
      }
    } else if (code == next && next < 4096) {
      prefix[next] = uint16_t(old);
      suffix[next] = first[old];
      first[next] = first[old];
      length[next] = uint16_t(length[old] + 1);
      emit = next++;
    } else {
      set_err(err, errlen, "GIF: bad LZW code");
      return -CORRUPT;
    }
    int sp = length[emit];
    int len = std::min<size_t>(sp, dn - o);
    int c = emit;
    while (sp > 0) {
      stack[--sp] = suffix[c];
      c = prefix[c];
    }
    std::memcpy(dst + o, stack.data(), len);
    o += len;
    old = code;
    if (next >= (1 << width) && width < 12) ++width;
  }
  return long(o);
}

}  // extern "C"
