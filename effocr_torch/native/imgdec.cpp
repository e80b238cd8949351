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
// would smooth its blocks: jdcoefct.c smoothing_ok).  Entropy data that
// ends early (at a marker inside a scan, or, for a TIFF segment, at the
// end of its bytes, where libtiff's source manager inserts an EOI) is
// read as jdhuff.c reads it: zero bits finish the MCU that ran out, and
// the MCUs after it stay zero (uniform gray) until a restart marker.
// A stand-alone file that ends early is truncated, as Pillow says; the
// caller of a TIFF segment appends the EOIs libtiff's source manager
// gives (tiff_fill_input_buffer) and asks for kSegment.
//
// The whole file is entropy-decoded into one coefficient buffer per
// component (baseline and progressive alike), then each block is
// dequantised and inverse-transformed, upsampled and colour-converted.
//
// TIFF: PackBits, LZW (MSB-first, the old LSB-first variant refused),
// CCITT modified Huffman (compression 2, and 32771 word-aligned), T.4
// 1-D / 2-D (3) and T.6 (4) as libtiff decodes them, damaged or cut data
// included; ThunderScan (32809); ZSTD (50000, RFC 8878, as libzstd 1.5.7
// decodes it under libtiff); the component planes of a JPEG stream for
// old-style JPEG (6).
// GIF: LZW.  Deflate and LZMA stay with Python's zlib and lzma.
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
        // jdhuff.c's check, before the code indexes the fast table
        if (code >= (1 << l)) fail(CORRUPT, "JPEG: bad Huffman table");
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
  int valid = 0;           // bits of acc that came from the data
  bool insufficient = false;  // jdhuff.c: a bit past the data was used

  void fill() {
    while (bits <= 56) {
      uint64_t b = 0;
      if (!at_marker && !at_eof) {
        if (pos >= n) {
          at_eof = true;
        } else if (d[pos] != 0xFF) {
          b = d[pos++];
          valid += 8;
        } else {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;
          if (q >= n) {
            at_eof = true;
          } else if (d[q] == 0) {
            b = 0xFF;
            pos = q + 1;
            valid += 8;
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
    valid -= k;
    if (valid < 0) insufficient = true;
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
    valid = 0;
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

// jidctint.c jpeg_idct_islow as libjpeg-turbo's x86 SIMD computes it
// (jidctint-avx2.asm, which Pillow's libjpeg-turbo runs): coefficients
// dequantized as 16-bit products (vpmullw), the sums in0 +- in4, in7 + in3
// and in5 + in1 in 16 bits (vpaddw), the rest in 32 bits through
// vpmaddwd pairs, each pass's outputs saturated to 16 bits (vpackssdw),
// the last to 8 bits (vpacksswb) and shifted by 128.  On the coefficients
// of a valid file nothing wraps or saturates and this is jidctint.c; on
// those of corrupt data (a segment cut inside a block) it is the SIMD's.
constexpr int CONST_BITS = 13, PASS1_BITS = 2;

inline int16_t wrap16(int32_t v) { return int16_t(uint16_t(uint32_t(v))); }
inline int16_t sat16(int32_t v) {
  return int16_t(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}

// one 8-point pass on eight lanes at once, as the SIMD runs it: x[k * 8 +
// l] is input k of lane l (lanes are columns in the first pass, rows in
// the second); y[k * 8 + l] gets output k, descaled by n bits and
// saturated to 16 bits.  From 16-bit inputs no 32-bit sum here passes
// 1.7e9, so the SIMD's 32-bit lanes never wrap.
inline void idct_pass8(const int32_t* x, int32_t* y, int n) {
  const int32_t r = 1 << (n - 1);
  for (int l = 0; l < 8; ++l) {
    int32_t tmp0 = int32_t(wrap16(x[l] + x[32 + l])) * (1 << CONST_BITS);
    int32_t tmp1 = int32_t(wrap16(x[l] - x[32 + l])) * (1 << CONST_BITS);
    int32_t i2 = x[16 + l], i6 = x[48 + l];
    int32_t tmp3 = i2 * (4433 + 6270) + i6 * 4433;
    int32_t tmp2 = i2 * 4433 + i6 * (4433 - 15137);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int32_t i7 = x[56 + l], i5 = x[40 + l], i3 = x[24 + l], i1 = x[8 + l];
    int32_t z3 = wrap16(i7 + i3), z4 = wrap16(i5 + i1);
    int32_t z3p = z3 * (9633 - 16069) + z4 * 9633;
    int32_t z4p = z3 * 9633 + z4 * (9633 - 3196);
    int32_t o0 = i7 * (2446 - 7373) + i1 * -7373 + z3p;
    int32_t o3 = i7 * -7373 + i1 * (12299 - 7373) + z4p;
    int32_t o1 = i5 * (16819 - 20995) + i3 * -20995 + z4p;
    int32_t o2 = i5 * -20995 + i3 * (25172 - 20995) + z3p;
    y[l] = sat16((tmp10 + o3 + r) >> n);
    y[56 + l] = sat16((tmp10 - o3 + r) >> n);
    y[8 + l] = sat16((tmp11 + o2 + r) >> n);
    y[48 + l] = sat16((tmp11 - o2 + r) >> n);
    y[16 + l] = sat16((tmp12 + o1 + r) >> n);
    y[40 + l] = sat16((tmp12 - o1 + r) >> n);
    y[24 + l] = sat16((tmp13 + o0 + r) >> n);
    y[32 + l] = sat16((tmp13 - o0 + r) >> n);
  }
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int32_t dq[64], ws[64], t[64], res[64];
  bool ac_rows = false;      // any coefficient past the first row
  for (int k = 8; k < 64; ++k) ac_rows = ac_rows || in[k];
  bool ac = ac_rows;
  for (int k = 1; k < 8; ++k) ac = ac || in[k];
  if (!ac) {                 // DC alone: both passes in closed form
    int32_t v = (wrap16(wrap16(int32_t(in[0]) * q[0]) * 4) + 16) >> 5;
    uint8_t b = uint8_t((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
    for (int r = 0; r < 8; ++r) std::memset(out + r * stride, b, 8);
    return;
  }
  for (int k = 0; k < 64; ++k) dq[k] = wrap16(int32_t(in[k]) * q[k]);
  if (ac_rows) {
    idct_pass8(dq, ws, CONST_BITS - PASS1_BITS);
  } else {                   // the SIMD's shortcut: in0 << 2, in 16 bits
    for (int k = 0; k < 64; ++k) ws[k] = wrap16(dq[k & 7] * 4);
  }
  for (int r = 0; r < 8; ++r) {
    for (int c = 0; c < 8; ++c) t[c * 8 + r] = ws[r * 8 + c];
  }
  idct_pass8(t, res, CONST_BITS + PASS1_BITS + 3);
  for (int r = 0; r < 8; ++r) {
    uint8_t* op = out + r * stride;
    for (int c = 0; c < 8; ++c) {
      int32_t v = res[c * 8 + r];
      op[c] = uint8_t((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
    }
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
// RGB), 2 no conversion (libtiff's JCS_UNKNOWN for other photometrics);
// plus kSegment: the data is a TIFF strip or tile, where an EOI in place
// of a restart marker is libtiff's (jdmarker.c resync action 3: the
// marker stays, and each interval after it is an empty segment)
constexpr int kSegment = 8;
// plus kRaw: each component's samples at its own sampling, as libjpeg's
// jpeg_read_raw_data gives them to libtiff's old-style JPEG codec (any
// sampling factors: nothing is upsampled); plus kFirstScan: nothing past
// the first scan is read (that codec stops once its rows are decoded)
constexpr int kRaw = 16;
constexpr int kFirstScan = 32;

class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* d, size_t n, int color) : d_(d), n_(n),
      color_(color & ~(kSegment | kRaw | kFirstScan)),
      segment_(color & kSegment), raw_(color & kRaw),
      first_scan_(color & kFirstScan) {}

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
        if (first_scan_) break;
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

  // bytes of output_raw
  size_t raw_size() const {
    size_t n = 0;
    for (int c = 0; c < nc_; ++c) n += size_t(comp_[c].dsw) * comp_[c].dsh;
    return n;
  }
  // each component's samples [dsh, dsw], one plane after another, neither
  // upsampled nor colour-converted
  void output_raw(uint8_t* out) {
    check_block_smoothing();
    for (int c = 0; c < nc_; ++c) {
      const Comp& k = comp_[c];
      std::vector<uint8_t> plane = blocks(k);
      for (int y = 0; y < k.dsh; ++y) {
        std::memcpy(out, &plane[size_t(y) * k.wib * 8], k.dsw);
        out += k.dsw;
      }
    }
  }

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
  bool segment_, raw_, first_scan_;
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
    if (!ok && nc_ > 1 && !raw_) {
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
    // whether the MCU starting here is decoded: not after the data ran
    // out, until a restart marker comes (jdhuff.c process_restart)
    auto mcu_start = [&]() -> bool {
      if (!restart_) return !br.insufficient;
      if (todo == 0) {
        int m = br.next_marker();
        if (m == 0xD9 && segment_) {
          br.at_marker = true;    // not passed: the next intervals are empty
        } else {
          if (m < 0) fail(TRUNCATED, "JPEG: image file is truncated");
          if (m != 0xD0 + next_rst) {
            fail(CORRUPT, "JPEG: expected restart marker RST" +
                              std::to_string(next_rst));
          }
          br.pos += 2;
          br.insufficient = false;
        }
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        eobrun_ = 0;
        todo = restart_;
      }
      --todo;
      return !br.insufficient;
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
          if (mcu_start()) block(k, bx, by);
        }
      }
    } else {
      for (int my = 0; my < mcuy_; ++my) {
        for (int mx = 0; mx < mcux_; ++mx) {
          if (!mcu_start()) continue;
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

  // one component's inverse-transformed blocks [hib * 8, wib * 8]
  std::vector<uint8_t> blocks(const Comp& k) const {
    const int stride = k.wib * 8;
    std::vector<uint8_t> plane(size_t(stride) * k.hib * 8);
    for (int by = 0; by < k.hib; ++by) {
      for (int bx = 0; bx < k.wib; ++bx) {
        idct_islow(&k.coef[(size_t(by) * k.bw + bx) * 64], k.q,
                   &plane[size_t(by) * 8 * stride + bx * 8], stride);
      }
    }
    return plane;
  }

  // one component's samples at full size [h_, w_] (jdsample.c)
  std::vector<uint8_t> upsampled(const Comp& k) const {
    const int stride = k.wib * 8;
    std::vector<uint8_t> plane = blocks(k);
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
  if (color & kRaw) {  // ch: the bytes of out
    if (dec.raw_size() != size_t(ch)) {
      fail(CORRUPT, "JPEG: raw planes of another size than expected");
    }
    dec.output_raw(out);
    return OK;
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

// libtiff 4.7.1's CCITT decoders (tif_fax3.h, tif_fax3.c), step for step,
// so that data cut short or damaged gives libtiff's rows, as Pillow reads
// them: table lookups on LSB-first bits, zero bits padded at the end of
// the data while any bit is left, rows finished by CLEANUP_RUNS and
// written by _TIFFFax3fillruns, T.4's retry without EOLs.
enum FaxCode : uint8_t {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext,
  S_TermW, S_TermB, S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct FaxEnt {
  uint8_t state = S_Null;
  uint8_t width = 0;
  uint16_t param = 0;
};

// libtiff's TIFFFaxMainTable (7 bits), TIFFFaxWhiteTable (12) and
// TIFFFaxBlackTable (13), indexed by the next bits, first bit lowest, as
// mkg3states fills them; codes no table holds stay S_Null of width 0
struct FaxTables {
  std::vector<FaxEnt> main, white, black;
  FaxTables() : main(1 << 7), white(1 << 12), black(1 << 13) {
    auto put = [](std::vector<FaxEnt>& t, int size, uint32_t bits, int len,
                  FaxCode state, int param) {
      uint32_t r = 0;
      for (int i = 0; i < len; ++i) r |= ((bits >> i) & 1u) << (len - 1 - i);
      for (uint32_t k = r; k < (1u << size); k += 1u << len) {
        t[k] = FaxEnt{uint8_t(state), uint8_t(len), uint16_t(param)};
      }
    };
    put(main, 7, 0x1, 4, S_Pass, 0);
    put(main, 7, 0x1, 3, S_Horiz, 0);
    put(main, 7, 0x1, 1, S_V0, 0);
    put(main, 7, 0x3, 3, S_VR, 1);
    put(main, 7, 0x3, 6, S_VR, 2);
    put(main, 7, 0x3, 7, S_VR, 3);
    put(main, 7, 0x2, 3, S_VL, 1);
    put(main, 7, 0x2, 6, S_VL, 2);
    put(main, 7, 0x2, 7, S_VL, 3);
    put(main, 7, 0x1, 7, S_Ext, 0);
    put(main, 7, 0x0, 7, S_EOL, 0);
    for (const Code& c : kWhite) {
      put(white, 12, c.bits, c.len, c.run < 64 ? S_TermW : S_MakeUpW, c.run);
    }
    for (const Code& c : kBlack) {
      put(black, 13, c.bits, c.len, c.run < 64 ? S_TermB : S_MakeUpB, c.run);
    }
    for (const Code& c : kExtended) {
      put(white, 12, c.bits, c.len, S_MakeUp, c.run);
      put(black, 13, c.bits, c.len, S_MakeUp, c.run);
    }
    put(white, 12, 0x0, 11, S_EOL, 0);
    put(black, 13, 0x0, 11, S_EOL, 0);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables t;
  return t;
}

// libtiff keeps int positions and uint32_t runs and mixes them; the sums
// wrap as they do there
inline int32_t wrap(int64_t v) { return int32_t(uint32_t(uint64_t(v))); }

// One strip or tile.  runs: the image's run arrays (2 * nruns entries,
// allocated and zeroed once an image, as Fax3SetupState does), whose
// halves are the row being decoded and the reference row.
struct Fax {
  enum End { kRow, kData, kOverflow };  // eol / eof label / buffer overflow

  const FaxTables& tab = fax_tables();
  const uint8_t* d;
  size_t cp = 0, ep;
  bool reverse;  // FillOrder 1: each byte's bits reversed (the bitmap)
  uint32_t BitAcc = 0;
  int BitsAvail = 0;
  int EOLcnt = 0;
  int lastx;
  uint32_t* runs;
  size_t nruns, cur = 0, ref;
  // the row's state
  int a0 = 0, RunLength = 0, b1 = 0;
  size_t thisrun = 0, pa = 0, pb = 0;

  uint32_t byte(size_t i) const {
    uint32_t b = d[i];
    if (!reverse) return b;
    b = ((b & 0xF0) >> 4) | ((b & 0x0F) << 4);
    b = ((b & 0xCC) >> 2) | ((b & 0x33) << 2);
    return ((b & 0xAA) >> 1) | ((b & 0x55) << 1);
  }
  // NeedBits8 / NeedBits16: false where libtiff jumps to the end-of-data
  // label (no bit left); bits past the end read as zeros
  bool need(int n) {
    if (BitsAvail >= n) return true;
    if (cp >= ep) {
      if (BitsAvail == 0) return false;
      BitsAvail = n;
      return true;
    }
    BitAcc |= byte(cp++) << BitsAvail;
    BitsAvail += 8;
    if (n > 8 && BitsAvail < n) {
      if (cp >= ep) {
        BitsAvail = n;
      } else {
        BitAcc |= byte(cp++) << BitsAvail;
        BitsAvail += 8;
      }
    }
    return true;
  }
  uint32_t get(int n) const { return BitAcc & ((1u << n) - 1); }
  void clr(int n) {
    BitsAvail -= n;
    BitAcc >>= n;
  }
  bool lookup(int wid, const std::vector<FaxEnt>& t, FaxEnt& e) {
    if (!need(wid)) return false;
    e = t[get(wid)];
    clr(e.width);
    return true;
  }

  void start_row() {
    a0 = 0;
    RunLength = 0;
    thisrun = pa = cur;
  }
  // SETVALUE
  bool set(int x) {
    if (pa >= thisrun + nruns) return false;
    runs[pa++] = uint32_t(wrap(int64_t(RunLength) + x));
    a0 = wrap(int64_t(a0) + x);
    RunLength = 0;
    return true;
  }
  // CLEANUP_RUNS
  bool cleanup() {
    if (RunLength && !set(0)) return false;
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 = wrap(int64_t(a0) - runs[--pa]);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (((pa - thisrun) & 1) && !set(0)) return false;
        if (!set(lastx - a0)) return false;
      } else if (a0 > lastx) {
        if (!set(lastx) || !set(0)) return false;
      }
    }
    return true;
  }
  // CHECK_b1
  bool check_b1() {
    if (pa != thisrun) {
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= ref + nruns) return false;
        b1 = wrap(int64_t(b1) + runs[pb] + runs[pb + 1]);
        pb += 2;
      }
    }
    return true;
  }
  // the row's runs into row (one byte a pixel, 1 in a black run), as
  // _TIFFFax3fillruns: runs past lastx are cut there, pixels past the
  // last run are not written
  void fill(uint8_t* row) {
    size_t erun = pa;
    if ((erun - thisrun) & 1) runs[erun++] = 0;  // a spare word past 2 nruns
    uint32_t x = 0, lx = uint32_t(lastx);
    for (size_t i = thisrun; i < erun; i += 2) {
      for (int k = 0; k < 2; ++k) {
        uint32_t run = runs[i + k];
        if (x + run > lx || run > lx) run = runs[i + k] = lx - x;
        if (run) {
          std::memset(row + x, k, run);
          x += run;
        }
      }
    }
  }
  // EXPAND1D: the runs of a 1-D row
  End expand1d() {
    End end = kRow;
    FaxEnt e;
    for (;;) {
      for (int black = 0; black < 2; ++black) {
        for (;;) {
          bool ok = black ? lookup(13, tab.black, e) : lookup(12, tab.white, e);
          if (!ok) {
            end = kData;
            goto out;
          }
          if (e.state == S_EOL) {
            EOLcnt = 1;
            goto out;
          }
          if (e.state == (black ? S_TermB : S_TermW)) {
            if (!set(e.param)) return kOverflow;
            break;
          }
          if (e.state == (black ? S_MakeUpB : S_MakeUpW) ||
              e.state == S_MakeUp) {
            a0 = wrap(int64_t(a0) + e.param);
            RunLength = wrap(int64_t(RunLength) + e.param);
          } else {
            goto out;  // unexpected
          }
        }
        if (a0 >= lastx) goto out;
      }
      if (runs[pa - 1] == 0 && runs[pa - 2] == 0) pa -= 2;
    }
  out:
    return cleanup() ? end : kOverflow;
  }
  // EXPAND2D: the runs of a 2-D row against the reference row's
  End expand2d() {
    End end = kRow;
    FaxEnt e;
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) return kOverflow;
      if (!lookup(7, tab.main, e)) {
        end = kData;
        goto out;
      }
      switch (e.state) {
        case S_Pass:
          if (!check_b1() || pb + 1 >= ref + nruns) return kOverflow;
          b1 = wrap(int64_t(b1) + runs[pb++]);
          RunLength = wrap(int64_t(RunLength) + b1 - a0);
          a0 = b1;
          b1 = wrap(int64_t(b1) + runs[pb++]);
          break;
        case S_Horiz: {
          // the colour of the run to come: white after an even count
          int first = (pa - thisrun) & 1;
          for (int k = 0; k < 2; ++k) {
            int black = first ^ k;
            for (;;) {
              FaxEnt r;
              bool ok = black ? lookup(13, tab.black, r)
                              : lookup(12, tab.white, r);
              if (!ok) {
                end = kData;
                goto out;
              }
              if (r.state == (black ? S_TermB : S_TermW)) {
                if (!set(r.param)) return kOverflow;
                break;
              }
              if (r.state == (black ? S_MakeUpB : S_MakeUpW) ||
                  r.state == S_MakeUp) {
                a0 = wrap(int64_t(a0) + r.param);
                RunLength = wrap(int64_t(RunLength) + r.param);
              } else {
                goto out;  // unexpected
              }
            }
          }
          if (!check_b1()) return kOverflow;
          break;
        }
        case S_V0:
        case S_VR:
          if (!check_b1()) return kOverflow;
          if (!set(wrap(int64_t(b1) - a0 + (e.state == S_VR ? e.param : 0))))
            return kOverflow;
          if (pb >= ref + nruns) return kOverflow;
          b1 = wrap(int64_t(b1) + runs[pb++]);
          break;
        case S_VL:
          if (!check_b1()) return kOverflow;
          if (b1 < wrap(int64_t(a0) + e.param)) goto out;  // unexpected
          if (!set(wrap(int64_t(b1) - a0 - e.param))) return kOverflow;
          if (pb == 0) return kOverflow;
          b1 = wrap(int64_t(b1) - runs[--pb]);
          break;
        case S_Ext:  // uncompressed data, which libtiff does not read
          runs[pa++] = uint32_t(lastx - a0);
          goto out;
        case S_EOL:
          runs[pa++] = uint32_t(lastx - a0);
          if (!need(4)) {
            end = kData;
            goto out;
          }
          clr(4);
          EOLcnt = 1;
          goto out;
        default:
          goto out;  // unexpected
      }
    }
    if (RunLength) {
      if (wrap(int64_t(RunLength) + a0) < lastx) {
        if (!need(1)) {
          end = kData;
          goto out;
        }
        if (!get(1)) goto out;
        clr(1);
      }
      if (!set(0)) return kOverflow;
    }
  out:
    return cleanup() ? end : kOverflow;
  }
  // SYNC_EOL: 0 after an EOL, 1 at the end of the data before the EOL's
  // zeros end (libtiff's premature EOF), 2 where no EOL follows them
  int sync_eol() {
    if (EOLcnt == 0) {
      for (;;) {
        if (!need(11)) return 1;
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need(8)) return 2;
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    EOLcnt = 0;
    return 0;
  }

  // Fax3DecodeRLE: 1 or -1, as libtiff returns.  word < 0: rows start on
  // a byte (compression 2); else on a 16-bit word (32771,
  // FAXMODE_WORDALIGN), where libtiff also steps past a byte when no bit
  // is left and the next byte's address is odd: word is the parity of the
  // data's first byte in the file, which Pillow's libtiff maps
  int rle(uint8_t* dst, int rows, int word) {
    for (int y = 0; y < rows; ++y, dst += lastx) {
      start_row();
      End end = expand1d();
      if (end == kOverflow) return -1;
      fill(dst);
      if (end == kData) return -1;
      if (word < 0) {
        clr(BitsAvail & 7);
      } else {
        clr(BitsAvail & 15);
        if (BitsAvail == 0 && ((cp + size_t(word)) & 1)) ++cp;
      }
    }
    return 1;
  }
  // Fax3Decode1D / Fax3Decode2D.  Where no EOL follows a run of zeros,
  // libtiff warns, marks the codec as without EOLs (no_eol, which holds
  // for the image's later segments too) and decodes the segment again
  // from its first byte into the rows still to come.
  int t4(uint8_t* dst, int rows, bool two_d, bool& no_eol) {
    for (int y = 0; y < rows;) {
      start_row();
      if (!no_eol) {
        int r = sync_eol();
        if (r == 2) {
          no_eol = true;
          cp = 0;
          BitAcc = 0;
          BitsAvail = 0;
          EOLcnt = 0;
          continue;
        }
        if (r == 1) {
          if (!cleanup()) return -1;
          fill(dst);
          return -1;
        }
      }
      End end;
      if (two_d) {
        if (!need(1)) {
          if (!cleanup()) return -1;
          fill(dst);
          return -1;
        }
        bool one_d = get(1);
        clr(1);
        pb = ref;
        b1 = int32_t(runs[pb++]);
        end = one_d ? expand1d() : expand2d();
      } else {
        end = expand1d();
      }
      if (end == kOverflow) return -1;
      fill(dst);
      if (end == kData) return -1;
      if (two_d) {
        if (pa < thisrun + nruns) set(0);
        std::swap(cur, ref);
      }
      ++y;
      dst += lastx;
    }
    return 1;
  }
  // Fax4Decode: at an EOL or the end of the data the row is written and
  // decoding stops, an error only in the segment's first row
  int t6(uint8_t* dst, int rows) {
    for (int y = 0; y < rows; ++y, dst += lastx) {
      start_row();
      pb = ref;
      b1 = int32_t(runs[pb++]);
      End end = expand2d();
      if (end == kOverflow) return -1;
      fill(dst);
      if (end == kData || EOLcnt) return y ? 1 : -1;
      if (!set(0)) return -1;
      std::swap(cur, ref);
    }
    return 1;
  }
};

size_t fax_nruns(int width, bool two_d) {
  size_t n = (size_t(width) + 1 + 31) / 32 * 32;
  return two_d ? 2 * n : n;
}

// ------------------------------------------------------------- ThunderScan

// tif_thunder.c ThunderDecode: one row of `width` 4-bit pixels into op
// (two a byte, high nibble first); false where libtiff reports too few or
// too many pixels.  *bp / *cc: the data left, carried from row to row.
bool thunder_row(const uint8_t*& bp, size_t& cc, uint8_t* op, int64_t width) {
  static const int twobit[4] = {0, 1, 0, -1};
  static const int threebit[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  unsigned lastpixel = 0;
  int64_t npixels = 0;
  auto setpixel = [&](unsigned v) {
    lastpixel = v & 0xf;
    if (npixels < width) {
      if (npixels++ & 1) {
        *op++ |= uint8_t(lastpixel);
      } else {
        op[0] = uint8_t(lastpixel << 4);
      }
    }
  };
  while (cc > 0 && npixels < width) {
    int n = *bp++;
    --cc;
    switch (n & 0xc0) {
      case 0x00: {  // a run of the last pixel, n & 63 long
        n &= 0x3f;
        if (npixels & 1) {
          op[0] |= uint8_t(lastpixel);
          lastpixel = *op++;
          ++npixels;
          --n;
        } else {
          lastpixel |= lastpixel << 4;
        }
        npixels += n;
        if (npixels <= width) {
          for (; n > 0; n -= 2) *op++ = uint8_t(lastpixel);
        }
        if (n == -1) *--op &= 0xf0;
        lastpixel &= 0xf;
        break;
      }
      case 0x40:  // three 2-bit deltas (2: none)
        for (int sh = 4; sh >= 0; sh -= 2) {
          int d = (n >> sh) & 3;
          if (d != 2) setpixel(unsigned(int(lastpixel) + twobit[d]));
        }
        break;
      case 0x80:  // two 3-bit deltas (4: none)
        for (int sh = 3; sh >= 0; sh -= 3) {
          int d = (n >> sh) & 7;
          if (d != 4) setpixel(unsigned(int(lastpixel) + threebit[d]));
        }
        break;
      default:  // a raw pixel
        setpixel(unsigned(n));
        break;
    }
  }
  return npixels == width;
}

// ------------------------------------------------------------------ ZSTD
// RFC 8878 as libzstd 1.5.7 decodes it, driven as libtiff's tif_zstd.c
// ZSTDDecode drives ZSTD_decompressStream over one strip or tile: output
// goes to a buffer of the segment's size; decoding stops once it is full
// (the block that filled it, and one more block, or the checksum, where
// it filled exactly at a block's end, are still decoded and checked) or
// when the first frame ends.  The checks libzstd makes are made: frame
// header (reserved bit, a window above ZSTD_WINDOWLOG_LIMIT_DEFAULT, a
// dictionary ID, which no dictionary loaded matches), block sizes against
// min(window, 128 KiB), literals and sequence headers, FSE and Huffman
// table descriptions, bit streams consumed exactly (sequences may run
// past their start, reading zeros, as libzstd's do), offsets within the
// frame's output, the content size and the XXH64 checksum.

inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

inline uint64_t le_n(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = n - 1; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                 P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                 P5 = 2870177450012600261ULL;
  auto round = [&](uint64_t acc, uint64_t in) {
    return rotl64(acc + in * P2, 31) * P1;
  };
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
    for (; p + 32 <= end; p += 32) {
      for (int k = 0; k < 4; ++k) v[k] = round(v[k], le_n(p + 8 * k, 8));
    }
    h = rotl64(v[0], 1) + rotl64(v[1], 7) + rotl64(v[2], 12) +
        rotl64(v[3], 18);
    for (int k = 0; k < 4; ++k) h = (h ^ round(0, v[k])) * P1 + P4;
  } else {
    h = P5;
  }
  h += len;
  for (; p + 8 <= end; p += 8) {
    h = rotl64(h ^ round(0, le_n(p, 8)), 27) * P1 + P4;
  }
  if (p + 4 <= end) {
    h = rotl64(h ^ (le_n(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl64(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

[[noreturn]] void zfail(const std::string& msg) {
  fail(CORRUPT, "ZSTD: " + msg);
}

// a bit stream read backwards from its last byte, whose highest set bit
// marks its end; bits before its start read as the `before` bytes that
// precede it there (libzstd's fast Huffman decoder reads on into the
// stream before), then as zeros
struct BackBits {
  const uint8_t* d = nullptr;
  size_t n = 0, before = 0;
  int64_t pos = 0;  // bits left
  void init(const uint8_t* src, size_t len, size_t lead = 0) {
    if (len == 0) zfail("empty bit stream");
    if (src[len - 1] == 0) zfail("bit stream without its end marker");
    d = src;
    n = len;
    before = lead;
    pos = int64_t(len - 1) * 8 + highbit(src[len - 1]);
  }
  uint32_t peek(int nb) const {
    if (nb == 0) return 0;
    int64_t lo = pos - nb;
    uint64_t v = 0;
    if (lo >= 0) {
      size_t b = size_t(lo >> 3);
      int take = int(std::min<size_t>(8, n - b));
      v = le_n(d + b, take) >> (lo & 7);
    } else {
      if (pos <= 0 && int64_t(before) * 8 + pos <= 0) return 0;
      int64_t first = lo >> 3;  // floor
      for (int64_t i = first + 7; i >= first; --i) {
        bool in = i >= -int64_t(before) && i < int64_t(n);
        v = (v << 8) | (in ? d[i] : 0);
      }
      v >>= lo - first * 8;
    }
    return uint32_t(v & ((uint64_t(1) << nb) - 1));
  }
  uint32_t get(int nb) {
    uint32_t v = peek(nb);
    pos -= nb;
    return v;
  }
};

struct FseCell {
  uint16_t sym;
  uint8_t nb;
  uint16_t base;
};

struct FseTable {
  int al = 0;
  std::vector<FseCell> t;
};

// FSE_buildDTable
void fse_build(const int16_t* norm, int nsym, int al, FseTable& f) {
  const uint32_t size = 1u << al, mask = size - 1;
  f.al = al;
  f.t.assign(size, FseCell{0, 0, 0});
  uint32_t high = size - 1;
  uint32_t next[256];
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      f.t[high--].sym = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(std::max<int16_t>(norm[s], 0));
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3;
  uint32_t p = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      f.t[p].sym = uint16_t(s);
      do p = (p + step) & mask; while (p > high);
    }
  }
  if (p != 0) zfail("FSE table does not fill");
  for (uint32_t u = 0; u < size; ++u) {
    uint32_t ns = next[f.t[u].sym]++;
    int nb = al - highbit(ns);
    f.t[u].nb = uint8_t(nb);
    f.t[u].base = uint16_t((ns << nb) - size);
  }
}

// FSE_readNCount: a table description -> bytes it takes
size_t fse_read(const uint8_t* s, size_t n, int max_sym, int max_al,
                FseTable& f) {
  if (n == 0) zfail("FSE table description past the block");
  size_t bit = 0;
  auto peek = [&](int k) {
    size_t b = bit >> 3;
    uint64_t v = b < n ? le_n(s + b, int(std::min<size_t>(8, n - b))) : 0;
    return uint32_t((v >> (bit & 7)) & ((1u << k) - 1));
  };
  int al = int(peek(4)) + 5;
  bit += 4;
  if (al > max_al) zfail("FSE accuracy log too large");
  int remaining = (1 << al) + 1, threshold = 1 << al, nbits = al + 1;
  int sym = 0;
  bool prev0 = false;
  int16_t norm[256] = {0};
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      uint32_t rep;
      while ((rep = peek(2)) == 3) {
        sym += 3;
        bit += 2;
        if (sym > max_sym) zfail("FSE zeros past the last symbol");
      }
      sym += int(rep);
      bit += 2;
      if (sym > max_sym) break;
    }
    int max = (2 * threshold - 1) - remaining;
    uint32_t v = peek(nbits);
    int count;
    if (int(v & uint32_t(threshold - 1)) < max) {
      count = int(v & uint32_t(threshold - 1));
      bit += nbits - 1;
    } else {
      count = int(v & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= max;
      bit += nbits;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold && threshold > 1) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || sym > max_sym + 1) {
    zfail("FSE table description does not sum up");
  }
  size_t used = (bit + 7) / 8;
  if (used > n) zfail("FSE table description past the block");
  fse_build(norm, sym, al, f);
  return used;
}

struct Huffman {
  int bits = 0;
  std::vector<uint16_t> t;  // symbol << 8 | length, by the next `bits` bits
};

// HUF_readStats + HUF_readDTableX1: a tree description -> bytes it takes
size_t huf_read(const uint8_t* s, size_t n, Huffman& h) {
  if (n == 0) zfail("Huffman tree description past the block");
  uint8_t w[256];
  int nw = 0;
  size_t used;
  int hb = s[0];
  if (hb >= 128) {
    nw = hb - 127;
    used = 1 + size_t(nw + 1) / 2;
    if (used > n) zfail("Huffman weights past the block");
    for (int i = 0; i < nw; ++i) {
      w[i] = (i & 1) ? s[1 + i / 2] & 15 : s[1 + i / 2] >> 4;
    }
  } else {
    used = 1 + size_t(hb);
    if (used > n || hb == 0) zfail("Huffman weights past the block");
    FseTable f;
    size_t k = fse_read(s + 1, size_t(hb), 255, 6, f);
    if (k >= size_t(hb)) zfail("Huffman weights without a bit stream");
    BackBits br;
    br.init(s + 1 + k, size_t(hb) - k);
    uint32_t st[2] = {br.get(f.al), br.get(f.al)};
    for (int which = 0;; which ^= 1) {
      if (nw > 253) zfail("too many Huffman weights");
      const FseCell& c = f.t[st[which]];
      w[nw++] = uint8_t(c.sym);
      st[which] = c.base + br.get(c.nb);
      if (br.pos < 0) {
        w[nw++] = uint8_t(f.t[st[which ^ 1]].sym);
        break;
      }
    }
  }
  uint32_t total = 0, rank[16] = {0};
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 12) zfail("Huffman weight above 12");
    ++rank[w[i]];
    total += (1u << w[i]) >> 1;
  }
  if (total == 0) zfail("Huffman weights all zero");
  int bits = highbit(total) + 1;
  if (bits > 12) zfail("Huffman codes longer than 12 bits");
  uint32_t rest = (1u << bits) - total;
  if (rest != (1u << highbit(rest))) zfail("Huffman weights do not sum up");
  w[nw] = uint8_t(highbit(rest) + 1);
  ++rank[w[nw]];
  const int nsym = nw + 1;
  if (rank[1] < 2 || (rank[1] & 1)) zfail("Huffman weights do not sum up");
  h.bits = bits;
  h.t.assign(size_t(1) << bits, 0);
  size_t p = 0;
  for (int wt = 1; wt <= bits; ++wt) {
    for (int sym = 0; sym < nsym; ++sym) {
      if (w[sym] != wt) continue;
      size_t len = size_t(1) << (wt - 1);
      uint16_t e = uint16_t(sym << 8 | (bits + 1 - wt));
      for (size_t i = 0; i < len; ++i) h.t[p + i] = e;
      p += len;
    }
  }
  return used;
}

// one Huffman stream of `count` literals; exact: its bits must all be read
// (libzstd's fast 4-stream decoder, which takes streams of 8 bytes or
// more, only checks that none is read past its start)
void huf_stream(const Huffman& h, const uint8_t* s, size_t n, uint8_t* out,
                size_t count, bool exact, size_t lead = 0) {
  BackBits br;
  br.init(s, n, exact ? 0 : lead);
  for (size_t i = 0; i < count; ++i) {
    uint16_t e = h.t[br.peek(h.bits)];
    out[i] = uint8_t(e >> 8);
    br.pos -= e & 0xff;
  }
  if ((exact && br.pos != 0) || br.pos < -64) {
    zfail("Huffman stream not consumed exactly");
  }
}

// the predefined distributions and the codes' baselines and extra bits
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

const FseTable& predefined(int kind) {
  static const FseTable* t = [] {
    static FseTable tabs[3];
    fse_build(kLLNorm, 36, 6, tabs[0]);
    fse_build(kOFNorm, 29, 5, tabs[1]);
    fse_build(kMLNorm, 53, 6, tabs[2]);
    return tabs;
  }();
  return t[kind];
}

class ZstdSegment {
 public:
  ZstdSegment(const uint8_t* src, size_t n, uint8_t* dst, size_t occ)
      : s_(src), n_(n), dst_(dst), occ_(occ) {}

  // bytes written into dst: occ, or fewer where the data end first
  size_t run() {
    if (n_ < 4) return 0;
    uint32_t magic = uint32_t(le_n(s_, 4));
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) return 0;  // skippable
    if (magic != 0xFD2FB528u) zfail("unknown frame magic");
    if (n_ < 5) return 0;
    const int fhd = s_[4];
    const int fcs_flag = fhd >> 6, did_flag = fhd & 3;
    const bool single = fhd & 0x20, checksum = fhd & 4;
    static const int kDid[4] = {0, 1, 2, 4}, kFcs[4] = {0, 2, 4, 8};
    size_t hsize = 5 + (single ? 0 : 1) + kDid[did_flag] +
                   (fcs_flag == 0 && single ? 1 : kFcs[fcs_flag]);
    if (n_ < hsize) return 0;
    if (fhd & 8) zfail("reserved frame header bit set");
    size_t p = 5;
    uint64_t window = 0;
    if (!single) {
      int wd = s_[p++];
      int wlog = 10 + (wd >> 3);
      if (wlog > 31) zfail("window too large");
      uint64_t base = uint64_t(1) << wlog;
      window = base + (base >> 3) * uint64_t(wd & 7);
    }
    uint64_t did = le_n(s_ + p, kDid[did_flag]);
    p += kDid[did_flag];
    bool has_fcs = single || fcs_flag != 0;
    int fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : kFcs[fcs_flag];
    uint64_t fcs = le_n(s_ + p, fcs_bytes) + (fcs_flag == 1 ? 256 : 0);
    p += fcs_bytes;
    if (single) window = fcs;
    if (std::max<uint64_t>(window, 1024) > (uint64_t(1) << 27) + 1) {
      zfail("frame window of " + std::to_string(window) +
            " bytes, above libzstd's default limit (2^27 + 1)");
    }
    if (did) zfail("frame needs dictionary " + std::to_string(did));
    const size_t block_max = size_t(std::min<uint64_t>(window, 128 << 10));
    size_t written = 0;
    for (;;) {
      if (p + 3 > n_) return written;
      uint32_t bh = uint32_t(le_n(s_ + p, 3));
      p += 3;
      const bool last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t bsize = bh >> 3;
      if (type == 3) zfail("reserved block type");
      if (type != 1 && bsize > block_max) {
        zfail("block larger than its maximum");
      }
      const size_t start = out_.size();
      if (type == 0) {  // raw: libzstd streams what there is of it
        size_t have = std::min(bsize, n_ - p);
        if (has_fcs && start + bsize > fcs) {
          zfail("frame larger than its content size");
        }
        out_.insert(out_.end(), s_ + p, s_ + p + have);
        p += have;
        if (have < bsize) return deliver(written, start);
      } else if (type == 1) {
        // libzstd holds an RLE block to its buffer, not to block_max
        if (p + 1 > n_) return written;
        if (has_fcs && start + bsize > fcs) {
          zfail("frame larger than its content size");
        }
        out_.resize(start + bsize, s_[p]);
        p += 1;
      } else {
        if (p + bsize > n_) return written;
        block(s_ + p, bsize, block_max);
        p += bsize;
        if (has_fcs && out_.size() > fcs) {
          zfail("frame larger than its content size");
        }
      }
      size_t before = written;
      written = deliver(written, start);
      if (written - before < out_.size() - start) return written;  // full
      if (last) break;
    }
    if (has_fcs && out_.size() != fcs) {
      zfail("frame of another size than its content size");
    }
    if (checksum) {
      if (p + 4 > n_) return written;
      if (uint32_t(le_n(s_ + p, 4)) !=
          uint32_t(xxh64(out_.data(), out_.size()))) {
        zfail("checksum wrong");
      }
    }
    return written;
  }

 private:
  const uint8_t* s_;
  size_t n_;
  uint8_t* dst_;
  size_t occ_;
  std::vector<uint8_t> out_;  // the frame's output
  Huffman huf_;
  bool huf_set_ = false;
  FseTable seq_[3];  // literal lengths, offsets, match lengths
  bool seq_set_[3] = {false, false, false};
  uint64_t rep_[3] = {1, 4, 8};
  std::vector<uint8_t> lit_;

  // out_ from `from` into dst, as far as it has room
  size_t deliver(size_t written, size_t from) {
    size_t take = std::min(occ_ - written, out_.size() - from);
    if (take) std::memcpy(dst_ + written, out_.data() + from, take);
    return written + take;
  }

  void block(const uint8_t* b, size_t n, size_t block_max) {
    if (n < 2) zfail("compressed block under 2 bytes");
    size_t p = literals(b, n, block_max);
    sequences(b + p, n - p, block_max);
  }

  size_t literals(const uint8_t* b, size_t n, size_t block_max) {
    const int type = b[0] & 3, sf = (b[0] >> 2) & 3;
    size_t regen, csize = 0, hsize;
    bool four = false;
    if (type < 2) {
      if (sf == 1) {
        hsize = 2;
      } else if (sf == 3) {
        hsize = 3;
      } else {
        hsize = 1;
      }
      if (hsize + (type == 1 ? 1 : 0) > n) zfail("literals header cut");
      regen = hsize == 1 ? b[0] >> 3 : size_t(le_n(b, int(hsize))) >> 4;
    } else {
      if (n < 5) zfail("compressed literals in a block under 5 bytes");
      hsize = sf < 2 ? 3 : sf == 2 ? 4 : 5;
      four = sf != 0;
      uint64_t v = le_n(b, int(hsize));
      int wid = hsize == 3 ? 10 : hsize == 4 ? 14 : 18;
      regen = size_t((v >> 4) & ((1u << wid) - 1));
      csize = size_t((v >> (4 + wid)) & ((1u << wid) - 1));
    }
    if (regen > block_max) zfail("more literals than a block holds");
    lit_.resize(regen);
    if (type == 0) {
      if (hsize + regen > n) zfail("raw literals past the block");
      std::memcpy(lit_.data(), b + hsize, regen);
      return hsize + regen;
    }
    if (type == 1) {
      std::memset(lit_.data(), b[hsize], regen);
      return hsize + 1;
    }
    if (four && regen < 6) zfail("under 6 literals in 4 streams");
    if (hsize + csize > n) zfail("compressed literals past the block");
    const uint8_t* c = b + hsize;
    size_t cn = csize;
    if (type == 2) {
      size_t k = huf_read(c, cn, huf_);
      huf_set_ = true;
      c += k;
      cn -= k;
    } else if (!huf_set_) {
      zfail("treeless literals without an earlier Huffman table");
    }
    if (!four) {
      huf_stream(huf_, c, cn, lit_.data(), regen, true);
    } else {
      if (cn < 10) zfail("4-stream literals under 10 bytes");
      size_t l[4] = {size_t(le_n(c, 2)), size_t(le_n(c + 2, 2)),
                     size_t(le_n(c + 4, 2)), 0};
      if (6 + l[0] + l[1] + l[2] > cn) zfail("literal streams past the block");
      l[3] = cn - 6 - l[0] - l[1] - l[2];
      size_t seg = (regen + 3) / 4;
      const uint8_t* q = c + 6;
      const bool fast = l[0] >= 8 && l[1] >= 8 && l[2] >= 8 && l[3] >= 8 &&
                        huf_.bits <= 11;
      for (int k = 0; k < 4; ++k) {
        huf_stream(huf_, q, l[k], lit_.data() + seg * k,
                   k < 3 ? seg : regen - 3 * seg, !fast, size_t(q - c - 6));
        q += l[k];
      }
    }
    return hsize + csize;
  }

  void sequences(const uint8_t* b, size_t n, size_t block_max) {
    const size_t start = out_.size();
    if (n < 1) zfail("sequences section missing");
    size_t nseq, p;
    if (b[0] < 128) {
      nseq = b[0];
      p = 1;
    } else if (b[0] < 255) {
      if (n < 2) zfail("sequences header cut");
      nseq = ((b[0] - 128) << 8) + b[1];
      p = 2;
    } else {
      if (n < 3) zfail("sequences header cut");
      nseq = b[1] + (b[2] << 8) + 0x7F00;
      p = 3;
    }
    if (nseq == 0) {
      if (p != n) zfail("data after an empty sequences section");
      append_literals(0, lit_.size(), start, block_max);
      return;
    }
    if (p + 1 > n) zfail("sequences header cut");
    const int modes = b[p++];
    if (modes & 3) zfail("reserved sequences bits set");
    static const int kMax[3] = {35, 31, 52}, kAl[3] = {9, 8, 9};
    const int shift[3] = {6, 4, 2};
    for (int k = 0; k < 3; ++k) {
      int m = (modes >> shift[k]) & 3;
      if (m == 0) {
        seq_[k] = predefined(k);
      } else if (m == 1) {
        if (p + 1 > n) zfail("sequences header cut");
        if (b[p] > kMax[k]) zfail("RLE sequence code out of range");
        seq_[k].al = 0;
        seq_[k].t.assign(1, FseCell{b[p], 0, 0});
        ++p;
      } else if (m == 2) {
        p += fse_read(b + p, n - p, kMax[k], kAl[k], seq_[k]);
      } else if (!seq_set_[k]) {
        zfail("repeated sequence table without an earlier one");
      }
      seq_set_[k] = true;
    }
    if (p >= n) zfail("sequences bit stream missing");
    BackBits br;
    br.init(b + p, n - p);
    FseTable &ll = seq_[0], &of = seq_[1], &ml = seq_[2];
    uint32_t sll = br.get(ll.al), sof = br.get(of.al), sml = br.get(ml.al);
    size_t lit = 0;
    for (size_t i = 0; i < nseq; ++i) {
      const FseCell &cl = ll.t[sll], &co = of.t[sof], &cm = ml.t[sml];
      const int ofcode = co.sym;
      uint64_t ofv = (uint64_t(1) << ofcode) + br.get(ofcode);
      uint64_t mlen = kMLBase[cm.sym] + br.get(kMLBits[cm.sym]);
      uint64_t llen = kLLBase[cl.sym] + br.get(kLLBits[cl.sym]);
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        rep_[2] = rep_[1];
        rep_[1] = rep_[0];
        rep_[0] = off;
      } else {
        uint64_t idx = ofv - 1 + (llen == 0 ? 1 : 0);
        if (idx == 0) {
          off = rep_[0];
        } else {
          off = idx == 3 ? rep_[0] - 1 : rep_[idx];
          if (off == 0) zfail("offset 0");
          if (idx != 1) rep_[2] = rep_[1];
          rep_[1] = rep_[0];
          rep_[0] = off;
        }
      }
      if (i + 1 < nseq) {
        sll = cl.base + br.get(cl.nb);
        sml = cm.base + br.get(cm.nb);
        sof = co.base + br.get(co.nb);
      }
      if (llen > lit_.size() - lit) zfail("literal length past the literals");
      append_literals(lit, size_t(llen), start, block_max);
      lit += size_t(llen);
      const size_t have = out_.size();
      if (off > have) zfail("offset before the frame's start");
      if (have - start + mlen > block_max) {
        zfail("block larger than its maximum");
      }
      out_.resize(have + size_t(mlen));
      uint8_t* o = out_.data() + have;
      const uint8_t* from = o - off;
      if (off >= mlen) {
        std::memcpy(o, from, size_t(mlen));
      } else {
        for (size_t k = 0; k < mlen; ++k) o[k] = from[k];
      }
    }
    if (br.pos > 0) zfail("sequences bit stream not consumed");
    append_literals(lit, lit_.size() - lit, start, block_max);
  }

  void append_literals(size_t from, size_t count, size_t start,
                       size_t block_max) {
    if (out_.size() - start + count > block_max) {
      zfail("block larger than its maximum");
    }
    out_.insert(out_.end(), lit_.begin() + from, lit_.begin() + from + count);
  }
};


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

// CCITT rows into dst (rows x width bytes, one byte a pixel, 1 in a
// black run) as libtiff 4.7.1 decodes one strip or tile of them: mode 2
// modified Huffman (rows byte-aligned), 3 T.4 (t4_options bit 0: 2-D),
// 4 T.6, 32771 modified Huffman word-aligned (t4_options: the offset of
// the data in the file).  Pixels the decoder does not reach keep what dst
// held.  state
// (state_words long, zeroed for each image): word 0 the codec's flags,
// then its run arrays, carried from one segment to the next as libtiff
// carries them.  T.4's uncompressed-mode option changes nothing: libtiff
// ends a row at an uncompressed-mode code.  Returns 1, or 0 where
// libtiff's decoder returns -1 (data that end before the rows do, runs
// past its arrays), or -status.
long ccitt_decode(const uint8_t* src, size_t n, int mode, int t4_options,
                  int fill_order, int width, int rows, uint8_t* dst,
                  uint32_t* state, size_t state_words, char* err,
                  int errlen) {
  bool two_d = mode == 4 || (mode == 3 && (t4_options & 1));
  size_t nruns = fax_nruns(width, two_d);
  if (width <= 0 || rows < 0 || state_words < 2 * nruns + 2) {
    set_err(err, errlen, "TIFF: CCITT segment of a bad size");
    return -CORRUPT;
  }
  Fax f{};
  f.d = src;
  f.ep = n;
  f.reverse = fill_order != 2;
  f.lastx = width;
  f.runs = state + 1;
  f.nruns = nruns;
  f.ref = nruns;
  if (two_d) {  // Fax3PreDecode: the reference row is white
    f.runs[f.ref] = uint32_t(width);
    f.runs[f.ref + 1] = 0;
  }
  int got;
  if (mode == 2 || mode == 32771) {
    got = f.rle(dst, rows, mode == 2 ? -1 : t4_options & 1);
  } else if (mode == 3) {
    bool no_eol = state[0] & 1;
    got = f.t4(dst, rows, two_d, no_eol);
    state[0] = (state[0] & ~1u) | (no_eol ? 1u : 0u);
  } else {
    got = f.t6(dst, rows);
  }
  return got > 0 ? 1 : 0;
}

// ThunderScan (tif_thunder.c ThunderDecodeRow): rows of `width` 4-bit
// pixels, row_bytes apart, into dst.  Returns 1, or 0 where libtiff's
// decoder fails the segment.
long thunder_decode(const uint8_t* src, size_t n, uint8_t* dst, int rows,
                    int width, size_t row_bytes) {
  if (width <= 0 || rows < 0 || row_bytes < size_t(width + 1) / 2) return 0;
  const uint8_t* bp = src;
  size_t cc = n;
  for (int r = 0; r < rows; ++r) {
    if (!thunder_row(bp, cc, dst + size_t(r) * row_bytes, width)) return 0;
  }
  return 1;
}

// ZSTD, one strip or tile as tif_zstd.c decodes it into occ bytes: the
// bytes written into dst (occ, or fewer where the data end first), or
// -status with the message in err where libzstd fails
long zstd_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t occ,
                 char* err, int errlen) {
  try {
    ZstdSegment z(src, n, dst, occ);
    return long(z.run());
  } catch (const DecodeError& e) {
    set_err(err, errlen, e.msg);
    return -e.status;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "ZSTD: out of memory");
    return -CORRUPT;
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
