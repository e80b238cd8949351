// Glyph outlines and bitmaps of TrueType and CFF fonts, as FreeType 2.14
// gives them to Pillow (FT_LOAD_DEFAULT, FT_RENDER_MODE_NORMAL):
//
//   - scaling to 26.6 with FreeType's FT_MulFix / FT_MulDiv / FT_DivFix
//     rounding;
//   - the TrueType bytecode interpreter in FreeType's default "v40" mode
//     (subpixel hinting, minimal): `fpgm' once per size, `prep' per size
//     (run twice, as FreeType re-runs it when the first glyph load turns
//     on subpixel hinting), glyph programs with phantom points, composite
//     glyphs with their own instructions, and the backward-compatibility
//     rules (no x movement, no y movement after IUP on both axes) unless
//     `prep' turns them off with INSTCTRL;
//   - CFF charstrings through FreeType's CFF module and its default Adobe engine
//     (namespace cf2): the Type 2 interpreter, the hint map built from
//     the stems and the blue zones, hint replacement mid-contour, and
//     psaux's outline assembly, whose outlines carry cubic tags;
//   - FreeType's gray rasterizer (ftgrays.c): cell cover and area,
//     quadratic arcs flattened by its DDA, cubic arcs by bisection,
//     non-zero winding, 256 levels;
//   - Pillow's extended box blur (libImaging/BoxBlur.c), whose float
//     arithmetic must be C's.
//
// The sfnt and CFF tables are parsed in Python (effocr_torch/fonts/sfnt.py,
// cff.py) and handed over as arrays.  Built with g++ at first use (glyph.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

typedef int64_t Long;
typedef uint64_t ULong;

// ----------------------------------------------------------- fixed point
static inline Long add_long(Long a, Long b) { return (Long)((ULong)a + (ULong)b); }
static inline Long sub_long(Long a, Long b) { return (Long)((ULong)a - (ULong)b); }
static inline Long neg_long(Long a) { return (Long)(0 - (ULong)a); }
static inline Long pix_round(Long x) { return add_long(x, 32) & -64; }
static inline Long pix_floor(Long x) { return x & -64; }
static inline Long pix_ceil(Long x) { return add_long(x, 63) & -64; }

static Long mul_fix(Long a, Long b) {
  // FT_MulFix_x86_64: 32-bit operands, rounding half away from zero
  int64_t ab = (int64_t)(int32_t)a * (int64_t)(int32_t)b;
  ab += 0x8000 + (ab >> 63);
  return (Long)(int32_t)(ab >> 16);
}

static Long mul_div(Long a_, Long b_, Long c_) {
  int s = 1;
  ULong a, b, c, d;
  if (a_ < 0) { a = (ULong)(-a_); s = -s; } else a = (ULong)a_;
  if (b_ < 0) { b = (ULong)(-b_); s = -s; } else b = (ULong)b_;
  if (c_ < 0) { c = (ULong)(-c_); s = -s; } else c = (ULong)c_;
  d = c > 0 ? (a * b + (c >> 1)) / c : 0x7FFFFFFFUL;
  Long d_ = (Long)d;
  return s < 0 ? neg_long(d_) : d_;
}

static Long mul_div_no_round(Long a_, Long b_, Long c_) {
  int s = 1;
  ULong a, b, c, d;
  if (a_ < 0) { a = (ULong)(-a_); s = -s; } else a = (ULong)a_;
  if (b_ < 0) { b = (ULong)(-b_); s = -s; } else b = (ULong)b_;
  if (c_ < 0) { c = (ULong)(-c_); s = -s; } else c = (ULong)c_;
  d = c > 0 ? a * b / c : 0x7FFFFFFFUL;
  Long d_ = (Long)d;
  return s < 0 ? neg_long(d_) : d_;
}

static Long div_fix(Long a_, Long b_) {
  int s = 1;
  ULong a, b, q;
  if (a_ < 0) { a = (ULong)(-a_); s = -s; } else a = (ULong)a_;
  if (b_ < 0) { b = (ULong)(-b_); s = -s; } else b = (ULong)b_;
  q = b > 0 ? ((a << 16) + (b >> 1)) / b : 0x7FFFFFFFUL;
  Long q_ = (Long)q;
  return s < 0 ? neg_long(q_) : q_;
}

static Long mul_fix14(Long a, Long b) {
  int64_t ret = (int64_t)(int32_t)a * (int64_t)(int32_t)b;
  ret += 0x2000 + (ret >> 63);
  return (Long)(int32_t)(ret >> 14);
}

static Long dot_fix14(Long ax, Long ay, Long bx, Long by) {
  int64_t t1 = (int64_t)(int32_t)ax * (int64_t)(int32_t)bx;
  int64_t t2 = (int64_t)(int32_t)ay * (int64_t)(int32_t)by;
  t1 += t2;
  t2 = t1 >> 63;
  t1 += 0x2000 + t2;
  return (Long)(int32_t)(t1 >> 14);
}

static int msb32(uint32_t z) {
  int shift = 0;
  if (z & 0xFFFF0000UL) { z >>= 16; shift += 16; }
  if (z & 0x0000FF00UL) { z >>= 8; shift += 8; }
  if (z & 0x000000F0UL) { z >>= 4; shift += 4; }
  if (z & 0x0000000CUL) { z >>= 2; shift += 2; }
  if (z & 0x00000002UL) { shift += 1; }
  return shift;
}

// FT_Vector_Length (fttrigon.c): the CORDIC length of a vector, FT_Hypot
static Long vector_length(Long vx, Long vy) {
  if (vx == 0) return vy < 0 ? -vy : vy;
  if (vy == 0) return vx < 0 ? -vx : vx;
  // ft_trig_prenorm
  Long ax = vx < 0 ? -vx : vx, ay = vy < 0 ? -vy : vy;
  int shift = msb32((uint32_t)(ax | ay));
  Long x, y;
  if (shift <= 29) {
    shift = 29 - shift;
    x = (Long)((ULong)vx << shift);
    y = (Long)((ULong)vy << shift);
  } else {
    shift -= 29;
    x = vx >> shift;
    y = vy >> shift;
    shift = -shift;
  }
  // ft_trig_pseudo_polarize (the angle is not needed)
  Long xtemp, b;
  if (y > x) {
    if (y > -x) {
      xtemp = y;
      y = -x;
      x = xtemp;
    } else {
      x = -x;
      y = -y;
    }
  } else if (y < -x) {
    xtemp = -y;
    y = x;
    x = xtemp;
  }
  int i;
  for (i = 1, b = 1; i < 23; b <<= 1, i++) {
    if (y > 0) {
      xtemp = x + ((y + b) >> i);
      y = y - ((x + b) >> i);
      x = xtemp;
    } else {
      xtemp = x - ((y + b) >> i);
      y = y + ((x + b) >> i);
      x = xtemp;
    }
  }
  // ft_trig_downscale
  int s = 1;
  if (x < 0) {
    x = -x;
    s = -1;
  }
  uint64_t v = ((uint64_t)x * 0xDBD95B16UL + 0x40000000UL) >> 32;
  x = s < 0 ? -(Long)v : (Long)v;
  if (shift > 0) return (x + (1L << (shift - 1))) >> shift;
  return (Long)((uint32_t)x << -shift);
}

// FT_Vector_NormLen: the vector scaled to unit length in 16.16
static void vector_normlen(Long* vx, Long* vy) {
  int32_t x_ = (int32_t)*vx, y_ = (int32_t)*vy;
  int32_t b, z;
  uint32_t x, y, u, v, l;
  int sx = 1, sy = 1, shift;
  if (x_ < 0) { x = (uint32_t)(-x_); sx = -1; } else x = (uint32_t)x_;
  if (y_ < 0) { y = (uint32_t)(-y_); sy = -1; } else y = (uint32_t)y_;
  if (x == 0) {
    if (y > 0) *vy = sy * 0x10000;
    return;
  } else if (y == 0) {
    if (x > 0) *vx = sx * 0x10000;
    return;
  }
  l = x > y ? x + (y >> 1) : y + (x >> 1);
  shift = 31 - msb32(l);
  shift -= 15 + (l >= (0xAAAAAAAAUL >> shift));
  if (shift > 0) {
    x <<= shift;
    y <<= shift;
    l = x > y ? x + (y >> 1) : y + (x >> 1);
  } else {
    x >>= -shift;
    y >>= -shift;
    l >>= -shift;
  }
  b = 0x10000 - (int32_t)l;
  x_ = (int32_t)x;
  y_ = (int32_t)y;
  do {
    u = (uint32_t)(x_ + (x_ * b >> 16));
    v = (uint32_t)(y_ + (y_ * b >> 16));
    z = -(int32_t)(u * u + v * v) / 0x200;
    z = z * ((0x10000 + b) >> 8) / 0x10000;
    b += z;
  } while (z > 0);
  *vx = sx < 0 ? -(Long)u : (Long)u;
  *vy = sy < 0 ? -(Long)v : (Long)v;
}

// ------------------------------------------------------------------ font
struct Face {
  std::vector<uint8_t> glyf;
  std::vector<uint32_t> loca;  // n_glyphs + 1 offsets into glyf
  std::vector<uint16_t> adv;
  std::vector<int16_t> lsb;
  int n_glyphs = 0, upem = 0;
  int v_asc = 0, v_desc = 0;  // pp3 / pp4 without vmtx
  std::vector<int16_t> cvt;
  std::vector<uint8_t> fpgm, prep;
  int max_stack = 0, max_storage = 0, max_fdefs = 0, max_idefs = 0;
  int max_twilight = 0, max_ins = 0;
};

struct Vec { Long x, y; };

struct Zone {
  int n_points = 0, n_contours = 0;
  Vec* org = nullptr;
  Vec* cur = nullptr;
  Vec* orus = nullptr;
  uint8_t* tags = nullptr;
  int16_t* contours = nullptr;
  int first_point = 0;
};

struct ZoneStore {
  std::vector<Vec> org, cur, orus;
  std::vector<uint8_t> tags;
  std::vector<int16_t> contours;
  Zone zone() {
    Zone z;
    z.n_points = (int)cur.size();
    z.n_contours = (int)contours.size();
    z.org = org.data();
    z.cur = cur.data();
    z.orus = orus.data();
    z.tags = tags.data();
    z.contours = contours.data();
    return z;
  }
};

enum { RANGE_NONE = 0, RANGE_FONT = 1, RANGE_CVT = 2, RANGE_GLYPH = 3 };
enum { TAG_ON = 1, TOUCH_X = 8, TOUCH_Y = 16 };

struct GraphicsState {
  int rp0, rp1, rp2;
  Vec dualVector, projVector, freeVector;
  Long loop, minimum_distance;
  int round_state;
  bool auto_flip;
  Long control_value_cutin, single_width_cutin, single_width_value;
  int delta_base, delta_shift;
  uint8_t instruct_control;
  bool scan_control;
  int scan_type;
  int gep0, gep1, gep2;
};

static const GraphicsState default_gs = {
    0, 0, 0, {0x4000, 0}, {0x4000, 0}, {0x4000, 0}, 1, 64, 1, true, 68, 0, 0,
    9, 3, 0, false, 0, 1, 1, 1};

struct DefRec {
  int range;
  Long start, end;
  unsigned opc;
  bool active;
};

struct CallRec {
  int caller_range;
  Long caller_ip;
  Long cur_count;
  DefRec* def;
};

struct Size;

struct Exec {
  Face* face = nullptr;
  Size* size = nullptr;
  GraphicsState GS;
  Zone zp0, zp1, zp2, pts, twilight;
  // code ranges
  const uint8_t* range_code[4] = {nullptr, nullptr, nullptr, nullptr};
  Long range_size[4] = {0, 0, 0, 0};
  int curRange = 0, iniRange = 0;
  const uint8_t* code = nullptr;
  Long codeSize = 0, IP = 0;
  // stack
  std::vector<Long> stack;
  Long top = 0, args = 0, new_top = 0, stackSize = 0;
  uint8_t opcode = 0;
  Long length = 0;
  bool step_ins = false;
  int error = 0;
  std::vector<CallRec> callStack;
  int callTop = 0;
  // cvt / storage (copy-on-write inside glyph programs)
  Long* cvt = nullptr;
  Long cvtSize = 0;
  std::vector<Long> glyfCvt;
  Long* storage = nullptr;
  Long storeSize = 0;
  std::vector<Long> glyfStorage;
  // metrics
  Long x_scale = 0, y_scale = 0;  // exec->metrics (1.0 in composites)
  Long ppem = 0, tt_scale = 0;
  Long F_dot_P = 0x4000;
  int proj_kind = 0, dual_kind = 0, move_kind = 0;  // 0 general, 1 x, 2 y
  Long period = 64, phase = 0, threshold = 0;
  bool is_composite = false;
  bool backward_compatibility = false;
  bool iupx_called = false, iupy_called = false;
  bool subpixel_hinting_lean = false, grayscale_cleartype = false;
  bool grayscale = false;
  Long loopcall_counter = 0, loopcall_counter_max = 0;
  Long neg_jump_counter = 0, neg_jump_counter_max = 0;
};

struct Size {
  Face* face;
  int ppem;
  Long x_scale, y_scale;
  std::vector<Long> cvt;
  std::vector<Long> storage;
  ZoneStore twilight;
  GraphicsState GS;
  std::vector<DefRec> fdefs, idefs;
  int numFDefs = 0, numIDefs = 0;
  unsigned maxFunc = 0, maxIns = 0;
  int error = 0;
  Exec exec;
  std::vector<uint8_t> glyph_ins;
};

// --------------------------------------------------------- interpreter
static const int8_t opcode_length[256] = {
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    -1, -2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 3, 4, 5, 6, 7, 8, 9, 3, 5, 7, 9, 11, 13, 15, 17,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

#define PACK(x, y) ((x << 4) | y)
static const uint8_t pop_push[256] = {
    // 0x00
    PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0),
    PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0),
    PACK(0, 2), PACK(0, 2), PACK(0, 0), PACK(5, 0),
    // 0x10
    PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0),
    PACK(1, 0), PACK(1, 0), PACK(0, 0), PACK(0, 0), PACK(1, 0), PACK(0, 0),
    PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0),
    // 0x20
    PACK(1, 2), PACK(1, 0), PACK(0, 0), PACK(2, 2), PACK(0, 1), PACK(1, 1),
    PACK(1, 0), PACK(2, 0), PACK(0, 0), PACK(1, 0), PACK(2, 0), PACK(1, 0),
    PACK(1, 0), PACK(0, 0), PACK(1, 0), PACK(1, 0),
    // 0x30
    PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(1, 0), PACK(1, 0),
    PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(0, 0), PACK(2, 0), PACK(2, 0),
    PACK(0, 0), PACK(0, 0), PACK(2, 0), PACK(2, 0),
    // 0x40
    PACK(0, 0), PACK(0, 0), PACK(2, 0), PACK(1, 1), PACK(2, 0), PACK(1, 1),
    PACK(1, 1), PACK(1, 1), PACK(2, 0), PACK(2, 1), PACK(2, 1), PACK(0, 1),
    PACK(0, 1), PACK(0, 0), PACK(0, 0), PACK(1, 0),
    // 0x50
    PACK(2, 1), PACK(2, 1), PACK(2, 1), PACK(2, 1), PACK(2, 1), PACK(2, 1),
    PACK(1, 1), PACK(1, 1), PACK(1, 0), PACK(0, 0), PACK(2, 1), PACK(2, 1),
    PACK(1, 1), PACK(1, 0), PACK(1, 0), PACK(1, 0),
    // 0x60
    PACK(2, 1), PACK(2, 1), PACK(2, 1), PACK(2, 1), PACK(1, 1), PACK(1, 1),
    PACK(1, 1), PACK(1, 1), PACK(1, 1), PACK(1, 1), PACK(1, 1), PACK(1, 1),
    PACK(1, 1), PACK(1, 1), PACK(1, 1), PACK(1, 1),
    // 0x70
    PACK(2, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0),
    PACK(1, 0), PACK(1, 0), PACK(2, 0), PACK(2, 0), PACK(0, 0), PACK(0, 0),
    PACK(0, 0), PACK(0, 0), PACK(1, 0), PACK(1, 0),
    // 0x80
    PACK(0, 0), PACK(2, 0), PACK(2, 0), PACK(0, 0), PACK(0, 0), PACK(1, 0),
    PACK(2, 0), PACK(2, 0), PACK(1, 1), PACK(1, 0), PACK(3, 3), PACK(2, 1),
    PACK(2, 1), PACK(1, 0), PACK(2, 0), PACK(0, 0),
    // 0x90
    PACK(0, 0), PACK(0, 0), PACK(0, 1), PACK(0, 0), PACK(0, 0), PACK(0, 0),
    PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0),
    PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0),
    // 0xA0
    PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0),
    PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0),
    PACK(0, 0), PACK(0, 0), PACK(0, 0), PACK(0, 0),
    // 0xB0
    PACK(0, 1), PACK(0, 2), PACK(0, 3), PACK(0, 4), PACK(0, 5), PACK(0, 6),
    PACK(0, 7), PACK(0, 8), PACK(0, 1), PACK(0, 2), PACK(0, 3), PACK(0, 4),
    PACK(0, 5), PACK(0, 6), PACK(0, 7), PACK(0, 8),
    // 0xC0
    PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0),
    PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0),
    PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0),
    // 0xD0
    PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0),
    PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0),
    PACK(1, 0), PACK(1, 0), PACK(1, 0), PACK(1, 0),
    // 0xE0
    PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0),
    PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0),
    PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0),
    // 0xF0
    PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0),
    PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0),
    PACK(2, 0), PACK(2, 0), PACK(2, 0), PACK(2, 0)};
#undef PACK

enum {
  ERR_OK = 0,
  ERR_INVALID_OPCODE = 1,
  ERR_TOO_FEW = 2,
  ERR_STACK_OVERFLOW = 3,
  ERR_CODE_OVERFLOW = 4,
  ERR_BAD_ARG = 5,
  ERR_DIV0 = 6,
  ERR_INVALID_REF = 7,
  ERR_DEBUG = 8,
  ERR_ENDF = 9,
  ERR_NESTED_DEFS = 10,
  ERR_DEF_IN_GLYF = 11,
  ERR_TOO_MANY_DEFS = 12,
  ERR_TOO_LONG = 13,
  ERR_INVALID_GLYPH = 20,
};

static inline bool bounds(Long x, Long n) { return (ULong)x >= (ULong)n; }

static void compute_funcs(Exec* exc) {
  GraphicsState& gs = exc->GS;
  if (gs.freeVector.x == 0x4000)
    exc->F_dot_P = gs.projVector.x;
  else if (gs.freeVector.y == 0x4000)
    exc->F_dot_P = gs.projVector.y;
  else
    exc->F_dot_P = ((Long)gs.projVector.x * gs.freeVector.x +
                    (Long)gs.projVector.y * gs.freeVector.y) >> 14;
  if (gs.projVector.x == 0x4000)
    exc->proj_kind = 1;
  else if (gs.projVector.y == 0x4000)
    exc->proj_kind = 2;
  else
    exc->proj_kind = 0;
  if (gs.dualVector.x == 0x4000)
    exc->dual_kind = 1;
  else if (gs.dualVector.y == 0x4000)
    exc->dual_kind = 2;
  else
    exc->dual_kind = 0;
  exc->move_kind = 0;
  if (exc->F_dot_P == 0x4000) {
    if (gs.freeVector.x == 0x4000)
      exc->move_kind = 1;
    else if (gs.freeVector.y == 0x4000)
      exc->move_kind = 2;
  }
  if ((exc->F_dot_P < 0 ? -exc->F_dot_P : exc->F_dot_P) < 0x400L)
    exc->F_dot_P = 0x4000L;
}

static inline Long project(Exec* exc, Long dx, Long dy) {
  if (exc->proj_kind == 1) return dx;
  if (exc->proj_kind == 2) return dy;
  return dot_fix14(dx, dy, exc->GS.projVector.x, exc->GS.projVector.y);
}

static inline Long dual_project(Exec* exc, Long dx, Long dy) {
  if (exc->dual_kind == 1) return dx;
  if (exc->dual_kind == 2) return dy;
  return dot_fix14(dx, dy, exc->GS.dualVector.x, exc->GS.dualVector.y);
}

#define PROJECT(v1, v2) project(exc, sub_long((v1)->x, (v2)->x), sub_long((v1)->y, (v2)->y))
#define DUALPROJ(v1, v2) dual_project(exc, sub_long((v1)->x, (v2)->x), sub_long((v1)->y, (v2)->y))
#define FAST_PROJECT(v) project(exc, (v)->x, (v)->y)
#define FAST_DUALPROJ(v) dual_project(exc, (v)->x, (v)->y)

static inline bool post_iup(Exec* exc) {
  return exc->backward_compatibility && exc->iupx_called && exc->iupy_called;
}

static void func_move(Exec* exc, Zone* zone, int point, Long distance) {
  if (exc->move_kind == 1) {  // Direct_Move_X
    if (!exc->backward_compatibility)
      zone->cur[point].x = add_long(zone->cur[point].x, distance);
    zone->tags[point] |= TOUCH_X;
    return;
  }
  if (exc->move_kind == 2) {  // Direct_Move_Y
    if (!post_iup(exc))
      zone->cur[point].y = add_long(zone->cur[point].y, distance);
    zone->tags[point] |= TOUCH_Y;
    return;
  }
  Long v = exc->GS.freeVector.x;
  if (v != 0) {
    if (!exc->backward_compatibility)
      zone->cur[point].x =
          add_long(zone->cur[point].x, mul_div(distance, v, exc->F_dot_P));
    zone->tags[point] |= TOUCH_X;
  }
  v = exc->GS.freeVector.y;
  if (v != 0) {
    if (!post_iup(exc))
      zone->cur[point].y =
          add_long(zone->cur[point].y, mul_div(distance, v, exc->F_dot_P));
    zone->tags[point] |= TOUCH_Y;
  }
}

static void func_move_orig(Exec* exc, Zone* zone, int point, Long distance) {
  if (exc->move_kind == 1) {
    zone->org[point].x = add_long(zone->org[point].x, distance);
    return;
  }
  if (exc->move_kind == 2) {
    zone->org[point].y = add_long(zone->org[point].y, distance);
    return;
  }
  Long v = exc->GS.freeVector.x;
  if (v != 0)
    zone->org[point].x =
        add_long(zone->org[point].x, mul_div(distance, v, exc->F_dot_P));
  v = exc->GS.freeVector.y;
  if (v != 0)
    zone->org[point].y =
        add_long(zone->org[point].y, mul_div(distance, v, exc->F_dot_P));
}

static Long round_value(Exec* exc, Long distance, int state) {
  Long val;
  switch (state) {
    case 0:  // half grid
      if (distance >= 0) {
        val = add_long(pix_floor(distance), 32);
        if (val < 0) val = 32;
      } else {
        val = neg_long(add_long(pix_floor(neg_long(distance)), 32));
        if (val > 0) val = -32;
      }
      return val;
    case 1:  // grid
      if (distance >= 0) {
        val = pix_round(distance);
        if (val < 0) val = 0;
      } else {
        val = neg_long(pix_round(neg_long(distance)));
        if (val > 0) val = 0;
      }
      return val;
    case 2:  // double grid
      if (distance >= 0) {
        val = add_long(distance, 16) & -32;
        if (val < 0) val = 0;
      } else {
        val = neg_long(add_long(neg_long(distance), 16) & -32);
        if (val > 0) val = 0;
      }
      return val;
    case 3:  // down to grid
      if (distance >= 0) {
        val = pix_floor(distance);
        if (val < 0) val = 0;
      } else {
        val = neg_long(pix_floor(neg_long(distance)));
        if (val > 0) val = 0;
      }
      return val;
    case 4:  // up to grid
      if (distance >= 0) {
        val = pix_ceil(distance);
        if (val < 0) val = 0;
      } else {
        val = neg_long(pix_ceil(neg_long(distance)));
        if (val > 0) val = 0;
      }
      return val;
    case 5:  // off
      if (distance >= 0) {
        val = distance;
        if (val < 0) val = 0;
      } else {
        val = distance;
        if (val > 0) val = 0;
      }
      return val;
    case 6:  // super
      if (distance >= 0) {
        val = add_long(distance, exc->threshold - exc->phase) & -exc->period;
        val = add_long(val, exc->phase);
        if (val < 0) val = exc->phase;
      } else {
        val = neg_long(sub_long(exc->threshold - exc->phase, distance) &
                       -exc->period);
        val = sub_long(val, exc->phase);
        if (val > 0) val = -exc->phase;
      }
      return val;
    case 7:  // super 45
      if (distance >= 0) {
        val = (add_long(distance, exc->threshold - exc->phase) / exc->period) *
              exc->period;
        val = add_long(val, exc->phase);
        if (val < 0) val = exc->phase;
      } else {
        val = neg_long(
            (sub_long(exc->threshold - exc->phase, distance) / exc->period) *
            exc->period);
        val = sub_long(val, exc->phase);
        if (val > 0) val = -exc->phase;
      }
      return val;
  }
  return distance;
}

static inline Long func_round(Exec* exc, Long d) {
  return round_value(exc, d, exc->GS.round_state);
}

static inline Long round_none(Long distance) { return round_value(nullptr, distance, 5); }

static void set_super_round(Exec* exc, Long grid_period, Long selector) {
  switch ((int)(selector & 0xC0)) {
    case 0: exc->period = grid_period / 2; break;
    case 0x40: exc->period = grid_period; break;
    case 0x80: exc->period = grid_period * 2; break;
    case 0xC0: exc->period = grid_period; break;
  }
  switch ((int)(selector & 0x30)) {
    case 0: exc->phase = 0; break;
    case 0x10: exc->phase = exc->period / 4; break;
    case 0x20: exc->phase = exc->period / 2; break;
    case 0x30: exc->phase = exc->period * 3 / 4; break;
  }
  if ((selector & 0x0F) == 0)
    exc->threshold = exc->period - 1;
  else
    exc->threshold = ((int)(selector & 0x0F) - 4) * exc->period / 8;
  exc->period >>= 8;
  exc->phase >>= 8;
  exc->threshold >>= 8;
}

static void normalize(Long vx, Long vy, Vec* r) {
  if (vx == 0 && vy == 0) return;
  vector_normlen(&vx, &vy);
  r->x = (int16_t)(vx / 4);
  r->y = (int16_t)(vy / 4);
}

static void goto_range(Exec* exc, int range, Long ip) {
  if (range < 1 || range > 3) {
    exc->error = ERR_BAD_ARG;
    return;
  }
  if (!exc->range_code[range]) {
    exc->error = ERR_INVALID_REF;
    return;
  }
  if (ip > exc->range_size[range]) {
    exc->error = ERR_CODE_OVERFLOW;
    return;
  }
  exc->code = exc->range_code[range];
  exc->codeSize = exc->range_size[range];
  exc->IP = ip;
  exc->curRange = range;
}

static bool skip_code(Exec* exc) {
  exc->IP += exc->length;
  if (exc->IP < exc->codeSize) {
    exc->opcode = exc->code[exc->IP];
    exc->length = opcode_length[exc->opcode];
    if (exc->length < 0) {
      if (exc->IP + 1 >= exc->codeSize) goto fail;
      exc->length = 2 - exc->length * exc->code[exc->IP + 1];
    }
    if (exc->IP + exc->length <= exc->codeSize) return true;
  }
fail:
  exc->error = ERR_CODE_OVERFLOW;
  return false;
}

static void modify_cvt_check(Exec* exc) {
  if (exc->iniRange == RANGE_GLYPH && exc->cvt != exc->glyfCvt.data()) {
    exc->glyfCvt.assign(exc->cvt, exc->cvt + exc->cvtSize);
    exc->cvt = exc->glyfCvt.data();
  }
}

static void modify_storage_check(Exec* exc) {
  if (exc->iniRange == RANGE_GLYPH && exc->storage != exc->glyfStorage.data()) {
    exc->glyfStorage.assign(exc->storage, exc->storage + exc->storeSize);
    exc->storage = exc->glyfStorage.data();
  }
}

static bool set_zone(Exec* exc, Long n, Zone* z) {
  if (n == 0)
    *z = exc->twilight;
  else if (n == 1)
    *z = exc->pts;
  else
    return false;
  return true;
}

static void move_zp2_point(Exec* exc, int point, Long dx, Long dy, bool touch) {
  if (exc->GS.freeVector.x != 0) {
    if (!exc->backward_compatibility)
      exc->zp2.cur[point].x = add_long(exc->zp2.cur[point].x, dx);
    if (touch) exc->zp2.tags[point] |= TOUCH_X;
  }
  if (exc->GS.freeVector.y != 0) {
    if (!post_iup(exc))
      exc->zp2.cur[point].y = add_long(exc->zp2.cur[point].y, dy);
    if (touch) exc->zp2.tags[point] |= TOUCH_Y;
  }
}

static bool compute_point_displacement(Exec* exc, Long* x, Long* y, Zone* zone,
                                       int* refp) {
  Zone zp;
  int p;
  if (exc->opcode & 1) {
    zp = exc->zp0;
    p = exc->GS.rp1;
  } else {
    zp = exc->zp1;
    p = exc->GS.rp2;
  }
  if (bounds(p, zp.n_points)) {
    *refp = 0;
    return false;
  }
  *zone = zp;
  *refp = p;
  Long d = PROJECT(zp.cur + p, zp.org + p);
  *x = mul_div(d, (Long)exc->GS.freeVector.x, exc->F_dot_P);
  *y = mul_div(d, (Long)exc->GS.freeVector.y, exc->F_dot_P);
  return true;
}

struct IUPWorker {
  Vec* orgs;
  Vec* curs;
  Vec* orus;
  int axis;  // 0 = x, 1 = y
  int max_points;
  Long& o(int i) { return axis ? orgs[i].y : orgs[i].x; }
  Long& c(int i) { return axis ? curs[i].y : curs[i].x; }
  Long& u(int i) { return axis ? orus[i].y : orus[i].x; }
};

static void iup_shift(IUPWorker& w, int p1, int p2, int p) {
  Long dx = sub_long(w.c(p), w.o(p));
  if (dx != 0) {
    for (int i = p1; i < p; i++) w.c(i) = add_long(w.c(i), dx);
    for (int i = p + 1; i <= p2; i++) w.c(i) = add_long(w.c(i), dx);
  }
}

static void iup_interpolate(IUPWorker& w, int p1, int p2, int ref1, int ref2) {
  if (p1 > p2) return;
  if (bounds(ref1, w.max_points) || bounds(ref2, w.max_points)) return;
  Long orus1 = w.u(ref1), orus2 = w.u(ref2);
  if (orus1 > orus2) {
    Long t = orus1;
    orus1 = orus2;
    orus2 = t;
    int r = ref1;
    ref1 = ref2;
    ref2 = r;
  }
  Long org1 = w.o(ref1), org2 = w.o(ref2);
  Long cur1 = w.c(ref1), cur2 = w.c(ref2);
  Long delta1 = sub_long(cur1, org1), delta2 = sub_long(cur2, org2);
  if (cur1 == cur2 || orus1 == orus2) {
    for (int i = p1; i <= p2; i++) {
      Long x = w.o(i);
      if (x <= org1)
        x = add_long(x, delta1);
      else if (x >= org2)
        x = add_long(x, delta2);
      else
        x = cur1;
      w.c(i) = x;
    }
  } else {
    Long scale = 0;
    bool scale_valid = false;
    for (int i = p1; i <= p2; i++) {
      Long x = w.o(i);
      if (x <= org1)
        x = add_long(x, delta1);
      else if (x >= org2)
        x = add_long(x, delta2);
      else {
        if (!scale_valid) {
          scale_valid = true;
          scale = div_fix(sub_long(cur2, cur1), sub_long(orus2, orus1));
        }
        x = add_long(cur1, mul_fix(sub_long(w.u(i), orus1), scale));
      }
      w.c(i) = x;
    }
  }
}

static void ins_iup(Exec* exc) {
  if (exc->backward_compatibility) {
    if (exc->iupx_called && exc->iupy_called) return;
    if (exc->opcode & 1)
      exc->iupx_called = true;
    else
      exc->iupy_called = true;
  }
  if (exc->pts.n_contours == 0) return;
  IUPWorker w;
  uint8_t mask;
  if (exc->opcode & 1) {
    mask = TOUCH_X;
    w.axis = 0;
  } else {
    mask = TOUCH_Y;
    w.axis = 1;
  }
  w.orgs = exc->pts.org;
  w.curs = exc->pts.cur;
  w.orus = exc->pts.orus;
  w.max_points = exc->pts.n_points;
  int contour = 0, point = 0;
  do {
    int end_point = exc->pts.contours[contour] - exc->pts.first_point;
    int first_point = point;
    if (bounds(end_point, exc->pts.n_points)) end_point = exc->pts.n_points - 1;
    while (point <= end_point && (exc->pts.tags[point] & mask) == 0) point++;
    if (point <= end_point) {
      int first_touched = point, cur_touched = point;
      point++;
      while (point <= end_point) {
        if ((exc->pts.tags[point] & mask) != 0) {
          iup_interpolate(w, cur_touched + 1, point - 1, cur_touched, point);
          cur_touched = point;
        }
        point++;
      }
      if (cur_touched == first_touched)
        iup_shift(w, first_point, end_point, cur_touched);
      else {
        iup_interpolate(w, cur_touched + 1, end_point, cur_touched,
                        first_touched);
        if (first_touched > 0)
          iup_interpolate(w, first_point, first_touched - 1, cur_touched,
                          first_touched);
      }
    }
    contour++;
  } while (contour < exc->pts.n_contours);
}

static DefRec* find_fdef(Exec* exc, ULong F) {
  Size* sz = exc->size;
  if (bounds((Long)F, (Long)sz->maxFunc + 1)) return nullptr;
  if (sz->fdefs.empty()) return nullptr;
  DefRec* def = nullptr;
  if (F < sz->fdefs.size()) def = &sz->fdefs[F];
  if ((int)sz->maxFunc + 1 != sz->numFDefs || !def || def->opc != F) {
    def = nullptr;
    for (int i = 0; i < sz->numFDefs; i++)
      if (sz->fdefs[i].opc == F) {
        def = &sz->fdefs[i];
        break;
      }
    if (!def) return nullptr;
  }
  if (!def->active) return nullptr;
  return def;
}

static void ins_fdef(Exec* exc, Long* args) {
  Size* sz = exc->size;
  if (exc->iniRange == RANGE_GLYPH) {
    exc->error = ERR_DEF_IN_GLYF;
    return;
  }
  ULong n = (ULong)args[0];
  int i = 0;
  for (; i < sz->numFDefs; i++)
    if (sz->fdefs[i].opc == n) break;
  if (i == sz->numFDefs) {
    if (sz->numFDefs >= (int)sz->fdefs.size()) {
      exc->error = ERR_TOO_MANY_DEFS;
      return;
    }
    sz->numFDefs++;
  }
  if (n > 0xFFFFU) {
    exc->error = ERR_TOO_MANY_DEFS;
    return;
  }
  DefRec* rec = &sz->fdefs[i];
  rec->range = exc->curRange;
  rec->opc = (unsigned)n;
  rec->start = exc->IP + 1;
  rec->active = true;
  if (n > sz->maxFunc) sz->maxFunc = (unsigned)n;
  while (skip_code(exc)) {
    switch (exc->opcode) {
      case 0x89:
      case 0x2C:
        exc->error = ERR_NESTED_DEFS;
        return;
      case 0x2D:
        rec->end = exc->IP;
        return;
    }
  }
}

static void ins_idef(Exec* exc, Long* args) {
  Size* sz = exc->size;
  if (exc->iniRange == RANGE_GLYPH) {
    exc->error = ERR_DEF_IN_GLYF;
    return;
  }
  int i = 0;
  for (; i < sz->numIDefs; i++)
    if (sz->idefs[i].opc == (ULong)args[0]) break;
  if (i == sz->numIDefs) {
    if (sz->numIDefs >= (int)sz->idefs.size()) {
      exc->error = ERR_TOO_MANY_DEFS;
      return;
    }
    sz->numIDefs++;
  }
  if (0 > args[0] || args[0] > 0x00FF) {
    exc->error = ERR_TOO_MANY_DEFS;
    return;
  }
  DefRec* def = &sz->idefs[i];
  def->opc = (unsigned)args[0];
  def->start = exc->IP + 1;
  def->range = exc->curRange;
  def->active = true;
  if ((ULong)args[0] > sz->maxIns) sz->maxIns = (unsigned)args[0];
  while (skip_code(exc)) {
    switch (exc->opcode) {
      case 0x89:
      case 0x2C:
        exc->error = ERR_NESTED_DEFS;
        return;
      case 0x2D:
        def->end = exc->IP;
        return;
    }
  }
}

static void ins_call(Exec* exc, DefRec* def, Long count) {
  if (exc->callTop >= (int)exc->callStack.size()) {
    exc->error = ERR_STACK_OVERFLOW;
    return;
  }
  CallRec* c = &exc->callStack[exc->callTop];
  c->caller_range = exc->curRange;
  c->caller_ip = exc->IP + 1;
  c->cur_count = count;
  c->def = def;
  exc->callTop++;
  goto_range(exc, def->range, def->start);
  exc->step_ins = false;
}

static void ins_unknown(Exec* exc) {
  Size* sz = exc->size;
  for (int i = 0; i < sz->numIDefs; i++) {
    DefRec* def = &sz->idefs[i];
    if ((uint8_t)def->opc == exc->opcode && def->active) {
      ins_call(exc, def, 1);
      return;
    }
  }
  exc->error = ERR_INVALID_OPCODE;
}

static void ins_jmpr(Exec* exc, Long* args) {
  if (args[0] == 0 && exc->args == 0) {
    exc->error = ERR_BAD_ARG;
    return;
  }
  exc->IP = add_long(exc->IP, args[0]);
  if (exc->IP < 0 ||
      (exc->callTop > 0 && exc->IP > exc->callStack[exc->callTop - 1].def->end)) {
    exc->error = ERR_BAD_ARG;
    return;
  }
  exc->step_ins = false;
  if (args[0] < 0) {
    if (++exc->neg_jump_counter > exc->neg_jump_counter_max)
      exc->error = ERR_TOO_LONG;
  }
}

static bool ins_sxvtl(Exec* exc, int aIdx1, int aIdx2, Vec* vec) {
  uint8_t opcode = exc->opcode;
  if (bounds(aIdx1, exc->zp2.n_points) || bounds(aIdx2, exc->zp1.n_points))
    return false;
  Vec* p1 = exc->zp1.cur + aIdx2;
  Vec* p2 = exc->zp2.cur + aIdx1;
  Long A = sub_long(p1->x, p2->x);
  Long B = sub_long(p1->y, p2->y);
  if (A == 0 && B == 0) {
    A = 0x4000;
    opcode = 0;
  }
  if ((opcode & 1) != 0) {
    Long C = B;
    B = A;
    A = neg_long(C);
  }
  normalize(A, B, vec);
  return true;
}

static void ins_getinfo(Exec* exc, Long* args) {
  Long K = 0;
  if ((args[0] & 1) != 0) K = 40;
  if ((args[0] & 32) != 0 && exc->grayscale) K |= 1 << 12;
  if (exc->subpixel_hinting_lean) {
    if ((args[0] & 64) != 0) K |= 1 << 13;
    if ((args[0] & 1024) != 0) K |= 1 << 17;
    if ((args[0] & 2048) != 0) K |= 1 << 18;
    if ((args[0] & 4096) != 0 && exc->grayscale_cleartype) K |= 1 << 19;
  }
  args[0] = K;
}

static void ins_instctrl(Exec* exc, Long* args) {
  ULong K = (ULong)args[1], L = (ULong)args[0];
  if (K < 1 || K > 3) return;
  ULong Kf = 1UL << (K - 1);
  if (L != 0 && L != Kf) return;
  if (exc->iniRange == RANGE_CVT) {
    exc->GS.instruct_control &= ~(uint8_t)Kf;
    exc->GS.instruct_control |= (uint8_t)L;
  } else if (exc->iniRange == RANGE_GLYPH && K == 3) {
    exc->backward_compatibility = !(L == 4);
  }
}

static void ins_deltap(Exec* exc, Long* args) {
  ULong P = (ULong)exc->ppem;
  ULong nump = (ULong)args[0];
  for (ULong k = 1; k <= nump; k++) {
    if (exc->args < 2) {
      exc->args = 0;
      goto fail;
    }
    exc->args -= 2;
    {
      int A = (uint16_t)exc->stack[exc->args + 1];
      Long B = exc->stack[exc->args];
      if (!bounds(A, exc->zp0.n_points)) {
        ULong C = ((ULong)B & 0xF0) >> 4;
        switch (exc->opcode) {
          case 0x5D: break;
          case 0x71: C += 16; break;
          case 0x72: C += 32; break;
        }
        C += exc->GS.delta_base;
        if (P == C) {
          B = (Long)((ULong)B & 0xF) - 8;
          if (B >= 0) B++;
          B *= 1L << (6 - exc->GS.delta_shift);
          if (exc->backward_compatibility) {
            if (!(exc->iupx_called && exc->iupy_called) &&
                ((exc->is_composite && exc->GS.freeVector.y != 0) ||
                 (exc->zp0.tags[A] & TOUCH_Y)))
              func_move(exc, &exc->zp0, A, B);
          } else
            func_move(exc, &exc->zp0, A, B);
        }
      }
    }
  }
fail:
  exc->new_top = exc->args;
}

static void ins_deltac(Exec* exc, Long* args) {
  ULong P = (ULong)exc->ppem;
  ULong nump = (ULong)args[0];
  for (ULong k = 1; k <= nump; k++) {
    if (exc->args < 2) {
      exc->args = 0;
      goto fail;
    }
    exc->args -= 2;
    {
      ULong A = (ULong)exc->stack[exc->args + 1];
      Long B = exc->stack[exc->args];
      if (!bounds((Long)A, exc->cvtSize)) {
        ULong C = ((ULong)B & 0xF0) >> 4;
        switch (exc->opcode) {
          case 0x73: break;
          case 0x74: C += 16; break;
          case 0x75: C += 32; break;
        }
        C += exc->GS.delta_base;
        if (P == C) {
          B = (Long)((ULong)B & 0xF) - 8;
          if (B >= 0) B++;
          B *= 1L << (6 - exc->GS.delta_shift);
          modify_cvt_check(exc);
          exc->cvt[A] = add_long(exc->cvt[A], B);
        }
      }
    }
  }
fail:
  exc->new_top = exc->args;
}

static void ins_mdap(Exec* exc, Long* args) {
  int point = (uint16_t)args[0];
  if (bounds(point, exc->zp0.n_points)) return;
  Long distance;
  if ((exc->opcode & 1) != 0) {
    Long cur_dist = FAST_PROJECT(&exc->zp0.cur[point]);
    distance = sub_long(func_round(exc, cur_dist), cur_dist);
  } else
    distance = 0;
  func_move(exc, &exc->zp0, point, distance);
  exc->GS.rp0 = point;
  exc->GS.rp1 = point;
}

static void ins_miap(Exec* exc, Long* args) {
  ULong cvtEntry = (ULong)args[1];
  int point = (uint16_t)args[0];
  if (bounds(point, exc->zp0.n_points) || bounds((Long)cvtEntry, exc->cvtSize))
    goto fail;
  {
    Long distance = exc->cvt[cvtEntry];
    if (exc->GS.gep0 == 0) {
      exc->zp0.org[point].x = mul_fix14(distance, exc->GS.freeVector.x);
      exc->zp0.org[point].y = mul_fix14(distance, exc->GS.freeVector.y);
      exc->zp0.cur[point] = exc->zp0.org[point];
    }
    Long org_dist = FAST_PROJECT(&exc->zp0.cur[point]);
    if ((exc->opcode & 1) != 0) {
      Long delta = sub_long(distance, org_dist);
      if (delta < 0) delta = neg_long(delta);
      if (delta > exc->GS.control_value_cutin) distance = org_dist;
      distance = func_round(exc, distance);
    }
    func_move(exc, &exc->zp0, point, sub_long(distance, org_dist));
  }
fail:
  exc->GS.rp0 = point;
  exc->GS.rp1 = point;
}

static void ins_mdrp(Exec* exc, Long* args) {
  int point = (uint16_t)args[0];
  Long org_dist, distance;
  if (bounds(point, exc->zp1.n_points) || bounds(exc->GS.rp0, exc->zp0.n_points))
    goto fail;
  if (exc->GS.gep0 == 0 || exc->GS.gep1 == 0) {
    org_dist = DUALPROJ(&exc->zp1.org[point], &exc->zp0.org[exc->GS.rp0]);
  } else {
    Vec* vec1 = &exc->zp1.orus[point];
    Vec* vec2 = &exc->zp0.orus[exc->GS.rp0];
    if (exc->x_scale == exc->y_scale) {
      org_dist = DUALPROJ(vec1, vec2);
      org_dist = mul_fix(org_dist, exc->x_scale);
    } else {
      Vec v;
      v.x = mul_fix(sub_long(vec1->x, vec2->x), exc->x_scale);
      v.y = mul_fix(sub_long(vec1->y, vec2->y), exc->y_scale);
      org_dist = FAST_DUALPROJ(&v);
    }
  }
  if (exc->GS.single_width_cutin > 0 &&
      org_dist < exc->GS.single_width_value + exc->GS.single_width_cutin &&
      org_dist > exc->GS.single_width_value - exc->GS.single_width_cutin) {
    if (org_dist >= 0)
      org_dist = exc->GS.single_width_value;
    else
      org_dist = -exc->GS.single_width_value;
  }
  if ((exc->opcode & 4) != 0)
    distance = func_round(exc, org_dist);
  else
    distance = round_none(org_dist);
  if ((exc->opcode & 8) != 0) {
    Long md = exc->GS.minimum_distance;
    if (org_dist >= 0) {
      if (distance < md) distance = md;
    } else {
      if (distance > neg_long(md)) distance = neg_long(md);
    }
  }
  org_dist = PROJECT(exc->zp1.cur + point, exc->zp0.cur + exc->GS.rp0);
  func_move(exc, &exc->zp1, point, sub_long(distance, org_dist));
fail:
  exc->GS.rp1 = exc->GS.rp0;
  exc->GS.rp2 = point;
  if ((exc->opcode & 16) != 0) exc->GS.rp0 = point;
}

static void ins_mirp(Exec* exc, Long* args) {
  int point = (uint16_t)args[0];
  ULong cvtEntry = (ULong)add_long(args[1], 1);
  Long cvt_dist, distance, cur_dist, org_dist, delta;
  if (bounds(point, exc->zp1.n_points) ||
      bounds((Long)cvtEntry, exc->cvtSize + 1) ||
      bounds(exc->GS.rp0, exc->zp0.n_points))
    goto fail;
  if (!cvtEntry)
    cvt_dist = 0;
  else
    cvt_dist = exc->cvt[cvtEntry - 1];
  delta = sub_long(cvt_dist, exc->GS.single_width_value);
  if (delta < 0) delta = neg_long(delta);
  if (delta < exc->GS.single_width_cutin) {
    if (cvt_dist >= 0)
      cvt_dist = exc->GS.single_width_value;
    else
      cvt_dist = -exc->GS.single_width_value;
  }
  if (exc->GS.gep1 == 0) {
    exc->zp1.org[point].x = add_long(exc->zp0.org[exc->GS.rp0].x,
                                     mul_fix14(cvt_dist, exc->GS.freeVector.x));
    exc->zp1.org[point].y = add_long(exc->zp0.org[exc->GS.rp0].y,
                                     mul_fix14(cvt_dist, exc->GS.freeVector.y));
    exc->zp1.cur[point] = exc->zp1.org[point];
  }
  org_dist = DUALPROJ(&exc->zp1.org[point], &exc->zp0.org[exc->GS.rp0]);
  cur_dist = PROJECT(&exc->zp1.cur[point], &exc->zp0.cur[exc->GS.rp0]);
  if (exc->GS.auto_flip) {
    if ((org_dist ^ cvt_dist) < 0) cvt_dist = neg_long(cvt_dist);
  }
  if ((exc->opcode & 4) != 0) {
    if (exc->GS.gep0 == exc->GS.gep1) {
      delta = sub_long(cvt_dist, org_dist);
      if (delta < 0) delta = neg_long(delta);
      if (delta > exc->GS.control_value_cutin) cvt_dist = org_dist;
    }
    distance = func_round(exc, cvt_dist);
  } else
    distance = round_none(cvt_dist);
  if ((exc->opcode & 8) != 0) {
    Long md = exc->GS.minimum_distance;
    if (org_dist >= 0) {
      if (distance < md) distance = md;
    } else {
      if (distance > neg_long(md)) distance = neg_long(md);
    }
  }
  func_move(exc, &exc->zp1, point, sub_long(distance, cur_dist));
fail:
  exc->GS.rp1 = exc->GS.rp0;
  if ((exc->opcode & 16) != 0) exc->GS.rp0 = point;
  exc->GS.rp2 = point;
}

static void ins_msirp(Exec* exc, Long* args) {
  int point = (uint16_t)args[0];
  if (bounds(point, exc->zp1.n_points) || bounds(exc->GS.rp0, exc->zp0.n_points))
    return;
  if (exc->GS.gep1 == 0) {
    exc->zp1.org[point] = exc->zp0.org[exc->GS.rp0];
    func_move_orig(exc, &exc->zp1, point, args[1]);
    exc->zp1.cur[point] = exc->zp1.org[point];
  }
  Long distance = PROJECT(exc->zp1.cur + point, exc->zp0.cur + exc->GS.rp0);
  func_move(exc, &exc->zp1, point, sub_long(args[1], distance));
  exc->GS.rp1 = exc->GS.rp0;
  exc->GS.rp2 = point;
  if ((exc->opcode & 1) != 0) exc->GS.rp0 = point;
}

static void ins_ip(Exec* exc) {
  Long old_range, cur_range;
  Vec* orus_base;
  Vec* cur_base;
  bool twilight;
  if (exc->top < exc->GS.loop) goto fail;
  twilight = exc->GS.gep0 == 0 || exc->GS.gep1 == 0 || exc->GS.gep2 == 0;
  if (bounds(exc->GS.rp1, exc->zp0.n_points)) goto fail;
  if (twilight)
    orus_base = &exc->zp0.org[exc->GS.rp1];
  else
    orus_base = &exc->zp0.orus[exc->GS.rp1];
  cur_base = &exc->zp0.cur[exc->GS.rp1];
  if (bounds(exc->GS.rp1, exc->zp0.n_points) ||
      bounds(exc->GS.rp2, exc->zp1.n_points)) {
    old_range = 0;
    cur_range = 0;
  } else {
    if (twilight)
      old_range = DUALPROJ(&exc->zp1.org[exc->GS.rp2], orus_base);
    else if (exc->x_scale == exc->y_scale)
      old_range = DUALPROJ(&exc->zp1.orus[exc->GS.rp2], orus_base);
    else {
      Vec v;
      v.x = mul_fix(sub_long(exc->zp1.orus[exc->GS.rp2].x, orus_base->x),
                    exc->x_scale);
      v.y = mul_fix(sub_long(exc->zp1.orus[exc->GS.rp2].y, orus_base->y),
                    exc->y_scale);
      old_range = FAST_DUALPROJ(&v);
    }
    cur_range = PROJECT(&exc->zp1.cur[exc->GS.rp2], cur_base);
  }
  for (; exc->GS.loop > 0; exc->GS.loop--) {
    ULong point = (ULong)exc->stack[--exc->args];
    Long org_dist, cur_dist, new_dist;
    if (bounds((Long)point, exc->zp2.n_points)) continue;
    if (twilight)
      org_dist = DUALPROJ(&exc->zp2.org[point], orus_base);
    else if (exc->x_scale == exc->y_scale)
      org_dist = DUALPROJ(&exc->zp2.orus[point], orus_base);
    else {
      Vec v;
      v.x = mul_fix(sub_long(exc->zp2.orus[point].x, orus_base->x), exc->x_scale);
      v.y = mul_fix(sub_long(exc->zp2.orus[point].y, orus_base->y), exc->y_scale);
      org_dist = FAST_DUALPROJ(&v);
    }
    cur_dist = PROJECT(&exc->zp2.cur[point], cur_base);
    if (org_dist) {
      if (old_range)
        new_dist = mul_div(org_dist, cur_range, old_range);
      else
        new_dist = org_dist;
    } else
      new_dist = 0;
    func_move(exc, &exc->zp2, (int)point, sub_long(new_dist, cur_dist));
  }
fail:
  exc->GS.loop = 1;
  exc->new_top = exc->args;
}

static void ins_shp(Exec* exc) {
  Zone zp;
  int refp;
  Long dx, dy;
  if (exc->top < exc->GS.loop) goto fail;
  if (!compute_point_displacement(exc, &dx, &dy, &zp, &refp)) return;
  while (exc->GS.loop > 0) {
    exc->args--;
    int point = (uint16_t)exc->stack[exc->args];
    if (!bounds(point, exc->zp2.n_points)) {
      if (exc->backward_compatibility)
        move_zp2_point(exc, point, 0, dy, true);
      else
        move_zp2_point(exc, point, dx, dy, true);
    }
    exc->GS.loop--;
  }
fail:
  exc->GS.loop = 1;
  exc->new_top = exc->args;
}

static void ins_shc(Exec* exc, Long* args) {
  Zone zp;
  int refp;
  Long dx, dy;
  int contour = (uint16_t)args[0];
  int bnd = exc->GS.gep2 == 0 ? 1 : exc->zp2.n_contours;
  if (bounds(contour, bnd)) return;
  if (!compute_point_displacement(exc, &dx, &dy, &zp, &refp)) return;
  int start, limit;
  if (contour == 0)
    start = 0;
  else
    start = (uint16_t)(exc->zp2.contours[contour - 1] + 1 - exc->zp2.first_point);
  if (exc->GS.gep2 == 0)
    limit = exc->zp2.n_points;
  else
    limit = (uint16_t)(exc->zp2.contours[contour] - exc->zp2.first_point + 1);
  for (int i = start; i < limit; i++) {
    if (zp.cur != exc->zp2.cur || refp != i) move_zp2_point(exc, i, dx, dy, true);
  }
}

static void ins_shz(Exec* exc, Long* args) {
  Zone zp;
  int refp;
  Long dx, dy;
  if (bounds(args[0], 2)) return;
  if (!compute_point_displacement(exc, &dx, &dy, &zp, &refp)) return;
  int limit;
  if (exc->GS.gep2 == 0)
    limit = exc->zp2.n_points;
  else if (exc->GS.gep2 == 1 && exc->zp2.n_contours > 0)
    limit = (uint16_t)(exc->zp2.contours[exc->zp2.n_contours - 1] + 1);
  else
    limit = 0;
  for (int i = 0; i < limit; i++) {
    if (zp.cur != exc->zp2.cur || refp != i) move_zp2_point(exc, i, dx, dy, false);
  }
}

static void ins_shpix(Exec* exc, Long* args) {
  bool in_twilight = exc->GS.gep0 == 0 || exc->GS.gep1 == 0 || exc->GS.gep2 == 0;
  Long dx, dy;
  if (exc->top < exc->GS.loop + 1) goto fail;
  dx = mul_fix14(args[0], exc->GS.freeVector.x);
  dy = mul_fix14(args[0], exc->GS.freeVector.y);
  while (exc->GS.loop > 0) {
    exc->args--;
    int point = (uint16_t)exc->stack[exc->args];
    if (!bounds(point, exc->zp2.n_points)) {
      if (exc->backward_compatibility) {
        if (in_twilight ||
            (!(exc->iupx_called && exc->iupy_called) &&
             ((exc->is_composite && exc->GS.freeVector.y != 0) ||
              (exc->zp2.tags[point] & TOUCH_Y))))
          move_zp2_point(exc, point, 0, dy, true);
      } else
        move_zp2_point(exc, point, dx, dy, true);
    }
    exc->GS.loop--;
  }
fail:
  exc->GS.loop = 1;
  exc->new_top = exc->args;
}

static void ins_alignrp(Exec* exc) {
  if (exc->top < exc->GS.loop || bounds(exc->GS.rp0, exc->zp0.n_points)) goto fail;
  while (exc->GS.loop > 0) {
    exc->args--;
    int point = (uint16_t)exc->stack[exc->args];
    if (!bounds(point, exc->zp1.n_points)) {
      Long distance = PROJECT(exc->zp1.cur + point, exc->zp0.cur + exc->GS.rp0);
      func_move(exc, &exc->zp1, point, neg_long(distance));
    }
    exc->GS.loop--;
  }
fail:
  exc->GS.loop = 1;
  exc->new_top = exc->args;
}

static void ins_isect(Exec* exc, Long* args) {
  int point = (uint16_t)args[0];
  int a0 = (uint16_t)args[1], a1 = (uint16_t)args[2];
  int b0 = (uint16_t)args[3], b1 = (uint16_t)args[4];
  if (bounds(b0, exc->zp0.n_points) || bounds(b1, exc->zp0.n_points) ||
      bounds(a0, exc->zp1.n_points) || bounds(a1, exc->zp1.n_points) ||
      bounds(point, exc->zp2.n_points))
    return;
  Long dbx = sub_long(exc->zp0.cur[b1].x, exc->zp0.cur[b0].x);
  Long dby = sub_long(exc->zp0.cur[b1].y, exc->zp0.cur[b0].y);
  Long dax = sub_long(exc->zp1.cur[a1].x, exc->zp1.cur[a0].x);
  Long day = sub_long(exc->zp1.cur[a1].y, exc->zp1.cur[a0].y);
  Long dx = sub_long(exc->zp0.cur[b0].x, exc->zp1.cur[a0].x);
  Long dy = sub_long(exc->zp0.cur[b0].y, exc->zp1.cur[a0].y);
  Long discriminant = add_long(mul_div(dax, neg_long(dby), 0x40),
                               mul_div(day, dbx, 0x40));
  Long dotproduct = add_long(mul_div(dax, dbx, 0x40), mul_div(day, dby, 0x40));
  Long ad = discriminant < 0 ? -discriminant : discriminant;
  Long ap = dotproduct < 0 ? -dotproduct : dotproduct;
  if (19 * ad > ap) {
    Long val = add_long(mul_div(dx, neg_long(dby), 0x40), mul_div(dy, dbx, 0x40));
    Long rx = mul_div(val, dax, discriminant);
    Long ry = mul_div(val, day, discriminant);
    exc->zp2.cur[point].x = add_long(exc->zp1.cur[a0].x, rx);
    exc->zp2.cur[point].y = add_long(exc->zp1.cur[a0].y, ry);
  } else {
    exc->zp2.cur[point].x =
        add_long(add_long(exc->zp1.cur[a0].x, exc->zp1.cur[a1].x),
                 add_long(exc->zp0.cur[b0].x, exc->zp0.cur[b1].x)) / 4;
    exc->zp2.cur[point].y =
        add_long(add_long(exc->zp1.cur[a0].y, exc->zp1.cur[a1].y),
                 add_long(exc->zp0.cur[b0].y, exc->zp0.cur[b1].y)) / 4;
  }
  exc->zp2.tags[point] |= TOUCH_X | TOUCH_Y;
}

static void ins_sdpvtl(Exec* exc, Long* args) {
  uint8_t opcode = exc->opcode;
  int p1 = (uint16_t)args[1], p2 = (uint16_t)args[0];
  if (bounds(p2, exc->zp1.n_points) || bounds(p1, exc->zp2.n_points)) return;
  Long A, B, C;
  {
    Vec* v1 = exc->zp1.org + p2;
    Vec* v2 = exc->zp2.org + p1;
    A = sub_long(v1->x, v2->x);
    B = sub_long(v1->y, v2->y);
    if (A == 0 && B == 0) {
      A = 0x4000;
      opcode = 0;
    }
  }
  if ((opcode & 1) != 0) {
    C = B;
    B = A;
    A = neg_long(C);
  }
  normalize(A, B, &exc->GS.dualVector);
  {
    Vec* v1 = exc->zp1.cur + p2;
    Vec* v2 = exc->zp2.cur + p1;
    A = sub_long(v1->x, v2->x);
    B = sub_long(v1->y, v2->y);
    if (A == 0 && B == 0) {
      A = 0x4000;
      opcode = 0;
    }
  }
  if ((opcode & 1) != 0) {
    C = B;
    B = A;
    A = neg_long(C);
  }
  normalize(A, B, &exc->GS.projVector);
  compute_funcs(exc);
}

static int run_ins(Exec* exc) {
  Long ins_counter = 0;
  exc->iupx_called = false;
  exc->iupy_called = false;
  compute_funcs(exc);
  exc->loopcall_counter = 0;
  exc->neg_jump_counter = 0;
  {
    Long np = exc->pts.n_points > 0 ? exc->pts.n_points : 0;
    Long nc = exc->cvtSize;
    // FreeType's heuristic limits against runaway programs
    exc->loopcall_counter_max = np * 10 > 100 ? np * 10 : 100;
    exc->loopcall_counter_max += nc * 10;
    exc->neg_jump_counter_max = exc->loopcall_counter_max;
    if (exc->loopcall_counter_max < 100 * 64) exc->loopcall_counter_max = 100 * 64;
    if (exc->neg_jump_counter_max < 100 * 64) exc->neg_jump_counter_max = 100 * 64;
  }
  do {
    exc->opcode = exc->code[exc->IP];
    exc->length = opcode_length[exc->opcode];
    if (exc->length < 0) {
      if (exc->IP + 1 >= exc->codeSize) return ERR_CODE_OVERFLOW;
      exc->length = 2 - exc->length * exc->code[exc->IP + 1];
    }
    if (exc->IP + exc->length > exc->codeSize) return ERR_CODE_OVERFLOW;
    exc->args = exc->top - (pop_push[exc->opcode] >> 4);
    if (exc->args < 0) {
      for (int i = 0; i < (pop_push[exc->opcode] >> 4); i++) exc->stack[i] = 0;
      exc->args = 0;
    }
    exc->new_top = exc->args + (pop_push[exc->opcode] & 15);
    if (exc->new_top > exc->stackSize) return ERR_STACK_OVERFLOW;
    exc->step_ins = true;
    exc->error = ERR_OK;
    {
      Long* args = exc->stack.data() + exc->args;
      uint8_t opcode = exc->opcode;
      GraphicsState& GS = exc->GS;
      switch (opcode) {
        case 0x00: case 0x01: case 0x02: case 0x03: case 0x04: case 0x05: {
          int16_t AA = (int16_t)((opcode & 1) << 14);
          int16_t BB = (int16_t)(AA ^ 0x4000);
          if (opcode < 4) {
            GS.projVector.x = AA;
            GS.projVector.y = BB;
            GS.dualVector.x = AA;
            GS.dualVector.y = BB;
          }
          if ((opcode & 2) == 0) {
            GS.freeVector.x = AA;
            GS.freeVector.y = BB;
          }
          compute_funcs(exc);
          break;
        }
        case 0x06: case 0x07:
          if (ins_sxvtl(exc, (uint16_t)args[1], (uint16_t)args[0], &GS.projVector)) {
            GS.dualVector = GS.projVector;
            compute_funcs(exc);
          }
          break;
        case 0x08: case 0x09:
          if (ins_sxvtl(exc, (uint16_t)args[1], (uint16_t)args[0], &GS.freeVector))
            compute_funcs(exc);
          break;
        case 0x0A: case 0x0B: {
          Long Y = (Long)(int16_t)args[1];
          Long X = (Long)(int16_t)args[0];
          if (opcode == 0x0A) {
            normalize(X, Y, &GS.projVector);
            GS.dualVector = GS.projVector;
          } else
            normalize(X, Y, &GS.freeVector);
          compute_funcs(exc);
          break;
        }
        case 0x0C:
          args[0] = GS.projVector.x;
          args[1] = GS.projVector.y;
          break;
        case 0x0D:
          args[0] = GS.freeVector.x;
          args[1] = GS.freeVector.y;
          break;
        case 0x0E:
          GS.freeVector = GS.projVector;
          compute_funcs(exc);
          break;
        case 0x0F: ins_isect(exc, args); break;
        case 0x10: GS.rp0 = (uint16_t)args[0]; break;
        case 0x11: GS.rp1 = (uint16_t)args[0]; break;
        case 0x12: GS.rp2 = (uint16_t)args[0]; break;
        case 0x13:
          if (set_zone(exc, args[0], &exc->zp0)) GS.gep0 = (uint16_t)args[0];
          break;
        case 0x14:
          if (set_zone(exc, args[0], &exc->zp1)) GS.gep1 = (uint16_t)args[0];
          break;
        case 0x15:
          if (set_zone(exc, args[0], &exc->zp2)) GS.gep2 = (uint16_t)args[0];
          break;
        case 0x16:
          if (set_zone(exc, args[0], &exc->zp0)) {
            exc->zp1 = exc->zp0;
            exc->zp2 = exc->zp0;
            GS.gep0 = GS.gep1 = GS.gep2 = (uint16_t)args[0];
          }
          break;
        case 0x17:
          if (args[0] < 0)
            exc->error = ERR_BAD_ARG;
          else
            GS.loop = args[0] > 0xFFFFL ? 0xFFFFL : args[0];
          break;
        case 0x18: GS.round_state = 1; break;
        case 0x19: GS.round_state = 0; break;
        case 0x1A: GS.minimum_distance = args[0]; break;
        case 0x1B: {
          int nIfs = 1;
          do {
            if (!skip_code(exc)) break;
            switch (exc->opcode) {
              case 0x58: nIfs++; break;
              case 0x59: nIfs--; break;
            }
          } while (nIfs != 0);
          break;
        }
        case 0x1C: ins_jmpr(exc, args); break;
        case 0x1D: GS.control_value_cutin = args[0]; break;
        case 0x1E: GS.single_width_cutin = args[0]; break;
        case 0x1F: GS.single_width_value = mul_fix(args[0], exc->tt_scale); break;
        case 0x20: args[1] = args[0]; break;
        case 0x21: break;
        case 0x22: exc->new_top = 0; break;
        case 0x23: {
          Long L = args[0];
          args[0] = args[1];
          args[1] = L;
          break;
        }
        case 0x24: args[0] = exc->top; break;
        case 0x25: {
          Long L = args[0];
          if (L <= 0 || L > exc->args)
            args[0] = 0;
          else
            args[0] = exc->stack[exc->args - L];
          break;
        }
        case 0x26: {
          Long L = args[0];
          if (L <= 0 || L > exc->args) {
          } else {
            Long K = exc->stack[exc->args - L];
            memmove(&exc->stack[exc->args - L], &exc->stack[exc->args - L + 1],
                    (size_t)(L - 1) * sizeof(Long));
            exc->stack[exc->args - 1] = K;
          }
          break;
        }
        case 0x27: {
          int p1 = (uint16_t)args[0], p2 = (uint16_t)args[1];
          if (bounds(p1, exc->zp1.n_points) || bounds(p2, exc->zp0.n_points)) break;
          Long distance = PROJECT(exc->zp0.cur + p2, exc->zp1.cur + p1) / 2;
          func_move(exc, &exc->zp1, p1, distance);
          func_move(exc, &exc->zp0, p2, neg_long(distance));
          break;
        }
        case 0x29: {
          int point = (uint16_t)args[0];
          if (bounds(point, exc->zp0.n_points)) break;
          uint8_t mask = 0xFF;
          if (GS.freeVector.x != 0) mask &= ~TOUCH_X;
          if (GS.freeVector.y != 0) mask &= ~TOUCH_Y;
          exc->zp0.tags[point] &= mask;
          break;
        }
        case 0x2A: {
          DefRec* def = find_fdef(exc, (ULong)args[1]);
          if (!def) {
            exc->error = ERR_INVALID_REF;
            break;
          }
          if (args[0] > 0) {
            ins_call(exc, def, args[0]);
            if (exc->error) break;
            exc->loopcall_counter += args[0];
            if (exc->loopcall_counter > exc->loopcall_counter_max)
              exc->error = ERR_TOO_LONG;
          }
          break;
        }
        case 0x2B: {
          DefRec* def = find_fdef(exc, (ULong)args[0]);
          if (!def) {
            exc->error = ERR_INVALID_REF;
            break;
          }
          ins_call(exc, def, 1);
          break;
        }
        case 0x2C: ins_fdef(exc, args); break;
        case 0x2D: {
          if (exc->callTop <= 0) {
            exc->error = ERR_ENDF;
            break;
          }
          exc->callTop--;
          CallRec* pRec = &exc->callStack[exc->callTop];
          pRec->cur_count--;
          exc->step_ins = false;
          if (pRec->cur_count > 0) {
            exc->callTop++;
            exc->IP = pRec->def->start;
          } else
            goto_range(exc, pRec->caller_range, pRec->caller_ip);
          break;
        }
        case 0x2E: case 0x2F: ins_mdap(exc, args); break;
        case 0x30: case 0x31: ins_iup(exc); break;
        case 0x32: case 0x33: ins_shp(exc); break;
        case 0x34: case 0x35: ins_shc(exc, args); break;
        case 0x36: case 0x37: ins_shz(exc, args); break;
        case 0x38: ins_shpix(exc, args); break;
        case 0x39: ins_ip(exc); break;
        case 0x3A: case 0x3B: ins_msirp(exc, args); break;
        case 0x3C: ins_alignrp(exc); break;
        case 0x3D: GS.round_state = 2; break;
        case 0x3E: case 0x3F: ins_miap(exc, args); break;
        case 0x40: {
          Long L = exc->code[exc->IP + 1];
          if (bounds(L, exc->stackSize + 1 - exc->top)) {
            exc->error = ERR_STACK_OVERFLOW;
            break;
          }
          for (Long K = 1; K <= L; K++) args[K - 1] = exc->code[exc->IP + K + 1];
          exc->new_top += L;
          break;
        }
        case 0x41: {
          Long L = exc->code[exc->IP + 1];
          if (bounds(L, exc->stackSize + 1 - exc->top)) {
            exc->error = ERR_STACK_OVERFLOW;
            break;
          }
          exc->IP += 2;
          for (Long K = 0; K < L; K++) {
            args[K] = (int16_t)((exc->code[exc->IP] << 8) | exc->code[exc->IP + 1]);
            exc->IP += 2;
          }
          exc->step_ins = false;
          exc->new_top += L;
          break;
        }
        case 0x42: {
          ULong I = (ULong)args[0];
          if (!bounds((Long)I, exc->storeSize)) {
            modify_storage_check(exc);
            exc->storage[I] = args[1];
          }
          break;
        }
        case 0x43: {
          ULong I = (ULong)args[0];
          args[0] = bounds((Long)I, exc->storeSize) ? 0 : exc->storage[I];
          break;
        }
        case 0x44: {
          ULong I = (ULong)args[0];
          if (!bounds((Long)I, exc->cvtSize)) {
            modify_cvt_check(exc);
            exc->cvt[I] = args[1];
          }
          break;
        }
        case 0x45: {
          ULong I = (ULong)args[0];
          args[0] = bounds((Long)I, exc->cvtSize) ? 0 : exc->cvt[I];
          break;
        }
        case 0x46: case 0x47: {
          ULong L = (ULong)args[0];
          Long R;
          if (bounds((Long)L, exc->zp2.n_points))
            R = 0;
          else if (opcode & 1)
            R = FAST_DUALPROJ(&exc->zp2.org[L]);
          else
            R = FAST_PROJECT(&exc->zp2.cur[L]);
          args[0] = R;
          break;
        }
        case 0x48: {
          int L = (uint16_t)args[0];
          if (bounds(L, exc->zp2.n_points)) break;
          Long K = FAST_PROJECT(&exc->zp2.cur[L]);
          func_move(exc, &exc->zp2, L, sub_long(args[1], K));
          if (GS.gep2 == 0) exc->zp2.org[L] = exc->zp2.cur[L];
          break;
        }
        case 0x49: case 0x4A: {
          int K = (uint16_t)args[1], L = (uint16_t)args[0];
          Long D;
          if (bounds(L, exc->zp0.n_points) || bounds(K, exc->zp1.n_points))
            D = 0;
          else if (opcode & 1)
            D = PROJECT(exc->zp0.cur + L, exc->zp1.cur + K);
          else if (GS.gep0 == 0 || GS.gep1 == 0)
            D = DUALPROJ(exc->zp0.org + L, exc->zp1.org + K);
          else {
            Vec* vec1 = exc->zp0.orus + L;
            Vec* vec2 = exc->zp1.orus + K;
            if (exc->x_scale == exc->y_scale) {
              D = DUALPROJ(vec1, vec2);
              D = mul_fix(D, exc->x_scale);
            } else {
              Vec v;
              v.x = mul_fix(vec1->x - vec2->x, exc->x_scale);
              v.y = mul_fix(vec1->y - vec2->y, exc->y_scale);
              D = FAST_DUALPROJ(&v);
            }
          }
          args[0] = D;
          break;
        }
        case 0x4B: args[0] = exc->ppem; break;
        case 0x4C: args[0] = 12; break;
        case 0x4D: GS.auto_flip = true; break;
        case 0x4E: GS.auto_flip = false; break;
        case 0x4F: exc->error = ERR_DEBUG; break;
        case 0x50: args[0] = args[0] < args[1]; break;
        case 0x51: args[0] = args[0] <= args[1]; break;
        case 0x52: args[0] = args[0] > args[1]; break;
        case 0x53: args[0] = args[0] >= args[1]; break;
        case 0x54: args[0] = args[0] == args[1]; break;
        case 0x55: args[0] = args[0] != args[1]; break;
        case 0x56: args[0] = (func_round(exc, args[0]) & 127) == 64; break;
        case 0x57: args[0] = (func_round(exc, args[0]) & 127) == 0; break;
        case 0x58: {
          if (args[0] != 0) break;
          int nIfs = 1;
          bool out = false;
          do {
            if (!skip_code(exc)) break;
            switch (exc->opcode) {
              case 0x58: nIfs++; break;
              case 0x1B: out = nIfs == 1; break;
              case 0x59:
                nIfs--;
                out = nIfs == 0;
                break;
            }
          } while (!out);
          break;
        }
        case 0x59: break;
        case 0x5A: args[0] = (args[0] && args[1]); break;
        case 0x5B: args[0] = (args[0] || args[1]); break;
        case 0x5C: args[0] = !args[0]; break;
        case 0x5D: case 0x71: case 0x72: ins_deltap(exc, args); break;
        case 0x5E: GS.delta_base = (uint16_t)args[0]; break;
        case 0x5F:
          if ((ULong)args[0] > 6UL)
            exc->error = ERR_BAD_ARG;
          else
            GS.delta_shift = (uint16_t)args[0];
          break;
        case 0x60: args[0] = add_long(args[0], args[1]); break;
        case 0x61: args[0] = sub_long(args[0], args[1]); break;
        case 0x62:
          if (args[1] == 0)
            exc->error = ERR_DIV0;
          else
            args[0] = mul_div_no_round(args[0], 64L, args[1]);
          break;
        case 0x63: args[0] = mul_div(args[0], args[1], 64L); break;
        case 0x64:
          if (args[0] < 0) args[0] = neg_long(args[0]);
          break;
        case 0x65: args[0] = neg_long(args[0]); break;
        case 0x66: args[0] = pix_floor(args[0]); break;
        case 0x67: args[0] = pix_ceil(args[0]); break;
        case 0x68: case 0x69: case 0x6A: case 0x6B:
          args[0] = func_round(exc, args[0]);
          break;
        case 0x6C: case 0x6D: case 0x6E: case 0x6F:
          args[0] = round_none(args[0]);
          break;
        case 0x70: {
          ULong I = (ULong)args[0];
          if (!bounds((Long)I, exc->cvtSize)) {
            modify_cvt_check(exc);
            exc->cvt[I] = mul_fix(args[1], exc->tt_scale);
          }
          break;
        }
        case 0x73: case 0x74: case 0x75: ins_deltac(exc, args); break;
        case 0x76:
          set_super_round(exc, 0x4000, args[0]);
          GS.round_state = 6;
          break;
        case 0x77:
          set_super_round(exc, 0x2D41, args[0]);
          GS.round_state = 7;
          break;
        case 0x78:
          if (args[1] != 0) ins_jmpr(exc, args);
          break;
        case 0x79:
          if (args[1] == 0) ins_jmpr(exc, args);
          break;
        case 0x7A: GS.round_state = 5; break;
        case 0x7C: GS.round_state = 4; break;
        case 0x7D: GS.round_state = 3; break;
        case 0x7E: case 0x7F: break;
        case 0x80: {
          if (post_iup(exc)) {
            GS.loop = 1;
            exc->new_top = exc->args;
            break;
          }
          if (exc->top < GS.loop) {
            GS.loop = 1;
            exc->new_top = exc->args;
            break;
          }
          while (GS.loop > 0) {
            exc->args--;
            int point = (uint16_t)exc->stack[exc->args];
            if (!bounds(point, exc->pts.n_points)) exc->pts.tags[point] ^= TAG_ON;
            GS.loop--;
          }
          GS.loop = 1;
          exc->new_top = exc->args;
          break;
        }
        case 0x81: case 0x82: {
          if (post_iup(exc)) break;
          int K = (uint16_t)args[1], L = (uint16_t)args[0];
          if (bounds(K, exc->pts.n_points) || bounds(L, exc->pts.n_points)) break;
          for (int I = L; I <= K; I++) {
            if (opcode == 0x81)
              exc->pts.tags[I] |= TAG_ON;
            else
              exc->pts.tags[I] &= ~TAG_ON;
          }
          break;
        }
        case 0x85: {
          int A = (int)(args[0] & 0xFF);
          if (A == 0xFF) {
            GS.scan_control = true;
            break;
          } else if (A == 0) {
            GS.scan_control = false;
            break;
          }
          if ((args[0] & 0x100) != 0 && exc->ppem <= A) GS.scan_control = true;
          if ((args[0] & 0x800) != 0 && exc->ppem > A) GS.scan_control = false;
          break;
        }
        case 0x86: case 0x87: ins_sdpvtl(exc, args); break;
        case 0x88: ins_getinfo(exc, args); break;
        case 0x89: ins_idef(exc, args); break;
        case 0x8A: {
          Long A = args[2], B = args[1], C = args[0];
          args[2] = C;
          args[1] = A;
          args[0] = B;
          break;
        }
        case 0x8B: if (args[1] > args[0]) args[0] = args[1]; break;
        case 0x8C: if (args[1] < args[0]) args[0] = args[1]; break;
        case 0x8D:
          if (args[0] >= 0) GS.scan_type = (int)args[0] & 0xFFFF;
          break;
        case 0x8E: ins_instctrl(exc, args); break;
        case 0x92: args[0] = 17; break;
        default:
          if (opcode >= 0xB0 && opcode <= 0xB7) {
            int L = opcode - 0xB0 + 1;
            for (int K = 1; K <= L; K++) args[K - 1] = exc->code[exc->IP + K];
          } else if (opcode >= 0xB8 && opcode <= 0xBF) {
            int L = opcode - 0xB8 + 1;
            exc->IP++;
            for (int K = 0; K < L; K++) {
              args[K] = (int16_t)((exc->code[exc->IP] << 8) | exc->code[exc->IP + 1]);
              exc->IP += 2;
            }
            exc->step_ins = false;
          } else if (opcode >= 0xC0 && opcode <= 0xDF)
            ins_mdrp(exc, args);
          else if (opcode >= 0xE0)
            ins_mirp(exc, args);
          else
            ins_unknown(exc);
          break;
      }
    }
    if (exc->error) return exc->error;
    exc->top = exc->new_top;
    if (exc->step_ins) exc->IP += exc->length;
    if (++ins_counter > 1000000L) return ERR_TOO_LONG;
    if (exc->IP >= exc->codeSize) {
      if (exc->callTop > 0) return ERR_CODE_OVERFLOW;
      return ERR_OK;
    }
  } while (true);
}

// ------------------------------------------------------------ sizes
static void load_context(Exec* exc, Size* sz) {
  exc->face = sz->face;
  exc->size = sz;
  exc->GS = sz->GS;
  exc->cvt = sz->cvt.data();
  exc->cvtSize = (Long)sz->cvt.size();
  exc->storage = sz->storage.data();
  exc->storeSize = (Long)sz->storage.size();
  exc->twilight = sz->twilight.zone();
  exc->pts = Zone();
  exc->zp0 = exc->zp1 = exc->zp2 = Zone();
  exc->stackSize = sz->face->max_stack + 32;
  if ((Long)exc->stack.size() < exc->stackSize + 8) exc->stack.resize(exc->stackSize + 8);
  exc->tt_scale = sz->x_scale;
  exc->x_scale = sz->x_scale;
  exc->y_scale = sz->y_scale;
  exc->ppem = sz->ppem;
}

static int run_program(Exec* exc, int range, const std::vector<uint8_t>& prog) {
  for (int r = 1; r <= 3; r++) {
    if (r == range) {
      exc->range_code[r] = prog.empty() ? nullptr : prog.data();
      exc->range_size[r] = (Long)prog.size();
    }
  }
  if (prog.empty()) return ERR_OK;
  exc->callTop = 0;
  exc->top = 0;
  exc->iniRange = range;
  exc->error = 0;
  goto_range(exc, range, 0);
  exc->zp0 = exc->zp1 = exc->zp2 = exc->pts;
  return run_ins(exc);
}

static int run_prep(Size* sz) {
  Face* f = sz->face;
  Exec* exc = &sz->exec;
  for (size_t i = 0; i < sz->cvt.size(); i++)
    sz->cvt[i] = mul_fix((Long)f->cvt[i], sz->x_scale);
  load_context(exc, sz);
  exc->range_code[RANGE_GLYPH] = nullptr;
  exc->range_size[RANGE_GLYPH] = 0;
  int err = run_program(exc, RANGE_CVT, f->prep);
  exc->GS.dualVector = {0x4000, 0};
  exc->GS.projVector = {0x4000, 0};
  exc->GS.freeVector = {0x4000, 0};
  exc->GS.rp0 = exc->GS.rp1 = exc->GS.rp2 = 0;
  exc->GS.gep0 = exc->GS.gep1 = exc->GS.gep2 = 1;
  exc->GS.loop = 1;
  sz->GS = exc->GS;
  return err;
}

// ------------------------------------------------------------ glyphs
struct Outline {
  std::vector<Vec> pts;
  std::vector<uint8_t> tags;
  std::vector<int16_t> contours;  // end points, absolute
};

struct Loader {
  Size* sz;
  Face* face;
  bool hinted;
  Outline base;
  Vec pp1, pp2, pp3, pp4;
  int error = 0;
  // FT_OUTLINE_OVERLAP: OVERLAP_SIMPLE on the first point of any simple
  // glyph loaded, or OVERLAP_COMPOUND on the top glyph's first component
  bool overlap = false;
  int n_components = 0;
};

static inline int16_t rd16(const uint8_t* p) { return (int16_t)((p[0] << 8) | p[1]); }
static inline uint16_t ru16(const uint8_t* p) { return (uint16_t)((p[0] << 8) | p[1]); }

static void set_pp(Loader* ld, int gid, int xMin, int yMax) {
  Face* f = ld->face;
  int n_long = (int)f->adv.size();
  int adv = gid < n_long ? f->adv[gid] : f->adv[n_long - 1];
  int lsb = gid < (int)f->lsb.size() ? f->lsb[gid] : 0;
  int tsb = (int16_t)(f->v_asc - yMax);
  int ah = f->v_asc - f->v_desc;
  if (ah < 0) ah = -ah;
  ah = (uint16_t)ah;
  ld->pp1.x = xMin - lsb;
  ld->pp1.y = 0;
  ld->pp2.x = ld->pp1.x + adv;
  ld->pp2.y = 0;
  ld->pp3.x = 0;
  ld->pp3.y = tsb + yMax;
  ld->pp4.x = 0;
  ld->pp4.y = ld->pp3.y - ah;
}

static int hint_glyph(Loader* ld, ZoneStore& zs, const uint8_t* ins,
                      int n_ins, bool is_composite) {
  Size* sz = ld->sz;
  Exec* exc = &sz->exec;
  int n = (int)zs.cur.size();
  if (n_ins > 0) zs.org = zs.cur;
  load_context(exc, sz);
  exc->GS = sz->GS;
  if (is_composite) {
    exc->x_scale = 1 << 16;
    exc->y_scale = 1 << 16;
    zs.orus = zs.cur;
  }
  zs.cur[n - 4].x = pix_round(zs.cur[n - 4].x);
  zs.cur[n - 3].x = pix_round(zs.cur[n - 3].x);
  zs.cur[n - 2].y = pix_round(zs.cur[n - 2].y);
  zs.cur[n - 1].y = pix_round(zs.cur[n - 1].y);
  bool bc = !(exc->GS.instruct_control & 4);
  if (n_ins > 0) {
    sz->glyph_ins.assign(ins, ins + n_ins);
    exc->pts = zs.zone();
    exc->pts.n_points = n;
    exc->pts.first_point = 0;
    exc->is_composite = is_composite;
    exc->backward_compatibility = bc;
    exc->glyfCvt.clear();
    exc->glyfStorage.clear();
    exc->range_code[RANGE_GLYPH] = sz->glyph_ins.data();
    exc->range_size[RANGE_GLYPH] = n_ins;
    exc->GS.gep0 = exc->GS.gep1 = exc->GS.gep2 = 1;
    exc->GS.projVector = {0x4000, 0};
    exc->GS.freeVector = exc->GS.projVector;
    exc->GS.dualVector = exc->GS.projVector;
    exc->GS.round_state = 1;
    exc->GS.loop = 1;
    exc->top = 0;
    exc->callTop = 0;
    exc->iniRange = RANGE_GLYPH;
    exc->error = 0;
    goto_range(exc, RANGE_GLYPH, 0);
    exc->zp0 = exc->zp1 = exc->zp2 = exc->pts;
    run_ins(exc);  // errors keep the partial result, as FreeType does
    bc = exc->backward_compatibility;
  }
  if (!bc) {
    ld->pp1 = zs.cur[n - 4];
    ld->pp2 = zs.cur[n - 3];
    ld->pp3 = zs.cur[n - 2];
    ld->pp4 = zs.cur[n - 1];
  }
  return 0;
}

static int load_glyph(Loader* ld, int gid, int depth) {
  Face* f = ld->face;
  if (depth > 16) return ERR_INVALID_GLYPH;
  if (gid < 0 || gid >= f->n_glyphs) return ERR_INVALID_GLYPH;
  uint32_t off = f->loca[gid], end = f->loca[gid + 1];
  Long xs = ld->sz ? ld->sz->x_scale : 0x10000, ys = ld->sz ? ld->sz->y_scale : 0x10000;
  if (end <= off || end > f->glyf.size()) {
    // empty glyph: only phantom points
    set_pp(ld, gid, 0, 0);
    ld->pp1.x = mul_fix(ld->pp1.x, xs);
    ld->pp2.x = mul_fix(ld->pp2.x, xs);
    ld->pp3.y = mul_fix(ld->pp3.y, ys);
    ld->pp4.y = mul_fix(ld->pp4.y, ys);
    if (ld->hinted) {
      ld->pp1.x = pix_round(ld->pp1.x);
      ld->pp2.x = pix_round(ld->pp2.x);
      ld->pp3.y = pix_round(ld->pp3.y);
      ld->pp4.y = pix_round(ld->pp4.y);
    }
    return 0;
  }
  const uint8_t* p = f->glyf.data() + off;
  const uint8_t* limit = f->glyf.data() + end;
  if (limit - p < 10) return ERR_INVALID_GLYPH;
  int n_contours = rd16(p);
  int xMin = rd16(p + 2), yMax = rd16(p + 8);
  set_pp(ld, gid, xMin, yMax);
  p += 10;
  if (n_contours >= 0) {
    Outline& o = ld->base;
    int base_pts = (int)o.pts.size();
    if (limit - p < 2 * n_contours + 2) return ERR_INVALID_GLYPH;
    std::vector<int16_t> ends(n_contours);
    int prev = -1;
    for (int i = 0; i < n_contours; i++) {
      ends[i] = (int16_t)ru16(p);
      p += 2;
      if (ends[i] <= prev && i > 0) return ERR_INVALID_GLYPH;
      prev = ends[i];
    }
    int n_pts = n_contours > 0 ? ends[n_contours - 1] + 1 : 0;
    int n_ins = ru16(p);
    p += 2;
    if (limit - p < n_ins) return ERR_INVALID_GLYPH;
    const uint8_t* ins = p;
    p += n_ins;
    std::vector<uint8_t> flags(n_pts);
    for (int i = 0; i < n_pts;) {
      if (p >= limit) return ERR_INVALID_GLYPH;
      uint8_t fl = *p++;
      flags[i++] = fl;
      if (fl & 8) {
        if (p >= limit) return ERR_INVALID_GLYPH;
        int cnt = *p++;
        for (; cnt > 0 && i < n_pts; cnt--) flags[i++] = fl;
      }
    }
    if (n_pts > 0 && (flags[0] & 0x40)) ld->overlap = true;  // OVERLAP_SIMPLE
    std::vector<Vec> pts(n_pts + 4);
    Long x = 0;
    for (int i = 0; i < n_pts; i++) {
      uint8_t fl = flags[i];
      if (fl & 2) {
        if (p >= limit) return ERR_INVALID_GLYPH;
        int d = *p++;
        x += (fl & 16) ? d : -d;
      } else if (!(fl & 16)) {
        if (limit - p < 2) return ERR_INVALID_GLYPH;
        x += rd16(p);
        p += 2;
      }
      pts[i].x = x;
    }
    Long y = 0;
    for (int i = 0; i < n_pts; i++) {
      uint8_t fl = flags[i];
      if (fl & 4) {
        if (p >= limit) return ERR_INVALID_GLYPH;
        int d = *p++;
        y += (fl & 32) ? d : -d;
      } else if (!(fl & 32)) {
        if (limit - p < 2) return ERR_INVALID_GLYPH;
        y += rd16(p);
        p += 2;
      }
      pts[i].y = y;
    }
    pts[n_pts] = ld->pp1;
    pts[n_pts + 1] = ld->pp2;
    pts[n_pts + 2] = ld->pp3;
    pts[n_pts + 3] = ld->pp4;
    ZoneStore zs;
    if (ld->hinted) zs.orus = pts;
    for (auto& v : pts) {
      v.x = mul_fix(v.x, xs);
      v.y = mul_fix(v.y, ys);
    }
    ld->pp1 = pts[n_pts];
    ld->pp2 = pts[n_pts + 1];
    ld->pp3 = pts[n_pts + 2];
    ld->pp4 = pts[n_pts + 3];
    std::vector<uint8_t> tags(n_pts + 4, 0);
    for (int i = 0; i < n_pts; i++) tags[i] = flags[i] & TAG_ON;
    if (ld->hinted) {
      zs.cur = pts;
      zs.org = pts;
      zs.tags = tags;
      zs.contours = ends;
      hint_glyph(ld, zs, ins, n_ins, false);
      pts = zs.cur;
      tags = zs.tags;
    }
    for (int i = 0; i < n_pts; i++) {
      o.pts.push_back(pts[i]);
      o.tags.push_back(tags[i]);
    }
    for (int i = 0; i < n_contours; i++) o.contours.push_back((int16_t)(ends[i] + base_pts));
    return 0;
  }
  // composite glyph
  struct Sub {
    int flags, index;
    Long arg1, arg2;
    Long xx, xy, yx, yy;
  };
  std::vector<Sub> subs;
  int flags;
  do {
    if (limit - p < 4) return ERR_INVALID_GLYPH;
    Sub s;
    flags = ru16(p);
    s.flags = flags;
    s.index = ru16(p + 2);
    p += 4;
    if (flags & 1) {
      if (limit - p < 4) return ERR_INVALID_GLYPH;
      if (flags & 2) {
        s.arg1 = rd16(p);
        s.arg2 = rd16(p + 2);
      } else {
        s.arg1 = ru16(p);
        s.arg2 = ru16(p + 2);
      }
      p += 4;
    } else {
      if (limit - p < 2) return ERR_INVALID_GLYPH;
      if (flags & 2) {
        s.arg1 = (int8_t)p[0];
        s.arg2 = (int8_t)p[1];
      } else {
        s.arg1 = p[0];
        s.arg2 = p[1];
      }
      p += 2;
    }
    s.xx = s.yy = 0x10000;
    s.xy = s.yx = 0;
    if (flags & 8) {
      s.xx = (Long)rd16(p) * 4;
      s.yy = s.xx;
      p += 2;
    } else if (flags & 0x40) {
      s.xx = (Long)rd16(p) * 4;
      s.yy = (Long)rd16(p + 2) * 4;
      p += 4;
    } else if (flags & 0x80) {
      s.xx = (Long)rd16(p) * 4;
      s.yx = (Long)rd16(p + 2) * 4;
      s.xy = (Long)rd16(p + 4) * 4;
      s.yy = (Long)rd16(p + 6) * 4;
      p += 8;
    }
    // OVERLAP_COMPOUND counts on the first component of all the glyph
    // loader's subglyphs (gloader->base.subglyphs[0]): the top glyph's
    if (ld->n_components++ == 0 && (flags & 0x400)) ld->overlap = true;
    subs.push_back(s);
  } while (flags & 0x20);
  const uint8_t* ins_pos = p;
  bool have_ins = (subs.back().flags & 0x100) != 0;
  // composite phantom points, scaled
  ld->pp1.x = mul_fix(ld->pp1.x, xs);
  ld->pp2.x = mul_fix(ld->pp2.x, xs);
  ld->pp3.y = mul_fix(ld->pp3.y, ys);
  ld->pp4.y = mul_fix(ld->pp4.y, ys);
  Outline& o = ld->base;
  int start_point = (int)o.pts.size();
  int start_contour = (int)o.contours.size();
  for (auto& s : subs) {
    Vec pp[4] = {ld->pp1, ld->pp2, ld->pp3, ld->pp4};
    int num_base_points = (int)o.pts.size();
    int err = load_glyph(ld, s.index, depth + 1);
    if (err) return err;
    if (!(s.flags & 0x200)) {
      ld->pp1 = pp[0];
      ld->pp2 = pp[1];
      ld->pp3 = pp[2];
      ld->pp4 = pp[3];
    }
    int num_points = (int)o.pts.size();
    if (num_points == num_base_points) continue;
    bool have_scale = (s.flags & (8 | 0x40 | 0x80)) != 0;
    if (have_scale) {
      for (int i = num_base_points; i < num_points; i++) {
        Long x = o.pts[i].x, y = o.pts[i].y;
        o.pts[i].x = mul_fix(x, s.xx) + mul_fix(y, s.xy);
        o.pts[i].y = mul_fix(x, s.yx) + mul_fix(y, s.yy);
      }
    }
    Long x, y;
    if (!(s.flags & 2)) {
      Long k = s.arg1 + start_point, l = s.arg2 + num_base_points;
      if (k >= num_base_points || l >= num_points) return ERR_INVALID_GLYPH;
      x = sub_long(o.pts[k].x, o.pts[l].x);
      y = sub_long(o.pts[k].y, o.pts[l].y);
    } else {
      x = s.arg1;
      y = s.arg2;
      if (!x && !y) continue;
      if (have_scale && (s.flags & 0x800)) {
        // SCALED_COMPONENT_OFFSET (FreeType's default build scales only
        // then): the offset times the transform's column lengths
        x = mul_fix(x, vector_length(s.xx, s.xy));
        y = mul_fix(y, vector_length(s.yy, s.yx));
      }
      x = mul_fix(x, xs);
      y = mul_fix(y, ys);
      if ((s.flags & 4) && ld->hinted) y = pix_round(y);
    }
    if (x || y)
      for (int i = num_base_points; i < num_points; i++) {
        o.pts[i].x = add_long(o.pts[i].x, x);
        o.pts[i].y = add_long(o.pts[i].y, y);
      }
  }
  int num_points = (int)o.pts.size();
  if (ld->hinted && have_ins && num_points > start_point) {
    if (limit - ins_pos < 2) return ERR_INVALID_GLYPH;
    int n_ins = ru16(ins_pos);
    if (limit - ins_pos - 2 < n_ins) return ERR_INVALID_GLYPH;
    if (n_ins == 0) return 0;
    ZoneStore zs;
    int n = num_points - start_point;
    zs.cur.assign(o.pts.begin() + start_point, o.pts.end());
    zs.cur.push_back(ld->pp1);
    zs.cur.push_back(ld->pp2);
    zs.cur.push_back(ld->pp3);
    zs.cur.push_back(ld->pp4);
    zs.org = zs.cur;
    zs.orus = zs.cur;
    zs.tags.assign(o.tags.begin() + start_point, o.tags.end());
    for (auto& t : zs.tags) t &= ~(TOUCH_X | TOUCH_Y);
    zs.tags.resize(n + 4, 0);
    for (int c = start_contour; c < (int)o.contours.size(); c++)
      zs.contours.push_back((int16_t)(o.contours[c] - start_point));
    hint_glyph(ld, zs, ins_pos + 2, n_ins, true);
    for (int i = 0; i < n; i++) {
      o.pts[start_point + i] = zs.cur[i];
      o.tags[start_point + i] = zs.tags[i];
    }
  }
  return 0;
}

// ------------------------------------------------------------ rasterizer
namespace gray {

const int PIXEL_BITS = 8;
const Long ONE_PIXEL = 1L << PIXEL_BITS;
inline Long TRUNC(Long x) { return x >> PIXEL_BITS; }
inline Long FRACT(Long x) { return x & (ONE_PIXEL - 1); }
inline Long UPSCALE(Long x) { return x * (1L << (PIXEL_BITS - 6)); }

struct Cell { Long cover, area; };

struct Raster {
  int width, rows;
  std::vector<Cell> cells;  // rows x (width + 1); column 0 is x = -1
  Cell dump;
  Cell* cell;
  Long x, y;

  void set_cell(Long ex, Long ey) {
    if (ey < 0 || ey >= rows || ex >= width) {
      cell = &dump;
      return;
    }
    if (ex < -1) ex = -1;
    cell = &cells[(size_t)ey * (width + 1) + (size_t)(ex + 1)];
  }

  void render_line(Long to_x, Long to_y) {
    Long ex0, ex1, ey0, ey1, dx, dy, fx0, fy0, fx1, fy1, prod;
    ey0 = TRUNC(y);
    ey1 = TRUNC(to_y);
    if ((ey0 >= rows && ey1 >= rows) || (ey0 < 0 && ey1 < 0)) goto End;
    ex0 = TRUNC(x);
    ex1 = TRUNC(to_x);
    fx0 = FRACT(x);
    fy0 = FRACT(y);
    dx = to_x - x;
    dy = to_y - y;
    if (ex0 == ex1 && ey0 == ey1) {
    } else if (dy == 0) {
      set_cell(ex1, ey1);
      goto End;
    } else if (dx == 0) {
      if (dy > 0)
        do {
          fy1 = ONE_PIXEL;
          cell->cover += (fy1 - fy0);
          cell->area += (fy1 - fy0) * fx0 * 2;
          fy0 = 0;
          ey0++;
          set_cell(ex0, ey0);
        } while (ey0 != ey1);
      else
        do {
          fy1 = 0;
          cell->cover += (fy1 - fy0);
          cell->area += (fy1 - fy0) * fx0 * 2;
          fy0 = ONE_PIXEL;
          ey0--;
          set_cell(ex0, ey0);
        } while (ey0 != ey1);
    } else {
      // FT_UDIVPREP / FT_UDIV: divisions by reciprocal multiplication
      int64_t dxr = ex0 != ex1 ? (int64_t)0xFFFFFFFFUL / dx : 0;
      int64_t dyr = ey0 != ey1 ? (int64_t)0xFFFFFFFFUL / dy : 0;
#define UDIV(a, r) (Long)(((uint64_t)(a) * (uint64_t)(r)) >> 32)
      prod = dx * fy0 - dy * fx0;
      do {
        if (prod - dx * ONE_PIXEL > 0 && prod <= 0) {  // left
          fx1 = 0;
          fy1 = UDIV(-prod, -dxr);
          prod -= dy * ONE_PIXEL;
          cell->cover += (fy1 - fy0);
          cell->area += (fy1 - fy0) * (fx0 + fx1);
          fx0 = ONE_PIXEL;
          fy0 = fy1;
          ex0--;
        } else if (prod - dx * ONE_PIXEL + dy * ONE_PIXEL > 0 &&
                   prod - dx * ONE_PIXEL <= 0) {  // up
          prod -= dx * ONE_PIXEL;
          fx1 = UDIV(-prod, dyr);
          fy1 = ONE_PIXEL;
          cell->cover += (fy1 - fy0);
          cell->area += (fy1 - fy0) * (fx0 + fx1);
          fx0 = fx1;
          fy0 = 0;
          ey0++;
        } else if (prod + dy * ONE_PIXEL >= 0 &&
                   prod - dx * ONE_PIXEL + dy * ONE_PIXEL <= 0) {  // right
          prod += dy * ONE_PIXEL;
          fx1 = ONE_PIXEL;
          fy1 = UDIV(prod, dxr);
          cell->cover += (fy1 - fy0);
          cell->area += (fy1 - fy0) * (fx0 + fx1);
          fx0 = 0;
          fy0 = fy1;
          ex0++;
        } else {  // down
          fx1 = UDIV(prod, -dyr);
          fy1 = 0;
          prod += dx * ONE_PIXEL;
          cell->cover += (fy1 - fy0);
          cell->area += (fy1 - fy0) * (fx0 + fx1);
          fx0 = fx1;
          fy0 = ONE_PIXEL;
          ey0--;
        }
        set_cell(ex0, ey0);
      } while (ex0 != ex1 || ey0 != ey1);
#undef UDIV
    }
    fx1 = FRACT(to_x);
    fy1 = FRACT(to_y);
    cell->cover += (fy1 - fy0);
    cell->area += (fy1 - fy0) * (fx0 + fx1);
  End:
    x = to_x;
    y = to_y;
  }

  void render_conic(const Vec& control, const Vec& to) {
    Vec p0{x, y}, p1{UPSCALE(control.x), UPSCALE(control.y)},
        p2{UPSCALE(to.x), UPSCALE(to.y)};
    if ((TRUNC(p0.y) >= rows && TRUNC(p1.y) >= rows && TRUNC(p2.y) >= rows) ||
        (TRUNC(p0.y) < 0 && TRUNC(p1.y) < 0 && TRUNC(p2.y) < 0)) {
      x = p2.x;
      y = p2.y;
      return;
    }
    Long bx = p1.x - p0.x, by = p1.y - p0.y;
    Long ax = p2.x - p1.x - bx, ay = p2.y - p1.y - by;
    Long ddx = ax < 0 ? -ax : ax, ddy = ay < 0 ? -ay : ay;
    if (ddx < ddy) ddx = ddy;
    if (ddx <= ONE_PIXEL / 4) {
      render_line(p2.x, p2.y);
      return;
    }
    int shift = 0;
    do {
      ddx >>= 2;
      shift += 1;
    } while (ddx > ONE_PIXEL / 4);
    int64_t rx = (int64_t)((uint64_t)ax << (33 - 2 * shift));
    int64_t ry = (int64_t)((uint64_t)ay << (33 - 2 * shift));
    int64_t qx = (int64_t)((uint64_t)bx << (33 - shift)) + (int64_t)((uint64_t)ax << (32 - 2 * shift));
    int64_t qy = (int64_t)((uint64_t)by << (33 - shift)) + (int64_t)((uint64_t)ay << (32 - 2 * shift));
    int64_t px = (int64_t)((uint64_t)p0.x << 32);
    int64_t py = (int64_t)((uint64_t)p0.y << 32);
    for (unsigned count = 1U << shift; count > 0; count--) {
      px = (int64_t)((uint64_t)px + (uint64_t)qx);
      py = (int64_t)((uint64_t)py + (uint64_t)qy);
      qx = (int64_t)((uint64_t)qx + (uint64_t)rx);
      qy = (int64_t)((uint64_t)qy + (uint64_t)ry);
      render_line((Long)(int32_t)(px >> 32), (Long)(int32_t)(py >> 32));
    }
  }

  // gray_render_cubic: bisection until the control points lie within
  // half a pixel of the chord's trisection points
  void render_cubic(const Vec& control1, const Vec& control2, const Vec& to) {
    Vec bez_stack[16 * 3 + 1];
    Vec* arc = bez_stack;
    arc[0] = {UPSCALE(to.x), UPSCALE(to.y)};
    arc[1] = {UPSCALE(control2.x), UPSCALE(control2.y)};
    arc[2] = {UPSCALE(control1.x), UPSCALE(control1.y)};
    arc[3] = {x, y};
    if ((TRUNC(arc[0].y) >= rows && TRUNC(arc[1].y) >= rows && TRUNC(arc[2].y) >= rows &&
         TRUNC(arc[3].y) >= rows) ||
        (TRUNC(arc[0].y) < 0 && TRUNC(arc[1].y) < 0 && TRUNC(arc[2].y) < 0 &&
         TRUNC(arc[3].y) < 0)) {
      x = arc[0].x;
      y = arc[0].y;
      return;
    }
    for (;;) {
      if (std::labs(2 * arc[0].x - 3 * arc[1].x + arc[3].x) > ONE_PIXEL / 2 ||
          std::labs(2 * arc[0].y - 3 * arc[1].y + arc[3].y) > ONE_PIXEL / 2 ||
          std::labs(arc[0].x - 3 * arc[2].x + 2 * arc[3].x) > ONE_PIXEL / 2 ||
          std::labs(arc[0].y - 3 * arc[2].y + 2 * arc[3].y) > ONE_PIXEL / 2) {
        split_cubic(arc);
        arc += 3;
        continue;
      }
      render_line(arc[0].x, arc[0].y);
      if (arc == bez_stack) return;
      arc -= 3;
    }
  }

  static void split_cubic(Vec* base) {
    Long a, b, c;
    base[6].x = base[3].x;
    a = base[0].x + base[1].x;
    b = base[1].x + base[2].x;
    c = base[2].x + base[3].x;
    base[5].x = c >> 1;
    c += b;
    base[4].x = c >> 2;
    base[1].x = a >> 1;
    a += b;
    base[2].x = a >> 2;
    base[3].x = (a + c) >> 3;
    base[6].y = base[3].y;
    a = base[0].y + base[1].y;
    b = base[1].y + base[2].y;
    c = base[2].y + base[3].y;
    base[5].y = c >> 1;
    c += b;
    base[4].y = c >> 2;
    base[1].y = a >> 1;
    a += b;
    base[2].y = a >> 2;
    base[3].y = (a + c) >> 3;
  }

  void move_to(const Vec& to) {
    Long nx = UPSCALE(to.x), ny = UPSCALE(to.y);
    set_cell(TRUNC(nx), TRUNC(ny));
    x = nx;
    y = ny;
  }
};

// FT_Outline_Decompose with the gray raster's callbacks
static void decompose(Raster& r, const Vec* pts, const uint8_t* tags,
                      const int16_t* contours, int n_contours) {
  int first = 0;
  for (int n = 0; n < n_contours; n++) {
    int last = contours[n];
    const Vec* limit = pts + last;
    Vec v_start = pts[first], v_last = pts[last], v_control = v_start;
    const Vec* point = pts + first;
    const uint8_t* tp = tags + first;
    int tag = tp[0] & 3;
    if (tag == 0) {  // conic start
      if ((tags[last] & 3) == 1) {
        v_start = v_last;
        limit--;
      } else {
        v_start.x = (v_start.x + v_last.x) / 2;
        v_start.y = (v_start.y + v_last.y) / 2;
      }
      point--;
      tp--;
    }
    r.move_to(v_start);
    bool closed = false;
    while (point < limit) {
      point++;
      tp++;
      tag = tp[0] & 3;
      if (tag == 1) {
        Vec vec = *point;
        r.render_line(gray::UPSCALE(vec.x), gray::UPSCALE(vec.y));
        continue;
      }
      if (tag == 2) {  // cubic: two controls, then the end point
        Vec vec1 = point[0], vec2 = point[1];
        point += 2;
        tp += 2;
        if (point <= limit) {
          r.render_cubic(vec1, vec2, *point);
          continue;
        }
        r.render_cubic(vec1, vec2, v_start);
        closed = true;
        break;
      }
      v_control = *point;
    Do_Conic:
      if (point < limit) {
        point++;
        tp++;
        tag = tp[0] & 3;
        Vec vec = *point;
        if (tag == 1) {
          r.render_conic(v_control, vec);
          continue;
        }
        Vec v_middle{(v_control.x + vec.x) / 2, (v_control.y + vec.y) / 2};
        r.render_conic(v_control, v_middle);
        v_control = vec;
        goto Do_Conic;
      }
      r.render_conic(v_control, v_start);
      closed = true;
      break;
    }
    if (!closed) r.render_line(gray::UPSCALE(v_start.x), gray::UPSCALE(v_start.y));
    first = last + 1;
  }
}

}  // namespace gray

// ------------------------------------------------------------ CFF
// CFF outlines as FreeType 2.14's CFF module gives them with its
// default Adobe engine (psaux's `cf2' code): the Type 2 charstring
// interpreter, the hint map built from the active stems and the blue
// zones (no stem darkening: FreeType's default), the glyph path that
// applies a hint map per element and changes maps mid-contour, and
// psaux's outline assembly, which turns the 16.16 device-space path into a 26.6
// outline with cubic tags.
namespace cf2 {

typedef int32_t Fixed;
static inline Fixed add32(Fixed a, Fixed b) { return (Fixed)((uint32_t)a + (uint32_t)b); }
static inline Fixed sub32(Fixed a, Fixed b) { return (Fixed)((uint32_t)a - (uint32_t)b); }
static inline Fixed i2f(int32_t i) { return (Fixed)((uint32_t)i << 16); }
static inline Fixed fmul(Fixed a, Fixed b) { return (Fixed)mul_fix(a, b); }
static inline Fixed fdiv(Fixed a, Fixed b) { return (Fixed)div_fix(a, b); }
static inline Fixed fround(Fixed x) { return (Fixed)(((uint32_t)x + 0x8000u) & 0xFFFF0000u); }
static inline Fixed ffloor(Fixed x) { return (Fixed)((uint32_t)x & 0xFFFF0000u); }
static inline Fixed ffrac(Fixed x) { return x - ffloor(x); }
static inline Fixed fabs_(Fixed x) { return x < 0 ? -x : x; }

const Fixed MIN_COUNTER = 0x8000;     // cf2_doubleToFixed(0.5)
const Fixed ICF_TOP = 880 << 16, ICF_BOTTOM = -(120 << 16);
const int MAX_HINTS = 96, MAX_HINT_EDGES = 192, MAX_SUBR = 16, STACK = 48;
const int STORAGE = 32;

enum { GhostBottom = 1, GhostTop = 2, PairBottom = 4, PairTop = 8, Locked = 16,
       Synthetic = 32 };

enum Err { OK = 0, E_SYNTAX = 1, E_STACK = 2, E_GLYPH = 3, E_STREAM = 4 };

// one FD's Private DICT, as cf2 reads it
struct FDParams {
  int n_blue, n_other, n_family, n_family_other;
  int32_t blue[14], other[10], family[14], family_other[10];
  int32_t blue_scale, blue_shift, blue_fuzz, language_group;
  int32_t default_width, nominal_width, top_upm, sub_upm;
};

struct Face {
  std::vector<uint8_t> data;
  std::vector<int64_t> cs_off, gsubr_off;
  std::vector<uint8_t> fd_of_glyph;
  std::vector<std::vector<int64_t>> lsubr_off;
  std::vector<FDParams> fds;
  int32_t seac[256];
  std::vector<uint16_t> adv;
  int n_glyphs, upem;
};

struct Buf { const uint8_t *start, *end, *ptr; };

struct StemHint { bool used; Fixed min, max, minDS, maxDS; };

struct Hint { uint32_t flags; size_t index; Fixed csCoord, dsCoord, scale; };
static inline bool h_valid(const Hint* h) { return h->flags != 0; }
static inline bool h_pair(const Hint* h) { return (h->flags & (PairBottom | PairTop)) != 0; }
static inline bool h_pairtop(const Hint* h) { return (h->flags & PairTop) != 0; }
static inline bool h_top(const Hint* h) { return (h->flags & (PairTop | GhostTop)) != 0; }
static inline bool h_bottom(const Hint* h) { return (h->flags & (PairBottom | GhostBottom)) != 0; }
static inline bool h_locked(const Hint* h) { return (h->flags & Locked) != 0; }
static inline bool h_synth(const Hint* h) { return (h->flags & Synthetic) != 0; }

struct HintMask {
  bool isValid, isNew;
  size_t bitCount, byteCount;
  uint8_t mask[(MAX_HINTS + 7) / 8];
};

static bool mask_setcounts(HintMask* m, size_t bitCount, int* err) {
  if (bitCount > (size_t)MAX_HINTS) {
    if (!*err) *err = E_GLYPH;
    return false;
  }
  m->bitCount = bitCount;
  m->byteCount = (bitCount + 7) / 8;
  m->isValid = true;
  m->isNew = true;
  return bitCount != 0;
}

static void mask_setall(HintMask* m, size_t bitCount, int* err) {
  unsigned lastmask = (1u << ((-(int)bitCount) & 7)) - 1;
  if (!mask_setcounts(m, bitCount, err)) return;
  for (size_t i = 0; i < m->byteCount; i++) m->mask[i] = 0xFF;
  m->mask[m->byteCount - 1] &= (uint8_t)~lastmask;
}

struct HintMove { size_t j; Fixed moveUp; };

struct BlueZone { bool bottomZone; Fixed csBottomEdge, csTopEdge, csFlatEdge, dsFlatEdge; };

struct Blues {
  Fixed scale;
  unsigned count;
  bool suppressOvershoot, doEmBoxHints;
  Fixed blueScale, blueShift, blueFuzz, boost;
  Hint emBoxTopEdge, emBoxBottomEdge;
  BlueZone zone[12];
};

struct Font {
  bool hinted;
  Fixed a, d;   // innerTransform: a (x scale) and d (y scale); b = c = 0
  Blues blues;
  const FDParams* fd;
  Face* face;
  const std::vector<int64_t>* lsubrs;
  int err;
};

struct HintMap {
  Font* font;
  HintMap* initial;
  std::vector<HintMove>* moves;
  bool isValid, hinted;
  Fixed scale;
  unsigned count, lastIndex;
  Hint edge[MAX_HINT_EDGES];
};

static void hintmap_init(HintMap* m, Font* font, HintMap* initial,
                         std::vector<HintMove>* moves, Fixed scale) {
  memset((void*)m, 0, sizeof(*m));
  m->hinted = font->hinted;
  m->scale = scale;
  m->font = font;
  m->initial = initial;
  m->moves = moves;
}

// ---------------------------------------------------------- blues
static void blues_init(Blues* b, Font* font) {
  const FDParams* p = font->fd;
  Fixed maxZoneHeight = 0;
  memset((void*)b, 0, sizeof(*b));
  b->scale = font->d;
  b->blueScale = fdiv(p->blue_scale, i2f(1000));
  b->blueShift = i2f(p->blue_shift);
  b->blueFuzz = i2f(p->blue_fuzz);
  Fixed emBoxBottom = ICF_BOTTOM, emBoxTop = ICF_TOP;
  if (p->language_group == 1 &&
      (p->n_blue == 0 ||
       (p->n_blue == 4 && i2f(p->blue[0]) < emBoxBottom && i2f(p->blue[1]) < emBoxBottom &&
        i2f(p->blue[2]) > emBoxTop && i2f(p->blue[3]) > emBoxTop))) {
    b->emBoxBottomEdge.csCoord = emBoxBottom - 1;
    b->emBoxBottomEdge.dsCoord = fround(fmul(b->emBoxBottomEdge.csCoord, b->scale)) - MIN_COUNTER;
    b->emBoxBottomEdge.scale = b->scale;
    b->emBoxBottomEdge.flags = GhostBottom | Locked | Synthetic;
    b->emBoxTopEdge.csCoord = emBoxTop + 1;
    b->emBoxTopEdge.dsCoord = fround(fmul(b->emBoxTopEdge.csCoord, b->scale)) + MIN_COUNTER;
    b->emBoxTopEdge.scale = b->scale;
    b->emBoxTopEdge.flags = GhostTop | Locked | Synthetic;
    b->doEmBoxHints = true;
    return;
  }
  for (int i = 0; i < p->n_blue; i += 2) {
    BlueZone* z = &b->zone[b->count];
    z->csBottomEdge = i2f(p->blue[i]);
    z->csTopEdge = i2f(p->blue[i + 1]);
    Fixed zh = sub32(z->csTopEdge, z->csBottomEdge);
    if (zh < 0) continue;
    if (zh > maxZoneHeight) maxZoneHeight = zh;
    if (i == 0) {
      z->bottomZone = true;
      z->csFlatEdge = z->csTopEdge;
    } else {
      z->bottomZone = false;
      z->csFlatEdge = z->csBottomEdge;
    }
    b->count++;
  }
  for (int i = 0; i < p->n_other; i += 2) {
    BlueZone* z = &b->zone[b->count];
    z->csBottomEdge = i2f(p->other[i]);
    z->csTopEdge = i2f(p->other[i + 1]);
    Fixed zh = sub32(z->csTopEdge, z->csBottomEdge);
    if (zh < 0) continue;
    if (zh > maxZoneHeight) maxZoneHeight = zh;
    z->bottomZone = true;
    z->csFlatEdge = z->csTopEdge;
    b->count++;
  }
  Fixed csUnitsPerPixel = fdiv(i2f(1), b->scale);
  for (unsigned i = 0; i < b->count; i++) {
    Fixed flatEdge = b->zone[i].csFlatEdge;
    if (b->zone[i].bottomZone) {
      Fixed minDiff = 0x7FFFFFFF;
      for (int j = 0; j < p->n_family_other; j += 2) {
        Fixed ffe = i2f(p->family_other[j + 1]);
        Fixed diff = fabs_(sub32(flatEdge, ffe));
        if (diff < minDiff && diff < csUnitsPerPixel) {
          b->zone[i].csFlatEdge = ffe;
          minDiff = diff;
          if (diff == 0) break;
        }
      }
      if (p->n_family >= 2) {
        Fixed ffe = i2f(p->family[1]);
        Fixed diff = fabs_(sub32(flatEdge, ffe));
        if (diff < minDiff && diff < csUnitsPerPixel) b->zone[i].csFlatEdge = ffe;
      }
    } else {
      Fixed minDiff = 0x7FFFFFFF;
      for (int j = 2; j < p->n_family; j += 2) {
        Fixed ffe = i2f(p->family[j]);
        Fixed diff = fabs_(sub32(flatEdge, ffe));
        if (diff < minDiff && diff < csUnitsPerPixel) {
          b->zone[i].csFlatEdge = ffe;
          minDiff = diff;
          if (diff == 0) break;
        }
      }
    }
  }
  if (maxZoneHeight > 0) {
    if (b->blueScale > fdiv(i2f(1), maxZoneHeight)) b->blueScale = fdiv(i2f(1), maxZoneHeight);
  }
  if (b->scale < b->blueScale) {
    b->suppressOvershoot = true;
    b->boost = 39321 - (Fixed)mul_div(39321, b->scale, b->blueScale);
    if (b->boost > 0x7FFF) b->boost = 0x7FFF;
  }
  for (unsigned i = 0; i < b->count; i++) {
    if (b->zone[i].bottomZone)
      b->zone[i].dsFlatEdge = fround(fmul(b->zone[i].csFlatEdge, b->scale) - b->boost);
    else
      b->zone[i].dsFlatEdge = fround(fmul(b->zone[i].csFlatEdge, b->scale) + b->boost);
  }
}

static bool blues_capture(const Blues* b, Hint* bottom, Hint* top) {
  Fixed csFuzz = b->blueFuzz, dsNew, dsMove = 0;
  bool captured = false;
  for (unsigned i = 0; i < b->count; i++) {
    const BlueZone* z = &b->zone[i];
    if (z->bottomZone && h_bottom(bottom)) {
      if (sub32(z->csBottomEdge, csFuzz) <= bottom->csCoord &&
          bottom->csCoord <= add32(z->csTopEdge, csFuzz)) {
        if (b->suppressOvershoot)
          dsNew = z->dsFlatEdge;
        else if (sub32(z->csTopEdge, bottom->csCoord) >= b->blueShift)
          dsNew = std::min(fround(bottom->dsCoord), sub32(z->dsFlatEdge, i2f(1)));
        else
          dsNew = fround(bottom->dsCoord);
        dsMove = sub32(dsNew, bottom->dsCoord);
        captured = true;
        break;
      }
    }
    if (!z->bottomZone && h_top(top)) {
      if (sub32(z->csBottomEdge, csFuzz) <= top->csCoord &&
          top->csCoord <= add32(z->csTopEdge, csFuzz)) {
        if (b->suppressOvershoot)
          dsNew = z->dsFlatEdge;
        else if (sub32(top->csCoord, z->csBottomEdge) >= b->blueShift)
          dsNew = std::max(fround(top->dsCoord), add32(z->dsFlatEdge, i2f(1)));
        else
          dsNew = fround(top->dsCoord);
        dsMove = sub32(dsNew, top->dsCoord);
        captured = true;
        break;
      }
    }
  }
  if (captured) {
    if (h_valid(bottom)) {
      bottom->dsCoord = add32(bottom->dsCoord, dsMove);
      bottom->flags |= Locked;
    }
    if (h_valid(top)) {
      top->dsCoord = add32(top->dsCoord, dsMove);
      top->flags |= Locked;
    }
  }
  return captured;
}

// ---------------------------------------------------------- hints
// cf2_hint_init (darkenY is 0: top edges are not moved)
static void hint_init(Hint* hint, std::vector<StemHint>& stems, size_t idx,
                      Fixed hintOrigin, Fixed scale, bool bottom) {
  memset((void*)hint, 0, sizeof(*hint));
  const StemHint* sh = &stems[idx];
  Fixed width = sub32(sh->max, sh->min);
  if (width == i2f(-21)) {
    if (bottom) {
      hint->csCoord = sh->max;
      hint->flags = GhostBottom;
    } else
      hint->flags = 0;
  } else if (width == i2f(-20)) {
    if (bottom)
      hint->flags = 0;
    else {
      hint->csCoord = sh->min;
      hint->flags = GhostTop;
    }
  } else if (width < 0) {
    if (bottom) {
      hint->csCoord = sh->max;
      hint->flags = PairBottom;
    } else {
      hint->csCoord = sh->min;
      hint->flags = PairTop;
    }
  } else {
    if (bottom) {
      hint->csCoord = sh->min;
      hint->flags = PairBottom;
    } else {
      hint->csCoord = sh->max;
      hint->flags = PairTop;
    }
  }
  hint->csCoord = add32(hint->csCoord, hintOrigin);
  hint->scale = scale;
  hint->index = idx;
  if (hint->flags != 0 && sh->used) {
    hint->dsCoord = h_top(hint) ? sh->maxDS : sh->minDS;
    hint->flags |= Locked;
  } else
    hint->dsCoord = fmul(hint->csCoord, scale);
}

static Fixed hintmap_map(HintMap* m, Fixed cs) {
  if (m->count == 0 || !m->hinted) return fmul(cs, m->scale);
  unsigned i = m->lastIndex;
  while (i < m->count - 1 && cs >= m->edge[i + 1].csCoord) i++;
  while (i > 0 && cs < m->edge[i].csCoord) i--;
  m->lastIndex = i;
  if (i == 0 && cs < m->edge[0].csCoord)
    return add32(fmul(sub32(cs, m->edge[0].csCoord), m->scale), m->edge[0].dsCoord);
  return add32(fmul(sub32(cs, m->edge[i].csCoord), m->edge[i].scale), m->edge[i].dsCoord);
}

static void hintmap_adjust(HintMap* m) {
  m->moves->clear();
  for (size_t i = 0; i < m->count; i++) {
    bool isPair = h_pair(&m->edge[i]);
    size_t j = isPair ? i + 1 : i;
    if (!h_locked(&m->edge[i])) {
      Fixed fracDown = ffrac(m->edge[i].dsCoord);
      Fixed fracUp = ffrac(m->edge[j].dsCoord);
      Fixed downMoveDown = 0 - fracDown;
      Fixed upMoveDown = 0 - fracUp;
      Fixed downMoveUp = fracDown == 0 ? 0 : i2f(1) - fracDown;
      Fixed upMoveUp = fracUp == 0 ? 0 : i2f(1) - fracUp;
      Fixed moveUp = std::min(downMoveUp, upMoveUp);
      Fixed moveDown = std::max(downMoveDown, upMoveDown);
      Fixed downMinCounter = MIN_COUNTER, upMinCounter = MIN_COUNTER;
      bool saveEdge = false;
      Fixed move;
      if (j >= m->count - 1 ||
          m->edge[j + 1].dsCoord >= add32(m->edge[j].dsCoord, moveUp + upMinCounter)) {
        if (i == 0 ||
            m->edge[i - 1].dsCoord <= add32(m->edge[i].dsCoord, moveDown - downMinCounter))
          move = (-moveDown < moveUp) ? moveDown : moveUp;
        else
          move = moveUp;
      } else {
        if (i == 0 ||
            m->edge[i - 1].dsCoord <= add32(m->edge[i].dsCoord, moveDown - downMinCounter)) {
          move = moveDown;
          saveEdge = moveUp < -moveDown;
        } else {
          move = 0;
          saveEdge = true;
        }
      }
      if (saveEdge && j < m->count - 1 && !h_locked(&m->edge[j + 1]))
        m->moves->push_back(HintMove{j, moveUp - move});
      m->edge[i].dsCoord = add32(m->edge[i].dsCoord, move);
      if (isPair) m->edge[j].dsCoord = add32(m->edge[j].dsCoord, move);
    }
    if (i > 0) {
      if (m->edge[i].csCoord != m->edge[i - 1].csCoord)
        m->edge[i - 1].scale = fdiv(sub32(m->edge[i].dsCoord, m->edge[i - 1].dsCoord),
                                    sub32(m->edge[i].csCoord, m->edge[i - 1].csCoord));
    }
    if (isPair) {
      if (m->edge[j].csCoord != m->edge[j - 1].csCoord)
        m->edge[j - 1].scale = fdiv(sub32(m->edge[j].dsCoord, m->edge[j - 1].dsCoord),
                                    sub32(m->edge[j].csCoord, m->edge[j - 1].csCoord));
      i += 1;
    }
  }
  for (size_t i = m->moves->size(); i > 0; i--) {
    const HintMove& hm = (*m->moves)[i - 1];
    size_t j = hm.j;
    if (m->edge[j + 1].dsCoord >= add32(m->edge[j].dsCoord, hm.moveUp + MIN_COUNTER)) {
      m->edge[j].dsCoord = add32(m->edge[j].dsCoord, hm.moveUp);
      if (h_pair(&m->edge[j])) m->edge[j - 1].dsCoord = add32(m->edge[j - 1].dsCoord, hm.moveUp);
    }
  }
}

static void hintmap_insert(HintMap* m, Hint* bottom, Hint* top) {
  bool isPair = true;
  Hint* first = bottom;
  Hint* second = top;
  if (!h_valid(bottom)) {
    first = top;
    isPair = false;
  } else if (!h_valid(top)) {
    isPair = false;
  }
  if (isPair && top->csCoord < bottom->csCoord) return;
  unsigned ins = 0;
  for (; ins < m->count; ins++)
    if (m->edge[ins].csCoord >= first->csCoord) break;
  if (ins < m->count) {
    if (m->edge[ins].csCoord == first->csCoord) return;
    if (isPair && m->edge[ins].csCoord <= second->csCoord) return;
    if (h_pairtop(&m->edge[ins])) return;
  }
  if (m->initial->isValid && !h_locked(first)) {
    if (isPair) {
      Fixed midpoint = hintmap_map(m->initial, add32(second->csCoord, first->csCoord) / 2);
      Fixed halfWidth = fmul(sub32(second->csCoord, first->csCoord) / 2, m->scale);
      first->dsCoord = sub32(midpoint, halfWidth);
      second->dsCoord = add32(midpoint, halfWidth);
    } else
      first->dsCoord = hintmap_map(m->initial, first->csCoord);
  }
  if (ins > 0) {
    if (first->dsCoord < m->edge[ins - 1].dsCoord) return;
  }
  if (ins < m->count) {
    if (isPair) {
      if (second->dsCoord > m->edge[ins].dsCoord) return;
    } else {
      if (first->dsCoord > m->edge[ins].dsCoord) return;
    }
  }
  {
    int iSrc = (int)m->count - 1;
    int iDst = isPair ? (int)m->count + 1 : (int)m->count;
    unsigned count = m->count - ins;
    if (iDst >= MAX_HINT_EDGES) return;
    while (count--) m->edge[iDst--] = m->edge[iSrc--];
    m->edge[ins] = *first;
    m->count += 1;
    if (isPair) {
      m->edge[ins + 1] = *second;
      m->count += 1;
    }
  }
}

static void hintmap_build(HintMap* m, std::vector<StemHint>& hstems,
                          std::vector<StemHint>& vstems, HintMask* hintMask,
                          Fixed hintOrigin, bool initialMap) {
  Font* font = m->font;
  HintMask temp;
  if (!initialMap && !m->initial->isValid) {
    memset((void*)&temp, 0, sizeof(temp));
    hintmap_build(m->initial, hstems, vstems, &temp, hintOrigin, true);
  }
  if (!hintMask->isValid) {
    mask_setall(hintMask, hstems.size() + vstems.size(), &font->err);
    if (!hintMask->isValid) return;
  }
  m->count = 0;
  m->lastIndex = 0;
  temp = *hintMask;
  uint8_t* maskPtr = temp.mask;
  size_t bitCount = hstems.size();
  if (bitCount > hintMask->bitCount) return;
  if (font->blues.doEmBoxHints) {
    Hint dummy;
    memset((void*)&dummy, 0, sizeof(dummy));
    hintmap_insert(m, &font->blues.emBoxBottomEdge, &dummy);
    hintmap_insert(m, &dummy, &font->blues.emBoxTopEdge);
  }
  uint8_t maskByte = 0x80;
  for (size_t i = 0; i < bitCount; i++) {
    if (maskByte & *maskPtr) {
      Hint bottomE, topE;
      hint_init(&bottomE, hstems, i, hintOrigin, m->scale, true);
      hint_init(&topE, hstems, i, hintOrigin, m->scale, false);
      if (h_locked(&bottomE) || h_locked(&topE) || blues_capture(&font->blues, &bottomE, &topE)) {
        hintmap_insert(m, &bottomE, &topE);
        *maskPtr &= (uint8_t)~maskByte;
      }
    }
    if ((i & 7) == 7) {
      maskPtr++;
      maskByte = 0x80;
    } else
      maskByte >>= 1;
  }
  if (initialMap) {
    if (m->count == 0 || m->edge[0].csCoord > 0 || m->edge[m->count - 1].csCoord < 0) {
      Hint edge, invalid;
      memset((void*)&edge, 0, sizeof(edge));
      edge.flags = GhostBottom | Locked | Synthetic;
      edge.scale = m->scale;
      memset((void*)&invalid, 0, sizeof(invalid));
      hintmap_insert(m, &edge, &invalid);
    }
  } else {
    maskPtr = temp.mask;
    maskByte = 0x80;
    for (size_t i = 0; i < bitCount; i++) {
      if (maskByte & *maskPtr) {
        Hint bottomE, topE;
        hint_init(&bottomE, hstems, i, hintOrigin, m->scale, true);
        hint_init(&topE, hstems, i, hintOrigin, m->scale, false);
        hintmap_insert(m, &bottomE, &topE);
      }
      if ((i & 7) == 7) {
        maskPtr++;
        maskByte = 0x80;
      } else
        maskByte >>= 1;
    }
  }
  hintmap_adjust(m);
  if (!initialMap) {
    for (unsigned i = 0; i < m->count; i++) {
      if (!h_synth(&m->edge[i])) {
        StemHint* sh = &hstems[m->edge[i].index];
        if (h_top(&m->edge[i]))
          sh->maxDS = m->edge[i].dsCoord;
        else
          sh->minDS = m->edge[i].dsCoord;
        sh->used = true;
      }
    }
  }
  m->isValid = true;
  hintMask->isNew = false;
}

// ---------------------------------------------------------- outline assembly
// psaux's outline assembly as FreeType's cf2 callbacks drive it
struct PathOut {
  std::vector<Vec> pts;
  std::vector<uint8_t> tags;
  std::vector<int16_t> contours;
  bool path_begun = false;

  void add_point(Fixed x, Fixed y, bool on) {
    pts.push_back(Vec{(Long)(x >> 10), (Long)(y >> 10)});
    tags.push_back(on ? 1 : 2);
  }
  void add_contour() {
    if (!contours.empty()) contours.back() = (int16_t)(pts.size() - 1);
    contours.push_back(0);
  }
  void start_point(Fixed x, Fixed y) {
    if (!path_begun) {
      path_begun = true;
      add_contour();
      add_point(x, y, true);
    }
  }
  void close_contour() {
    int nc = (int)contours.size(), np = (int)pts.size();
    int first = nc <= 1 ? 0 : contours[nc - 2] + 1;
    if (nc && first == np) {
      contours.pop_back();
      return;
    }
    if (np > 1) {
      const Vec& p1 = pts[first];
      const Vec& p2 = pts[np - 1];
      if (p1.x == p2.x && p1.y == p2.y && tags[np - 1] == 1) {
        pts.pop_back();
        tags.pop_back();
        np--;
      }
    }
    if (nc > 0) {
      if (first == np - 1) {
        contours.pop_back();
        pts.pop_back();
        tags.pop_back();
      } else
        contours.back() = (int16_t)(np - 1);
    }
  }
};

struct Params { Vec pt0, pt1, pt2, pt3; };
struct FV { Fixed x, y; };

// ---------------------------------------------------------- glyph path
enum { OpLineTo = 1, OpCubeTo = 2 };

struct GlyphPath {
  Font* font;
  PathOut* out;
  HintMap initialHintMap, firstHintMap, hintMap;
  std::vector<HintMove> hintMoves;
  Fixed scaleX, scaleY;
  std::vector<StemHint>* hstems;
  std::vector<StemHint>* vstems;
  HintMask* hintMask;
  Fixed hintOriginY;
  bool moveIsPending, pathIsOpen, pathIsClosing, elemIsQueued;
  FV currentCS, start, currentDS, offsetStart0, offsetStart1;
  int prevElemOp;
  FV prevElemP0, prevElemP1, prevElemP2, prevElemP3;
};

static void gp_init(GlyphPath* g, Font* font, PathOut* out, Fixed scaleY,
                    std::vector<StemHint>* hs, std::vector<StemHint>* vs, HintMask* mask,
                    Fixed hintOriginY) {
  g->font = font;
  g->out = out;
  hintmap_init(&g->initialHintMap, font, &g->initialHintMap, &g->hintMoves, scaleY);
  hintmap_init(&g->firstHintMap, font, &g->initialHintMap, &g->hintMoves, scaleY);
  hintmap_init(&g->hintMap, font, &g->initialHintMap, &g->hintMoves, scaleY);
  g->scaleX = font->a;
  g->scaleY = font->d;
  g->hstems = hs;
  g->vstems = vs;
  g->hintMask = mask;
  g->hintOriginY = hintOriginY;
  g->moveIsPending = true;
  g->pathIsOpen = g->pathIsClosing = g->elemIsQueued = false;
  g->currentCS = g->start = g->currentDS = g->offsetStart0 = g->offsetStart1 = FV{0, 0};
  g->prevElemOp = 0;
}

static void gp_hintpoint(GlyphPath* g, HintMap* m, FV* ppt, Fixed x, Fixed y) {
  // outerTransform is the identity and the fractional translation zero
  ppt->x = fmul(g->scaleX, x);
  ppt->y = hintmap_map(m, y);
}

static void cb_move(GlyphPath* g) {
  g->out->close_contour();
  g->out->path_begun = false;
}

static void cb_line(GlyphPath* g, FV pt0, FV pt1) {
  if (!g->out->path_begun) g->out->start_point(pt0.x, pt0.y);
  g->out->add_point(pt1.x, pt1.y, true);
}

static void cb_cube(GlyphPath* g, FV pt0, FV p1, FV p2, FV p3) {
  if (!g->out->path_begun) g->out->start_point(pt0.x, pt0.y);
  g->out->add_point(p1.x, p1.y, false);
  g->out->add_point(p2.x, p2.y, false);
  g->out->add_point(p3.x, p3.y, true);
}

static void gp_moveto(GlyphPath* g, Fixed x, Fixed y);

static void gp_pushmove(GlyphPath* g, FV start) {
  if (!g->hintMap.isValid) gp_moveto(g, g->start.x, g->start.y);
  FV pt1;
  gp_hintpoint(g, &g->hintMap, &pt1, start.x, start.y);
  cb_move(g);
  g->currentDS = pt1;
  g->offsetStart0 = start;
}

static void gp_pushprev(GlyphPath* g, HintMap* m, FV* nextP0, FV nextP1, bool close) {
  (void)nextP1;
  FV pt1, pt2, pt3;
  // no darkening: elements always join, no intersection is computed
  FV pt0 = g->currentDS;
  if (g->prevElemOp == OpLineTo) {
    gp_hintpoint(g, close ? &g->firstHintMap : m, &pt1, g->prevElemP1.x, g->prevElemP1.y);
    if (pt0.x != pt1.x || pt0.y != pt1.y) {
      cb_line(g, pt0, pt1);
      g->currentDS = pt1;
    }
  } else {
    gp_hintpoint(g, m, &pt1, g->prevElemP1.x, g->prevElemP1.y);
    gp_hintpoint(g, m, &pt2, g->prevElemP2.x, g->prevElemP2.y);
    gp_hintpoint(g, m, &pt3, g->prevElemP3.x, g->prevElemP3.y);
    cb_cube(g, pt0, pt1, pt2, pt3);
    g->currentDS = pt3;
  }
  // the connecting line (useIntersection is false)
  gp_hintpoint(g, close ? &g->firstHintMap : m, &pt1, nextP0->x, nextP0->y);
  if (pt1.x != g->currentDS.x || pt1.y != g->currentDS.y) {
    cb_line(g, g->currentDS, pt1);
    g->currentDS = pt1;
  }
}

static void gp_lineto(GlyphPath* g, Fixed x, Fixed y);

static void gp_closeopen(GlyphPath* g) {
  if (g->pathIsOpen) {
    g->pathIsClosing = true;
    gp_lineto(g, g->start.x, g->start.y);
    if (g->elemIsQueued) gp_pushprev(g, &g->hintMap, &g->offsetStart0, g->offsetStart1, true);
    g->moveIsPending = true;
    g->pathIsOpen = false;
    g->pathIsClosing = false;
    g->elemIsQueued = false;
  }
}

static void gp_moveto(GlyphPath* g, Fixed x, Fixed y) {
  gp_closeopen(g);
  g->currentCS.x = g->start.x = x;
  g->currentCS.y = g->start.y = y;
  g->moveIsPending = true;
  if (!g->hintMap.isValid || g->hintMask->isNew)
    hintmap_build(&g->hintMap, *g->hstems, *g->vstems, g->hintMask, g->hintOriginY, false);
  g->firstHintMap = g->hintMap;
}

static void gp_lineto(GlyphPath* g, Fixed x, Fixed y) {
  bool newHintMap = g->hintMask->isNew && !g->pathIsClosing;
  if (g->currentCS.x == x && g->currentCS.y == y && !newHintMap) return;
  FV P0 = g->currentCS, P1{x, y};
  if (g->moveIsPending) {
    gp_pushmove(g, P0);
    g->moveIsPending = false;
    g->pathIsOpen = true;
    g->offsetStart1 = P1;
  }
  if (g->elemIsQueued) gp_pushprev(g, &g->hintMap, &P0, P1, false);
  g->elemIsQueued = true;
  g->prevElemOp = OpLineTo;
  g->prevElemP0 = P0;
  g->prevElemP1 = P1;
  if (newHintMap)
    hintmap_build(&g->hintMap, *g->hstems, *g->vstems, g->hintMask, g->hintOriginY, false);
  g->currentCS.x = x;
  g->currentCS.y = y;
}

static void gp_curveto(GlyphPath* g, Fixed x1, Fixed y1, Fixed x2, Fixed y2, Fixed x3,
                       Fixed y3) {
  FV P0 = g->currentCS, P1{x1, y1}, P2{x2, y2}, P3{x3, y3};
  if (g->moveIsPending) {
    gp_pushmove(g, P0);
    g->moveIsPending = false;
    g->pathIsOpen = true;
    g->offsetStart1 = P1;
  }
  if (g->elemIsQueued) gp_pushprev(g, &g->hintMap, &P0, P1, false);
  g->elemIsQueued = true;
  g->prevElemOp = OpCubeTo;
  g->prevElemP0 = P0;
  g->prevElemP1 = P1;
  g->prevElemP2 = P2;
  g->prevElemP3 = P3;
  if (g->hintMask->isNew)
    hintmap_build(&g->hintMap, *g->hstems, *g->vstems, g->hintMask, g->hintOriginY, false);
  g->currentCS.x = x3;
  g->currentCS.y = y3;
}

// ---------------------------------------------------------- operand stack
struct Num { bool is_int; int32_t v; };

struct Stack {
  Num buf[STACK];
  int top = 0;
  int* err;
  void push_int(int32_t v) {
    if (top < STACK) buf[top++] = Num{true, v};
    else if (!*err) *err = E_STACK;
  }
  void push_fixed(Fixed v) {
    if (top < STACK) buf[top++] = Num{false, v};
    else if (!*err) *err = E_STACK;
  }
  int32_t pop_int() {
    if (top == 0) {
      if (!*err) *err = E_STACK;
      return 0;
    }
    if (!buf[top - 1].is_int) {
      if (!*err) *err = E_SYNTAX;
      return 0;
    }
    return buf[--top].v;
  }
  Fixed pop_fixed() {
    if (top == 0) {
      if (!*err) *err = E_STACK;
      return 0;
    }
    --top;
    return buf[top].is_int ? i2f(buf[top].v) : buf[top].v;
  }
  Fixed get(int idx) {
    if (idx < 0 || idx >= top) {
      if (!*err) *err = E_STACK;
      return 0;
    }
    return buf[idx].is_int ? i2f(buf[idx].v) : buf[idx].v;
  }
  int count() const { return top; }
  void clear() { top = 0; }
  // cf2_stack_roll rotates the bottom `count' entries of the stack
  void roll(int count, int shift) {
    if (count < 2) return;
    if (count > top) {
      if (!*err) *err = E_STACK;
      return;
    }
    if (shift < 0)
      shift = -((-shift) % count);
    else
      shift %= count;
    if (shift == 0) return;
    Num last{true, 0};
    int start_idx = -1, idx = -1;
    for (int i = 0; i < count; i++) {
      if (start_idx == idx) {
        start_idx++;
        idx = start_idx;
        last = buf[idx];
      }
      idx += shift;
      if (idx >= count)
        idx -= count;
      else if (idx < 0)
        idx += count;
      Num tmp = buf[idx];
      buf[idx] = last;
      last = tmp;
    }
  }
};

static inline uint8_t rd(Buf* b, int* err) {
  if (b->ptr < b->end) return *b->ptr++;
  if (!*err) *err = E_STREAM;
  return 0;
}

static void mask_read(HintMask* m, Buf* cs, size_t bitCount, int* err) {
  if (!mask_setcounts(m, bitCount, err)) return;
  for (size_t i = 0; i < m->byteCount; i++) m->mask[i] = rd(cs, err);
}

static void do_stems(Font* font, Stack& st, std::vector<StemHint>& arr, Fixed* width,
                     bool* haveWidth) {
  int count = st.count();
  bool hasWidthArg = (count & 1) != 0;
  Fixed position = 0;
  if (hasWidthArg && !*haveWidth) *width = add32(st.get(0), i2f(font->fd->nominal_width));
  for (int i = hasWidthArg ? 1 : 0; i < count; i += 2) {
    StemHint sh;
    sh.min = position = add32(st.get(i), position);
    sh.max = position = add32(st.get(i + 1), position);
    sh.used = false;
    sh.maxDS = sh.minDS = 0;
    arr.push_back(sh);
  }
  st.clear();
  *haveWidth = true;
}

static void do_flex(Stack& st, Fixed* curX, Fixed* curY, GlyphPath* gp, const bool* rfs,
                    bool conditional) {
  Fixed vals[14];
  int idx = 0;
  vals[0] = *curX;
  vals[1] = *curY;
  bool isHFlex = !rfs[9];
  int top = isHFlex ? 9 : 10;
  for (int i = 0; i < top; i++) {
    vals[i + 2] = vals[i];
    if (rfs[i]) vals[i + 2] = add32(vals[i + 2], st.get(idx++));
  }
  if (isHFlex) vals[9 + 2] = *curY;
  if (conditional) {
    bool lastIsX = fabs_(sub32(vals[10], *curX)) > fabs_(sub32(vals[11], *curY));
    Fixed lastVal = st.get(idx);
    if (lastIsX) {
      vals[12] = add32(vals[10], lastVal);
      vals[13] = *curY;
    } else {
      vals[12] = *curX;
      vals[13] = add32(vals[11], lastVal);
    }
  } else {
    vals[12] = rfs[10] ? add32(vals[10], st.get(idx++)) : *curX;
    vals[13] = rfs[11] ? add32(vals[11], st.get(idx)) : *curY;
  }
  for (int j = 0; j < 2; j++)
    gp_curveto(gp, vals[j * 6 + 2], vals[j * 6 + 3], vals[j * 6 + 4], vals[j * 6 + 5],
               vals[j * 6 + 6], vals[j * 6 + 7]);
  st.clear();
  *curX = vals[12];
  *curY = vals[13];
}

static int bias(size_t n) { return n < 1240 ? 107 : n < 33900 ? 1131 : 32768; }

static bool subr_buf(const std::vector<int64_t>& off, const std::vector<uint8_t>& data,
                     int num, Buf* b) {
  size_t n = off.empty() ? 0 : off.size() - 1;
  int64_t idx = (int64_t)num + bias(n);
  if (idx < 0 || (size_t)idx >= n) return false;
  b->start = b->ptr = data.data() + off[idx];
  b->end = data.data() + off[idx + 1];
  return true;
}

static bool glyph_buf(Face* f, int gid, Buf* b) {
  if (gid < 0 || gid >= f->n_glyphs) return false;
  b->start = b->ptr = f->data.data() + f->cs_off[gid];
  b->end = f->data.data() + f->cs_off[gid + 1];
  return true;
}

// cf2_interpT2CharString
static void interp(Font* font, Buf* start_buf, PathOut* out, bool doingSeac, Fixed curX,
                   Fixed curY, Fixed* width) {
  Face* face = font->face;
  int* err = &font->err;
  Stack st;
  st.err = err;
  std::vector<StemHint> hstems, vstems;
  HintMask hintMask;
  memset((void*)&hintMask, 0, sizeof(hintMask));
  bool haveWidth = false;
  Fixed storage[STORAGE] = {0};
  Fixed hintOriginY = curY;
  Fixed nominalWidthX = i2f(font->fd->nominal_width);
  Buf subrStack[MAX_SUBR + 1];
  int csIndex = 0;
  subrStack[0] = *start_buf;
  Buf* cs = &subrStack[0];
  GlyphPath* gp = new GlyphPath();
  gp_init(gp, font, out, font->d, &hstems, &vstems, &hintMask, hintOriginY);
  *width = i2f(font->fd->default_width);
  for (;;) {
    if (*err) break;
    int op1;
    if (cs->ptr >= cs->end)
      op1 = csIndex ? 11 : 14;
    else
      op1 = *cs->ptr++;
    bool clear = true;
    switch (op1) {
      case 1:    // hstem
      case 18:   // hstemhm
        if (hintMask.isValid) break;
        do_stems(font, st, hstems, width, &haveWidth);
        break;
      case 3:    // vstem
      case 23:   // vstemhm
        if (hintMask.isValid) break;
        do_stems(font, st, vstems, width, &haveWidth);
        break;
      case 19:   // hintmask
      case 20: { // cntrmask
        if (st.count() > 1 && hintMask.isValid) break;
        do_stems(font, st, vstems, width, &haveWidth);
        if (op1 == 19) {
          mask_read(&hintMask, cs, hstems.size() + vstems.size(), err);
        } else {
          HintMask counterMask;
          memset((void*)&counterMask, 0, sizeof(counterMask));
          mask_read(&counterMask, cs, hstems.size() + vstems.size(), err);
          HintMap* counterMap = new HintMap();
          hintmap_init(counterMap, font, &gp->initialHintMap, &gp->hintMoves, font->d);
          hintmap_build(counterMap, hstems, vstems, &counterMask, 0, false);
          delete counterMap;
        }
        break;
      }
      case 21:   // rmoveto
        if (st.count() > 2 && !haveWidth) *width = add32(st.get(0), nominalWidthX);
        haveWidth = true;
        curY = add32(curY, st.pop_fixed());
        curX = add32(curX, st.pop_fixed());
        gp_moveto(gp, curX, curY);
        break;
      case 22:   // hmoveto
        if (st.count() > 1 && !haveWidth) *width = add32(st.get(0), nominalWidthX);
        haveWidth = true;
        curX = add32(curX, st.pop_fixed());
        gp_moveto(gp, curX, curY);
        break;
      case 4:    // vmoveto
        if (st.count() > 1 && !haveWidth) *width = add32(st.get(0), nominalWidthX);
        haveWidth = true;
        curY = add32(curY, st.pop_fixed());
        gp_moveto(gp, curX, curY);
        break;
      case 5: {  // rlineto
        int count = st.count();
        for (int idx = 0; idx < count; idx += 2) {
          curX = add32(curX, st.get(idx));
          curY = add32(curY, st.get(idx + 1));
          gp_lineto(gp, curX, curY);
        }
        st.clear();
        clear = false;
        break;
      }
      case 6:    // hlineto
      case 7: {  // vlineto
        int count = st.count();
        bool isX = op1 == 6;
        for (int idx = 0; idx < count; idx++) {
          Fixed v = st.get(idx);
          if (isX)
            curX = add32(curX, v);
          else
            curY = add32(curY, v);
          isX = !isX;
          gp_lineto(gp, curX, curY);
        }
        st.clear();
        clear = false;
        break;
      }
      case 24:   // rcurveline
      case 8: {  // rrcurveto
        int count = st.count(), idx = 0;
        while (idx + 6 <= count) {
          Fixed x1 = add32(st.get(idx + 0), curX);
          Fixed y1 = add32(st.get(idx + 1), curY);
          Fixed x2 = add32(st.get(idx + 2), x1);
          Fixed y2 = add32(st.get(idx + 3), y1);
          Fixed x3 = add32(st.get(idx + 4), x2);
          Fixed y3 = add32(st.get(idx + 5), y2);
          gp_curveto(gp, x1, y1, x2, y2, x3, y3);
          curX = x3;
          curY = y3;
          idx += 6;
        }
        if (op1 == 24) {
          curX = add32(curX, st.get(idx + 0));
          curY = add32(curY, st.get(idx + 1));
          gp_lineto(gp, curX, curY);
        }
        st.clear();
        clear = false;
        break;
      }
      case 25: { // rlinecurve
        int count = st.count(), idx = 0;
        while (idx + 6 < count) {
          curX = add32(curX, st.get(idx + 0));
          curY = add32(curY, st.get(idx + 1));
          gp_lineto(gp, curX, curY);
          idx += 2;
        }
        while (idx < count) {
          Fixed x1 = add32(st.get(idx + 0), curX);
          Fixed y1 = add32(st.get(idx + 1), curY);
          Fixed x2 = add32(st.get(idx + 2), x1);
          Fixed y2 = add32(st.get(idx + 3), y1);
          Fixed x3 = add32(st.get(idx + 4), x2);
          Fixed y3 = add32(st.get(idx + 5), y2);
          gp_curveto(gp, x1, y1, x2, y2, x3, y3);
          curX = x3;
          curY = y3;
          idx += 6;
        }
        st.clear();
        clear = false;
        break;
      }
      case 26:   // vvcurveto
      case 27: { // hhcurveto
        int count1 = st.count();
        int count = count1 & ~2, idx = count1 - count;
        while (idx < count) {
          Fixed x1, y1, x2, y2, x3, y3;
          if (op1 == 26) {
            if ((count - idx) & 1) {
              x1 = add32(st.get(idx), curX);
              idx++;
            } else
              x1 = curX;
            y1 = add32(st.get(idx + 0), curY);
            x2 = add32(st.get(idx + 1), x1);
            y2 = add32(st.get(idx + 2), y1);
            x3 = x2;
            y3 = add32(st.get(idx + 3), y2);
          } else {
            if ((count - idx) & 1) {
              y1 = add32(st.get(idx), curY);
              idx++;
            } else
              y1 = curY;
            x1 = add32(st.get(idx + 0), curX);
            x2 = add32(st.get(idx + 1), x1);
            y2 = add32(st.get(idx + 2), y1);
            x3 = add32(st.get(idx + 3), x2);
            y3 = y2;
          }
          gp_curveto(gp, x1, y1, x2, y2, x3, y3);
          curX = x3;
          curY = y3;
          idx += 4;
        }
        st.clear();
        clear = false;
        break;
      }
      case 30:   // vhcurveto
      case 31: { // hvcurveto
        int count1 = st.count();
        int count = count1 & ~2, idx = count1 - count;
        bool alternate = op1 == 31;
        while (idx < count) {
          Fixed x1, x2, x3, y1, y2, y3;
          if (alternate) {
            x1 = add32(st.get(idx + 0), curX);
            y1 = curY;
            x2 = add32(st.get(idx + 1), x1);
            y2 = add32(st.get(idx + 2), y1);
            y3 = add32(st.get(idx + 3), y2);
            if (count - idx == 5) {
              x3 = add32(st.get(idx + 4), x2);
              idx++;
            } else
              x3 = x2;
            alternate = false;
          } else {
            x1 = curX;
            y1 = add32(st.get(idx + 0), curY);
            x2 = add32(st.get(idx + 1), x1);
            y2 = add32(st.get(idx + 2), y1);
            x3 = add32(st.get(idx + 3), x2);
            if (count - idx == 5) {
              y3 = add32(st.get(idx + 4), y2);
              idx++;
            } else
              y3 = y2;
            alternate = true;
          }
          gp_curveto(gp, x1, y1, x2, y2, x3, y3);
          curX = x3;
          curY = y3;
          idx += 4;
        }
        st.clear();
        clear = false;
        break;
      }
      case 10:   // callsubr
      case 29: { // callgsubr
        if (csIndex > MAX_SUBR - 1) {
          if (!*err) *err = E_GLYPH;
          break;
        }
        int num = st.pop_int();
        Buf* next = &subrStack[csIndex + 1];
        bool ok = op1 == 29 ? subr_buf(face->gsubr_off, face->data, num, next)
                            : subr_buf(*font->lsubrs, face->data, num, next);
        if (!ok) {
          if (!*err) *err = E_GLYPH;
          break;
        }
        csIndex++;
        cs = next;
        clear = false;
        break;
      }
      case 11:   // return
        if (csIndex < 1) {
          if (!*err) *err = E_GLYPH;
          break;
        }
        cs = &subrStack[--csIndex];
        clear = false;
        break;
      case 14: { // endchar
        if (st.count() == 1 || st.count() == 5) {
          if (!haveWidth) *width = add32(st.get(0), nominalWidthX);
        }
        haveWidth = true;
        gp_closeopen(gp);
        if (st.count() > 1) {
          if (doingSeac) {
            if (!*err) *err = E_GLYPH;
            goto exit;
          }
          int achar = st.pop_int();
          int bchar = st.pop_int();
          Fixed sy = st.pop_fixed();
          Fixed sx = st.pop_fixed();
          Fixed dummy;
          Buf comp;
          int ga = achar >= 0 && achar < 256 ? face->seac[achar] : -1;
          if (ga < 0 || !glyph_buf(face, ga, &comp)) {
            if (!*err) *err = E_GLYPH;
            goto exit;
          }
          interp(font, &comp, out, true, sx, sy, &dummy);
          int gb = bchar >= 0 && bchar < 256 ? face->seac[bchar] : -1;
          if (gb < 0 || !glyph_buf(face, gb, &comp)) {
            if (!*err) *err = E_GLYPH;
            goto exit;
          }
          interp(font, &comp, out, true, 0, 0, &dummy);
        }
        goto exit;
      }
      case 28: {  // shortint
        uint8_t b1 = rd(cs, err), b2 = rd(cs, err);
        st.push_int((int16_t)((b1 << 8) | b2));
        clear = false;
        break;
      }
      case 12: {  // escape
        int op2 = rd(cs, err);
        clear = false;
        switch (op2) {
          case 34: {
            static const bool r[12] = {true, false, true, true, true, false,
                                       true, false, true, false, true, false};
            do_flex(st, &curX, &curY, gp, r, true);
            break;
          }
          case 35: {
            static const bool r[12] = {true, true, true, true, true, true,
                                       true, true, true, true, true, true};
            do_flex(st, &curX, &curY, gp, r, false);
            clear = true;
            break;
          }
          case 36: {
            static const bool r[12] = {true, true, true, true, true, false,
                                       true, false, true, true, true, false};
            do_flex(st, &curX, &curY, gp, r, true);
            break;
          }
          case 37: {
            static const bool r[12] = {true, true, true, true, true, true,
                                       true, true, true, true, false, false};
            do_flex(st, &curX, &curY, gp, r, true);
            break;
          }
          case 3: {  // and
            Fixed b = st.pop_fixed(), a = st.pop_fixed();
            st.push_int(a && b);
            break;
          }
          case 4: {  // or
            Fixed b = st.pop_fixed(), a = st.pop_fixed();
            st.push_int(a || b);
            break;
          }
          case 5: {  // not
            Fixed a = st.pop_fixed();
            st.push_int(!a);
            break;
          }
          case 9: {  // abs
            Fixed a = st.pop_fixed();
            st.push_fixed(a < -0x7FFFFFFF ? 0x7FFFFFFF : (a < 0 ? -a : a));
            break;
          }
          case 10: {  // add
            Fixed b = st.pop_fixed(), a = st.pop_fixed();
            st.push_fixed(add32(a, b));
            break;
          }
          case 11: {  // sub
            Fixed b = st.pop_fixed(), a = st.pop_fixed();
            st.push_fixed(sub32(a, b));
            break;
          }
          case 12: {  // div
            Fixed b = st.pop_fixed(), a = st.pop_fixed();
            st.push_fixed(fdiv(a, b));
            break;
          }
          case 14: {  // neg
            Fixed a = st.pop_fixed();
            st.push_fixed(a < -0x7FFFFFFF ? 0x7FFFFFFF : -a);
            break;
          }
          case 15: {  // eq
            Fixed b = st.pop_fixed(), a = st.pop_fixed();
            st.push_int(a == b);
            break;
          }
          case 18:  // drop
            (void)st.pop_fixed();
            break;
          case 20: {  // put
            int idx = st.pop_int();
            Fixed v = st.pop_fixed();
            if (idx >= 0 && idx < STORAGE) storage[idx] = v;
            break;
          }
          case 21: {  // get
            int idx = st.pop_int();
            if (idx >= 0 && idx < STORAGE) st.push_fixed(storage[idx]);
            break;
          }
          case 22: {  // ifelse
            Fixed c2 = st.pop_fixed(), c1 = st.pop_fixed();
            Fixed a2 = st.pop_fixed(), a1 = st.pop_fixed();
            st.push_fixed(c1 <= c2 ? a1 : a2);
            break;
          }
          case 24: {  // mul
            Fixed b = st.pop_fixed(), a = st.pop_fixed();
            st.push_fixed(fmul(a, b));
            break;
          }
          case 27: {  // dup
            Fixed a = st.pop_fixed();
            st.push_fixed(a);
            st.push_fixed(a);
            break;
          }
          case 28: {  // exch
            Fixed b = st.pop_fixed(), a = st.pop_fixed();
            st.push_fixed(b);
            st.push_fixed(a);
            break;
          }
          case 29: {  // index
            int idx = st.pop_int();
            int size = st.count();
            if (size > 0) {
              int gi = idx < 0 ? size - 1 : idx >= size ? 0 : size - 1 - idx;
              st.push_fixed(st.get(gi));
            }
            break;
          }
          case 30: {  // roll
            int idx = st.pop_int();
            int count = st.pop_int();
            st.roll(count, idx);
            break;
          }
          default:  // dotsection and the reserved / unsupported escapes
            clear = true;
            break;
        }
        break;
      }
      default:
        if (op1 >= 32 && op1 <= 246) {
          st.push_int(op1 - 139);
          clear = false;
        } else if (op1 >= 247 && op1 <= 250) {
          int v = (op1 - 247) * 256 + rd(cs, err) + 108;
          st.push_int(v);
          clear = false;
        } else if (op1 >= 251 && op1 <= 254) {
          int v = (op1 - 251) * 256 + rd(cs, err);
          st.push_int(-v - 108);
          clear = false;
        } else if (op1 == 255) {
          uint32_t v = (uint32_t)rd(cs, err) << 24;
          v |= (uint32_t)rd(cs, err) << 16;
          v |= (uint32_t)rd(cs, err) << 8;
          v |= (uint32_t)rd(cs, err);
          st.push_fixed((Fixed)v);
          clear = false;
        }
        // reserved operators clear the stack
        break;
    }
    if (clear) st.clear();
  }
exit:
  delete gp;
}

// cff_slot_load for one glyph: its outline (26.6) and advances
struct Size { Face* face; int ppem; Long x_scale, y_scale; };

static int load(Size* sz, int gid, bool hinted, PathOut* out, Long* adv, Long* linear) {
  Face* f = sz->face;
  Buf b;
  if (!glyph_buf(f, gid, &b)) return 6;  // Invalid_Argument
  int fdi = f->fd_of_glyph.empty() ? 0 : f->fd_of_glyph[gid];
  if (fdi >= (int)f->fds.size()) return 3;
  const FDParams* fd = &f->fds[fdi];
  Long x_scale = sz->x_scale, y_scale = sz->y_scale;
  if (fd->top_upm != fd->sub_upm) {
    x_scale = mul_div(x_scale, fd->top_upm, fd->sub_upm);
    y_scale = mul_div(y_scale, fd->top_upm, fd->sub_upm);
  }
  Font font;
  memset((void*)&font, 0, sizeof(font));
  font.face = f;
  font.fd = fd;
  font.lsubrs = &f->lsubr_off[fdi];
  font.hinted = hinted;
  if (hinted) {
    font.a = (Fixed)((int32_t)add_long(x_scale, 32) / 64);
    font.d = (Fixed)((int32_t)add_long(y_scale, 32) / 64);
  } else {
    font.a = font.d = 0x400;
  }
  blues_init(&font.blues, &font);
  Fixed width;
  interp(&font, &b, out, false, 0, 0, &width);
  if (font.err) return 20 + font.err;
  out->close_contour();
  if (!hinted)
    for (auto& p : out->pts) {
      p.x = mul_fix(p.x, x_scale);
      p.y = mul_fix(p.y, y_scale);
    }
  // the hmtx advance (cff_slot_load prefers it to the charstring width)
  Long a = f->adv.empty() ? (width + 0x8000) >> 16
                          : (Long)f->adv[gid < (int)f->adv.size() ? gid : f->adv.size() - 1];
  *linear = mul_div(a, sz->x_scale, 64);
  a = mul_fix(a, x_scale);
  *adv = hinted ? pix_round(a) : a;
  return 0;
}

}  // namespace cf2

// ------------------------------------------------------------ C API
extern "C" {

void* eg_face_new(const uint8_t* glyf, int64_t glyf_len, const uint32_t* loca,
                  int n_glyphs, const uint16_t* adv, int n_adv,
                  const int16_t* lsb, int n_lsb, int upem, int v_asc, int v_desc,
                  const int16_t* cvt, int n_cvt, const uint8_t* fpgm, int n_fpgm,
                  const uint8_t* prep, int n_prep, int max_stack,
                  int max_storage, int max_fdefs, int max_idefs,
                  int max_twilight) {
  Face* f = new Face();
  f->glyf.assign(glyf, glyf + glyf_len);
  f->loca.assign(loca, loca + n_glyphs + 1);
  f->n_glyphs = n_glyphs;
  f->adv.assign(adv, adv + n_adv);
  f->lsb.assign(lsb, lsb + n_lsb);
  f->upem = upem;
  f->v_asc = v_asc;
  f->v_desc = v_desc;
  f->cvt.assign(cvt, cvt + n_cvt);
  f->fpgm.assign(fpgm, fpgm + n_fpgm);
  f->prep.assign(prep, prep + n_prep);
  f->max_stack = max_stack;
  f->max_storage = max_storage;
  f->max_fdefs = max_fdefs;
  f->max_idefs = max_idefs;
  f->max_twilight = max_twilight;
  return f;
}

void eg_face_free(void* f) { delete (Face*)f; }

// A size at `ppem' pixels: scales, then `fpgm' and `prep' (twice) as
// FreeType runs them before the first hinted glyph load.  Returns the
// size; *err receives the first program error (0 if none).
void* eg_size_new(void* face, int ppem, int* err) {
  Face* f = (Face*)face;
  Size* sz = new Size();
  sz->face = f;
  sz->ppem = ppem;
  sz->x_scale = div_fix((Long)ppem << 6, f->upem);
  sz->y_scale = sz->x_scale;
  sz->cvt.assign(f->cvt.size(), 0);
  sz->storage.assign(f->max_storage, 0);
  int nt = f->max_twilight + 4;
  sz->twilight.org.assign(nt, {0, 0});
  sz->twilight.cur.assign(nt, {0, 0});
  sz->twilight.orus.assign(nt, {0, 0});
  sz->twilight.tags.assign(nt, 0);
  sz->fdefs.assign(f->max_fdefs, DefRec{0, 0, 0, 0, false});
  sz->idefs.assign(f->max_idefs, DefRec{0, 0, 0, 0, false});
  sz->GS = default_gs;
  Exec* exc = &sz->exec;
  exc->callStack.resize(32);
  // fpgm: no scale, no ppem
  for (size_t i = 0; i < sz->cvt.size(); i++)
    sz->cvt[i] = mul_fix((Long)f->cvt[i], sz->x_scale);
  load_context(exc, sz);
  exc->period = 64;
  exc->phase = 0;
  exc->threshold = 0;
  exc->F_dot_P = 0x4000;
  exc->ppem = 0;
  exc->tt_scale = 0;
  exc->x_scale = exc->y_scale = 0;
  exc->range_code[RANGE_CVT] = nullptr;
  exc->range_code[RANGE_GLYPH] = nullptr;
  int e = run_program(exc, RANGE_FONT, f->fpgm);
  if (!e) sz->GS = exc->GS;
  // prep: first with subpixel hinting off, then on
  if (!e) {
    for (auto& v : sz->twilight.org) v = {0, 0};
    for (auto& v : sz->twilight.cur) v = {0, 0};
    for (auto& s : sz->storage) s = 0;
    sz->GS = default_gs;
    exc->subpixel_hinting_lean = false;
    exc->grayscale_cleartype = false;
    exc->grayscale = false;
    e = run_prep(sz);
  }
  if (!e) {
    exc->subpixel_hinting_lean = true;
    exc->grayscale_cleartype = true;
    e = run_prep(sz);
  }
  sz->error = e;
  *err = e;
  return sz;
}

void eg_size_free(void* s) { delete (Size*)s; }

// The outline of glyph `gid' in 26.6: hinted (FT_LOAD_DEFAULT) or only
// scaled (FT_LOAD_NO_HINTING), translated by -pp1.x as TT_Load_Glyph
// does.  Returns 0, or an error code; *n_pts / *n_contours receive the
// sizes (callers retry with larger buffers when they exceed the caps).
int eg_load(void* size, int gid, int hinted, int64_t* xy, uint8_t* tags,
            int16_t* contours, int cap_pts, int cap_contours, int* n_pts,
            int* n_contours, int64_t* pp1x, int* overlap) {
  Size* sz = (Size*)size;
  Loader ld;
  ld.sz = sz;
  ld.face = sz->face;
  ld.hinted = hinted != 0;
  if (ld.hinted && sz->error) return sz->error + 100;
  bool hint = ld.hinted && !(sz->GS.instruct_control & 1);
  ld.hinted = hint;
  int err = load_glyph(&ld, gid, 0);
  if (err) return err;
  *n_pts = (int)ld.base.pts.size();
  *n_contours = (int)ld.base.contours.size();
  *pp1x = ld.pp1.x;
  *overlap = ld.overlap ? 1 : 0;
  if (*n_pts > cap_pts || *n_contours > cap_contours) return -1;
  for (int i = 0; i < *n_pts; i++) {
    xy[2 * i] = ld.base.pts[i].x - ld.pp1.x;
    xy[2 * i + 1] = ld.base.pts[i].y;
    tags[i] = ld.base.tags[i];
  }
  for (int i = 0; i < *n_contours; i++) contours[i] = ld.base.contours[i];
  return 0;
}

// Renders an outline (26.6, already shifted into [0, width*64) x [0,
// rows*64)) into a top-down gray bitmap of `rows' x `width'.  With
// `overlap' (FT_OUTLINE_OVERLAP) it is ft_smooth_raster_overlap: the
// outline scaled 4x in each direction is rasterized over a 4x clip box,
// and each subpixel's coverage, rounded to 1/16 ((c + 8) / 16), is added
// into its pixel, a sum of 256 kept at 255 (sum - (sum >> 8)).
void eg_render(const int64_t* xy, const uint8_t* tags, const int16_t* contours,
               int n_pts, int n_contours, int width, int rows, int overlap,
               uint8_t* out) {
  const int S = overlap ? 4 : 1;
  gray::Raster r;
  r.width = width * S;
  r.rows = rows * S;
  r.cells.assign((size_t)r.rows * (r.width + 1), {0, 0});
  r.dump = {0, 0};
  r.x = r.y = 0;
  r.cell = &r.dump;
  std::vector<Vec> pts(n_pts);
  for (int i = 0; i < n_pts; i++) pts[i] = {xy[2 * i] * S, xy[2 * i + 1] * S};
  gray::decompose(r, pts.data(), tags, contours, n_contours);
  if (overlap) memset(out, 0, (size_t)rows * width);
  for (int y = 0; y < r.rows; y++) {
    uint8_t* line = out + (size_t)(rows - 1 - y / S) * width;
    Long cover = 0;
    const gray::Cell* c = &r.cells[(size_t)y * (r.width + 1)];
    cover += c[0].cover * (gray::ONE_PIXEL * 2);
    for (int x = 0; x < r.width; x++) {
      cover += c[x + 1].cover * (gray::ONE_PIXEL * 2);
      Long area = cover - c[x + 1].area;
      int coverage = 0;
      if (area != 0) {
        coverage = (int)(area >> (gray::PIXEL_BITS * 2 + 1 - 8));
        if (coverage & INT32_MIN) coverage = ~coverage;
        if (coverage > 255) coverage = 255;
      }
      if (!overlap) {
        line[x] = (uint8_t)coverage;
      } else if (coverage) {
        unsigned sum = line[x / S] + (unsigned)(coverage + S * S / 2) / (S * S);
        line[x / S] = (uint8_t)(sum - (sum >> 8));
      }
    }
  }
}

// Pillow's ImagingGaussianBlur(passes=3) on an 8-bit image of
// `channels' interleaved bands (1 for L, 4 for RGB's RGBX storage).
static float gaussian_blur_radius(float radius, int passes) {
  float sigma2, L, l, a;
  sigma2 = radius * radius / passes;
  L = sqrt(12.0 * sigma2 + 1.0);
  l = floor((L - 1.0) / 2.0);
  a = (2 * l + 1) * (l * (l + 1) - 3 * sigma2);
  a /= 6 * (sigma2 - (l + 1) * (l + 1));
  return l + a;
}

static void line_box_blur(uint8_t* out, const uint8_t* in, int lastx, int radius,
                          int edgeA, int edgeB, uint32_t ww, uint32_t fw, int ch) {
  for (int c = 0; c < ch; c++) {
#define IN(i) ((uint32_t)in[(size_t)(i) * ch + c])
#define MOVE_ACC(acc, sub, add) acc += IN(add) - IN(sub);
#define ADD_FAR(bulk, acc, left, right) bulk = (acc * ww) + (IN(left) + IN(right)) * fw;
#define SAVE(x, bulk) out[(size_t)(x) * ch + c] = (uint8_t)((bulk + (1 << 23)) >> 24)
    uint32_t acc, bulk;
    int x;
    acc = IN(0) * (radius + 1);
    for (x = 0; x < edgeA - 1; x++) acc += IN(x);
    acc += IN(lastx) * (radius - edgeA + 1);
    if (edgeA <= edgeB) {
      for (x = 0; x < edgeA; x++) {
        MOVE_ACC(acc, 0, x + radius);
        ADD_FAR(bulk, acc, 0, x + radius + 1);
        SAVE(x, bulk);
      }
      for (x = edgeA; x < edgeB; x++) {
        MOVE_ACC(acc, x - radius - 1, x + radius);
        ADD_FAR(bulk, acc, x - radius - 1, x + radius + 1);
        SAVE(x, bulk);
      }
      for (x = edgeB; x <= lastx; x++) {
        MOVE_ACC(acc, x - radius - 1, lastx);
        ADD_FAR(bulk, acc, x - radius - 1, lastx);
        SAVE(x, bulk);
      }
    } else {
      for (x = 0; x < edgeB; x++) {
        MOVE_ACC(acc, 0, x + radius);
        ADD_FAR(bulk, acc, 0, lastx);
        SAVE(x, bulk);
      }
      for (x = edgeB; x < edgeA; x++) {
        MOVE_ACC(acc, 0, lastx);
        ADD_FAR(bulk, acc, 0, lastx);
        SAVE(x, bulk);
      }
      for (x = edgeA; x <= lastx; x++) {
        MOVE_ACC(acc, x - radius - 1, lastx);
        ADD_FAR(bulk, acc, x - radius - 1, lastx);
        SAVE(x, bulk);
      }
    }
#undef IN
#undef MOVE_ACC
#undef ADD_FAR
#undef SAVE
  }
}

static void horizontal_box_blur(uint8_t* img, int xsize, int ysize, int ch,
                                float floatRadius) {
  int radius = (int)floatRadius;
  uint32_t ww = (uint32_t)((float)(1 << 24) / (floatRadius * 2 + 1));
  uint32_t fw = ((1 << 24) - (radius * 2 + 1) * ww) / 2;
  int edgeA = radius + 1 < xsize ? radius + 1 : xsize;
  int edgeB = xsize - radius - 1 > 0 ? xsize - radius - 1 : 0;
  std::vector<uint8_t> line((size_t)xsize * ch);
  for (int y = 0; y < ysize; y++) {
    uint8_t* row = img + (size_t)y * xsize * ch;
    line_box_blur(line.data(), row, xsize - 1, radius, edgeA, edgeB, ww, fw, ch);
    memcpy(row, line.data(), line.size());
  }
}

void eg_gaussian_blur(uint8_t* img, int xsize, int ysize, int ch, float radius) {
  const int passes = 3;
  float r = gaussian_blur_radius(radius, passes);
  if (r != 0) {
    for (int i = 0; i < passes; i++) horizontal_box_blur(img, xsize, ysize, ch, r);
    std::vector<uint8_t> t((size_t)xsize * ysize * ch);
    for (int y = 0; y < ysize; y++)
      for (int x = 0; x < xsize; x++)
        memcpy(&t[((size_t)x * ysize + y) * ch], &img[((size_t)y * xsize + x) * ch], ch);
    for (int i = 0; i < passes; i++) horizontal_box_blur(t.data(), ysize, xsize, ch, r);
    for (int y = 0; y < ysize; y++)
      for (int x = 0; x < xsize; x++)
        memcpy(&img[((size_t)y * xsize + x) * ch], &t[((size_t)x * ysize + y) * ch], ch);
  }
}

// A CFF face: the table's bytes, the CharStrings / Global Subrs / each
// FD's local Subrs offsets (absolute, count + 1 each; an FD without
// Subrs has none), the FD of each glyph (NULL: one FD), each FD's
// Private values (CFF_FD_PARAMS int32 each, laid out as
// fonts/cff.py's fd_params), the glyph of each StandardEncoding code for
// seac (-1: none) and the hmtx advances.
enum { CFF_FD_PARAMS = 64 };

void* eg_cff_face_new(const uint8_t* data, int64_t len, int n_glyphs, const int64_t* cs_off,
                      int n_gsubrs, const int64_t* gsubr_off, const uint8_t* fd_of_glyph,
                      int n_fds, const int64_t* lsubr_off, const int32_t* lsubr_n,
                      const int32_t* fd_params, const int32_t* seac, const uint16_t* adv,
                      int n_adv, int upem) {
  cf2::Face* f = new cf2::Face();
  f->data.assign(data, data + len);
  f->n_glyphs = n_glyphs;
  f->cs_off.assign(cs_off, cs_off + n_glyphs + 1);
  if (n_gsubrs > 0) f->gsubr_off.assign(gsubr_off, gsubr_off + n_gsubrs + 1);
  if (fd_of_glyph) f->fd_of_glyph.assign(fd_of_glyph, fd_of_glyph + n_glyphs);
  const int64_t* lo = lsubr_off;
  for (int i = 0; i < n_fds; i++) {
    f->lsubr_off.emplace_back(lo, lo + lsubr_n[i]);
    lo += lsubr_n[i];
    const int32_t* q = fd_params + (size_t)i * CFF_FD_PARAMS;
    cf2::FDParams p;
    memset((void*)&p, 0, sizeof(p));
    p.n_blue = q[0];
    for (int k = 0; k < 14; k++) p.blue[k] = q[1 + k];
    p.n_other = q[15];
    for (int k = 0; k < 10; k++) p.other[k] = q[16 + k];
    p.n_family = q[26];
    for (int k = 0; k < 14; k++) p.family[k] = q[27 + k];
    p.n_family_other = q[41];
    for (int k = 0; k < 10; k++) p.family_other[k] = q[42 + k];
    p.blue_scale = q[52];
    p.blue_shift = q[53];
    p.blue_fuzz = q[54];
    p.language_group = q[55];
    p.default_width = q[56];
    p.nominal_width = q[57];
    p.top_upm = q[58];
    p.sub_upm = q[59];
    f->fds.push_back(p);
  }
  memcpy(f->seac, seac, sizeof(f->seac));
  f->adv.assign(adv, adv + n_adv);
  f->upem = upem;
  return f;
}

void eg_cff_face_free(void* f) { delete (cf2::Face*)f; }

void* eg_cff_size_new(void* face, int ppem) {
  cf2::Size* sz = new cf2::Size();
  sz->face = (cf2::Face*)face;
  sz->ppem = ppem;
  sz->x_scale = sz->y_scale = div_fix((Long)ppem << 6, sz->face->upem);
  return sz;
}

void eg_cff_size_free(void* s) { delete (cf2::Size*)s; }

// The outline of glyph `gid' in 26.6 (FT_LOAD_DEFAULT when `hinted',
// else FT_LOAD_NO_HINTING) and adv[0] = advance.x (26.6, rounded when
// hinted), adv[1] = linearHoriAdvance (16.16).  Returns 0, -1 when the
// buffers are too small (the sizes are in *n_pts / *n_contours), or an
// error code.
int eg_cff_load(void* size, int gid, int hinted, int64_t* xy, uint8_t* tags,
                int16_t* contours, int cap_pts, int cap_contours, int* n_pts,
                int* n_contours, int64_t* adv) {
  cf2::PathOut out;
  Long a = 0, lin = 0;
  int err = cf2::load((cf2::Size*)size, gid, hinted != 0, &out, &a, &lin);
  if (err) return err;
  *n_pts = (int)out.pts.size();
  *n_contours = (int)out.contours.size();
  adv[0] = a;
  adv[1] = lin;
  if (*n_pts > cap_pts || *n_contours > cap_contours) return -1;
  for (int i = 0; i < *n_pts; i++) {
    xy[2 * i] = out.pts[i].x;
    xy[2 * i + 1] = out.pts[i].y;
    tags[i] = out.tags[i];
  }
  for (int i = 0; i < *n_contours; i++) contours[i] = out.contours[i];
  return 0;
}

}  // extern "C"
