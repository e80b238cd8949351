"""The ``CFF `` table of an OpenType font (FreeType's cffload / cffparse):
what native/glyph.cpp needs to run Type 2 charstrings through FreeType's
Adobe hinting engine.

Read: the header and the Name, Top DICT, String and Global Subr INDEXes
(offSize 1-4); the Top DICT's ``FontMatrix``, ``CharStrings``,
``Private``, ``charset`` (formats 0 / 1 / 2 and the ISOAdobe charset),
``ROS`` / ``CIDCount`` / ``FDArray`` / ``FDSelect`` (formats 0 and 3); each
Private DICT's blue zones, ``BlueScale`` / ``BlueShift`` / ``BlueFuzz``,
stem widths, ``ForceBold``, ``LanguageGroup``, ``ExpansionFactor``,
``Subrs`` and the widths.  DICT numbers become what FreeType stores:
integers, and reals (operand 30) through a copy of ``cff_parse_real``'s
integer arithmetic, never through a Python float.

A 65,535-glyph CID font stays cheap to open: the INDEX offsets are read
as numpy arrays and FDSelect is expanded with ``np.repeat``; no glyph is
decoded here.

Refused with ``NotImplementedError`` (ROADMAP.md, queue 1): a FontMatrix
that is not a uniform scale once FreeType has normalised it (oblique or
offset fonts), Type 1 charstrings in CFF (CharstringType 1), and the
Expert charsets.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from effocr_torch.fonts.shaping import _mul_div

POWER_TENS = [1, 10, 100, 1000, 10000, 100000, 1000000, 10000000,
              100000000, 1000000000]
POWER_TEN_LIMITS = [0x7FFFFFFF // p for p in POWER_TENS]

# cff_standard_encoding: StandardEncoding's code -> SID (seac's bchar and
# achar are codes of this encoding)
STANDARD_ENCODING = (
    [0] * 32 + list(range(1, 96)) + [0] * 34 + list(range(96, 111)) + [0]
    + [111, 112, 113, 114, 0, 115, 116, 117, 118, 119, 120, 121, 122, 0,
       123, 0, 124, 125, 126, 127, 128, 129, 130, 131, 0, 132, 133, 0, 134,
       135, 136, 137] + [0] * 16
    + [138, 0, 139, 0, 0, 0, 0, 140, 141, 142, 143, 0, 0, 0, 0, 0, 144, 0,
       0, 0, 145, 0, 0, 146, 147, 148, 149, 0, 0, 0, 0])
assert len(STANDARD_ENCODING) == 256

# FreeType's defaults for a Private DICT (cff_load_private_dict)
DEFAULT_BLUE_SCALE = 2596864  # (FT_Fixed)(0.039625 * 0x10000 * 1000)
DEFAULT_EXPANSION = 3932      # (FT_Fixed)(0.06 * 0x10000)


class CFFError(OSError):
    pass


def div_fix(a: int, b: int) -> int:
    """FT_DivFix: (a << 16) / b rounded half away from zero."""
    s = -1 if (a < 0) ^ (b < 0) else 1
    a, b = abs(a), abs(b)
    return s * (((a << 16) + (b >> 1)) // b) if b else 0x7FFFFFFF


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


# ------------------------------------------------------------ numbers
def parse_integer(d: bytes) -> int:
    v = d[0]
    if v == 28:
        return struct.unpack(">h", d[1:3])[0]
    if v == 29:
        # (FT_Long)(FT_ULong) of four bytes: not sign-extended on LP64
        return struct.unpack(">I", d[1:5])[0]
    if v < 247:
        return v - 139
    if v < 251:
        return (v - 247) * 256 + d[1] + 108
    return -(v - 251) * 256 - d[1] - 108


def parse_real(d: bytes, power_ten: int, want_scaling: bool
               ) -> Tuple[int, int]:
    """cff_parse_real: the BCD real at d[0] == 30 as 16.16 (times
    10^power_ten), and with ``want_scaling`` its dynamic scaling."""
    p = 0
    phase = 4
    sign = exponent_sign = have_overflow = 0
    number = exponent = exponent_add = 0
    integer_length = fraction_length = 0
    scaling = 0
    nib = 0
    limit = len(d)

    def nibble():
        nonlocal p, phase
        if phase:
            p += 1
            if p >= limit:
                raise EOFError
        n = (d[p] >> phase) & 0xF
        phase = 4 - phase
        return n

    try:
        while True:
            nib = nibble()
            if nib == 0xE:
                sign = 1
            elif nib > 9:
                break
            elif number >= 0xCCCCCCC:
                exponent_add += 1
            elif nib or number:
                integer_length += 1
                number = number * 10 + nib
        if nib == 0xA:
            while True:
                nib = nibble()
                if nib >= 10:
                    break
                if not nib and not number:
                    exponent_add -= 1
                elif number < 0xCCCCCCC and fraction_length < 9:
                    fraction_length += 1
                    number = number * 10 + nib
        if nib == 12:
            exponent_sign = 1
            nib = 11
        if nib == 11:
            while True:
                nib = nibble()
                if nib >= 10:
                    break
                if exponent > 1000:
                    have_overflow = 1
                else:
                    exponent = exponent * 10 + nib
            if exponent_sign:
                exponent = -exponent
    except EOFError:
        return 0, 0
    result = 0
    if not number:
        return 0, 0
    if have_overflow:
        return (0 if exponent_sign else
                (-0x7FFFFFFF if sign else 0x7FFFFFFF)), 0
    exponent += power_ten + exponent_add
    if want_scaling:
        fraction_length += integer_length
        exponent += integer_length
        if fraction_length <= 5:
            if number > 0x7FFF:
                result = div_fix(number, 10)
                scaling = exponent - fraction_length + 1
            else:
                if exponent > 0:
                    new_fraction_length = min(exponent, 5)
                    shift = new_fraction_length - fraction_length
                    if shift > 0:
                        exponent -= new_fraction_length
                        number *= POWER_TENS[shift]
                        if number > 0x7FFF:
                            number //= 10
                            exponent += 1
                    else:
                        exponent -= fraction_length
                else:
                    exponent -= fraction_length
                result = number << 16
                scaling = exponent
        elif number // POWER_TENS[fraction_length - 5] > 0x7FFF:
            result = div_fix(number, POWER_TENS[fraction_length - 4])
            scaling = exponent - 4
        else:
            result = div_fix(number, POWER_TENS[fraction_length - 5])
            scaling = exponent - 5
    else:
        integer_length += exponent
        fraction_length -= exponent
        if integer_length > 5:
            return (-0x7FFFFFFF if sign else 0x7FFFFFFF), 0
        if integer_length < -5:
            return 0, 0
        if integer_length < 0:
            number //= POWER_TENS[-integer_length]
            fraction_length += integer_length
        if fraction_length == 10:
            number //= 10
            fraction_length -= 1
        if fraction_length > 0:
            if number // POWER_TENS[fraction_length] > 0x7FFF:
                return (-0x7FFFFFFF if sign else 0x7FFFFFFF), 0
            result = div_fix(number, POWER_TENS[fraction_length])
        else:
            number *= POWER_TENS[-fraction_length]
            if number > 0x7FFF:
                return (-0x7FFFFFFF if sign else 0x7FFFFFFF), 0
            result = number << 16
    return (-result if sign else result), scaling


def parse_num(d: bytes) -> int:
    """cff_parse_num: integers; a real is truncated (>> 16)."""
    if d[0] == 30:
        return parse_real(d, 0, False)[0] >> 16
    return parse_integer(d)


def parse_fixed(d: bytes, scaling: int = 0) -> int:
    """do_fixed: 16.16 (times 10^scaling), with FreeType's overflow
    saturation for integers."""
    if d[0] == 30:
        return parse_real(d, scaling, False)[0]
    val = parse_integer(d)
    if scaling:
        if abs(val) > POWER_TEN_LIMITS[scaling]:
            return 0x7FFFFFFF if val > 0 else -0x7FFFFFFF
        val *= POWER_TENS[scaling]
    if val > 0x7FFF:
        return 0x7FFFFFFF
    if val < -0x7FFF:
        return -0x7FFFFFFF
    return val << 16


def parse_fixed_dynamic(d: bytes) -> Tuple[int, int]:
    if d[0] == 30:
        return parse_real(d, 0, True)
    number = parse_integer(d)
    if number > 0x7FFF:
        integer_length = 5
        while integer_length < 10 and number >= POWER_TENS[integer_length]:
            integer_length += 1
        if number // POWER_TENS[integer_length - 5] > 0x7FFF:
            return (div_fix(number, POWER_TENS[integer_length - 4]),
                    integer_length - 4)
        return (div_fix(number, POWER_TENS[integer_length - 5]),
                integer_length - 5)
    return number << 16, 0


def parse_font_matrix(args: List[bytes]):
    """cff_parse_font_matrix: (xx, yx, xy, yy, ox, oy) in 16.16 and the
    units per em that the matrix's scale implies."""
    if len(args) < 6:
        return None
    values, scalings = [], []
    for a in args[:6]:
        v, s = parse_fixed_dynamic(a)
        values.append(v)
        scalings.append(s)
    nz = [s for v, s in zip(values, scalings) if v]
    max_s = max(nz) if nz else -0x7FFFFFFF
    min_s = min(nz) if nz else 0x7FFFFFFF
    if max_s < -9 or max_s > 0 or not 0 <= max_s - min_s <= 9:
        return [0x10000, 0, 0, 0x10000, 0, 0], 1
    out = []
    for v, s in zip(values, scalings):
        if not v:
            out.append(0)
            continue
        divisor = POWER_TENS[max_s - s]
        half = divisor >> 1
        out.append(_trunc_div(v - half, divisor) if v < 0
                   else _trunc_div(v + half, divisor))
    return out, POWER_TENS[-max_s]


def normalize_matrix(m: List[int], upm: int):
    """cff_face_init: scale the matrix so that yy is 1, folding the scale
    into the units per em; offsets to integer font units."""
    xx, yx, xy, yy, ox, oy = m
    temp = abs(yy) if yy else abs(yx)
    if temp != 0x10000:
        upm = div_fix(upm, temp)
        xx, yx, xy, yy = (div_fix(v, temp) for v in (xx, yx, xy, yy))
        ox, oy = div_fix(ox, temp), div_fix(oy, temp)
    return [xx, yx, xy, yy, ox >> 16, oy >> 16], upm


def _matrix_multiply_scaled(a, b, scaling):
    """FT_Matrix_Multiply_Scaled(a, b): b = a * b / scaling."""
    val = 0x10000 * scaling
    axx, ayx, axy, ayy = a[0], a[1], a[2], a[3]
    bxx, byx, bxy, byy = b[0], b[1], b[2], b[3]
    xx = _mul_div(axx, bxx, val) + _mul_div(axy, byx, val)
    xy = _mul_div(axx, bxy, val) + _mul_div(axy, byy, val)
    yx = _mul_div(ayx, bxx, val) + _mul_div(ayy, byx, val)
    yy = _mul_div(ayx, bxy, val) + _mul_div(ayy, byy, val)
    return [xx, yx, xy, yy]


# ------------------------------------------------------------ INDEX
class Index:
    """An INDEX: ``count`` items, item i at data[start[i]:start[i+1]]
    (absolute offsets into the table)."""

    def __init__(self, data: bytes, pos: int):
        if pos + 2 > len(data):
            raise CFFError("truncated INDEX")
        self.count = struct.unpack(">H", data[pos: pos + 2])[0]
        if self.count == 0:
            self.offsets = np.zeros(1, np.int64)
            self.end = pos + 2
            return
        off_size = data[pos + 2]
        if not 1 <= off_size <= 4:
            raise CFFError(f"bad INDEX offSize {off_size}")
        n = self.count + 1
        raw = np.frombuffer(data, np.uint8, n * off_size, pos + 3)
        raw = raw.reshape(n, off_size).astype(np.int64)
        off = np.zeros(n, np.int64)
        for k in range(off_size):
            off = (off << 8) | raw[:, k]
        base = pos + 3 + n * off_size - 1
        self.offsets = off + base
        self.end = int(self.offsets[-1])
        if self.end > len(data) or np.any(np.diff(off) < 0):
            raise CFFError("bad INDEX offsets")

    def item(self, data: bytes, i: int) -> bytes:
        return data[int(self.offsets[i]): int(self.offsets[i + 1])]


# ------------------------------------------------------------ DICT
def parse_dict(b: bytes) -> Dict[int, List[bytes]]:
    """op -> its operands' raw bytes (escaped ops as 1200 + op2)."""
    out: Dict[int, List[bytes]] = {}
    stack: List[bytes] = []
    i = 0
    n = len(b)
    while i < n:
        v = b[i]
        if v == 28:
            stack.append(b[i: i + 3])
            i += 3
        elif v == 29:
            stack.append(b[i: i + 5])
            i += 5
        elif v == 30:
            j = i + 1
            while j < n and (b[j] & 0x0F) != 0x0F and (b[j] >> 4) != 0x0F:
                j += 1
            stack.append(b[i: j + 1])
            i = j + 1
        elif 32 <= v <= 246:
            stack.append(b[i: i + 1])
            i += 1
        elif 247 <= v <= 254:
            stack.append(b[i: i + 2])
            i += 2
        else:
            op = v
            if v == 12:
                op = 1200 + b[i + 1]
                i += 1
            i += 1
            out[op] = stack
            stack = []
    return out


def _num(d, op, default=0):
    a = d.get(op)
    return parse_num(a[0]) if a else default


def _delta(d, op, max_n):
    """A delta array as FreeType stores it (at most ``max_n`` values)."""
    a = d.get(op, [])[:max_n]
    out, v = [], 0
    for x in a:
        v += parse_num(x)
        out.append(v)
    return out


class Private:
    """One Private DICT as FreeType's CFF_PrivateRec holds it."""

    def __init__(self, data: bytes, size: int, off: int):
        d = parse_dict(data[off: off + size]) if size else {}
        self.blue_values = _delta(d, 6, 14)
        self.blue_values = self.blue_values[: len(self.blue_values) & ~1]
        self.other_blues = _delta(d, 7, 10)
        self.family_blues = _delta(d, 8, 14)
        self.family_other_blues = _delta(d, 9, 10)
        self.blue_scale = parse_fixed(d[1209][0], 3) if 1209 in d \
            else DEFAULT_BLUE_SCALE
        self.blue_shift = _num(d, 1210, 7)
        self.blue_fuzz = _num(d, 1211, 1)
        if not 0 <= self.blue_shift <= 1000:
            self.blue_shift = 7
        if not 0 <= self.blue_fuzz <= 1000:
            self.blue_fuzz = 1
        self.std_hw = _num(d, 10)
        self.std_vw = _num(d, 11)
        self.snap_h = _delta(d, 1212, 13)
        self.snap_v = _delta(d, 1213, 13)
        self.force_bold = _num(d, 1214) != 0
        self.language_group = _num(d, 1217)
        self.expansion_factor = parse_fixed(d[1218][0]) if 1218 in d \
            else DEFAULT_EXPANSION
        self.default_width = _num(d, 20)
        self.nominal_width = _num(d, 21)
        subrs = _num(d, 19)
        self.subrs = Index(data, off + subrs) if subrs and size else None


class CFF:
    """The parsed ``CFF `` table: ``charstrings`` and ``gsubrs`` INDEXes,
    ``privates`` (one, or one per FD), ``fd_of_glyph`` (uint8 [n] or
    None), the scales (``top_upm``, each FD's ``sub_upm``) and, for a
    name-keyed font, the glyph of each StandardEncoding code (``seac``)."""

    def __init__(self, data: bytes, head_upm: int, path: str):
        from effocr_torch.fonts.sfnt import refuse

        self.data = data
        if len(data) < 4 or data[0] != 1:
            raise CFFError(f"not a CFF table (major {data[:1]!r}): {path}")
        pos = data[2]
        names = Index(data, pos)
        tops = Index(data, names.end)
        strings = Index(data, tops.end)
        self.gsubrs = Index(data, strings.end)
        if tops.count < 1:
            raise CFFError(f"CFF without a Top DICT: {path}")
        top = parse_dict(tops.item(data, 0))
        if _num(top, 1206, 2) != 2:
            raise refuse("Type 1 charstrings in CFF (CharstringType 1)",
                         path)
        cs_off = _num(top, 17)
        if not cs_off:
            raise CFFError(f"CFF without CharStrings: {path}")
        self.charstrings = Index(data, cs_off)
        self.num_glyphs = self.charstrings.count
        self.is_cid = 1230 in top
        has_matrix = 1207 in top
        if has_matrix:
            m, upm = parse_font_matrix(top[1207])
        else:
            m, upm = [0x10000, 0, 0, 0x10000, 0, 0], head_upm
        # cff_face_init: normalise the top matrix, then concatenate each
        # FD's own matrix with it
        self.top_matrix, top_upm = normalize_matrix(m, upm)
        self.top_upm = top_upm
        self.fd_of_glyph: Optional[np.ndarray] = None
        self.privates: List[Private] = []
        self.sub_upm: List[int] = []
        if self.is_cid:
            fda = Index(data, _num(top, 1236))
            for i in range(fda.count):
                fd = parse_dict(fda.item(data, i))
                if 1207 in fd:
                    sub_m, sub_upm = parse_font_matrix(fd[1207])
                    if has_matrix:
                        scaling = min(top_upm, sub_upm) \
                            if top_upm > 1 and sub_upm > 1 else 1
                        t = self.top_matrix
                        val = 0x10000 * scaling
                        ox, oy = sub_m[4], sub_m[5]
                        # FT_Vector_Transform_Scaled of the FD's offset
                        sub_m = _matrix_multiply_scaled(t, sub_m, scaling) + [
                            _mul_div(ox, t[0], val) + _mul_div(oy, t[2], val),
                            _mul_div(ox, t[1], val) + _mul_div(oy, t[3], val)]
                        sub_upm = _mul_div(sub_upm, top_upm, scaling)
                    m, sub_upm = normalize_matrix(sub_m, sub_upm)
                else:
                    m, sub_upm = self.top_matrix, top_upm
                self._check_matrix(m, path)
                self.sub_upm.append(sub_upm)
                pr = fd.get(18, [])
                size, off = (parse_num(pr[0]), parse_num(pr[1])) \
                    if len(pr) >= 2 else (0, 0)
                self.privates.append(Private(data, size, off))
            if not self.privates:
                raise CFFError(f"CID font without FDArray: {path}")
            self.fd_of_glyph = self._fd_select(_num(top, 1237))
            self.seac = np.full(256, -1, np.int32)
        else:
            self._check_matrix(self.top_matrix, path)
            pr = top.get(18, [])
            size, off = (parse_num(pr[0]), parse_num(pr[1])) \
                if len(pr) >= 2 else (0, 0)
            self.privates.append(Private(data, size, off))
            self.sub_upm.append(top_upm)
            self.seac = self._seac_table(_num(top, 15))

    # ---------------------------------------------------------- parts
    @staticmethod
    def _check_matrix(m, path):
        from effocr_torch.fonts.sfnt import refuse

        if m != [0x10000, 0, 0, 0x10000, 0, 0]:
            raise refuse("CFF fonts whose FontMatrix is not a uniform "
                         "scale (oblique or offset)", path)

    def _fd_select(self, off: int) -> np.ndarray:
        d, n = self.data, self.num_glyphs
        if not off:
            return np.zeros(n, np.uint8)
        fmt = d[off]
        if fmt == 0:
            return np.frombuffer(d, np.uint8, n, off + 1).copy()
        if fmt == 3:
            nr = struct.unpack(">H", d[off + 1: off + 3])[0]
            rec = np.frombuffer(d, np.uint8, 3 * nr + 2, off + 3)
            firsts = (rec[0: 3 * nr: 3].astype(np.int64) << 8) | \
                rec[1: 3 * nr: 3]
            fds = rec[2: 3 * nr: 3]
            sentinel = (int(rec[3 * nr]) << 8) | int(rec[3 * nr + 1])
            ends = np.append(firsts[1:], sentinel)
            out = np.zeros(n, np.uint8)
            # glyphs before the first range and past the sentinel read 0
            reps = np.clip(np.minimum(ends, n) - np.minimum(firsts, n), 0,
                           None)
            body = np.repeat(fds, reps)
            start = min(int(firsts[0]), n) if nr else 0
            out[start: start + len(body)] = body
            return out
        raise CFFError(f"FDSelect format {fmt}")

    def _seac_table(self, charset_off: int) -> np.ndarray:
        """cff_lookup_glyph_by_stdcharcode for each code: the first glyph
        whose charset SID is the code's StandardEncoding SID."""
        sids = self._charset(charset_off)
        out = np.full(256, -1, np.int32)
        if sids is None:
            return out
        first: Dict[int, int] = {}
        for g, s in enumerate(sids.tolist()):
            first.setdefault(s, g)
        for code in range(256):
            g = first.get(STANDARD_ENCODING[code])
            if g is not None:
                out[code] = g
        return out

    def _charset(self, off: int) -> Optional[np.ndarray]:
        n, d = self.num_glyphs, self.data
        if off == 0:
            # ISOAdobe: SID i for glyph i (228 predefined names)
            return np.arange(min(n, 229), dtype=np.int64)
        if off in (1, 2):
            return None  # the Expert charsets: no StandardEncoding names
        fmt = d[off]
        sids = np.zeros(n, np.int64)
        if fmt == 0:
            v = np.frombuffer(d, ">u2", n - 1, off + 1)
            sids[1:] = v
            return sids
        if fmt in (1, 2):
            g, p = 1, off + 1
            while g < n:
                first = struct.unpack(">H", d[p: p + 2])[0]
                if fmt == 1:
                    left = d[p + 2]
                    p += 3
                else:
                    left = struct.unpack(">H", d[p + 2: p + 4])[0]
                    p += 4
                k = min(left + 1, n - g)
                sids[g: g + k] = np.arange(first, first + k)
                g += k
            return sids
        raise CFFError(f"charset format {fmt}")
