"""Text shaping: the glyph sequence and positions that raqm and HarfBuzz
give Pillow's text drawing (``ImageFont.Layout.RAQM``), for text that
HarfBuzz shapes with its default shaper.

What is carried over:

- raqm's itemization into script runs (Common and Inherited characters
  take the script of their neighbours, paired brackets the script of
  their opening bracket), each run shaped on its own;
- HarfBuzz's script and language-system selection (the run's script
  tag, else ``DFLT``, ``dflt``, ``latn``; the default language system);
- the default features ``ccmp``, ``locl``, ``rlig``, ``calt``, ``clig``,
  ``liga``, ``rclt`` (and the language system's required feature) in
  GSUB: single, multiple-free chaining and plain contextual rules whose
  nested lookups are single substitutions, and ligatures; ``kern``,
  ``mark``, ``mkmk``, ``curs``, ``dist`` in GPOS: single and pair
  adjustment, mark-to-base attachment with format-1 anchors;
- advances in 26.6 as HarfBuzz's FreeType font functions return them
  (unhinted, ``FT_MulDiv(advance, x_scale, 64)`` rounded from 16.16),
  GPOS values scaled as HarfBuzz's ``em_scale`` rounds them;
- marks zeroed by their GDEF class after GPOS, a dotted circle (U+25CC)
  before a text that starts with a combining mark, default-ignorable
  characters hidden behind the space glyph with no advance.

Refused with ``NotImplementedError`` naming the feature and ROADMAP.md
queue 1: scripts HarfBuzz shapes with a complex shaper (Arabic, Hebrew,
Indic, Thai, Lao, Khmer, Myanmar, Tibetan, Hangul, N'Ko, Syriac,
Mongolian and the like), combining marks inside longer strings,
default-ignorable characters inside longer strings, characters the font
lacks but HarfBuzz would compose from others, and lookups outside the
list above when they would apply.
"""

from __future__ import annotations

import functools
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from effocr_torch.fonts.sfnt import Font, ROADMAP
from effocr_torch.fonts.sfnt import read_class_def as _read_class_def

read_class_def = functools.lru_cache(maxsize=4096)(_read_class_def)

# ------------------------------------------------------------ scripts
_LATIN = ((0x41, 0x5A), (0x61, 0x7A), (0xAA, 0xAA), (0xBA, 0xBA),
          (0xC0, 0xD6), (0xD8, 0xF6), (0xF8, 0x2B8), (0x2E0, 0x2E4),
          (0x1D00, 0x1D25), (0x1D2C, 0x1D5C), (0x1D62, 0x1D65),
          (0x1D6B, 0x1D77), (0x1D79, 0x1DBE), (0x1E00, 0x1EFF),
          (0x2071, 0x2071), (0x207F, 0x207F), (0x2090, 0x209C),
          (0x212A, 0x212B), (0x2132, 0x2132), (0x214E, 0x214E),
          (0x2160, 0x2188), (0x2C60, 0x2C7F), (0xA722, 0xA787),
          (0xA78B, 0xA7FF), (0xAB30, 0xAB5A), (0xAB5C, 0xAB64),
          (0xFB00, 0xFB06), (0xFF21, 0xFF3A), (0xFF41, 0xFF5A))
_GREEK = ((0x370, 0x373), (0x375, 0x377), (0x37A, 0x37D), (0x37F, 0x37F),
          (0x384, 0x384), (0x386, 0x386), (0x388, 0x38A), (0x38C, 0x38C),
          (0x38E, 0x3A1), (0x3A3, 0x3E1), (0x3F0, 0x3FF), (0x1D26, 0x1D2A),
          (0x1D5D, 0x1D61), (0x1D66, 0x1D6A), (0x1DBF, 0x1DBF),
          (0x1F00, 0x1FFE), (0x2126, 0x2126), (0xAB65, 0xAB65))
_CYRILLIC = ((0x400, 0x484), (0x487, 0x52F), (0x1C80, 0x1C88),
             (0x1D2B, 0x1D2B), (0x1D78, 0x1D78), (0x2DE0, 0x2DFF),
             (0xA640, 0xA69F), (0xFE2E, 0xFE2F))
_OTHER = (("copt", ((0x3E2, 0x3EF), (0x2C80, 0x2CFF))),
          ("armn", ((0x531, 0x58F), (0xFB13, 0xFB17))),
          ("geor", ((0x10A0, 0x10FF), (0x2D00, 0x2D2F), (0x1C90, 0x1CBF))),
          ("cher", ((0x13A0, 0x13FF), (0xAB70, 0xABBF))),
          ("cans", ((0x1400, 0x167F), (0x18B0, 0x18FF))),
          ("ogam", ((0x1680, 0x169F),)),
          ("runr", ((0x16A0, 0x16FF),)),
          ("brai", ((0x2800, 0x28FF),)),
          ("glag", ((0x2C00, 0x2C5F),)),
          ("tfng", ((0x2D30, 0x2D7F),)),
          ("kana", ((0x3041, 0x30FF), (0x31F0, 0x31FF))),
          ("hani", ((0x2E80, 0x2FDF), (0x3005, 0x3007), (0x3021, 0x3029),
                    (0x3038, 0x303B), (0x3400, 0x4DBF), (0x4E00, 0x9FFF),
                    (0xF900, 0xFAFF), (0x20000, 0x3FFFF))))
# scripts HarfBuzz hands to a complex shaper, or that run right to left
_COMPLEX = ((0x590, 0x8FF), (0x900, 0xDFF), (0xE00, 0xEFF), (0xF00, 0xFFF),
            (0x1000, 0x109F), (0x1100, 0x11FF), (0x1700, 0x18AF),
            (0x1900, 0x1AAF), (0x1B00, 0x1C7F), (0x1CD0, 0x1CFF),
            (0x3130, 0x318F), (0xA800, 0xABFF), (0xAC00, 0xD7FF),
            (0xFB1D, 0xFDFF), (0xFE70, 0xFEFE), (0x10800, 0x10FFF),
            (0x11000, 0x11FFF), (0x1E800, 0x1EFFF))
_INHERITED_EXTRA = ((0x200C, 0x200D),)
# raqm's paired characters: (open, close) at (even, odd) indices
_PAIRED = (0x28, 0x29, 0x3C, 0x3E, 0x5B, 0x5D, 0x7B, 0x7D, 0xAB, 0xBB,
           0x2018, 0x2019, 0x201C, 0x201D, 0x2039, 0x203A, 0x3008, 0x3009,
           0x300A, 0x300B, 0x300C, 0x300D, 0x300E, 0x300F, 0x3010, 0x3011,
           0x3014, 0x3015, 0x3016, 0x3017, 0x3018, 0x3019, 0x301A, 0x301B)
_PAIR_INDEX = {cp: i for i, cp in enumerate(_PAIRED)}


def _in(cp: int, ranges) -> bool:
    return any(a <= cp <= b for a, b in ranges)


def is_mark(ch: str) -> bool:
    return unicodedata.category(ch) in ("Mn", "Mc", "Me")


@functools.lru_cache(maxsize=65536)
def script_of(cp: int) -> str:
    """'latn', 'grek', 'cyrl', another OpenType script tag, 'Zinh'
    (inherited), 'Zyyy' (common) or 'complex'."""
    if _in(cp, _COMPLEX):
        return "complex"
    if _in(cp, _LATIN):
        return "latn"
    if _in(cp, _GREEK):
        return "grek"
    if _in(cp, _CYRILLIC):
        return "cyrl"
    for tag, ranges in _OTHER:
        if _in(cp, ranges):
            return tag
    if is_mark(chr(cp)) or _in(cp, _INHERITED_EXTRA):
        return "Zinh"
    return "Zyyy"


def is_default_ignorable(cp: int) -> bool:
    """HarfBuzz's hb_unicode_funcs_t::is_default_ignorable."""
    plane = cp >> 16
    if plane == 0:
        page = cp >> 8
        if page == 0x00:
            return cp == 0x00AD
        if page == 0x03:
            return cp == 0x034F
        if page == 0x06:
            return cp == 0x061C
        if page == 0x17:
            return 0x17B4 <= cp <= 0x17B5
        if page == 0x18:
            return 0x180B <= cp <= 0x180F
        if page == 0x20:
            return (0x200B <= cp <= 0x200F or 0x202A <= cp <= 0x202E
                    or 0x2060 <= cp <= 0x206F)
        if page == 0xFE:
            return 0xFE00 <= cp <= 0xFE0F or cp == 0xFEFF
        if page == 0xFF:
            return 0xFFF0 <= cp <= 0xFFF8
        return False
    if plane == 0x01:
        return 0x1D173 <= cp <= 0x1D17A
    if plane == 0x0E:
        return 0xE0000 <= cp <= 0xE0FFF
    return False


def refuse(feature: str) -> NotImplementedError:
    return NotImplementedError(f"{feature}: {ROADMAP}")


def itemize(text: str) -> List[Tuple[str, int, int]]:
    """raqm's script runs (_raqm_resolve_scripts): [(script, start,
    end)]."""
    scripts = [script_of(ord(c)) for c in text]
    for i, s in enumerate(scripts):
        if s == "complex":
            raise refuse(f"text in a script HarfBuzz shapes with a complex "
                         f"shaper or right to left (U+{ord(text[i]):04X})")
    last_index = last_set = -1
    last_value = None
    stack: List[Tuple[str, int]] = []
    for i, ch in enumerate(text):
        s = scripts[i]
        if s == "Zyyy" and last_index != -1:
            pair = _PAIR_INDEX.get(ord(ch), -1)
            if pair >= 0 and pair % 2 == 0:
                scripts[i] = last_value
                stack.append((last_value, pair))
            elif pair >= 0:
                while stack and stack[-1][1] != (pair & ~1):
                    stack.pop()
                if stack:
                    scripts[i] = last_value = stack[-1][0]
                else:
                    scripts[i] = last_value
            else:
                scripts[i] = last_value
            last_set = i
        elif s == "Zinh" and last_index != -1:
            scripts[i] = last_value
            last_set = i
        else:
            for j in range(last_set + 1, i):
                scripts[j] = s
            last_value = s
            last_index = last_set = i
    for i in range(len(text) - 2, -1, -1):
        if scripts[i] in ("Zyyy", "Zinh"):
            scripts[i] = scripts[i + 1]
    runs = []
    start = 0
    for i in range(1, len(text) + 1):
        if i == len(text) or scripts[i] != scripts[start]:
            runs.append((scripts[start], start, i))
            start = i
    return runs


# ------------------------------------------------------------ layout
def _u16(d: bytes, o: int) -> int:
    return struct.unpack(">H", d[o: o + 2])[0]


def _i16(d: bytes, o: int) -> int:
    return struct.unpack(">h", d[o: o + 2])[0]


@functools.lru_cache(maxsize=8192)
def _coverage(d: bytes, o: int) -> Dict[int, int]:
    fmt = _u16(d, o)
    out = {}
    if fmt == 1:
        n = _u16(d, o + 2)
        glyphs = struct.unpack(f">{n}H", d[o + 4: o + 4 + 2 * n])
        for i, g in enumerate(glyphs):
            out[g] = i
    elif fmt == 2:
        n = _u16(d, o + 2)
        for i in range(n):
            s, e, si = struct.unpack(">HHH", d[o + 4 + 6 * i: o + 10 + 6 * i])
            for g in range(s, e + 1):
                out[g] = si + g - s
    return out


_VALUE_FIELDS = ((1, "x_off"), (2, "y_off"), (4, "x_adv"), (8, "y_adv"))


def _value_size(fmt: int) -> int:
    return 2 * bin(fmt & 0xFF).count("1")


def _read_value(d: bytes, o: int, fmt: int) -> Dict[str, int]:
    if fmt & 0xF0:
        raise refuse("GPOS values with device tables")
    out = {}
    for bit, name in _VALUE_FIELDS:
        if fmt & bit:
            out[name] = _i16(d, o)
            o += 2
    return out


class Table:
    """GSUB or GPOS: script / language / feature lists and lazily parsed
    lookups."""

    def __init__(self, data: bytes, kind: str):
        self.d = data
        self.kind = kind
        d = data
        self.script_off = _u16(d, 4)
        self.feature_off = _u16(d, 6)
        self.lookup_off = _u16(d, 8)
        so = self.script_off
        self.scripts = {}
        for i in range(_u16(d, so)):
            tag = d[so + 2 + 6 * i: so + 6 + 6 * i].decode("latin-1")
            self.scripts[tag] = so + _u16(d, so + 6 + 6 * i)
        fo = self.feature_off
        self.features = []
        for i in range(_u16(d, fo)):
            tag = d[fo + 2 + 6 * i: fo + 6 + 6 * i].decode("latin-1")
            off = fo + _u16(d, fo + 6 + 6 * i)
            n = _u16(d, off + 2)
            lookups = struct.unpack(f">{n}H", d[off + 4: off + 4 + 2 * n])
            self.features.append((tag, list(lookups)))
        lo = self.lookup_off
        self.n_lookups = _u16(d, lo)
        self._lookups = {}

    def langsys(self, script_tags: Sequence[str]) -> Optional[int]:
        """Offset of the default language system of the selected script
        (hb_ot_layout_table_select_script, then the default language)."""
        for t in list(script_tags) + ["DFLT", "dflt", "latn"]:
            if t in self.scripts:
                so = self.scripts[t]
                off = _u16(self.d, so)
                return so + off if off else None
        return None

    def lookup_indices(self, script_tags: Sequence[str],
                       feature_tags: Sequence[str]) -> List[int]:
        ls = self.langsys(script_tags)
        if ls is None:
            return []
        d = self.d
        req = _u16(d, ls + 2)
        n = _u16(d, ls + 4)
        idx = struct.unpack(f">{n}H", d[ls + 6: ls + 6 + 2 * n])
        out = set()
        chosen = [i for i in idx if i < len(self.features)
                  and self.features[i][0] in feature_tags]
        if req != 0xFFFF and req < len(self.features):
            chosen.append(req)
        for i in chosen:
            out.update(k for k in self.features[i][1] if k < self.n_lookups)
        return sorted(out)

    def has_feature(self, script_tags, tag) -> bool:
        ls = self.langsys(script_tags)
        if ls is None:
            return False
        d = self.d
        n = _u16(d, ls + 4)
        idx = struct.unpack(f">{n}H", d[ls + 6: ls + 6 + 2 * n])
        return any(i < len(self.features) and self.features[i][0] == tag
                   for i in idx)

    def lookup(self, i: int):
        if i not in self._lookups:
            self._lookups[i] = self._parse_lookup(i)
        return self._lookups[i]

    def _parse_lookup(self, i: int):
        d = self.d
        off = self.lookup_off + _u16(d, self.lookup_off + 2 + 2 * i)
        ltype, flag, n = struct.unpack(">HHH", d[off: off + 6])
        subs = []
        for k in range(n):
            so = off + _u16(d, off + 6 + 2 * k)
            t = ltype
            if (self.kind == "GSUB" and t == 7) or (self.kind == "GPOS"
                                                    and t == 9):
                t = _u16(d, so + 2)
                so = so + struct.unpack(">I", d[so + 4: so + 8])[0]
            subs.append((t, so))
        return {"type": ltype, "flag": flag, "subs": subs}


@functools.lru_cache(maxsize=32)
def _tables(font: Font):
    gsub = Table(font.gsub, "GSUB") if font.gsub else None
    gpos = Table(font.gpos, "GPOS") if font.gpos else None
    return gsub, gpos


# HarfBuzz's default features (hb-ot-shape.cc), horizontal text
_FEATURES = ("abvm", "blwm", "ccmp", "locl", "mark", "mkmk", "rlig", "calt",
             "clig", "curs", "dist", "kern", "liga", "rclt", "rvrn")

_PROPS_BASE, _PROPS_LIGATURE, _PROPS_MARK = 2, 4, 8


class Glyph:
    __slots__ = ("gid", "props", "x_adv", "y_adv", "x_off", "y_off",
                 "attach", "ignorable")

    def __init__(self, gid: int, props: int, ignorable: bool):
        self.gid, self.props = gid, props
        self.x_adv = self.y_adv = self.x_off = self.y_off = 0
        self.attach = 0
        self.ignorable = ignorable


def glyph_props(font: Font, gid: int) -> int:
    c = font.glyph_class.get(gid, 0)
    return {1: _PROPS_BASE, 2: _PROPS_LIGATURE, 3: _PROPS_MARK}.get(c, 0)


def _skip(g: Glyph, flag: int) -> bool:
    """True when lookup ``flag`` ignores glyph ``g``
    (check_glyph_property)."""
    if g.props & flag & 0x0E:
        return True
    if g.props & _PROPS_MARK and flag & 0xFF10:
        raise refuse("mark attachment classes and mark filtering sets in "
                     "lookups")
    return False


class _Ctx:
    def __init__(self, font: Font, table: Table, scale: "Scale"):
        self.font, self.t, self.scale = font, table, scale


def _next(buf: List[Glyph], i: int, flag: int) -> int:
    j = i + 1
    while j < len(buf) and _skip(buf[j], flag):
        j += 1
    return j


def _prev(buf: List[Glyph], i: int, flag: int) -> int:
    j = i - 1
    while j >= 0 and _skip(buf[j], flag):
        j -= 1
    return j


# ------------------------------------------------------------ GSUB
def _single_subst(d: bytes, so: int, gid: int) -> Optional[int]:
    fmt = _u16(d, so)
    cov = _coverage(d, so + _u16(d, so + 2))
    if gid not in cov:
        return None
    if fmt == 1:
        return (gid + _i16(d, so + 4)) & 0xFFFF
    return _u16(d, so + 6 + 2 * cov[gid])


def _apply_single_lookup(ctx: _Ctx, li: int, buf: List[Glyph], i: int
                         ) -> bool:
    lk = ctx.t.lookup(li)
    if lk["type"] != 1:
        raise refuse(f"GSUB lookup type {lk['type']} nested in a context")
    if _skip(buf[i], lk["flag"]):
        return False
    for t, so in lk["subs"]:
        g = _single_subst(ctx.t.d, so, buf[i].gid)
        if g is not None:
            buf[i].gid = g
            buf[i].props = glyph_props(ctx.font, g)
            return True
    return False


def _match_context(ctx, buf, i, flag, backtrack, inp, lookahead, match):
    """Positions of the input sequence starting at i, or None."""
    pos = [i]
    j = i
    for v in inp:
        j = _next(buf, j, flag)
        if j >= len(buf) or not match(buf[j].gid, v, "input"):
            return None
        pos.append(j)
    k = i
    for v in backtrack:
        k = _prev(buf, k, flag)
        if k < 0 or not match(buf[k].gid, v, "backtrack"):
            return None
    k = j
    for v in lookahead:
        k = _next(buf, k, flag)
        if k >= len(buf) or not match(buf[k].gid, v, "lookahead"):
            return None
    return pos


def _apply_records(ctx, buf, pos, records):
    for seq, li in records:
        if seq < len(pos):
            _apply_single_lookup(ctx, li, buf, pos[seq])


def _context_subst(ctx: _Ctx, t: int, so: int, buf: List[Glyph], i: int,
                   flag: int) -> bool:
    d = ctx.t.d
    fmt = _u16(d, so)
    gid = buf[i].gid
    chain = t == 6
    if fmt in (1, 2):
        cov = _coverage(d, so + _u16(d, so + 2))
        if gid not in cov:
            return False
        if fmt == 2:
            if chain:
                bc = read_class_def(d, so + _u16(d, so + 4))
                ic = read_class_def(d, so + _u16(d, so + 6))
                lc = read_class_def(d, so + _u16(d, so + 8))
                nsets, base = _u16(d, so + 10), so + 12
            else:
                ic = read_class_def(d, so + _u16(d, so + 4))
                bc = lc = ic
                nsets, base = _u16(d, so + 6), so + 8
            k = ic.get(gid, 0)
            classes = {"backtrack": bc, "input": ic, "lookahead": lc}

            def match(g, v, kind):
                return classes[kind].get(g, 0) == v
        else:
            nsets, base = _u16(d, so + 4), so + 6
            k = cov[gid]

            def match(g, v, kind):
                return g == v
        if k >= nsets:
            return False
        set_off = _u16(d, base + 2 * k)
        if not set_off:
            return False
        rs = so + set_off
        for r in range(_u16(d, rs)):
            ro = rs + _u16(d, rs + 2 + 2 * r)
            if chain:
                nb = _u16(d, ro)
                back = struct.unpack(f">{nb}H", d[ro + 2: ro + 2 + 2 * nb])
                o = ro + 2 + 2 * nb
                ni = _u16(d, o)
                inp = struct.unpack(f">{ni - 1}H", d[o + 2: o + 2 * ni])
                o += 2 * ni
                nl = _u16(d, o)
                look = struct.unpack(f">{nl}H", d[o + 2: o + 2 + 2 * nl])
                o += 2 + 2 * nl
                ns = _u16(d, o)
                rec_o = o + 2
            else:
                ni, ns = _u16(d, ro), _u16(d, ro + 2)
                inp = struct.unpack(f">{ni - 1}H", d[ro + 4: ro + 2 + 2 * ni])
                back = look = ()
                rec_o = ro + 2 + 2 * ni
            pos = _match_context(ctx, buf, i, flag, back, inp, look, match)
            if pos is None:
                continue
            recs = [struct.unpack(">HH", d[rec_o + 4 * q: rec_o + 4 * q + 4])
                    for q in range(ns)]
            _apply_records(ctx, buf, pos, recs)
            return True
        return False
    # format 3: coverages
    if chain:
        nb = _u16(d, so + 2)
        bcov = [_coverage(d, so + _u16(d, so + 4 + 2 * q)) for q in range(nb)]
        o = so + 4 + 2 * nb
        ni = _u16(d, o)
        icov = [_coverage(d, so + _u16(d, o + 2 + 2 * q)) for q in range(ni)]
        o += 2 + 2 * ni
        nl = _u16(d, o)
        lcov = [_coverage(d, so + _u16(d, o + 2 + 2 * q)) for q in range(nl)]
        o += 2 + 2 * nl
        ns = _u16(d, o)
        rec_o = o + 2
    else:
        ni, ns = _u16(d, so + 2), _u16(d, so + 4)
        icov = [_coverage(d, so + _u16(d, so + 6 + 2 * q)) for q in range(ni)]
        bcov = lcov = []
        rec_o = so + 6 + 2 * ni
    if gid not in icov[0]:
        return False

    def match(g, v, kind):
        return g in v
    pos = _match_context(ctx, buf, i, flag, bcov, icov[1:], lcov, match)
    if pos is None:
        return False
    recs = [struct.unpack(">HH", d[rec_o + 4 * q: rec_o + 4 * q + 4])
            for q in range(ns)]
    _apply_records(ctx, buf, pos, recs)
    return True


def _ligature(ctx: _Ctx, so: int, buf: List[Glyph], i: int, flag: int
              ) -> bool:
    d = ctx.t.d
    cov = _coverage(d, so + _u16(d, so + 2))
    gid = buf[i].gid
    if gid not in cov:
        return False
    ls = so + _u16(d, so + 6 + 2 * cov[gid])
    for k in range(_u16(d, ls)):
        lo = ls + _u16(d, ls + 2 + 2 * k)
        lig, nc = _u16(d, lo), _u16(d, lo + 2)
        comps = struct.unpack(f">{nc - 1}H", d[lo + 4: lo + 2 + 2 * nc])
        pos = [i]
        j = i
        ok = True
        for c in comps:
            j = _next(buf, j, flag)
            if j >= len(buf) or buf[j].gid != c:
                ok = False
                break
            pos.append(j)
        if not ok:
            continue
        if pos[-1] - pos[0] + 1 != len(pos):
            raise refuse("ligatures across skipped glyphs")
        buf[i].gid = lig
        buf[i].props = glyph_props(ctx.font, lig) or _PROPS_LIGATURE
        del buf[i + 1: pos[-1] + 1]
        return True
    return False


def apply_gsub(ctx: _Ctx, lookups: Sequence[int], buf: List[Glyph]) -> None:
    for li in lookups:
        lk = ctx.t.lookup(li)
        flag = lk["flag"]
        i = 0
        while i < len(buf):
            applied = False
            if not _skip(buf[i], flag):
                for t, so in lk["subs"]:
                    if t == 1:
                        g = _single_subst(ctx.t.d, so, buf[i].gid)
                        if g is not None:
                            buf[i].gid = g
                            buf[i].props = glyph_props(ctx.font, g)
                            applied = True
                    elif t == 4:
                        applied = _ligature(ctx, so, buf, i, flag)
                    elif t in (5, 6):
                        applied = _context_subst(ctx, t, so, buf, i, flag)
                    else:
                        if _gsub_covers(ctx.t.d, t, so, buf[i].gid):
                            raise refuse(f"GSUB lookup type {t}")
                    if applied:
                        break
            i += 1


def _gsub_covers(d: bytes, t: int, so: int, gid: int) -> bool:
    if t in (2, 3):
        return gid in _coverage(d, so + _u16(d, so + 2))
    return True


# ------------------------------------------------------------ GPOS
class Scale:
    """HarfBuzz's font scale for a FreeType size (hb_ft_font_changed)."""

    def __init__(self, font: Font, x_scale_ft: int):
        upem = font.units_per_em
        self.upem = upem
        self.x_scale = (x_scale_ft * upem + (1 << 15)) >> 16
        self.x_mult = (self.x_scale << 16) // upem
        self.x_multf = np.float32(self.x_scale) / np.float32(upem)

    def em(self, v: int) -> int:
        return (v * self.x_mult + 32768) >> 16

    def emf(self, v: int) -> np.float32:
        return np.float32(v) * self.x_multf


def _apply_value(scale: Scale, g: Glyph, val: Dict[str, int]) -> None:
    for name, v in val.items():
        setattr(g, name, getattr(g, name) + scale.em(v))


def _pair(ctx: _Ctx, so: int, buf: List[Glyph], i: int, flag: int
          ) -> Optional[int]:
    """New index after PairPos at i, or None when it does not apply."""
    d = ctx.t.d
    fmt = _u16(d, so)
    cov = _coverage(d, so + _u16(d, so + 2))
    if buf[i].gid not in cov:
        return None
    vf1, vf2 = _u16(d, so + 4), _u16(d, so + 6)
    s1, s2 = _value_size(vf1), _value_size(vf2)
    j = _next(buf, i, flag)
    if j >= len(buf):
        return None
    second = buf[j].gid
    if fmt == 1:
        ps = so + _u16(d, so + 10 + 2 * cov[buf[i].gid])
        n = _u16(d, ps)
        rec = 2 + s1 + s2
        found = None
        for k in range(n):
            o = ps + 2 + rec * k
            if _u16(d, o) == second:
                found = o + 2
                break
        if found is None:
            return None
        v1 = _read_value(d, found, vf1)
        v2 = _read_value(d, found + s1, vf2)
    else:
        cd1 = read_class_def(d, so + _u16(d, so + 8))
        cd2 = read_class_def(d, so + _u16(d, so + 10))
        n1, n2 = _u16(d, so + 12), _u16(d, so + 14)
        k2 = cd2.get(second, 0)
        if not k2:
            return None
        k1 = cd1.get(buf[i].gid, 0)
        if k1 >= n1 or k2 >= n2:
            return None
        o = so + 16 + (s1 + s2) * (k1 * n2 + k2)
        v1 = _read_value(d, o, vf1)
        v2 = _read_value(d, o + s1, vf2)
    if s1:
        _apply_value(ctx.scale, buf[i], v1)
    if s2:
        _apply_value(ctx.scale, buf[j], v2)
        return j + 1
    return j


def _single_pos(ctx: _Ctx, so: int, g: Glyph) -> bool:
    d = ctx.t.d
    fmt = _u16(d, so)
    cov = _coverage(d, so + _u16(d, so + 2))
    if g.gid not in cov:
        return False
    vf = _u16(d, so + 4)
    if fmt == 1:
        val = _read_value(d, so + 6, vf)
    else:
        val = _read_value(d, so + 8 + _value_size(vf) * cov[g.gid], vf)
    _apply_value(ctx.scale, g, val)
    return True


def _anchor(ctx: _Ctx, o: int) -> Tuple[np.float32, np.float32]:
    d = ctx.t.d
    if _u16(d, o) != 1:
        raise refuse("GPOS anchors of format 2 or 3")
    return ctx.scale.emf(_i16(d, o + 2)), ctx.scale.emf(_i16(d, o + 4))


def _mark_base(ctx: _Ctx, so: int, buf: List[Glyph], i: int) -> bool:
    d = ctx.t.d
    mcov = _coverage(d, so + _u16(d, so + 2))
    if buf[i].gid not in mcov:
        return False
    j = _prev(buf, i, 8)
    if j < 0:
        return False
    bcov = _coverage(d, so + _u16(d, so + 4))
    if buf[j].gid not in bcov:
        return False
    ncls = _u16(d, so + 6)
    ma = so + _u16(d, so + 8)
    ba = so + _u16(d, so + 10)
    mi = mcov[buf[i].gid]
    klass, m_anchor = _u16(d, ma + 2 + 4 * mi), _u16(d, ma + 4 + 4 * mi)
    bo = ba + 2 + 2 * (bcov[buf[j].gid] * ncls + klass)
    b_anchor = _u16(d, bo)
    if not b_anchor:
        return False
    mx, my = _anchor(ctx, ma + m_anchor)
    bx, by = _anchor(ctx, ba + b_anchor)
    # roundf rounds half away from zero
    buf[i].x_off = _roundf(np.float32(bx - mx))
    buf[i].y_off = _roundf(np.float32(by - my))
    buf[i].attach = j - i
    return True


def _roundf(v: np.float32) -> int:
    f = float(v)
    return int(np.floor(f + 0.5)) if f >= 0 else -int(np.floor(-f + 0.5))


def apply_gpos(ctx: _Ctx, lookups: Sequence[int], buf: List[Glyph]) -> None:
    for li in lookups:
        lk = ctx.t.lookup(li)
        flag = lk["flag"]
        i = 0
        while i < len(buf):
            nxt = i + 1
            if not _skip(buf[i], flag):
                for t, so in lk["subs"]:
                    if t == 1:
                        if _single_pos(ctx, so, buf[i]):
                            break
                    elif t == 2:
                        r = _pair(ctx, so, buf, i, flag)
                        if r is not None:
                            nxt = r
                            break
                    elif t == 4:
                        if _mark_base(ctx, so, buf, i):
                            break
                    elif t in (5, 6):
                        d = ctx.t.d
                        if buf[i].gid in _coverage(d, so + _u16(d, so + 2)):
                            j = _prev(buf, i, 0)
                            if j >= 0 and (
                                    (t == 6 and buf[j].props & _PROPS_MARK)
                                    or (t == 5 and buf[j].props
                                        & _PROPS_LIGATURE)):
                                raise refuse("mark-to-ligature and "
                                             "mark-to-mark attachment")
                    else:
                        raise refuse(f"GPOS lookup type {t}")
            i = nxt


# ------------------------------------------------------------ shaping
def advance(font: Font, x_scale_ft: int, gid: int) -> int:
    """HarfBuzz's hb-ft h_advance in 26.6: FT_Get_Advance unhinted
    (``FT_MulDiv(advance, x_scale, 64)``, 16.16) rounded to 26.6."""
    n = len(font.advances)
    a = int(font.advances[gid if gid < n else n - 1])
    v = _mul_div(a, x_scale_ft, 64)
    return (v + (1 << 9)) >> 10


def _mul_div(a: int, b: int, c: int) -> int:
    s = -1 if (a < 0) ^ (b < 0) ^ (c < 0) else 1
    a, b, c = abs(a), abs(b), abs(c)
    d = (a * b + (c >> 1)) // c if c > 0 else 0x7FFFFFFF
    return s * d


def shape(font: Font, text: str, x_scale_ft: int) -> List[Glyph]:
    """Glyphs with 26.6 advances and offsets, in visual (= logical) order."""
    if not text:
        return []
    if len(text) > 1:
        for ch in text:
            if is_mark(ch):
                raise refuse("combining marks inside a string (HarfBuzz's "
                             "normalization and mark positioning)")
            if is_default_ignorable(ord(ch)):
                raise refuse("default-ignorable characters inside a string")
    for ch in text:
        dec = unicodedata.decomposition(ch)
        if is_mark(ch) and dec and not dec.startswith("<"):
            raise refuse(f"U+{ord(ch):04X}, a mark HarfBuzz decomposes")
    gsub, gpos = _tables(font)
    scale = Scale(font, x_scale_ft)
    cmap = font.cmap
    space = cmap.get(0x20, 0)
    out: List[Glyph] = []
    for script, a, b in itemize(text):
        tags = [] if script in ("Zyyy", "Zinh") else [script]
        buf = []
        for ch in text[a:b]:
            cp = ord(ch)
            gid = cmap.get(cp, 0)
            ign = is_default_ignorable(cp)
            if gid == 0 and not ign:
                dec = unicodedata.decomposition(ch)
                if dec and not dec.startswith("<") and all(
                        int(h, 16) in cmap for h in dec.split()):
                    raise refuse(f"U+{cp:04X}, which the font lacks and "
                                 f"HarfBuzz would compose from others")
                if unicodedata.category(ch) == "Zs":
                    raise refuse(f"U+{cp:04X}, a space the font lacks "
                                 f"(HarfBuzz's space fallback)")
            if gid == 0 and ign:
                gid = space
            buf.append(Glyph(gid, glyph_props(font, gid), ign))
        if a == 0 and is_mark(text[0]) and 0x25CC in cmap:
            dc = cmap[0x25CC]
            buf.insert(0, Glyph(dc, glyph_props(font, dc), False))
        if gsub is not None:
            apply_gsub(_Ctx(font, gsub, scale),
                       gsub.lookup_indices(tags, _FEATURES), buf)
        for g in buf:
            g.x_adv = advance(font, x_scale_ft, g.gid)
        if gpos is not None:
            apply_gpos(_Ctx(font, gpos, scale),
                       gpos.lookup_indices(tags, _FEATURES), buf)
        for g in buf:
            if g.props & _PROPS_MARK:
                g.x_adv = g.y_adv = 0
        for g in buf:
            if g.ignorable:
                g.x_adv = g.y_adv = g.x_off = g.y_off = 0
        for i, g in enumerate(buf):
            _propagate(buf, i)
        for g in buf:
            if g.ignorable and space:
                g.gid = space
        out.extend(buf)
    return out


def _propagate(buf: List[Glyph], i: int) -> None:
    chain = buf[i].attach
    if not chain:
        return
    buf[i].attach = 0
    j = i + chain
    if not 0 <= j < len(buf):
        return
    _propagate(buf, j)
    buf[i].x_off += buf[j].x_off
    buf[i].y_off += buf[j].y_off
    for k in range(j, i):
        buf[i].x_off -= buf[k].x_adv
        buf[i].y_off -= buf[k].y_adv
