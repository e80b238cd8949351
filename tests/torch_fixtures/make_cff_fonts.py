"""CFF (OpenType 'OTTO') test fonts derived from the committed DejaVu
TrueType fonts, and golden digests of the JAX package's renders of them.

    python tests/torch_fixtures/make_cff_fonts.py [--fonts-only]

writes into ``tests/torch_fixtures/fonts_cff/``:

- ``FixtureSerifCFF.otf``: a name-keyed CFF font from DejaVuSerif (2048
  units per em, FontMatrix 1/2048): the 90 en characters and a seeded
  Latin / Greek / Cyrillic sample, the source's GSUB / GPOS / GDEF on the
  same glyph order.  Stem hints come from a small stem finder
  (``hstemhm`` / ``vstemhm`` with ``hintmask`` replacement where stems
  overlap, mid-contour replacement on some glyphs, ``cntrmask`` on a
  few), ghost hints at blue zones, blue zones from the source's alignment
  heights, local and global subroutines (the global INDEX over 1,240
  entries, so its bias is 1131; some calls nested), each flex operator on
  a few glyphs, accented glyphs as ``seac`` ``endchar``, a few glyphs
  drawn through the arithmetic operators, widths against
  ``nominalWidthX``.
- ``FixtureSansCID.otf``: a CID-keyed CFF font from DejaVuSans at the
  scale of Noto CJK: 65,535 glyphs (CIDCount 65,535), 1000 units per em
  (FontMatrix 1/1000), ROS Adobe-Identity-0, 10 FDs with distinct Private
  dicts and local Subrs (some LanguageGroup 1 with the -250 / 1100 dummy
  zones, which turn on FreeType's em-box hints), FDSelect format 3.  The
  en characters and the Greek / Cyrillic sample are real glyphs; every
  other glyph is composed from two subroutine calls (a local subr drawing
  one source glyph squeezed into the left half, with its stems, and a
  global subr drawing another into the right half), so the format 12
  cmap maps U+3400-U+4DBF and U+4E00-U+9FFF to distinct shapes while the
  file stays small.
- ``golden.npz`` (skipped with ``--fonts-only``): digests of the JAX
  package's ``draw_single_char`` / ``draw_single_char_ascender`` of the
  90 en characters at canvas 256 in both fonts and of 90 seeded CJK
  codepoints in the CID font, of ``render_adjacent_bank`` of each font
  at 128 px (en for the serif font, jp for the CID font), and of the jp
  ``make-corpus`` (128 lines of the CID font's coverage) ->
  ``make-charset --dedupe_renders`` -> ``format-dataset`` chain.

``LICENSE`` (DejaVu's, Bitstream Vera terms) and ``DERIVATION.md`` (how
the fonts derive from DejaVu and why they are renamed) sit beside them.
The CFF tables are written here, byte by byte (fontTools only wraps them
in the sfnt and subsets the source), so every operator and DICT entry is
where the tests expect it.  The output is deterministic: running the
script twice writes identical bytes.  It needs fontTools, Pillow and the
JAX package, i.e. this host.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import random
import shutil
import struct
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SRC_DIR = os.path.join(HERE, "fonts")
OUT_DIR = os.path.join(HERE, "fonts_cff")
SERIF = "FixtureSerifCFF.otf"
CID = "FixtureSansCID.otf"
FONTS = (SERIF, CID)
CANVAS = 256
BANK_SIZE = 128
N_CID_GLYPHS = 65535
CJK_RANGES = ((0x3400, 0x4DBF), (0x4E00, 0x9FFF))
CORPUS_FLAGS = ["--n_lines", "128", "--lang", "jp", "--seed", "0",
                "--noise_std", "8", "--blur_sigma", "1"]
CHARSET_FLAGS = ["--min_codepoint", "19968", "--max_chars", "160",
                 "--dedupe_renders"]
FORMAT_FLAGS = ["--cat_id", "0", "--clip_to_top_and_bottom"]


def en_chars():
    sys.path.insert(0, ROOT)
    from effocr_torch.data.builtin_charsets import english_charsets

    cs = english_charsets()
    return cs["digits"] + cs["letters"] + cs["punctuation"]


def sample_chars(seed: int, n_latin=40, n_greek=24, n_cyr=28):
    """The seeded Latin / Greek / Cyrillic sample (and the accents and
    accented letters that the serif font draws with seac)."""
    rng = random.Random(seed)
    latin = [c for c in range(0xC0, 0x180) if c not in (0xD7, 0xF7)]
    greek = [c for c in range(0x391, 0x3CA) if c != 0x3A2]
    cyr = list(range(0x410, 0x450))
    picks = (rng.sample(latin, n_latin) + rng.sample(greek, n_greek)
             + rng.sample(cyr, n_cyr))
    seac = [0xB4, 0x60, 0xA8, 0x2C6, 0x2DC, 0xE9, 0xE8, 0xEA, 0xEB, 0xE0,
            0xE1, 0xE2, 0xE4, 0xF1, 0xFC, 0xF6, 0xF3, 0xD1, 0xC9]
    return sorted(set(picks + seac))


# ------------------------------------------------------------ CFF writer
def enc_int(v: int) -> bytes:
    """A Type 2 charstring integer operand."""
    if -107 <= v <= 107:
        return bytes([v + 139])
    if 108 <= v <= 1131:
        v -= 108
        return bytes([(v >> 8) + 247, v & 0xFF])
    if -1131 <= v <= -108:
        v = -v - 108
        return bytes([(v >> 8) + 251, v & 0xFF])
    assert -32768 <= v <= 32767, v
    return b"\x1c" + struct.pack(">h", v)


def enc_fixed(v: float) -> bytes:
    return b"\xff" + struct.pack(">i", int(round(v * 65536)))


def enc_dict_int(v: int) -> bytes:
    if -1131 <= v <= 1131:
        return enc_int(v)
    if -32768 <= v <= 32767:
        return b"\x1c" + struct.pack(">h", v)
    return b"\x1d" + struct.pack(">i", v)


def enc_real(s: str) -> bytes:
    """A DICT real from its decimal text (e.g. "0.039625", "4.8e-4")."""
    nib = []
    i = 0
    while i < len(s):
        c = s[i]
        if c.isdigit():
            nib.append(int(c))
        elif c == ".":
            nib.append(0xA)
        elif c in "eE":
            if s[i + 1] == "-":
                nib.append(0xC)
                i += 1
            else:
                nib.append(0xB)
        elif c == "-":
            nib.append(0xE)
        i += 1
    nib.append(0xF)
    if len(nib) % 2:
        nib.append(0xF)
    return b"\x1e" + bytes((nib[k] << 4) | nib[k + 1]
                           for k in range(0, len(nib), 2))


def dict_bytes(entries) -> bytes:
    """entries: [(op, [operands])]; operands are ints, str (reals) or
    ("off", v) for a 5-byte int (offsets, fixed size for layout)."""
    out = b""
    for op, args in entries:
        for a in args:
            if isinstance(a, tuple):
                out += b"\x1d" + struct.pack(">i", a[1])
            elif isinstance(a, str):
                out += enc_real(a)
            else:
                out += enc_dict_int(a)
        out += bytes([12, op - 1200]) if op >= 1200 else bytes([op])
    return out


def index_bytes(items, off_size=None) -> bytes:
    if not items:
        return b"\x00\x00"
    offs = [1]
    for it in items:
        offs.append(offs[-1] + len(it))
    if off_size is None:
        last = offs[-1]
        off_size = 1 if last < 1 << 8 else 2 if last < 1 << 16 else \
            3 if last < 1 << 24 else 4
    out = struct.pack(">HB", len(items), off_size)
    for o in offs:
        out += o.to_bytes(off_size, "big")
    return out + b"".join(items)


OPS = {"hstem": 1, "vstem": 3, "vmoveto": 4, "rlineto": 5, "hlineto": 6,
       "vlineto": 7, "rrcurveto": 8, "callsubr": 10, "return": 11,
       "endchar": 14, "hstemhm": 18, "hintmask": 19, "cntrmask": 20,
       "rmoveto": 21, "hmoveto": 22, "vstemhm": 23, "rcurveline": 24,
       "rlinecurve": 25, "vvcurveto": 26, "hhcurveto": 27, "callgsubr": 29,
       "vhcurveto": 30, "hvcurveto": 31}
ESC = {"and": 3, "or": 4, "not": 5, "abs": 9, "add": 10, "sub": 11,
       "div": 12, "neg": 14, "eq": 15, "drop": 18, "put": 20, "get": 21,
       "ifelse": 22, "mul": 24, "dup": 27, "exch": 28, "index": 29,
       "roll": 30, "hflex": 34, "flex": 35, "hflex1": 36, "flex1": 37}


def encode_program(prog) -> bytes:
    """A charstring from a program list: numbers, operator names, and the
    mask bytes (``bytes``) after hintmask / cntrmask."""
    out = bytearray()
    for t in prog:
        if isinstance(t, bytes):
            out += t
        elif isinstance(t, str):
            if t in OPS:
                out.append(OPS[t])
            else:
                out += bytes([12, ESC[t]])
        elif isinstance(t, float) and t != int(t):
            out += enc_fixed(t)
        else:
            out += enc_int(int(t))
    return bytes(out)


def sid_of(name: str, strings: list) -> int:
    from fontTools.cffLib import cffStandardStrings

    std = {n: i for i, n in enumerate(cffStandardStrings)}
    if name in std:
        return std[name]
    if name not in strings:
        strings.append(name)
    return 391 + strings.index(name)


def charset_bytes(sids, fmt: int) -> bytes:
    """sids: the SIDs (or CIDs) of glyphs 1..n-1."""
    if fmt == 0:
        return b"\x00" + b"".join(struct.pack(">H", s) for s in sids)
    out = bytes([fmt])
    i = 0
    lim = 255 if fmt == 1 else 65535
    while i < len(sids):
        j = i
        while j + 1 < len(sids) and sids[j + 1] == sids[j] + 1 \
                and j + 1 - i <= lim - 1:
            j += 1
        out += struct.pack(">H", sids[i])
        out += bytes([j - i]) if fmt == 1 else struct.pack(">H", j - i)
        i = j + 1
    return out


def fdselect3(fds) -> bytes:
    ranges = []
    for g, fd in enumerate(fds):
        if not ranges or ranges[-1][1] != fd:
            ranges.append((g, fd))
    out = struct.pack(">BH", 3, len(ranges))
    for g, fd in ranges:
        out += struct.pack(">HB", g, fd)
    return out + struct.pack(">H", len(fds))


def private_entries(p) -> list:
    """Private DICT entries (without Subrs) from a dict of values."""
    def delta(v):
        out, prev = [], 0
        for x in v:
            out.append(x - prev)
            prev = x
        return out

    e = []
    for key, op in (("BlueValues", 6), ("OtherBlues", 7),
                    ("FamilyBlues", 8), ("FamilyOtherBlues", 9)):
        if p.get(key):
            e.append((op, delta(p[key])))
    for key, op in (("StdHW", 10), ("StdVW", 11)):
        if key in p:
            e.append((op, [p[key]]))
    for key, op in (("BlueScale", 1209), ("BlueShift", 1210),
                    ("BlueFuzz", 1211)):
        if key in p:
            e.append((op, [p[key]]))
    for key, op in (("StemSnapH", 1212), ("StemSnapV", 1213)):
        if p.get(key):
            e.append((op, delta(p[key])))
    for key, op in (("ForceBold", 1214), ("LanguageGroup", 1217),
                    ("ExpansionFactor", 1218)):
        if key in p:
            e.append((op, [p[key]]))
    for key, op in (("defaultWidthX", 20), ("nominalWidthX", 21)):
        if key in p:
            e.append((op, [p[key]]))
    return e


def private_block(p, subrs) -> bytes:
    """The Private DICT followed by its local Subrs INDEX."""
    e = private_entries(p)
    if subrs:
        size = len(dict_bytes(e + [(19, [("off", 0)])]))
        return dict_bytes(e + [(19, [("off", size)])]) + index_bytes(subrs)
    return dict_bytes(e)


def build_cff(name: str, top_entries, strings, gsubrs, charstrings,
              charset: bytes, privates, fdselect: bytes = None) -> bytes:
    """The whole CFF table.  ``privates``: [(private dict, local subrs)]
    (one for a name-keyed font, one per FD for a CID font);
    ``top_entries`` get charset, CharStrings, Private / FDArray /
    FDSelect appended with their offsets."""
    header = bytes([1, 0, 4, 4])
    name_idx = index_bytes([name.encode("latin-1")])
    string_idx = index_bytes([s.encode("latin-1") for s in strings])
    gsubr_idx = index_bytes(gsubrs)
    cs_idx = index_bytes(charstrings)
    cid = fdselect is not None

    def top(offs):
        e = list(top_entries)
        e.append((15, [("off", offs["charset"])]))
        e.append((17, [("off", offs["cs"])]))
        if cid:
            e.append((1236, [("off", offs["fdarray"])]))
            e.append((1237, [("off", offs["fdselect"])]))
        else:
            e.append((18, [("off", offs["priv_size"]),
                           ("off", offs["priv"])]))
        return index_bytes([dict_bytes(e)], off_size=4)

    zero = {"charset": 0, "cs": 0, "fdarray": 0, "fdselect": 0,
            "priv_size": 0, "priv": 0}
    top_len = len(top(zero))
    pos = len(header) + len(name_idx) + top_len + len(string_idx) \
        + len(gsubr_idx)
    offs = dict(zero)
    offs["charset"] = pos
    pos += len(charset)
    if cid:
        offs["fdselect"] = pos
        pos += len(fdselect)
    offs["cs"] = pos
    pos += len(cs_idx)
    blocks = [private_block(p, s) for p, s in privates]
    if cid:
        # FDArray: each Font DICT names its Private block (after it)
        fd_dicts_0 = [dict_bytes([(1238, [sid_of(f"{name}-FD{i:02d}",
                                                   strings)]),
                                  (1207, [1, 0, 0, 1, 0, 0]),
                                  (18, [("off", 0), ("off", 0)])])
                      for i in range(len(blocks))]
        # the strings grew: recompute the layout once with the final INDEX
        string_idx = index_bytes([s.encode("latin-1") for s in strings])
        pos = len(header) + len(name_idx) + top_len + len(string_idx) \
            + len(gsubr_idx)
        offs["charset"] = pos
        pos += len(charset)
        offs["fdselect"] = pos
        pos += len(fdselect)
        offs["cs"] = pos
        pos += len(cs_idx)
        fd_len = len(index_bytes(fd_dicts_0, off_size=4))
        offs["fdarray"] = pos
        pos += fd_len
        fd_dicts = []
        for i, b in enumerate(blocks):
            fd_dicts.append(dict_bytes([
                (1238, [sid_of(f"{name}-FD{i:02d}", strings)]),
                (1207, [1, 0, 0, 1, 0, 0]),
                (18, [("off", len(dict_bytes(private_entries(privates[i][0])
                                             + ([(19, [("off", 0)])]
                                                if privates[i][1] else []))
                                  )), ("off", pos)])]))
            pos += len(b)
        fd_idx = index_bytes(fd_dicts, off_size=4)
        assert len(fd_idx) == fd_len
        body = header + name_idx + top(offs) + string_idx + gsubr_idx \
            + charset + fdselect + cs_idx + fd_idx + b"".join(blocks)
    else:
        offs["priv"] = pos
        dict_len = len(dict_bytes(private_entries(privates[0][0])
                                  + ([(19, [("off", 0)])]
                                     if privates[0][1] else [])))
        offs["priv_size"] = dict_len
        body = header + name_idx + top(offs) + string_idx + gsubr_idx \
            + charset + cs_idx + blocks[0]
    return body


# ------------------------------------------------------------ outlines
class _SegPen:
    """Records a glyph as contours of ('M'|'L'|'C', points) with cubic
    curves, TrueType quadratics raised exactly (then rounded)."""

    def __init__(self, scale=1.0, dx=0.0, sx=None):
        from fontTools.pens.basePen import BasePen

        outer = self

        class P(BasePen):
            def _moveTo(self, p):
                outer.contours.append([("M", [outer.t(p)])])

            def _lineTo(self, p):
                outer.contours[-1].append(("L", [outer.t(p)]))

            def _curveToOne(self, a, b, c):
                outer.contours[-1].append(
                    ("C", [outer.t(a), outer.t(b), outer.t(c)]))

            def _qCurveToOne(self, a, b):
                p0 = self._getCurrentPoint()
                c1 = (p0[0] + 2 * (a[0] - p0[0]) / 3,
                      p0[1] + 2 * (a[1] - p0[1]) / 3)
                c2 = (b[0] + 2 * (a[0] - b[0]) / 3,
                      b[1] + 2 * (a[1] - b[1]) / 3)
                self._curveToOne(c1, c2, b)

            def _closePath(self):
                pass

        self.contours = []
        self.scale = scale
        self.sx = scale if sx is None else sx
        self.dx = dx
        self.pen = P(None)

    def t(self, p):
        return (int(round(p[0] * self.sx + self.dx)),
                int(round(p[1] * self.scale)))


def glyph_contours(font, name, scale=1.0, dx=0.0, sx=None):
    from fontTools.pens.reverseContourPen import ReverseContourPen

    from fontTools.pens.recordingPen import DecomposingRecordingPen

    rec = _SegPen(scale, dx, sx)
    gs = font.getGlyphSet()
    flat = DecomposingRecordingPen(gs)
    gs[name].draw(flat)
    flat.replay(ReverseContourPen(rec.pen))
    out = []
    for c in rec.contours:
        start = c[0][1][0]
        segs = [s for s in c[1:]]
        # drop degenerate segments and a final line back to the start
        clean = []
        cur = start
        for op, pts in segs:
            if op == "L" and pts[0] == cur:
                continue
            clean.append((op, pts))
            cur = pts[-1]
        if clean and clean[-1][0] == "L" and clean[-1][1][0] == start:
            clean.pop()
        if len(clean) >= 2 or (clean and clean[0][0] == "C"):
            out.append((start, clean))
    return out


def _flatten(contours):
    polys = []
    for start, segs in contours:
        pts = [start]
        cur = start
        for op, p in segs:
            if op == "L":
                pts.append(p[0])
            else:
                for k in range(1, 9):
                    t = k / 8
                    u = 1 - t
                    pts.append(tuple(u ** 3 * cur[i] + 3 * u * u * t * p[0][i]
                                     + 3 * u * t * t * p[1][i]
                                     + t ** 3 * p[2][i] for i in range(2)))
            cur = p[-1]
        polys.append(pts)
    return polys


def _inside(polys, x, y) -> bool:
    wind = 0
    for pts in polys:
        n = len(pts)
        for i in range(n):
            (x0, y0), (x1, y1) = pts[i], pts[(i + 1) % n]
            side = (x1 - x0) * (y - y0) - (x - x0) * (y1 - y0)
            if y0 <= y < y1 and side > 0:
                wind += 1
            elif y1 <= y < y0 and side < 0:
                wind -= 1
    return wind != 0


def find_stems(contours, upem, axis, zones=()):
    """Stems along ``axis`` (1: horizontal edges -> hstems, 0: vertical):
    [(lo, hi, contour ids)], and ghost edges in ``zones``."""
    a, b = axis, 1 - axis
    edges = []
    for ci, (start, segs) in enumerate(contours):
        cur = start
        n = len(segs)
        for si, (op, p) in enumerate(segs):
            end = p[-1]
            if op == "L" and end[a] == cur[a] and abs(end[b] - cur[b]) \
                    >= upem // 40:
                edges.append((end[a], min(end[b], cur[b]),
                              max(end[b], cur[b]), ci))
            if op == "C":
                nxt = segs[(si + 1) % n]
                nxt_first = nxt[1][0] if si + 1 < n else segs[0][1][0]
                if p[1][a] == end[a] and nxt_first[a] == end[a] and \
                        nxt[0] == "C":
                    edges.append((end[a], end[b] - upem // 100,
                                  end[b] + upem // 100, ci))
            cur = end
    polys = _flatten(contours)
    maxw = upem * 18 // 100
    stems = {}
    used = set()
    for i, (y0, l0, h0, c0) in enumerate(edges):
        best = None
        for j, (y1, l1, h1, _) in enumerate(edges):
            if y1 <= y0 or y1 - y0 > maxw:
                continue
            lo, hi = max(l0, l1), min(h0, h1)
            if lo >= hi:
                continue
            mid = (lo + hi) / 2
            pt = (mid, (y0 + y1) / 2) if axis == 1 else ((y0 + y1) / 2, mid)
            if not _inside(polys, *pt):
                continue
            if best is None or y1 - y0 < best[1] - best[0]:
                best = (y0, y1, j)
        if best is not None:
            key = (best[0], best[1])
            stems.setdefault(key, set()).update({c0, edges[best[2]][3]})
            used.update({i, best[2]})
    out = [(lo, hi, frozenset(c)) for (lo, hi), c in sorted(stems.items())]
    if axis == 1:
        for i, (y, _, _, c) in enumerate(edges):
            if i in used:
                continue
            for zlo, zhi, top in zones:
                if zlo <= y <= zhi:
                    if top:
                        out.append((y, y - 20, frozenset([c])))
                    else:
                        out.append((y + 21, y, frozenset([c])))
                    break
    # unique, sorted by position
    seen, uniq = set(), []
    for s in sorted(out, key=lambda s: (min(s[0], s[1]), s[1])):
        if (s[0], s[1]) not in seen:
            seen.add((s[0], s[1]))
            uniq.append(s)
    return uniq[:40]


def _span(s):
    lo, hi = s[0], s[1]
    if hi < lo:  # ghost: the edge alone
        return (hi, hi) if hi - lo == -21 else (lo, lo)
    return (lo, hi)


def _overlap(s, t) -> bool:
    a, b = _span(s), _span(t)
    return not (a[1] < b[0] or b[1] < a[0])


def stem_args(stems):
    args, prev = [], 0
    for lo, hi, _ in stems:
        args += [lo - prev, hi - lo]
        prev = hi
    return args


def mask_bytes(bits, n):
    out = bytearray((n + 7) // 8)
    for i in bits:
        out[i >> 3] |= 0x80 >> (i & 7)
    return bytes(out)


def _pick(stems, want):
    """Non-overlapping subset of ``want`` (indices), narrowest first."""
    chosen = []
    for i in sorted(want, key=lambda i: (abs(_span(stems[i])[1]
                                             - _span(stems[i])[0]), i)):
        if all(not _overlap(stems[i], stems[j]) for j in chosen):
            chosen.append(i)
    return sorted(chosen)


def path_program(start, segs, cur):
    """Specialized Type 2 path operators of one contour, from ``cur``."""
    from fontTools.cffLib.specializer import (commandsToProgram,
                                              specializeCommands)

    cmds = [("rmoveto", [start[0] - cur[0], start[1] - cur[1]])]
    cmds += seg_commands(segs, start)
    return commandsToProgram(specializeCommands(cmds))


def seg_commands(segs, cur):
    cmds = []
    for op, p in segs:
        if op == "L":
            cmds.append(("rlineto", [p[0][0] - cur[0], p[0][1] - cur[1]]))
        else:
            cmds.append(("rrcurveto", [p[0][0] - cur[0], p[0][1] - cur[1],
                                       p[1][0] - p[0][0], p[1][1] - p[0][1],
                                       p[2][0] - p[1][0], p[2][1] - p[1][1]]))
        cur = p[-1]
    return cmds


def chunk_program(segs, cur):
    from fontTools.cffLib.specializer import (commandsToProgram,
                                              specializeCommands)

    return commandsToProgram(specializeCommands(seg_commands(segs, cur)))


def end_point(segs, start):
    return segs[-1][1][-1] if segs else start


# ------------------------------------------------------------ glyph code
class GlyphCoder:
    """Charstrings of one font: hints, hint replacement, subroutines."""

    def __init__(self, upem, zones, n_chunk=3):
        self.upem = upem
        self.zones = zones
        self.gsubrs, self.lsubrs = [], []
        self.n_chunk = n_chunk
        self.counter = 0

    def subr(self, prog, glob) -> list:
        """A subroutine (a program, encoded once the biases are known);
        returns the reference to call it."""
        lst = self.gsubrs if glob else self.lsubrs
        lst.append(list(prog) + ["return"])
        return [("gsub" if glob else "lsub", len(lst) - 1)]

    def glyph(self, contours, width_arg, *, subrs=True, cntr=False,
              mid_replace=False, flex=None, arith=False):
        hs = find_stems(contours, self.upem, 1, self.zones)
        vs = find_stems(contours, self.upem, 0)
        replace = any(_overlap(hs[i], hs[j]) for i in range(len(hs))
                      for j in range(i)) or \
            any(_overlap(vs[i], vs[j]) for i in range(len(vs))
                for j in range(i))
        nh, n = len(hs), len(hs) + len(vs)
        prog = [] if width_arg is None else [width_arg]
        if hs:
            prog += stem_args(hs) + ["hstemhm" if replace else "hstem"]
        if vs:
            # with replacement the vstems are implied by the first mask
            prog += stem_args(vs) + ([] if replace else ["vstem"])
        if cntr and hs:
            prog += ["cntrmask", mask_bytes(range(0, nh, 2), n)]
        cur = (0, 0)
        last_mask = None
        for ci, (start, segs) in enumerate(contours):
            if replace:
                want = [i for i, s in enumerate(hs) if ci in s[2]] + \
                    [nh + i for i, s in enumerate(vs) if ci in s[2]]
                bits = _pick(hs, [i for i in want if i < nh]) + \
                    [nh + i for i in _pick(vs, [i - nh for i in want
                                                if i >= nh])]
                mb = mask_bytes(bits, n)
                if mb != last_mask:
                    prog += ["hintmask", mb]
                    last_mask = mb
            if flex is not None and ci == flex[0]:
                prog += self.flex_contour(start, segs, cur, flex[1])
                cur = end_point(segs, start)
                continue
            mv = path_program(start, [], cur)
            if arith and ci == 0:
                mv = self.arith_moveto(start)
            prog += mv
            pieces = [segs[k: k + self.n_chunk]
                      for k in range(0, len(segs), self.n_chunk)]
            p_cur = start
            calls = []
            for pi, piece in enumerate(pieces):
                if replace and mid_replace and pi == 1 and hs:
                    # mid-contour replacement: the stems of the rest
                    rest = [i for i in range(nh)
                            if i % 2 == (self.counter % 2)]
                    mb = mask_bytes(_pick(hs, rest), n)
                    if mb != last_mask:
                        calls += ["hintmask", mb]
                        last_mask = mb
                if subrs:
                    self.counter += 1
                    calls += self.subr(chunk_program(piece, p_cur),
                                       self.counter % 5 != 0)
                else:
                    calls += chunk_program(piece, p_cur)
                p_cur = piece[-1][1][-1]
            if subrs and len(calls) > 2 and ci % 3 == 2:
                # nest: a local subr calling the chunk subrs
                calls = self.subr(calls, False)
            prog += calls
            cur = end_point(segs, start)
        return prog

    def arith_moveto(self, start):
        """The first rmoveto's operands through the arithmetic and
        storage operators."""
        x, y = start
        return [x + 7, 7, "sub", 2, "mul", 2, "div",
                y, "neg", "neg", "abs" if y >= 0 else "dup",
                *([] if y >= 0 else ["drop"]),
                1, 2, "exch", "drop", "drop",
                5, 0, "put", 0, "get", "drop",
                3, 3, "eq", "drop",
                1, 1, 2, 3, "ifelse", "drop",
                11, 0, "index", "drop", "drop",
                9, 8, 2, 1, "roll", "drop", "drop",
                1, 0, "and", 1, "or", "not", "drop",
                "rmoveto"]

    def flex_contour(self, start, segs, cur, kind):
        """The contour with its longest horizontal line drawn as two
        curves through ``kind`` (flex / hflex / hflex1 / flex1)."""
        from fontTools.cffLib.specializer import (commandsToProgram,
                                                  specializeCommands)

        best, bl = None, 0
        p = start
        for i, (op, pts) in enumerate(segs):
            if op == "L" and pts[0][1] == p[1] and abs(pts[0][0] - p[0]) > bl:
                best, bl = i, abs(pts[0][0] - p[0])
            p = pts[-1]
        prog = path_program(start, [], cur)
        if best is None:
            return prog + chunk_program(segs, start)
        p0 = start if best == 0 else segs[best - 1][1][-1]
        x0, y = p0
        L = segs[best][1][0][0] - x0
        d = 6 if L > 0 else -6
        pre = segs[:best]
        if pre:
            prog += chunk_program(pre, start)
        s = L / 6
        xs = [x0 + round(s * k) for k in range(7)]
        if kind == "flex":
            pts = [(xs[1], y + 1), (xs[2], y + d), (xs[3], y + d),
                   (xs[4], y + d), (xs[5], y - 1), (xs[6], y)]
            args = []
            q = p0
            for pt in pts:
                args += [pt[0] - q[0], pt[1] - q[1]]
                q = pt
            prog += args + [50, "flex"]
        elif kind == "hflex":
            prog += [xs[1] - x0, xs[2] - xs[1], d, xs[3] - xs[2],
                     xs[4] - xs[3], xs[5] - xs[4], xs[6] - xs[5], "hflex"]
        elif kind == "hflex1":
            prog += [xs[1] - x0, 1, xs[2] - xs[1], d - 1, xs[3] - xs[2],
                     xs[4] - xs[3], xs[5] - xs[4], 1 - d, xs[6] - xs[5],
                     "hflex1"]
        else:  # flex1: the last point's y returns to the start
            pts = [(xs[1], y + 2), (xs[2], y + d), (xs[3], y + d),
                   (xs[4], y + d), (xs[5], y + 1)]
            args = []
            q = p0
            for pt in pts:
                args += [pt[0] - q[0], pt[1] - q[1]]
                q = pt
            prog += args + [xs[6] - xs[5], "flex1"]
        post = segs[best + 1:]
        if post:
            prog += commandsToProgram(specializeCommands(
                seg_commands(post, segs[best][1][0])))
        return prog


def resolve(prog, lbias, gbias, gbase=0):
    """Replace subr references by biased operands and call operators
    (``gbase``: where the coder's global subrs start in the INDEX)."""
    out = []
    for t in prog:
        if isinstance(t, tuple) and t[0] == "lsub":
            out += [t[1] - lbias, "callsubr"]
        elif isinstance(t, tuple) and t[0] == "gsub":
            out += [t[1] + gbase - gbias, "callgsubr"]
        else:
            out.append(t)
    return out


def bias(n):
    return 107 if n < 1240 else 1131 if n < 33900 else 32768


# ------------------------------------------------------------ fonts
def _rename(font, family, ps):
    for rec in font["name"].names:
        if rec.nameID in (1, 16):
            rec.string = family
        elif rec.nameID in (3, 4):
            rec.string = f"{family} Regular" if rec.nameID == 4 else \
                f"{ps};fixture"
        elif rec.nameID == 6:
            rec.string = ps
        elif rec.nameID == 5:
            rec.string = "Version 1.0 (derived from DejaVu, CFF fixture)"


def alignment_zones(font, scale=1.0):
    """BlueValues / OtherBlues from the source's alignment heights."""
    gs = font.getGlyphSet()
    cmap = font.getBestCmap()

    def box(ch):
        from fontTools.pens.boundsPen import BoundsPen

        bp = BoundsPen(gs)
        gs[cmap[ord(ch)]].draw(bp)
        return [int(round(v * scale)) for v in bp.bounds]

    base_os = min(box(c)[1] for c in "oeOs")
    x_h, x_os = box("x")[3], box("o")[3]
    cap, cap_os = box("H")[3], box("O")[3]
    asc = box("d")[3]
    asc_os = max(asc, box("f")[3])
    desc = box("p")[1]
    blues = [base_os, 0, x_h, max(x_os, x_h + 1), cap, max(cap_os, cap + 1)]
    if asc > cap_os + 2:
        blues += [asc, max(asc_os, asc + 1)]
    other = [desc - max(1, (x_os - x_h) // 2), desc]
    return blues, other


def zones_of(blues, other):
    z = [(blues[0], blues[1], False)]
    z += [(blues[i], blues[i + 1], True) for i in range(2, len(blues), 2)]
    z += [(other[i], other[i + 1], False) for i in range(0, len(other), 2)]
    return z


def build_serif(out_path: str, charset_format: int = 1):
    from fontTools import subset
    from fontTools.encodings.StandardEncoding import StandardEncoding \
        as cffStandardEncoding
    from fontTools.ttLib import TTFont

    src = TTFont(os.path.join(SRC_DIR, "DejaVuSerif.ttf"))
    opts = subset.Options()
    opts.layout_features = ["*"]
    opts.name_IDs = ["*"]
    opts.name_languages = ["*"]
    opts.notdef_outline = True
    opts.glyph_names = True
    opts.hinting = False
    opts.drop_tables += ["MATH", "FFTM", "kern", "gasp"]
    ss = subset.Subsetter(opts)
    ss.populate(unicodes=[ord(c) for c in en_chars()] + [0x20]
                + sample_chars(15))
    ss.subset(src)
    font = src
    order = font.getGlyphOrder()
    upem = font["head"].unitsPerEm
    blues, other = alignment_zones(font)
    zones = zones_of(blues, other)
    glyf = font["glyf"]
    hmtx = font["hmtx"].metrics
    widths = [hmtx[g][0] for g in order]
    default_w = max(set(widths), key=widths.count)
    nominal_w = sorted(widths)[len(widths) // 2]
    coder = GlyphCoder(upem, zones, n_chunk=2)
    std_code = {n: i for i, n in enumerate(cffStandardEncoding) if n and
                n != ".notdef"}
    strings = []
    cmap = font.getBestCmap()
    by_char = {v: k for k, v in cmap.items()}
    flex_kinds = {"E": "flex", "T": "hflex", "L": "hflex1", "Z": "flex1",
                  "F": "flex", "hyphen": "hflex", "underscore": "hflex1",
                  "I": "flex1"}
    progs = []
    seac_count = 0
    for gi, g in enumerate(order):
        w = widths[gi]
        width_arg = None if w == default_w else w - nominal_w
        gl = glyf[g]
        if gl.isComposite() and len(gl.components) == 2 and seac_count < 12:
            (b, bx, by), (a, ax, ay) = [(c.glyphName, c.x, c.y)
                                        for c in gl.components]
            ok = (bx, by) == (0, 0) and b in std_code and a in std_code \
                and not any(hasattr(c, "transform") for c in gl.components) \
                and not glyf[b].isComposite() and not glyf[a].isComposite()
            if ok:
                seac_count += 1
                prog = ([] if width_arg is None else [width_arg]) + \
                    [ax, ay, std_code[b], std_code[a], "endchar"]
                progs.append(prog)
                continue
        contours = glyph_contours(font, g)
        ch = chr(by_char[g]) if g in by_char else ""
        kw = {}
        if g in flex_kinds and contours:
            kw["flex"] = (0, flex_kinds[g])
        if g in ("E", "m", "three", "equal", "H", "B"):
            kw["cntr"] = True
        if ch and ch in "aegsxkAKRSW&":
            kw["mid_replace"] = True
        if g in ("n", "o", "zero", "O", "u"):
            kw["arith"] = True
        kw["subrs"] = g not in ("v", "w", "y", "Q") and "flex" not in kw
        prog = coder.glyph(contours, width_arg, **kw) + ["endchar"]
        progs.append(prog)
    gb, lb = bias(len(coder.gsubrs)), bias(len(coder.lsubrs))
    charstrings = [encode_program(resolve(p, lb, gb)) for p in progs]
    lsubrs = [encode_program(resolve(p, lb, gb)) for p in coder.lsubrs]
    gsubrs = [encode_program(resolve(p, lb, gb)) for p in coder.gsubrs]
    sids = [sid_of(g, strings) for g in order[1:]]
    ps = "FixtureSerifCFF-Regular"
    top = [(0, [sid_of("1.0", strings)]),
           (1, [sid_of("Derived from DejaVu Serif (Bitstream Vera "
                       "licence); CFF test fixture", strings)]),
           (2, [sid_of("Fixture Serif CFF", strings)]),
           (3, [sid_of("Fixture Serif CFF", strings)]),
           (1207, ["4.8828125e-4", 0, 0, "4.8828125e-4", 0, 0]),
           (5, list(_bbox(font)))]
    priv = {"BlueValues": blues, "OtherBlues": other,
            "FamilyBlues": [b + 1 for b in blues],
            "FamilyOtherBlues": [b - 1 for b in other],
            "BlueScale": "0.0375", "BlueShift": 7, "BlueFuzz": 1,
            "StdHW": 141, "StdVW": 172, "StemSnapH": [129, 141, 156],
            "StemSnapV": [160, 172, 190], "ExpansionFactor": "0.06",
            "defaultWidthX": default_w, "nominalWidthX": nominal_w}
    cff = build_cff(ps, top, strings, gsubrs, charstrings,
                    charset_bytes(sids, charset_format),
                    [(priv, lsubrs)])
    _wrap_otf(font, cff, "Fixture Serif CFF", ps)
    font.recalcTimestamp = False
    font.recalcBBoxes = False
    font.save(out_path, reorderTables=True)
    return {"glyphs": len(order), "gsubrs": len(gsubrs),
            "lsubrs": len(lsubrs), "seac": seac_count}


def _bbox(font):
    h = font["head"]
    return h.xMin, h.yMin, h.xMax, h.yMax


def _wrap_otf(font, cff: bytes, family: str, ps: str):
    from fontTools.ttLib.tables.DefaultTable import DefaultTable

    for t in ("glyf", "loca", "fpgm", "prep", "cvt ", "gasp", "hdmx",
              "LTSH", "VDMX", "kern"):
        if t in font:
            del font[t]
    font.sfntVersion = "OTTO"
    tab = DefaultTable("CFF ")
    tab.data = cff
    font["CFF "] = tab
    font["maxp"].tableVersion = 0x5000
    post = font["post"]
    post.formatType = 3.0
    _rename(font, family, ps)


def _component_sources(font, n):
    """``n`` source glyphs (letters of Latin, Greek and Cyrillic) for the
    composed CID glyphs, in a fixed order."""
    cmap = font.getBestCmap()
    cps = [c for r in ((0x41, 0x5B), (0x61, 0x7B), (0x391, 0x3AA),
                       (0x3B1, 0x3CA), (0x410, 0x450), (0x30, 0x3A),
                       (0x100, 0x250), (0x460, 0x530), (0x1E00, 0x1F00))
           for c in range(*r) if c in cmap]
    out, seen = [], set()
    for c in cps:
        if cmap[c] not in seen:
            seen.add(cmap[c])
            out.append(cmap[c])
    assert len(out) >= n, len(out)
    return out[:n]


def _squeeze(font, name, x_left):
    """The source glyph squeezed into a half of the 1000-unit em."""
    from fontTools.pens.boundsPen import BoundsPen

    gs = font.getGlyphSet()
    bp = BoundsPen(gs)
    gs[name].draw(bp)
    x0 = bp.bounds[0] if bp.bounds else 0
    return glyph_contours(font, name, scale=0.415, sx=0.22,
                          dx=x_left - 0.22 * x0), 80


def _shift_y(contours, dy):
    return [((s[0], s[1] + dy), [(op, [(x, y + dy) for x, y in pts])
                                 for op, pts in segs])
            for s, segs in contours]


# per FD of the composed glyphs: the Private dict's own values
_CJK_ZONES = [68, 80, 545, 557, 700, 712]
CID_FD_PRIVATE = [
    {"LanguageGroup": 1, "BlueValues": [-250, -250, 1100, 1100],
     "StdHW": 40, "StdVW": 48, "nominalWidthX": 900},
    {"LanguageGroup": 1, "StdHW": 44, "StdVW": 52, "nominalWidthX": 1000},
    {"BlueValues": _CJK_ZONES, "BlueScale": "0.039625", "BlueShift": 7,
     "BlueFuzz": 1, "StdHW": 40, "StdVW": 48, "nominalWidthX": 980},
    {"BlueValues": _CJK_ZONES, "BlueScale": "0.1", "BlueShift": 0,
     "StdHW": 38, "StdVW": 46, "nominalWidthX": 1020},
    {"BlueValues": _CJK_ZONES, "BlueScale": "0.02", "BlueShift": 12,
     "BlueFuzz": 0, "StdHW": 42, "StdVW": 50, "nominalWidthX": 960},
    {"LanguageGroup": 1, "BlueValues": _CJK_ZONES, "StdHW": 40,
     "StdVW": 48, "nominalWidthX": 1000},
    {"BlueValues": _CJK_ZONES, "OtherBlues": [-130, -120],
     "ForceBold": 1, "ExpansionFactor": "0.07", "StdHW": 46,
     "StdVW": 56, "nominalWidthX": 1040},
    {"BlueValues": _CJK_ZONES, "FamilyBlues": [66, 79, 546, 556, 701, 711],
     "FamilyOtherBlues": [-131, -119], "OtherBlues": [-130, -120],
     "BlueFuzz": 2, "StdHW": 40, "StdVW": 48, "nominalWidthX": 1000},
    {"BlueValues": [68, 80, 300, 310, 545, 557, 700, 712, 760, 770],
     "StemSnapH": [36, 40, 44], "StemSnapV": [44, 48, 54],
     "BlueScale": "0.05", "StdHW": 40, "StdVW": 48,
     "nominalWidthX": 1000},
]
N_LOCAL = 40
N_GLOBAL = 200


def build_cid(out_path: str):
    from fontTools.fontBuilder import FontBuilder
    from fontTools.ttLib import TTFont
    from fontTools.ttLib.tables._c_m_a_p import CmapSubtable

    src = TTFont(os.path.join(SRC_DIR, "DejaVuSans.ttf"))
    s = 1000 / 2048
    scmap = src.getBestCmap()
    real = [ord(c) for c in en_chars()] + [0x20] + \
        [c for c in sample_chars(16) if c >= 0x370]
    real = [c for c in dict.fromkeys(real) if c in scmap]
    upem = 1000
    blues, other = alignment_zones(src, s)
    zones = zones_of(blues, other)
    fd0 = {"BlueValues": blues, "OtherBlues": other, "BlueScale": "0.039625",
           "BlueShift": 7, "BlueFuzz": 1, "StdHW": 69, "StdVW": 90,
           "StemSnapH": [62, 69], "StemSnapV": [84, 90],
           "defaultWidthX": 0, "nominalWidthX": 0}
    privates = [fd0] + [dict(p, defaultWidthX=1000)
                        for p in CID_FD_PRIVATE]
    n_fd = len(privates)
    # real glyphs: gid 1..R, FD 0, drawn through a GlyphCoder
    coder = GlyphCoder(upem, zones, n_chunk=3)
    hmtx = {}
    order = [".notdef"] + [f"cid{g:05d}" for g in range(1, N_CID_GLYPHS)]
    progs = [[500, "endchar"]]
    hmtx[".notdef"] = (500, 0)
    cmap = {}
    for k, cp in enumerate(real):
        gid = k + 1
        name = scmap[cp]
        w = int(round(src["hmtx"][name][0] * s))
        contours = glyph_contours(src, name, scale=s)
        lsb = min([c[0][0] for c in contours] + [p[0] for c in contours
                                                  for _, pts in c[1]
                                                  for p in pts]) \
            if contours else 0
        hmtx[order[gid]] = (w, lsb)
        kw = {"cntr": cp in (0x45, 0x6D), "mid_replace": cp in (0x61, 0x53),
              "subrs": cp % 4 != 0}
        progs.append(coder.glyph(contours, w, **kw) + ["endchar"])
        cmap[cp] = gid
    n_real = len(real) + 1
    # composed glyphs: contiguous FD ranges over the rest
    sources = _component_sources(src, N_GLOBAL + N_LOCAL * (n_fd - 1))
    g_comps = []
    for name in sources[:N_GLOBAL]:
        contours, dy = _squeeze(src, name, 520)
        contours = _shift_y(contours, dy)
        cur = (0, 0)
        prog = []
        for start, segs in contours:
            prog += path_program(start, segs, cur)
            cur = end_point(segs, start)
        g_comps.append(prog + ["return"])
    local_progs = [list(coder.lsubrs)]
    for fd in range(1, n_fd):
        lst = []
        fz = privates[fd].get("BlueValues", [])
        fzones = zones_of(fz, privates[fd].get("OtherBlues", [])) \
            if fz and fz[0] > -200 else ()
        comp = GlyphCoder(upem, fzones)
        for j in range(N_LOCAL):
            name = sources[N_GLOBAL + (fd - 1) * N_LOCAL + j]
            contours, dy = _squeeze(src, name, 40)
            contours = _shift_y(contours, dy)
            prog = comp.glyph(contours, None, subrs=False,
                              mid_replace=(j % 7 == 3))
            cur = end_point(contours[-1][1], contours[-1][0]) \
                if contours else (0, 0)
            # back to the origin, where the global component starts
            prog += [-cur[0], -cur[1], "rmoveto", "return"]
            lst.append(prog)
        local_progs.append(lst)
    n_comp = N_CID_GLYPHS - n_real
    per_fd = -(-n_comp // (n_fd - 1))
    fds = [0] * n_real
    gbase = len(g_comps)
    lb0 = bias(len(coder.lsubrs))
    gsub_all = g_comps + coder.gsubrs
    gb = bias(len(gsub_all))
    charstrings = [encode_program(resolve(p, lb0, gb, gbase))
                   for p in progs]
    for k in range(n_comp):
        fd = 1 + k // per_fd
        i = k % per_fd
        a, b = i % N_LOCAL, (i // N_LOCAL) % N_GLOBAL
        lb = bias(N_LOCAL)
        charstrings.append(encode_program(
            [a - lb, "callsubr", b - gb, "callgsubr", "endchar"]))
        fds.append(fd)
        hmtx[order[n_real + k]] = (1000, 40)
    cps = [c for lo, hi in CJK_RANGES for c in range(lo, hi + 1)]
    for k, cp in enumerate(cps):
        cmap[cp] = n_real + k
    gsubrs = [encode_program(resolve(p, lb0, gb, gbase)) for p in gsub_all]
    lsubrs = [[encode_program(resolve(p, lb0, gb, gbase))
               for p in local_progs[0]]] + \
        [[encode_program(p) for p in lst] for lst in local_progs[1:]]
    strings = []
    ps = "FixtureSansCID-Regular"
    top = [(1230, [sid_of("Adobe", strings), sid_of("Identity", strings),
                   0]),
           (0, [sid_of("1.0", strings)]),
           (1, [sid_of("Derived from DejaVu Sans (Bitstream Vera "
                       "licence); CFF test fixture", strings)]),
           (2, [sid_of("Fixture Sans CID", strings)]),
           (3, [sid_of("Fixture Sans CID", strings)]),
           (1207, ["0.001", 0, 0, "0.001", 0, 0]),
           (5, [-1021, -415, 1681, 1167]),
           (1234, [N_CID_GLYPHS])]
    charset = b"\x02" + struct.pack(">HH", 1, N_CID_GLYPHS - 2)
    cff = build_cff(ps, top, strings, gsubrs, charstrings, charset,
                    list(zip(privates, lsubrs)), fdselect3(fds))
    fb = FontBuilder(upem, isTTF=False)
    fb.setupGlyphOrder(order)
    fb.setupCharacterMap({})
    sub4 = CmapSubtable.newSubtable(4)
    sub4.platformID, sub4.platEncID, sub4.language = 3, 1, 0
    sub4.cmap = {cp: order[g] for cp, g in cmap.items()}
    sub12 = CmapSubtable.newSubtable(12)
    sub12.platformID, sub12.platEncID, sub12.language = 3, 10, 0
    sub12.cmap = dict(sub4.cmap)
    fb.font["cmap"].tables = [sub4, sub12]
    fb.setupHorizontalMetrics(hmtx)
    asc, desc = int(round(1901 * s)), int(round(-483 * s))
    fb.setupHorizontalHeader(ascent=asc, descent=desc)
    fb.setupNameTable({"familyName": "Fixture Sans CID",
                       "styleName": "Regular", "psName": ps,
                       "version": "Version 1.0 (derived from DejaVu, "
                                  "CFF fixture)",
                       "copyright": src["name"].getDebugName(0)})
    fb.setupOS2(sTypoAscender=asc, sTypoDescender=desc, sTypoLineGap=0,
                usWinAscent=asc, usWinDescent=-desc, fsSelection=0x40,
                achVendID="NONE")
    fb.setupPost(isFixedPitch=0)
    fb.setupHead(unitsPerEm=upem, created=0, modified=0)
    from fontTools.ttLib.tables.DefaultTable import DefaultTable

    tab = DefaultTable("CFF ")
    tab.data = cff
    fb.font["CFF "] = tab
    fb.setupMaxp()
    h = fb.font["head"]
    h.xMin, h.yMin, h.xMax, h.yMax = -1021, -415, 1681, 1167
    fb.font["hhea"].advanceWidthMax = max(w for w, _ in hmtx.values())
    fb.font.sfntVersion = "OTTO"
    fb.font.recalcTimestamp = False
    fb.font.recalcBBoxes = False
    fb.font.save(out_path)
    return {"glyphs": len(order), "real": n_real, "fds": n_fd,
            "gsubrs": len(gsubrs), "bytes": os.path.getsize(out_path)}


def probe_font(path: str, top_entries, charstrings, private=None,
               gsubrs=(), lsubrs=(), fds=None, fdselect_format=3):
    """A small CFF font (1000 units per em) around the given Top DICT
    entries and charstring programs, for the tests' probes: name-keyed,
    or with ``fds`` (each glyph's FD) CID-keyed, ``private`` then a list
    of (Private dict, local subr programs) per FD."""
    from fontTools.fontBuilder import FontBuilder
    from fontTools.ttLib.tables.DefaultTable import DefaultTable

    strings = []
    order = [".notdef"] + [f"g{i}" for i in range(1, len(charstrings))]
    progs = [encode_program(p) for p in charstrings]
    gs = [encode_program(p) for p in gsubrs]
    if fds is None:
        cff = build_cff("Probe", list(top_entries), strings, gs, progs,
                        charset_bytes([sid_of(g, strings)
                                       for g in order[1:]], 0),
                        [(private or {}, [encode_program(p)
                                          for p in lsubrs])])
    else:
        top = [(1230, [sid_of("Adobe", strings), sid_of("Identity", strings),
                       0]), (1207, ["0.001", 0, 0, "0.001", 0, 0]),
               (1234, [len(charstrings)])] + list(top_entries)
        fdsel = fdselect3(fds) if fdselect_format == 3 \
            else bytes([0]) + bytes(fds)
        cff = build_cff("Probe", top, strings, gs, progs,
                        charset_bytes(list(range(1, len(charstrings))), 2),
                        [(p, [encode_program(x) for x in subs])
                         for p, subs in private], fdsel)
    fb = FontBuilder(1000, isTTF=False)
    fb.setupGlyphOrder(order)
    fb.setupCharacterMap({})
    fb.setupHorizontalMetrics({g: (500, 0) for g in order})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "Probe", "styleName": "Regular"})
    fb.setupOS2()
    fb.setupPost()
    fb.setupHead(unitsPerEm=1000, created=0, modified=0)
    tab = DefaultTable("CFF ")
    tab.data = cff
    fb.font["CFF "] = tab
    fb.setupMaxp()
    fb.font.sfntVersion = "OTTO"
    fb.font.recalcBBoxes = False
    fb.font.recalcTimestamp = False
    fb.save(path)
    return cff


# ------------------------------------------------------------ goldens
def cjk_sample(n: int = 90):
    """The seeded CJK codepoints whose renders the goldens hold."""
    rng = random.Random(90)
    return sorted(rng.sample(range(0x4E00, 0xA000), n))


def render_cases():
    """(font file, kind, codepoint) of every render golden."""
    out = []
    for name in FONTS:
        for c in en_chars():
            for kind in ("single", "ascender"):
                out.append((name, kind, ord(c)))
    out += [(CID, "single", cp) for cp in cjk_sample()]
    return out


BANKS = ((SERIF, "en"), (CID, "jp"))


def file_digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def pipeline_outputs(work: str, font_dir: str, run) -> dict:
    """The jp make-corpus -> make-charset -> format-dataset chain into
    ``work`` through ``run(command, argv)`` over ``font_dir`` (the CID
    font alone); the digests of what it wrote."""
    from effocr_torch.data.imaging import digest_tree

    corpus = os.path.join(work, "corpus")
    run("make-corpus", ["--out_dir", corpus, "--font_dir", font_dir,
                        *CORPUS_FLAGS])
    charsets = os.path.join(work, "charsets_jp")
    run("make-charset", ["--font_dir", font_dir, "--out",
                         os.path.join(charsets, "jp_chars.txt"),
                         *CHARSET_FLAGS])
    run("format-dataset", ["--image_dir", os.path.join(corpus, "images"),
                           "--coco_jsons",
                           os.path.join(corpus, "corpus.json"),
                           "--crops_save_dir", os.path.join(work, "crops"),
                           "--font_dir", font_dir, "--charset_dir", charsets,
                           "--dataset_save_dir", os.path.join(work, "tree"),
                           *FORMAT_FLAGS])
    return {
        "corpus_json": file_digest(os.path.join(corpus, "corpus.json")),
        "corpus_images": digest_tree(os.path.join(corpus, "images")),
        "charset": file_digest(os.path.join(charsets, "jp_chars.txt")),
        "dataset_tree": digest_tree(os.path.join(work, "tree")),
        "dataset_crops": digest_tree(os.path.join(work, "crops")),
    }


def run_jax(module, argv):
    old = sys.argv
    sys.argv = [module.__name__] + list(argv)
    try:
        module.main()
    finally:
        sys.argv = old


def write_goldens(out_path: str):
    sys.path.insert(0, ROOT)
    from PIL import ImageFont

    from effocr_tpu.cli import format_dataset, make_charset, make_corpus
    from effocr_tpu.data import fonts as J
    from effocr_torch.data.imaging import digest_image

    keys, digests = [], []
    fonts = {n: ImageFont.truetype(os.path.join(OUT_DIR, n), size=CANVAS)
             for n in FONTS}
    for name, kind, cp in render_cases():
        fn = J.draw_single_char if kind == "single" else \
            J.draw_single_char_ascender
        img = fn(chr(cp), fonts[name], CANVAS)
        keys.append(f"{name}|{kind}|{cp}")
        digests.append("none" if img is None else digest_image(
            np.asarray(img), img.mode))
    out = {"render_keys": np.array(keys), "render_digests": np.array(digests)}
    for name, lang in BANKS:
        bank = J.render_adjacent_bank(os.path.join(OUT_DIR, name), BANK_SIZE,
                                      lang)
        out[f"bank_{lang}"] = np.array(digest_image(bank, "L"))
    mods = {"make-corpus": make_corpus, "make-charset": make_charset,
            "format-dataset": format_dataset}
    work = tempfile.mkdtemp()
    try:
        fonts_dir = os.path.join(work, "fonts")
        os.makedirs(fonts_dir)
        shutil.copy(os.path.join(OUT_DIR, CID), fonts_dir)
        res = pipeline_outputs(work, fonts_dir,
                               lambda cmd, argv: run_jax(mods[cmd], argv))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out.update({k: np.array(v) for k, v in res.items()})
    np.savez(out_path, **out)
    print(f"{len(keys)} renders, {len(out)} keys -> {out_path}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--fonts-only", action="store_true")
    p.add_argument("--out_dir", default=OUT_DIR,
                   help="where the fonts go (the goldens always render the "
                        "committed fonts in tests/torch_fixtures/fonts_cff)")
    args = p.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    info = build_serif(os.path.join(args.out_dir, SERIF))
    print("serif", info)
    info = build_cid(os.path.join(args.out_dir, CID))
    print("cid", info)
    if not args.fonts_only:
        write_goldens(os.path.join(OUT_DIR, "golden.npz"))


if __name__ == "__main__":
    main()
