"""OpenType font file reader: the sfnt tables the glyph renderer, the
shaper and the charset tools need (what fontTools gives the JAX
package's data/fonts.py, and what FreeType's sfnt loader gives Pillow).

Read: the table directory, ``head``, ``hhea``, ``maxp``, ``OS/2``,
``hmtx``, ``loca`` / ``glyf`` (raw; the glyph records are parsed by
native/glyph.cpp), ``cvt ``, ``fpgm``, ``prep``, ``GDEF``'s glyph classes
and ``cmap`` formats 0, 4, 6 and 12 (format 14 holds variation
sequences, which add no codepoint).  An ``OTTO`` font's ``CFF `` table
(name-keyed or CID-keyed) is read by fonts/cff.py.  ``gasp`` is not
read: FreeType's TrueType loader and gray renderer do not consult it.
GSUB and GPOS are kept as bytes for fonts/shaping.py.

Embedded bitmap strikes (``CBLC``, ``EBLC``, ``bloc`` or ``sbix``, the
one FreeType's sfnt loader picks) are read down to their sizes and
whether they hold any bitmap (``strikes``); ``check_size`` does what
FT_Set_Pixel_Sizes does with them (see there).  A font with ``CBLC``
strikes or an ``sbix`` table, or without outlines, is not scalable, as
in FreeType.

Refused with ``NotImplementedError`` naming the feature and ROADMAP.md
queue 1: CFF2 outlines, TrueType collections, variable fonts, the sizes
at which FreeType hands back a strike's bitmaps, and TrueType fonts
without bytecode (FreeType renders those through its auto-hinter).
"""

from __future__ import annotations

import functools
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

ROADMAP = "not rendered by effocr_torch (ROADMAP.md, queue 1)"


def refuse(feature: str, path: str) -> NotImplementedError:
    return NotImplementedError(f"{feature} in {path}: {ROADMAP}")


class Font:
    """The parsed tables of one TrueType or CFF OpenType font file
    (``cff`` is the parsed ``CFF `` table, None for TrueType)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < 12:
            raise OSError(f"not a font file: {path}")
        tag = data[:4]
        if tag == b"ttcf":
            raise refuse("TrueType collections (TTC)", path)
        if tag not in (b"\x00\x01\x00\x00", b"true", b"OTTO"):
            raise OSError(f"unknown font format {tag!r}: {path}")
        n_tables = struct.unpack(">H", data[4:6])[0]
        self.tables: Dict[str, bytes] = {}
        for i in range(n_tables):
            rec = data[12 + 16 * i: 28 + 16 * i]
            t, _, off, length = struct.unpack(">4sIII", rec)
            self.tables[t.decode("latin-1")] = data[off: off + length]
        t = self.tables
        if "CFF2" in t:
            raise refuse("CFF2 outlines (OpenType 'CFF2')", path)
        if "fvar" in t or "gvar" in t:
            raise refuse("variable fonts (fvar / gvar)", path)
        self.cff = None
        self._read_strikes()
        has_outlines = "glyf" in t or "CFF " in t
        # sfnt_load_face: CBLC strikes or an sbix table make the face
        # bitmap-only, as a missing glyf / CFF does
        self.scalable = has_outlines and self.sbit_table != "CBLC" \
            and "sbix" not in t
        # a strikes-only font has no outline tables to read
        outlines = () if not has_outlines and self.strikes else \
            ("loca", "glyf") if "glyf" in t or "CFF " not in t else ("CFF ",)
        for name in ("head", "hhea", "maxp", "hmtx", "cmap") + outlines:
            if name not in t:
                raise OSError(f"font without a '{name}' table: {path}")
        self._read_head()
        self._read_maxp()
        self._read_hhea_hmtx()
        self._read_os2()
        if outlines == ("CFF ",):
            from effocr_torch.fonts.cff import CFF

            self.cff = CFF(t["CFF "], self.units_per_em, path)
            self.num_glyphs = self.cff.num_glyphs
        elif outlines:
            self._read_loca()
            self.cvt = np.frombuffer(t.get("cvt ", b""),
                                     ">i2").astype(np.int16)
            self.fpgm = t.get("fpgm", b"")
            self.prep = t.get("prep", b"")
            if self.max_size_of_instructions == 0 and not self.fpgm \
                    and not self.prep and self.scalable:
                raise refuse("TrueType fonts without bytecode (FreeType's "
                             "auto-hinter)", path)
        self.gsub = t.get("GSUB")
        self.gpos = t.get("GPOS")
        self.glyph_class = self._read_gdef_classes()
        self.cmap = self._read_cmap()

    # ------------------------------------------------------------ strikes
    def _read_strikes(self):
        """``sbit_table``: the strike table FreeType's tt_face_load_sbit
        picks (CBLC, else EBLC, else bloc, else sbix; the first three
        only with a CBDT, EBDT or bdat table to read from); ``strikes``:
        its [(x_ppem, y_ppem, holds a bitmap)], in file order."""
        t = self.tables
        self.sbit_table, self.strikes = None, []
        name = next((n for n in ("CBLC", "EBLC", "bloc", "sbix") if n in t),
                    None)
        if name is None or (name != "sbix" and not any(
                d in t for d in ("CBDT", "EBDT", "bdat"))):
            return
        self.sbit_table = name
        self.strikes = _sbix_strikes(t[name]) if name == "sbix" else \
            _bloc_strikes(t[name])

    def check_size(self, ppem: int) -> None:
        """What FT_Set_Pixel_Sizes(face, 0, ppem) and the glyph loads after
        it do, as Pillow's ``truetype`` calls them: tt_size_request
        selects the first strike whose x and y ppem both equal ``ppem``
        (FT_Match_Size); where that strike holds bitmaps (or the face has
        no outlines) FreeType hands them back instead of outlines, which
        the port refuses.  A face without outlines and without a strike
        at ``ppem`` fails with FreeType's "invalid pixel size"."""
        for x, y, has in self.strikes:
            if x == ppem and y == ppem:
                if has or not self.scalable:
                    raise refuse(f"embedded bitmap strikes ({self.sbit_table}"
                                 f" at {ppem} ppem)", self.path)
                return
        if not self.scalable:
            raise OSError(f"invalid pixel size: {self.path} has no scalable "
                          f"outlines and no strike at {ppem} ppem")

    # ------------------------------------------------------------ tables
    def _read_head(self):
        h = self.tables["head"]
        self.head_flags = struct.unpack(">H", h[16:18])[0]
        self.units_per_em = struct.unpack(">H", h[18:20])[0]
        self.index_to_loc = struct.unpack(">h", h[50:52])[0]

    def _read_maxp(self):
        m = self.tables["maxp"]
        self.num_glyphs = struct.unpack(">H", m[4:6])[0]
        if len(m) >= 32:
            (self.max_zones, self.max_twilight, self.max_storage,
             self.max_fdefs, self.max_idefs, self.max_stack,
             self.max_size_of_instructions) = struct.unpack(
                 ">7H", m[14:28])
        else:
            self.max_zones = self.max_twilight = self.max_storage = 0
            self.max_fdefs = self.max_idefs = self.max_stack = 0
            self.max_size_of_instructions = 0

    def _read_hhea_hmtx(self):
        h = self.tables["hhea"]
        (self.hhea_ascender, self.hhea_descender, self.hhea_line_gap
         ) = struct.unpack(">hhh", h[4:10])
        self.advance_width_max = struct.unpack(">H", h[10:12])[0]
        n_long = struct.unpack(">H", h[34:36])[0]
        mt = self.tables["hmtx"]
        longs = np.frombuffer(mt[: 4 * n_long], ">u2").reshape(-1, 2)
        self.advances = longs[:, 0].astype(np.uint16)
        lsb = longs[:, 1].astype(np.int16)
        extra = np.frombuffer(
            mt[4 * n_long: 4 * n_long
               + 2 * max(0, self.num_glyphs - n_long)], ">i2")
        self.lsbs = np.concatenate([lsb, extra.astype(np.int16)])

    def _read_os2(self):
        o = self.tables.get("OS/2")
        self.os2_version = None
        if o is not None and len(o) >= 78:
            self.os2_version = struct.unpack(">H", o[0:2])[0]
            self.fs_selection = struct.unpack(">H", o[62:64])[0]
            (self.typo_ascender, self.typo_descender, self.typo_line_gap,
             self.win_ascent, self.win_descent) = struct.unpack(
                 ">hhhHH", o[68:78])

    def _read_loca(self):
        lo = self.tables["loca"]
        n = self.num_glyphs + 1
        if self.index_to_loc == 0:
            off = np.frombuffer(lo[: 2 * n], ">u2").astype(np.uint32) * 2
        else:
            off = np.frombuffer(lo[: 4 * n], ">u4").astype(np.uint32)
        if len(off) < n:
            off = np.concatenate([off, np.full(n - len(off), off[-1],
                                               np.uint32)])
        self.loca = np.ascontiguousarray(off, np.uint32)

    def _read_gdef_classes(self) -> Dict[int, int]:
        g = self.tables.get("GDEF")
        if not g:
            return {}
        off = struct.unpack(">H", g[4:6])[0]
        return read_class_def(g, off) if off else {}

    def _read_cmap(self) -> Dict[int, int]:
        """Every subtable into ``cmap_subtables``; returns the charmap
        FreeType selects (``unicode_cmap``)."""
        c = self.tables["cmap"]
        n = struct.unpack(">H", c[2:4])[0]
        self.cmap_subtables: List[Tuple[int, int, Dict[int, int]]] = []
        seen = {}
        for i in range(n):
            pid, eid, off = struct.unpack(">HHI", c[4 + 8 * i: 12 + 8 * i])
            if off not in seen:
                seen[off] = _cmap_subtable(c, off)
            if seen[off] is not None:
                self.cmap_subtables.append((pid, eid, seen[off]))
        return self.unicode_cmap()

    def unicode_cmap(self) -> Dict[int, int]:
        """The charmap FreeType selects for a Unicode font: the UCS-4
        subtable (3,10 or 0,4/0,6) if there is one, else the first
        Unicode BMP subtable (3,1 or 0,x)."""
        best = None
        for pid, eid, m in self.cmap_subtables:
            if (pid, eid) in ((3, 10), (0, 4), (0, 6)):
                return m
        for pid, eid, m in self.cmap_subtables:
            if pid == 0 or (pid, eid) == (3, 1):
                best = m
                break
        return best if best is not None else {}

    def coverage(self) -> List[int]:
        """Sorted codepoints over the union of all cmap subtables
        (``get_unicode_coverage_from_ttf``)."""
        cps = set()
        for _, _, m in self.cmap_subtables:
            cps.update(m)
        return sorted(cps)


def _bloc_strikes(d: bytes) -> List[Tuple[int, int, bool]]:
    """The bitmapSize records of an EBLC / CBLC / bloc table, as
    tt_face_load_sbit reads them (version 2 or 3, either byte order of
    it; as many records as the table holds)."""
    if len(d) < 8:
        return []
    version, n = struct.unpack(">II", d[:8])
    if (version & 0xFFFF0000) not in (0x20000, 0x30000) and \
            (version & 0xFFFF) not in (0x200, 0x300):
        return []
    if n >= 0x10000:
        return []
    out = []
    for i in range(min(n, (len(d) - 8) // 48)):
        rec = d[8 + 48 * i: 56 + 48 * i]
        arr, _, n_sub = struct.unpack(">III", rec[:12])
        out.append((rec[44], rec[45], _holds_bitmaps(d, arr, n_sub)))
    return out


def _holds_bitmaps(d: bytes, arr: int, n_sub: int) -> bool:
    """Whether any index subtable of a strike gives a glyph a non-empty
    image (tt_sbit_decoder_load_image: equal offsets are a missing
    glyph, which falls back to the outline)."""
    try:
        for j in range(n_sub):
            first, last, add = struct.unpack(">HHI",
                                             d[arr + 8 * j: arr + 8 * j + 8])
            sub = arr + add
            fmt = struct.unpack(">H", d[sub: sub + 2])[0]
            n = last - first + 1
            if n <= 0:
                continue
            if fmt in (1, 3):
                code, size = (">I", 4) if fmt == 1 else (">H", 2)
                offs = struct.unpack(f">{n + 1}{code[1]}",
                                     d[sub + 8: sub + 8 + size * (n + 1)])
                if any(a != b for a, b in zip(offs, offs[1:])):
                    return True
            elif fmt == 2:
                if struct.unpack(">I", d[sub + 8: sub + 12])[0]:
                    return True
            elif fmt == 4:
                k = struct.unpack(">I", d[sub + 8: sub + 12])[0]
                pairs = struct.unpack(f">{2 * (k + 1)}H",
                                      d[sub + 12: sub + 12 + 4 * (k + 1)])
                if any(a != b for a, b in zip(pairs[1::2], pairs[3::2])):
                    return True
            elif fmt == 5:
                size = struct.unpack(">I", d[sub + 8: sub + 12])[0]
                k = struct.unpack(">I", d[sub + 20: sub + 24])[0]
                if size and k:
                    return True
    except struct.error:
        return False
    return False


def _sbix_strikes(d: bytes) -> List[Tuple[int, int, bool]]:
    """The strikes of an sbix table (version >= 1, flags 1 or 3), each
    holding its glyphs' images."""
    if len(d) < 8:
        return []
    version, flags, n = struct.unpack(">HHI", d[:8])
    if version < 1 or flags not in (1, 3) or n >= 0x10000:
        return []
    out = []
    for i in range(min(n, (len(d) - 8) // 4)):
        off = struct.unpack(">I", d[8 + 4 * i: 12 + 4 * i])[0]
        if off + 4 > len(d):
            break
        ppem = struct.unpack(">H", d[off: off + 2])[0]
        out.append((ppem, ppem, True))
    return out


def read_class_def(data: bytes, off: int) -> Dict[int, int]:
    fmt = struct.unpack(">H", data[off: off + 2])[0]
    out = {}
    if fmt == 1:
        start, count = struct.unpack(">HH", data[off + 2: off + 6])
        vals = struct.unpack(f">{count}H", data[off + 6: off + 6 + 2 * count])
        for i, v in enumerate(vals):
            if v:
                out[start + i] = v
    elif fmt == 2:
        count = struct.unpack(">H", data[off + 2: off + 4])[0]
        for i in range(count):
            s, e, v = struct.unpack(
                ">HHH", data[off + 4 + 6 * i: off + 10 + 6 * i])
            if v:
                for g in range(s, e + 1):
                    out[g] = v
    return out


def _cmap_subtable(c: bytes, off: int) -> Optional[Dict[int, int]]:
    fmt = struct.unpack(">H", c[off: off + 2])[0]
    m: Dict[int, int] = {}
    if fmt == 0:
        glyphs = c[off + 6: off + 6 + 256]
        for cp, g in enumerate(glyphs):
            if g:
                m[cp] = g
    elif fmt == 4:
        segx2 = struct.unpack(">H", c[off + 6: off + 8])[0]
        n = segx2 // 2
        base = off + 14
        ends = struct.unpack(f">{n}H", c[base: base + segx2])
        starts = struct.unpack(f">{n}H", c[base + segx2 + 2:
                                            base + 2 * segx2 + 2])
        deltas = struct.unpack(f">{n}h", c[base + 2 * segx2 + 2:
                                            base + 3 * segx2 + 2])
        ro_base = base + 3 * segx2 + 2
        ros = struct.unpack(f">{n}H", c[ro_base: ro_base + segx2])
        for i in range(n):
            s, e, d, ro = starts[i], ends[i], deltas[i], ros[i]
            if s == 0xFFFF and e == 0xFFFF:
                continue
            for cp in range(s, e + 1):
                if ro == 0:
                    g = (cp + d) & 0xFFFF
                else:
                    p = ro_base + 2 * i + ro + 2 * (cp - s)
                    g = struct.unpack(">H", c[p: p + 2])[0]
                    if g:
                        g = (g + d) & 0xFFFF
                if g:
                    m[cp] = g
    elif fmt == 6:
        first, count = struct.unpack(">HH", c[off + 6: off + 10])
        glyphs = struct.unpack(f">{count}H", c[off + 10: off + 10 + 2 * count])
        for i, g in enumerate(glyphs):
            if g:
                m[first + i] = g
    elif fmt == 12:
        n = struct.unpack(">I", c[off + 12: off + 16])[0]
        for i in range(n):
            s, e, g0 = struct.unpack(">III", c[off + 16 + 12 * i:
                                                off + 28 + 12 * i])
            for cp in range(s, e + 1):
                g = g0 + cp - s
                if g:
                    m[cp] = g
    elif fmt == 14:
        return None
    else:
        return None
    return m


@functools.lru_cache(maxsize=32)
def _load(path: str, mtime: float) -> Font:
    return Font(path)


def load(path: str) -> Font:
    """The parsed font at ``path`` (cached per file and mtime)."""
    return _load(os.path.abspath(path), os.path.getmtime(path))
