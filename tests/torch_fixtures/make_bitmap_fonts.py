"""TrueType test fonts with bitmap strikes, overlap flags and scaled
component offsets, derived from the committed DejaVu Sans, and golden
digests of the JAX package's renders of them.

    python tests/torch_fixtures/make_bitmap_fonts.py [--fonts-only]

writes into ``tests/torch_fixtures/fonts_bitmap/``:

- ``FixtureSansStrikes.ttf``: DejaVu Sans subset to the 90 en characters
  and the space (hinting, GSUB / GPOS / GDEF kept), with ``EBLC`` /
  ``EBDT`` strikes (``STRIKES``): 12 ppem mono (index format 1, image
  format 2), 16 ppem mono holding only the letters and digits (index
  format 3, image format 1), 20 ppem 8-bit gray (index format 2, image
  format 5, every bitmap in one constant box), 24 ppem 8-bit gray (index
  format 1, image format 1) and a 30 x 32 ppem mono strike, which
  FreeType never selects (its x and y ppem differ).  The bitmaps are
  FreeType's renders of the outlines at the strike's size.
- ``FixtureSansStrikesOnly.ttf``: the same strikes and no outlines (no
  ``glyf`` / ``loca``): Pillow opens it only at a strike's size.
- ``FixtureSansOverlap.ttf``: OVERLAP_SIMPLE (0x40) on the first point of
  every simple glyph but the hyphen, l and period; ``UNIONS`` glyphs are
  the union of their own contours and another glyph's (their
  instructions dropped, since the points they name moved), so the
  oversampled rendering shows; ``OVERLAP_COMPOSITES`` are composites of
  the unflagged glyphs with OVERLAP_COMPOUND (0x400) on the first
  component, on the second only, or on none.
- ``FixtureSansScaled.ttf``: ``SCALED_COMPOSITES``, composites whose
  components carry a scale, an x / y scale or a 2 x 2 transform, with
  SCALED_COMPONENT_OFFSET (0x800), UNSCALED_COMPONENT_OFFSET (0x1000),
  neither, ROUND_XY_TO_GRID, and one nested composite.
- ``golden.npz`` (skipped with ``--fonts-only``): digests of the JAX
  package's ``draw_single_char`` / ``draw_single_char_ascender`` of the
  90 en characters at canvas 256 in the three fonts with outlines, and of
  ``render_adjacent_bank`` (en and jp) of each at 128 px.

``LICENSE`` (DejaVu's) and ``DERIVATION.md`` sit beside them.  The
``EBLC`` / ``EBDT`` tables are written here byte by byte; fontTools
subsets the source and writes the rest.  The output is deterministic.
It needs fontTools, Pillow (its FreeType, through tests/ft_oracle.py)
and the JAX package, i.e. this host.  ``eblc_ebdt``, ``cblc_cbdt`` and
``sbix_table`` also build the colour strikes the tests probe FreeType
with.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import os
import shutil
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SRC = os.path.join(HERE, "fonts", "DejaVuSans.ttf")
OUT_DIR = os.path.join(HERE, "fonts_bitmap")
STRIKES_FONT = "FixtureSansStrikes.ttf"
STRIKES_ONLY = "FixtureSansStrikesOnly.ttf"
OVERLAP = "FixtureSansOverlap.ttf"
SCALED = "FixtureSansScaled.ttf"
FONTS = (STRIKES_FONT, OVERLAP, SCALED)      # the fonts with outlines
CANVAS = 256
BANK_SIZE = 128
# (ppem x, ppem y, bit depth, index format, image format, glyphs)
STRIKES = ((12, 12, 1, 1, 2, "all"), (16, 16, 1, 3, 1, "alnum"),
           (20, 20, 8, 2, 5, "all"), (24, 24, 8, 1, 1, "all"),
           (30, 32, 1, 1, 2, "all"))
# the sizes at which FreeType hands back the strikes' bitmaps (the sweep
# of sizes 8-64 in the tests and on the card must find exactly these)
REFUSED_SIZES = (12, 16, 20, 24)
SWEEP = range(8, 65)
# glyph (by character) -> the character whose contours it also takes
UNIONS = {"O": "I", "B": "X", "g": "o", "8": "0", "&": "-", "W": "V",
          "a": "e", "Q": "q"}
# unflagged glyphs the overlap composites are made of
PLAIN = ("-", "l", ".")
# character -> [(component character, dx, dy, 0x400 set)]
OVERLAP_COMPOSITES = {
    "+": [("l", 0, -120, True), ("-", 200, 300, False)],
    "*": [("-", 0, 0, False), ("-", 120, 90, True)],
    "#": [("l", 0, 0, False), ("l", 300, 0, False), ("-", 60, 150, False)],
}
# character -> [(component character, dx, dy, transform, flags)]:
# transform (xx, xy, yx, yy) as fontTools' [[xx, xy], [yx, yy]]
SCALED_COMPOSITES = {
    "o": [("O", 120, -40, (0.75, 0, 0, 0.75), 0x800)],
    "x": [("X", 90, 30, (0.8, 0, 0, 0.65), 0x800)],
    "l": [("I", -60, 20, (1.25, 0, 0, 1.0), 0x800)],
    "v": [("V", 70, 40, (0.9, 0.2, -0.1, 0.8), 0x800)],
    "c": [("C", 130, -77, (0.7, 0, 0, 0.7), 0x800 | 0x4)],
    "z": [("Z", 110, 10, (0.7, 0, 0, 0.7), 0x1000)],
    "s": [("S", 100, 0, (0.72, 0, 0, 0.72), 0)],
    "y": [("Y", 150, -60, (0.6, -0.3, 0.25, 0.7), 0x800)],
    "w": [("W", 33, 71, (0.85, 0.05, 0.07, 0.66), 0x800)],
    "e": [("o", 40, -25, (0.9, 0, 0, 0.9), 0x800)],
    "k": [("K", 60, 0, (0.8, 0, 0, 0.8), 0x800),
          ("period", 700, 500, (1.5, 0, 0, 1.5), 0x800)],
    "%": [("0", 0, 600, (0.5, 0, 0, 0.5), 0x800),
          ("0", 900, -100, (0.5, 0.1, 0, 0.5), 0x800),
          ("/", 0, 0, None, 0x800)],
}


def en_chars():
    sys.path.insert(0, ROOT)
    from effocr_torch.data.builtin_charsets import english_charsets

    cs = english_charsets()
    return cs["digits"] + cs["letters"] + cs["punctuation"]


def file_digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ------------------------------------------------------------ source
def _subset(out_path: str):
    """DejaVu Sans subset to the en characters and the space."""
    from fontTools import subset

    opts = subset.Options()
    opts.name_IDs = ["*"]
    opts.name_languages = ["*"]
    opts.notdef_outline = True
    opts.glyph_names = True
    opts.layout_features = ["*"]
    opts.drop_tables += ["DSIG"]
    font = subset.load_font(SRC, opts)
    s = subset.Subsetter(opts)
    s.populate(unicodes=[ord(c) for c in en_chars()] + [32])
    s.subset(font)
    return font


def _rename(font, family: str, ps: str):
    for rec in font["name"].names:
        if rec.nameID in (1, 16):
            rec.string = family
        elif rec.nameID == 4:
            rec.string = f"{family} Regular"
        elif rec.nameID == 3:
            rec.string = f"{ps};fixture"
        elif rec.nameID == 6:
            rec.string = ps
        elif rec.nameID == 5:
            rec.string = "Version 1.0 (derived from DejaVu, bitmap fixture)"


def _save(font, path: str):
    font.recalcTimestamp = False
    font["head"].created = font["head"].modified = 0x7C259DC0
    buf = io.BytesIO()
    font.save(buf)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


# ------------------------------------------------------------ strikes
def _strike_bitmaps(path: str, ppem: int, gids, depth: int):
    """{gid: (uint8 [rows, width] 0-255 or 0/1, left, top, advance)} of
    FreeType's renders at ``ppem`` (empty glyphs left out)."""
    sys.path.insert(0, os.path.dirname(HERE))
    from ft_oracle import FTFace

    ft = FTFace(path, ppem)
    out = {}
    for g in gids:
        bmp, left, top = ft.bitmap(g)
        if bmp.size == 0:
            continue
        adv = ft.advance(g)[0] >> 6
        out[g] = ((bmp > 127).astype(np.uint8) if depth == 1 else bmp,
                  left, top, adv)
    return out


def _pack_rows(bmp: np.ndarray, depth: int, bit_aligned: bool) -> bytes:
    if depth == 8:
        return bmp.astype(np.uint8).tobytes()
    if bit_aligned:
        return np.packbits(bmp.reshape(-1)).tobytes()
    return np.packbits(bmp, axis=1).tobytes()


def eblc_ebdt(strikes, major: int = 2) -> tuple:
    """(EBLC, EBDT) bytes (``major`` 3: CBLC / CBDT) of ``strikes``: each
    a dict with ppem_x, ppem_y, depth, index_format (1, 2 or 3),
    image_format (1, 2, 5, or 17 for PNG data), first, last (the glyph
    range) and bitmaps {gid: (pixels or PNG bytes, left, top, advance)};
    glyphs of the range without a bitmap are empty entries."""
    version = struct.pack(">HH", major, 0)
    ebdt = bytearray(version)
    sizes, arrays = [], []
    arrays_at = 8 + 48 * len(strikes)
    for st in strikes:
        first, last, fmt = st["first"], st["last"], st["image_format"]
        image_at = len(ebdt)
        offsets, data = [], bytearray()
        box = None
        if st["index_format"] == 2:
            rows = max(b[0].shape[0] + 2 for b in st["bitmaps"].values())
            cols = max(b[0].shape[1] + 2 for b in st["bitmaps"].values())
            top = max(b[2] for b in st["bitmaps"].values()) + 1
            box = (rows, cols, top)
        for g in range(first, last + 1):
            offsets.append(len(data))
            b = st["bitmaps"].get(g)
            if box is not None:
                rows, cols, top = box
                canvas = np.zeros((rows, cols), np.uint8)
                if b is not None:
                    px, left, t, _ = b
                    y0 = top - t
                    canvas[y0:y0 + px.shape[0], 1:1 + px.shape[1]] = px
                data += _pack_rows(canvas, st["depth"], True)
                continue
            if b is None:
                continue
            px, left, t, adv = b
            if fmt == 17:
                data += struct.pack(">BBbbB", 8, 8, 0, 8, 8)
                data += struct.pack(">I", len(px)) + px
                continue
            data += struct.pack(">BBbbB", px.shape[0], px.shape[1], left, t,
                                adv)
            data += _pack_rows(px, st["depth"], fmt == 2)
        offsets.append(len(data))
        ebdt += data
        # index subtable
        if st["index_format"] == 1:
            sub = struct.pack(">HHI", 1, fmt, image_at) + struct.pack(
                f">{len(offsets)}I", *offsets)
        elif st["index_format"] == 3:
            sub = struct.pack(">HHI", 3, fmt, image_at) + struct.pack(
                f">{len(offsets)}H", *offsets)
        else:
            rows, cols, top = box
            size = len(_pack_rows(np.zeros((rows, cols), np.uint8),
                                  st["depth"], True))
            adv = max(b[3] for b in st["bitmaps"].values())
            sub = struct.pack(">HHI", 2, fmt, image_at) + struct.pack(
                ">IBBbbBbbB", size, rows, cols, -1, top, adv, 0, 0, 0)
        sub += b"\0" * (-len(sub) % 4)
        arr = struct.pack(">HHI", first, last, 8) + sub
        arrays.append(arr)
    out = bytearray(version + struct.pack(">I", len(strikes)))
    at = arrays_at
    for st, arr in zip(strikes, arrays):
        asc = st["ppem_y"] * 8 // 10
        desc = asc - st["ppem_y"]
        width_max = max([b[0].shape[1] if not isinstance(b[0], bytes) else 8
                         for b in st["bitmaps"].values()] or [0])
        hori = struct.pack(">bbBbbbbbbbbb", asc, desc, width_max, 1, 0, 0, 0,
                           0, asc, desc, 0, 0)
        vert = struct.pack(">bbBbbbbbbbbb", asc, desc, width_max, 0, 0, 0, 0,
                           0, 0, 0, 0, 0)
        out += struct.pack(">IIII", at, len(arr), 1, 0) + hori + vert
        out += struct.pack(">HHBBBb", st["first"], st["last"], st["ppem_x"],
                           st["ppem_y"], st["depth"], 1)
        at += len(arr)
    for arr in arrays:
        out += arr
    return bytes(out), bytes(ebdt)


def _png_bytes(w: int = 8, h: int = 8) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGBA", (w, h), (200, 30, 30, 255)).save(buf, "PNG")
    return buf.getvalue()


def cblc_cbdt(ppem: int, first: int, last: int) -> tuple:
    """(CBLC, CBDT) bytes: one 32-bit colour strike at ``ppem`` whose
    glyphs first..last are small PNGs (image format 17)."""
    png = _png_bytes()
    st = {"ppem_x": ppem, "ppem_y": ppem, "depth": 32, "index_format": 1,
          "image_format": 17, "first": first, "last": last,
          "bitmaps": {g: (png, 0, 8, 8) for g in range(first, last + 1)}}
    return eblc_ebdt([st], major=3)


def sbix_table(ppems, n_glyphs: int, gids) -> bytes:
    """An ``sbix`` table (version 1, flags 1) with one strike per ppem
    holding a PNG for each glyph of ``gids``."""
    png = _png_bytes()
    strikes = []
    for ppem in ppems:
        offs, data = [], bytearray()
        head = 4 + 4 * (n_glyphs + 1)
        for g in range(n_glyphs):
            offs.append(head + len(data))
            if g in gids:
                data += struct.pack(">hh4s", 0, 0, b"png ") + png
        offs.append(head + len(data))
        strikes.append(struct.pack(">HH", ppem, 72)
                       + struct.pack(f">{n_glyphs + 1}I", *offs) + data)
    out = bytearray(struct.pack(">HHI", 1, 1, len(strikes)))
    at = 8 + 4 * len(strikes)
    for s in strikes:
        out += struct.pack(">I", at)
        at += len(s)
    for s in strikes:
        out += s
    return bytes(out)


def _raw_table(tag: str, data: bytes):
    from fontTools.ttLib.tables.DefaultTable import DefaultTable

    t = DefaultTable(tag)
    t.data = data
    return t


def add_strikes(font, src_path: str):
    """EBLC / EBDT of ``STRIKES`` rendered from ``src_path``."""
    cmap = font.getBestCmap()
    order = font.getGlyphOrder()
    gid_of = {c: order.index(cmap[ord(c)]) for c in en_chars()}
    alnum = {g for c, g in gid_of.items() if c.isalnum()}
    first, last = min(gid_of.values()), max(gid_of.values())
    strikes = []
    for px, py, depth, ixf, imf, which in STRIKES:
        gids = sorted(gid_of.values()) if which == "all" else sorted(alnum)
        bitmaps = _strike_bitmaps(src_path, py, gids, depth)
        strikes.append({"ppem_x": px, "ppem_y": py, "depth": depth,
                        "index_format": ixf, "image_format": imf,
                        "first": first, "last": last, "bitmaps": bitmaps})
    eblc, ebdt = eblc_ebdt(strikes)
    font["EBLC"] = _raw_table("EBLC", eblc)
    font["EBDT"] = _raw_table("EBDT", ebdt)


# ------------------------------------------------------------ the fonts
def build_strikes(out_dir: str, base_path: str):
    from fontTools.ttLib import TTFont

    font = TTFont(base_path)
    add_strikes(font, base_path)
    _rename(font, "Fixture Sans Strikes", "FixtureSans-Strikes")
    _save(font, os.path.join(out_dir, STRIKES_FONT))

    font = TTFont(base_path)
    add_strikes(font, base_path)
    for t in ("glyf", "loca", "fpgm", "prep", "cvt ", "gasp", "GSUB",
              "GPOS", "GDEF"):
        if t in font:
            del font[t]
    maxp = font["maxp"]
    maxp.tableVersion = 0x00005000
    for a in ("maxPoints", "maxContours", "maxCompositePoints",
              "maxCompositeContours", "maxZones", "maxTwilightPoints",
              "maxStorage", "maxFunctionDefs", "maxInstructionDefs",
              "maxStackElements", "maxSizeOfInstructions",
              "maxComponentElements", "maxComponentDepth"):
        if hasattr(maxp, a):
            delattr(maxp, a)
    font["head"].glyphDataFormat = 0
    _rename(font, "Fixture Sans Strikes Only", "FixtureSans-StrikesOnly")
    font.recalcBBoxes = False
    _save(font, os.path.join(out_dir, STRIKES_ONLY))


def _name_of(font, ch: str) -> str:
    return ch if ch in font.getGlyphOrder() else font.getBestCmap()[ord(ch)]


def build_overlap(out_dir: str, base_path: str):
    from fontTools.ttLib import TTFont
    from fontTools.ttLib.tables import ttProgram
    from fontTools.ttLib.tables._g_l_y_f import Glyph, GlyphComponent

    font = TTFont(base_path)
    glyf = font["glyf"]
    name = {c: _name_of(font, c) for c in en_chars()}
    for c, other in UNIONS.items():
        g, o = glyf[name[c]], glyf[name[other]]
        n = len(g.coordinates)
        g.coordinates.extend(o.coordinates)
        g.flags.extend(o.flags)
        g.endPtsOfContours = list(g.endPtsOfContours) + [
            e + n for e in o.endPtsOfContours]
        g.numberOfContours = len(g.endPtsOfContours)
        g.program = ttProgram.Program()
        g.program.fromBytecode(b"")
    for c, comps in OVERLAP_COMPOSITES.items():
        g = Glyph()
        g.numberOfContours = -1
        g.components = []
        for ch, dx, dy, flag in comps:
            comp = GlyphComponent()
            comp.glyphName = name[ch]
            comp.x, comp.y = dx, dy
            comp.flags = 0x400 if flag else 0
            g.components.append(comp)
        glyf[name[c]] = g
    plain = {name[c] for c in PLAIN}
    for gname in font.getGlyphOrder():
        g = glyf[gname]
        if g.numberOfContours > 0 and gname not in plain:
            g.flags[0] |= 0x40
    _rename(font, "Fixture Sans Overlap", "FixtureSans-Overlap")
    _save(font, os.path.join(out_dir, OVERLAP))


def build_scaled(out_dir: str, base_path: str):
    from fontTools.ttLib import TTFont
    from fontTools.ttLib.tables._g_l_y_f import Glyph, GlyphComponent

    font = TTFont(base_path)
    glyf = font["glyf"]
    name = {c: _name_of(font, c) for c in en_chars()}
    name["period"] = name["."]
    # build the referenced glyphs before the ones that nest them
    for c in sorted(SCALED_COMPOSITES, key=lambda c: c == "e"):
        g = Glyph()
        g.numberOfContours = -1
        g.components = []
        for ch, dx, dy, tr, flags in SCALED_COMPOSITES[c]:
            comp = GlyphComponent()
            comp.glyphName = name[ch]
            comp.x, comp.y = dx, dy
            comp.flags = flags
            if tr is not None:
                comp.transform = [[tr[0], tr[1]], [tr[2], tr[3]]]
            g.components.append(comp)
        glyf[name[c]] = g
    _rename(font, "Fixture Sans Scaled", "FixtureSans-Scaled")
    _save(font, os.path.join(out_dir, SCALED))


def build_fonts(out_dir: str):
    import tempfile

    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp()
    try:
        base = os.path.join(tmp, "base.ttf")
        _save(_subset(base), base)
        build_strikes(out_dir, base)
        build_overlap(out_dir, base)
        build_scaled(out_dir, base)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ goldens
def render_cases():
    """(font file, kind, codepoint) of every render golden."""
    return [(name, kind, ord(c)) for name in FONTS for c in en_chars()
            for kind in ("single", "ascender")]


BANKS = tuple((name, lang) for name in FONTS for lang in ("en", "jp"))


def write_goldens(out_path: str):
    sys.path.insert(0, ROOT)
    from PIL import ImageFont

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
        out[f"bank|{name}|{lang}"] = np.array(digest_image(bank, "L"))
    np.savez_compressed(out_path, **out)
    print(f"{len(keys)} renders, {len(out)} keys -> {out_path}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--fonts-only", action="store_true")
    p.add_argument("--out_dir", default=OUT_DIR,
                   help="where the fonts go (the goldens always render the "
                        "committed fonts in tests/torch_fixtures/"
                        "fonts_bitmap)")
    args = p.parse_args()
    build_fonts(args.out_dir)
    for f in sorted(os.listdir(args.out_dir)):
        if f.endswith(".ttf"):
            print(f, os.path.getsize(os.path.join(args.out_dir, f)),
                  file_digest(os.path.join(args.out_dir, f))[:16])
    if not args.fonts_only:
        write_goldens(os.path.join(OUT_DIR, "golden.npz"))


if __name__ == "__main__":
    main()
