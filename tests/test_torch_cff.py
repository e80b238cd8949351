"""CFF fonts (OpenType 'OTTO', name-keyed and CID-keyed) in the port's
glyph renderer, stage by stage, against FreeType 2.14.1, Pillow 12.1 and
the JAX package.

- Tables: fonts/cff.py's INDEXes, DICTs, charset, FDSelect and coverage
  against fontTools' reading of the same bytes; DICT reals against
  FreeType's own parse (a probe font's ItalicAngle through
  FT_Get_PS_Font_Info: FreeType reports no Private DICT of a CFF face,
  FT_Get_PS_Font_Private refuses it, so BlueScale is held through the
  hinted outlines below, which move with it);
- outlines: unhinted and hinted (the Adobe engine) points, tags and
  contours, FT_LOAD_RENDER bitmaps with their offsets, and the advances
  of every en glyph and 200 seeded glyphs of each font at nine sizes,
  exact, through tests/ft_oracle.py;
- the size metrics and HarfBuzz's positions over hb_ft;
- Pillow: getmetrics, getbbox, textlength, textbbox, getmask2 and
  ImageDraw.text into L and RGB;
- the JAX package: data/fonts.py's functions, make-corpus (en, jp,
  jp --vertical), make-charset --dedupe_renders, format-dataset,
  error-analysis --font_dir, one train-recognizer step with the CFF
  bank;
- the committed goldens (tests/torch_fixtures/fonts_cff/golden.npz),
  the CID font's opening cost, the fixture script's determinism, and
  the refusals that stay.

The fonts are tests/torch_fixtures/fonts_cff/, written by
tests/torch_fixtures/make_cff_fonts.py from the committed DejaVu fonts.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import sys
import time

import numpy as np
import pytest

from test_torch_fonts import (  # noqa: F401  (the fixture is used by name)
    _run_jax,
    adjacent_step_matches_jax,
    assert_same_tree,
    builtin_words,
    cut_mobilenet_fonts,
    en_chars,
    seeded_strings,
)

HERE = os.path.dirname(os.path.abspath(__file__))
CFF_DIR = os.path.join(HERE, "torch_fixtures", "fonts_cff")
SERIF = "FixtureSerifCFF.otf"
CID = "FixtureSansCID.otf"
FONTS = [SERIF, CID]
SIZES = [9, 11, 13, 16, 20, 28, 36, 64, 256]
CJK = "代西岡光夫締雪一丁七万丈三上下不与丑专且世丘丙业丛东丝丞丢两严丧个"


def cff_path(name):
    return os.path.join(CFF_DIR, name)


def _glyph_sample(font, seed, n=200):
    gids = {font.cmap.get(ord(c), 0) for c in en_chars()}
    rng = np.random.default_rng(seed)
    gids |= set(rng.choice(np.arange(1, font.num_glyphs), n,
                           replace=False).tolist())
    return sorted(gids)


# ------------------------------------------------------------ tables
@pytest.mark.parametrize("name", FONTS)
def test_tables_match_fonttools(name):
    """CharStrings / Subrs counts, every Private DICT (integers exact,
    reals within FreeType's 16.16 step), the charset's names behind the
    seac lookups, FDSelect, the FontMatrix's units per em, and the cmap
    coverage, against fontTools."""
    from fontTools.cffLib import cffStandardStrings
    from fontTools.ttLib import TTFont

    from effocr_torch.data.fonts import get_unicode_coverage_from_ttf
    from effocr_torch.fonts import cff as C
    from effocr_torch.fonts import sfnt

    path = cff_path(name)
    font = sfnt.load(path)
    c = font.cff
    tt = TTFont(path)
    ft_cff = tt["CFF "].cff
    top = ft_cff.topDictIndex[0]
    assert c.num_glyphs == len(top.CharStrings) == tt["maxp"].numGlyphs
    assert c.gsubrs.count == len(ft_cff.GlobalSubrs)
    fds = list(top.FDArray) if hasattr(top, "FDArray") else [top]
    assert len(c.privates) == len(fds)
    assert c.is_cid == hasattr(top, "ROS")
    for p, fd in zip(c.privates, fds):
        q = fd.Private
        for ours, key in ((p.blue_values, "BlueValues"),
                          (p.other_blues, "OtherBlues"),
                          (p.family_blues, "FamilyBlues"),
                          (p.family_other_blues, "FamilyOtherBlues"),
                          (p.snap_h, "StemSnapH"), (p.snap_v, "StemSnapV")):
            assert ours == list(getattr(q, key, None) or []), key
        for ours, key, default in ((p.blue_shift, "BlueShift", 7),
                                   (p.blue_fuzz, "BlueFuzz", 1),
                                   (p.std_hw, "StdHW", 0),
                                   (p.std_vw, "StdVW", 0),
                                   (p.language_group, "LanguageGroup", 0),
                                   (p.default_width, "defaultWidthX", 0),
                                   (p.nominal_width, "nominalWidthX", 0),
                                   (int(p.force_bold), "ForceBold", 0)):
            assert ours == int(getattr(q, key, default)), key
        assert abs(p.blue_scale / 65536000 - q.BlueScale) <= 1 / 65536000
        n_sub = len(q.Subrs) if hasattr(q, "Subrs") else 0
        assert (p.subrs.count if p.subrs else 0) == n_sub
    assert c.top_upm == tt["head"].unitsPerEm and set(c.sub_upm) == {
        c.top_upm}
    if c.is_cid:
        want = [top.FDSelect[g] for g in range(c.num_glyphs)]
        np.testing.assert_array_equal(c.fd_of_glyph, want)
        assert len(c.privates) >= 8 and (c.seac < 0).all()
        assert top.ROS == ("Adobe", "Identity", 0)
        assert top.CIDCount == c.num_glyphs == 65535
    else:
        std = {n: i for i, n in enumerate(cffStandardStrings)}
        order = tt.getGlyphOrder()
        for code in range(256):
            sid = C.STANDARD_ENCODING[code]
            hits = [g for g, n in enumerate(order) if std.get(n) == sid]
            assert c.seac[code] == (hits[0] if hits and sid else
                                    (0 if sid == 0 else -1)), code
        assert c.gsubrs.count > 1240
    cov = sorted({cp for t in tt["cmap"].tables for cp in t.cmap})
    assert font.coverage() == cov
    assert get_unicode_coverage_from_ttf(path)[0] == cov


REALS = ["0.06", "0.5", "0.039625", "-2.25", "12.5", "0.1", "1.5E2", "1e-3",
         "7.0E-4", "0.0012345", "0.000012", "123.456789", "0.123456789012",
         "99999", "32767.5", "1234567", "-0.06", "3.14159265358979",
         "0.0375", "0.02", "0.07", "4.8828125e-4", "0.001", "-12.0E-1"]


def test_real_operands_parse_as_freetype_does(tmp_path):
    """cff_parse_real's integer arithmetic (its leading-digit loss for
    values under 0.1 included: FreeType reads "0.06" as 0), against
    FreeType itself: each real as a probe font's ItalicAngle, which
    FT_Get_PS_Font_Info reports in 16.16; BlueScale's read times 1000
    and the FontMatrix's dynamic scaling on the fixtures' reals."""
    import ft_oracle
    from torch_fixtures.make_cff_fonts import enc_real, probe_font

    from effocr_torch.fonts import cff as C

    for i, text in enumerate(REALS):
        path = str(tmp_path / f"r{i}.otf")
        probe_font(path, [(1202, [text])], [[500, "endchar"], ["endchar"]])
        want = ft_oracle.FTFace(path, 10).italic_angle()
        assert C.parse_fixed(enc_real(text)) == want, text
    assert C.parse_fixed(enc_real("0.039625"), 3) == C.DEFAULT_BLUE_SCALE
    assert C.parse_fixed(enc_real("0.0375"), 3) == 2457600
    m, upm = C.parse_font_matrix([enc_real("0.001"), b"\x8b", b"\x8b",
                                  enc_real("0.001"), b"\x8b", b"\x8b"])
    assert (m[0], m[3], upm) == (65536, 65536, 1000)
    m, upm = C.parse_font_matrix([enc_real("4.8828125e-4"), b"\x8b", b"\x8b",
                                  enc_real("4.8828125e-4"), b"\x8b",
                                  b"\x8b"])
    assert C.normalize_matrix(m, upm)[0] == [65536, 0, 0, 65536, 0, 0]


# ------------------------------------------------------------ outlines
@pytest.mark.parametrize("name", FONTS)
@pytest.mark.parametrize("ppem", SIZES)
def test_outlines_bitmaps_and_advances_match_freetype(name, ppem):
    """FT_LOAD_NO_HINTING and FT_LOAD_DEFAULT outline points, tags
    (cubic 2) and contours, FT_LOAD_RENDER bitmaps with left / top, and
    advance.x / linearHoriAdvance, for every en glyph and 200 seeded
    glyphs (subroutines, flex, seac, hint replacement, cntrmask and the
    arithmetic operators among them); the size's scale and metrics."""
    import ft_oracle

    from effocr_torch.fonts import imagefont, sfnt

    path = cff_path(name)
    font = sfnt.load(path)
    ft = ft_oracle.FTFace(path, ppem)
    mf = imagefont.truetype(path, ppem)
    size = mf.glyphs.size
    for g in _glyph_sample(font, ppem):
        for hinted in (False, True):
            want = ft.outline(g, hinted)
            got = size.load(g, hinted)
            np.testing.assert_array_equal(got[0], want[0], err_msg=f"{g}")
            np.testing.assert_array_equal(got[1], want[1] & 3)
            np.testing.assert_array_equal(got[2], want[2])
            assert got[3] == ft.advance(g, hinted), (g, hinted)
        bmp, left, top = ft.bitmap(g)
        mine = mf.glyphs.bitmap(g)
        assert (mine[1], mine[2]) == (left, top) or bmp.size == 0, g
        np.testing.assert_array_equal(mine[0], bmp, err_msg=f"{g}")
    x_scale, _, asc, desc, _ = ft.metrics()
    assert (mf.x_scale, mf.ascender, mf.descender) == (x_scale, asc, desc)


def _random_glyph(rng):
    """A random hinted charstring: a width or not, hstems / vstems with
    ghost (-20 / -21) and inverted widths, hstem or hstemhm with masks
    (the first implying the vstems), a cntrmask, hintmask replacement
    between segments, zero-length lines, several contours."""
    from torch_fixtures.make_cff_fonts import mask_bytes

    prog = [int(rng.integers(-200, 200))] if rng.random() < 0.5 else []
    nh, nv = int(rng.integers(0, 15)), int(rng.integers(0, 9))

    def stems(n, lo, hi):
        out, prev = [], 0
        for p in sorted(int(v) for v in rng.integers(lo, hi, n)):
            r = rng.random()
            w = -20 if r < 0.1 else -21 if r < 0.2 else \
                -int(rng.integers(1, 40)) if r < 0.27 else \
                int(rng.integers(0, 120))
            out += [p - prev, w]
            prev = p + w
        return out

    def mask(q):
        return mask_bytes([i for i in range(nh + nv) if rng.random() < q],
                          nh + nv)

    hm = rng.random() < 0.6
    if nh:
        prog += stems(nh, -250, 900) + ["hstemhm" if hm else "hstem"]
    if nv:
        prog += stems(nv, -50, 800)
        if not hm or rng.random() < 0.5:
            prog.append("vstemhm" if hm else "vstem")
        else:
            prog += ["hintmask", mask(0.6)]
    if nh and rng.random() < 0.2:
        prog += ["cntrmask", mask(0.5)]
    x = y = 0
    for _ in range(int(rng.integers(1, 5))):
        nx, ny = int(rng.integers(-100, 900)), int(rng.integers(-250, 900))
        prog += [nx - x, ny - y, "rmoveto"]
        x, y = nx, ny
        for _ in range(int(rng.integers(1, 10))):
            if hm and rng.random() < 0.25:
                prog += ["hintmask", mask(0.5)]
            r = rng.random()
            if r < 0.35:
                d = [0, 0] if rng.random() < 0.08 else \
                    [int(v) for v in rng.integers(-300, 300, 2)]
                prog += d + ["rlineto"]
            elif r < 0.45:
                d = [int(rng.integers(-300, 300)), 0]
                prog += d[:1] + ["hlineto"]
            else:
                c = [int(v) for v in rng.integers(-250, 250, 6)]
                prog += c + ["rrcurveto"]
                d = [c[0] + c[2] + c[4], c[1] + c[3] + c[5]]
            x, y = x + d[0], y + d[1]
    return prog + ["endchar"]


EDGE_GLYPHS = [
    # 97 stems: more than the engine's 96 -> an error in both
    [1, 2] * 97 + ["hstem", 0, 0, "rmoveto", 100, 0, "rlineto", 0, 100,
                   "rlineto", "endchar"],
    # a mask with no stems, then drawing
    ["hintmask", 10, 10, "rmoveto", 100, 0, "rlineto", 0, 100, "rlineto",
     "endchar"],
    # stems after the first mask is built: ignored
    [0, 50, "hstem", 10, 10, "rmoveto", 100, 0, "rlineto", 0, 60, "rlineto",
     20, 30, "hstem", 0, 50, "rlineto", "endchar"],
    # subroutines nested past the limit
    [-107, "callsubr", "endchar"],
    # a return at the top level
    ["return"],
]


@pytest.mark.parametrize("seed", [1, 2])
def test_random_charstrings_match_freetype(seed, tmp_path):
    """Seeded random hinted charstrings (and EDGE_GLYPHS) under random
    Private DICTs (blue zones and family zones, BlueScale / BlueShift /
    BlueFuzz, LanguageGroup 1): hinted outlines exact, and a glyph fails
    to load in the port exactly where it fails in FreeType."""
    import ft_oracle
    from torch_fixtures.make_cff_fonts import probe_font

    from effocr_torch.fonts import imagefont

    rng = np.random.default_rng(seed)
    blues = sorted(int(v) for v in rng.choice(np.arange(-300, 1000), 8,
                                              replace=False))
    priv = {"BlueValues": blues,
            "OtherBlues": sorted(int(v) for v in rng.choice(
                np.arange(-400, -150), 2, replace=False)),
            "FamilyBlues": [v + int(rng.integers(-3, 4)) for v in blues],
            "BlueScale": ["0.01", "0.1"][seed - 1],
            "BlueShift": [0, 20][seed - 1], "BlueFuzz": [3, 0][seed - 1],
            "LanguageGroup": seed - 1, "nominalWidthX": 500}
    progs = [[500, "endchar"]] + [_random_glyph(rng) for _ in range(40)] \
        + EDGE_GLYPHS
    lsubrs = [[-107, "callsubr", "return"]]
    path = str(tmp_path / "fuzz.otf")
    probe_font(path, [], progs, private=priv, lsubrs=lsubrs)
    for ppem in (8, 13, 24, 50):
        ft = ft_oracle.FTFace(path, ppem)
        mf = imagefont.truetype(path, ppem)
        for g in range(1, len(progs)):
            try:
                want = ft.outline(g, True)
            except AssertionError:
                want = None
            try:
                got = mf.glyphs.size.outline(g, True)
            except OSError:
                got = None
            assert (got is None) == (want is None), (g, ppem)
            if want is not None:
                np.testing.assert_array_equal(got[0], want[0],
                                              err_msg=f"{g} {ppem}")
                np.testing.assert_array_equal(got[1], want[1] & 3)
                np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("charset_format", [0, 2])
def test_seac_through_each_charset_format(charset_format, tmp_path):
    """The serif font rebuilt with its charset in format 0 or 2 (the
    fixture has format 1): the same StandardEncoding lookups, and its
    seac glyphs' outlines equal FreeType's."""
    import ft_oracle
    from torch_fixtures.make_cff_fonts import build_serif

    from effocr_torch.fonts import imagefont, sfnt

    path = str(tmp_path / "serif.otf")
    build_serif(path, charset_format=charset_format)
    font = sfnt.load(path)
    np.testing.assert_array_equal(font.cff.seac,
                                  sfnt.load(cff_path(SERIF)).cff.seac)
    ft = ft_oracle.FTFace(path, 20)
    mf = imagefont.truetype(path, 20)
    seac = [font.cmap[ord(c)] for c in "éèêëàáâäñüöóÑÉ" if ord(c) in font.cmap]
    assert len(seac) >= 10
    for g in seac:
        for hinted in (False, True):
            want = ft.outline(g, hinted)
            got = mf.glyphs.size.outline(g, hinted)
            np.testing.assert_array_equal(got[0], want[0], err_msg=f"{g}")
            np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("fdselect_format", [0, 3])
def test_small_cid_fonts_match_freetype(fdselect_format, tmp_path):
    """A CID-keyed probe with FDSelect format 0 or 3: glyphs in three FDs
    whose Private dicts (blue zones, LanguageGroup 1 em-box hints,
    nominalWidthX) and local Subrs differ, hinted and unhinted, equal
    FreeType's outlines and advances."""
    import ft_oracle
    from torch_fixtures.make_cff_fonts import probe_font

    from effocr_torch.fonts import imagefont

    privates = [
        ({"BlueValues": [-10, 0, 500, 510], "nominalWidthX": 400},
         [[0, 40, "hstem", 100, 0, "rmoveto", 300, 0, "rlineto", 0, 40,
           "rlineto", "return"]]),
        ({"LanguageGroup": 1, "nominalWidthX": 700},
         [[0, 0, "rmoveto", 400, 0, 0, 300, -400, 0, "rlineto",
           "return"], [-107, "callsubr", "return"]]),
        ({"BlueValues": [-20, 0, 700, 720], "BlueScale": "0.1",
          "nominalWidthX": 0},
         [[0, 700, "rmoveto", 500, 0, 100, 100, 0, 200, "rrcurveto",
           "return"]])]
    progs = [[500, "endchar"]]
    fds = [0]
    for k in range(12):
        fd = k % 3
        body = {0: [-107, "callsubr", -300, -40, "rlineto", "endchar"],
                1: [-106, "callsubr", "endchar"],
                2: [0, 20, 680, 40, "hstem", -107, "callsubr", 0, -700,
                    "rlineto", "endchar"]}[fd]
        progs.append([k * 10] + body if fd == 1 else body)
        fds.append(fd)
    path = str(tmp_path / "cid.otf")
    probe_font(path, [], progs, private=privates, fds=fds,
               fdselect_format=fdselect_format)
    for ppem in (11, 17, 40):
        ft = ft_oracle.FTFace(path, ppem)
        mf = imagefont.truetype(path, ppem)
        np.testing.assert_array_equal(mf.glyphs.size.face.font.cff
                                      .fd_of_glyph, fds)
        for g in range(1, len(progs)):
            for hinted in (False, True):
                want = ft.outline(g, hinted)
                got = mf.glyphs.size.load(g, hinted)
                np.testing.assert_array_equal(got[0], want[0],
                                              err_msg=f"{g} {ppem}")
                np.testing.assert_array_equal(got[2], want[2])
                assert got[3] == ft.advance(g, hinted)


@pytest.mark.parametrize("name", FONTS)
def test_shaping_matches_harfbuzz(name):
    """Glyphs, advances and offsets of the port's shaper against
    hb_shape over hb_ft's font functions (HarfBuzz's load flags)."""
    import ft_oracle

    from effocr_torch.fonts import shaping, sfnt

    path = cff_path(name)
    font = sfnt.load(path)
    texts = builtin_words()[:40] + seeded_strings(5) + [
        "AVo ffi Té", "«Мир» (a)", CJK, "x " + CJK[:5] + " y"]
    for ppem in (13, 28, 44):
        ft = ft_oracle.FTFace(path, ppem)
        for t in texts:
            got = [(g.gid, g.x_adv, g.y_adv, g.x_off, g.y_off)
                   for g in shaping.shape(font, t, ft.metrics()[0])]
            assert got == ft.hb_shape(t), (t, ppem)


# ------------------------------------------------------------ Pillow
@pytest.mark.parametrize("name", FONTS)
def test_single_characters_match_pillow(name):
    """getmetrics at every size; getlength and getbbox (la, mm, rb, lb)
    of a seeded sample of the font's characters at 13 and 44 px."""
    from PIL import ImageFont

    from effocr_torch.fonts import imagefont, sfnt

    path = cff_path(name)
    cps = np.array(sfnt.load(path).coverage())
    sample = sorted(set(np.random.default_rng(9).choice(
        cps, 160, replace=False).tolist()) | {ord(c) for c in en_chars()})
    for size in SIZES:
        assert imagefont.truetype(path, size).getmetrics() == \
            ImageFont.truetype(path, size).getmetrics()
    for size in (13, 44):
        pf = ImageFont.truetype(path, size)
        mf = imagefont.truetype(path, size)
        for cp in sample:
            ch = chr(cp)
            got = [mf.getlength(ch)] + [mf.getbbox(ch, a) for a in
                                        ("la", "mm", "rb", "lb")]
            want = [pf.getlength(ch)] + [pf.getbbox(ch, anchor=a) for a in
                                         ("la", "mm", "rb", "lb")]
            assert got == want, (hex(cp), size, got, want)


@pytest.mark.parametrize("name", FONTS)
def test_text_layout_and_masks_match_pillow(name):
    """textlength, textbbox at float positions and every anchor, and
    getmask2 at fractional starts, for BUILTIN_TEXT's words and seeded
    Latin / Greek / Cyrillic (and CJK) strings, at 16, 28 and 44 px."""
    from PIL import Image, ImageDraw, ImageFont

    from effocr_torch.fonts import imagefont

    path = cff_path(name)
    rng = np.random.default_rng(len(name))
    words = builtin_words()
    texts = (words[:40] + [" ".join(rng.choice(words, 5)) for _ in range(6)]
             + seeded_strings(len(name)) + ["AV", "To", "ffi", "fi", "(Мир)",
                                            "«Мир» x", "éèñ ÑÉ", CJK[:9],
                                            "a " + CJK[9:14]])
    anchors = ["la", "mm", "rb", "lb", "rm", "lm", "mb", "mt", "ls", "ra",
               "md", "lt", "ma", "rd"]
    draw = ImageDraw.Draw(Image.new("L", (8, 8)))
    for size in (16, 28, 44):
        pf = ImageFont.truetype(path, size)
        mf = imagefont.truetype(path, size)
        for t in texts:
            assert mf.getlength(t) == draw.textlength(t, font=pf), t
            a = anchors[int(rng.integers(len(anchors)))]
            xy = (float(rng.uniform(-30, 30)), float(rng.uniform(-30, 30)))
            assert imagefont.textbbox(xy, t, mf, a) == draw.textbbox(
                xy, t, font=pf, anchor=a), (t, a, xy)
            start = (float(np.modf(rng.uniform(-1, 1))[0]),
                     float(np.modf(rng.uniform(-1, 1))[0]))
            mask, off = mf.getmask2(t, anchor=a, start=start)
            pm, poff = pf.getmask2(t, "L", anchor=a, start=start)
            want = np.asarray(Image.frombytes("L", pm.size, bytes(pm))) \
                if pm.size[0] * pm.size[1] else np.zeros(pm.size[::-1],
                                                         np.uint8)
            assert off == poff, (t, a, start)
            np.testing.assert_array_equal(mask, want, err_msg=t)


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_draw_text_matches_pillow(mode):
    """ImageDraw.text into L and RGB images with both fonts: fills,
    overlapping words blended in order, clipping at every edge."""
    from PIL import Image, ImageDraw, ImageFont

    from effocr_torch.fonts import imagefont

    rng = np.random.default_rng(4)
    for name in FONTS:
        for size in (13, 36):
            pf = ImageFont.truetype(cff_path(name), size)
            mf = imagefont.truetype(cff_path(name), size)
            bg = (250, 240, 230) if mode == "RGB" else 200
            im = Image.new(mode, (240, 100), bg)
            arr = np.array(im)
            d = ImageDraw.Draw(im)
            words = list(rng.choice(builtin_words(), 6)) + [CJK[:6]]
            for w in words:
                xy = (float(rng.uniform(-40, 220)),
                      float(rng.uniform(-30, 90)))
                fill = (tuple(int(v) for v in rng.integers(0, 256, 3))
                        if mode == "RGB" else int(rng.integers(256)))
                a = ["la", "mm", "rb", "lb"][int(rng.integers(4))]
                d.text(xy, w, fill, font=pf, anchor=a)
                imagefont.draw_text(arr, xy, w, fill, mf, anchor=a)
            np.testing.assert_array_equal(arr, np.asarray(im))


# ------------------------------------------------------------ JAX
@pytest.mark.parametrize("name", FONTS)
def test_render_functions_match_jax(name):
    """draw_single_char at 64 and 256, draw_single_char_ascender at 256
    (with padding), both AddAdjacentChars banks, coverage."""
    from PIL import ImageFont

    from effocr_tpu.data import fonts as J
    from effocr_torch.data import fonts as P

    path = cff_path(name)
    assert P.get_unicode_coverage_from_ttf(path) == \
        J.get_unicode_coverage_from_ttf(path)
    chars = "aAgjQ0.,%éÑ" + CJK[:3]
    for cs in (64, 256):
        jf, pf = ImageFont.truetype(path, cs), P.truetype(path, cs)
        for c in chars:
            for fn in (("draw_single_char", "draw_single_char_ascender")
                       if cs == 256 else ("draw_single_char",)):
                want = getattr(J, fn)(c, jf, cs, padding=0.05)
                got = getattr(P, fn)(c, pf, cs, padding=0.05)
                if want is None:
                    assert got is None, (c, fn)
                    continue
                assert (got.ndim == 3) == (want.mode == "RGB")
                np.testing.assert_array_equal(got, np.asarray(want))
    for lang in ("en", "jp"):
        np.testing.assert_array_equal(P.render_adjacent_bank(path, 48, lang),
                                      J.render_adjacent_bank(path, 48, lang))


def test_render_chars_signatures_and_dedupe_match_jax(tmp_path):
    """render_chars trees, render_signatures and dedupe_render_identical
    over both CFF fonts and a DejaVu TrueType font together."""
    from effocr_tpu.data import fonts as J
    from effocr_torch.data import fonts as P

    paths = [cff_path(n) for n in FONTS] + [os.path.join(
        HERE, "torch_fixtures", "fonts", "DejaVuSans.ttf")]
    chars = list("AАΑBcl1IO0oé") + list(CJK[:6])
    for fn, square in (("draw_single_char", False),
                       ("draw_single_char_ascender", True)):
        for pkg, mod in (("j", J), ("p", P)):
            n = mod.render_chars(paths, chars, str(tmp_path / f"{pkg}{fn}"),
                                 padding=0.05, draw_func=getattr(mod, fn),
                                 square=square, canvas_size=48)
        assert assert_same_tree(tmp_path / f"j{fn}", tmp_path / f"p{fn}") == n
    assert P.render_signatures(chars, paths) == J.render_signatures(chars,
                                                                    paths)
    for tol in (0.0, 0.05):
        assert P.dedupe_render_identical(chars, paths, tol=tol) == \
            J.dedupe_render_identical(chars, paths, tol=tol)


@pytest.fixture(scope="module")
def cff_font_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cff_fonts")
    for n in FONTS:
        shutil.copy(cff_path(n), d)
    return str(d)


CORPUS_CASES = {
    "en": ["--lang", "en", "--noise_std", "8", "--blur_sigma", "1"],
    "jp": ["--lang", "jp", "--blur_sigma", "1.5"],
    "jp_vertical": ["--lang", "jp", "--vertical", "--noise_std", "4"],
}


@pytest.fixture(scope="module")
def cff_corpora(tmp_path_factory, cff_font_dir):
    from effocr_tpu.cli import make_corpus as J
    from effocr_torch.cli import make_corpus as P

    root = tmp_path_factory.mktemp("cff_corpora")
    for case, flags in CORPUS_CASES.items():
        for pkg in ("j", "p"):
            argv = ["--out_dir", str(root / f"{case}_{pkg}"), "--n_lines",
                    "8", "--font_dir", cff_font_dir, "--seed", "6", *flags]
            _run_jax(J, argv) if pkg == "j" else P.main(argv)
    return root


@pytest.mark.parametrize("case", list(CORPUS_CASES))
def test_make_corpus_matches_jax(case, cff_corpora):
    a, b = cff_corpora / f"{case}_j", cff_corpora / f"{case}_p"
    assert (a / "corpus.json").read_bytes() == (b / "corpus.json").read_bytes()
    assert assert_same_tree(a, b) == 9
    coco = json.loads((b / "corpus.json").read_text())
    assert sum(x["category_id"] == 0 for x in coco["annotations"]) > 8


def test_make_charset_and_format_dataset_match_jax(tmp_path, cff_corpora,
                                                   cff_font_dir, capsys):
    """make-charset --dedupe_renders over a capped CJK range of both
    fonts, then format-dataset on the jp corpus with it."""
    from effocr_tpu.cli import format_dataset as JF
    from effocr_tpu.cli import make_charset as JS
    from effocr_torch.cli import format_dataset as PF
    from effocr_torch.cli import make_charset as PS

    outs = {}
    for pkg, mod in (("j", JS), ("p", PS)):
        out = tmp_path / f"charsets_{pkg}" / "jp_chars.txt"
        argv = ["--font_dir", cff_font_dir, "--out", str(out),
                "--min_codepoint", "19968", "--max_chars", "60",
                "--dedupe_renders"]
        _run_jax(mod, argv) if pkg == "j" else mod.main(argv)
        outs[pkg] = (out.read_bytes(), capsys.readouterr().out.replace(
            f"charsets_{pkg}", ""))
    assert outs["p"] == outs["j"]
    corpus = cff_corpora / "jp_j"
    for pkg, mod in (("j", JF), ("p", PF)):
        argv = ["--image_dir", str(corpus / "images"), "--coco_jsons",
                str(corpus / "corpus.json"), "--crops_save_dir",
                str(tmp_path / f"crops_{pkg}"), "--cat_id", "0",
                "--clip_to_top_and_bottom", "--font_dir", cff_font_dir,
                "--charset_dir", str(tmp_path / "charsets_j"),
                "--dataset_save_dir", str(tmp_path / f"tree_{pkg}")]
        _run_jax(mod, argv) if pkg == "j" else mod.main(argv)
    assert_same_tree(tmp_path / "crops_j", tmp_path / "crops_p")
    assert assert_same_tree(tmp_path / "tree_j", tmp_path / "tree_p") > 60


def test_error_analysis_font_dir_matches_jax(tmp_path, monkeypatch, capsys,
                                             cff_font_dir):
    """error-analysis --font_dir over the CFF fonts: the confusions'
    render distances and their report, as the JAX command prints and
    saves them."""
    from effocr_tpu.cli import error_analysis as J
    from effocr_torch.cli import error_analysis as P

    pairs = [("Hamburg", "Hambnrg"), ("Аб", "Ab"), ("lI", "Il"),
             (CJK[:4], CJK[1:5]), ("éa", "ea"), ("0O", "O0")]
    coco = {"images": [{"id": i, "file_name": f"l{i}.png", "text": gt}
                       for i, (gt, _) in enumerate(pairs)]}
    (tmp_path / "coco.json").write_text(json.dumps(coco))
    (tmp_path / "res.json").write_text(json.dumps(
        {f"l{i}.png": pred for i, (_, pred) in enumerate(pairs)}))
    outs = {}
    for pkg in ("jax", "port"):
        argv = ["--results", str(tmp_path / "res.json"), "--coco_json",
                str(tmp_path / "coco.json"), "--top", "30", "--font_dir",
                cff_font_dir, "--save_json", str(tmp_path / f"{pkg}.json")]
        if pkg == "jax":
            monkeypatch.setattr(sys, "argv", ["error-analysis"] + argv)
            J.main()
        else:
            P.main(argv)
        out = capsys.readouterr().out
        outs[pkg] = (out.replace(f"{pkg}.json", ""),
                     (tmp_path / f"{pkg}.json").read_bytes())
    assert outs["port"] == outs["jax"]
    assert "render dist" in outs["port"][0]


def test_train_step_with_cff_bank_matches_jax(cut_mobilenet_fonts):
    """One train-recognizer step with --adjacent_font_path on the serif
    CFF font: loss 1e-5 rel, gradients 1e-4 of the largest."""
    adjacent_step_matches_jax(cff_path(SERIF))


# ------------------------------------------------------------ goldens
def test_goldens_match_the_port():
    """The committed fonts_cff/golden.npz (make_cff_fonts.py, from the
    JAX package) against the port's renders: a sample of the en
    characters in both fonts, CJK codepoints in the CID font, both banks.
    chip_smoke.py checks all of them on the card's host, and the jp
    pipeline's digests."""
    from torch_fixtures.make_cff_fonts import (BANK_SIZE, BANKS, CANVAS,
                                               cjk_sample)

    from effocr_torch.data import fonts as P
    from effocr_torch.data.imaging import digest_image

    g = np.load(os.path.join(CFF_DIR, "golden.npz"))
    want = dict(zip(g["render_keys"].tolist(), g["render_digests"].tolist()))
    assert len(want) == 2 * 90 * 2 + 90
    cases = [(n, "aQ7&,é") for n in FONTS] + [(CID, "".join(
        chr(c) for c in cjk_sample()[::15]))]
    for name, chars in cases:
        font = P.truetype(cff_path(name), CANVAS)
        for c in chars:
            kinds = (("single", P.draw_single_char),
                     ("ascender", P.draw_single_char_ascender))
            for kind, fn in kinds:
                key = f"{name}|{kind}|{ord(c)}"
                if key not in want:
                    continue
                img = fn(c, font, CANVAS)
                got = "none" if img is None else digest_image(
                    img, "L" if img.ndim == 2 else "RGB")
                assert got == want[key], key
    for name, lang in BANKS:
        bank = P.render_adjacent_bank(cff_path(name), BANK_SIZE, lang)
        assert digest_image(bank, "L") == str(g[f"bank_{lang}"])


def test_cid_font_opens_fast():
    """Opening the 65,535-glyph CID font (sfnt, CFF INDEXes, FDSelect,
    cmap) and rendering one glyph takes well under a second."""
    from effocr_torch.fonts import imagefont, sfnt
    from effocr_torch.native import glyph

    glyph.build()
    path = cff_path(CID)
    sfnt._load.cache_clear()
    imagefont._face.cache_clear()
    imagefont._glyphs.cache_clear()
    t0 = time.perf_counter()
    mask, _ = imagefont.truetype(path, 64).getmask2(CJK[0])
    seconds = time.perf_counter() - t0
    assert mask.any()
    assert sfnt.load(path).num_glyphs == 65535
    assert seconds < 1.0, seconds


def test_fixture_script_is_deterministic(tmp_path):
    """make_cff_fonts.py rebuilds byte-identical fonts (the goldens'
    rendering is Pillow's, checked above)."""
    import subprocess

    script = os.path.join(HERE, "torch_fixtures", "make_cff_fonts.py")
    subprocess.run([sys.executable, script, "--fonts-only", "--out_dir",
                    str(tmp_path)], check=True, capture_output=True)
    for n in FONTS:
        with open(cff_path(n), "rb") as a, open(tmp_path / n, "rb") as b:
            assert a.read() == b.read(), n
    total = sum(os.path.getsize(cff_path(n)) for n in FONTS)
    assert total < 1_500_000, total


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("case,feature", [
    ("cff2", "CFF2 outlines"), ("oblique", "not a uniform scale"),
    ("type1", "CharstringType 1")])
def test_cff_refusals_name_their_feature(case, feature, tmp_path):
    """CFF2, a skewing FontMatrix and Type 1 charstrings in CFF raise
    NotImplementedError naming the feature and ROADMAP.md."""
    from torch_fixtures.make_cff_fonts import (build_cff, charset_bytes,
                                               encode_program)

    from effocr_torch.fonts import cff as C
    from effocr_torch.fonts import imagefont

    p = tmp_path / "f.otf"
    if case == "cff2":
        # the serif font with its 'CFF ' table renamed in the directory
        with open(cff_path(SERIF), "rb") as f:
            data = f.read()
        n = struct.unpack(">H", data[4:6])[0]
        head = data[: 12 + 16 * n].replace(b"CFF ", b"CFF2", 1)
        p.write_bytes(head + data[len(head):])
        with pytest.raises(NotImplementedError, match=feature) as e:
            imagefont.truetype(str(p), 20)
        assert "ROADMAP.md" in str(e.value)
        return
    top = [(1207, ["0.001", 0, "0.0002", "0.001", 0, 0])] \
        if case == "oblique" else [(1206, [1])]
    data = build_cff("Probe", top, [], [],
                     [encode_program([500, "endchar"]),
                      encode_program(["endchar"])],
                     charset_bytes([1], 0), [({}, [])])
    with pytest.raises(NotImplementedError, match=feature) as e:
        C.CFF(data, 1000, str(p))
    assert "ROADMAP.md" in str(e.value)
