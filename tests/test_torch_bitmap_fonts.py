"""Fonts with bitmap strikes, overlap-flagged glyphs and scaled component
offsets in the port's glyph renderer (fonts/sfnt.py, fonts/imagefont.py,
native/glyph.cpp) against FreeType 2.14.1 (tests/ft_oracle.py), Pillow
12.1 and the JAX package, on the CPU.

The committed fixtures are tests/torch_fixtures/fonts_bitmap/ (written
by make_bitmap_fonts.py); the colour strikes (CBLC / CBDT, sbix), an
EBLC without EBDT, the bloc / bdat pair and an empty strike are built
here from the strikes fixture.

- strikes: the port's strike table and sizes and its scalability equal
  FreeType's face; over sizes 8-64 the port refuses (NotImplementedError)
  exactly the sizes at which FreeType hands back a bitmap glyph, raises
  OSError exactly where FT_Set_Pixel_Sizes fails (Pillow's OSError), and
  renders every other size;
- overlap: every en glyph's FT_OUTLINE_OVERLAP flag and rendered bitmap
  (FreeType's 4x oversampled pass) equal FreeType's, bit for bit;
- scaled offsets: every en glyph's outline points, hinted and unhinted,
  equal FreeType's;
- a sample of golden.npz (the JAX package's renders); chip_smoke.py
  checks all of it.

Tolerance: none (exact equality) throughout.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import ft_oracle as fo
from effocr_torch.fonts import imagefont, sfnt
from effocr_torch.native import glyph as native
from torch_fixtures import make_bitmap_fonts as mb

D = mb.OUT_DIR
CHARS = mb.en_chars()


def _path(name):
    return os.path.join(D, name)


@pytest.fixture(scope="module")
def variants(tmp_path_factory):
    """Strike tables FreeType treats each its own way, on the strikes
    fixture's glyphs: {name: path}."""
    from fontTools.ttLib import TTFont

    d = tmp_path_factory.mktemp("variants")
    src = _path(mb.STRIKES_FONT)
    base = TTFont(src)
    eblc, ebdt = base["EBLC"].compile(base), base["EBDT"].compile(base)
    order = base.getGlyphOrder()
    cmap = base.getBestCmap()
    gids = sorted(order.index(cmap[ord(c)]) for c in CHARS)
    cblc, cbdt = mb.cblc_cbdt(18, gids[0], gids[-1])
    sbix = mb.sbix_table([18, 40], len(order), set(gids))
    empty = mb.eblc_ebdt([{"ppem_x": 14, "ppem_y": 14, "depth": 1,
                           "index_format": 1, "image_format": 2,
                           "first": gids[0], "last": gids[-1],
                           "bitmaps": {}}])
    tables = {
        "cbdt": {"CBLC": cblc, "CBDT": cbdt},
        "sbix": {"sbix": sbix},
        "cblc_and_eblc": {"CBLC": cblc, "CBDT": cbdt, "EBLC": eblc,
                          "EBDT": ebdt},
        "cblc_without_cbdt": {"CBLC": cblc},
        "eblc_without_ebdt": {"EBLC": eblc},
        "bloc": {"bloc": eblc, "bdat": ebdt},
        "eblc_and_sbix": {"EBLC": eblc, "EBDT": ebdt, "sbix": sbix},
        "empty_strike": {"EBLC": empty[0], "EBDT": empty[1]},
    }
    out = {}
    for name, tabs in tables.items():
        f = TTFont(src)
        del f["EBLC"], f["EBDT"]
        for tag, data in tabs.items():
            f[tag] = mb._raw_table(tag, data)
        out[name] = str(d / f"{name}.ttf")
        mb._save(f, out[name])
    return out


def _font(name, variants):
    return variants[name] if name in variants else _path(name)


STRIKE_FONTS = [mb.STRIKES_FONT, mb.STRIKES_ONLY, "cbdt", "sbix",
                "cblc_and_eblc", "cblc_without_cbdt", "eblc_without_ebdt",
                "bloc", "eblc_and_sbix", "empty_strike"]


@pytest.mark.parametrize("name", STRIKE_FONTS)
def test_strike_sizes_and_scalability_match_freetype(name, variants):
    path = _font(name, variants)
    info = fo.face_info(path)
    font = sfnt.Font(path)
    assert [(x, y) for x, y, _ in font.strikes] == info["strikes"]
    assert bool(font.strikes) == info["fixed_sizes"]
    assert font.scalable == info["scalable"]


def _freetype_outcome(path, size, gids):
    """"error" where FT_Set_Pixel_Sizes fails (Pillow raises OSError),
    "bitmap" where any glyph loads as a strike's bitmap, else
    "outline"."""
    if fo.set_size_error(path, size):
        return "error"
    ft = fo.FTFace(path, size)
    for g in gids:
        try:
            if ft.glyph_kind(g) == "bitmap":
                return "bitmap"
        except AssertionError:      # a strike the glyph fails to load from
            return "bitmap"
    return "outline"


@pytest.mark.parametrize("name", STRIKE_FONTS)
def test_refused_sizes_are_where_freetype_loads_bitmaps(name, variants):
    path = _font(name, variants)
    cmap = sfnt.Font(path).cmap
    gids = sorted({cmap[ord(c)] for c in CHARS})
    refused, failed = [], []
    for size in mb.SWEEP:
        want = _freetype_outcome(path, size, gids)
        try:
            font = imagefont.truetype(path, size)
            got = "outline"
        except NotImplementedError as e:
            assert "embedded bitmap strikes" in str(e) \
                and "ROADMAP.md, queue 1" in str(e)
            got = "bitmap"
        except OSError as e:
            assert "invalid pixel size" in str(e)
            got = "error"
        assert got == want, (name, size)
        if got == "outline":
            assert font.getmask2("Hg")[0].any()
        refused += [size] * (got == "bitmap")
        failed += [size] * (got == "error")
    if name == mb.STRIKES_FONT:
        assert tuple(refused) == mb.REFUSED_SIZES and not failed
    if name == mb.STRIKES_ONLY:
        assert tuple(refused) == mb.REFUSED_SIZES
        assert len(failed) == len(mb.SWEEP) - len(refused)


def test_pillow_raises_where_the_port_raises_oserror():
    from PIL import ImageFont

    path = _path(mb.STRIKES_ONLY)
    with pytest.raises(OSError, match="invalid pixel size"):
        ImageFont.truetype(path, 13)
    with pytest.raises(OSError, match="invalid pixel size"):
        imagefont.truetype(path, 13)
    ImageFont.truetype(path, 12)     # a strike size: Pillow draws bitmaps
    with pytest.raises(NotImplementedError, match="EBLC at 12 ppem"):
        imagefont.truetype(path, 12)


@pytest.mark.parametrize("ppem", [9, 13, 32, 64])
def test_overlap_glyphs_render_as_freetype(ppem):
    path = _path(mb.OVERLAP)
    ft = fo.FTFace(path, ppem)
    gc = imagefont.GlyphCache(native.open_face(sfnt.Font(path)), ppem)
    flagged = 0
    for c in CHARS:
        g = ft.char_index(ord(c))
        overlap = gc.outline(g)[3]
        assert overlap == bool(ft.outline_flags(g) & fo.FT_OUTLINE_OVERLAP), c
        flagged += overlap
        want, wl, wt = ft.bitmap(g)
        got, gl, gt = gc.bitmap(g)
        assert (gl, gt) == (wl, wt), c
        np.testing.assert_array_equal(got, want, err_msg=c)
    # all but the three unflagged glyphs and the two composites of them
    # whose first component has no OVERLAP_COMPOUND
    assert flagged == len(CHARS) - 5


def test_overlap_compound_counts_on_the_first_component():
    path = _path(mb.OVERLAP)
    ft = fo.FTFace(path, 40)
    size = native.open_face(sfnt.Font(path)).new_size(40)
    want = {"+": True, "*": False, "#": False, "-": False, "O": True}
    for c, flag in want.items():
        g = ft.char_index(ord(c))
        assert bool(ft.outline_flags(g) & fo.FT_OUTLINE_OVERLAP) == flag, c
        assert size.glyph(g)[3] == flag, c


def test_oversampling_changes_the_flagged_renders():
    """The 4x pass is not a no-op on this font: most flagged glyphs render
    differently without it."""
    path = _path(mb.OVERLAP)
    gc = imagefont.GlyphCache(native.open_face(sfnt.Font(path)), 32)
    cmap = sfnt.Font(path).cmap
    differ = 0
    for c in mb.UNIONS:
        pts, tags, cont, overlap = gc.outline(cmap[ord(c)])
        x0, y0, x1, y1 = gc.cbox(cmap[ord(c)])
        sh = pts - np.array([x0 * 64, y0 * 64])
        differ += not np.array_equal(
            native.render(sh, tags, cont, x1 - x0, y1 - y0, True),
            native.render(sh, tags, cont, x1 - x0, y1 - y0, False))
    assert differ == len(mb.UNIONS)


@pytest.mark.parametrize("hinted", [True, False])
@pytest.mark.parametrize("ppem", [7, 11, 24, 64, 256])
def test_scaled_component_offsets_load_as_freetype(ppem, hinted):
    path = _path(mb.SCALED)
    ft = fo.FTFace(path, ppem)
    size = native.open_face(sfnt.Font(path)).new_size(ppem)
    for c in CHARS:
        g = ft.char_index(ord(c))
        want = ft.outline(g, hinted)
        got = size.outline(g, hinted)
        np.testing.assert_array_equal(got[0], want[0], err_msg=c)
        np.testing.assert_array_equal(got[1] & 1, want[1] & 1, err_msg=c)
        np.testing.assert_array_equal(got[2], want[2], err_msg=c)


def test_goldens_match_the_port():
    """A sample of golden.npz (the JAX package's renders): a few
    characters of each font, both draw functions, and each font's banks."""
    from effocr_torch.data import fonts as P
    from effocr_torch.data.imaging import digest_image

    g = np.load(os.path.join(D, "golden.npz"))
    want = dict(zip(g["render_keys"].tolist(), g["render_digests"].tolist()))
    assert len(want) == len(mb.render_cases())
    for name in mb.FONTS:
        font = P.truetype(_path(name), mb.CANVAS)
        for c in "OoBv%+*#Q8":
            for kind, fn in (("single", P.draw_single_char),
                             ("ascender", P.draw_single_char_ascender)):
                img = fn(c, font, mb.CANVAS)
                assert digest_image(img, "L" if img.ndim == 2 else "RGB") \
                    == want[f"{name}|{kind}|{ord(c)}"], (name, kind, c)
    for name, lang in mb.BANKS:
        bank = P.render_adjacent_bank(_path(name), mb.BANK_SIZE, lang)
        assert digest_image(bank, "L") == str(g[f"bank|{name}|{lang}"])
