"""The port's own glyph renderer, stage by stage, against its oracles.

- Stage 1: outlines (scaled, hinted by the v40 interpreter) and bitmaps
  (the gray rasterizer) of native/glyph.cpp against FreeType 2.14.1
  through ctypes (tests/ft_oracle.py; the test's oracle only);
- stage 2: metrics, bounding boxes, text lengths, masks and drawn pixels
  of fonts/imagefont.py, and the image operations of data/imaging.py,
  against Pillow 12.1;
- stage 3: data/fonts.py and ``confusion_render_distance`` against the
  JAX package's functions;
- stage 4: ``make-corpus``, ``make-charset`` and ``format-dataset``
  against the JAX commands (identical JSON and charset bytes, file
  names, pixels and modes; PNG bytes may differ);
- stage 5: ``extract_char_crops``;
- stage 6: the neighbour-glyph composite of ``apply_augment`` and one
  ``train-recognizer --adjacent_font_path`` step against JAX;
- the refusals, which name their feature and ROADMAP.md, and the
  committed goldens that chip_smoke.py checks on the card's host.

Every comparison is exact except ``confusion_render_distance`` (1e-12).
The fonts are the committed DejaVu copies in tests/torch_fixtures/fonts/.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import struct
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
FONT_DIR = os.path.join(HERE, "torch_fixtures", "fonts")
FONTS = ["DejaVuSans.ttf", "DejaVuSerif.ttf", "DejaVuSansMono.ttf"]
SIZES = [28, 36, 44, 64, 256]


def font_path(name):
    return os.path.join(FONT_DIR, name)


def en_chars():
    from effocr_torch.data.builtin_charsets import english_charsets

    cs = english_charsets()
    return cs["digits"] + cs["letters"] + cs["punctuation"]


LATIN = ("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
         " .,;:!?()-'\"")
GREEK = "αβγδεζηθικλμνξοπρστυφχψωΑΒΓΔΕΖΗΘΙΚΛΜΝΞΟΠΡΣΤΥΦΧΨΩ"
CYRILLIC = ("абвгдежзийклмнопрстуфхцчшщъыьэюяАБВГДЕЖЗИЙКЛМНОПРСТУФХЦЧШЩЪЫЬ"
            "ЭЮЯ")


def seeded_strings(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for alpha in (LATIN, LATIN + GREEK, LATIN + CYRILLIC, GREEK + " ",
                  CYRILLIC + " "):
        for _ in range(n // 5):
            out.append("".join(rng.choice(list(alpha),
                                          int(rng.integers(1, 14)))))
    return out


@functools.lru_cache(maxsize=None)
def builtin_words():
    from effocr_tpu.cli.make_corpus import BUILTIN_TEXT

    return list(BUILTIN_TEXT)


# ------------------------------------------------------------ stage 1
@pytest.mark.parametrize("name", FONTS)
@pytest.mark.parametrize("ppem", SIZES)
def test_outlines_and_bitmaps_match_freetype(name, ppem):
    """Unhinted and hinted (FT_LOAD_DEFAULT: v40) outline points, tags
    and contours, and FT_RENDER_MODE_NORMAL bitmaps with their offsets,
    for the en charset's glyphs and a seeded sample of the font's glyphs,
    composites included; and the size's scale and metrics."""
    import ft_oracle

    from effocr_torch.fonts import imagefont, sfnt
    from effocr_torch.native import glyph

    path = font_path(name)
    font = sfnt.load(path)
    ft = ft_oracle.FTFace(path, ppem)
    gids = {font.cmap.get(ord(c), 0) for c in en_chars()}
    rng = np.random.default_rng(ppem)
    gids |= set(rng.choice(font.num_glyphs, 24, replace=False).tolist())
    composites = [g for g in range(font.num_glyphs)
                  if font.loca[g + 1] > font.loca[g] and struct.unpack(
                      ">h", font.tables["glyf"][font.loca[g]:
                                               font.loca[g] + 2])[0] < 0]
    gids |= set(rng.choice(composites, 16, replace=False).tolist())
    cache = imagefont._glyphs(os.path.abspath(path),
                              os.path.getmtime(path), ppem)
    sz = glyph.Size(glyph.Face(font), ppem)
    assert sz.error == 0
    for g in sorted(gids):
        for hinted in (False, True):
            want = ft.outline(g, hinted)
            got = sz.outline(g, hinted)
            np.testing.assert_array_equal(got[0], want[0], err_msg=f"{g}")
            np.testing.assert_array_equal(got[1] & 1, want[1] & 1)
            np.testing.assert_array_equal(got[2], want[2])
        bmp, left, top = ft.bitmap(g)
        mine = cache.bitmap(g)
        assert (mine[1], mine[2]) == (left, top) or bmp.size == 0, g
        np.testing.assert_array_equal(mine[0], bmp, err_msg=f"{g}")
    x_scale, _, asc, desc, _ = ft.metrics()
    f = imagefont.truetype(path, ppem)
    assert (f.x_scale, f.ascender, f.descender) == (x_scale, asc, desc)


# ------------------------------------------------------------ stage 2
@pytest.mark.parametrize("name", FONTS)
def test_single_characters_match_pillow(name):
    """getmetrics at every size; getlength and getbbox (anchors la, mm,
    rb, lb) of a seeded sample of the font's characters at 28 and 64 px,
    combining marks (a dotted circle first), default-ignorable and
    control characters included; only complex-shaper scripts refused."""
    from PIL import ImageFont

    from effocr_torch.fonts import imagefont, sfnt

    path = font_path(name)
    cps = np.array(sfnt.load(path).coverage())
    sample = np.random.default_rng(7).choice(cps, 500, replace=False)
    sample = sorted(set(sample.tolist()) | set(range(0x300, 0x30A))
                    | {0xAD, 0x20, 0x0, 0xA0, 0x2060} & set(cps.tolist()))
    for size in SIZES:
        assert imagefont.truetype(path, size).getmetrics() == \
            ImageFont.truetype(path, size).getmetrics()
    refused = 0
    for size in (28, 64):
        pf = ImageFont.truetype(path, size)
        mf = imagefont.truetype(path, size)
        for cp in sample:
            ch = chr(cp)
            try:
                got = [mf.getlength(ch)] + [mf.getbbox(ch, a) for a in
                                            ("la", "mm", "rb", "lb")]
            except NotImplementedError as e:
                assert "ROADMAP.md" in str(e) and (
                    "complex shaper" in str(e) or "decomposes" in str(e))
                refused += 1
                continue
            want = [pf.getlength(ch)] + [pf.getbbox(ch, anchor=a) for a in
                                         ("la", "mm", "rb", "lb")]
            assert got == want, (hex(cp), size, got, want)
    assert refused < len(sample)


@pytest.mark.parametrize("name", FONTS)
def test_text_layout_and_masks_match_pillow(name):
    """textlength (kerning and ligatures), textbbox at float positions and
    every anchor, and getmask2's mask and offset at fractional starts, for
    BUILTIN_TEXT's words and lines and seeded Latin / Greek / Cyrillic
    strings, at 28, 36 and 44 px."""
    from PIL import Image, ImageDraw, ImageFont

    from effocr_torch.fonts import imagefont

    path = font_path(name)
    rng = np.random.default_rng(len(name))
    words = builtin_words()
    texts = (words[:60] + [" ".join(rng.choice(words, 6)) for _ in range(8)]
             + seeded_strings(len(name)) + ["AV", "To", "ffi", "ffl", "fi",
                                            "(Мир)", "a (б) c", "123",
                                            "«Мир» x", "‘a’ “б”", "<b>",
                                            "x (y [z) w]", "((Ж"])
    anchors = ["la", "mm", "rb", "lb", "rm", "lm", "mb", "mt", "ls", "ra",
               "md", "lt", "ma", "rd"]
    draw = ImageDraw.Draw(Image.new("L", (8, 8)))
    for size in (28, 36, 44):
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
    """ImageDraw.text into L and RGB images: fill colours, overlapping
    words blended in drawing order, text clipped at every edge."""
    from PIL import Image, ImageDraw, ImageFont

    from effocr_torch.fonts import imagefont

    rng = np.random.default_rng(3)
    for name in FONTS:
        for size in (28, 64):
            pf = ImageFont.truetype(font_path(name), size)
            mf = imagefont.truetype(font_path(name), size)
            bg = (250, 240, 230) if mode == "RGB" else 200
            im = Image.new(mode, (240, 100), bg)
            arr = np.array(im)
            d = ImageDraw.Draw(im)
            for w in rng.choice(builtin_words(), 7):
                xy = (float(rng.uniform(-40, 220)),
                      float(rng.uniform(-30, 90)))
                fill = (tuple(int(v) for v in rng.integers(0, 256, 3))
                        if mode == "RGB" else int(rng.integers(256)))
                a = ["la", "mm", "rb", "lb"][int(rng.integers(4))]
                d.text(xy, w, fill, font=pf, anchor=a)
                imagefont.draw_text(arr, xy, w, fill, mf, anchor=a)
            np.testing.assert_array_equal(arr, np.asarray(im))


def test_imaging_ops_match_pillow():
    """resize (LANCZOS and the default bicubic), GaussianBlur, invert,
    getbbox and float-box crop, on L and RGB."""
    from PIL import Image, ImageFilter, ImageOps

    from effocr_torch.data import imaging

    rng = np.random.default_rng(0)
    for h, w, oh, ow in [(300, 200, 256, 256), (1024, 700, 256, 256),
                         (37, 53, 64, 64), (120, 90, 224, 224),
                         (5, 400, 64, 64)]:
        for shape in ((h, w), (h, w, 3)):
            a = rng.integers(0, 256, shape, np.uint8)
            pim = Image.fromarray(a)
            np.testing.assert_array_equal(
                imaging.resize(a, (ow, oh), "lanczos"),
                np.asarray(pim.resize((ow, oh), Image.LANCZOS)))
            np.testing.assert_array_equal(imaging.resize(a, (ow, oh)),
                                          np.asarray(pim.resize((ow, oh))))
            box = (rng.uniform(-20, w / 2), rng.uniform(-20, h / 2),
                   rng.uniform(w / 2, w + 20), rng.uniform(h / 2, h + 20))
            np.testing.assert_array_equal(imaging.crop(a, box),
                                          np.asarray(pim.crop(box)))
            np.testing.assert_array_equal(imaging.invert(a),
                                          np.asarray(ImageOps.invert(pim)))
    a = rng.integers(0, 256, (37, 53, 3), np.uint8)
    for r in (0.3, 1.0, 1.7, 7.9):
        for x in (a, a[..., 0]):
            np.testing.assert_array_equal(
                imaging.gaussian_blur(x, r), np.asarray(
                    Image.fromarray(x).filter(ImageFilter.GaussianBlur(r))))
    z = np.zeros((20, 30, 3), np.uint8)
    assert imaging.getbbox(z) is None
    z[5, 7, 2], z[9, 20, 0] = 1, 3
    assert imaging.getbbox(z) == Image.fromarray(z).getbbox()
    assert imaging.getbbox(z[..., 0]) == Image.fromarray(z[..., 0]).getbbox()


# ------------------------------------------------------------ stage 3
@pytest.mark.parametrize("name", FONTS)
def test_render_functions_match_jax(name):
    """draw_single_char at 64 and 256, draw_single_char_ascender at 256
    (with padding), the AddAdjacentChars banks (en and jp), coverage."""
    from PIL import ImageFont

    from effocr_tpu.data import fonts as J
    from effocr_torch.data import fonts as P

    path = font_path(name)
    assert P.get_unicode_coverage_from_ttf(path) == \
        J.get_unicode_coverage_from_ttf(path)
    chars = "aAgjQ0.,%ĀжΩ"
    for cs in (64, 256):
        jf, pf = ImageFont.truetype(path, cs), P.truetype(path, cs)
        for c in chars:
            for fn in (("draw_single_char", "draw_single_char_ascender")
                       if cs == 256 else ("draw_single_char",)):
                want = getattr(J, fn)(c, jf, cs, padding=0.05)
                got = getattr(P, fn)(c, pf, cs, padding=0.05)
                assert got.shape == np.asarray(want).shape, (c, fn)
                assert (got.ndim == 3) == (want.mode == "RGB")
                np.testing.assert_array_equal(got, np.asarray(want))
    for lang in ("en", "jp"):
        np.testing.assert_array_equal(P.render_adjacent_bank(path, 48, lang),
                                      J.render_adjacent_bank(path, 48, lang))


def _tree(root):
    """{relative path: (mode, pixels) for PNGs, bytes otherwise}."""
    from PIL import Image

    out = {}
    for dp, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(dp, f)
            rel = os.path.relpath(p, root)
            if f.endswith(".png"):
                with Image.open(p) as im:
                    out[rel] = (im.mode, np.asarray(im).shape,
                                np.asarray(im).tobytes())
            else:
                with open(p, "rb") as fh:
                    out[rel] = fh.read()
    return out


def assert_same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    bad = [k for k in ta if ta[k] != tb[k]]
    assert not bad, bad[:5]
    return len(ta)


def test_render_chars_signatures_and_dedupe_match_jax(tmp_path):
    """render_chars trees (names and pixels, both draw functions,
    --square), render_signatures, dedupe_render_identical exact and with
    tol, over Latin / Cyrillic / Greek twins."""
    from effocr_tpu.data import fonts as J
    from effocr_torch.data import fonts as P

    paths = [font_path(n) for n in FONTS]
    chars = list("AАΑBcl1IOО0оo") + ["ä", "ß", "Ж"]
    for fn, square, cs in (("draw_single_char", False, 64),
                           ("draw_single_char_ascender", True, 64)):
        for pkg, mod in (("j", J), ("p", P)):
            n = mod.render_chars(paths, chars, str(tmp_path / f"{pkg}{fn}"),
                                 padding=0.05, draw_func=getattr(mod, fn),
                                 square=square, canvas_size=cs)
        assert assert_same_tree(tmp_path / f"j{fn}", tmp_path / f"p{fn}") == n
    assert P.render_signatures(chars, paths) == J.render_signatures(chars,
                                                                    paths)
    for tol in (0.0, 0.05):
        assert P.dedupe_render_identical(chars, paths, tol=tol) == \
            J.dedupe_render_identical(chars, paths, tol=tol)


def test_confusion_render_distance_matches_jax():
    """The cases of tests/test_error_analysis.py on the committed fonts:
    A / А / Α are clones, l / I near-identical, at 1e-12."""
    from effocr_tpu.eval.error_analysis import confusion_render_distance as J
    from effocr_torch.data.fonts import dedupe_render_identical
    from effocr_torch.eval.error_analysis import confusion_render_distance

    sans = font_path("DejaVuSans.ttf")
    pairs = [("A", "А"), ("A", "B"), ("A", "A"), ("l", "I"), ("Α", "А"),
             ("ab", "a"), ("Ж", "ж")]
    for fonts in ([sans], [font_path(n) for n in FONTS]):
        got, want = confusion_render_distance(pairs, fonts), J(pairs, fonts)
        assert got.keys() == want.keys()
        for k in want:
            if want[k] != want[k]:
                assert got[k] != got[k], k
            else:
                assert abs(got[k] - want[k]) <= 1e-12, k
    d = confusion_render_distance(pairs, [sans])
    assert d[("A", "A")] == 0.0 and d[("A", "А")] == 0.0
    assert 0.0 <= d[("l", "I")] < d[("A", "B")]
    kept, dropped = dedupe_render_identical(["A", "B", "А", "Α", "c"], [sans])
    assert {x for x, _ in dropped} == {"А", "Α"}
    assert dedupe_render_identical(["l", "I"], [sans])[1] == []
    assert dedupe_render_identical(["l", "I"], [sans], tol=0.05)[1] == [
        ("I", "l")]


# ------------------------------------------------------------ stage 4
def _run_jax(module, argv):
    old = sys.argv
    sys.argv = [module.__name__] + list(argv)
    try:
        module.main()
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def font_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fonts")
    for n in FONTS:
        shutil.copy(font_path(n), d)
    return str(d)


@pytest.fixture(scope="module")
def gc_charset(tmp_path_factory):
    """Greek and Cyrillic letters (codepoints >= 0x100, as the jp path
    keeps them) as a charset file."""
    d = tmp_path_factory.mktemp("gc")
    p = d / "gc.txt"
    p.write_text("\n".join(f"GC\t{ord(c)}\t{c}" for c in GREEK + CYRILLIC))
    return str(p)


CORPUS_CASES = {
    "en": ["--lang", "en", "--noise_std", "8", "--blur_sigma", "1"],
    "jp": ["--lang", "jp", "--max_charset", "40", "--blur_sigma", "1.5"],
    "jp_vertical": ["--lang", "jp", "--vertical", "--noise_std", "4"],
}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory, font_dir, gc_charset):
    from effocr_tpu.cli import make_corpus as J
    from effocr_torch.cli import make_corpus as P

    root = tmp_path_factory.mktemp("corpora")
    for case, flags in CORPUS_CASES.items():
        extra = ["--charset_file", gc_charset] if "jp" in case else []
        for pkg in ("j", "p"):
            argv = ["--out_dir", str(root / f"{case}_{pkg}"), "--n_lines",
                    "10", "--font_dir", font_dir, "--seed", "5", *flags,
                    *extra]
            if pkg == "j":
                _run_jax(J, argv)
            else:
                P.main(argv)
    return root


@pytest.mark.parametrize("case", list(CORPUS_CASES))
def test_make_corpus_matches_jax(case, corpora):
    a, b = corpora / f"{case}_j", corpora / f"{case}_p"
    assert (a / "corpus.json").read_bytes() == (b / "corpus.json").read_bytes()
    assert assert_same_tree(a, b) == 11
    coco = json.loads((b / "corpus.json").read_text())
    assert sum(x["category_id"] == 0 for x in coco["annotations"]) > 10


CHARSET_CASES = {
    "union": ["--mode", "union", "--min_codepoint", "880", "--max_chars",
              "100", "--dedupe_renders"],
    "intersection": ["--mode", "intersection", "--max_chars", "150"],
    "dedupe_tol": ["--min_codepoint", "32", "--max_chars", "96",
                   "--dedupe_renders", "--dedupe_tol", "0.05", "--name",
                   "ENG"],
}


@pytest.mark.parametrize("case", list(CHARSET_CASES))
def test_make_charset_matches_jax(case, tmp_path, font_dir, capsys):
    from effocr_tpu.cli import make_charset as J
    from effocr_torch.cli import make_charset as P

    outs = {}
    for pkg in ("j", "p"):
        out = tmp_path / pkg / "eng_chars.txt"
        argv = ["--font_dir", font_dir, "--out", str(out),
                *CHARSET_CASES[case]]
        _run_jax(J, argv) if pkg == "j" else P.main(argv)
        outs[pkg] = (out.read_bytes(), capsys.readouterr().out.replace(
            str(tmp_path / pkg), ""))
    assert outs["p"] == outs["j"]


@pytest.fixture(scope="module")
def en_charset_dir(tmp_path_factory, font_dir):
    from effocr_torch.cli import make_charset as P

    d = tmp_path_factory.mktemp("charsets_eng")
    P.main(["--font_dir", font_dir, "--out", str(d / "eng_chars.txt"),
            "--min_codepoint", "33", "--max_chars", "40"])
    return str(d)


@pytest.mark.parametrize("square", [False, True])
def test_format_dataset_matches_jax(square, tmp_path, corpora, font_dir,
                                    en_charset_dir):
    """--spaces --clip_to_top_and_bottom on the en corpus, ascender
    renders (an 'eng' charset dir), with and without --square: crops,
    renders, charset file, dataset_meta.json."""
    from effocr_tpu.cli import format_dataset as J
    from effocr_torch.cli import format_dataset as P

    corpus = corpora / "en_j"
    for pkg in ("j", "p"):
        argv = ["--image_dir", str(corpus / "images"), "--coco_jsons",
                str(corpus / "corpus.json"), "--crops_save_dir",
                str(tmp_path / f"crops_{pkg}"), "--cat_id", "0", "--spaces",
                "--clip_to_top_and_bottom", "--font_dir", font_dir,
                "--charset_dir", en_charset_dir, "--dataset_save_dir",
                str(tmp_path / f"tree_{pkg}")] + (["--square"] if square
                                                  else [])
        _run_jax(J, argv) if pkg == "j" else P.main(argv)
    assert_same_tree(tmp_path / "crops_j", tmp_path / "crops_p")
    n = assert_same_tree(tmp_path / "tree_j", tmp_path / "tree_p")
    assert n > 100
    meta = json.loads((tmp_path / "tree_p" / "dataset_meta.json").read_text())
    assert meta == {"crop_geometry": "line"}


# ------------------------------------------------------------ stage 5
@pytest.mark.parametrize("spaces,clip", [(True, False), (True, True)])
def test_extract_char_crops_matches_jax(spaces, clip, tmp_path, corpora):
    from effocr_tpu.data.coco import extract_char_crops as J
    from effocr_torch.data.coco import extract_char_crops as P

    for case in ("en", "jp_vertical"):
        src = corpora / f"{case}_p"
        coco = json.loads((src / "corpus.json").read_text())
        outs = []
        for pkg, fn in (("j", J), ("p", P)):
            out = tmp_path / f"{case}_{pkg}"
            outs.append(fn(coco, str(src / "images"), str(out), cat_id=0,
                           spaces=spaces, clip=clip))
        assert outs[0] == outs[1] > 0
        assert_same_tree(tmp_path / f"{case}_j", tmp_path / f"{case}_p")


# ------------------------------------------------------------ stage 6
def _adjacent_draws(key, b, bank_shape, lang):
    """augment_batch's neighbour-glyph draws from its key: keys[17]
    split three ways (data/transforms.py _compose_adjacent)."""
    import jax
    import jax.numpy as jnp

    v, n = bank_shape[:2]
    probs = jnp.asarray([0.7, 0.2, 0.05, 0.05, 0.0] if lang == "jp"
                        else [0.5, 0.25, 0.25])
    k_n, k_perm, k_glyph = jax.random.split(jax.random.split(key, 19)[17], 3)
    return {"adj_n": jax.random.choice(k_n, probs.shape[0], (b,), p=probs),
            "adj_u": jax.random.uniform(k_perm, (b, v)),
            "adj_glyph": jax.random.randint(k_glyph, (b, v), 0, n)}


@pytest.mark.parametrize("lang,channels", [("en", 3), ("jp", 1)])
def test_compose_adjacent_matches_jax(lang, channels):
    """augment_batch with adjacent_bank against apply_augment with the
    bank, on the JAX draws (test_torch_data.py's tolerance)."""
    import jax
    import jax.numpy as jnp
    import torch
    from test_torch_data import jax_draws, torch_draws

    from effocr_tpu.data.transforms import augment_batch
    from effocr_torch.data.fonts import render_adjacent_bank
    from effocr_torch.data.transforms import apply_augment, draw_augment

    size, b = 32, 8
    bank = render_adjacent_bank(font_path("DejaVuSerif.ttf"), size, lang)
    rng = np.random.default_rng(len(lang))
    imgs = rng.integers(0, 256, (b, size, size, 3), np.uint8)
    imgs[:, :, : size // 2] = 255
    paired = rng.uniform(size=b) < 0.3
    key = jax.random.PRNGKey(17)

    def run(x, p, k, bk):
        return (augment_batch(x, p, k, lang=lang, adjacent_bank=bk,
                              paired_jitter=0.3, out_channels=channels),
                {**jax_draws(k, b, size, lang, False, 0.0, 0.3),
                 **_adjacent_draws(k, b, bank.shape, lang)})

    ref, draws = jax.jit(run)(jnp.asarray(imgs), jnp.asarray(paired), key,
                              jnp.asarray(bank))
    got = apply_augment(torch.from_numpy(imgs), torch.from_numpy(paired),
                        torch_draws(draws), lang=lang, paired_jitter=0.3,
                        out_channels=channels,
                        adjacent_bank=torch.from_numpy(bank)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
    # the composite itself against JAX's, exact
    from effocr_tpu.data.transforms import _compose_adjacent as j_compose
    from effocr_torch.data.transforms import _compose_adjacent

    x = imgs.astype(np.float32) / 255.0
    want = j_compose(jnp.asarray(x), jnp.asarray(bank),
                     jax.random.split(key, 19)[17], lang)
    got = _compose_adjacent(torch.from_numpy(x), torch.from_numpy(bank),
                            torch_draws(draws), lang)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the port's own draws: shapes, ranges, the side counts' support
    d = draw_augment(torch.Generator().manual_seed(0), 256, size, lang=lang,
                     adjacent=bank.shape[:2])
    assert d["adj_u"].shape == (256, bank.shape[0])
    assert int(d["adj_glyph"].max()) < bank.shape[1]
    assert int(d["adj_n"].max()) <= bank.shape[0]
    assert set(d["adj_n"].tolist()) <= set(range(bank.shape[0] + 1))


def test_train_step_with_adjacent_bank_matches_jax(cut_mobilenet_fonts):
    """One train-recognizer step with --adjacent_font_path (float32,
    32 px, mobilenetv3_small_050): loss and gradients against the JAX
    step at test_torch_train.py's tolerances."""
    adjacent_step_matches_jax(font_path("DejaVuSerif.ttf"))


def adjacent_step_matches_jax(serif):
    """The step of test_train_step_with_adjacent_bank_matches_jax with
    the bank of the font at ``serif``."""
    import jax
    import jax.numpy as jnp
    import torch
    from test_torch_data import jax_draws, torch_draws
    from test_torch_train import (
        _GradRecorder,
        _capture_grads,
        _np,
        _seeded_vars,
        _step_models,
    )

    from effocr_tpu.core.config import EncoderConfig as JEncoderConfig
    from effocr_tpu.core.config import RecognizerTrainConfig as JTrainConfig
    from effocr_tpu.data.fonts import render_adjacent_bank as j_bank
    from effocr_tpu.train.recognizer import make_train_step as j_make_step
    from effocr_torch.core.config import EncoderConfig, RecognizerTrainConfig
    from effocr_torch.data.fonts import render_adjacent_bank
    from effocr_torch.interop.flax_bridge import flax_to_state_dict
    from effocr_torch.train.recognizer import make_train_step

    arch, channels, b, size, n_cls = "mobilenetv3_small_050", 1, 8, 32, 4
    bank = render_adjacent_bank(serif, size, "en")
    np.testing.assert_array_equal(bank, j_bank(serif, size, "en"))
    cfg_kw = dict(batch_size=b, lang="en", paired_jitter=0.5,
                  aux_ce_weight=1.0, adjacent_font_path=serif)
    jcfg = JTrainConfig(encoder=JEncoderConfig(arch=arch, image_size=size,
                                               input_channels=channels),
                        **cfg_kw)
    tcfg = RecognizerTrainConfig(encoder=EncoderConfig(
        arch=arch, image_size=size, input_channels=channels), **cfg_kw)
    jm, tm = _step_models(arch, channels)
    variables, dim = _seeded_vars(arch, channels, 3, tm)
    rng = np.random.default_rng(14)
    w = rng.normal(size=(n_cls, dim)).astype(np.float32)
    imgs = rng.integers(0, 256, (b, size, size, 3), np.uint8)
    imgs[:, :, : size // 2] = 255
    targets = rng.integers(0, n_cls, b).astype(np.int32)
    paired = rng.uniform(size=b) < 0.3
    key = jax.random.PRNGKey(23)
    state = {"params": variables["params"],
             "batch_stats": variables.get("batch_stats", {}),
             "aux": {"w": jnp.asarray(w)}}
    state["opt_state"] = _capture_grads().init(
        {"model": state["params"], "aux": state["aux"]})
    jstep = j_make_step(jm, jcfg, _capture_grads(), False, use_aux=True,
                        adjacent_bank=jnp.asarray(bank))
    (new, jloss), draws = jax.jit(lambda *a: (jstep(*a), {
        **jax_draws(a[-1], b, size, "en", False, 0.0, 0.5),
        **_adjacent_draws(a[-1], b, bank.shape, "en")}))(
        state, jnp.asarray(imgs), jnp.asarray(targets), jnp.asarray(paired),
        key)
    jgrads = _np(new["opt_state"]["g"])

    tm.load_state_dict(flax_to_state_dict(variables))
    aux = torch.tensor(w, requires_grad=True)
    named = dict(tm.named_parameters())
    named["aux"] = aux
    rec = _GradRecorder(named)
    tstep = make_train_step(tm, tcfg, rec, False, aux=aux,
                            adjacent_bank=torch.from_numpy(bank))
    tloss = tstep(torch.from_numpy(imgs), torch.from_numpy(targets).long(),
                  torch.from_numpy(paired), torch_draws(draws))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    ref = flax_to_state_dict({"params": jgrads["model"]})
    ref["aux"] = torch.from_numpy(np.array(jgrads["aux"]["w"]))
    assert ref.keys() == rec.grads.keys()
    gmax = max(float(g.abs().max()) for g in ref.values())
    for k, g in ref.items():
        np.testing.assert_allclose(rec.grads[k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * gmax, err_msg=k)


@pytest.fixture
def cut_mobilenet_fonts(monkeypatch):
    """test_torch_train.py's cut_mobilenet: 4 of the 11 block specs in
    both packages (the same arithmetic at half the JAX compile)."""
    from effocr_tpu.models import mobilenetv3 as j_mnv3
    from effocr_torch.models import mobilenetv3 as t_mnv3

    for module in (j_mnv3, t_mnv3):
        monkeypatch.setattr(module, "SMALL_SPECS", tuple(
            module.SMALL_SPECS[i] for i in (0, 1, 3, 4)))


# ------------------------------------------------------------ refusals
def _sfnt(tag: bytes, tables):
    """A font file header with ``tables`` (tag -> bytes)."""
    n = len(tables)
    head = struct.pack(">4sHHHH", tag, n, 0, 0, 0)
    off = 12 + 16 * n
    recs, body = b"", b""
    for t, data in tables.items():
        recs += struct.pack(">4sIII", t, 0, off + len(body), len(data))
        body += data
    return head + recs + body


@pytest.mark.parametrize("case,feature", [
    ("cff2", "CFF2 outlines"), ("ttc", "TrueType collections"),
    ("variable", "variable fonts"), ("bitmap", "embedded bitmap strikes"),
    ("no_bytecode", "without bytecode"), ("complex", "complex shaper")])
def test_refusals_name_their_feature(case, feature, tmp_path):
    from effocr_torch.data import fonts as P

    p = tmp_path / "f.ttf"
    if case == "cff2":
        p.write_bytes(_sfnt(b"OTTO", {b"CFF2": b"\0" * 8}))
    elif case == "ttc":
        p.write_bytes(b"ttcf" + b"\0" * 16)
    elif case == "variable":
        p.write_bytes(_sfnt(b"\0\1\0\0", {b"fvar": b"\0" * 8}))
    elif case == "bitmap":
        # a real EBLC / EBDT strike at the size asked for: FreeType hands
        # its bitmaps back there
        from fontTools.ttLib import TTFont

        from torch_fixtures import make_bitmap_fonts as mb

        f = TTFont(font_path("DejaVuSansMono.ttf"))
        g = f.getGlyphOrder().index(f.getBestCmap()[ord("a")])
        tables = mb.eblc_ebdt([{
            "ppem_x": 32, "ppem_y": 32, "depth": 1, "index_format": 1,
            "image_format": 2, "first": g, "last": g,
            "bitmaps": {g: (np.ones((3, 2), np.uint8), 1, 3, 4)}}])
        for tag, data in zip(("EBLC", "EBDT"), tables):
            f[tag] = mb._raw_table(tag, data)
        f.save(str(p))
    elif case == "no_bytecode":
        from fontTools.ttLib import TTFont

        f = TTFont(font_path("DejaVuSansMono.ttf"))
        for t in ("fpgm", "prep", "cvt "):
            del f[t]
        f["maxp"].maxSizeOfInstructions = 0
        f.save(str(p))
    else:
        p = font_path("DejaVuSans.ttf")
    with pytest.raises(NotImplementedError, match=feature) as e:
        font = P.truetype(str(p), 32)
        P.draw_single_char("سلام", font, 32)
    assert "ROADMAP.md" in str(e.value)


def test_goldens_match_the_port():
    """The committed golden.npz (make_fonts.py, from the JAX package)
    against the port's renders: a sample of the en characters in every
    font, both banks.  chip_smoke.py checks all of them on the card's
    host, and the pipeline digests."""
    from effocr_torch.data import fonts as P
    from effocr_torch.data.imaging import digest_image

    g = np.load(os.path.join(FONT_DIR, "golden.npz"))
    want = dict(zip(g["render_keys"].tolist(), g["render_digests"].tolist()))
    assert len(want) == 3 * 90 * 2
    for name in FONTS:
        font = P.truetype(font_path(name), 256)
        for c in "aQ7&,":
            for kind, fn in (("single", P.draw_single_char),
                             ("ascender", P.draw_single_char_ascender)):
                img = fn(c, font, 256)
                assert digest_image(img, "L" if img.ndim == 2 else "RGB") \
                    == want[f"{name}|{kind}|{ord(c)}"], (name, kind, c)
    for lang in ("en", "jp"):
        bank = P.render_adjacent_bank(font_path("DejaVuSerif.ttf"), 128, lang)
        assert digest_image(bank, "L") == str(g[f"bank_{lang}"])
