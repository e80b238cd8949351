"""effocr_torch's TIFF reader on every sample layout Pillow 12.1 opens,
against Pillow (libtiff 4.7.1, libjpeg-turbo 3.1.3, Little CMS 2) and
the JAX package, on the CPU.

Every case is a file written by tests/torch_fixtures/make_images.py
(``tiff_layout``: any sample format, 12 / 32-bit samples, extra samples,
libtiff's floating-point predictor) from seeded numpy, 23 x 41 so that
16 x 16 edge tiles are padded:

- the layouts of Pillow's ``OPEN_INFO`` beyond 8 / 16-bit unsigned ones:
  float (F, NaN / infinities / -0.0 among the samples), signed 8 / 16 /
  32-bit, unsigned 32-bit, 12-bit, 16-bit MinIsWhite, RGB with extra
  samples (unspecified, associated and unassociated alpha, 1-3 extra),
  16-bit RGBA / RGBX / RGBa, PX and PA, 16-bit and extra-sample CMYK,
  YCbCr (one sample; three outside JPEG, 1x1 or subsampled, converted
  as libtiff converts them) and CIELab; each in both byte orders (Pillow opens
  some little-endian only, and misreads big-endian 32-bit and signed
  16-bit words libtiff hands it: the port does the same), as
  uncompressed strips, Deflate strips with predictor 2, PackBits tiles
  and separate Deflate planes, some as uncompressed planes (LZW in the
  predictor, engine and fixture cases); layouts of byte samples take
  both orders as uncompressed strips and one in each other container;
- the port's layout table against Pillow's ``OPEN_INFO``, key for key;
- predictor 3 after LZW and Deflate, in strips and tiles, both orders;
  OSError where libtiff refuses a predictor;
- the new modes through ``image_io.header``, ``read_rgb``, ``read_l``
  (the same exception where Pillow refuses, LAB -> L), ``imaging
  .open_image`` against what Pillow holds, and the port's ``_LazyImage``
  against the JAX package's under both channel rules;
- Pillow's LAB -> RGB (Little CMS) on a sweep of LAB values;
- JPEG strips and tiles cut inside their byte counts: Pillow's pixels;
  a cut stand-alone JPEG and a file cut before a segment's end: OSError;
- CCITT strips and tiles (modified Huffman, T.4 1-D and 2-D, T.6) cut
  inside their byte counts: libtiff's rows, the rest as Pillow's reused
  buffer holds them, OSError where libtiff fails a strip; a single group
  4 strip: libtiff's rows, then zeros where Pillow shows memory;
- ``extract_char_crops`` over I, F, PA and LAB pages against the JAX
  package (the same PNGs, or the same OSError);
- (``engine.run`` over float, associated-alpha, signed and LAB lines:
  test_torch_tiff_layouts.py, which holds the engine's other TIFF lines)
- the committed ``SAMPLE_FILES`` against their goldens.
Tolerance: none (exact equality; NaN equal to NaN) throughout.
"""

from __future__ import annotations

import io
import os
import warnings

import numpy as np
import pytest
from PIL import Image

from effocr_tpu.data import coco as j_coco
from effocr_tpu.pipelines import infer as j_infer
from effocr_torch.data import coco as t_coco
from effocr_torch.data import image_io, imaging, lab, tiff
from effocr_torch.pipelines import infer as t_infer
from test_torch_image_modes import H, W, _coco
from torch_fixtures import make_images as mi

SHAPE = (23, 41)


# ------------------------------------------------------------ content
def _float(r):
    v = r.normal(120, 140, SHAPE).astype(np.float32)
    v[0, :8] = [np.nan, np.inf, -np.inf, -0.0, 1e30, 254.99, 0.5, -3.7]
    return v


def _ints(lo, hi, c=None):
    return lambda r: r.integers(lo, hi, SHAPE + ((c,) if c else ()),
                                np.int64)


def _assoc(r, c=4, bits=8):
    """RGB premultiplied by alpha (0, 255, 1, 128 among the alphas), and
    ``c`` - 4 more samples."""
    top = (1 << bits) - 1
    a = r.integers(0, top + 1, SHAPE)
    a[0, :4] = [0, top, 1, top // 2]
    rgb = r.integers(0, top + 1, SHAPE + (3,)) * a[..., None] // top
    return np.dstack([rgb, a] + [r.integers(0, top + 1, SHAPE)] * (c - 4))


def _ex(*v):
    return {338: (3, list(v))}


_CMAP = {320: (3, list(np.random.default_rng(0).integers(0, 65536, 768)))}

# layout -> (samples of a seeded rng, tiff_layout keywords)
LAYOUTS = {
    "float": (_float, dict(bits=32, sample_format=3)),
    "float_miniswhite": (_float, dict(bits=32, sample_format=3,
                                      photometric=0)),
    "int32": (_ints(-2**31, 2**31), dict(bits=32, sample_format=2)),
    "int16": (_ints(-2**15, 2**15), dict(bits=16, sample_format=2)),
    "int8": (_ints(-128, 128), dict(sample_format=2)),
    "uint32": (_ints(0, 2**32), dict(bits=32)),
    "gray12": (_ints(0, 4096), dict(bits=12)),
    "gray16_miniswhite": (_ints(0, 700), dict(bits=16, photometric=0)),
    "rgba_unspecified": (_ints(0, 256, 4), dict(photometric=2)),
    "rgba_999": (_ints(0, 256, 4), dict(photometric=2,
                                        extra_tags=_ex(999))),
    "rgbx": (_ints(0, 256, 4), dict(photometric=2, extra_tags=_ex(0))),
    "rgba_assoc": (_assoc, dict(photometric=2, extra_tags=_ex(1))),
    "rgbxx": (_ints(0, 256, 5), dict(photometric=2, extra_tags=_ex(0, 0))),
    "rgba_assoc_x": (lambda r: _assoc(r, 5),
                     dict(photometric=2, extra_tags=_ex(1, 0))),
    "rgbax": (_ints(0, 256, 5), dict(photometric=2, extra_tags=_ex(2, 0))),
    "rgbxxx": (_ints(0, 256, 6), dict(photometric=2,
                                      extra_tags=_ex(0, 0, 0))),
    "rgba_assoc_xx": (lambda r: _assoc(r, 6),
                      dict(photometric=2, extra_tags=_ex(1, 0, 0))),
    "rgbaxx": (_ints(0, 256, 6), dict(photometric=2,
                                      extra_tags=_ex(2, 0, 0))),
    "rgba16_unspecified": (_ints(0, 65536, 4), dict(bits=16,
                                                    photometric=2)),
    "rgbx16": (_ints(0, 65536, 4), dict(bits=16, photometric=2,
                                        extra_tags=_ex(0))),
    "rgba16_assoc": (lambda r: _assoc(r, bits=16),
                     dict(bits=16, photometric=2, extra_tags=_ex(1))),
    "px": (_ints(0, 256, 2), dict(photometric=3,
                                  extra_tags={**_ex(0), **_CMAP})),
    "pa": (_ints(0, 256, 2), dict(photometric=3,
                                  extra_tags={**_ex(2), **_CMAP})),
    "cmyk16": (_ints(0, 65536, 4), dict(bits=16, photometric=5)),
    "cmykx": (_ints(0, 256, 5), dict(photometric=5, extra_tags=_ex(0))),
    "cmykxx": (_ints(0, 256, 6), dict(photometric=5,
                                      extra_tags=_ex(0, 0))),
    "ycbcr_gray": (_ints(0, 256), dict(photometric=6)),
    "ycbcr": (_ints(0, 256, 3), dict(photometric=6,
                                     extra_tags={530: (3, [1, 1])})),
    "lab": (_ints(0, 256, 3), dict(photometric=8)),
}
CONTAINERS = {
    "raw": dict(rows_per_strip=8),
    "deflate_pred2": dict(compression=8, predictor=2, rows_per_strip=16),
    "tiles": dict(compression=32773, tile=(16, 16)),
    "planes": dict(compression=8, planar=2),
}
# uncompressed planes: Pillow unpacks plane k with the rawmode's k-th
# letter (a native 32-bit unpacker for one-sample float and int32)
CONTAINERS["raw_planes"] = dict(planar=2, tile=(16, 16))
RAW_PLANES = ("float", "int32", "int16", "gray12", "int8", "rgba_999",
              "rgba_unspecified", "rgbx", "rgba_assoc", "pa", "lab", "cmykx")
# where samples are bytes, the byte order changes only the header and
# the table key: both orders as raw strips, one order for each other
# container (the two orders between them)
BYTE_ORDERS = {"raw": "<>", "deflate_pred2": ">", "tiles": "<",
               "planes": ">", "raw_planes": "<"}


def _cases():
    cases = {}
    for lay, (make, args) in LAYOUTS.items():
        multi = make(np.random.default_rng(0)).ndim == 3
        for box in CONTAINERS:
            # one-sample layouts in compressed planes are their strips
            if (box == "planes" and not multi
                    or box == "raw_planes" and lay not in RAW_PLANES):
                continue
            wide = args.get("bits", 8) > 8
            for order in "<>" if wide else BYTE_ORDERS[box]:
                cases[f"{lay}-{box}-{'mm' if order == '>' else 'ii'}"] = (
                    lay, box, order)
    return cases


CASES = _cases()


def layout_file(lay: str, box: str, order: str, **kw) -> bytes:
    make, args = LAYOUTS[lay]
    r = np.random.default_rng(sum(map(ord, lay)))
    return mi.tiff_layout(make(r), order=order,
                          **{**args, **CONTAINERS[box], **kw})


def _write(d, name: str, data: bytes) -> str:
    p = os.path.join(str(d), name + ".tif")
    with open(p, "wb") as f:
        f.write(data)
    return p


# ------------------------------------------------------------ oracles
def pillow_view(path: str):
    """(mode, samples as the port holds them, palette, size) of
    ``Image.open``: 1 as 0 / 255, 16-bit as their values."""
    with Image.open(path) as im:
        im.load()
        px = np.asarray(im)
        if im.mode == "1":
            px = px.astype(np.uint8) * np.uint8(255)
        elif px.dtype.kind == "u" and px.dtype.itemsize == 2:
            px = px.astype(np.uint16)
        pal = None
        if im.mode in ("P", "PA"):
            pal = np.array(im.getpalette(), np.uint8).reshape(-1, 3)
        return im.mode, px, pal


def converted(path: str, mode: str):
    """``Image.open(path).convert(mode)`` as an array, or the exception
    type it raises."""
    with Image.open(path) as im:
        try:
            return np.asarray(im.convert(mode))
        except Exception as e:  # noqa: BLE001 (the type is the oracle)
            return type(e)


def assert_same(got, want, what):
    if isinstance(want, type):
        assert isinstance(got, want), (what, got, want)
    else:
        np.testing.assert_array_equal(got, want, err_msg=str(what))


def attempt(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001
        return e


def assert_like_pillow_and_jax(p: str):
    """Header, both conversions, ``open_image`` and both ``_LazyImage``
    rules against Pillow and the JAX package; where Pillow cannot open the
    file, OSError from every reader."""
    try:
        with Image.open(p) as im:
            (w, h), mode = im.size, im.mode
            im.load()
    except (OSError, ValueError):
        for fn in (image_io.read_rgb, image_io.read_l, imaging.open_image,
                   lambda q: t_infer._LazyImage(q, gray=True).load()):
            with pytest.raises(OSError, match="TIFF"):
                fn(p)
        return None
    assert image_io.header(p) == (h, w, mode)
    assert_same(attempt(image_io.read_rgb, p), converted(p, "RGB"), p)
    assert_same(attempt(image_io.read_l, p), converted(p, "L"), p)
    got = imaging.open_image(p)
    want = pillow_view(p)
    assert (got.mode, got.px.dtype) == (want[0], want[1].dtype), p
    np.testing.assert_array_equal(got.px, want[1], err_msg=p)
    if want[2] is None:
        assert got.palette is None, p
    else:
        np.testing.assert_array_equal(got.palette,
                                      want[2][:len(got.palette)])
    for gray in (True, False):
        t, j = t_infer._LazyImage(p, gray), j_infer._LazyImage(p, gray)
        assert t.shape == j.shape, (p, gray)
        np.testing.assert_array_equal(t.load(), j.load(), err_msg=p)
    return mode


# ------------------------------------------------------------ parity
@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("samples")


# refused by name: Pillow's pixels there are not the file's (PA planes:
# alpha 0; RGBA planes past a tile edge: a 3-sample stride; uncompressed
# YCbCr: 4 bytes a pixel read)
REFUSED = {("pa", "planes"), ("rgba_unspecified", "raw_planes"),
           ("ycbcr", "raw")}


def test_open_info_is_pillows():
    """The port's layout table is Pillow's ``OPEN_INFO`` for FillOrder 1,
    key for key: a layout missed or mistyped there would be refused where
    Pillow and the JAX package read it."""
    from PIL import TiffImagePlugin as tip

    want = {(bo == tip.MM, ph, sf, bits, extra): v
            for (bo, ph, sf, fo, bits, extra), v in tip.OPEN_INFO.items()
            if fo == 1}
    assert tiff._OPEN_INFO == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_matches_pillow_and_jax(case, case_dir):
    lay, box, order = CASES[case]
    p = _write(case_dir, case, layout_file(lay, box, order))
    if (lay, box) in REFUSED:
        with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1"):
            image_io.read_rgb(p)
        return
    assert_like_pillow_and_jax(p)


@pytest.mark.parametrize("sub", [(4, 4), (4, 2), (4, 1), (2, 2), (2, 1),
                                 (1, 2), (2, 4), (1, 4)])
def test_subsampled_ycbcr_reads_as_libtiff_does(sub, tmp_path):
    """Subsampled YCbCr outside JPEG: each pixel its block's Cb and Cr
    (libtiff's put routines), in strips of odd heights and in tiles,
    oriented; 2x4 and 1x4, which libtiff has no routine for, raise
    OSError; 4x4 where libtiff misreads it (an odd count of blocks a
    strip row, edge tiles) is refused by name."""
    r = np.random.default_rng(sum(sub))
    img = _ints(0, 256, 3)(r)
    files = {
        "strips": dict(rows_per_strip=7, compression=8),
        "tiles": dict(tile=(16, 16), compression=5),
        "even": dict(compression=32773, extra_tags={274: (3, [6])}),
    }
    for name, kw in files.items():
        im = img[:, :40] if name == "even" else img
        et = {530: (3, list(sub)), **kw.pop("extra_tags", {})}
        p = _write(tmp_path, name, mi.tiff_layout(
            im, photometric=6, extra_tags=et,
            encode=mi.ycbcr_encoder(sub, kw["compression"]), **kw))
        if sub == (4, 4) and name != "even":
            with pytest.raises(NotImplementedError, match="4x4"):
                image_io.read_rgb(p)
            continue
        mode = assert_like_pillow_and_jax(p)
        assert mode == (None if sub in ((2, 4), (1, 4)) else "RGB"), name


def test_ycbcr_converts_as_libtiff_does(tmp_path):
    """YCbCr at 1x1 outside JPEG: libtiff's RGBA interface converts it
    (its tables, with the file's YCbCrCoefficients and fractional
    ReferenceBlackWhite, orientation applied once); subsampled in planes
    (libtiff reads only 1x1 there) raises OSError."""
    r = np.random.default_rng(9)
    img = _ints(0, 256, 3)(r)
    tags = {530: (3, [1, 1]), 529: (5, [2126, 10000, 7152, 10000, 722,
                                         10000]),
            532: (5, [15, 2, 235, 1, 127, 2, 241, 1, 128, 1, 200, 1])}
    for name, kw in (("tags", dict(compression=5, extra_tags=tags)),
                     ("orient6", dict(compression=8, tile=(16, 16),
                                      extra_tags={530: (3, [1, 1]),
                                                  274: (3, [6])}))):
        assert assert_like_pillow_and_jax(_write(tmp_path, name,
                                                 mi.tiff_layout(
            img, photometric=6, **kw))) == "RGB"
    p = _write(tmp_path, "s22", mi.tiff_layout(img, photometric=6,
                                               compression=5, planar=2))
    assert assert_like_pillow_and_jax(p) is None


def test_refused_planes_are_the_ones_pillow_misreads(tmp_path):
    """PA planes (Pillow's alpha reads 0), PX in tiled planes (Pillow
    reads every other index of the first plane) and unspecified-alpha
    RGBA in uncompressed planes past a tile edge (Pillow's stride there
    counts 3 samples): refused by name, and Pillow's pixels are not the
    file's."""
    r = np.random.default_rng(1)
    idx = _ints(0, 256, 2)(r)
    rgba = _ints(0, 256, 4)(r)
    cases = {
        "pa": (idx, dict(photometric=3, planar=2, compression=8,
                         extra_tags={**_ex(2), **_CMAP})),
        "px": (idx, dict(photometric=3, planar=2, compression=8,
                         tile=(16, 16), extra_tags={**_ex(0), **_CMAP})),
        "rgba": (rgba, dict(photometric=2, planar=2, tile=(16, 16))),
    }
    for name, (img, kw) in cases.items():
        p = _write(tmp_path, name, mi.tiff_layout(img, **kw))
        held = pillow_view(p)[1]
        file_px = img[..., 0] if name == "px" else img
        assert not np.array_equal(held, file_px.astype(np.uint8)), name
        with pytest.raises(NotImplementedError,
                           match="planar configuration 2.*ROADMAP"):
            image_io.read_rgb(p)


@pytest.mark.parametrize("comp", [5, 8])
@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("tile", [None, (16, 16)])
def test_float_predictor_matches_pillow(comp, order, tile, tmp_path):
    """libtiff's floating-point predictor (byte planes, most significant
    first, summed along the row) after LZW and Deflate; Pillow's
    big-endian misread of libtiff's words included."""
    r = np.random.default_rng(comp)
    data = mi.tiff_layout(_float(r), bits=32, sample_format=3, order=order,
                          compression=comp, predictor=3, tile=tile,
                          rows_per_strip=None if tile else 9)
    p = _write(tmp_path, "f", data)
    assert assert_like_pillow_and_jax(p) == "F"
    px = imaging.open_image(p).px
    want = _float(np.random.default_rng(comp))
    np.testing.assert_array_equal(px, want if order == "<" else
                                  want.byteswap())


@pytest.mark.parametrize("case", ["predictor3_int8", "predictor3_uint32",
                                  "predictor2_12bit", "int_rgb_format",
                                  "void_format", "gray12_mm",
                                  "uint32_mm", "gray16_miniswhite_mm"])
def test_what_libtiff_or_pillow_refuses_raises_oserror(case, tmp_path):
    """Predictor 3 on integer samples, predictor 2 on 12-bit samples
    (libtiff), a per-sample signed RGB, sample format 4 and the layouts
    Pillow opens little-endian only: OSError in both."""
    r = np.random.default_rng(2)
    g = _ints(0, 256)(r)
    data = {
        "predictor3_int8": lambda: mi.tiff_layout(
            g, sample_format=2, compression=8, predictor=3),
        "predictor3_uint32": lambda: mi.tiff_layout(
            g, bits=32, compression=5, predictor=3),
        "predictor2_12bit": lambda: mi.tiff_layout(g, bits=12,
                                                   compression=5,
                                                   predictor=2),
        "int_rgb_format": lambda: mi.tiff_layout(
            _ints(0, 100, 3)(r), photometric=2, sample_format=2),
        "void_format": lambda: mi.tiff_layout(g, extra_tags={339: (3, [4])}),
        "gray12_mm": lambda: mi.tiff_layout(g, bits=12, order=">"),
        "uint32_mm": lambda: mi.tiff_layout(g, bits=32, order=">"),
        "gray16_miniswhite_mm": lambda: mi.tiff_layout(
            g, bits=16, photometric=0, order=">"),
    }[case]()
    p = _write(tmp_path, case, data)
    with pytest.raises((OSError, ValueError)):
        with Image.open(p) as im:
            im.load()
    for fn in (image_io.read_rgb, image_io.header,
               lambda q: t_infer._LazyImage(q, gray=False).load()):
        if fn is image_io.header and case.startswith("predictor"):
            continue            # the header opens; the decode fails
        with pytest.raises(OSError, match="TIFF"):
            fn(p)


def test_predictor_is_ignored_where_libtiff_ignores_it(tmp_path):
    """Pillow's raw decoder and libtiff's PackBits codec take no
    predictor: a predictor tag there changes nothing."""
    r = np.random.default_rng(3)
    g = _float(r)
    for comp in (1, 32773):
        raw = mi.tiff_layout(g, bits=32, sample_format=3, compression=comp)
        segs, tags, order, big, tiled = _retag_add(raw, {317: (3, [3])})
        p = _write(tmp_path, f"c{comp}", mi.tiff_bytes(segs, tags, order,
                                                       big, tiled))
        assert assert_like_pillow_and_jax(p) == "F"
        np.testing.assert_array_equal(imaging.open_image(p).px, g)


def _retag_add(data: bytes, extra):
    from test_torch_tiff_layouts import _retag

    segs, keep, order, big, tiled = _retag(data, extra)
    with Image.open(io.BytesIO(data)) as im:
        if 339 in im.tag_v2:
            keep[339] = (3, list(im.tag_v2[339]))
    return segs, keep, order, big, tiled


# ------------------------------------------------------------ conversions
def test_float_and_int_conversions_match_pillow():
    """F and I -> L / RGB: 0 at or below 0 and for NaN, 255 at or above
    255, truncated between (Convert.c f2l, i2l)."""
    f = np.array([[np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, -3.7, 0.4,
                   0.99, 1.0, 127.5, 254.6, 254.99, 255.0, 255.5, 300.0,
                   1e10, -1e10, 2.0 ** 31, 1e-40]], np.float32)
    i = np.array([[-5, 0, 1, 127, 255, 256, 65535, 2**31 - 1, -2**31]],
                 np.int32)
    for px, mode in ((f, "F"), (i, "I")):
        im = Image.fromarray(px, mode)
        np.testing.assert_array_equal(image_io.to_l(px, mode, None),
                                      np.asarray(im.convert("L")))
        np.testing.assert_array_equal(image_io.to_rgb(px, mode, None),
                                      np.asarray(im.convert("RGB")))


def test_pa_converts_through_its_palette_like_pillow():
    r = np.random.default_rng(4)
    pal = r.integers(0, 256, (256, 3)).astype(np.uint8)
    px = r.integers(0, 256, (5, 7, 2)).astype(np.uint8)
    im = Image.fromarray(px, "PA")
    im.putpalette(pal.reshape(-1).tolist())
    np.testing.assert_array_equal(image_io.to_l(px, "PA", pal),
                                  np.asarray(im.convert("L")))
    np.testing.assert_array_equal(image_io.to_rgb(px, "PA", pal),
                                  np.asarray(im.convert("RGB")))


def test_lab_to_rgb_matches_little_cms():
    """Every L at a* = b* = 0 and at the corners, every grid-cell
    boundary value of each axis, and 2^16 seeded values: Pillow's
    ImageCms transform bit for bit (the whole 2^24 cube agrees too; it
    takes ~40 s).  LAB -> L raises ValueError in both."""
    r = np.random.default_rng(5)
    axis = np.unique(np.concatenate([np.arange(0, 256, 8), np.arange(
        7, 256, 8), [0, 1, 127, 128, 129, 254, 255]])).astype(np.uint8)
    grid = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                    -1).reshape(-1, 3)
    rand = r.integers(0, 256, (1 << 16, 3)).astype(np.uint8)
    px = np.concatenate([grid, rand])[None]
    want = np.asarray(Image.fromarray(px, "LAB").convert("RGB"))
    np.testing.assert_array_equal(lab.lab_to_rgb(px), want)
    with pytest.raises(ValueError, match="LAB to RGB"):
        Image.fromarray(px, "LAB").convert("L")
    with pytest.raises(ValueError, match="LAB to RGB"):
        image_io.to_l(px, "LAB", None)


# ------------------------------------------------------------ cut segments
@pytest.mark.parametrize("mode", ["YCbCr", "RGB", "L"])
@pytest.mark.parametrize("tile", [None, (16, 16)])
def test_cut_jpeg_segments_give_pillows_pixels(mode, tile, tmp_path):
    """A JPEG strip or tile cut inside its byte count, at fractions that
    fall in the frame header, the scan header and the entropy data:
    Pillow's pixels (libjpeg's zero bits, then gray; libjpeg-turbo's SIMD
    inverse DCT on the block that ran out) or, cut inside the frame
    header, OSError in both."""
    r = np.random.default_rng(6)
    img = mi.textured(r, *SHAPE)
    img = img[..., 0] if mode == "L" else img
    full = mi.jpeg_tiled(img, mode=mode, tile=tile or SHAPE[::-1])
    for frac in (0.02, 0.1, 0.2, 0.3, 0.5, 0.8, 0.97):
        p = _write(tmp_path, f"cut{frac}", mi.cut_segment(full, frac))
        assert_like_pillow_and_jax(p)


def test_cut_standalone_jpeg_and_cut_file_still_raise(tmp_path):
    """A cut .jpg raises "image file is truncated" in Pillow and OSError in
    the port; so does a TIFF whose file ends before a JPEG segment's."""
    r = np.random.default_rng(7)
    img = mi.textured(r, *SHAPE)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG")
    jpg = str(tmp_path / "cut.jpg")
    with open(jpg, "wb") as f:
        f.write(buf.getvalue()[:len(buf.getvalue()) // 2])
    full = mi.jpeg_tiled(img)
    tif = _write(tmp_path, "cut_file", full[:len(full) // 2])
    for p in (jpg, tif):
        with pytest.raises(OSError):
            with Image.open(p) as im:
                im.load()
        with pytest.raises(OSError):
            image_io.read_rgb(p)


def _fax_file(comp, t4, box, frac):
    """23 x 41 bilevel rows from Pillow's CCITT encoder in strips of 8 rows
    or 16 x 16 tiles, the last segment cut to ``frac`` of its bytes."""
    bw = (mi.textured(np.random.default_rng(comp + t4), *SHAPE)[..., 1]
          > 128).astype(np.uint8)
    name = {2: "tiff_ccitt", 3: "group3", 4: "group4"}[comp]
    info = {292: t4} if t4 else None
    full = mi.tiff_layout(
        bw, bits=1, compression=comp, extra_tags={292: (4, [t4])} if t4
        else None, encode=lambda t: mi.pillow_segment(
            t * 255, "1", tiffinfo=info, compression=name)[0],
        **(dict(tile=(16, 16)) if box == "tiles" else
           dict(rows_per_strip=box)))
    return mi.cut_segment(full, frac)


@pytest.mark.parametrize("box", [8, "tiles"])
@pytest.mark.parametrize("comp,t4", [(2, 0), (3, 0), (3, 1), (4, 0)])
def test_cut_ccitt_segments_give_pillows_pixels(comp, t4, box, tmp_path):
    """The last strip or tile of a CCITT file cut inside its byte count,
    at 5 fractions: libtiff's rows (zero bits padded past the data, rows
    finished by CLEANUP_RUNS, T.4 decoded again without EOLs where none
    follows), and past them the rows of the segment decoded before, as
    Pillow's one buffer holds them; OSError where libtiff fails a strip
    (modified Huffman; group 4 cut in a strip's first row)."""
    for frac in (0.0, 0.15, 0.4, 0.65, 0.9):
        p = _write(tmp_path, f"cut{frac}", _fax_file(comp, t4, box, frac))
        assert_like_pillow_and_jax(p)


@pytest.mark.parametrize("opts", [2, 3])
def test_t4_uncompressed_option_reads_like_pillow(opts, tmp_path):
    """T4Options with the uncompressed-mode bit (1-D and 2-D): libtiff
    reads the rows, ending one at an uncompressed-mode code, and so does
    the port."""
    bw = (mi.textured(np.random.default_rng(opts), *SHAPE)[..., 1]
          > 128).astype(np.uint8)
    info = {292: opts & 1} if opts & 1 else None
    data = mi.tiff_layout(
        bw, bits=1, compression=3, extra_tags={292: (4, [opts])},
        encode=lambda t: mi.pillow_segment(t * 255, "1", tiffinfo=info,
                                           compression="group3")[0])
    assert_like_pillow_and_jax(_write(tmp_path, "t4", data))


def test_cut_group4_strip_alone_reads_libtiffs_rows(tmp_path):
    """One group 4 strip cut inside its byte count: libtiff writes the
    rows up to the one the data end in and stops, and Pillow's rows past
    those are its buffer's memory.  The port gives libtiff's rows (held
    to Pillow's) and zero bytes past them, a zeroed buffer's rows (black
    here, under MinIsBlack).  The rows libtiff writes are found with the
    port's decoder over buffers of 0 and of 1."""
    from effocr_torch.native import imgdec

    for frac in (0.3, 0.7):
        data = _fax_file(4, 0, SHAPE[0], frac)
        p = _write(tmp_path, f"g4_{frac}", data)
        with Image.open(p) as im:
            seg = data[im.tag_v2[273][0]:][:im.tag_v2[279][0]]
            pil = np.asarray(im.convert("L"))
        reached = []
        for v in (0, 1):
            out = np.full(SHAPE, v, np.uint8)
            assert imgdec.ccitt(seg, 4, 0, 1, out, imgdec.ccitt_state(
                SHAPE[1]))
            reached.append(out)
        rows = int((reached[0] == reached[1]).all(axis=1).sum())
        assert (reached[0] == reached[1])[:rows].all()
        assert 0 < rows < SHAPE[0]
        got = image_io.read_l(p)
        np.testing.assert_array_equal(got[:rows], pil[:rows])
        assert (got[rows:] == 0).all()


# ------------------------------------------------------------ dataset tools
def _page(kind, r):
    """An H x W page in the mode, as a TIFF."""
    g = r.integers(0, 256, (H, W))
    if kind == "I":
        return mi.tiff_layout(g * 300 - 2000, bits=32, sample_format=2,
                              compression=5)
    if kind == "F":
        return mi.tiff_layout(g.astype(np.float32) * 1.5 - 20, bits=32,
                              sample_format=3, compression=8, predictor=3)
    if kind == "PA":
        return mi.tiff_layout(np.dstack([g, g[::-1]]), photometric=3,
                              extra_tags={**_ex(2), **_CMAP})
    return mi.tiff_layout(np.dstack([g, g, g[::-1]]), photometric=8)


@pytest.mark.parametrize("kind", ["I", "F", "PA", "LAB"])
def test_char_crops_over_sample_pages_match_jax(kind, tmp_path):
    """I crops are written as 16-bit gray PNGs, clipped (Pillow's I;16B
    rawmode); F, PA and LAB crops raise Pillow's OSError at the first
    crop, in both, and leave no file."""
    img_dir = tmp_path / "img"
    img_dir.mkdir()
    p = _write(img_dir, f"page_{kind}", _page(kind, np.random.default_rng(
        len(kind))))
    coco = _coco(p)
    crops = {k: str(tmp_path / k) for k in ("jax", "port")}
    if kind != "I":
        for fn, d in ((j_coco.extract_char_crops, crops["jax"]),
                      (t_coco.extract_char_crops, crops["port"])):
            with pytest.raises(OSError, match=f"cannot write mode {kind}"):
                fn(coco, str(img_dir), d)
            assert os.listdir(d) == []
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        n = j_coco.extract_char_crops(coco, str(img_dir), crops["jax"])
    assert t_coco.extract_char_crops(coco, str(img_dir), crops["port"]) \
        == n == 5
    names = sorted(os.listdir(crops["jax"]))
    assert names == sorted(os.listdir(crops["port"]))
    for f in names:
        a = pillow_view(os.path.join(crops["port"], f))
        b = pillow_view(os.path.join(crops["jax"], f))
        assert a[0] == b[0] == "I;16", f
        np.testing.assert_array_equal(a[1], b[1], err_msg=f)


# ------------------------------------------------------------ fixtures
def test_sample_fixtures_equal_golden_and_pillow():
    golden = np.load(os.path.join(mi.OUT, "golden.npz"))
    for name in mi.SAMPLE_FILES:
        p = os.path.join(mi.OUT, name)
        assert os.path.getsize(p) < 12000, name
        got = {"rgb": attempt(image_io.read_rgb, p),
               "l": attempt(image_io.read_l, p),
               "lazy_gray": t_infer._LazyImage(p, gray=True).load(),
               "lazy_rgb": t_infer._LazyImage(p, gray=False).load()}
        for kind, a in got.items():
            err = f"{name}|{kind}|error"
            if err in golden.files:
                assert type(a).__name__ == str(golden[err]), (name, kind)
                assert isinstance(converted(p, "L"), type), name
                continue
            assert tuple(golden[f"{name}|{kind}|shape"]) == a.shape, name
            np.testing.assert_array_equal(mi.digest(a),
                                          golden[f"{name}|{kind}|sha256"],
                                          err_msg=f"{name} {kind}")
        assert_same(got["rgb"], converted(p, "RGB"), name)
