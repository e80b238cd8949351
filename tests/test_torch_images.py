"""effocr_torch's decoders for JPEG, TIFF, BMP and GIF against Pillow 12
and the JAX package, on the CPU.

Every case makes its file with Pillow (or, for what Pillow cannot write,
with the writers of tests/torch_fixtures/make_images.py) from seeded
numpy, and holds the port to Pillow bit for bit: the size and mode
``Image.open`` reports, ``convert("RGB")`` and ``convert("L")``.

- JPEG: gray / RGB / CMYK x quality {1, 50, 75, 100} x subsampling
  {4:4:4, 4:2:2, 4:2:0} x {baseline, progressive} x {plain, optimize,
  restart markers}, each at 1x1, 7x9, 8x8, 17x15 and 64x1024; 1x2 and
  mixed sampling factors and gray with 2x2 factors from
  ``baseline_jpeg``;
- TIFF, BMP and GIF: every compression, mode, header and layout the
  decoders take, including the hand-built RLE4 / RLE8 streams;
- every refusal (NotImplementedError naming the feature and ROADMAP.md),
  a truncated file of each format (OSError, as in Pillow), and seeded
  corruptions of every branch (an error, never a crash);
- parity with the JAX package: ``_LazyImage`` shape and pixels for every
  mode and both channel rules; ``infer --infer_over_img_dir`` on a nested
  png / jpg folder against the JAX command (image list, text, COCO JSON);
  ``CharFolderDataset``, ``DetectionDataset`` and ``Seq2SeqDataset``
  items read from JPEG files;
- the native batch decode equal to one file at a time;
- the committed fixtures (tests/torch_fixtures/images/) equal to
  golden.npz and to Pillow now.
Tolerance: none (exact equality) throughout.
"""

import itertools
import json
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from effocr_tpu.pipelines import infer as j_infer
from effocr_torch.data import image_io, jpeg
from effocr_torch.native import imgdec
from effocr_torch.pipelines import infer as t_infer
from torch_fixtures import make_images as mi

FIXTURES = mi.OUT


def _pillow(path):
    with Image.open(path) as im:
        return (im.mode, im.size, np.asarray(im.convert("RGB")),
                np.asarray(im.convert("L")))


def assert_like_pillow(path):
    mode, (w, h), rgb, l = _pillow(path)
    assert image_io.header(path) == (h, w, mode)
    np.testing.assert_array_equal(image_io.read_rgb(path), rgb)
    np.testing.assert_array_equal(image_io.read_l(path), l)
    return mode


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


# ------------------------------------------------------------------ JPEG
SIZES = [(1, 1), (7, 9), (8, 8), (17, 15), (64, 1024)]
JPEG_CASES = [
    (mode, q, ss, prog, var)
    for mode in ("L", "RGB", "CMYK")
    for q in (1, 50, 75, 100)
    for ss in ((0, 1, 2) if mode == "RGB" else (0,))
    for prog in (False, True)
    for var in ("plain", "optimize", "restart")
]


@pytest.mark.parametrize("mode,quality,subsampling,progressive,variant",
                         JPEG_CASES)
def test_jpeg_matches_pillow(tmp_path, mode, quality, subsampling,
                             progressive, variant):
    rng = np.random.default_rng(quality * 7 + subsampling)
    for h, w in SIZES:
        # the wide case gets less noise: Pillow's encoder buffer for
        # optimized / progressive files is one byte a pixel
        src = mi.textured(rng, h, w, noise=2.0 if w > 100 else 25.0)
        kw = dict(quality=quality, subsampling=subsampling,
                  progressive=progressive, optimize=variant == "optimize")
        if variant == "restart":
            kw["restart_marker_blocks"] = 2
        p = str(tmp_path / f"{h}x{w}.jpg")
        Image.fromarray(src).convert(mode).save(p, "JPEG", **kw)
        assert assert_like_pillow(p) == mode
        with Image.open(p) as im:
            px, got_mode = jpeg.decode(open(p, "rb").read())
            assert got_mode == mode
            np.testing.assert_array_equal(px, np.asarray(im))


@pytest.mark.parametrize("factors", [
    [(1, 2), (1, 1), (1, 1)],           # h1v2_fancy_upsample
    [(2, 2), (1, 2), (2, 1)],           # each component its own filter
    [(2, 1), (2, 1), (1, 1)],
    [(2, 1), (1, 2), (1, 1)],           # luma upsampled vertically
    [(1, 1), (1, 1), (1, 1)],
    [(2, 2)],                           # gray with 2x2: one block an MCU
])
def test_jpeg_any_sampling_factors_match_pillow(tmp_path, factors):
    rng = np.random.default_rng(len(factors) + factors[0][0])
    for h, w in [(1, 1), (2, 3), (7, 9), (17, 15), (33, 50)]:
        src = mi.textured(rng, h, w)
        src = src[..., 0] if len(factors) == 1 else src
        p = _write(tmp_path / f"{h}x{w}.jpg", mi.baseline_jpeg(src, factors))
        assert_like_pillow(p)


def test_jpeg_frame_past_the_first_header_read(tmp_path):
    """An EXIF segment of 20 kB before the frame header (camera files):
    the header is found past ``image_io.HEAD_BYTES``, in ``_LazyImage``
    too, and the pixels are Pillow's."""
    rng = np.random.default_rng(8)
    im = Image.fromarray(mi.textured(rng, 30, 50))
    exif = Image.Exif()
    exif[0x010E] = "x" * 20000          # ImageDescription
    p = str(tmp_path / "exif.jpg")
    im.save(p, "JPEG", exif=exif.tobytes(), quality=85)
    assert open(p, "rb").read().find(b"\xff\xc0") > image_io.HEAD_BYTES
    assert_like_pillow(p)
    for gray in (True, False):
        np.testing.assert_array_equal(t_infer._LazyImage(p, gray).load(),
                                      j_infer._LazyImage(p, gray).load())


def test_jpeg_batch_equals_one_at_a_time(tmp_path):
    rng = np.random.default_rng(5)
    paths, shapes = [], []
    for i in range(12):
        src = mi.textured(rng, int(rng.integers(1, 60)),
                          int(rng.integers(1, 300)))
        p = str(tmp_path / f"{i}.jpg")
        Image.fromarray(src).convert("L" if i % 3 == 0 else "RGB").save(
            p, "JPEG", quality=int(rng.integers(20, 95)), progressive=i % 2)
        paths.append(p)
        h, w, mode = image_io.header(p)
        shapes.append((h, w, 1 if mode == "L" else 3))
    many = imgdec.decode_jpeg_batch(paths, shapes, num_threads=4)
    for p, s, arr in zip(paths, shapes, many):
        one = imgdec.decode_jpeg(open(p, "rb").read(), s)
        np.testing.assert_array_equal(arr, one)
        np.testing.assert_array_equal(arr, image_io.load(p, s[2]))
    # the channel rules of the batch: gray -> 3 replicated, RGB -> mean
    flipped = [(h, w, 4 - c) for h, w, c in shapes]
    for p, arr in zip(paths, imgdec.decode_jpeg_batch(paths, flipped)):
        np.testing.assert_array_equal(arr, image_io.load(p, arr.shape[2]))
    # a mixed batch through image_io.read equals load() file by file
    Image.fromarray(mi.textured(rng, 20, 30)).save(tmp_path / "x.png")
    Image.fromarray(mi.textured(rng, 20, 30)).convert("CMYK").save(
        tmp_path / "k.jpg")
    mixed = paths[:4] + [str(tmp_path / "x.png"), str(tmp_path / "k.jpg")]
    for ch in (1, 3):
        for p, arr in zip(mixed, image_io.read(mixed, [ch] * len(mixed))):
            np.testing.assert_array_equal(arr, image_io.load(p, ch))


# ------------------------------------------------------------------ TIFF
TIFF_CASES = [
    ("1", "group4", {}), ("1", "group3", {}), ("1", "group3", {292: 1}),
    ("1", "tiff_ccitt", {}), ("1", "group4", {266: 2}),
    ("1", "group3", {266: 2, 292: 1}), ("1", "raw", {}),
    ("1", "packbits", {}), ("1", "tiff_lzw", {}),
    ("L", "raw", {}), ("L", "tiff_lzw", {}), ("L", "packbits", {}),
    ("L", "tiff_deflate", {}), ("L", "tiff_adobe_deflate", {}),
    ("L", "jpeg", {}), ("L", "tiff_lzw", {317: 2}),
    ("I;16", "raw", {}), ("I;16", "tiff_lzw", {}),
    ("I;16", "tiff_adobe_deflate", {317: 2}), ("I;16B", "raw", {}),
    ("P", "raw", {}), ("P", "tiff_lzw", {}),
    ("RGB", "raw", {}), ("RGB", "tiff_lzw", {}), ("RGB", "jpeg", {}),
    ("RGB", "tiff_adobe_deflate", {317: 2}), ("RGB", "packbits", {}),
    ("RGBA", "raw", {}), ("RGBA", "tiff_lzw", {}), ("CMYK", "raw", {}),
    ("CMYK", "tiff_lzw", {}), ("LA", "raw", {}), ("YCbCr", "jpeg", {}),
]


def _tiff_source(rng, mode, h, w):
    if mode in ("I;16", "I;16B"):
        im = Image.fromarray(rng.integers(0, 700, (h, w)).astype(np.uint16))
        return im if mode == "I;16" else im.convert("I;16B")
    src = Image.fromarray(mi.textured(rng, h, w))
    return src.quantize(40) if mode == "P" else src.convert(mode)


@pytest.mark.parametrize("mode,compression,info", TIFF_CASES)
def test_tiff_matches_pillow(tmp_path, mode, compression, info):
    rng = np.random.default_rng(len(mode) + len(compression))
    # (301, 1700): several strips for every compression but CCITT
    for h, w in [(1, 1), (37, 29), (301, 1700)]:
        p = str(tmp_path / f"{h}.tif")
        _tiff_source(rng, mode, h, w).save(p, "TIFF", compression=compression,
                                           tiffinfo=info)
        assert_like_pillow(p)


def _strips(path):
    with Image.open(path) as im:
        offs, counts = im.tag_v2[273], im.tag_v2[279]
    data = open(path, "rb").read()
    return [data[o:o + c] for o, c in zip(offs, counts)]


def test_tiff_hand_built_layouts_match_pillow(tmp_path):
    """Big-endian, MinIsWhite at 1 and 8 bits, 16-bit big-endian, RGB in
    many strips, CCITT re-tagged MinIsWhite."""
    rng = np.random.default_rng(9)
    gray = mi.textured(rng, 37, 29)[..., 0]
    rgb = mi.textured(rng, 37, 29)
    cases = {
        "mm_l": mi.tiff_gray(gray, order=">", rows_per_strip=5),
        "miniswhite_l": mi.tiff_gray(gray, photometric=0),
        "mm_miniswhite_l": mi.tiff_gray(gray, order=">", photometric=0),
        "mm_rgb": mi.tiff_gray(rgb, order=">", rows_per_strip=4,
                               extra_tags={262: (3, [2])}),
        "mm_16": mi.tiff_gray(rng.integers(0, 900, (37, 29)), order=">",
                              bits=16),
        "ii_16": mi.tiff_gray(rng.integers(0, 900, (37, 29)), bits=16,
                              rows_per_strip=7),
    }
    bw = Image.fromarray(gray).point(lambda v: 255 if v > 128 else 0
                                     ).convert("1")
    for comp, tags in (("group4", {}), ("group3", {292: (4, [1])}),
                       ("tiff_ccitt", {})):
        p = str(tmp_path / f"src_{comp}.tif")
        bw.save(p, "TIFF", compression=comp,
                tiffinfo={k: v[1][0] for k, v in tags.items()})
        num = {"group4": 4, "group3": 3, "tiff_ccitt": 2}[comp]
        cases[f"{comp}_miniswhite"] = mi.tiff_bytes(_strips(p), {
            256: (3, [29]), 257: (3, [37]), 258: (3, [1]), 259: (3, [num]),
            262: (3, [0]), 278: (3, [37]), **tags})
    for name, data in cases.items():
        assert_like_pillow(_write(tmp_path / f"{name}.tif", data))


# ------------------------------------------------------------------- BMP
def _pal(n, grey=False, core=False):
    ent = [(i, i, i) if grey else (i * 37 % 256, 255 - i * 11 % 256, i * 5
                                   % 256) for i in range(n)]
    return b"".join(bytes([b, g, r] + ([] if core else [0]))
                    for r, g, b in ent)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_bmp_pillow_written_matches_pillow(tmp_path, mode):
    rng = np.random.default_rng(len(mode))
    for h, w in [(1, 1), (7, 9), (37, 29), (64, 301)]:
        src = Image.fromarray(mi.textured(rng, h, w))
        im = src.quantize(50) if mode == "P" else src.convert(mode)
        p = str(tmp_path / f"{h}.bmp")
        im.save(p)
        assert_like_pillow(p)


def test_bmp_hand_built_matches_pillow(tmp_path):
    rng = np.random.default_rng(4)
    h, w = 13, 11
    idx4 = rng.integers(0, 16, (h, w)).astype(np.uint8)
    idx8 = rng.integers(0, 200, (h, w)).astype(np.uint8)
    idx1 = rng.integers(0, 2, (h, w)).astype(np.uint8)
    tex = mi.textured(rng, h, w)
    bgr = tex[..., ::-1]
    c555 = ((tex[..., 0] >> 3).astype(np.uint16) << 10
            | (tex[..., 1] >> 3).astype(np.uint16) << 5 | tex[..., 2] >> 3)
    c565 = ((tex[..., 0] >> 3).astype(np.uint16) << 11
            | (tex[..., 1] >> 2).astype(np.uint16) << 5 | tex[..., 2] >> 3)

    def u16(a):
        return a.astype("<u2").view(np.uint8).reshape(h, -1)

    cases = {
        "core_24": mi.bmp_bytes(w, h, 24, mi.bmp_rows(bgr.reshape(h, -1), 8),
                                header=12),
        "core_8": mi.bmp_bytes(w, h, 8, mi.bmp_rows(idx8, 8), header=12,
                               palette=_pal(256, core=True)),
        "p4": mi.bmp_bytes(w, h, 4, mi.bmp_rows(idx4, 4), palette=_pal(16)),
        "p1_colour": mi.bmp_bytes(w, h, 1, mi.bmp_rows(idx1, 1),
                                  palette=_pal(2)),
        "bw1": mi.bmp_bytes(w, h, 1, mi.bmp_rows(idx1, 1),
                            palette=b"\0\0\0\0\xff\xff\xff\0"),
        "grey8_200": mi.bmp_bytes(w, h, 8, mi.bmp_rows(idx8, 8),
                                  palette=_pal(200, grey=True), colors=200),
        "rgb555": mi.bmp_bytes(w, h, 16, mi.bmp_rows(u16(c555), 8)),
        "bf565": mi.bmp_bytes(w, h, 16, mi.bmp_rows(u16(c565), 8),
                              compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "bf555_v4": mi.bmp_bytes(w, h, 16, mi.bmp_rows(u16(c555), 8),
                                 header=108, compression=3,
                                 masks=(0x7C00, 0x3E0, 0x1F)),
        "top_down_24": mi.bmp_bytes(w, h, 24, b"".join(
            r.tobytes() + b"\0" * (-3 * w % 4) for r in bgr), top_down=True),
        "rle8": mi.bmp_bytes(12, 6, 8, mi.rle8_stream(), palette=_pal(256),
                             compression=1),
        "rle4": mi.bmp_bytes(10, 4, 4, mi.rle4_stream(), palette=_pal(16),
                             compression=2),
    }
    for masks in mi_masks_32():
        lanes = [m.bit_length() // 8 - 1 for m in masks]
        px = np.zeros((h, w, 4), np.uint8)
        a = rng.integers(0, 256, (h, w), np.uint8)
        for lane, v in zip(lanes, [tex[..., 0], tex[..., 1], tex[..., 2],
                                   a]):
            if lane >= 0:
                px[..., lane] = v
        # a 40-byte header carries three masks (Pillow reads no alpha)
        for header in ((40, 124) if not masks[3] else (124,)):
            cases[f"bf32_{'_'.join(hex(m) for m in masks)}_{header}"] = (
                mi.bmp_bytes(w, h, 32, mi.bmp_rows(px.reshape(h, -1), 8),
                             header=header, compression=3, masks=masks))
    for name, data in cases.items():
        assert_like_pillow(_write(tmp_path / f"{name}.bmp", data))


def mi_masks_32():
    from effocr_torch.data import bmp

    return sorted(bmp._MASKS_32)


# ------------------------------------------------------------------- GIF
@pytest.mark.parametrize("mode,interlace", itertools.product(
    ["L", "P"], [False, True]))
def test_gif_pillow_written_matches_pillow(tmp_path, mode, interlace):
    rng = np.random.default_rng(len(mode) + interlace)
    for h, w in [(1, 1), (7, 9), (37, 29), (64, 300)]:
        src = Image.fromarray(mi.textured(rng, h, w))
        im = src.quantize(50) if mode == "P" else src.convert(mode)
        p = str(tmp_path / f"{h}.gif")
        im.save(p, interlace=interlace)
        # Pillow writes L with an optimized palette: it reads back as P
        assert_like_pillow(p)


def test_gif_hand_built_matches_pillow(tmp_path):
    rng = np.random.default_rng(6)
    ramp = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)
    pal = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    small = rng.integers(0, 256, (4, 3)).astype(np.uint8)
    frame = rng.integers(0, 16, (21, 30)).astype(np.uint8)
    cases = {
        # local palette over a global one, frame inside the screen,
        # transparency fills the rest
        "local": mi.gif_bytes((50, 40), frame, (7, 5), pal[:8], pal, 3,
                              True),
        "no_transparency": mi.gif_bytes((50, 40), frame, (3, 2), pal, None),
        # a grey ramp reads as L, with or without a global table
        "ramp_local": mi.gif_bytes((30, 21), frame, local_pal=ramp),
        "ramp_global_offset": mi.gif_bytes((40, 30), frame, (4, 4), ramp),
        "no_palette": mi.gif_bytes((30, 21), frame),
        # the frame reaches past the screen: the image grows
        "grows": mi.gif_bytes((20, 10), frame, (5, 3), pal),
        # four colours, 2-bit codes; a long run for the KwKwK code
        "tiny_palette": mi.gif_bytes((64, 64), np.where(
            rng.random((64, 64)) < 0.9, 0, rng.integers(0, 4, (64, 64))
        ).astype(np.uint8), global_pal=small, interlace=True),
    }
    for name, data in cases.items():
        assert_like_pillow(_write(tmp_path / f"{name}.gif", data))


# ------------------------------------------------------------- refusals
def _sof(marker, prec=8, nc=3, factors=None):
    factors = factors or [(1, 1)] * nc
    body = struct.pack(">BHHB", prec, 16, 16, nc) + b"".join(
        bytes([i + 1, (h << 4) | v, 0]) for i, (h, v) in enumerate(factors))
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _refusals(tmp_path):
    rng = np.random.default_rng(2)
    tex = mi.textured(rng, 24, 40)
    prog = str(tmp_path / "prog.jpg")
    Image.fromarray(tex).save(prog, "JPEG", progressive=True, quality=80)
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x02"
    gray = tex[..., 0]
    g4 = str(tmp_path / "g4.tif")
    Image.fromarray(gray).convert("1").save(g4, "TIFF", compression="group4")
    base = {256: (3, [40]), 257: (3, [24]), 258: (3, [8]), 259: (3, [1]),
            262: (3, [1]), 278: (3, [24])}
    return {
        "arithmetic coding \\(SOF9\\)": b"\xff\xd8" + _sof(0xC9),
        "arithmetic coding, progressive": b"\xff\xd8" + _sof(0xCA),
        "lossless coding \\(SOF3\\)": b"\xff\xd8" + _sof(0xC3),
        "hierarchical lossless": b"\xff\xd8" + _sof(0xC7),
        "hierarchical coding \\(SOF5\\)": b"\xff\xd8" + _sof(0xC5),
        "12-bit precision": b"\xff\xd8" + _sof(0xC1, prec=12),
        "YCCK colour \\(Adobe transform 2\\)": b"\xff\xd8" + adobe + _sof(
            0xC0, nc=4),
        "sampling factors 4x1, 1x1, 1x1": mi.baseline_jpeg(
            tex, [(4, 1), (1, 1), (1, 1)]),
        "sampling factors 3x1, 1x1, 1x1": mi.baseline_jpeg(
            tex, [(3, 1), (1, 1), (1, 1)]),
        "coefficient bits unsent": mi.drop_refinement_scans(
            open(prog, "rb").read()),
        # float, 12-bit and predictor 3 are read now
        # (test_former_tiff_refusals_match_pillow); these stay refused
        "planar configuration 2 for PA": mi.tiff_bytes(
            [bytes(24 * 40)] * 2, {**base, 258: (3, [8, 8]), 259: (3, [8]),
                                   262: (3, [3]), 277: (3, [2]),
                                   284: (3, [2]), 338: (3, [2]),
                                   320: (3, [0] * 768)}),
        "photometric 6 with 1 sample \\(YCbCr\\) under JPEG": mi.tiff_bytes(
            _strips(g4), {**base, 259: (3, [7]), 262: (3, [6])}),
        "old-style \\(LSB-first\\) LZW": mi.tiff_bytes([b"\x00\x01" + bytes(
            40)], {**base, 259: (3, [5])}),
        "photometric 6 with 3 samples": mi.tiff_bytes(_strips(g4), {
            **base, 258: (3, [8, 8, 8]), 262: (3, [6]), 277: (3, [3])}),
        "BMP uses JPEG compression": mi.bmp_bytes(4, 4, 24, bytes(64),
                                                  compression=4),
        "RIFF \\(WebP\\)": b"RIFF\x10\0\0\0WEBPVP8 " + bytes(32),
    }


def _former_refusals():
    """The TIFF files this test module refused by name before float,
    12-bit samples and predictor 3 were read: a float tile, a BigTIFF with
    predictor 3 over LZW, a float strip, 12-bit samples in a plane."""
    base = {256: (3, [40]), 257: (3, [24]), 258: (3, [8]), 259: (3, [1]),
            262: (3, [1]), 278: (3, [24])}
    return {
        "float_tile": mi.tiff_bytes([bytes(16 * 16 * 4)] * 9, {
            **base, 258: (3, [32]), 339: (3, [3]), 322: (3, [16]),
            323: (3, [16])}, tiled=True),
        "predictor3_bigtiff": mi.tiff_bytes([bytes(24 * 40)], {
            **base, 259: (3, [5]), 317: (3, [3])}, big=True),
        "float_strip": mi.tiff_bytes([bytes(24 * 40 * 4)], {
            **base, 258: (3, [32]), 339: (3, [3])}),
        "planes_12bit": mi.tiff_bytes([bytes(24 * 60)], {
            **base, 258: (3, [12]), 284: (3, [2])}),
    }


@pytest.mark.parametrize("case", sorted(_former_refusals()))
def test_former_tiff_refusals_match_pillow(case, tmp_path):
    """Read as Pillow reads them (float zeros), or OSError where Pillow
    raises: libtiff takes predictor 3 only on float samples, and Pillow
    has no unpacker for a plane of 12-bit samples."""
    p = _write(tmp_path / f"{case}.tif", _former_refusals()[case])
    try:
        mode = _pillow(p)[0]
    except (OSError, ValueError):
        for fn in (image_io.read_rgb, image_io.read_l,
                   lambda q: t_infer._LazyImage(q, gray=True).load()):
            with pytest.raises(OSError, match="TIFF"):
                fn(p)
        return
    assert assert_like_pillow(p) == mode == "F"


def test_every_refusal_names_its_feature_and_the_roadmap(tmp_path):
    for i, (feature, data) in enumerate(_refusals(tmp_path).items()):
        p = _write(tmp_path / f"r{i}.img", data)
        for fn in (image_io.read_rgb, image_io.read_l,
                   lambda q: t_infer._LazyImage(q, gray=True).load()):
            with pytest.raises(NotImplementedError,
                               match=f"{feature}.*ROADMAP"):
                fn(p)


def test_decodes_pillow_accepts_are_the_ones_refused_by_name(tmp_path):
    """Pillow (libjpeg-turbo) decodes the 4:1:1 file and the one with
    unsent bits: the port refuses them rather than guess."""
    rng = np.random.default_rng(2)
    tex = mi.textured(rng, 24, 40)
    p = _write(tmp_path / "411.jpg", mi.baseline_jpeg(
        tex, [(4, 1), (1, 1), (1, 1)]))
    assert np.asarray(Image.open(p).convert("RGB")).shape == (24, 40, 3)
    prog = str(tmp_path / "prog.jpg")
    Image.fromarray(tex).save(prog, "JPEG", progressive=True)
    cut = _write(tmp_path / "cut.jpg", mi.drop_refinement_scans(
        open(prog, "rb").read()))
    assert np.asarray(Image.open(cut).convert("L")).shape == (24, 40)
    for q in (p, cut):
        with pytest.raises(NotImplementedError):
            image_io.read_rgb(q)


@pytest.mark.parametrize("fmt", ["JPEG", "PJPEG", "TIFF", "BMP", "GIF"])
def test_truncated_file_raises_like_pillow(tmp_path, fmt):
    """Cut at half and at two bytes short: the port raises OSError where
    Pillow raises (at half, always) and reads Pillow's pixels where Pillow
    reads the file (a GIF without its trailer)."""
    rng = np.random.default_rng(1)
    im = Image.fromarray(mi.textured(rng, 40, 60))
    p = str(tmp_path / "full")
    kw = {"PJPEG": dict(format="JPEG", progressive=True),
          "TIFF": dict(format="TIFF", compression="tiff_lzw")}.get(
        fmt, dict(format=fmt))
    (im.quantize(64) if fmt == "GIF" else im).save(p, **kw)
    data = open(p, "rb").read()
    for cut in (len(data) // 2, len(data) - 2):
        q = _write(tmp_path / f"cut{cut}", data[:cut])
        try:
            ref = np.asarray(Image.open(q).convert("RGB"))
        except Exception:
            ref = None
        if ref is None:
            with pytest.raises(OSError, match=fmt[-4:]):
                image_io.read_rgb(q)
        else:
            assert cut > len(data) // 2
            np.testing.assert_array_equal(image_io.read_rgb(q), ref)


@pytest.mark.parametrize("seed", range(3))
def test_corrupt_files_raise_and_never_crash(tmp_path, seed):
    """Seeded byte flips and cuts of every fixture branch: each read
    decodes or raises OSError or NotImplementedError (the native
    decoders check every bound; they ran clean under AddressSanitizer
    and UBSan on such files)."""
    rng = np.random.default_rng(seed)
    cases = sorted(os.listdir(os.path.join(FIXTURES, "cases")))
    p = str(tmp_path / "f")
    for k in range(100):
        src = os.path.join(FIXTURES, "cases", cases[k % len(cases)])
        data = bytearray(open(src, "rb").read())
        for i in rng.integers(0, len(data), int(rng.integers(1, 9))):
            data[i] = int(rng.integers(0, 256))
        if rng.random() < 0.2:
            data = data[:int(rng.integers(1, len(data)))]
        _write(p, bytes(data))
        try:
            image_io.read_rgb(p)
        except (OSError, NotImplementedError):
            pass


# ------------------------------------------------------------ JAX parity
def _mode_files(d):
    """One file of every mode each decoder gives, and both kinds of PNG."""
    rng = np.random.default_rng(11)
    tex = Image.fromarray(mi.textured(rng, 23, 41))
    files = {}
    for mode in ("L", "RGB", "CMYK"):
        files[f"jpeg_{mode}"] = (tex.convert(mode), "JPEG", {})
    for mode in ("1", "L", "I;16", "P", "RGB", "RGBA", "CMYK", "LA"):
        im = (Image.fromarray(rng.integers(0, 600, (23, 41)).astype(
            np.uint16)) if mode == "I;16" else tex.quantize(30)
              if mode == "P" else tex.convert(mode))
        files[f"tiff_{mode}"] = (im, "TIFF", {"compression": "tiff_lzw"})
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        files[f"bmp_{mode}"] = (tex.quantize(30) if mode == "P"
                                else tex.convert(mode), "BMP", {})
    for mode in ("L", "P"):
        files[f"gif_{mode}"] = (tex.quantize(30) if mode == "P"
                                else tex.convert(mode), "GIF", {})
    files["png_L"] = (tex.convert("L"), "PNG", {})
    files["png_P"] = (tex.quantize(30), "PNG", {})
    out = {}
    for name, (im, fmt, kw) in files.items():
        p = str(d / f"{name}.{fmt.lower()}")
        im.save(p, fmt, **kw)
        out[name] = p
    return out


def test_lazy_image_matches_jax_for_every_mode(tmp_path):
    for name, p in _mode_files(tmp_path).items():
        for gray in (True, False):
            t, j = t_infer._LazyImage(p, gray), j_infer._LazyImage(p, gray)
            assert t.shape == j.shape, (name, gray)
            got, ref = t.load(), j.load()
            assert got.dtype == ref.dtype == np.uint8, name
            np.testing.assert_array_equal(got, ref, err_msg=name)
        # a chunk decodes in one batch: the same arrays
        chunk = [t_infer._LazyImage(p, g) for g in (True, False)]
        for g, arr in zip((True, False), t_infer._materialize_batch(chunk)):
            np.testing.assert_array_equal(arr,
                                          j_infer._LazyImage(p, g).load())


def _nested_mixed_folder(root, line_paths):
    """The pipeline test's gray lines as PNG, gray JPEG and RGB JPEG in
    nested folders, plus files neither command globs."""
    names = []
    for i, src in enumerate(line_paths):
        gray = np.asarray(Image.open(src))
        sub = root / ("a" if i % 3 == 0 else "b/c" if i % 3 == 1 else "")
        sub.mkdir(parents=True, exist_ok=True)
        if i % 3 == 0:
            p = sub / f"line{i}.png"
            Image.fromarray(gray).save(p)
        elif i % 3 == 1:
            p = sub / f"line{i}.jpg"
            Image.fromarray(gray).save(p, quality=95)
        else:
            p = sub / f"line{i}.jpg"
            Image.fromarray(gray).convert("RGB").save(p, quality=95,
                                                      subsampling=0)
        names.append(p)
    Image.fromarray(gray).save(root / "skipped.jpeg")
    Image.fromarray(gray).save(root / "skipped.tif")
    return names


def test_infer_over_img_dir_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """``infer --infer_over_img_dir`` in both packages on one nested
    folder of .png and .jpg lines: the same images in the same order,
    the same text and the same COCO JSON (both commands' engines are the
    pipeline test's tiny-encoder engines)."""
    import jax
    import jax.numpy as jnp

    from effocr_tpu.cli import infer as j_cli
    from effocr_tpu.core.config import (
        EncoderConfig as JEncoderConfig,
        LocalizerConfig as JLocalizerConfig,
        PipelineConfig as JPipelineConfig,
    )
    from effocr_tpu.kernels.roi import crop_lines_to_squares
    from effocr_tpu.pipelines.infer import EffOCRInference as JEngine
    from effocr_tpu.retrieval.index import PrototypeIndex as JIndex
    from effocr_torch.cli import infer as t_cli
    from effocr_torch.core.config import (
        EncoderConfig,
        LocalizerConfig,
        PipelineConfig,
    )
    from effocr_torch.interop.flax_bridge import flax_to_state_dict
    from effocr_torch.pipelines.infer import EffOCRInference
    from effocr_torch.retrieval.index import PrototypeIndex
    from test_pipeline_e2e import CHARS, make_line
    from test_torch_pipeline import (
        TEXTS, JaxOracle, TinyEncoder, TorchTinyEncoder, _config,
        torch_oracle)

    enc = TinyEncoder()
    variables = enc.init(jax.random.PRNGKey(3), jnp.zeros((1, 128, 128, 1)))
    crops = []
    for ch in CHARS:
        img, boxes, _ = make_line(ch)
        g = img.mean(axis=-1, keepdims=True)[None].astype(np.float32)
        crops.append(crop_lines_to_squares(
            jnp.asarray(g / 255.0), jnp.asarray([boxes[0]], jnp.int32),
            jnp.zeros((1,), jnp.int32), jnp.ones((1,), bool), out_size=128,
            window=256)[0])
    protos = np.asarray(enc.apply(variables, jnp.stack(crops)))
    t_enc = TorchTinyEncoder(256)
    t_enc.load_state_dict(flax_to_state_dict(variables), strict=True)
    src = []
    for i, text in enumerate(TEXTS[:6]):
        img, _, _ = make_line(text)
        p = tmp_path / f"src{i}.png"
        Image.fromarray(img.mean(axis=-1).astype(np.uint8)).save(p)
        src.append(p)
    root = tmp_path / "lines"
    _nested_mixed_folder(root, src)
    ran = {}

    def engine_of(tag, make):
        def load(args):
            eng = make()
            run = eng.run

            def recorded(images, return_coco=False):
                ran[tag] = list(images)
                return run(images, return_coco=return_coco)

            eng.run = recorded
            return eng
        return load

    monkeypatch.setattr(j_cli, "load_engine", engine_of("jax", lambda: JEngine(
        _config(JPipelineConfig, JLocalizerConfig, JEncoderConfig,
                nms_kernel="pallas"), JaxOracle(), {}, enc, variables,
        JIndex(protos, CHARS))))
    monkeypatch.setattr(t_cli, "load_engine", engine_of(
        "port", lambda: EffOCRInference(
            _config(PipelineConfig, LocalizerConfig, EncoderConfig,
                    nms_kernel="cuda"), torch_oracle, t_enc,
            PrototypeIndex(protos, CHARS), device="cpu")))
    flags = ["--recognizer_dir", "r", "--localizer_dir", "l", "--lang", "en",
             "--image_dir", str(root), "--infer_over_img_dir"]
    monkeypatch.setattr(sys, "argv", ["infer", *flags, "--save_output",
                                      str(tmp_path / "jax")])
    j_cli.main()
    t_cli.main([*flags, "--save_output", str(tmp_path / "port")])
    capsys.readouterr()
    assert ran["port"] == ran["jax"]
    assert len(ran["port"]) == 6 and sum(
        p.endswith(".jpg") for p in ran["port"]) == 4
    for name in ("inference_results.json", "inference_coco.json"):
        with open(tmp_path / "port" / name) as f, open(
                tmp_path / "jax" / name) as g:
            assert json.load(f) == json.load(g), name
    with open(tmp_path / "port" / "inference_results.json") as f:
        assert sum(v is not None for v in json.load(f).values()) >= 4


def test_datasets_read_jpeg_like_jax(tmp_path):
    """CharFolderDataset, DetectionDataset and Seq2SeqDataset items from
    JPEG files (gray, RGB 4:2:0, CMYK) equal the JAX package's."""
    from effocr_tpu.baselines import data as j_s2s_data
    from effocr_tpu.baselines import seq2seq as j_s2s
    from effocr_tpu.data import folder as j_folder
    from effocr_tpu.data.detection import DetectionDataset as JDetection
    from effocr_torch.baselines import data as t_s2s_data
    from effocr_torch.baselines import seq2seq as t_s2s
    from effocr_torch.data import folder
    from effocr_torch.data.detection import DetectionDataset

    rng = np.random.default_rng(3)
    tree = tmp_path / "tree"
    for c in "AXo":
        d = tree / str(ord(c))
        d.mkdir(parents=True)
        for k, mode in enumerate(("L", "RGB", "CMYK")):
            im = Image.fromarray(mi.textured(rng, 40 + k, 37)).convert(mode)
            # the tree globs *.png; Pillow reads by content
            im.save(d / f"{hex(ord(c))}_{k}_Font{k}-Regular.png", "JPEG",
                    quality=70)
    ds, jds = folder.CharFolderDataset(str(tree)), j_folder.CharFolderDataset(
        str(tree))
    assert ds.data == jds.data and len(ds) == 9
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds.load_square(i, 48),
                                      jds.load_square(i, 48))
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    coco = {"images": [], "annotations": [], "categories": [
        {"id": 0, "name": "char"}, {"id": 1, "name": "word"}]}
    for i, mode in enumerate(("L", "RGB", "CMYK", "RGB")):
        g = mi.colour_line(mi.synth_line(rng, n=6))
        Image.fromarray(g).convert(mode).save(img_dir / f"l{i}.jpg",
                                              quality=80)
        coco["images"].append({"id": i, "file_name": f"l{i}.jpg",
                               "width": g.shape[1], "height": g.shape[0],
                               "text": "AXo"})
        coco["annotations"].append({"id": i, "image_id": i,
                                    "category_id": 0, "bbox": [3, 4, 10, 20],
                                    "area": 200, "iscrowd": 0})
    for ch in (1, 3):
        kw = dict(input_size=256, input_height=64, channels=ch,
                  max_targets=8)
        t, j = DetectionDataset(coco, str(img_dir), **kw), JDetection(
            coco, str(img_dir), **kw)
        for i in range(4):
            for a, b in zip(t.load(i)[:3], j.load(i)[:3]):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(t.materialize(), j.materialize()):
            np.testing.assert_array_equal(a, b)
    tds = t_s2s_data.Seq2SeqDataset(coco, str(img_dir),
                                    t_s2s.CharTokenizer(list("AXo")),
                                    img_h=32, img_w=128, max_len=8)
    jds = j_s2s_data.Seq2SeqDataset(coco, str(img_dir),
                                    j_s2s.CharTokenizer(list("AXo")),
                                    img_h=32, img_w=128, max_len=8)
    for a, b in zip(tds.materialize(), jds.materialize()):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- fixtures
def _fixture_names():
    golden = np.load(os.path.join(FIXTURES, "golden.npz"))
    return sorted({k.split("|")[0] for k in golden.files})


def test_fixture_directory_is_small_and_complete():
    names = _fixture_names()
    on_disk = sorted(os.path.relpath(os.path.join(r, f), FIXTURES)
                     for r, _, fs in os.walk(FIXTURES) for f in fs
                     if f != "golden.npz")
    assert names == on_disk and len(names) == 2 * mi.N_LINES + 30 + len(
        mi.LAYOUT_FILES) + len(mi.SAMPLE_FILES)
    total = sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in names)
    assert total + os.path.getsize(os.path.join(FIXTURES, "golden.npz")) \
        < 2 * 2**20


@pytest.mark.parametrize("group", ["lines", "cases", "page"])
def test_fixtures_equal_golden_and_pillow(group):
    golden = np.load(os.path.join(FIXTURES, "golden.npz"))

    def same(name, kind, a):
        assert tuple(golden[f"{name}|{kind}|shape"]) == a.shape, (name, kind)
        np.testing.assert_array_equal(mi.digest(a),
                                      golden[f"{name}|{kind}|sha256"],
                                      err_msg=f"{name} {kind}")

    for name in _fixture_names():
        if not name.startswith(group + "/"):
            continue
        p = os.path.join(FIXTURES, name)
        _, _, rgb, l = _pillow(p)
        same(name, "rgb", rgb)
        same(name, "l", l)
        same(name, "rgb", image_io.read_rgb(p))
        same(name, "l", image_io.read_l(p))
        same(name, "lazy_gray", t_infer._LazyImage(p, gray=True).load())
        same(name, "lazy_rgb", t_infer._LazyImage(p, gray=False).load())
