"""effocr_torch's TIFF reader on the layouts archive scans come in, against
Pillow 12.1 (libtiff 4.7.1) and the JAX package, on the CPU.

Every case is a file written by tests/torch_fixtures/make_images.py
(``tiff_layout``, ``jpeg_tiled``, Pillow's encoder for CCITT and JPEG
segments) from seeded numpy, 37 x 61 so that edge tiles are padded:

- tiles under every compression the strip path takes (none, PackBits,
  LZW and Deflate with and without predictor 2, CCITT 2 / 3 / 4, JPEG
  YCbCr, RGB and gray with ``JPEGTables``), both byte orders, in 1, L,
  LA, I;16(B), P, RGB, RGBA and CMYK;
- little-endian BigTIFF (strips, tiles, separate planes);
- planar configuration 2 (8- and 16-bit, strips and tiles);
- orientations 2-8 over strips, tiles, CCITT, JPEG, P and I;16 files;
- 2- and 4-bit gray in both photometrics, 1 / 2 / 4-bit palettes;
- 16-bit RGB and RGBA in both byte orders, with and without predictor 2.

For each: ``image_io.header``, ``read_rgb`` and ``read_l`` against
``Image.open`` (size, mode, ``convert("RGB")``, ``convert("L")``),
``data/imaging.py open_image`` against what Pillow holds (mode, samples,
palette at its length), and the port's ``_LazyImage`` against the JAX
package's under both channel rules.  Then: the layouts Pillow cannot
open (big-endian BigTIFF, 16-bit LA, predictor 2 on 4-bit samples)
raise ``OSError`` in both; truncated tiles and short tile counts;
``extract_char_crops`` over orientation-6 tiled pages; ``engine.run``
over tiled, BigTIFF and rotated lines, and over float, associated-alpha,
signed and LAB lines (test_torch_tiff_samples.py's layouts), against the
JAX engine; and the golden entries that were committed before these
layouts, unchanged.
Tolerance: none (exact equality) throughout.
"""

from __future__ import annotations

import hashlib
import os
import struct

import numpy as np
import pytest
from PIL import Image

from effocr_tpu.data import coco as j_coco
from effocr_tpu.pipelines import infer as j_infer
from effocr_torch.data import coco as t_coco
from effocr_torch.data import image_io, imaging
from effocr_torch.pipelines import infer as t_infer
from test_torch_image_modes import H, W, _coco, assert_same_view, pillow_view
from test_torch_pipeline import (  # noqa: F401  (tiny_parts: a fixture)
    TEXTS, TorchTinyEncoder, _run_both, tiny_parts)
from torch_fixtures import make_images as mi

SHAPE = (37, 61)


# ------------------------------------------------------------ content
def _rgb(r):
    return mi.textured(r, *SHAPE)


def _gray(r):
    return _rgb(r)[..., 1]


def _bits(r, b):
    return r.integers(0, 1 << b, SHAPE).astype(np.uint8)


def _rgb16(r, c=3):
    return (r.integers(0, 256, SHAPE + (c,)).astype(np.uint16) << 8
            | r.integers(0, 256, SHAPE + (c,)).astype(np.uint16))


def _cmap(r, b):
    return {320: (3, list(r.integers(0, 65536, 3 << b)))}


def _ccitt(r, comp, **kw):
    name = {2: "tiff_ccitt", 3: "group3", 4: "group4"}[comp]
    return mi.tiff_layout(
        (_gray(r) > 128).astype(np.uint8), bits=1, compression=comp,
        encode=lambda t: mi.pillow_segment(t * 255, "1",
                                           compression=name)[0], **kw)


def _planar(img, photo, **kw):
    return mi.tiff_layout(img, photometric=photo, planar=2, **kw)


CASES = {
    # tiles
    "tile_raw_gray": lambda r: mi.tiff_layout(_gray(r), tile=(16, 16)),
    "tile_raw_rgb_mm": lambda r: mi.tiff_layout(
        _rgb(r), photometric=2, order=">", tile=(16, 32)),
    "tile_lzw_pred_rgb": lambda r: mi.tiff_layout(
        _rgb(r), photometric=2, compression=5, predictor=2, tile=(32, 16)),
    "tile_lzw_pred_gray_mm": lambda r: mi.tiff_layout(
        _gray(r), order=">", compression=5, predictor=2, tile=(16, 16)),
    "tile_lzw_gray": lambda r: mi.tiff_layout(_gray(r), compression=5,
                                              tile=(48, 32)),
    "tile_deflate_gray": lambda r: mi.tiff_layout(_gray(r), compression=8,
                                                  tile=(16, 32)),
    "tile_deflate_pred_rgb_mm": lambda r: mi.tiff_layout(
        _rgb(r), photometric=2, order=">", compression=32946, predictor=2,
        tile=(16, 16)),
    "tile_packbits_gray_mm": lambda r: mi.tiff_layout(
        _gray(r), order=">", compression=32773, tile=(32, 32)),
    "tile_lzw_rgba": lambda r: mi.tiff_layout(
        np.dstack([_rgb(r), _gray(r)]), photometric=2, compression=5,
        tile=(16, 16), extra_tags={338: (3, [2])}),
    "tile_raw_la": lambda r: mi.tiff_layout(
        np.dstack([_gray(r), _gray(r)]), tile=(16, 16),
        extra_tags={338: (3, [2])}),
    "tile_deflate_cmyk": lambda r: mi.tiff_layout(
        np.dstack([_rgb(r), _gray(r)]), photometric=5, compression=8,
        tile=(16, 16)),
    "tile_i16_lzw_pred_mm": lambda r: mi.tiff_layout(
        r.integers(0, 700, SHAPE), bits=16, order=">", compression=5,
        predictor=2, tile=(16, 16)),
    "tile_i16_raw": lambda r: mi.tiff_layout(
        r.integers(0, 700, SHAPE), bits=16, tile=(32, 16)),
    "tile_1bit_raw_miniswhite": lambda r: mi.tiff_layout(
        _bits(r, 1), bits=1, photometric=0, tile=(16, 16)),
    "tile_p8_lzw": lambda r: mi.tiff_layout(
        _gray(r), photometric=3, compression=5, tile=(16, 16),
        extra_tags=_cmap(r, 8)),
    "tile_jpeg_ycbcr": lambda r: mi.jpeg_tiled(_rgb(r)),
    "tile_jpeg_rgb_mm": lambda r: mi.jpeg_tiled(_rgb(r), mode="RGB",
                                                order=">"),
    "tile_jpeg_gray": lambda r: mi.jpeg_tiled(_gray(r), tile=(32, 16),
                                              mode="L"),
    "tile_g4": lambda r: _ccitt(r, 4, tile=(16, 16)),
    "tile_g3": lambda r: _ccitt(r, 3, tile=(32, 16)),
    "tile_mh_mm": lambda r: _ccitt(r, 2, tile=(16, 32), order=">"),
    # BigTIFF (little-endian: Pillow opens no other)
    "big_strips_raw": lambda r: mi.tiff_layout(_gray(r), big=True,
                                               rows_per_strip=8),
    "big_strips_lzw_rgb": lambda r: mi.tiff_layout(
        _rgb(r), photometric=2, big=True, compression=5, rows_per_strip=5),
    "big_tiles_deflate": lambda r: mi.tiff_layout(
        _gray(r), big=True, compression=8, tile=(16, 16)),
    "big_tiles_planar_lzw_pred": lambda r: _planar(
        _rgb(r), 2, big=True, compression=5, predictor=2,
        tile=(16, 16)),
    "big_tiles_jpeg": lambda r: mi.jpeg_tiled(_rgb(r), big=True),
    "big_g4": lambda r: _ccitt(r, 4, big=True),
    # separate planes
    "planar_raw_rgb": lambda r: _planar(_rgb(r), 2, rows_per_strip=10),
    "planar_lzw_pred_rgb_mm": lambda r: _planar(
        _rgb(r), 2, order=">", compression=5, predictor=2),
    "planar_deflate_rgba": lambda r: _planar(
        np.dstack([_rgb(r), _gray(r)]), 2, compression=8,
        rows_per_strip=16, extra_tags={338: (3, [2])}),
    "planar_packbits_cmyk": lambda r: _planar(
        np.dstack([_rgb(r), _gray(r)]), 5, compression=32773),
    "planar_tiles_raw": lambda r: _planar(_rgb(r), 2, tile=(16, 32)),
    "planar_tiles_deflate_pred_mm": lambda r: _planar(
        _rgb(r), 2, order=">", compression=8, predictor=2,
        tile=(32, 16)),
    "planar_rgb16_lzw_pred": lambda r: _planar(
        _rgb16(r), 2, bits=16, compression=5, predictor=2),
    "planar_rgb16_deflate_mm": lambda r: _planar(
        _rgb16(r), 2, bits=16, order=">", compression=8,
        tile=(16, 16)),
    "planar_one_sample_lzw": lambda r: mi.tiff_layout(
        _gray(r), compression=5, planar=2),
    # 16-bit RGB / RGBA: each sample's high byte
    "rgb16_raw": lambda r: mi.tiff_layout(_rgb16(r), bits=16, photometric=2),
    "rgb16_raw_mm": lambda r: mi.tiff_layout(_rgb16(r), bits=16,
                                             photometric=2, order=">"),
    "rgb16_lzw_pred": lambda r: mi.tiff_layout(
        _rgb16(r), bits=16, photometric=2, compression=5, predictor=2,
        rows_per_strip=9),
    "rgb16_lzw_pred_mm": lambda r: mi.tiff_layout(
        _rgb16(r), bits=16, photometric=2, order=">", compression=5,
        predictor=2),
    "rgb16_deflate_pred": lambda r: mi.tiff_layout(
        _rgb16(r), bits=16, photometric=2, compression=8, predictor=2),
    "rgb16_deflate_mm_tiles": lambda r: mi.tiff_layout(
        _rgb16(r), bits=16, photometric=2, order=">", compression=32946,
        tile=(16, 16)),
    "rgba16_lzw_pred": lambda r: mi.tiff_layout(
        _rgb16(r, 4), bits=16, photometric=2, compression=5, predictor=2,
        extra_tags={338: (3, [2])}),
    "rgba16_raw_mm": lambda r: mi.tiff_layout(
        _rgb16(r, 4), bits=16, photometric=2, order=">",
        extra_tags={338: (3, [2])}),
}
for _b in (2, 4):
    for _photo in (0, 1):
        for _comp in (1, 5, 8, 32773):
            CASES[f"gray{_b}_photo{_photo}_c{_comp}"] = (
                lambda r, b=_b, p=_photo, c=_comp: mi.tiff_layout(
                    _bits(r, b), bits=b, photometric=p, compression=c,
                    tile=(16, 16) if c == 8 else None, rows_per_strip=7))
    CASES[f"gray{_b}_mm_tiles"] = lambda r, b=_b: mi.tiff_layout(
        _bits(r, b), bits=b, order=">", compression=5, tile=(32, 16))
for _b in (1, 2, 4):
    for _comp in (1, 5):
        CASES[f"palette{_b}_c{_comp}"] = lambda r, b=_b, c=_comp: (
            mi.tiff_layout(_bits(r, b), bits=b, photometric=3,
                           compression=c, extra_tags=_cmap(r, b)))
for _o in range(2, 9):
    _t = {274: (3, [_o])}
    CASES[f"orient{_o}_strips_gray"] = lambda r, t=_t: mi.tiff_layout(
        _gray(r), compression=5, rows_per_strip=16, extra_tags=t)
    CASES[f"orient{_o}_tiles_rgb"] = lambda r, t=_t: mi.tiff_layout(
        _rgb(r), photometric=2, compression=8, predictor=2, tile=(16, 16),
        extra_tags=t)
    CASES[f"orient{_o}_jpeg_tiles"] = lambda r, t=_t: mi.jpeg_tiled(
        _rgb(r), extra_tags=t)
    CASES[f"orient{_o}_g4"] = lambda r, t=_t: _ccitt(r, 4, extra_tags=t)
    CASES[f"orient{_o}_p4"] = lambda r, t=_t: mi.tiff_layout(
        _bits(r, 4), bits=4, photometric=3, extra_tags={**_cmap(r, 4), **t})
    CASES[f"orient{_o}_i16_mm"] = lambda r, t=_t: mi.tiff_layout(
        r.integers(0, 700, SHAPE), bits=16, order=">", rows_per_strip=8,
        extra_tags=t)
for _o in (0, 9):       # out of range: Pillow leaves the image as it is
    CASES[f"orient{_o}_ignored"] = lambda r, o=_o: mi.tiff_layout(
        _gray(r), extra_tags={274: (3, [o])})


def _write(d, name: str, data: bytes) -> str:
    p = os.path.join(str(d), name + ".tif")
    with open(p, "wb") as f:
        f.write(data)
    return p


def make_case(name: str, d) -> str:
    return _write(d, name, CASES[name](np.random.default_rng(
        sum(map(ord, name)))))


def assert_like_pillow_and_jax(p: str):
    with Image.open(p) as im:
        (w, h), mode = im.size, im.mode
        rgb, l = np.asarray(im.convert("RGB")), np.asarray(im.convert("L"))
    assert image_io.header(p) == (h, w, mode)
    np.testing.assert_array_equal(image_io.read_rgb(p), rgb)
    np.testing.assert_array_equal(image_io.read_l(p), l)
    got = imaging.open_image(p)
    assert_same_view((got.mode, got.px, got.palette, got.transparency),
                     pillow_view(p), p)
    for gray in (True, False):
        t, j = t_infer._LazyImage(p, gray), j_infer._LazyImage(p, gray)
        assert t.shape == j.shape, (p, gray)
        np.testing.assert_array_equal(t.load(), j.load(), err_msg=p)
    return h, w, mode


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_matches_pillow_and_jax(case, tmp_path):
    p = make_case(case, tmp_path)
    h, w, mode = assert_like_pillow_and_jax(p)
    if case.startswith(("orient5", "orient6", "orient7", "orient8")):
        # the header reports the transposed size before any decode, as
        # Image.open(...).size does, and the pixels have it
        assert (h, w) == SHAPE[::-1] == image_io.read_l(p).shape


MAPPED = {
    "L": lambda r: mi.tiff_layout(_gray(r)),
    "L_exact_tile": lambda r: mi.tiff_layout(_gray(r)[:32, :48],
                                             tile=(48, 32)),
    "L_tall_tile": lambda r: mi.tiff_layout(_gray(r)[:20, :30],
                                            tile=(32, 64)),
    "P": lambda r: mi.tiff_layout(_gray(r), photometric=3,
                                  extra_tags=_cmap(r, 8)),
    "RGBA": lambda r: mi.tiff_layout(np.dstack([_rgb(r), _gray(r)]),
                                     photometric=2,
                                     extra_tags={338: (3, [2])}),
    "CMYK": lambda r: mi.tiff_layout(np.dstack([_rgb(r), _gray(r)]),
                                     photometric=5),
    "I;16": lambda r: mi.tiff_layout(r.integers(0, 700, SHAPE), bits=16),
    "I;16B": lambda r: mi.tiff_layout(r.integers(0, 700, SHAPE), bits=16,
                                      order=">"),
}


@pytest.mark.parametrize("orientation", [5, 6, 7, 8])
@pytest.mark.parametrize("kind", sorted(MAPPED))
def test_memory_mapped_rotations_keep_pillows_pixels(kind, orientation,
                                                     tmp_path):
    """One uncompressed strip or tile of L, P, RGBA, CMYK or I;16:
    Pillow memory-maps it at ``Image.open``'s (transposed) size, so the
    stored bytes read as w rows of h samples, then transposes that; its
    pixels keep the stored h x w while the size it reported before
    ``load`` (and the JAX ``_LazyImage`` shape) is w x h. The port gives
    both, as Pillow does."""
    data = MAPPED[kind](np.random.default_rng(len(kind)))
    p = _write(tmp_path, "m", mi.tiff_bytes(*_retag(data, {274: (
        3, [orientation])})))
    h, w, _ = assert_like_pillow_and_jax(p)
    assert image_io.read_l(p).shape == (w, h)


def _retag(data: bytes, extra):
    """(segments, tags, order, big, tiled) of a file ``tiff_layout``
    wrote, with ``extra`` tags added."""
    import io

    with Image.open(io.BytesIO(data)) as im:
        tags = dict(im.tag_v2)
    tiled = 324 in tags
    key = (324, 325) if tiled else (273, 279)
    segs = [data[o:o + c] for o, c in zip(tags[key[0]], tags[key[1]])]
    keep = {k: (4 if k in (256, 257) else 3, list(v) if isinstance(
        v, tuple) else [v]) for k, v in tags.items() if k in (
        256, 257, 258, 259, 262, 277, 278, 284, 320, 322, 323, 338)}
    keep.update(extra)
    return segs, keep, "<" if data[:2] == b"II" else ">", False, tiled


def test_bigtiff_ifd_past_the_first_header_read(tmp_path):
    """A BigTIFF whose IFD and tile offsets lie past ``HEAD_BYTES``: the
    header reads the whole file, in ``_LazyImage`` too."""
    r = np.random.default_rng(4)
    data = mi.tiff_layout(mi.textured(r, 61, 70), photometric=2, big=True,
                          tile=(16, 16))
    assert struct.unpack("<Q", data[8:16])[0] > image_io.HEAD_BYTES
    assert_like_pillow_and_jax(_write(tmp_path, "big", data))


def test_uncompressed_short_tile_count_reads_zeros_like_pillow(tmp_path):
    """Pillow's raw decoder reads the tiles an uncompressed file lists and
    leaves the rest 0 (in the image's mode: black under MinIsWhite too);
    strips the same."""
    r = np.random.default_rng(5)
    for name, kw in (("tiles", dict(tile=(16, 16), photometric=0)),
                     ("planar", dict(tile=(16, 16), planar=2,
                                     photometric=2)),
                     ("strips", dict(rows_per_strip=8))):
        img = _rgb(r) if name == "planar" else _gray(r)
        segs, keep, order, big, tiled = _retag(mi.tiff_layout(img, **kw),
                                               {})
        p = _write(tmp_path, name, mi.tiff_bytes(
            segs[:len(segs) - 3], keep, order, big, tiled))
        with Image.open(p) as im:
            assert (np.asarray(im) == 0).any()
        assert_like_pillow_and_jax(p)


@pytest.mark.parametrize("comp", [5, 8, 7, 4])
def test_truncated_tiles_raise_like_pillow(comp, tmp_path):
    """A tile count short of the image, a tile cut inside its byte count
    (LZW, Deflate), a file cut before its IFD: OSError, as Pillow raises
    (libtiff's "decoder error", "cannot identify image file").  A cut
    JPEG tile gives Pillow's pixels (libjpeg's gray past the cut), and so
    does a cut group 4 tile (libtiff's rows up to the cut, the rows past
    it those of the tile decoded before it in Pillow's one buffer)."""
    r = np.random.default_rng(comp)
    full = (mi.jpeg_tiled(_rgb(r)) if comp == 7 else _ccitt(
        r, 4, tile=(16, 16)) if comp == 4 else mi.tiff_layout(
        _gray(r), compression=comp, predictor=2, tile=(16, 16)))
    with Image.open(_write(tmp_path, "full", full)) as im:
        tags = dict(im.tag_v2)
    offs, counts = tags[324], tags[325]
    segs = [full[o:o + c] for o, c in zip(offs, counts)]
    keep = {k: (7 if k == 347 else 4 if k in (256, 257) else 3,
                list(v) if isinstance(v, (tuple, bytes)) else [v])
            for k, v in tags.items() if k not in (324, 325)
            and isinstance(v, (int, tuple, bytes))}
    cases = {
        "short": mi.tiff_bytes(segs[:-2], keep, tiled=True),
        "cut_tile": mi.tiff_bytes(segs[:-1] + [segs[-1][:len(segs[-1])
                                                        // 3]], keep,
                                  tiled=True),
        "cut_file": full[:offs[-1] + counts[-1] // 2],
    }
    for name, data in cases.items():
        p = _write(tmp_path, name, data)
        if name == "cut_tile" and comp in (7, 4):
            assert_like_pillow_and_jax(p)
            continue
        with pytest.raises(OSError):
            with Image.open(p) as im:
                im.convert("RGB")
        for fn in (image_io.read_rgb, image_io.read_l,
                   lambda q: t_infer._LazyImage(q, gray=True).load()):
            with pytest.raises(OSError, match="TIFF"):
                fn(p)


@pytest.mark.parametrize("case", ["bigtiff_mm", "la16", "predictor2_4bit",
                                  "la16_mm_planar", "la_planes_raw"])
def test_layouts_pillow_cannot_open_raise_oserror(case, tmp_path):
    """Pillow 12.1 opens no big-endian BigTIFF (it reads the BigTIFF mark
    from the little-endian byte only), has no 16-bit LA mode and no raw
    unpacker for an A plane alone (a ValueError there), and libtiff
    refuses horizontal differencing on 4-bit samples: an error in both,
    OSError in the port."""
    r = np.random.default_rng(7)
    data = {
        "bigtiff_mm": lambda: mi.tiff_layout(_gray(r), order=">", big=True),
        "la16": lambda: mi.tiff_layout(_rgb16(r, 2), bits=16,
                                       extra_tags={338: (3, [2])}),
        "predictor2_4bit": lambda: mi.tiff_layout(
            _bits(r, 4), bits=4, compression=5, predictor=2),
        "la16_mm_planar": lambda: mi.tiff_layout(
            _rgb16(r, 2), bits=16, order=">", planar=2, compression=5,
            extra_tags={338: (3, [2])}),
        "la_planes_raw": lambda: mi.tiff_layout(
            np.dstack([_gray(r), _gray(r)]), planar=2,
            extra_tags={338: (3, [2])}),
    }[case]()
    p = _write(tmp_path, case, data)
    with pytest.raises((OSError, ValueError)):
        with Image.open(p) as im:
            im.convert("RGB")
    for fn in (image_io.read_rgb,
               lambda q: t_infer._LazyImage(q, gray=False).load()):
        with pytest.raises(OSError, match="TIFF"):
            fn(p)


@pytest.mark.parametrize("case", ["rgb16_raw", "la_lzw"])
def test_planes_pillow_misreads_are_refused_by_name(case, tmp_path):
    """Pillow's raw decoder unpacks uncompressed 16-bit planes with its
    8-bit band unpackers, and its libtiff path gives LA planes that are
    not the file's: refused, by name."""
    r = np.random.default_rng(8)
    img = _rgb16(r) if case == "rgb16_raw" else np.dstack([_gray(r),
                                                          _gray(r) // 2])
    p = _write(tmp_path, case, mi.tiff_layout(
        img, bits=16, photometric=2, planar=2) if case == "rgb16_raw"
        else mi.tiff_layout(img, planar=2, compression=5,
                            extra_tags={338: (3, [2])}))
    with Image.open(p) as im:
        assert not np.array_equal(np.asarray(im), (
            img >> 8 if case == "rgb16_raw" else img).astype(np.uint8))
    with pytest.raises(NotImplementedError,
                       match="planar configuration 2.*ROADMAP.md, queue 1"):
        image_io.read_rgb(p)


# ------------------------------------------------------------ dataset tools
def _page(kind, r):
    """An H x W page of the mode, stored as orientation 6 (rotated 90
    degrees counter-clockwise, LZW tiles of 16 x 16) so that Pillow's
    transpose gives it upright."""
    img = {"L": _gray, "RGB": _rgb}.get(kind, lambda q: _bits(q, 4))(r)
    img = np.rot90(img[:H, :W], 1)
    kw = dict(compression=5, tile=(16, 16), extra_tags={274: (3, [6])})
    if kind == "RGB":
        kw["photometric"] = 2
    if kind == "P4":
        kw.update(bits=4, photometric=3,
                  extra_tags={274: (3, [6]), **_cmap(r, 4)})
    return mi.tiff_layout(np.ascontiguousarray(img), **kw)


@pytest.mark.parametrize("kind", ["L", "RGB", "P4"])
def test_char_crops_over_a_rotated_tiled_page_match_jax(kind, tmp_path):
    img_dir = tmp_path / "img"
    img_dir.mkdir()
    p = _write(img_dir, f"page_{kind}", _page(kind, np.random.default_rng(
        len(kind))))
    with Image.open(p) as im:
        assert im.size == (W, H)
    coco = _coco(p)
    crops = {k: str(tmp_path / k) for k in ("jax", "port")}
    n = j_coco.extract_char_crops(coco, str(img_dir), crops["jax"])
    assert t_coco.extract_char_crops(coco, str(img_dir), crops["port"]) \
        == n == 5
    names = sorted(os.listdir(crops["jax"]))
    assert names == sorted(os.listdir(crops["port"]))
    for f in names:
        assert_same_view(pillow_view(os.path.join(crops["port"], f)),
                         pillow_view(os.path.join(crops["jax"], f)),
                         (kind, f))


# ------------------------------------------------------------ the engine
def test_engine_reads_tiled_bigtiff_and_rotated_lines_like_jax(
        tiny_parts, tmp_path):
    """engine.run over gray lines as a tiled TIFF, a BigTIFF, an
    orientation-6 and an orientation-3 file, a 4-bit gray file and 16-bit
    RGB planes: the JAX engine's text on the same weights, which is each
    line's text where the pixels are the line's own."""
    from effocr_torch.interop.flax_bridge import flax_to_state_dict
    from test_pipeline_e2e import CHARS, make_line

    enc, variables, protos = tiny_parts
    t_enc = TorchTinyEncoder(256)
    t_enc.load_state_dict(flax_to_state_dict(variables), strict=True)
    writers = [
        lambda g: mi.tiff_layout(g, compression=8, predictor=2,
                                 tile=(32, 16)),
        lambda g: mi.tiff_layout(g, big=True, compression=5,
                                 rows_per_strip=16),
        lambda g: mi.tiff_layout(np.ascontiguousarray(np.rot90(g, 1)),
                                 compression=5, tile=(16, 16),
                                 extra_tags={274: (3, [6])}),
        lambda g: mi.tiff_layout(np.ascontiguousarray(g[::-1, ::-1]),
                                 extra_tags={274: (3, [3])}),
        lambda g: mi.tiff_layout(g >> 4, bits=4, compression=5),
        lambda g: mi.tiff_layout(np.repeat(g[..., None], 3, -1).astype(
            np.uint16) * 257, bits=16, photometric=2, planar=2,
            compression=8, tile=(16, 16)),
    ]
    paths, exact = [], []
    for i, write in enumerate(writers):
        img, _, _ = make_line(TEXTS[i])
        g = img.mean(axis=-1).astype(np.uint8)
        paths.append(_write(tmp_path, f"line{i}", write(g)))
        exact.append(i != 4)
    jres, tres, _, _, _ = _run_both(paths, enc, variables, t_enc, protos,
                                    CHARS)
    for i, p in enumerate(paths):
        assert tres[p] == jres[p], (i, tres[p], jres[p])
        if exact[i]:
            assert tres[p] == TEXTS[i], (i, tres[p])


def test_engine_reads_sample_layouts_like_jax(tiny_parts, tmp_path):
    """engine.run over gray lines stored as float (Deflate, predictor 3),
    associated-alpha RGBA, big-endian signed 16-bit and LAB:
    the JAX engine's text on the same weights, which is each line's text
    where the pixels are the line's own."""
    from effocr_torch.interop.flax_bridge import flax_to_state_dict
    from test_pipeline_e2e import CHARS, make_line

    enc, variables, protos = tiny_parts
    t_enc = TorchTinyEncoder(256)
    t_enc.load_state_dict(flax_to_state_dict(variables), strict=True)
    writers = [
        lambda g: mi.tiff_layout(g.astype(np.float32) + 0.25, bits=32,
                                 sample_format=3, compression=8,
                                 predictor=3),
        lambda g: mi.tiff_layout(np.dstack([g, g, g, np.full_like(g, 255)]),
                                 photometric=2, compression=5,
                                 extra_tags={338: (3, [1])}),
        lambda g: mi.tiff_layout(g.astype(np.int64), bits=16,
                                 sample_format=2, order=">"),
        lambda g: mi.tiff_layout(np.dstack([g, np.zeros_like(g),
                                            np.zeros_like(g)]),
                                 photometric=8),
    ]
    paths, exact = [], []
    for i, write in enumerate(writers):
        img, _, _ = make_line(TEXTS[i])
        g = img.mean(axis=-1).astype(np.uint8)
        paths.append(_write(tmp_path, f"line{i}", write(g)))
        exact.append(i < 3)
    jres, tres, _, _, _ = _run_both(paths, enc, variables, t_enc, protos,
                                    CHARS)
    for i, p in enumerate(paths):
        assert tres[p] == jres[p], (i, tres[p], jres[p])
        if exact[i]:
            assert tres[p] == TEXTS[i], (i, tres[p])


# ------------------------------------------------------------ fixtures
# golden.npz before the layout fixtures: 752 entries, their digest
OLD_GOLDEN = (752, "b65b4d1bcfac47892e220c38693e4a434979dd2bd4c9a3fd7c64ee7b"
                   "137e82d5")


def test_old_golden_entries_are_unchanged_and_layouts_have_theirs():
    golden = np.load(os.path.join(mi.OUT, "golden.npz"))
    old = sorted(k for k in golden.files
                 if k.split("|")[0] not in mi.LAYOUT_FILES + mi.SAMPLE_FILES
                 + mi.COMPRESSION_FILES)
    h = hashlib.sha256()
    for k in old:
        h.update(k.encode() + b"\0" + np.ascontiguousarray(
            golden[k]).tobytes())
    assert (len(old), h.hexdigest()) == OLD_GOLDEN
    for name in mi.LAYOUT_FILES:
        for kind in ("rgb", "l", "lazy_gray", "lazy_rgb"):
            assert f"{name}|{kind}|sha256" in golden.files, (name, kind)
        assert os.path.getsize(os.path.join(mi.OUT, name)) < 20000, name
