"""effocr_torch's TIFF reader on every compression Pillow 12.1 reads
(libtiff 4.7.1, libzstd 1.5.7, liblzma), against Pillow, libzstd and the
JAX package, on the CPU.

- every code of Pillow's ``COMPRESSION_INFO`` and six it does not know,
  over gray, RGB, 1-bit and 4-bit samples: Pillow's pixels, or OSError
  where Pillow raises, at open (a code it does not know: ``_LazyImage``
  raises when it is built, in both packages) or at load (WebP, SGILog,
  RLEW off 1 bit, ThunderScan off 4 bits, a CCITT codec off 1 bit);
- LZMA and ZSTD in strips, tiles and planes, both byte orders,
  predictors 1, 2 and 3;
- ZSTD frames libzstd writes (levels 1, 3, 19, 22, random, constant and
  text-like data over several 128 KiB blocks, with the checksum at 3
  and 22) and frames made by hand (raw and RLE blocks, a skippable
  frame, several frames, a dictionary ID, a window above libzstd's
  limit, a reserved bit, a wrong checksum or content size): the bytes
  libzstd gives libtiff's loop over one segment, or OSError where that
  loop fails;
- CCITT RLEW from the fixtures' writer (rows word-aligned against the
  file, strips at even and odd offsets) and ThunderScan (every code);
- old-style JPEG as an interchange-format stream and as tables with
  bare strips, gray and YCbCr 1x1 / 2x1 / 2x2 (the subsampling tag
  wrong or missing: the frame's holds), the component planes as libjpeg's
  raw data output gives libtiff, converted by libtiff's tables; Pillow's
  errors (one-sample YCbCr, a 1-bit file at open); photometric RGB
  refused by name (Pillow unpacks libtiff's YCbCr as RGBX);
- segments of each codec cut inside their byte counts;
- ``engine.run`` over ZSTD, LZMA and old-style JPEG lines and
  ``extract_char_crops`` over a ZSTD page, against the JAX package;
- a seeded corruption sweep: every file decodes or raises OSError;
- the committed ``COMPRESSION_FILES`` against their goldens.
Tolerance: none (exact equality; NaN equal to NaN) throughout.
"""

from __future__ import annotations

import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

import zstd_oracle as zo
from effocr_tpu.data import coco as j_coco
from effocr_tpu.pipelines import infer as j_infer
from effocr_torch.data import coco as t_coco
from effocr_torch.data import image_io, tiff
from effocr_torch.native import imgdec
from effocr_torch.pipelines import infer as t_infer
from test_torch_image_modes import H, W, _coco, assert_same_view, pillow_view
from test_torch_pipeline import (  # noqa: F401  (tiny_parts: a fixture)
    TEXTS, TorchTinyEncoder, _run_both, tiny_parts)
from test_torch_tiff_samples import _write, assert_like_pillow_and_jax
from torch_fixtures import make_images as mi

SHAPE = (23, 41)
UNKNOWN = (32766, 32909, 34661, 34887, 50002, 9999)


def _content(kind, r):
    tex = mi.textured(r, *SHAPE)
    return {"gray": tex[..., 1], "rgb": tex,
            "bw": (tex[..., 1] > 128).astype(np.uint8),
            "nib": tex[..., 1] >> 4}[kind]


def _pillow_stage(p):
    """Where Pillow stops: "open", "load", or None (it reads the file)."""
    try:
        im = Image.open(p)
    except OSError:
        return "open"
    with im:
        try:
            im.load()
        except OSError:
            return "load"
    return None


def assert_compression_like_pillow(p):
    """Pillow's pixels (``assert_like_pillow_and_jax``), or OSError at
    the step where Pillow raises: at open, the header and ``_LazyImage``
    (built) in both packages; at load, every reader while the header
    holds Pillow's size and mode."""
    stage = _pillow_stage(p)
    if stage == "open":
        with pytest.raises(OSError, match="TIFF"):
            image_io.header(p)
        for lazy in (t_infer._LazyImage, j_infer._LazyImage):
            with pytest.raises(OSError):
                lazy(p, gray=True)
    elif stage == "load":
        with Image.open(p) as im:
            (w, h), mode = im.size, im.mode
        assert image_io.header(p) == (h, w, mode)
        for gray in (True, False):
            lazy = t_infer._LazyImage(p, gray)
            with pytest.raises(OSError, match="TIFF"):
                lazy.load()
        with pytest.raises(OSError, match="TIFF"):
            image_io.read_rgb(p)
    else:
        assert_like_pillow_and_jax(p)
    return stage


# ------------------------------------------------------------ every code
def _code_file(code, kind):
    """A file of the kind's samples under compression ``code``: encoded
    as its codec writes them where the codec has a writer here, else the
    samples as stored (which Pillow's libtiff fails to decode, or never
    reaches)."""
    img = _content(kind, np.random.default_rng(code % 1000))
    bits = {"bw": 1, "nib": 4}.get(kind, 8)
    photo = 2 if kind == "rgb" else 1
    kw = dict(bits=bits, photometric=photo, rows_per_strip=8)
    raw = lambda t: mi.pack_samples(t, bits).tobytes()  # noqa: E731
    fax = {2: "tiff_ccitt", 3: "group3", 4: "group4"}
    if code in (1, 5, 8, 32773, 32946, 34925, 50000):
        return mi.tiff_layout(img, compression=code, **kw)
    if code in fax and kind == "bw":
        return mi.tiff_layout(img, compression=code, **kw, encode=lambda t:
                              mi.pillow_segment(t * 255, "1",
                                                compression=fax[code])[0])
    if code == 32771 and kind == "bw":
        return mi.tiff_layout(img, compression=code, **kw, encode=mi.rlew)
    if code == 32809 and kind == "nib":
        return mi.tiff_layout(img, compression=code, **kw,
                              encode=mi.thunderscan)
    if code == 6 and kind in ("gray", "rgb"):
        return mi.ojpeg(img, (2, 2))
    if code == 7 and kind in ("gray", "rgb"):
        mode = "L" if kind == "gray" else "RGB"
        return mi.tiff_layout(img, compression=7, **kw, encode=lambda t:
                              mi.pillow_segment(t, mode, compression="jpeg",
                                                quality=90)[0])
    return mi.tiff_layout(img, compression=code, **kw, encode=raw)


def test_compression_table_is_pillows():
    assert tiff._COMPRESSION_INFO == TiffImagePlugin.COMPRESSION_INFO


@pytest.mark.parametrize("kind", ["gray", "rgb", "bw", "nib"])
@pytest.mark.parametrize("code", sorted(TiffImagePlugin.COMPRESSION_INFO)
                         + list(UNKNOWN))
def test_every_code_reads_or_raises_like_pillow(code, kind, tmp_path):
    p = _write(tmp_path, f"c{code}_{kind}", _code_file(code, kind))
    stage = assert_compression_like_pillow(p)
    if code in UNKNOWN:
        assert stage == "open"
    if code in (34925, 50000, 5, 8):
        assert stage is None


# ------------------------------------------------------------ LZMA, ZSTD
_LAYOUTS = {
    "strips": lambda r, c, o: mi.tiff_layout(
        _content("gray", r), compression=c, order=o, rows_per_strip=8),
    "tiles_pred2": lambda r, c, o: mi.tiff_layout(
        _content("rgb", r), photometric=2, compression=c, order=o,
        predictor=2, tile=(16, 16)),
    "planes_pred2": lambda r, c, o: mi.tiff_layout(
        _content("rgb", r), photometric=2, compression=c, order=o,
        predictor=2, planar=2),
    "gray16_pred2": lambda r, c, o: mi.tiff_layout(
        r.integers(0, 65536, SHAPE), bits=16, compression=c, order=o,
        predictor=2, rows_per_strip=10),
    "float_pred3": lambda r, c, o: mi.tiff_layout(
        r.normal(100, 90, SHAPE).astype(np.float32), bits=32,
        sample_format=3, compression=c, order=o, predictor=3,
        tile=(16, 16)),
}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("comp", [34925, 50000])
def test_lzma_and_zstd_layouts_match_pillow(comp, order, layout, tmp_path):
    p = _write(tmp_path, layout, _LAYOUTS[layout](
        np.random.default_rng(len(layout)), comp, order))
    assert assert_compression_like_pillow(p) is None


def test_predictor_2_on_1_bit_raises_like_libtiff(tmp_path):
    for comp in (34925, 50000):
        p = _write(tmp_path, f"p{comp}", mi.tiff_layout(
            _content("bw", np.random.default_rng(1)), bits=1,
            compression=comp, predictor=2))
        assert assert_compression_like_pillow(p) == "load"


# ------------------------------------------------------------ ZSTD frames
def _text(n, r):
    words = [bytes(r.integers(97, 123, r.integers(2, 9))) for _ in range(200)]
    out = b" ".join(words[i] for i in r.integers(0, 200, n // 4 + 1))
    return out[:n]


def _data(kind):
    r = np.random.default_rng(len(kind))
    n = 300_000
    if kind == "random":
        return r.integers(0, 256, n).astype(np.uint8).tobytes()
    if kind == "constant":
        return b"\x5a" * n
    if kind == "text":
        return _text(n, r)
    # text, a near-constant field, a random field: mixed blocks
    return (_text(n // 3, r) + r.integers(0, 3, n // 3).astype(
        np.uint8).tobytes() + r.integers(0, 256, n // 3).astype(
            np.uint8).tobytes())


def _port(frame, occ):
    try:
        return imgdec.zstd(frame, occ).tobytes()
    except OSError:
        return None


def assert_like_libzstd(frame, occs):
    for occ in occs:
        assert _port(frame, occ) == zo.tiff_segment(frame, occ), occ


@pytest.mark.parametrize("kind", ["random", "constant", "text", "mixed"])
@pytest.mark.parametrize("level", [1, 3, 19, 22])
def test_zstd_frames_decode_to_libzstds_bytes(level, kind):
    """With the checksum at levels 3 and 22, without at 1 and 19."""
    data = _data(kind)
    frame = zo.compress(data, level, level in (3, 22))
    assert zo.tiff_segment(frame, len(data)) == data
    assert_like_libzstd(frame, (len(data), len(data) - 1, 70_000,
                                len(data) + 1))


def _frame(blocks, fhd=0x20, content=None, extra=b"", checksum=None):
    """A frame by hand: header descriptor ``fhd`` (single segment, a
    1-byte content size by default), ``extra`` header bytes, blocks
    [(type, last, body, size)], the checksum's 4 bytes."""
    head = struct.pack("<IB", 0xFD2FB528, fhd) + extra
    if content is not None:
        head += bytes([content])
    body = b"".join(struct.pack("<I", (size << 3) | (t << 1) | last)[:3] + b
                    for t, last, b, size in blocks)
    return head + body + (checksum or b"")


def _hand_frames():
    xx = struct.pack("<I", _xxh64_low(b"ab" * 30 + b"Z" * 40))
    ok = _frame([(0, 0, b"ab" * 30, 60), (1, 1, b"Z", 40)], fhd=0x24,
                content=100, checksum=xx)
    bad_xx = ok[:-1] + bytes([ok[-1] ^ 1])
    big = zo.compress(b"q" * 200_000 + bytes(range(256)) * 100, 3)
    return {
        "raw_rle_checksum": (ok, 100),
        "checksum_wrong": (bad_xx, 100),
        "content_size_short": (_frame([(0, 1, b"abc", 3)], content=9), 9),
        "content_size_long": (_frame([(0, 1, b"abcdef", 6)], content=4), 4),
        "reserved_bit": (_frame([(0, 1, b"abc", 3)], fhd=0x28, content=3),
                         3),
        "dictionary_id": (_frame([(0, 1, b"abc", 3)], fhd=0x22,
                                 extra=struct.pack("<I", 7), content=3), 3),
        "window_2_28": (_frame([(0, 1, b"abc", 3)], fhd=0x00,
                               extra=bytes([(28 - 10) << 3])), 3),
        "window_2_27": (_frame([(0, 1, b"abc", 3)], fhd=0x00,
                               extra=bytes([(27 - 10) << 3])), 3),
        "reserved_block": (_frame([(3, 1, b"abc", 3)], content=3), 3),
        "skippable_first": (struct.pack("<II", 0x184D2A53, 4) + b"skip"
                            + _frame([(0, 1, b"abc", 3)], content=3), 3),
        "two_frames": (_frame([(0, 1, b"abc", 3)], content=3)
                       + _frame([(0, 1, b"def", 3)], content=3), 6),
        "two_frames_first_fills": (_frame([(0, 1, b"abc", 3)], content=3)
                                   + b"\x01\x02", 3),
        "raw_block_cut": (_frame([(0, 1, b"abcdef", 9)], content=9)[:-1],
                          5),
        "unknown_magic": (b"\x27\xb5\x2f\xfd" + bytes(8), 3),
        "several_blocks_cut": (big[:len(big) // 2], 250_000),
        "several_blocks_prefix": (big, 130_000),
    }


def _xxh64_low(data: bytes) -> int:
    """XXH64 (seed 0) of ``data``, its low 32 bits (the frame checksum),
    written out here from the xxHash specification."""
    p1, p2, p3 = 11400714785074694791, 14029467366897019727, \
        1609587929392839161
    p4, p5, m = 9650029242287828579, 2870177450012600261, (1 << 64) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    def rnd(acc, v):
        return rotl((acc + v * p2) & m, 31) * p1 & m

    h, i, n = 0, 0, len(data)
    if n >= 32:
        v = [(p1 + p2) & m, p2, 0, (-p1) & m]
        while i + 32 <= n:
            for k in range(4):
                v[k] = rnd(v[k], int.from_bytes(data[i + 8 * k:i + 8 * k + 8],
                                                "little"))
            i += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12)
             + rotl(v[3], 18)) & m
        for k in range(4):
            h = ((h ^ rnd(0, v[k])) * p1 + p4) & m
    else:
        h = p5
    h = (h + n) & m
    while i + 8 <= n:
        h = (rotl(h ^ rnd(0, int.from_bytes(data[i:i + 8], "little")), 27)
             * p1 + p4) & m
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ (int.from_bytes(data[i:i + 4], "little") * p1 & m),
                  23) * p2 + p3) & m
        i += 4
    while i < n:
        h = rotl(h ^ (data[i] * p5 & m), 11) * p1 & m
        i += 1
    h ^= h >> 33
    h = h * p2 & m
    h ^= h >> 29
    h = h * p3 & m
    return (h ^ (h >> 32)) & 0xFFFFFFFF


@pytest.mark.parametrize("case", sorted(_hand_frames()))
def test_hand_made_zstd_frames_like_libzstd(case):
    frame, occ = _hand_frames()[case]
    assert_like_libzstd(frame, (occ, max(occ - 1, 1)))
    if case in ("raw_rle_checksum", "two_frames_first_fills",
                "several_blocks_prefix"):
        assert _port(frame, occ) is not None
    if case in ("checksum_wrong", "dictionary_id", "window_2_28",
                "reserved_bit", "two_frames", "skippable_first"):
        assert _port(frame, occ) is None


def test_libzstd_frames_with_a_dictionary_id_or_large_window():
    """A frame libzstd wrote with a 2^28 window (its streaming
    compressor, no content size): libzstd's decoder refuses it above its
    default limit, and so does the port; and the same frame with a
    dictionary ID spliced into its header."""
    data = _data("text")[:200_000]
    frame = zo.compress(data, 3, window_log=28, stream=True)
    assert frame[4] & 0x20 == 0 and frame[5] >> 3 == 28 - 10
    assert zo.tiff_segment(frame, len(data)) is None
    assert _port(frame, len(data)) is None
    small = zo.compress(data, 3, window_log=20, stream=True)
    assert _port(small, len(data)) == data
    fhd = small[4]
    assert fhd & 3 == 0 and not fhd & 0x20
    with_id = small[:4] + bytes([fhd | 1]) + small[5:6] + b"\x09" + small[6:]
    assert zo.tiff_segment(with_id, len(data)) is None
    assert _port(with_id, len(data)) is None
    many = zo.compress(data, 3, block=50_000)
    assert_like_libzstd(many, (len(data), 50_000, 40_000))


# ------------------------------------------------------------ RLEW
@pytest.mark.parametrize("rps", [8, 23])
@pytest.mark.parametrize("lead", [0, 1])
@pytest.mark.parametrize("parity", [0, 1])
def test_rlew_reads_like_pillow(parity, lead, rps, tmp_path):
    """Rows word-aligned for data at offsets of one parity, stored at
    offsets of that parity or the other: libtiff aligns against the
    mapped file, so the rows read (or fail) as Pillow reads them."""
    bw = _content("bw", np.random.default_rng(rps))
    data = mi.tiff_bytes(
        [mi.rlew(bw[y:y + rps, :, None], parity) for y in range(0, 23, rps)],
        {256: (4, [41]), 257: (4, [23]), 258: (3, [1]), 259: (3, [32771]),
         262: (3, [1]), 277: (3, [1]), 278: (3, [rps])}, lead=lead)
    stage = assert_compression_like_pillow(_write(tmp_path, "rlew", data))
    if lead == parity:
        assert stage is None
        np.testing.assert_array_equal(image_io.read_l(
            os.path.join(tmp_path, "rlew.tif")), bw * 255)


# ------------------------------------------------------------ ThunderScan
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("photometric", [0, 1, 3])
def test_thunderscan_reads_like_pillow(seed, photometric, tmp_path):
    r = np.random.default_rng(seed)
    nib = _content("nib", r)
    nib[0, :20] = 7                     # a long run, odd and even starts
    nib[1, 3:9] = [1, 2, 3, 2, 1, 0]    # deltas
    kw = {}
    if photometric == 3:
        kw["extra_tags"] = {320: (3, list(r.integers(0, 65536, 48)))}
    data = mi.tiff_layout(nib, bits=4, photometric=photometric,
                          compression=32809, rows_per_strip=5,
                          encode=lambda t: mi.thunderscan(t, seed), **kw)
    p = _write(tmp_path, "thunder", data)
    assert assert_compression_like_pillow(p) is None
    if photometric == 1:
        np.testing.assert_array_equal(image_io.read_l(p), nib * 17)


def test_thunderscan_tiles_and_pixel_counts_raise_like_pillow(tmp_path):
    nib = _content("nib", np.random.default_rng(4))
    cases = {
        "tiles": mi.tiff_layout(nib[:, :32], bits=4, compression=32809,
                                tile=(32, 16), encode=mi.thunderscan),
        "too_few": mi.tiff_layout(nib, bits=4, compression=32809,
                                  encode=lambda t: mi.thunderscan(t)[:-3]),
        "too_many": mi.tiff_layout(nib, bits=4, compression=32809,
                                   encode=lambda t: b"\x3f" + mi.thunderscan(
                                       t)),
    }
    for name, data in cases.items():
        assert assert_compression_like_pillow(
            _write(tmp_path, name, data)) == "load", name


# ------------------------------------------------------------ old JPEG
@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("form,rps", [("jif", None), ("tables", None),
                                      ("tables", 16)])
def test_ojpeg_reads_like_pillow(form, rps, sub, tmp_path):
    r = np.random.default_rng(sub[0] * 3 + sub[1])
    img = mi.textured(r, 40, 41)
    p = _write(tmp_path, "oj", mi.ojpeg(img, sub, form, rows_per_strip=rps))
    assert assert_compression_like_pillow(p) is None


@pytest.mark.parametrize("factors", [
    ((1, 2), (1, 1), (1, 1)), ((4, 1), (1, 1), (1, 1)),
    ((4, 2), (1, 1), (1, 1)), ((2, 2), (1, 1), (1, 1)),
    ((1, 1), (2, 1), (1, 1))])
def test_ojpeg_of_any_jpeg_file_reads_like_pillow(factors, tmp_path):
    """A JPEG file (the fixtures' own encoder, any sampling factors) as
    an interchange-format old JPEG, as chip_smoke.py writes one: 1x2,
    4x1 and 4x2 luma read through libtiff's blocks; chroma sampled above
    1x1 fails in libtiff (OSError)."""
    tex = mi.textured(np.random.default_rng(len(factors[0])), *SHAPE)
    p = _write(tmp_path, "oj", mi.ojpeg_jif(mi.baseline_jpeg(tex, factors)))
    stage = assert_compression_like_pillow(p)
    assert stage == ("load" if factors[1] != (1, 1) else None)


@pytest.mark.parametrize("case", ["tag_11", "no_tag", "gray_jif",
                                  "gray_tables", "gray_miniswhite",
                                  "gray_ycbcr", "bilevel", "rgb_photometric",
                                  "rps_not_mcu"])
def test_ojpeg_corrections_and_errors_like_pillow(case, tmp_path):
    """The frame's subsampling over a wrong or missing tag; gray (also
    MinIsWhite: not inverted, Pillow takes old JPEG as YCbCr); OSError
    for one-sample YCbCr (at load) and a 1-bit file (at open) and for
    strips of a length the MCU does not divide; photometric RGB with 3
    samples refused by name (Pillow unpacks libtiff's YCbCr as RGBX)."""
    r = np.random.default_rng(len(case))
    tex = mi.textured(r, *SHAPE)
    data = {
        "tag_11": lambda: mi.ojpeg(tex, (2, 2), tag_sub=(1, 1)),
        "no_tag": lambda: mi.ojpeg(tex, (1, 1), tag_sub=()),
        "gray_jif": lambda: mi.ojpeg(tex[..., 0]),
        "gray_tables": lambda: mi.ojpeg(tex[..., 0], form="tables"),
        "gray_miniswhite": lambda: mi.ojpeg(tex[..., 0], photometric=0),
        "gray_ycbcr": lambda: mi.ojpeg(tex[..., 0], photometric=6),
        "bilevel": lambda: mi.tiff_layout(
            (tex[..., 0] > 100).astype(np.uint8), bits=1, compression=6,
            encode=lambda t: mi.pack_samples(t, 1).tobytes()),
        "rgb_photometric": lambda: mi.ojpeg(tex, (1, 1), photometric=2),
        "rps_not_mcu": lambda: _set_tags(mi.ojpeg(
            mi.textured(r, 40, 41), (2, 2), "tables", rows_per_strip=16),
            {278: (4, [8])}),
    }[case]()
    p = _write(tmp_path, case, data)
    if case == "rgb_photometric":
        assert _pillow_stage(p) is None
        with pytest.raises(NotImplementedError, match="old-style JPEG"):
            image_io.read_rgb(p)
        return
    stage = assert_compression_like_pillow(p)
    assert stage == {"gray_ycbcr": "load", "bilevel": "open",
                     "rps_not_mcu": "load"}.get(case), stage


def _set_tags(data: bytes, extra) -> bytes:
    """A little-endian TIFF's IFD 0 entries replaced by ``extra`` {tag:
    (type, [value])} (values that fit the entry)."""
    off = struct.unpack("<I", data[4:8])[0]
    n = struct.unpack("<H", data[off:off + 2])[0]
    out = bytearray(data)
    for i in range(n):
        p = off + 2 + 12 * i
        tag = struct.unpack("<H", data[p:p + 2])[0]
        if tag in extra:
            typ, (v,) = extra[tag]
            out[p:p + 12] = struct.pack("<HHI", tag, typ, 1) + struct.pack(
                "<I" if typ == 4 else "<H2x", v)
    return bytes(out)


# ------------------------------------------------------------ cut data
def _cut_files():
    r = np.random.default_rng(9)
    g = _content("gray", r)
    return {
        "zstd": mi.tiff_layout(g, compression=50000, rows_per_strip=8),
        "lzma": mi.tiff_layout(g, compression=34925, rows_per_strip=8),
        "rlew": mi.tiff_layout(_content("bw", r), bits=1, compression=32771,
                               rows_per_strip=8, encode=mi.rlew),
        "thunderscan": mi.tiff_layout(g >> 4, bits=4, compression=32809,
                                      rows_per_strip=8,
                                      encode=mi.thunderscan),
        "ojpeg_tables": mi.ojpeg(mi.textured(r, *SHAPE), (2, 2), "tables",
                                 rows_per_strip=16),
        "ojpeg_jif": mi.ojpeg(mi.textured(r, *SHAPE), (2, 1)),
        "ojpeg_gray": mi.ojpeg(g, form="tables", rows_per_strip=8),
    }


@pytest.mark.parametrize("codec", sorted(_cut_files()))
def test_cut_segments_read_like_pillow(codec, tmp_path):
    """The last segment cut at four fractions of its bytes (the interchange
    format's stream for the one-strip old-style JPEG): Pillow's pixels
    (old JPEG: libjpeg's zeros past the data) or OSError at load."""
    for frac in (0.2, 0.5, 0.8, 0.97):
        p = _write(tmp_path, f"{codec}_{frac}", mi.cut_segment(
            _cut_files()[codec], frac))
        assert assert_compression_like_pillow(p) != "open", frac


# ------------------------------------------------------------ corruption
def test_corrupted_files_decode_or_raise_oserror():
    """Each committed compression fixture with 1-4 seeded bytes changed
    past its header, 40 times: pixels or OSError, nothing else."""
    r = np.random.default_rng(13)
    outcomes = {"pixels": 0, "OSError": 0}
    for name in mi.COMPRESSION_FILES[:-1]:
        with open(os.path.join(mi.OUT, name), "rb") as f:
            data = f.read()
        ifd = struct.unpack("<I" if data[:2] == b"II" else ">I",
                            data[4:8])[0]
        for _ in range(40):
            b = bytearray(data)
            for _ in range(int(r.integers(1, 5))):
                b[int(r.integers(8, ifd))] = int(r.integers(0, 256))
            try:
                tiff.decode(bytes(b))
                outcomes["pixels"] += 1
            except OSError:
                outcomes["OSError"] += 1
    assert min(outcomes.values()) > 0, outcomes


def test_corrupted_zstd_frames_decode_or_raise_oserror():
    r = np.random.default_rng(17)
    data = _data("mixed")[:150_000]
    for level in (1, 19):
        frame = zo.compress(data, level, True)
        for _ in range(150):
            b = bytearray(frame)
            for _ in range(int(r.integers(1, 4))):
                b[int(r.integers(0, len(b)))] = int(r.integers(0, 256))
            if r.random() < 0.2:
                b = b[:int(r.integers(0, len(b)))]
            _port(bytes(b), len(data))


# ------------------------------------------------------------ the engine
def test_engine_reads_compressed_lines_like_jax(tiny_parts, tmp_path):
    """engine.run over gray lines as ZSTD (predictor 2), LZMA tiles,
    old-style JPEG YCbCr 2x2 and gray: the JAX engine's text on the same
    weights, which is each line's text where the pixels are the line's
    own."""
    from effocr_torch.interop.flax_bridge import flax_to_state_dict
    from test_pipeline_e2e import CHARS, make_line

    enc, variables, protos = tiny_parts
    t_enc = TorchTinyEncoder(256)
    t_enc.load_state_dict(flax_to_state_dict(variables), strict=True)
    writers = [
        lambda g: mi.tiff_layout(g, compression=50000, predictor=2,
                                 rows_per_strip=16),
        lambda g: mi.tiff_layout(g, compression=34925, tile=(32, 16)),
        lambda g: mi.ojpeg(np.repeat(g[..., None], 3, -1), (2, 2),
                           quality=95),
        lambda g: mi.ojpeg(g, form="tables", quality=95),
    ]
    paths = []
    for i, write in enumerate(writers):
        img, _, _ = make_line(TEXTS[i])
        g = img.mean(axis=-1).astype(np.uint8)
        paths.append(_write(tmp_path, f"line{i}", write(g)))
    jres, tres, _, _, _ = _run_both(paths, enc, variables, t_enc, protos,
                                    CHARS)
    for i, p in enumerate(paths):
        assert tres[p] == jres[p], (i, tres[p], jres[p])
        if i < 2:
            assert tres[p] == TEXTS[i], (i, tres[p])


def test_char_crops_over_a_zstd_page_match_jax(tmp_path):
    img_dir = tmp_path / "img"
    img_dir.mkdir()
    tex = mi.textured(np.random.default_rng(21), H, W)
    p = _write(img_dir, "page", mi.tiff_layout(
        tex, photometric=2, compression=50000, predictor=2, tile=(16, 16)))
    coco = _coco(p)
    crops = {k: str(tmp_path / k) for k in ("jax", "port")}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        n = j_coco.extract_char_crops(coco, str(img_dir), crops["jax"])
    assert t_coco.extract_char_crops(coco, str(img_dir), crops["port"]) \
        == n == 5
    names = sorted(os.listdir(crops["jax"]))
    assert names == sorted(os.listdir(crops["port"]))
    for f in names:
        assert_same_view(pillow_view(os.path.join(crops["port"], f)),
                         pillow_view(os.path.join(crops["jax"], f)), f)


# ------------------------------------------------------------ fixtures
def test_compression_fixtures_equal_golden_and_pillow():
    golden = np.load(os.path.join(mi.OUT, "golden.npz"))
    for name in mi.COMPRESSION_FILES:
        p = os.path.join(mi.OUT, name)
        got = {"rgb": image_io.read_rgb(p), "l": image_io.read_l(p),
               "lazy_gray": t_infer._LazyImage(p, gray=True).load(),
               "lazy_rgb": t_infer._LazyImage(p, gray=False).load()}
        for kind, a in got.items():
            assert tuple(golden[f"{name}|{kind}|shape"]) == a.shape, name
            np.testing.assert_array_equal(mi.digest(a),
                                          golden[f"{name}|{kind}|sha256"],
                                          err_msg=f"{name} {kind}")
        if not name.startswith("page/"):
            assert os.path.getsize(p) < 20000, name
