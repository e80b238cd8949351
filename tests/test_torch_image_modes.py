"""Every image mode through the port's dataset tools (data/imaging.py,
data/png.py's writer, data/coco.py ``extract_char_crops``, data/fonts.py
``paired_chars``) against Pillow and the JAX package, on the CPU.

Each case is one file of a mode in a format the port's decoders read:
PNG at every bit depth and colour type, with and without ``tRNS``; TIFF
1 (uncompressed and group 4), L, P, LA, I;16 in both byte orders, RGB,
RGBA and CMYK; BMP 1, P and L; GIF P (with and without a transparent
index) and L; JPEG L, RGB and CMYK.  For each:

- ``open_image`` holds what ``Image.open`` holds: mode, samples, palette
  and ``info["transparency"]``;
- the JAX ``extract_char_crops`` and the port's, on one COCO, write crops
  that reopen in Pillow with the same mode, samples, palette and
  transparency (CMYK raises ``OSError`` in both, and leaves no file);
- ``paired_chars`` over those crops, plain and ``square`` (Pillow's
  ``Image.resize((224, 224))`` mode by mode), gives the same files;
- ``resize_picture`` equals ``Image.resize`` in every mode, I;16B and
  CMYK included, which no crop reaches (crops reopen as I;16; CMYK
  cannot be saved as PNG).

Then one ``format-dataset`` CLI run per committed page fixture
(tests/torch_fixtures/mode_pages/, written by make_images.py
``--mode_pages``) against the JAX run's tree digest.

Tolerance: none (exact equality) throughout.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from effocr_tpu.data import coco as j_coco
from effocr_tpu.data import fonts as j_fonts
from effocr_torch.data import coco as t_coco
from effocr_torch.data import fonts as t_fonts
from effocr_torch.data import imaging, png
from torch_fixtures import make_images as mi

H, W = 23, 41


# ------------------------------------------------------------ files
def _png_bytes(samples: np.ndarray, depth: int, ct: int, palette=None,
               trns: bytes = None) -> bytes:
    """A PNG written here, independent of the port's writer: samples
    [h, w, spp] at ``depth`` bits, filter None on every row."""
    h, w, spp = samples.shape
    if depth == 16:
        body = samples.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth == 8:
        body = samples.astype(np.uint8).reshape(h, -1)
    else:
        per = 8 // depth
        v = samples.reshape(h, -1).astype(np.uint8)
        v = np.concatenate([v, np.zeros((h, -v.shape[1] % per), np.uint8)],
                           1).reshape(h, -1, per)
        sh = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        body = np.bitwise_or.reduce(v << sh, axis=2).astype(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), body], 1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ct, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _tex(rng, spp=1, hi=256, dtype=np.uint8):
    """Text-like samples: a light ground with dark strokes."""
    base = mi.textured(rng, H, W)[..., 0].astype(np.int64)
    out = np.stack([np.roll(base, 3 * i, axis=1) for i in range(spp)], -1)
    return (out * (hi - 1) // 255).astype(dtype)


def _pal(rng, n):
    return rng.integers(0, 256, (n, 3)).astype(np.uint8)


def _idx(rng, n):
    return rng.integers(0, n, (H, W, 1)).astype(np.uint8)


def _png_case(name, rng):
    gray = {1: 1, 2: 3, 4: 15, 8: 255, 16: 65535}
    kind, *rest = name.split("_")[1:]
    trns = "trns" in rest
    if kind.startswith("g"):
        d = int(kind[1:])
        s = _tex(rng, 1, gray[d] + 1, np.uint16 if d == 16 else np.uint8)
        return _png_bytes(s, d, 0, trns=struct.pack(">H", gray[d] // 3)
                          if trns else None)
    if kind.startswith("rgba"):
        d = int(kind[4:])
        return _png_bytes(_tex(rng, 4, 1 << d, np.uint16 if d == 16
                               else np.uint8), d, 6)
    if kind.startswith("rgb"):
        d = int(kind[3:])
        return _png_bytes(_tex(rng, 3, 1 << d, np.uint16 if d == 16
                               else np.uint8), d, 2,
                          trns=struct.pack(">HHH", 7, 300, 9) if trns
                          else None)
    if kind.startswith("la"):
        d = int(kind[2:])
        return _png_bytes(_tex(rng, 2, 1 << d, np.uint16 if d == 16
                               else np.uint8), d, 4)
    # p<depth>x<colours>[_trns | _alpha]
    d, n = (int(v) for v in kind[1:].split("x"))
    t = None
    if trns:
        t = b"\xff" * (n // 2) + b"\0" + b"\xff" * (n - n // 2 - 1)
    elif "alpha" in rest:
        t = bytes(rng.integers(0, 256, max(1, n - 1)).astype(np.uint8))
    return _png_bytes(_idx(rng, n), d, 3, palette=_pal(rng, n), trns=t)


PNG_CASES = [
    "png_g1", "png_g1_trns", "png_g2", "png_g2_trns", "png_g4", "png_g8",
    "png_g8_trns", "png_g16", "png_g16_trns", "png_rgb8", "png_rgb8_trns",
    "png_rgb16", "png_rgb16_trns", "png_p1x2", "png_p2x3", "png_p2x3_trns",
    "png_p4x11", "png_p4x11_alpha", "png_p8x200", "png_p8x200_trns",
    "png_p8x17_alpha", "png_la8", "png_la16", "png_rgba8", "png_rgba16",
]


def _tiff_case(name, rng):
    mode = name.split("_", 1)[1]
    if mode in ("I16", "I16B"):
        v = _tex(rng, 1, 1 << 16, np.uint16)[..., 0]
        return mi.tiff_gray(v, ">" if mode == "I16B" else "<", bits=16)
    if mode == "1_g4":
        im = Image.fromarray(_tex(rng)[..., 0]).convert("1")
        return ("TIFF", im, {"compression": "group4"})
    src = Image.fromarray(_tex(rng)[..., 0])
    im = {"1": lambda: src.convert("1"), "P": lambda: src.convert(
        "RGB").quantize(40)}.get(mode, lambda: src.convert(mode))()
    if mode == "LA":
        im = Image.merge("LA", (src, Image.fromarray(_tex(rng)[..., 0][
            :, ::-1].copy())))
    if mode == "RGBA":
        im = Image.merge("RGBA", src.convert("RGB").split() + (
            Image.fromarray(_tex(rng)[..., 0][::-1].copy()),))
    return ("TIFF", im, {"compression": "tiff_lzw"})


TIFF_CASES = ["tiff_1", "tiff_1_g4", "tiff_L", "tiff_P", "tiff_LA",
              "tiff_I16", "tiff_I16B", "tiff_RGB", "tiff_RGBA", "tiff_CMYK"]


def _bmp_case(name, rng):
    kind = name.split("_", 1)[1]
    if kind == "1":
        im = Image.fromarray(_tex(rng)[..., 0]).convert("1")
        return ("BMP", im, {})
    if kind == "L":
        return ("BMP", Image.fromarray(_tex(rng)[..., 0]), {})
    bits, n = {"P1": (1, 2), "P4": (4, 13), "P8": (8, 150)}[kind]
    idx = _idx(rng, n)[..., 0]
    pal = _pal(rng, n)
    entries = b"".join(bytes([b, g, r, 0]) for r, g, b in pal)
    return mi.bmp_bytes(W, H, bits, mi.bmp_rows(idx, bits), palette=entries,
                        colors=n if bits == 8 else 0)


BMP_CASES = ["bmp_1", "bmp_L", "bmp_P1", "bmp_P4", "bmp_P8"]


def _gif_case(name, rng):
    kind = name.split("_", 1)[1]
    if kind == "L":
        ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        return mi.gif_bytes((W, H), _tex(rng)[..., 0], global_pal=ramp)
    pal = _pal(rng, 16)
    return mi.gif_bytes((W, H), _idx(rng, 16)[..., 0], global_pal=pal,
                        transparency=5 if kind == "P_trns" else None)


GIF_CASES = ["gif_L", "gif_P", "gif_P_trns"]


def _jpeg_case(name, rng):
    mode = name.split("_", 1)[1]
    return ("JPEG", Image.fromarray(_tex(rng, 3)).convert(mode),
            {"quality": 90})


JPEG_CASES = ["jpeg_L", "jpeg_RGB", "jpeg_CMYK"]

CASES = PNG_CASES + TIFF_CASES + BMP_CASES + GIF_CASES + JPEG_CASES
CMYK = ("tiff_CMYK", "jpeg_CMYK")
EXT = {"png": ".png", "tiff": ".tif", "bmp": ".bmp", "gif": ".gif",
       "jpeg": ".jpg"}


def make_case(name: str, d) -> str:
    """The case's file in ``d`` (seeded by its name)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    fmt = name.split("_")[0]
    made = {"png": _png_case, "tiff": _tiff_case, "bmp": _bmp_case,
            "gif": _gif_case, "jpeg": _jpeg_case}[fmt](name, rng)
    os.makedirs(str(d), exist_ok=True)
    path = os.path.join(str(d), name + EXT[fmt])
    if isinstance(made, tuple):
        f, im, kw = made
        im.save(path, f, **kw)
    else:
        with open(path, "wb") as fh:
            fh.write(made)
    return path


# ------------------------------------------------------------ Pillow
def pillow_view(path: str):
    """(mode, samples, palette [n, 3] or None, transparency) of
    ``Image.open(path)``, samples as the port holds them (1 as 0 / 255,
    16-bit as their values)."""
    with Image.open(path) as im:
        im.load()
        px = np.asarray(im)
        if im.mode == "1":
            px = px.astype(np.uint8) * np.uint8(255)
        elif px.dtype.kind == "u" and px.dtype.itemsize == 2:
            px = px.astype(np.uint16)
        pal = None
        if im.mode == "P":
            pal = np.array(im.getpalette(), np.uint8).reshape(-1, 3)
        return im.mode, px, pal, im.info.get("transparency")


def assert_same_view(a, b, what):
    assert a[0] == b[0], (what, a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1], err_msg=str(what))
    assert a[1].dtype == b[1].dtype, (what, a[1].dtype, b[1].dtype)
    if a[2] is None or b[2] is None:
        assert a[2] is None and b[2] is None, what
    else:
        np.testing.assert_array_equal(a[2], b[2], err_msg=f"{what} palette")
    assert a[3] == b[3], (what, a[3], b[3])


def _coco(name: str) -> dict:
    """Five char boxes over the case's image, float corners, the last one
    past the right edge."""
    boxes = [[1.4, 2.0, 7.2, 17.5], [8.6, 0.0, 8.0, 23.0],
             [17.5, 3.5, 6.49, 12.0], [24.0, 1.0, 9.5, 20.6],
             [33.2, 4.0, 12.0, 16.0]]
    return {
        "images": [{"id": 1, "file_name": os.path.basename(name),
                    "width": W, "height": H, "text": "aQ7&,"}],
        "annotations": [{"id": 10 + i, "image_id": 1, "category_id": 0,
                         "bbox": b} for i, b in enumerate(boxes)],
    }


def _tree(d):
    return sorted(os.path.relpath(os.path.join(dp, f), d)
                  for dp, _, fs in os.walk(d) for f in fs)


# ------------------------------------------------------------ tests
@pytest.mark.parametrize("case", CASES)
def test_open_image_holds_what_pillow_opens(case, tmp_path):
    path = make_case(case, tmp_path)
    got = imaging.open_image(path)
    assert_same_view((got.mode, got.px, got.palette, got.transparency),
                     pillow_view(path), case)


@pytest.mark.parametrize("case", CASES)
def test_crops_and_paired_chars_match_jax(case, tmp_path):
    path = make_case(case, tmp_path / "img")
    coco = _coco(path)
    img_dir = os.path.dirname(path)
    crops = {k: str(tmp_path / k / "crops") for k in ("jax", "port")}
    if case in CMYK:
        for k, fn in (("jax", j_coco.extract_char_crops),
                      ("port", t_coco.extract_char_crops)):
            with pytest.raises(OSError, match="cannot write mode CMYK"):
                fn(coco, img_dir, crops[k])
        assert _tree(crops["jax"]) == _tree(crops["port"]) == []
        return
    n = j_coco.extract_char_crops(coco, img_dir, crops["jax"])
    assert t_coco.extract_char_crops(coco, img_dir, crops["port"]) == n == 5
    names = _tree(crops["jax"])
    assert names == _tree(crops["port"])
    for f in names:
        assert_same_view(pillow_view(os.path.join(crops["port"], f)),
                         pillow_view(os.path.join(crops["jax"], f)),
                         (case, f))
    for square in (False, True):
        trees = {}
        for k, fn in (("jax", j_fonts.paired_chars),
                      ("port", t_fonts.paired_chars)):
            trees[k] = str(tmp_path / k / f"tree{int(square)}")
            assert fn([crops["jax"]], trees[k], square=square) == n
        names = _tree(trees["jax"])
        assert names == _tree(trees["port"]) and len(names) == n
        for f in names:
            assert_same_view(pillow_view(os.path.join(trees["port"], f)),
                             pillow_view(os.path.join(trees["jax"], f)),
                             (case, square, f))


def _pillow_image(px, mode):
    """A Pillow image holding ``px`` in ``mode`` (16-bit from raw bytes in
    the mode's byte order, so every sample is kept)."""
    if mode in ("I;16", "I;16B"):
        order = ">u2" if mode == "I;16B" else "<u2"
        return Image.frombytes(mode, px.shape[::-1],
                               px.astype(order).tobytes())
    if mode == "1":
        return Image.fromarray(px > 127).convert("1")
    return Image.fromarray(px, mode)


@pytest.mark.parametrize("size", [(224, 224), (5, 9), (13, 31)])
@pytest.mark.parametrize("mode", ["1", "L", "P", "LA", "RGB", "RGBA",
                                  "I;16", "I;16B", "CMYK"])
def test_resize_picture_is_pillows_resize(mode, size):
    """``resize_picture`` against ``Image.resize(size)`` for every mode,
    from 13 x 31 up and down (and to its own size), on seeded samples
    with transparent, opaque and partial alpha."""
    rng = np.random.default_rng(len(mode) * 7 + size[0])
    c = {"LA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}.get(mode, 1)
    if mode in ("I;16", "I;16B"):
        px = rng.integers(0, 65536, (31, 13)).astype(np.uint16)
    else:
        px = rng.integers(0, 256, (31, 13, c)).astype(np.uint8)
        if mode in ("LA", "RGBA"):
            px[..., -1] = rng.choice([0, 255, 7, 128, 200], (31, 13))
        px = px[..., 0] if c == 1 else px
        if mode == "1":
            px = np.where(px > 127, 255, 0).astype(np.uint8)
    im = _pillow_image(px, mode)
    pal = None
    if mode == "P":
        pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
        im.putpalette(pal.tobytes())
    want = np.asarray(im.resize(size))
    if mode == "1":
        want = want.astype(np.uint8) * np.uint8(255)
    got = imaging.resize_picture(imaging.Picture(px, mode, pal), size)
    np.testing.assert_array_equal(got.px, want.astype(got.px.dtype))
    assert got.mode == mode and got.palette is pal


@pytest.mark.parametrize("mode,shape,dtype", [
    ("L", (5, 7), np.uint8), ("RGB", (5, 7, 3), np.uint8),
    ("RGBA", (5, 7, 4), np.uint8)])
def test_digest_of_l_rgb_rgba_is_unchanged(mode, shape, dtype):
    """The committed golden.npz digests hash (mode, shape, uint8 bytes):
    L, RGB and RGBA without transparency keep that value."""
    import hashlib

    px = np.random.default_rng(3).integers(0, 256, shape).astype(dtype)
    h = hashlib.sha256(mode.encode())
    h.update(repr(tuple(px.shape)).encode())
    h.update(px.tobytes())
    assert imaging.digest_image(px, mode) == h.hexdigest()


def test_digest_tells_palette_transparency_and_depth_apart():
    px = np.zeros((3, 4), np.uint8)
    pal = np.arange(6, dtype=np.uint8).reshape(2, 3)
    base = imaging.digest_image(px, "P", pal)
    assert base != imaging.digest_image(px, "P", pal[::-1])
    assert base != imaging.digest_image(px, "P", pal, 0)
    assert imaging.digest_image(px, "L") != imaging.digest_image(px, "L",
                                                                 None, 0)
    v = np.full((3, 4), 300, np.uint16)
    assert imaging.digest_image(v, "I;16") != imaging.digest_image(
        np.minimum(v, 255).astype(np.uint8), "I;16")


@pytest.mark.parametrize("mode", ["CMYK", "I", "F", "YCbCr"])
def test_png_writer_refuses_what_pillow_refuses(mode, tmp_path):
    if mode == "I":
        # Pillow 12.1 writes I as 16-bit gray (PngImagePlugin's I;16B
        # rawmode clips to 0-65535; deprecated, not refused)
        v = np.array([[-5, 0, 255, 65535, 70000]], np.int32)
        p = imaging.save_image(str(tmp_path / "x.png"), v, mode)
        want = str(tmp_path / "want.png")
        with pytest.warns(DeprecationWarning):
            Image.fromarray(v, "I").save(want)
        got = pillow_view(p)
        assert_same_view(got, pillow_view(want), mode)
        assert got[1].tolist() == [[0, 0, 255, 65535, 65535]]
        return
    px = np.zeros((2, 2, 4) if mode == "CMYK" else (2, 2), np.uint8)
    with pytest.raises(OSError, match=f"cannot write mode {mode} as PNG"):
        imaging.save_image(str(tmp_path / "x.png"), px, mode)
    assert not os.listdir(tmp_path)


def test_two_colour_palette_writes_at_one_bit(tmp_path):
    p = imaging.save_image(str(tmp_path / "p.png"),
                           np.eye(4, dtype=np.uint8), "P",
                           np.array([[0, 0, 0], [255, 0, 0]], np.uint8), 1)
    assert png.png_header(p)[2:4] == (3, 1)
    assert pillow_view(p)[3] == 1


# ------------------------------------------------------- page fixtures
PAGES = mi.MODE_PAGES_DIR


@pytest.mark.parametrize("page", mi.MODE_PAGES)
def test_format_dataset_over_page_fixture_matches_jax(page, tmp_path):
    """``python -m effocr_torch format-dataset --spaces
    --clip_to_top_and_bottom`` over a committed page fixture (rendered en
    lines in one mode) gives the JAX command's tree, by digest."""
    from effocr_torch.cli import format_dataset

    golden = np.load(os.path.join(PAGES, "golden.npz"))
    argv = mi.mode_page_argv(page, str(tmp_path))
    format_dataset.main(argv)
    assert imaging.digest_tree(str(tmp_path / "tree")) == str(
        golden[f"{page}|tree"])
    assert imaging.digest_tree(str(tmp_path / "crops")) == str(
        golden[f"{page}|crops"])
    with open(os.path.join(PAGES, page, "coco.json")) as f:
        n_chars = sum(len(im["text"].replace(" ", ""))
                      for im in json.load(f)["images"])
    assert len(os.listdir(tmp_path / "crops")) == n_chars
