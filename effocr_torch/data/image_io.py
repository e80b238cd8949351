"""Image files in, as Pillow 12 reads them: one dispatch by magic bytes.

PNG goes through data/png.py (and its native decoder), JPEG through
data/jpeg.py (native, and one threaded native batch for many files),
TIFF, BMP and GIF through their modules.  WebP and anything else raise
``NotImplementedError`` naming the format (``png.not_png_error``).

- ``header(path)`` -> (h, w, mode), the size and mode ``Image.open``
  reports, without decoding (``describe``: the format too);
- ``read_rgb(path)`` = ``np.asarray(Image.open(path).convert("RGB"))``;
- ``read_l(path)`` = ``np.asarray(Image.open(path).convert("L"))``;
- ``load(path, channels)``: the JAX package's channel rule for one
  inference line.  PNG keeps data/png.py's rule; any other file gives
  its ``L`` pixels when ``channels`` is 1 and its mode is ``L``, else
  its RGB conversion (reduced by the truncating channel mean when
  ``channels`` is 1);
- ``read(paths, channels)``: ``load`` over a batch, PNGs through
  ``png.read`` and JPEGs through one native batch (``channels`` 1 of an
  RGB JPEG is the truncating channel mean, taken in the decoder).

Mode conversions are Pillow's: ``1`` is 0 / 255; ``P`` and ``PA``
read their palette (a 1 / 2 / 4-bit TIFF's has 2^bits entries; entries
the file does not give are black) and convert to L by the palette's
luma; ``I;16``, ``I`` and ``F`` clip to 0-255 (F truncated, NaN 0);
``LA`` and ``RGBA`` drop alpha; ``CMYK`` -> RGB is ``Convert.c
cmyk2rgb`` and CMYK -> L goes through it; ``LAB`` -> RGB is ImageCms's
Little CMS transform (data/lab.py) and LAB -> L raises Pillow's
ValueError; RGB -> L is ``png.to_l``.  The TIFF reader hands over 2 / 4-bit gray already scaled
to ``L``, 16-bit RGB / RGBA as each sample's high byte, and pixels
after the file's orientation (whose ``header`` size is the transposed
one for orientations 5-8, as ``Image.open`` reports it).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from effocr_torch.data import bmp, gif, jpeg, lab, png, tiff
from effocr_torch.native import imgdec

# bytes read for a header first (the whole file when the header lies past
# them: a TIFF's IFD at its end, a JPEG's large EXIF or ICC segment)
HEAD_BYTES = 1 << 12


def sniff(head: bytes) -> str:
    """The format of a file from its first bytes: PNG, JPEG, TIFF, BMP or
    GIF; None for anything else."""
    if head.startswith(png.PNG_MAGIC):
        return "PNG"
    if head.startswith(jpeg.MAGIC):
        return "JPEG"
    if head[:4] in tiff.MAGICS or head[:4] in tiff.BIGTIFF_MAGICS:
        return "TIFF"
    if head.startswith(bmp.MAGIC):
        return "BMP"
    if head[:6] in gif.MAGICS:
        return "GIF"
    return None


def _read(path: str, limit: int = -1) -> bytes:
    with open(path, "rb") as f:
        return f.read(limit)


def _unknown(path: str, head: bytes) -> Exception:
    """The error for a file no reader of this module takes: the refusal
    naming its format, or, where its first bytes start like a format
    read here but are not that format's, a broken file."""
    err = png.not_png_error(path, head[:16])
    if isinstance(err, NotImplementedError):
        return err
    return OSError(f"{path}: a broken image file (first bytes "
                   f"{head[:8]!r})")


def _named(path: str, fmt: str, fn, *args):
    """Call a format module, the file's path on its errors."""
    try:
        return fn(*args)
    except NotImplementedError as e:
        raise NotImplementedError(f"{path}: {e}") from None
    except (OSError, ValueError, IndexError, KeyError, struct.error) as e:
        raise OSError(f"{path}: {fmt} file: {e}") from None


def describe(path: str, head: Optional[bytes] = None
             ) -> Tuple[str, int, int, str]:
    """(format, h, w, Pillow's mode) of an image file, without
    decoding.  ``head``: its first ``HEAD_BYTES`` (or all of it, when
    shorter), when the caller has read them: one open a file matters on
    hosts where opening is slow."""
    if head is None:
        head = _read(path, HEAD_BYTES)
    fmt = sniff(head)
    if fmt is None:
        raise _unknown(path, head)
    if fmt == "PNG":
        hdr = png.png_header(path, head)
        if hdr is None:
            raise OSError(f"{path}: PNG file: no IHDR")
        h, w, ct, depth, _ = hdr
        return fmt, h, w, png.pillow_mode(ct, depth)
    fn = {"JPEG": jpeg.jpeg_header, "TIFF": tiff.tiff_header,
          "BMP": bmp.bmp_header, "GIF": gif.gif_header}[fmt]
    try:
        return (fmt,) + _named(path, fmt, fn, head)
    except OSError:
        if len(head) < HEAD_BYTES:
            raise
        return (fmt,) + _named(path, fmt, fn, _read(path))


def header(path: str) -> Tuple[int, int, str]:
    """(h, w, Pillow's mode) of an image file, without decoding."""
    return describe(path)[1:]


def decode(path: str, data: Optional[bytes] = None
           ) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """(pixels, mode, palette) of a file other than PNG; see each
    module's ``decode``."""
    if data is None:
        data = _read(path)
    fmt = sniff(data[:16])
    if fmt is None or fmt == "PNG":
        raise _unknown(path, data)
    if fmt == "JPEG":
        px, mode = _named(path, fmt, jpeg.decode, data, path)
        return px, mode, None
    mod = {"TIFF": tiff, "BMP": bmp, "GIF": gif}[fmt]
    return _named(path, fmt, mod.decode, data)


def full_palette(palette: np.ndarray) -> np.ndarray:
    """A palette of n entries as [256, 3]: the entries a file does not
    give read black, as in Pillow."""
    full = np.zeros((256, 3), np.uint8)
    full[:min(len(palette), 256)] = palette[:256]
    return full


def _gray8(px: np.ndarray, mode: str) -> np.ndarray:
    """I, I;16(B) or F samples -> L, as Convert.c's i2l / I16_L / f2l: 0
    at or below 0 (and NaN), 255 at or above 255, else truncated."""
    if mode == "F":
        out = np.zeros(px.shape, np.uint8)
        out[px >= 255] = 255
        mid = (px > 0) & (px < 255)
        out[mid] = px[mid].astype(np.uint8)
        return out
    return np.clip(px, 0, 255).astype(np.uint8)


def to_rgb(px: np.ndarray, mode: str, palette: Optional[np.ndarray]
           ) -> np.ndarray:
    """Pixels of a mode -> uint8 [H, W, 3], Pillow's ``convert("RGB")``."""
    if mode in ("P", "PA"):
        return full_palette(palette)[px if mode == "P" else px[..., 0]]
    if mode in ("1", "L"):
        return np.repeat(px[..., None], 3, axis=-1)
    if mode in ("I;16", "I;16B", "I", "F"):
        return np.repeat(_gray8(px, mode)[..., None], 3, axis=-1)
    if mode == "LA":
        return np.repeat(px[..., :1], 3, axis=-1)
    if mode == "LAB":
        return lab.lab_to_rgb(px)
    if mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(px[..., :3])
    if mode == "CMYK":
        c = px.astype(np.int32)
        nk = 255 - c[..., 3:]
        t = c[..., :3] * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    raise ValueError(f"mode {mode}")


def to_l(px: np.ndarray, mode: str, palette: Optional[np.ndarray]
         ) -> np.ndarray:
    """Pixels of a mode -> uint8 [H, W], Pillow's ``convert("L")``."""
    if mode in ("1", "L"):
        return px
    if mode in ("I;16", "I;16B", "I", "F"):
        return _gray8(px, mode)
    if mode == "LA":
        return np.ascontiguousarray(px[..., 0])
    if mode in ("P", "PA"):
        return png.to_l(full_palette(palette))[px if mode == "P"
                                               else px[..., 0]]
    if mode == "LAB":
        # Image.convert tries LAB -> L, then LAB's base mode, RGB, in C,
        # which has no LAB conversion (ImageCms does LAB -> RGB only)
        raise ValueError("conversion from LAB to RGB not supported")
    return png.to_l(to_rgb(px, mode, palette))


def read_rgb(path: str) -> np.ndarray:
    """uint8 [H, W, 3]: ``Image.open(path).convert("RGB")``."""
    if _read(path, 8).startswith(png.PNG_MAGIC):
        return png.read_png(path, 3)
    return to_rgb(*decode(path))


def read_l(path: str) -> np.ndarray:
    """uint8 [H, W]: ``Image.open(path).convert("L")``."""
    if _read(path, 8).startswith(png.PNG_MAGIC):
        return png.read_png_l(path)
    return to_l(*decode(path))


def load(path: str, channels: int = 3) -> np.ndarray:
    """uint8 [H, W, channels] of one file under the JAX package's channel
    rule (see the module docstring)."""
    data = _read(path)
    if data.startswith(png.PNG_MAGIC):
        return png.read_png(path, channels, data=data)
    px, mode, palette = decode(path, data)
    if channels == 1 and mode == "L":
        return px[..., None]
    rgb = to_rgb(px, mode, palette)
    if channels == 1:
        return (rgb.astype(np.uint16).sum(-1, keepdims=True) // 3).astype(
            np.uint8)
    return rgb


def read(paths: Sequence[str], channels: Sequence[int],
         num_threads: int = 8,
         described: Optional[Sequence[Tuple[str, int, int, str]]] = None
         ) -> List[np.ndarray]:
    """``load`` of each path: PNGs in one ``png.read`` call, L and RGB
    JPEGs in one threaded native batch, the rest one by one.
    ``described``: each path's ``describe``, when the caller has it."""
    if described is None:
        described = [describe(p) for p in paths]
    out: List[Optional[np.ndarray]] = [None] * len(paths)
    pngs = [i for i, d in enumerate(described) if d[0] == "PNG"]
    if pngs:
        for i, arr in zip(pngs, png.read([paths[i] for i in pngs],
                                         [channels[i] for i in pngs])):
            out[i] = arr
    jpegs, shapes = [], []
    for i, (fmt, hh, ww, mode) in enumerate(described):
        if fmt == "JPEG" and mode != "CMYK":
            jpegs.append(i)
            shapes.append((hh, ww, channels[i]))
    if jpegs:
        for i, arr in zip(jpegs, imgdec.decode_jpeg_batch(
                [paths[i] for i in jpegs], shapes, num_threads)):
            out[i] = arr
    return [arr if arr is not None else load(p, ch)
            for arr, p, ch in zip(out, paths, channels)]
