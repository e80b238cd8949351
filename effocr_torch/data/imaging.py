"""Pillow's image operations, on numpy arrays ("L" = uint8 [H, W],
"RGB" = uint8 [H, W, 3]), with Pillow 12.1's pixels (no torch import, so
the glyph tools' processes start fast):

- ``pil_resize`` (``pil_bilinear_resize``, ``pil_bicubic_resize``):
  libImaging/Resample.c's fixed-point passes, the readers' resizes;
- ``resize(img, (w, h), "lanczos" | "bicubic")``: libImaging/Resample.c
  (``Image.LANCZOS``, and ``Image.resize``'s default bicubic);
- ``gaussian_blur``: ``ImageFilter.GaussianBlur``, Pillow's extended box
  blur (native/glyph.cpp, for C's float arithmetic);
- ``invert``: ``ImageOps.invert``;
- ``getbbox``: ``Image.getbbox`` (any band non-zero);
- ``crop``: ``Image.crop`` with a float box (Python's ``round``, black
  outside the image);
- ``open_image`` / ``save_image`` / ``copy_image``: ``Image.open`` (a
  ``Picture``: pixels, mode, palette and ``info["transparency"]``) of
  any file the port decodes, in any of its modes (1, L, P, LA, RGB,
  RGBA, I;16, I;16B, CMYK), and ``Image.save`` of it as PNG through
  data/png.py (pixels, modes, palettes and transparency are Pillow's;
  the bytes are not; CMYK raises Pillow's ``OSError``);
- ``resize_picture``: ``Image.resize(size)`` with its default filter,
  mode by mode (NEAREST for 1 and P, BICUBIC through premultiplied alpha
  for LA and RGBA, 16-bit BICUBIC for I;16, 8-bit BICUBIC otherwise);
- ``digest_image`` / ``digest_tree``: SHA-256 of an image's mode,
  samples, palette and transparency, and of a directory.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

from effocr_torch.data import gif, image_io, png

# Pillow's fixed-point resampling precision (libImaging/Resample.c)
_PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's cubic convolution, a = -0.5."""
    a, x = -0.5, np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


@np.vectorize
def _lanczos(x: float) -> float:
    """Pillow's lanczos_filter (support 3), with C's sin (math.sin), not
    numpy's."""
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


# Pillow's filters: (kernel, support) by name
_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0),
            "lanczos": (_lanczos, 3.0)}


@functools.lru_cache(maxsize=64)
def _pil_kernel(in_size: int, out_size: int, kind: str = "bilinear"
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's resample weights along one axis (libImaging/Resample.c
    precompute_coeffs): output xx reads inputs ``start[xx] + j`` with
    float64 weight ``k[xx, j]``, j < ksize (0 past the window).  The
    filter is widened by the scale on a downscale, and each output's
    weights are summed in input order and normalised."""
    kernel, support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ss = 1.0 / filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; the clamp at 0 makes it a floor
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(
        np.int64)
    x = xmin[:, None] + np.arange(ksize)
    k = np.where(x < xmax[:, None],
                 kernel((x - center[:, None] + 0.5) * ss), 0.0)
    total = k[:, 0].copy()
    for j in range(1, ksize):           # Pillow's order: ww += w
        total += k[:, j]
    k = np.where(total[:, None] != 0.0,
                 k / np.where(total == 0.0, 1.0, total)[:, None], k)
    return xmin, k


@functools.lru_cache(maxsize=64)
def _pil_coeffs(in_size: int, out_size: int, kind: str = "bilinear"
                ) -> Tuple[np.ndarray, np.ndarray]:
    """``_pil_kernel``'s weights as normalize_coeffs_8bpc makes them:
    rounded half away from zero to 22-bit fixed point."""
    xmin, k = _pil_kernel(in_size, out_size, kind)
    w = k * (1 << _PRECISION_BITS)
    return xmin, np.where(w < 0, np.trunc(w - 0.5), np.trunc(w + 0.5))


def _pil_pass(x: np.ndarray, coeffs: Tuple[np.ndarray, np.ndarray],
              axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis`` of [H, W, C]: Pillow's 32-bit integer
    sums, rounded at half and clipped to uint8, as Pillow does between
    and after its passes."""
    start, weights = coeffs
    src = np.ascontiguousarray(np.moveaxis(x, axis, 0), dtype=np.int32)
    last = src.shape[0] - 1
    shape = (-1,) + (1,) * (src.ndim - 1)
    acc = np.full((len(start),) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int32)
    for j in range(weights.shape[1]):
        acc += src[np.minimum(start + j, last)] * weights[:, j].astype(
            np.int32).reshape(shape)
    acc = np.moveaxis(acc >> _PRECISION_BITS, 0, axis)
    return np.clip(acc, 0, 255).astype(np.uint8)


def _pil_pass16(x: np.ndarray, kernel: Tuple[np.ndarray, np.ndarray],
                axis: int) -> np.ndarray:
    """One 16-bit pass along ``axis`` of uint16 [H, W]
    (ImagingResample{Horizontal,Vertical}_16bpc): float64 sums in input
    order, rounded half away from zero (ROUND_UP), then stored as
    ``CLIP8(v % 256)`` low and ``CLIP8(v >> 8)`` high byte."""
    start, k = kernel
    src = np.moveaxis(x, axis, 0).astype(np.float64)
    last = src.shape[0] - 1
    acc = np.zeros((len(start),) + src.shape[1:], np.float64)
    for j in range(k.shape[1]):
        acc += src[np.minimum(start + j, last)] * k[:, j:j + 1]
    v = np.where(acc >= 0, acc + 0.5, acc - 0.5).astype(np.int64)
    lo = np.where(v < 0, 0, v & 255)
    hi = np.clip(v >> 8, 0, 255)
    return np.moveaxis((hi << 8 | lo).astype(np.uint16), 0, axis)


def _nearest_rows(n_in: int, n_out: int) -> np.ndarray:
    """ImagingScaleAffine's source index of each output row or column
    (-1: none): the position steps by n_in / n_out from half a step, in
    float64 added step by step, truncated."""
    a = n_in / n_out
    pos = a * 0.5
    out = np.empty(n_out, np.int64)
    for i in range(n_out):
        v = -1 if pos < 0.0 else int(pos)
        out[i] = v if v < n_in else -1
        pos += a
    return out


def _nearest(px: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``Image.resize(..., NEAREST)`` (ImagingScaleAffine, filling with 0
    where no source pixel maps)."""
    h, w = px.shape[:2]
    xs, ys = _nearest_rows(w, out_w), _nearest_rows(h, out_h)
    out = px[np.maximum(ys, 0)][:, np.maximum(xs, 0)]
    out[ys < 0] = 0
    out[:, xs < 0] = 0
    return out


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.uint32) * b.astype(np.uint32) + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def _premultiply(px: np.ndarray) -> np.ndarray:
    """LA -> La / RGBA -> RGBa (Convert.c lA2la, rgbA2rgba)."""
    a = px[..., -1:]
    return np.concatenate([_muldiv255(px[..., :-1], a), a], axis=-1)


def _unpremultiply(px: np.ndarray) -> np.ndarray:
    """La -> LA / RGBa -> RGBA (Convert.c la2lA, rgba2rgbA): each colour
    255 * c / alpha, truncated and clipped, where alpha is neither 0 nor
    255."""
    a = px[..., -1:].astype(np.uint32)
    c = px[..., :-1].astype(np.uint32)
    div = np.minimum(255 * c // np.maximum(a, 1), 255)
    keep = (a == 0) | (a == 255)
    return np.concatenate([np.where(keep, c, div).astype(np.uint8),
                           px[..., -1:]], axis=-1)


def pil_resize(img: np.ndarray, out_w: int, out_h: int,
               kind: str = "bilinear") -> np.ndarray:
    """uint8 [H, W, C] -> [out_h, out_w, C], bit for bit
    ``Image.fromarray(img).resize((out_w, out_h), Image.BILINEAR)`` (or
    ``BICUBIC``): horizontal pass first, then vertical, each only when
    its size changes, clipped to uint8 between and after them."""
    h, w = img.shape[:2]
    if w != out_w:
        img = _pil_pass(img, _pil_coeffs(w, out_w, kind), 1)
    if h != out_h:
        img = _pil_pass(img, _pil_coeffs(h, out_h, kind), 0)
    return img


def pil_bilinear_resize(img: np.ndarray, out_w: int, out_h: int
                        ) -> np.ndarray:
    """``Image.resize(..., BILINEAR)`` (``pil_resize``)."""
    return pil_resize(img, out_w, out_h, "bilinear")


def pil_bicubic_resize(img: np.ndarray, out_w: int, out_h: int
                       ) -> np.ndarray:
    """``Image.resize(..., BICUBIC)``, the default filter of
    ``Image.resize`` (``pil_resize``)."""
    return pil_resize(img, out_w, out_h, "bicubic")



def resize(img: np.ndarray, size: Tuple[int, int], kind: str = "bicubic"
           ) -> np.ndarray:
    """``Image.resize(size, LANCZOS | BICUBIC)`` of an L or RGB array."""
    w, h = size
    if img.ndim == 2:
        return pil_resize(img[..., None], w, h, kind)[..., 0]
    return pil_resize(img, w, h, kind)


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    from effocr_torch.native import glyph

    if radius == 0:
        return img.copy()
    return glyph.gaussian_blur(img, radius)


def invert(img: np.ndarray) -> np.ndarray:
    return 255 - img


def getbbox(img: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    """(left, upper, right, lower) of the non-zero pixels, or None."""
    ink = img if img.ndim == 2 else img.any(axis=2)
    rows = np.flatnonzero(ink.any(axis=1))
    if len(rows) == 0:
        return None
    cols = np.flatnonzero(ink.any(axis=0))
    return int(cols[0]), int(rows[0]), int(cols[-1]) + 1, int(rows[-1]) + 1


def crop(img: np.ndarray, box: Sequence[float]) -> np.ndarray:
    """``Image.crop(box)``: the box rounded with Python's ``round``,
    pixels outside the image black."""
    x0, y0, x1, y1 = (int(round(v)) for v in box)
    h, w = img.shape[:2]
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)) + img.shape[2:],
                   img.dtype)
    sx0, sy0 = max(x0, 0), max(y0, 0)
    sx1, sy1 = min(x1, w), min(y1, h)
    if sx0 < sx1 and sy0 < sy1:
        out[sy0 - y0: sy1 - y0, sx0 - x0: sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out


class Picture(NamedTuple):
    """An image as ``Image.open`` holds it.  ``px``: uint8 [H, W] for 1
    (0 / 255), L and P (indices), uint8 [H, W, C] for LA, RGB, RGBA and
    CMYK, uint16 [H, W] for I;16 and I;16B (the sample values);
    ``palette``: [n, 3] uint8 of P (n entries, as Pillow keeps them);
    ``transparency``: Pillow's ``info["transparency"]`` (an int, an
    (r, g, b) tuple or P's alpha bytes), None without one."""
    px: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None
    transparency: Union[None, int, Tuple[int, ...], bytes] = None


def _png_picture(data: bytes) -> Picture:
    """PngImagePlugin's modes and rawmodes: gray below 8 bits scaled to
    0-255 (1 bit opens as mode 1), 16-bit gray kept whole (I;16), 16-bit
    colour and alpha cut to their high byte (gray + alpha at 16 bits opens
    as RGBA)."""
    px, hdr = png.decode(data)
    ct, depth = hdr["color_type"], hdr["bit_depth"]
    mode = png.pillow_mode(ct, depth)
    if ct in (0, 3):
        px = px[..., 0]
        if ct == 0 and depth < 8:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    elif depth == 16:
        px = (px >> 8).astype(np.uint8)
        if ct == 4:
            px = px[..., [0, 0, 0, 1]]
    return Picture(np.ascontiguousarray(px), mode,
                   hdr["palette"] if ct == 3 else None,
                   png.trns_info(hdr["trns"], mode))


def open_image(path: str) -> Picture:
    """``Image.open(path)``: pixels, mode, palette and transparency of a
    PNG, or of any file data/image_io.py decodes, in the mode Pillow
    opens it in."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(png.PNG_MAGIC):
        return _png_picture(data)
    px, mode, palette = image_io.decode(path, data)
    trans = gif.transparency(data) if image_io.sniff(data[:16]) == "GIF" \
        else None
    return Picture(np.ascontiguousarray(px), mode, palette, trans)


def save_image(path: str, img: np.ndarray, mode: Optional[str] = None,
               palette: Optional[np.ndarray] = None, transparency=None
               ) -> str:
    """``Image.save(path)`` as PNG: the same pixels, mode, palette and
    transparency (zlib level 1, for speed: the bytes are not Pillow's
    either way).  ``mode`` defaults to L, RGB or RGBA by the array's
    channels; ``save_image(path, *picture)`` saves a ``Picture``.  A mode
    PNG cannot hold (CMYK) raises ``OSError`` before the file is made."""
    return png.write(path, img, level=1, mode=mode, palette=palette,
                     transparency=transparency)


def copy_image(src: str, dst: str) -> str:
    """``Image.open(src).save(dst)`` of a PNG: a file Pillow would open in
    mode L, RGB or RGBA at 8 bits is copied as it is (the same pixels,
    mode and transparency); anything else is decoded and written."""
    import shutil

    with open(src, "rb") as f:
        head = f.read(33)
    if head.startswith(png.PNG_MAGIC) and len(head) == 33 and head[24] == 8 \
            and head[25] in (0, 2, 6):
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        shutil.copyfile(src, dst)
        return dst
    return save_image(dst, *open_image(src))


def resize_picture(pic: Picture, size: Tuple[int, int]) -> Picture:
    """``Image.resize(size)`` with Pillow 12.1's default filter, mode by
    mode: 1 and P with NEAREST (palette and transparency kept), LA and
    RGBA through La / RGBa (premultiplied alpha) with BICUBIC, I;16 with
    the 16-bit BICUBIC passes, every other mode with the 8-bit BICUBIC
    passes.  The same size is a copy."""
    w, h = size
    px, mode = pic.px, pic.mode
    if px.shape[1] == w and px.shape[0] == h:
        return pic._replace(px=px.copy())
    if mode in ("1", "P"):
        return pic._replace(px=_nearest(px, w, h))
    if mode in ("I;16", "I;16B"):
        # Resample.c reads I;16B's bytes as little-endian too
        v = px.byteswap() if mode == "I;16B" else px
        if v.shape[1] != w:
            v = _pil_pass16(v, _pil_kernel(v.shape[1], w, "bicubic"), 1)
        if v.shape[0] != h:
            v = _pil_pass16(v, _pil_kernel(v.shape[0], h, "bicubic"), 0)
        return pic._replace(px=v.byteswap() if mode == "I;16B" else v)
    if mode in ("LA", "RGBA"):
        out = _unpremultiply(pil_resize(_premultiply(px), w, h, "bicubic"))
        return pic._replace(px=out)
    return pic._replace(px=resize(px, size, "bicubic"))


def digest_image(px: np.ndarray, mode: str,
                 palette: Optional[np.ndarray] = None,
                 transparency=None) -> str:
    """SHA-256 of an image's mode, shape and samples at their own dtype
    (16-bit little-endian), then of its palette and transparency where
    it has them (PNG bytes may differ between writers; these may not).
    An L, RGB or RGBA image without transparency hashes as it always
    has."""
    import hashlib

    h = hashlib.sha256(mode.encode())
    h.update(repr(tuple(px.shape)).encode())
    dt = "<u2" if px.dtype == np.uint16 else np.uint8
    h.update(np.ascontiguousarray(px, dt).tobytes())
    if palette is not None:
        h.update(b"palette" + np.ascontiguousarray(palette, np.uint8)
                 .tobytes())
    if transparency is not None:
        h.update(b"transparency" + repr(transparency).encode())
    return h.hexdigest()


def digest_tree(root: str) -> str:
    """SHA-256 over a directory: every file's relative path, then for a
    PNG its ``digest_image`` (every mode), for anything else its bytes."""
    import hashlib

    h = hashlib.sha256()
    files = []
    for dp, _, fs in os.walk(root):
        files += [os.path.join(dp, f) for f in fs]
    for p in sorted(files, key=lambda q: os.path.relpath(q, root)):
        h.update(os.path.relpath(p, root).encode() + b"\0")
        if p.endswith(".png"):
            h.update(digest_image(*open_image(p)).encode())
        else:
            with open(p, "rb") as f:
                h.update(hashlib.sha256(f.read()).hexdigest().encode())
    return h.hexdigest()
