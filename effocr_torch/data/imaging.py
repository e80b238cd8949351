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
- ``open_image`` / ``save_image`` / ``copy_image``: ``Image.open`` and
  ``Image.save`` of a PNG in its own mode (L, RGB or RGBA), through
  data/png.py (pixels and modes are Pillow's; the bytes are not).
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from effocr_torch.data import image_io, png

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
def _pil_coeffs(in_size: int, out_size: int, kind: str = "bilinear"
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's resample weights along one axis (libImaging/Resample.c
    precompute_coeffs + normalize_coeffs_8bpc): output xx reads inputs
    ``start[xx] + j`` with integer weight ``weights[xx, j]``, j < ksize.
    The filter is widened by the scale on a downscale, each output's
    weights are summed in input order and normalised in float64, then
    rounded half away from zero to 22-bit fixed point."""
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


def open_image(path: str) -> Tuple[np.ndarray, str]:
    """(pixels, mode) as ``Image.open(path)`` holds them, for L, RGB and
    RGBA images (PNG, or any format data/image_io.py decodes)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(png.PNG_MAGIC):
        px, hdr = png.decode(data)
        mode = png.pillow_mode(hdr["color_type"], hdr["bit_depth"])
        if mode == "L":
            px = px[..., 0]
    else:
        px, mode, _ = image_io.decode(path, data)
    if mode not in ("L", "RGB", "RGBA"):
        raise NotImplementedError(
            f"{path} opens in mode {mode}; keeping that mode on save is not "
            f"ported (ROADMAP.md, queue 1)")
    return np.ascontiguousarray(px, np.uint8), mode


def save_image(path: str, img: np.ndarray) -> str:
    """``Image.save`` as PNG: the same pixels and mode (zlib level 1, for
    speed: the bytes are not Pillow's either way)."""
    return png.write(path, img, level=1)


def copy_image(src: str, dst: str) -> str:
    """``Image.open(src).save(dst)`` of a PNG: a file Pillow would open in
    mode L, RGB or RGBA is copied as it is (the same pixels and mode);
    anything else is decoded and written."""
    import shutil

    with open(src, "rb") as f:
        head = f.read(33)
    if head.startswith(png.PNG_MAGIC) and len(head) == 33 and head[24] == 8 \
            and head[25] in (0, 2, 6):
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        shutil.copyfile(src, dst)
        return dst
    return save_image(dst, open_image(src)[0])


def digest_image(px: np.ndarray, mode: str) -> str:
    """SHA-256 of an image's mode, shape and pixels (PNG bytes may differ
    between writers; these may not)."""
    import hashlib

    h = hashlib.sha256(mode.encode())
    h.update(repr(tuple(px.shape)).encode())
    h.update(np.ascontiguousarray(px, np.uint8).tobytes())
    return h.hexdigest()


def digest_tree(root: str) -> str:
    """SHA-256 over a directory: every file's relative path, then for a
    PNG its ``digest_image``, for anything else its bytes."""
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
