"""PNG reader in numpy and zlib, with Pillow's conversions.

The native decoder (native/preproc.cpp) reads 8-bit gray and RGB
non-interlaced PNGs; this module reads every other PNG: bit depths 1, 2,
4, 8 and 16, gray, RGB, palette (with ``tRNS``), gray + alpha and RGBA,
the five row filters, and Adam7 interlacing.  The pixels it returns are
the ones ``PIL.Image.open(path).convert("RGB")`` gives:

- gray at 1, 2 or 4 bits is scaled to 0-255 (x255, x85, x17);
- 16-bit gray (Pillow's mode ``I;16``) clips to 255; 16-bit colour
  channels keep their high byte;
- a palette index reads its ``PLTE`` entry;
- alpha (``tRNS``, gray + alpha, RGBA) is dropped, with no compositing.

``read_png(path, channels)`` applies the JAX package's channel rule for
one image: ``channels`` 1 keeps an 8-bit gray PNG as it is and reduces
anything else to the truncating channel mean of its RGB conversion.
``read(paths, channels)`` is the one place that picks the decoder: the
native one for the files it takes, this module for the rest.
``read_png_l(path)`` is Pillow's ``convert("L")`` (``to_l``: ITU-R 601-2
luma in Pillow's integer form), which is not the channel mean.

``encode(img)`` / ``write(path, img)`` write gray, RGB and RGBA uint8
arrays as 8-bit PNGs (filter None, zlib level 6): the pixels decode to
the array, in Pillow too; the bytes are not Pillow's.

Files that are not PNG raise ``NotImplementedError`` naming their format.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from effocr_torch import native

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

# (magic prefix, format name) of the image files this package refuses
_OTHER_FORMATS = (
    (b"\xff\xd8\xff", "JPEG"),
    (b"II*\x00", "TIFF"),
    (b"MM\x00*", "TIFF"),
    (b"BM", "BMP"),
    (b"GIF8", "GIF"),
    (b"RIFF", "RIFF (WebP)"),
)

# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

# samples per pixel by colour type
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def png_header(path: str) -> Optional[Tuple[int, int, int, int, int]]:
    """(h, w, color_type, bit_depth, interlace) from a PNG IHDR, or None
    when the file is not a PNG."""
    with open(path, "rb") as f:
        head = f.read(33)
    if len(head) < 33 or head[:8] != PNG_MAGIC or head[12:16] != b"IHDR":
        return None
    w = int.from_bytes(head[16:20], "big")
    h = int.from_bytes(head[20:24], "big")
    return h, w, head[25], head[24], head[28]


def is_native(hdr: Tuple[int, int, int, int, int]) -> bool:
    """Whether the native decoder reads this PNG: 8-bit gray or RGB,
    non-interlaced."""
    return hdr[3] == 8 and hdr[2] in (0, 2) and hdr[4] == 0


def not_png_error(path: str, head: bytes) -> NotImplementedError:
    fmt = next((name for magic, name in _OTHER_FORMATS
                if head.startswith(magic)), "an unknown format")
    return NotImplementedError(
        f"{path}: {fmt}, not PNG.  effocr_torch decodes PNG files only (or "
        "takes HWC uint8 arrays); other formats need a decoder the package "
        "does not have (ROADMAP.md, queue 3)")


def _chunks(data: bytes):
    pos = len(PNG_MAGIC)
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        yield tag, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IEND":
            return


def _unfilter(raw: memoryview, height: int, stride: int, bpp: int
              ) -> np.ndarray:
    """Undo the per-row filters of one (sub-)image: [height, stride].
    ``stride`` is a whole number of ``bpp``-byte pixels (bpp is 1 below
    8 bits)."""
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    ft, data = rows[:, 0], rows[:, 1:]
    if ft.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(ft.max())}")
    if np.isin(ft, (3, 4)).any():
        return _unfilter_wavefront(data, ft, bpp)
    out = np.empty_like(data)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        row = data[y]
        if ft[y] == 1:      # Sub: running sum per byte lane
            row = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ft[y] == 2:    # Up
            row = row + prev
        out[y] = row
        prev = out[y]
    return out


def _unfilter_wavefront(data: np.ndarray, ft: np.ndarray, bpp: int
                        ) -> np.ndarray:
    """All five filters (Average and Paeth read the pixel to the left, so
    a row cannot be undone as a whole).  Pixel (y, x) depends on (y, x-1),
    (y-1, x) and (y-1, x-1) only, so every pixel of an anti-diagonal
    y + x = d is undone at once, from diagonals d-1 and d-2: h + w - 1
    vector steps instead of a pass per byte.  Diagonals are stored as
    contiguous rows, pixel (y, x) at t[y + x + 2, y + 1]; row 0 of each
    diagonal and diagonals 0-1 are the zero pixels outside the image."""
    h, w = data.shape[0], data.shape[1] // bpp
    t = np.zeros((h + w + 2, h + 1, bpp), np.uint8)
    t0, t1, t2 = t.strides
    skew = np.lib.stride_tricks.as_strided(t[2:, 1:], (h, w, bpp),
                                           (t0 + t1, t0, t2))
    skew[...] = data.reshape(h, w, bpp)
    # per-row 0/1 weights of the four predictors (np.where is several
    # times slower than these products at page width)
    sub, up, avg, pth = (np.repeat((ft == f)[:, None], bpp, 1).astype(
        np.int16) for f in (1, 2, 3, 4))
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        k = d + 2
        a = t[k - 1, y0 + 1:y1 + 1].astype(np.int16)     # left
        b = t[k - 1, y0:y1].astype(np.int16)             # up
        c = t[k - 2, y0:y1].astype(np.int16)             # up-left
        ac, bc = a - c, b - c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(ac + bc)
        near_a = (pa <= pb) & (pa <= pc)
        near_b = (pb <= pc) & ~near_a
        paeth = c + near_a * ac + near_b * bc
        pred = (sub[y0:y1] * a + up[y0:y1] * b
                + avg[y0:y1] * ((a + b) >> 1) + pth[y0:y1] * paeth)
        t[k, y0 + 1:y1 + 1] += pred.astype(np.uint8)     # mod 256
    return skew.reshape(h, w * bpp)


def _samples(rows: np.ndarray, width: int, depth: int, spp: int
             ) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, width, spp] (uint8
    below 16 bits, uint16 at 16)."""
    h = rows.shape[0]
    if depth == 16:
        v = rows[:, :width * spp * 2].reshape(h, -1, 2).astype(np.uint16)
        return ((v[..., 0] << 8) | v[..., 1]).reshape(h, width, spp)
    if depth == 8:
        return rows[:, :width * spp].reshape(h, width, spp)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    v = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return v.reshape(h, -1)[:, :width * spp].reshape(h, width, spp)


def decode(data: bytes) -> Tuple[np.ndarray, dict]:
    """PNG bytes -> (samples [H, W, spp] uint8 or uint16, header dict with
    ``color_type``, ``bit_depth``, ``palette`` [n, 3] uint8 or None)."""
    if not data.startswith(PNG_MAGIC):
        raise ValueError("not a PNG stream")
    ihdr = palette = None
    idat = []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color_type, _, _, interlace = ihdr
    if color_type not in _SAMPLES or depth not in (1, 2, 4, 8, 16) or (
            color_type == 3 and palette is None):
        raise ValueError(f"PNG colour type {color_type}, bit depth "
                         f"{depth} (or a palette PNG without PLTE)")
    spp = _SAMPLES[color_type]
    bpp = max(1, depth * spp // 8)
    raw = memoryview(zlib.decompress(b"".join(idat)))
    if interlace == 0:
        stride = (width * spp * depth + 7) // 8
        px = _samples(_unfilter(raw, height, stride, bpp), width, depth, spp)
    else:
        px = np.zeros((height, width, spp),
                      np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw = (width - x0 + dx - 1) // dx if width > x0 else 0
            ph = (height - y0 + dy - 1) // dy if height > y0 else 0
            if pw == 0 or ph == 0:
                continue
            stride = (pw * spp * depth + 7) // 8
            rows = _unfilter(raw[pos:], ph, stride, bpp)
            pos += ph * (stride + 1)
            px[y0::dy, x0::dx] = _samples(rows, pw, depth, spp)
    return px, {"color_type": color_type, "bit_depth": depth,
                "palette": palette}


def to_rgb(px: np.ndarray, hdr: dict) -> np.ndarray:
    """Samples of ``decode`` -> uint8 [H, W, 3], as Pillow's
    ``convert("RGB")`` gives them."""
    ct, depth = hdr["color_type"], hdr["bit_depth"]
    if ct == 3:
        pal = hdr["palette"]
        full = np.zeros((256, 3), np.uint8)
        full[:len(pal)] = pal
        return full[px[..., 0]]
    if depth == 16:
        # gray (Pillow mode I;16) clips; colour keeps the high byte
        v = (np.minimum(px, 255) if ct == 0 else px >> 8).astype(np.uint8)
    elif depth < 8:
        v = px * np.uint8(255 // ((1 << depth) - 1))
    else:
        v = px
    if ct in (0, 4):          # gray, gray + alpha
        return np.repeat(v[..., :1], 3, axis=-1)
    return np.ascontiguousarray(v[..., :3])


def read_png(path: str, channels: int = 3,
             data: Optional[bytes] = None) -> np.ndarray:
    """uint8 [H, W, channels] of one PNG file.  ``channels`` 3: Pillow's
    RGB conversion; 1: an 8-bit gray PNG as it is, anything else the
    truncating channel mean of its RGB conversion."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    if not data.startswith(PNG_MAGIC):
        raise not_png_error(path, data[:16])
    px, hdr = decode(data)
    if channels == 1 and hdr["color_type"] == 0 and hdr["bit_depth"] == 8:
        return px
    rgb = to_rgb(px, hdr)
    if channels == 1:
        return (rgb.astype(np.uint16).sum(-1, keepdims=True) // 3).astype(
            np.uint8)
    return rgb


def read(paths: Sequence[str], channels: Sequence[int]) -> List[np.ndarray]:
    """uint8 [H, W, channels[i]] of each PNG path, Pillow's conversion and
    the channel rule of ``read_png``: the files the native decoder takes
    (8-bit gray or RGB, non-interlaced) in one threaded native call, every
    other PNG (and any the native decoder rejects) through ``read_png``."""
    out: List[Optional[np.ndarray]] = [None] * len(paths)
    hdrs = [png_header(p) for p in paths]
    nat = [i for i, h in enumerate(hdrs) if h is not None and is_native(h)]
    if nat:
        arrs, _ = native.decode_png_batch(
            [paths[i] for i in nat],
            [hdrs[i][:2] + (channels[i],) for i in nat])
        for i, arr in zip(nat, arrs):
            out[i] = arr
    return [arr if arr is not None else read_png(p, ch)
            for arr, p, ch in zip(out, paths, channels)]


def to_l(rgb: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> [H, W], Pillow's RGB -> L conversion:
    ``(R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16``.  A gray,
    palette or 16-bit PNG converts through its RGB pixels (``to_rgb``) to
    the value Pillow's direct conversion gives."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def read_png_l(path: str) -> np.ndarray:
    """uint8 [H, W]: ``PIL.Image.open(path).convert("L")``."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_MAGIC):
        raise not_png_error(path, data[:16])
    px, hdr = decode(data)
    if hdr["color_type"] == 0 and hdr["bit_depth"] == 8:
        return px[..., 0]
    return to_l(to_rgb(px, hdr))


# colour type by channel count of the array written
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


def encode(img: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, 1 | 3 | 4] -> PNG bytes (8-bit gray, RGB or
    RGBA; every row filter None)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8, not {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPE or 0 in a.shape[:2]:
        raise ValueError(f"PNG writer takes [H, W] or [H, W, 1|3|4], not "
                         f"{list(np.shape(img))}")
    h, w, c = a.shape
    rows = np.zeros((h, w * c + 1), np.uint8)
    rows[:, 1:] = a.reshape(h, w * c)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (PNG_MAGIC + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write(path: str, img: np.ndarray) -> str:
    """``encode(img)`` into ``path`` (parent directories made); returns
    the path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode(img))
    return path
