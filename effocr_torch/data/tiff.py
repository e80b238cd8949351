"""TIFF reader: the first image (IFD 0) of a file, as Pillow opens it.

Byte orders II and MM, strips, and every compression Pillow writes:
none, PackBits, LZW, Deflate (8 and 32946, through zlib), CCITT modified
Huffman (2), T.4 (3) and T.6 (4) with either FillOrder, and JPEG (7)
with its ``JPEGTables``; horizontal differencing (predictor 2) after LZW
and Deflate.  The codecs other than Deflate are native (imgdec.cpp).

Modes, as Pillow names them: ``1`` (MinIsWhite or MinIsBlack), ``L``,
``LA``, ``I;16`` / ``I;16B``, ``P`` (with its colour map), ``RGB``,
``RGBA`` and ``CMYK``; a JPEG strip of photometric YCbCr comes back as
``RGB``, as Pillow's ``JPEGCOLORMODE`` gives it.  Tiled TIFF, BigTIFF,
planar configuration 2, float or signed samples and any other layout
raise ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from effocr_torch.data import jpeg
from effocr_torch.native import imgdec

MAGICS = (b"II*\x00", b"MM\x00*")
BIGTIFF_MAGICS = (b"II+\x00", b"MM\x00+")

# (photometric, bits per sample, extra samples) -> (mode, invert)
_MODES = {
    (0, (1,), ()): ("1", True),
    (1, (1,), ()): ("1", False),
    (0, (8,), ()): ("L", True),
    (1, (8,), ()): ("L", False),
    (1, (16,), ()): ("I;16", False),
    (1, (8, 8), (2,)): ("LA", False),
    (3, (8,), ()): ("P", False),
    (2, (8, 8, 8), ()): ("RGB", False),
    (2, (8, 8, 8, 8), (2,)): ("RGBA", False),
    (5, (8, 8, 8, 8), ()): ("CMYK", False),
    (6, (8, 8, 8), ()): ("RGB", False),
}

# none, CCITT modified Huffman, T.4, T.6, LZW, JPEG, Deflate, PackBits,
# Deflate (the old code)
_COMPRESSIONS = {1, 2, 3, 4, 5, 7, 8, 32773, 32946}

# TIFF field types -> struct code
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d"}


def refuse(what: str) -> NotImplementedError:
    return NotImplementedError(f"TIFF uses {what}; {imgdec.ROADMAP_HINT}")


def _ifd0(data: bytes) -> Tuple[str, Dict[int, tuple]]:
    """Byte-order prefix and the tags of IFD 0: {tag: values}."""
    if data[:4] in BIGTIFF_MAGICS:
        raise refuse("the BigTIFF layout")
    if data[:4] not in MAGICS:
        raise ValueError("not a TIFF stream")
    e = "<" if data[:2] == b"II" else ">"
    if len(data) < 8:
        raise OSError("TIFF: image file is truncated")
    off = struct.unpack(e + "I", data[4:8])[0]
    if off + 2 > len(data):
        raise OSError("TIFF: image file is truncated (IFD 0)")
    n = struct.unpack(e + "H", data[off:off + 2])[0]
    if off + 2 + 12 * n > len(data):
        raise OSError("TIFF: image file is truncated (IFD 0)")
    tags: Dict[int, tuple] = {}
    for i in range(n):
        p = off + 2 + 12 * i
        tag, typ, count = struct.unpack(e + "HHI", data[p:p + 8])
        if typ not in _TYPES:
            continue
        code = _TYPES[typ]
        size = struct.calcsize(e + code) * count
        if size <= 4:
            raw = data[p + 8:p + 8 + size]
        else:
            vo = struct.unpack(e + "I", data[p + 8:p + 12])[0]
            raw = data[vo:vo + size]
            if len(raw) < size:
                raise OSError("TIFF: image file is truncated (a tag's "
                              "values)")
        vals = struct.unpack(e + code * count, raw)
        if typ in (2, 7):
            vals = (bytes(vals),)
        tags[tag] = vals
    return e, tags


def _layout(tags: Dict[int, tuple]) -> Tuple[int, int, str, bool]:
    """(h, w, mode, invert) of IFD 0; raises for what is refused."""
    if 322 in tags or 324 in tags:
        raise refuse("tiles (a tiled TIFF)")
    try:
        w, h = tags[256][0], tags[257][0]
    except KeyError as e:
        raise OSError("TIFF: missing dimensions") from e
    comp = tags.get(259, (1,))[0]
    if comp not in _COMPRESSIONS:
        raise refuse(f"compression {comp}")
    if tags.get(284, (1,))[0] != 1:
        raise refuse("planar configuration 2 (separate planes)")
    fmt = set(tags.get(339, (1,)))
    if fmt != {1}:
        raise refuse(f"sample format {sorted(fmt)} (float or signed "
                     "samples)")
    if tags.get(274, (1,))[0] != 1:
        raise refuse(f"orientation {tags[274][0]}")
    photo = tags.get(262, (0,))[0]
    spp = tags.get(277, (1,))[0]
    bps = tags.get(258, (1,))
    if len(bps) == 1 and spp > 1:
        bps = bps * spp
    extra = tuple(tags.get(338, ()))
    key = (photo, tuple(bps[:spp]), extra)
    if key not in _MODES or (photo == 6 and comp != 7):
        raise refuse(f"photometric {photo} with {spp} samples of "
                     f"{list(bps[:spp])} bits (extra samples {list(extra)})")
    mode, invert = _MODES[key]
    return h, w, mode, invert


def tiff_header(data: bytes) -> Tuple[int, int, str]:
    """(h, w, Pillow's mode) of IFD 0."""
    e, tags = _ifd0(data)
    h, w, mode, _ = _layout(tags)
    if mode == "I;16" and e == ">":
        mode = "I;16B"
    return h, w, mode


def _strip_bytes(comp: int, raw: bytes, nbytes: int, tags, rows: int,
                 w: int) -> np.ndarray:
    """One strip's decoded bytes (CCITT: one byte a pixel, 1 for a black
    run)."""
    if comp == 1:
        return np.frombuffer(raw[:nbytes], np.uint8)
    if comp == 32773:
        return imgdec.packbits(raw, nbytes)
    if comp == 5:
        return imgdec.tiff_lzw(raw, nbytes)
    if comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, nbytes)
        except zlib.error as err:
            raise OSError(f"TIFF: Deflate data: {err}") from err
        return np.frombuffer(out, np.uint8)
    if comp in (2, 3, 4):
        opts = tags.get(292 if comp == 3 else 293, (0,))[0]
        return imgdec.ccitt(raw, comp, opts, tags.get(266, (1,))[0], w, rows)
    raise refuse(f"compression {comp}")


def _jpeg_strip(raw: bytes, tables: Optional[bytes], photo: int, rows: int,
                w: int, spp: int) -> np.ndarray:
    data = raw
    if tables and len(tables) > 4:
        data = tables[:-2] + raw[2:]   # tables' SOI..DQT/DHT, strip's frame
    sh, sw, _ = jpeg.jpeg_header(data)
    if sw != w or sh < rows:
        raise OSError(f"TIFF: JPEG strip of {sw} x {sh} for {w} x {rows}")
    px = imgdec.decode_jpeg(data, (sh, sw, spp), color=1 if photo == 6
                            else 2, where="TIFF JPEG strip")
    return px[:rows].reshape(-1)


def decode(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """TIFF bytes -> (pixels, mode, palette): pixels uint8 [H, W] for
    ``1`` (0 / 255), ``L`` and ``P``, uint16 [H, W] for ``I;16(B)``,
    uint8 [H, W, C] for the rest; palette [256, 3] uint8 for ``P``."""
    e, tags = _ifd0(data)
    h, w, mode, invert = _layout(tags)
    comp = tags.get(259, (1,))[0]
    photo = tags.get(262, (0,))[0]
    spp = tags.get(277, (1,))[0]
    bits = tags.get(258, (1,))[0]
    if 273 not in tags or 279 not in tags:
        raise OSError("TIFF: no strips")
    offsets, counts = tags[273], tags[279]
    rps = min(tags.get(278, (h,))[0], h)
    row_bytes = (w * spp * bits + 7) // 8
    predictor = tags.get(317, (1,))[0]
    if predictor not in (1, 2):
        raise refuse(f"predictor {predictor}")
    rows_out = []
    for i, (off, cnt) in enumerate(zip(offsets, counts)):
        rows = min(rps, h - i * rps)
        if rows <= 0:
            break
        raw = data[off:off + cnt]
        if len(raw) < cnt:
            raise OSError("TIFF: image file is truncated (strip "
                          f"{i} of {len(offsets)})")
        if comp == 7:
            strip = _jpeg_strip(raw, tags.get(347, (None,))[0], photo, rows,
                                w, spp)
            rows_out.append(strip.reshape(rows, w * spp))
            continue
        if comp in (2, 3, 4):
            rows_out.append(np.packbits(
                _strip_bytes(comp, raw, 0, tags, rows, w), axis=1))
            continue
        strip = _strip_bytes(comp, raw, rows * row_bytes, tags, rows, w)
        if strip.size < rows * row_bytes:
            raise OSError(f"TIFF: image file is truncated (strip {i} "
                          f"holds {strip.size} of {rows * row_bytes} bytes)")
        rows_out.append(strip.reshape(rows, row_bytes))
    if sum(r.shape[0] for r in rows_out) < h:
        raise OSError("TIFF: image file is truncated (too few strips)")
    buf = np.concatenate(rows_out)[:h]
    if predictor == 2 and comp in (5, 8, 32946):
        buf = _undo_predictor(buf, spp, bits, e)
    return _pixels(buf, h, w, mode, invert, bits, spp, e, tags)


def _undo_predictor(buf: np.ndarray, spp: int, bits: int, e: str
                    ) -> np.ndarray:
    """Horizontal differencing: a running sum along each row, per
    sample, modulo the sample's range."""
    h = buf.shape[0]
    if bits == 8:
        return np.cumsum(buf.reshape(h, -1, spp), axis=1,
                         dtype=np.uint8).reshape(h, -1)
    if bits == 16:
        v = buf.view(e + "u2").reshape(h, -1, spp)
        return np.cumsum(v, axis=1, dtype=np.uint16).astype(
            e + "u2").view(np.uint8).reshape(h, -1)
    raise refuse(f"predictor 2 on {bits}-bit samples")


def _pixels(buf, h, w, mode, invert, bits, spp, e, tags):
    if mode == "1":
        px = np.unpackbits(buf, axis=1)[:, :w]
        if invert:
            px = 1 - px
        return px * np.uint8(255), mode, None
    if mode == "I;16":
        px = buf[:, :2 * w].copy().view(e + "u2").astype(np.uint16)
        return px, "I;16B" if e == ">" else "I;16", None
    px = buf[:, :w * spp].reshape(h, w, spp)
    if spp == 1:
        px = px[..., 0]
    if invert:
        px = 255 - px
    palette = None
    if mode == "P":
        cmap = tags.get(320)
        if cmap is None or len(cmap) < 3 * 256:
            raise OSError("TIFF: palette image without a 256-entry colour "
                          "map")
        palette = (np.asarray(cmap[:768], np.uint32).reshape(3, 256).T
                   // 256).astype(np.uint8)
    return np.ascontiguousarray(px), mode, palette
