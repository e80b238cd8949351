"""TIFF reader: the first image (IFD 0) of a file, as Pillow opens it.

Containers: byte orders II and MM, BigTIFF (little-endian; Pillow 12.1
opens no big-endian BigTIFF, so neither does this reader), strips or
tiles (the edge tiles' padding cropped), samples interleaved or in
separate planes (planar configuration 2, one plane after another),
and every compression Pillow writes: none, PackBits, LZW, Deflate (8
and 32946, through zlib), CCITT modified Huffman (2), T.4 (3) and T.6
(4) with either FillOrder, and JPEG (7) with its ``JPEGTables``;
horizontal differencing (predictor 2) on 8- and 16-bit samples after
LZW and Deflate.  The codecs other than Deflate are native (imgdec.cpp).
Orientations 2-8 transpose the decoded image as Pillow's
``ImageOps.exif_transpose`` does; 5-8 swap the size ``tiff_header``
reports, as ``Image.open(...).size`` does.

Modes, as Pillow names them: ``1`` (MinIsWhite or MinIsBlack), ``L``
(8 bits, or 2 / 4 bits scaled to 0-255), ``LA``, ``I;16`` / ``I;16B``,
``P`` (1 / 2 / 4 / 8-bit indices, with the colour map's 2^bits
entries), ``RGB`` and ``RGBA`` (8 bits, or 16 bits as each sample's
high byte) and ``CMYK``; a JPEG segment of photometric YCbCr comes back
as ``RGB``, as Pillow's ``JPEGCOLORMODE`` gives it.  Float or signed
samples, other bit depths, unspecified or associated alpha, predictor
3, other compressions, uncompressed 16-bit or one-sample files in
separate planes, LA and JPEG in separate planes raise
``NotImplementedError`` naming the feature; a layout Pillow cannot
open raises ``OSError``, as it does there.
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
    (0, (2,), ()): ("L", True),
    (1, (2,), ()): ("L", False),
    (0, (4,), ()): ("L", True),
    (1, (4,), ()): ("L", False),
    (0, (8,), ()): ("L", True),
    (1, (8,), ()): ("L", False),
    (1, (16,), ()): ("I;16", False),
    (1, (8, 8), (2,)): ("LA", False),
    (3, (1,), ()): ("P", False),
    (3, (2,), ()): ("P", False),
    (3, (4,), ()): ("P", False),
    (3, (8,), ()): ("P", False),
    (2, (8, 8, 8), ()): ("RGB", False),
    (2, (8, 8, 8, 8), (2,)): ("RGBA", False),
    (2, (16, 16, 16), ()): ("RGB", False),
    (2, (16, 16, 16, 16), (2,)): ("RGBA", False),
    (5, (8, 8, 8, 8), ()): ("CMYK", False),
    (6, (8, 8, 8), ()): ("RGB", False),
}


def _pillow_layouts():
    """(photometric, bits, extra samples) of every unsigned layout
    Pillow 12.1's TIFF plugin opens in both byte orders, and those it
    opens only little-endian (its ``OPEN_INFO``)."""
    b8, b16 = (8,), (16,)
    both = {(p, (b,), ()) for p in (0, 1, 3) for b in (1, 2, 4, 8)}
    both |= {(1, b16, ()), (1, b8 * 2, (2,)), (3, b8 * 2, (0,)),
             (3, b8 * 2, (2,)), (6, b8, ()), (6, b8 * 3, ()),
             (8, b8 * 3, ()), (2, b8 * 3, ()), (2, b8 * 4, ()),
             (2, b8 * 4, (999,)), (5, b8 * 4, ()), (5, b8 * 5, (0,)),
             (5, b8 * 6, (0, 0)), (5, b16 * 4, ()), (2, b16 * 3, ())}
    for a in (0, 1, 2):
        both |= {(2, b8 * (4 + k), (a,) + (0,) * k) for k in range(3)}
        both.add((2, b16 * 4, (a,)))
    both.add((2, b16 * 4, ()))
    little = {(0, b16, ()), (1, (12,), ()), (1, (32,), ())}
    return both, little


_PILLOW_BOTH, _PILLOW_LITTLE = _pillow_layouts()

# none, CCITT modified Huffman, T.4, T.6, LZW, JPEG, Deflate, PackBits,
# Deflate (the old code)
_COMPRESSIONS = {1, 2, 3, 4, 5, 7, 8, 32773, 32946}
_PREDICTED = (5, 8, 32946)        # the codecs libtiff undoes predictor 2 in
_MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)  # Pillow's bomb error

# TIFF field types -> struct code (16-18: BigTIFF's LONG8, SLONG8, IFD8)
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 13: "I", 16: "Q", 17: "q",
          18: "Q"}


def refuse(what: str) -> NotImplementedError:
    return NotImplementedError(f"TIFF uses {what}; {imgdec.ROADMAP_HINT}")


def _ifd0(data: bytes) -> Tuple[str, Dict[int, tuple]]:
    """Byte-order prefix and the tags of IFD 0: {tag: values}."""
    big = data[:4] in BIGTIFF_MAGICS
    if data[:4] == BIGTIFF_MAGICS[1]:
        raise OSError("TIFF: cannot identify image file (a big-endian "
                      "BigTIFF, which Pillow does not open)")
    if not big and data[:4] not in MAGICS:
        raise ValueError("not a TIFF stream")
    e = "<" if data[:2] == b"II" else ">"
    head, count, ent, inline = ((16, "Q", 20, 8) if big else
                                (8, "H", 12, 4))
    if len(data) < head:
        raise OSError("TIFF: image file is truncated")
    off = struct.unpack(e + ("Q" if big else "I"),
                        data[head - (8 if big else 4):head])[0]
    csize = struct.calcsize(count)
    if off + csize > len(data):
        raise OSError("TIFF: image file is truncated (IFD 0)")
    n = struct.unpack(e + count, data[off:off + csize])[0]
    if off + csize + ent * n > len(data):
        raise OSError("TIFF: image file is truncated (IFD 0)")
    tags: Dict[int, tuple] = {}
    for i in range(n):
        p = off + csize + ent * i
        tag, typ, cnt = struct.unpack(e + ("HHQ" if big else "HHI"),
                                      data[p:p + ent - inline])
        if typ not in _TYPES:
            continue
        code = _TYPES[typ]
        size = struct.calcsize(e + code) * cnt
        p += ent - inline
        if size <= inline:
            raw = data[p:p + size]
        else:
            vo = struct.unpack(e + ("Q" if big else "I"),
                               data[p:p + inline])[0]
            raw = data[vo:vo + size]
            if len(raw) < size:
                raise OSError("TIFF: image file is truncated (a tag's "
                              "values)")
        vals = struct.unpack(e + code * cnt, raw)
        if typ in (2, 7):
            vals = (bytes(vals),)
        tags[tag] = vals
    return e, tags


def _layout(e: str, tags: Dict[int, tuple]
            ) -> Tuple[int, int, str, bool, int]:
    """(h, w, mode, invert, bits) of IFD 0 as stored (before its
    orientation); raises for what is refused."""
    try:
        w, h = tags[256][0], tags[257][0]
    except KeyError as err:
        raise OSError("TIFF: missing dimensions") from err
    if w * h > _MAX_PIXELS:
        raise OSError(f"TIFF: {w} x {h} pixels, above the {_MAX_PIXELS} "
                      "Pillow opens (a decompression bomb)")
    comp = tags.get(259, (1,))[0]
    if comp not in _COMPRESSIONS:
        raise refuse(f"compression {comp}")
    fmt = set(tags.get(339, (1,)))
    if fmt != {1}:
        raise refuse(f"sample format {sorted(fmt)} (float or signed "
                     "samples)")
    photo = tags.get(262, (0,))[0]
    spp = tags.get(277, (1,))[0]
    bps = tags.get(258, (1,))
    if len(bps) == 1 and spp > 1:
        bps = bps * spp
    extra = tuple(tags.get(338, ()))
    key = (photo, tuple(bps[:spp]), extra)
    if key not in _PILLOW_BOTH and (e == ">" or key not in _PILLOW_LITTLE):
        raise OSError(f"TIFF: unknown pixel mode (photometric {photo}, "
                      f"{list(bps)} bits, extra samples {list(extra)}), "
                      "which Pillow does not open")
    if key not in _MODES or (photo == 6 and comp != 7):
        raise refuse(f"photometric {photo} with {spp} samples of "
                     f"{list(bps[:spp])} bits (extra samples {list(extra)})")
    planar = tags.get(284, (1,))[0]
    if planar not in (1, 2):
        raise refuse(f"planar configuration {planar}")
    if planar == 2 and comp == 7 and spp > 1:
        raise refuse("JPEG compression in separate planes")
    if planar == 2 and comp == 1 and (spp == 1 or bps[0] == 16):
        raise refuse(f"planar configuration 2 with {spp} uncompressed "
                     f"{bps[0]}-bit samples")
    if planar == 2 and key == (1, (8, 8), (2,)):
        if comp == 1:
            raise OSError("TIFF: unknown raw mode for separate L and A "
                          "planes (Pillow has no unpacker for them)")
        raise refuse("planar configuration 2 for LA (Pillow's planes are "
                      "not the file's)")
    mode, invert = _MODES[key]
    return h, w, mode, invert, bps[0]


def _orientation(tags: Dict[int, tuple]) -> int:
    o = tags.get(274, (1,))[0]
    return o if o in range(2, 9) else 1


def tiff_header(data: bytes) -> Tuple[int, int, str]:
    """(h, w, Pillow's mode) of IFD 0, the size after its orientation."""
    e, tags = _ifd0(data)
    h, w, mode, _, _ = _layout(e, tags)
    if mode == "I;16" and e == ">":
        mode = "I;16B"
    if _orientation(tags) >= 5:
        h, w = w, h
    return h, w, mode


def _segment_bytes(comp: int, raw: bytes, nbytes: int, tags, rows: int,
                   w: int) -> np.ndarray:
    """One strip or tile's decoded bytes (CCITT: one byte a pixel, 1 for
    a black run)."""
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


def _jpeg_segment(raw: bytes, tables: Optional[bytes], photo: int,
                  rows: int, w: int, spp: int) -> np.ndarray:
    """uint8 [rows, w, spp] of one JPEG strip or tile."""
    data = raw
    if tables and len(tables) > 4:
        data = tables[:-2] + raw[2:]   # tables' SOI..DQT/DHT, the frame's
    sh, sw, _ = jpeg.jpeg_header(data)
    if sw != w or sh < rows:
        raise OSError(f"TIFF: JPEG segment of {sw} x {sh} for {w} x {rows}")
    px = imgdec.decode_jpeg(data, (sh, sw, spp), color=1 if photo == 6
                            else 2, where="TIFF JPEG segment")
    return px[:rows].reshape(rows, w, spp)


def _samples(buf: np.ndarray, bits: int, n: int, e: str) -> np.ndarray:
    """[rows, row bytes] -> [rows, n] samples: uint8 (1 / 2 / 4 / 8
    bits), uint16 (16 bits, read in the file's byte order)."""
    if bits == 16:
        return buf[:, :2 * n].copy().view(e + "u2").astype(np.uint16)
    if bits == 8:
        return buf[:, :n]
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    v = (buf[..., None] >> shifts) & np.uint8((1 << bits) - 1)
    return v.reshape(buf.shape[0], -1)[:, :n]


def decode(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """TIFF bytes -> (pixels, mode, palette): pixels uint8 [H, W] for
    ``1`` (0 / 255), ``L`` and ``P``, uint16 [H, W] for ``I;16(B)``,
    uint8 [H, W, C] for the rest, after the orientation; palette [2^bits,
    3] uint8 for ``P``."""
    e, tags = _ifd0(data)
    h, w, mode, invert, bits = _layout(e, tags)
    comp = tags.get(259, (1,))[0]
    photo = tags.get(262, (0,))[0]
    spp = tags.get(277, (1,))[0]
    predictor = tags.get(317, (1,))[0]
    if predictor not in (1, 2):
        raise refuse(f"predictor {predictor}")
    predicted = predictor == 2 and comp in _PREDICTED
    if predicted and bits not in (8, 16):
        raise OSError(f"TIFF: horizontal differencing (predictor 2) is "
                      f"not supported with {bits}-bit samples")
    tiled = 324 in tags or 322 in tags
    if tiled:
        try:
            tw, th = tags[322][0], tags[323][0]
            offsets, counts = tags[324], tags[325]
        except KeyError as err:
            raise OSError(f"TIFF: tiled without tag {err}") from err
        if tw <= 0 or th <= 0:
            raise OSError(f"TIFF: tiles of {tw} x {th}")
    else:
        if 273 not in tags or 279 not in tags:
            raise OSError("TIFF: no strips")
        offsets, counts = tags[273], tags[279]
        tw, th = w, min(tags.get(278, (h,))[0], h)
        if th <= 0:
            raise OSError("TIFF: RowsPerStrip 0")
    planes = spp if tags.get(284, (1,))[0] == 2 and spp > 1 else 1
    seg_spp = spp // planes
    across, down = -(-w // tw), -(-h // th)
    total = planes * across * down
    present = min(total, len(offsets), len(counts))
    if present < total and comp != 1:
        raise OSError(f"TIFF: image file is truncated ({present} of {total} "
                      f"{'tiles' if tiled else 'strips'})")
    samples = np.zeros((h, w, spp), np.uint16 if bits == 16 else np.uint8)
    tables = tags.get(347, (None,))[0]
    row_bytes = (tw * seg_spp * bits + 7) // 8
    for i in range(present):
        plane, r, c = i // (across * down), i // across % down, i % across
        y0, x0 = r * th, c * tw
        rows = th if tiled else min(th, h - y0)
        ry, rx = min(th, h - y0), min(tw, w - x0)
        region = (slice(y0, y0 + ry), slice(x0, x0 + rx),
                  slice(plane * seg_spp, (plane + 1) * seg_spp))
        off, cnt = offsets[i], counts[i]
        if comp == 1:
            # as Pillow's raw decoder: the rows inside the image, from the
            # offset, whatever the byte count says
            need = ry * row_bytes
            seg = np.frombuffer(data[off:off + need], np.uint8)
            if seg.size < need:
                raise OSError(f"TIFF: image file is truncated (segment {i} "
                              f"holds {seg.size} of {need} bytes)")
            buf = seg.reshape(ry, row_bytes)
        else:
            raw = data[off:off + cnt]
            if len(raw) < cnt:
                raise OSError(f"TIFF: image file is truncated (segment "
                              f"{i} of {present})")
            if comp == 7:
                px = _jpeg_segment(raw, tables, photo, rows, tw, seg_spp)
                samples[region] = px[:ry, :rx]
                continue
            if comp in (2, 3, 4):
                buf = np.packbits(_segment_bytes(comp, raw, 0, tags, rows,
                                                 tw), axis=1)
            else:
                seg = _segment_bytes(comp, raw, rows * row_bytes, tags, rows,
                                     tw)
                if seg.size < rows * row_bytes:
                    raise OSError(f"TIFF: image file is truncated (segment "
                                  f"{i} holds {seg.size} of "
                                  f"{rows * row_bytes} bytes)")
                buf = seg[:rows * row_bytes].reshape(rows, row_bytes)
            if predicted:
                buf = _undo_predictor(buf, seg_spp, bits, e)
        v = _samples(buf[:ry], bits, tw * seg_spp, e)
        samples[region] = v.reshape(ry, tw, seg_spp)[:, :rx]
    orientation = _orientation(tags)
    if orientation >= 5 and comp == 1:
        samples = _mapped(data, tags, samples, mode, invert, bits, e,
                          offsets, tiled, tw, th)
    px, palette = _pixels(samples, mode, invert, bits, tags)
    if present < total:     # uncompressed: Pillow leaves the rest 0
        got = (np.arange(total) < present).reshape(planes, down, across)
        got = got.repeat(th, 1).repeat(tw, 2)[:, :h, :w]
        if px.ndim == 2:
            px[~got[0]] = 0
        else:
            px[~np.moveaxis(got, 0, -1).repeat(seg_spp, -1)] = 0
    if mode == "I;16" and e == ">":
        mode = "I;16B"
    return _orient(px, orientation), mode, palette


def _mapped(data: bytes, tags, samples: np.ndarray, mode: str,
            invert: bool, bits: int, e: str, offsets, tiled: bool, tw: int,
            th: int) -> np.ndarray:
    """The samples Pillow transposes for orientations 5-8 of a file it
    memory-maps: one uncompressed strip or tile of L, P, RGBA, CMYK or
    I;16 (``ImageFile.load`` maps it at ``Image.open``'s size, the
    transposed one, so the stored bytes read as w rows of h samples, and
    the transposed image keeps the stored h x w).  Other files: as
    given."""
    h, w, spp = samples.shape
    one = (len(offsets) == 1 or (tw, th) == (w, h)
           or (not tiled and tags.get(278, (h,))[0] == h))
    if (not one or invert or mode not in ("L", "P", "RGBA", "CMYK", "I;16")
            or (bits == 8) == (mode == "I;16")
            or tags.get(284, (1,))[0] != 1):
        return samples
    size = bits // 8 * spp
    stride = tw * size if tiled and tw > w else h * size
    off = offsets[-1]
    raw = np.frombuffer(data[off:off + w * stride], np.uint8)
    if raw.size < w * stride:       # Pillow's map check fails: decoded
        return samples
    rows = raw.reshape(w, stride)[:, :h * size]
    if bits == 16:
        rows = rows.copy().view(e + "u2").astype(np.uint16)
    return rows.reshape(w, h, spp)


def _undo_predictor(buf: np.ndarray, spp: int, bits: int, e: str
                    ) -> np.ndarray:
    """Horizontal differencing: a running sum along each row, per
    sample, modulo the sample's range."""
    h = buf.shape[0]
    if bits == 8:
        return np.cumsum(buf.reshape(h, -1, spp), axis=1,
                         dtype=np.uint8).reshape(h, -1)
    v = buf.view(e + "u2").reshape(h, -1, spp)
    return np.cumsum(v, axis=1, dtype=np.uint16).astype(
        e + "u2").view(np.uint8).reshape(h, -1)


def _pixels(samples: np.ndarray, mode: str, invert: bool, bits: int, tags
            ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """[H, W, C] samples -> (pixels of the mode, palette)."""
    px = samples[..., 0] if samples.shape[2] == 1 else samples
    if mode == "1":
        px = 1 - px if invert else px
        return px * np.uint8(255), None
    if mode == "I;16":
        return px, None
    if bits == 16:                  # RGB / RGBA: each sample's high byte
        return (px >> 8).astype(np.uint8), None
    if mode == "L" and bits < 8:    # Pillow's L;2 / L;4 unpackers
        px = px * np.uint8(255 // ((1 << bits) - 1))
    if invert:
        px = 255 - px
    palette = None
    if mode == "P":
        cmap = tags.get(320)
        n = 1 << bits
        if cmap is None or len(cmap) < 3 * n:
            raise OSError(f"TIFF: palette image without a {n}-entry colour "
                          "map")
        palette = (np.asarray(cmap[:3 * n], np.uint32).reshape(3, n).T
                   // 256).astype(np.uint8)
    return np.ascontiguousarray(px), palette


def _orient(px: np.ndarray, orientation: int) -> np.ndarray:
    """Pillow's ``exif_transpose`` of [H, W, ...] pixels: 2 mirror, 3
    rotate 180, 4 flip, 5 transpose, 6 rotate 270, 7 transverse, 8
    rotate 90 (counter-clockwise)."""
    if orientation >= 5:
        px = px.swapaxes(0, 1)
        orientation = {5: 1, 6: 2, 7: 3, 8: 4}[orientation]
    if orientation in (2, 3):
        px = px[:, ::-1]
    if orientation in (3, 4):
        px = px[::-1]
    return np.ascontiguousarray(px)
