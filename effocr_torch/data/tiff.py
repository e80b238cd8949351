"""TIFF reader: the first image (IFD 0) of a file, as Pillow opens it.

Containers: byte orders II and MM, BigTIFF (little-endian; Pillow 12.1
opens no big-endian BigTIFF, so neither does this reader), strips or
tiles (the edge tiles' padding cropped), samples interleaved or in
separate planes (planar configuration 2, one plane after another),
and every compression Pillow writes: none, PackBits, LZW, Deflate (8
and 32946, through zlib), CCITT modified Huffman (2), T.4 (3) and T.6
(4) with either FillOrder (libtiff's decoder, so that a segment cut or
damaged gives its rows, and the rows it does not reach those of the
segment before, as in Pillow's one buffer), and JPEG (7) with its
``JPEGTables`` (a segment cut inside its byte count read as libjpeg
reads the EOIs libtiff puts after it); horizontal differencing
(predictor 2) on 8, 16 and 32-bit samples and the floating-point
predictor (3) on float samples after LZW and Deflate.  The codecs other than Deflate are native
(imgdec.cpp).  Orientations 2-8 transpose the decoded image as Pillow's
``ImageOps.exif_transpose`` does; 5-8 swap the size ``tiff_header``
reports, as ``Image.open(...).size`` does.

Layouts and modes are Pillow 12.1's ``OPEN_INFO`` (``_OPEN_INFO``, a
copy), each sample unpacked as its rawmode says: ``1``, ``L`` (8 bits,
signed 8 bits as stored, 2 / 4 bits scaled to 0-255, one-sample YCbCr),
``LA``, ``I;16`` / ``I;16B`` (16 bits, 12 bits, 16-bit MinIsWhite not
inverted), ``I`` (signed 16 / 32 bits, unsigned 32 bits wrapped), ``F``
(32-bit float, MinIsWhite not inverted), ``P`` (1 / 2 / 4 / 8-bit
indices, with the colour map's 2^bits entries; PX), ``PA``, ``RGB`` and
``RGBA`` (8 bits, or 16 bits as each sample's high byte; extra samples
dropped, associated alpha divided out as Pillow's RGBa unpackers do),
``CMYK`` (8 or 16 bits, extra samples dropped) and ``LAB`` (as stored);
a JPEG segment of photometric YCbCr comes back as ``RGB``, as Pillow's
``JPEGCOLORMODE`` gives it, and compressed YCbCr outside JPEG as libtiff's
RGBA interface converts it (its subsampled blocks, its tables).  Pillow's
own readings are kept: words libtiff hands over in the machine's order
read through a big-endian rawmode (32-bit and signed 16-bit,
compressed) come out byte-swapped, and planes follow Pillow's rules
(``_planes_raw``).  Layouts whose pixels in Pillow are not the file's
(uncompressed YCbCr, 4x4 YCbCr where libtiff misreads it, LA and PA
planes, uncompressed 16-bit planes and most one-sample planes) and other
compressions raise ``NotImplementedError`` naming the feature; a layout
Pillow cannot open or decode raises ``OSError``, as it does there.
"""

from __future__ import annotations

import functools
import struct
import zlib
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from effocr_torch.data import jpeg
from effocr_torch.native import imgdec

MAGICS = (b"II*\x00", b"MM\x00*")
BIGTIFF_MAGICS = (b"II+\x00", b"MM\x00+")


def _open_info():
    """Pillow 12.1's ``TiffImagePlugin.OPEN_INFO`` (FillOrder 1):
    (big-endian, photometric, sample format, bits, extra samples) ->
    (mode, rawmode).  The rawmode says how Pillow unpacks the samples
    (``_pixels``)."""
    info = {}
    b8, b16 = (8,), (16,)

    def both(key, mode, raw, raw_big=None):
        info[(False,) + key] = (mode, raw)
        info[(True,) + key] = (mode if mode != "I;16" else "I;16B",
                               raw_big or raw)

    for b, sfx in ((1, ""), (2, ";2"), (4, ";4"), (8, "")):
        gray = "1" if b == 1 else "L"
        both((0, (1,), (b,), ()), gray, gray + (sfx or ";") + "I")
        both((1, (1,), (b,), ()), gray, gray + sfx)
        both((3, (1,), (b,), ()), "P", "P" + (sfx or (";1" if b == 1
                                                    else "")))
    both((1, (1,), b16, ()), "I;16", "I;16", "I;16B")
    both((1, (2,), b16, ()), "I", "I;16S", "I;16BS")
    both((1, (2,), (32,), ()), "I", "I;32S", "I;32BS")
    both((1, (2,), b8, ()), "L", "L")
    for p in (0, 1):
        both((p, (3,), (32,), ()), "F", "F;32F", "F;32BF")
    both((1, (1,), b8 * 2, (2,)), "LA", "LA")
    both((3, (1,), b8 * 2, (0,)), "P", "PX")
    both((3, (1,), b8 * 2, (2,)), "PA", "PA")
    both((2, (1,), b8 * 3, ()), "RGB", "RGB")
    both((2, (1,), b16 * 3, ()), "RGB", "RGB;16L", "RGB;16B")
    for extra, mode, raw in (((), "RGBA", "RGBA"), ((999,), "RGBA", "RGBA"),
                             ((0,), "RGB", "RGBX"), ((1,), "RGBA", "RGBa"),
                             ((2,), "RGBA", "RGBA")):
        both((2, (1,), b8 * 4, extra), mode, raw)
        if extra != (999,):
            both((2, (1,), b16 * 4, extra), mode, raw + ";16L",
                 raw + ";16B")
    for k in (1, 2):
        for a, mode, raw in ((0, "RGB", "RGBX"), (1, "RGBA", "RGBa"),
                             (2, "RGBA", "RGBA")):
            both((2, (1,), b8 * (4 + k), (a,) + (0,) * k), mode,
                 raw + "X" * k)
    both((5, (1,), b8 * 4, ()), "CMYK", "CMYK")
    both((5, (1,), b16 * 4, ()), "CMYK", "CMYK;16L", "CMYK;16B")
    both((5, (1,), b8 * 5, (0,)), "CMYK", "CMYKX")
    both((5, (1,), b8 * 6, (0, 0)), "CMYK", "CMYKXX")
    both((6, (1,), b8, ()), "L", "L")
    both((6, (1,), b8 * 3, ()), "RGB", "RGBX")
    both((8, (1,), b8 * 3, ()), "LAB", "LAB")
    # little-endian only: 16-bit MinIsWhite (not inverted), 12-bit and
    # unsigned 32-bit gray
    info[(False, 0, (1,), b16, ())] = ("I;16", "I;16")
    info[(False, 1, (1,), (12,), ())] = ("I;16", "I;12")
    info[(False, 1, (1,), (32,), ())] = ("I", "I;32N")
    return info


_OPEN_INFO = _open_info()
# Image._MAPMODES: the modes ImageFile.load memory-maps when the rawmode
# is the mode itself
_MAPMODES = ("L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B")


class Layout(NamedTuple):
    """IFD 0's pixels as Pillow opens them: size as stored (before the
    orientation), mode, rawmode, bits per sample, sample format, and
    whether 16 / 32-bit words reach the rawmode's unpacker in the
    machine's (little-endian) order, as libtiff hands them over, rather
    than the file's."""
    h: int
    w: int
    mode: str
    raw: str
    bits: int
    fmt: int
    native: bool

# YCbCr subsamplings libtiff's RGBA interface has a put routine for
# (tif_getimage.c putcontig8bitYCbCr{44,42,41,22,21,12,11}tile)
_YCBCR_PUT = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))

# none, CCITT modified Huffman, T.4, T.6, LZW, JPEG, Deflate, PackBits,
# Deflate (the old code)
_COMPRESSIONS = {1, 2, 3, 4, 5, 7, 8, 32773, 32946}
_PREDICTED = (5, 8, 32946)        # the codecs libtiff undoes predictor 2 in
_MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)  # Pillow's bomb error
_EOIS = b"\xff\xd9" * 32770      # past a cut JPEG segment: a marker's
                                  # longest length, and its EOI

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


def _layout(e: str, tags: Dict[int, tuple]) -> Layout:
    """IFD 0's ``Layout``; raises for what is refused."""
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
    photo = tags.get(262, (0,))[0]
    spp = tags.get(277, (1,))[0]
    bps = tags.get(258, (1,))
    if len(bps) == 1 and spp > 1:
        bps = bps * spp
    bps = tuple(bps[:spp])
    extra = tuple(tags.get(338, ()))
    fmt = tuple(tags.get(339, (1,)))
    if len(fmt) > 1 and set(fmt) == {1}:     # one format for all: unsigned
        fmt = (1,)
    key = (e == ">", photo, fmt, bps, extra)
    if key not in _OPEN_INFO:
        raise OSError(f"TIFF: unknown pixel mode (photometric {photo}, "
                      f"sample format {list(fmt)}, {list(bps)} bits, extra "
                      f"samples {list(extra)}), which Pillow does not open")
    mode, raw = _OPEN_INFO[key]
    if photo == 6 and spp == 3 and comp == 1:
        raise refuse("photometric 6 with 3 samples (YCbCr) uncompressed "
                     "(Pillow's raw decoder reads 4 bytes a pixel of these "
                     "3: its pixels are not the file's)")
    if photo == 6 and spp == 3 and comp != 7:
        # libtiff's RGBA interface converts them (TIFFYCbCrToRGB), at the
        # subsamplings it has a put routine for, contiguous unless 1x1
        sub = _subsampling(tags)
        if sub not in _YCBCR_PUT or (sub != (1, 1) and tags.get(
                284, (1,))[0] == 2):
            raise OSError(f"TIFF: YCbCr subsampled {sub[0]}x{sub[1]}"
                          f"{' in planes' if sub in _YCBCR_PUT else ''}, "
                          "which libtiff's RGBA interface does not read "
                          "(Pillow: decoder error)")
        if sub != (1, 1) and tags.get(317, (1,))[0] != 1:
            raise refuse("a predictor on subsampled YCbCr")
        tw = tags.get(322, (0,))[0]
        if sub == (4, 4) and (w % tw if tw else -(-w // 4) % 2):
            # libtiff reads 4 x 4 blocks wrong there: its scanline size
            # drops 2 bytes a row of an odd count of blocks, and it skips
            # 10 bytes (not 18) a block past a narrowed tile's rows
            raise refuse("YCbCr subsampled 4x4 in strips of an odd count "
                         "of blocks or in edge tiles (Pillow's pixels are "
                         "not the file's)")
        raw = "YCbCr"
    if photo == 6 and spp == 1 and comp == 7:
        raise refuse("photometric 6 with 1 sample (YCbCr) under JPEG "
                     "compression")
    if photo == 6 and spp == 1 and comp != 1:
        raise OSError("TIFF: one-sample YCbCr under compression "
                      f"{comp}, which libtiff's RGBA interface refuses "
                      "(Pillow: decoder error)")
    planar = tags.get(284, (1,))[0]
    if planar not in (1, 2):
        raise refuse(f"planar configuration {planar}")
    tw = tags.get(322, (w,))[0]
    native = comp != 1
    if planar == 2 and spp > 1:
        raw = _planes_raw(comp, mode, raw, bps, extra, w, tw, 322 in tags)
    elif planar == 2 and comp == 1:
        # Pillow's raw decoder unpacks one plane with the rawmode's first
        # letter: the same unpacker, a native 32-bit one, or none
        if raw.startswith(("F;32", "I;32")):
            native = True
        elif raw.startswith("I;"):
            raise OSError(f"TIFF: unknown raw mode {raw[0]} for a plane of "
                          f"{raw} (Pillow has no unpacker for it)")
        elif raw != raw[0] or (photo == 6 and w % tw):
            raise refuse(f"planar configuration 2 with {spp} uncompressed "
                         f"{bps[0]}-bit samples")
    return Layout(h, w, mode, raw, bps[0], fmt[0], native)


def _planes_raw(comp: int, mode: str, raw: str, bps, extra, w: int,
                tw: int, tiled: bool) -> str:
    """The rawmode that gives Pillow's pixels of samples in separate
    planes, or the error.  Uncompressed, Pillow unpacks plane k with the
    k-th letter of the rawmode (RGB, RGBA, CMYK and LAB have such
    unpackers; LAB's A and B read the file's signed a* and b*).  Through
    libtiff it reads as many planes as the mode has bands: from strips
    only when there are no more, from tiles the first ones; RGB with one
    extra sample that is not unassociated alpha comes as associated
    alpha."""
    spp = len(bps)
    if comp == 7:
        raise refuse("JPEG compression in separate planes")
    if mode == "LA":
        if comp == 1:
            raise OSError("TIFF: unknown raw mode for separate L and A "
                          "planes (Pillow has no unpacker for them)")
        raise refuse("planar configuration 2 for LA (Pillow's planes are "
                     "not the file's)")
    if comp == 1:
        if raw.split(";")[0] not in ("RGB", "RGBA", "CMYK", "LAB"):
            raise OSError(f"TIFF: unknown raw mode for separate planes of "
                          f"{raw} (Pillow has no unpacker for them)")
        if bps[0] == 16:
            raise refuse(f"planar configuration 2 with {spp} uncompressed "
                         "16-bit samples")
        if raw == "RGBA" and extra == () and w % tw:
            raise refuse("planar configuration 2 for RGBA without extra "
                         "samples in tiles past the right edge (Pillow's "
                         "stride there is not the file's)")
    elif spp != len(mode) and not tiled:
        raise OSError(f"TIFF: separate planes of {raw}, {spp} samples for "
                      f"{len(mode)} bands (Pillow: decoder error)")
    elif mode in ("P", "PA"):
        raise refuse(f"planar configuration 2 for {raw} (Pillow's planes "
                     "are not the file's)")
    elif mode == "RGBA" and (extra == () or extra[0] == 1):
        raw = "RGBa" + raw[4:]
    return "LAB;planes" if mode == "LAB" else raw


def _orientation(tags: Dict[int, tuple]) -> int:
    o = tags.get(274, (1,))[0]
    return o if o in range(2, 9) else 1


def tiff_header(data: bytes) -> Tuple[int, int, str]:
    """(h, w, Pillow's mode) of IFD 0, the size after its orientation."""
    e, tags = _ifd0(data)
    h, w, mode = _layout(e, tags)[:3]
    if _orientation(tags) >= 5:
        h, w = w, h
    return h, w, mode


def _segment_bytes(comp: int, raw: bytes, nbytes: int, tags, rows: int,
                   w: int) -> np.ndarray:
    """One strip or tile's decoded bytes."""
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
    raise refuse(f"compression {comp}")


def _jpeg_segment(raw: bytes, tables: Optional[bytes], photo: int,
                  rows: int, w: int, spp: int) -> np.ndarray:
    """uint8 [rows, w, spp] of one JPEG strip or tile."""
    data = raw
    if tables and len(tables) > 4:
        data = tables[:-2] + raw[2:]   # tables' SOI..DQT/DHT, the frame's
    if not data.endswith(b"\xff\xd9"):
        # a segment cut inside its byte count: libtiff's source manager
        # gives EOI markers past its end, as many as are read; cut before
        # its frame header ends, libjpeg refuses the frame they make
        if _frame_end(data) > len(data):
            raise OSError("TIFF: JPEG segment cut before the end of its "
                          "frame header")
        data += _EOIS
    try:
        sh, sw, _ = jpeg.jpeg_header(data)
    except (ValueError, IndexError, struct.error) as err:
        raise OSError(f"TIFF: JPEG segment header: {err}") from err
    if sw != w or sh < rows:
        raise OSError(f"TIFF: JPEG segment of {sw} x {sh} for {w} x {rows}")
    px = imgdec.decode_jpeg(data, (sh, sw, spp), color=1 if photo == 6
                            else 2, where="TIFF JPEG segment", segment=True)
    return px[:rows].reshape(rows, w, spp)


def _frame_end(data: bytes) -> int:
    """The offset past a JPEG stream's SOF segment (past its end when the
    stream stops before one)."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        m = data[pos + 1]
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            return end
        if m == 0xDA:
            break
        pos = end
    return len(data) + 1


def _samples(buf: np.ndarray, bits: int, n: int, e: str) -> np.ndarray:
    """[rows, row bytes] -> [rows, n] samples: uint8 (1 / 2 / 4 / 8
    bits), uint16 (12 bits, packed MSB first; 16 bits) and uint32 (32
    bits), the words read in the file's byte order."""
    if bits in (16, 32):
        size = bits // 8
        return buf[:, :size * n].copy().view(f"{e}u{size}").astype(
            np.uint16 if bits == 16 else np.uint32)
    if bits == 8:
        return buf[:, :n]
    if bits == 12:
        b = buf[:, :(3 * n + 1) // 2].astype(np.uint16)
        b = np.concatenate([b, np.zeros((b.shape[0], -b.shape[1] % 3),
                                        np.uint16)], axis=1)
        g = b.reshape(b.shape[0], -1, 3)
        v = np.stack([g[..., 0] << 4 | g[..., 1] >> 4,
                      (g[..., 1] & 15) << 8 | g[..., 2]], -1)
        return v.reshape(b.shape[0], -1)[:, :n]
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    v = (buf[..., None] >> shifts) & np.uint8((1 << bits) - 1)
    return v.reshape(buf.shape[0], -1)[:, :n]


def _predictor(tags, comp: int, lay: Layout) -> int:
    """The predictor libtiff undoes (1: none); raises where it refuses
    one.  Pillow's raw decoder and libtiff's other codecs ignore it."""
    predictor = tags.get(317, (1,))[0]
    if comp not in _PREDICTED or predictor == 1:
        return 1
    if predictor == 2 and lay.bits not in (8, 16, 32):
        raise OSError(f"TIFF: horizontal differencing (predictor 2) is "
                      f"not supported with {lay.bits}-bit samples")
    if predictor == 3 and (lay.fmt != 3 or lay.bits not in (16, 24, 32,
                                                            64)):
        raise OSError(f"TIFF: the floating-point predictor (3) is not "
                      f"supported with sample format {lay.fmt}, "
                      f"{lay.bits}-bit samples")
    if predictor not in (2, 3):
        raise refuse(f"predictor {predictor}")
    return predictor


def decode(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """TIFF bytes -> (pixels, mode, palette) after the orientation:
    pixels uint8 [H, W] for ``1`` (0 / 255), ``L`` and ``P``, uint16
    [H, W] for ``I;16(B)``, int32 [H, W] for ``I``, float32 [H, W] for
    ``F``, uint8 [H, W, C] for the rest; palette [2^bits, 3] uint8 for
    ``P`` and ``PA``."""
    e, tags = _ifd0(data)
    lay = _layout(e, tags)
    h, w, mode, bits = lay.h, lay.w, lay.mode, lay.bits
    comp = tags.get(259, (1,))[0]
    photo = tags.get(262, (0,))[0]
    spp = tags.get(277, (1,))[0]
    predictor = _predictor(tags, comp, lay)
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
    samples = np.zeros((h, w, spp), np.uint32 if bits == 32 else
                       np.uint16 if bits > 8 else np.uint8)
    tables = tags.get(347, (None,))[0]
    row_bytes = (tw * seg_spp * bits + 7) // 8
    sub = _subsampling(tags) if lay.raw == "YCbCr" else (1, 1)
    if comp in (2, 3, 4):
        # libtiff decodes each strip or tile into the one buffer Pillow
        # keeps for them all, so rows a cut segment does not reach hold the
        # segment before's (zeros before the first); libtiff's codec state
        # goes from segment to segment too
        fax_rows = np.zeros((th, tw), np.uint8)
        fax_state = imgdec.ccitt_state(tw)
        fax_opts = tags.get(292 if comp == 3 else 293, (0,))[0]
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
                # an empty segment fails to load in libtiff; a failed
                # decode fails a strip, not a tile (TIFFReadEncodedTile
                # takes the decoder's -1 for success)
                if not raw or not (imgdec.ccitt(
                        raw, comp, fax_opts, tags.get(266, (1,))[0],
                        fax_rows[:rows], fax_state) or tiled):
                    raise OSError(f"TIFF: CCITT data of segment {i} end "
                                  f"before its rows")
                buf = np.packbits(fax_rows[:rows], axis=1)
            elif sub != (1, 1):
                need = (-(-tw // sub[0]) * -(-rows // sub[1])
                        * (sub[0] * sub[1] + 2))
                v = _ycbcr_blocks(_segment_bytes(comp, raw, need, tags, rows,
                                                 tw), rows, tw, sub)
                samples[region] = v[:ry, :rx]
                continue
            else:
                seg = _segment_bytes(comp, raw, rows * row_bytes, tags, rows,
                                     tw)
                if seg.size < rows * row_bytes:
                    raise OSError(f"TIFF: image file is truncated (segment "
                                  f"{i} holds {seg.size} of "
                                  f"{rows * row_bytes} bytes)")
                buf = seg[:rows * row_bytes].reshape(rows, row_bytes)
            if predictor == 2:
                buf = _undo_predictor(buf, seg_spp, bits, e)
            elif predictor == 3:
                buf = _undo_float_predictor(buf, seg_spp, bits, e)
        v = _samples(buf[:ry], bits, tw * seg_spp, e)
        samples[region] = v.reshape(ry, tw, seg_spp)[:, :rx]
    orientation = _orientation(tags)
    if orientation >= 5 and comp == 1:
        samples = _mapped(data, tags, samples, lay, e, offsets, tiled, tw,
                          th)
    # words in the machine's (little-endian) order where the rawmode reads
    # big-endian ones come out swapped
    px, palette = _pixels(samples, lay, tags, lay.native and e == ">")
    if present < total:     # uncompressed: Pillow leaves the rest 0
        got = (np.arange(total) < present).reshape(planes, down, across)
        got = got.repeat(th, 1).repeat(tw, 2)[:, :h, :w]
        if px.ndim == 2:
            px[~got[0]] = 0
        else:
            px[~np.moveaxis(got, 0, -1).repeat(seg_spp, -1)] = 0
    return _orient(px, orientation), mode, palette


def _mapped(data: bytes, tags, samples: np.ndarray, lay: Layout, e: str,
            offsets, tiled: bool, tw: int, th: int) -> np.ndarray:
    """The samples Pillow transposes for orientations 5-8 of a file it
    memory-maps: one uncompressed strip or tile whose rawmode is its mode,
    one of ``_MAPMODES`` (``ImageFile.load`` maps it at ``Image.open``'s
    size, the transposed one, so the stored bytes read as w rows of h
    samples, and the transposed image keeps the stored h x w).  Other
    files: as given."""
    h, w, spp = samples.shape
    one = (len(offsets) == 1 or (tw, th) == (w, h)
           or (not tiled and tags.get(278, (h,))[0] == h))
    if (not one or lay.raw != lay.mode or lay.mode not in _MAPMODES
            or tags.get(284, (1,))[0] != 1):
        return samples
    bits = lay.bits
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
    sample, modulo the sample's range (8, 16 or 32 bits)."""
    h = buf.shape[0]
    if bits == 8:
        return np.cumsum(buf.reshape(h, -1, spp), axis=1,
                         dtype=np.uint8).reshape(h, -1)
    t = np.uint16 if bits == 16 else np.uint32
    word = f"{e}u{bits // 8}"
    v = buf.view(word).reshape(h, -1, spp)
    return np.cumsum(v, axis=1, dtype=t).astype(word).view(
        np.uint8).reshape(h, -1)


def _undo_float_predictor(buf: np.ndarray, spp: int, bits: int, e: str
                          ) -> np.ndarray:
    """libtiff's floating-point predictor (fpAcc): each row's bytes summed
    with a stride of ``spp``, then read as byte planes, the most
    significant byte of every word first; back to words in the file's
    byte order."""
    rows, nb = buf.shape
    size = bits // 8
    acc = np.cumsum(buf.reshape(rows, -1, spp), axis=1, dtype=np.uint8)
    words = acc.reshape(rows, size, nb // size).transpose(0, 2, 1)
    if e == "<":
        words = words[..., ::-1]
    return np.ascontiguousarray(words).reshape(rows, nb)


def _unpremultiply(px: np.ndarray) -> np.ndarray:
    """Associated alpha as Pillow's RGBa unpackers undo it: each colour
    255 * c / a, truncated and clipped; all four 0 where a is 0."""
    a = px[..., 3:4].astype(np.uint32)
    c = px[..., :3].astype(np.uint32)
    rgb = np.where(a == 255, c, np.minimum(255 * c // np.maximum(a, 1), 255))
    rgb = np.where(a == 0, 0, rgb)
    return np.concatenate([rgb.astype(np.uint8), px[..., 3:4]], axis=-1)


def _pixels(samples: np.ndarray, lay: Layout, tags, swapped: bool
            ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """[H, W, C] samples -> (pixels of the mode, palette), as Pillow's
    unpacker of the layout's rawmode gives them (``swapped``: 16 / 32-bit
    words that reach it byte-swapped)."""
    mode, raw, bits = lay.mode, lay.raw, lay.bits
    if mode in ("F", "I"):
        v = samples[..., 0]
        if swapped and raw.endswith(("BF", "BS")):
            v = v.byteswap()
        if mode == "F":
            return np.ascontiguousarray(v).view(np.float32), None
        if bits == 16:
            return v.view(np.int16).astype(np.int32), None
        return np.ascontiguousarray(v).view(np.int32), None
    if mode in ("I;16", "I;16B"):
        return np.ascontiguousarray(samples[..., 0]), None
    px = samples[..., :len(mode)] if len(mode) > 1 else samples[..., 0]
    if mode == "1":
        px = 1 - px if raw == "1;I" else px
        return px * np.uint8(255), None
    if raw == "YCbCr":
        return _ycbcr_to_rgb(px, tags), None
    if bits == 16:                  # RGB / RGBA / CMYK: each high byte
        px = (px >> 8).astype(np.uint8)
    if raw.startswith("RGBa"):
        px = _unpremultiply(px)
    if raw == "LAB;planes":         # the A and B band unpackers
        px = px ^ np.array([0, 128, 128], np.uint8)
    if mode == "L" and bits < 8:    # Pillow's L;2 / L;4 unpackers
        px = px * np.uint8(255 // ((1 << bits) - 1))
    if raw in ("L;I", "L;2I", "L;4I"):
        px = 255 - px
    palette = None
    if mode in ("P", "PA"):
        cmap = tags.get(320)
        n = 1 << bits
        if cmap is None or len(cmap) < 3 * n:
            raise OSError(f"TIFF: palette image without a {n}-entry colour "
                          "map")
        palette = (np.asarray(cmap[:3 * n], np.uint32).reshape(3, n).T
                   // 256).astype(np.uint8)
    return np.ascontiguousarray(px), palette


def _subsampling(tags) -> Tuple[int, int]:
    """YCbCrSubsampling (horizontal, vertical); libtiff's default 2 x 2."""
    v = tags.get(530, (2, 2))
    return (v[0], v[1]) if len(v) >= 2 else (2, 2)


def _ycbcr_blocks(seg: np.ndarray, rows: int, w: int, sub) -> np.ndarray:
    """A segment of subsampled YCbCr (blocks of h x v Y samples, then Cb
    and Cr, left to right, top to bottom) -> uint8 [rows, w, 3], each
    pixel with its block's Cb and Cr, as libtiff's put routines give
    them."""
    sh, sv = sub
    nbx, nby = -(-w // sh), -(-rows // sv)
    size = sh * sv + 2
    if seg.size < nbx * nby * size:
        raise OSError(f"TIFF: image file is truncated (a YCbCr segment "
                      f"holds {seg.size} of {nbx * nby * size} bytes)")
    blk = seg[:nbx * nby * size].reshape(nby, nbx, size)
    y = blk[..., :sh * sv].reshape(nby, nbx, sv, sh).transpose(0, 2, 1, 3)
    out = np.empty((nby * sv, nbx * sh, 3), np.uint8)
    out[..., 0] = y.reshape(nby * sv, nbx * sh)
    for k in (1, 2):
        out[..., k] = blk[..., sh * sv + k - 1].repeat(sv, 0).repeat(sh, 1)
    return out[:rows, :w]


def _floats(tags, tag: int, default) -> Tuple[np.float32, ...]:
    """A RATIONAL tag's values as libtiff reads them: float numerator
    over float denominator (0 where the denominator is 0)."""
    v = tags.get(tag)
    if v is None or len(v) < 2 * len(default):
        return tuple(np.float32(d) for d in default)
    return tuple(np.float32(0) if v[2 * i + 1] == 0 else
                 np.float32(v[2 * i]) / np.float32(v[2 * i + 1])
                 for i in range(len(default)))


@functools.lru_cache(maxsize=8)
def _ycbcr_tables(luma, rbw) -> Tuple[np.ndarray, ...]:
    """libtiff's TIFFYCbCrToRGBInit (tif_color.c): Cr -> R, Cb -> B,
    Cr -> G, Cb -> G and Y tables, in its float32 and 16.16 fixed
    point."""
    f32 = np.float32
    lr, lg, lb = luma

    def fix(x):                 # FIX: (int32_t)(x * (1L << 16) + 0.5)
        return int(np.float64(f32(x) * f32(65536)) + 0.5)

    def clamp(v, lo, hi):
        return lo if v < lo else hi if v > hi else v

    def code2v(c, rb, rw, cr):
        den = (rw - rb) if (rw - rb) != 0 else f32(1)
        return f32(f32(c - int(rb)) * f32(cr)) / f32(den)

    f1 = f32(2) - f32(2) * lr
    f3 = f32(2) - f32(2) * lb
    d1 = fix(clamp(f1, f32(0), f32(2)))
    d2 = -fix(clamp(lr * f1 / lg, f32(0), f32(2)))
    d3 = fix(clamp(f3, f32(0), f32(2)))
    d4 = -fix(clamp(lb * f3 / lg, f32(0), f32(2)))
    lim = (f32(-128 * 32), f32(128 * 32))
    tabs = [[], [], [], [], []]
    for x in range(-128, 128):
        cr = int(clamp(code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127),
                       *lim))
        cb = int(clamp(code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127),
                       *lim))
        tabs[0].append((d1 * cr + (1 << 15)) >> 16)
        tabs[1].append((d3 * cb + (1 << 15)) >> 16)
        tabs[2].append(d2 * cr)
        tabs[3].append(d4 * cb + (1 << 15))
        tabs[4].append(int(clamp(code2v(x + 128, rbw[0], rbw[1], 255),
                                 *lim)))
    return tuple(np.asarray(t, np.int64) for t in tabs)


def _ycbcr_to_rgb(px: np.ndarray, tags) -> np.ndarray:
    """uint8 [H, W, 3] Y, Cb, Cr at 1x1 -> RGB, as libtiff's RGBA
    interface gives them to Pillow (TIFFYCbCrtoRGB, the file's
    YCbCrCoefficients and ReferenceBlackWhite or their defaults)."""
    cr_r, cb_b, cr_g, cb_g, y_tab = _ycbcr_tables(
        _floats(tags, 529, (0.299, 0.587, 0.114)),
        _floats(tags, 532, (0, 255, 128, 255, 128, 255)))
    y = y_tab[px[..., 0]]
    cb, cr = px[..., 1], px[..., 2]
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                    y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


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
